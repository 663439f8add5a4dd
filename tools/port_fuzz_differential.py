#!/usr/bin/env python3
"""Differential fuzz harness of the port: every hand-written codec and
device program against its oracle.

The counterpart of tools/fuzz_differential.py over veneur_tpu_torch, with
the same ten targets and the same value distributions:

  dogstatsd      the native C++ parser (veneur_tpu_torch/native.py's own
                 build) vs the Python parser: accept/reject parity per
                 line (newline-free inputs; the datagram API splits lines)
  ssf            native span decoder accepts => the Python decoder parses
  metricpb       native MetricBatch decoder accepts => the generated
                 protobuf parses, and the metric counts agree
  gob            round-trip identity, and a clean bounded-time GobError
                 on mutated bytes (untrusted peer input on /import)
  ssf_stream     framed-stream recoverability: a bad payload in a
                 well-formed frame consumes exactly its frame
  loadgen        every line a random WorkloadSpec synthesizes parses in
                 both codecs, with the ring's, Python's and native tallies
                 equal
  reader_commit  per-reader owned contexts vs one legacy context over the
                 same streams: keyed fold parity
  query          ops/query.quantile_rows vs np_quantile, hll.estimate (K5
                 on the card) vs np_hll_estimate, the count-min sketch vs
                 np_cms_query and its bounds, SpaceSaving vs an exact
                 count. Its quantile check diverges on every seed, as the
                 JAX tool's does: its random pools send a target at a
                 row's total past the last live centroid
                 (``slot_past_last_live``; ROADMAP §3, F9)
  forward_codec  native VSF1/VDE1 frame codec vs the Python reference:
                 identical encodes, round-trip decodes, the same verdict
                 on corrupted blobs
  device_fallback  a DeviceWorker under a seeded DeviceFaultPlan vs a
                 clean worker fed the same lines: every flushed array
                 bitwise (only ``degraded`` may differ). On the card the
                 clean worker launches K1, K3 and the spill's K2b, and a
                 faulted op fails over to the same torch programs on the
                 CPU, so each faulted case holds the card to the CPU. A
                 case's seed picks, by its two low bits, the worker's set
                 store (the staged store, or the dense pool: K4 and K5)
                 and its staging depth (32, or 4: rows past it spill
                 through K2b); no draw of the JAX tool's sequence is
                 added.

Usage:
    python3 tools/port_fuzz_differential.py [--device cpu] [--seconds 30]
        [--seed N] [--targets a,b,...] [--tally PATH] [--rounds N]

``query`` and ``device_fallback`` run their device work on --device (the
card unless another device is named; without CUDA the tool raises before
any target runs). ``device_fallback`` is opt-in, as in the JAX tool.
--tally accumulates the results into the JSON file it names and writes
nothing else. Exit 0 = no divergence; 1 = divergence (repro printed with
its seed).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import subprocess
import sys
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

FAULT_KINDS = ("oom", "compile", "lost", "other")
DEFAULT_TARGETS = ("dogstatsd,ssf,metricpb,gob,ssf_stream,loadgen,"
                   "reader_commit,query,forward_codec")


def span_bytes(**kw) -> bytes:
    """A serialized ssf.SSFSpan from keyword fields (``tags`` a dict,
    ``metrics`` a list of sample-field dicts)."""
    from veneur_tpu_torch.gen import ssf_pb2

    pb = ssf_pb2.SSFSpan()
    for k, v in kw.pop("tags", {}).items():
        pb.tags[k] = v
    for s in kw.pop("metrics", []):
        m = pb.metrics.add()
        for f, fv in s.items():
            if f == "tags":
                for tk, tv in fv.items():
                    m.tags[tk] = tv
            else:
                setattr(m, f, fv)
    for k, v in kw.items():
        setattr(pb, k, v)
    return pb.SerializeToString()


def fuzz_dogstatsd(rng, t_end, dev, stats) -> int:
    from veneur_tpu_torch import native as native_mod
    from veneur_tpu_torch.protocol import dogstatsd

    types = [b"c", b"g", b"ms", b"h", b"d", b"s", b"zz", b"", b"cg", b"mss"]
    names = [b"a.b.c", b"x", b"", b"with space", b"uni\xc3\xa9", b"a" * 64,
             b"a:b"]
    values = [b"1", b"2.5", b"-3", b"+4", b"1e3", b"nan", b"inf", b"bar",
              b"", b"0x1f", b"1_0", b"9" * 30, b"1.2.3", b" 1"]
    rates = [b"", b"|@0.5", b"|@1", b"|@0", b"|@2", b"|@x", b"|@-1"]
    tagsets = [b"", b"|#a:1", b"|#b:2,a:1", b"|#veneurlocalonly", b"|#",
               b"|#a:1|#b:2", b"|#" + b"t" * 200, b"|#a:1,a:1", b"|#,"]
    ni = native_mod.NativeIngest()
    n = 0
    while time.time() < t_end:
        for _ in range(2000):
            line = (rng.choice(names) + b":" + rng.choice(values) + b"|"
                    + rng.choice(types) + rng.choice(rates)
                    + rng.choice(tagsets))
            if rng.random() < 0.4 and line:
                pos = rng.randrange(len(line))
                b = rng.randrange(0, 256)  # NULs included
                if b == 0x0A:  # newline splits datagrams; per-line scope
                    b = 0x0B
                line = line[:pos] + bytes([b]) + line[pos + 1:]
            try:
                dogstatsd.parse_metric(line)
                py_ok = True
            except dogstatsd.ParseError:
                py_ok = False
            before = ni.processed
            ni.ingest(line)
            if (ni.processed > before) != py_ok:
                print(f"dogstatsd DIVERGE py={py_ok}: {line!r}")
                return -1
            n += 1
    return n


def fuzz_ssf(rng, t_end, dev, stats) -> int:
    from veneur_tpu_torch import native as native_mod
    from veneur_tpu_torch.protocol import ssf_wire

    seeds = []
    for i in range(60):
        metrics = [{"name": f"m{j}", "value": j + 0.5, "sample_rate": 1.0,
                    "message": "msg" * j, "unit": "ms",
                    "tags": {f"t{k}": "v" * k for k in range(j)}}
                   for j in range(i % 5)]
        seeds.append(span_bytes(
            trace_id=rng.randrange(0, 1 << 63), id=rng.randrange(0, 1 << 63),
            start_timestamp=rng.randrange(0, 1 << 63),
            end_timestamp=rng.randrange(0, 1 << 63),
            service=f"s{i}", name=f"op{i}", indicator=bool(i % 2),
            metrics=metrics, tags={f"k{j}": f"v{j}" for j in range(i % 6)}))
    ni = native_mod.NativeIngest()
    n = 0
    while time.time() < t_end:
        for _ in range(2000):
            base = bytearray(rng.choice(seeds))
            roll = rng.random()
            if roll < 0.4 and base:
                for _ in range(rng.randrange(1, 8)):
                    base[rng.randrange(len(base))] = rng.randrange(256)
            elif roll < 0.55:
                del base[rng.randrange(max(1, len(base))):]
            elif roll < 0.65:
                base = bytearray(rng.randbytes(rng.randrange(0, 300)))
            payload = bytes(base)
            try:
                ssf_wire.parse_ssf(payload)
                py_ok = True
            except Exception:
                py_ok = False
            rc = ni.ingest_ssf(payload, b"ind.t", b"obj.t")
            if rc not in (-1, 0, 1) or (rc in (1, -1) and not py_ok):
                print(f"ssf DIVERGE rc={rc} py={py_ok}: {payload!r}")
                return -1
            n += 1
    return n


def fuzz_metricpb(rng, t_end, dev, stats) -> int:
    from veneur_tpu_torch import native as native_mod
    from veneur_tpu_torch.gen import veneur_tpu_pb2 as mpb

    def make_batch(i):
        b = mpb.MetricBatch()
        for j in range(i % 5):
            m = b.metrics.add()
            m.name = f"fz.m{j}" * (1 + j % 3)
            m.tags.extend([f"t{k}:v{k}" for k in range(j % 4)])
            m.kind = [mpb.KIND_COUNTER, mpb.KIND_GAUGE, mpb.KIND_HISTOGRAM,
                      mpb.KIND_SET, mpb.KIND_TIMER][j % 5]
            m.scope = [mpb.SCOPE_MIXED, mpb.SCOPE_LOCAL,
                       mpb.SCOPE_GLOBAL][j % 3]
            if m.kind == mpb.KIND_COUNTER:
                m.counter.value = int(j * 3 - 2)
            elif m.kind == mpb.KIND_GAUGE:
                m.gauge.value = float(j) * 1.5 - 2
            elif m.kind in (mpb.KIND_HISTOGRAM, mpb.KIND_TIMER):
                m.digest.compression = 100.0
                m.digest.min = -1.0
                m.digest.max = 99.0
                m.digest.centroids.means.extend(
                    [float(k) for k in range(j + 1)])
                m.digest.centroids.weights.extend(
                    [1.0 + k for k in range(j + 1)])
            elif m.kind == mpb.KIND_SET:
                m.hll.registers = bytes(range(16 + j))
                m.hll.precision = 14
        return b.SerializeToString()

    seeds = [make_batch(i) for i in range(50)]
    n = 0
    while time.time() < t_end:
        for _ in range(2000):
            base = bytearray(rng.choice(seeds))
            roll = rng.random()
            if roll < 0.4 and base:
                for _ in range(rng.randrange(1, 8)):
                    base[rng.randrange(len(base))] = rng.randrange(256)
            elif roll < 0.55 and base:
                del base[rng.randrange(len(base)):]
            elif roll < 0.65:
                base = bytearray(rng.randbytes(rng.randrange(0, 200)))
            blob = bytes(base)
            d = native_mod.decode_metric_batch(blob)
            if d is not None:
                try:
                    pb = mpb.MetricBatch.FromString(blob)
                except Exception:
                    print(f"metricpb DIVERGE C++ n={d.n} py=rej: {blob!r}")
                    return -1
                if d.n != len(pb.metrics):
                    print(f"metricpb COUNT {d.n} != {len(pb.metrics)}: "
                          f"{blob!r}")
                    return -1
            n += 1
    return n


def fuzz_gob(rng, t_end, dev, stats) -> int:
    from veneur_tpu_torch.distributed import gob

    seeds = []
    for i in range(20):
        k = 1 + i % 15
        means = np.sort(np.array([rng.uniform(-1e3, 1e3) for _ in range(k)]))
        weights = np.array([1.0 + rng.random() * 5 for _ in range(k)])
        blob = gob.encode_merging_digest(
            means, weights, 100.0, float(means.min()), float(means.max()),
            0.5)
        d = gob.decode_merging_digest(blob)
        if not np.allclose(d.means, means):
            print(f"gob ROUNDTRIP {d.means!r} != {means!r}")
            return -1
        seeds.append(blob)
    n = 0
    while time.time() < t_end:
        for _ in range(2000):
            base = bytearray(rng.choice(seeds))
            roll = rng.random()
            if roll < 0.5 and base:
                for _ in range(rng.randrange(1, 6)):
                    base[rng.randrange(len(base))] = rng.randrange(256)
            elif roll < 0.65 and base:
                del base[rng.randrange(len(base)):]
            elif roll < 0.75:
                base = bytearray(rng.randbytes(rng.randrange(0, 150)))
            blob = bytes(base)
            # CPU time: wall time flags false positives whenever the
            # fuzzer is descheduled under host load
            t0 = time.process_time()
            try:
                gob.decode_merging_digest(blob)
            except gob.GobError:
                pass
            except Exception as e:
                print(f"gob CRASH {type(e).__name__}: {e} on {blob!r}")
                return -1
            if time.process_time() - t0 > 1.0:
                print(f"gob SLOW on {len(blob)}B")
                return -1
            n += 1
    return n


def fuzz_ssf_stream(rng, t_end, dev, stats) -> int:
    """Framed-stream reader invariants (an unmarshalable payload inside a
    well-formed frame is recoverable, as the reference's
    ReadSSFStreamSocket continues on non-framing errors):

      1. SSFUnmarshalError consumes exactly its frame: a valid frame
         appended after a bad-payload frame always decodes.
      2. Any byte stream ends in bounded reads with FramingError,
         SSFUnmarshalError, clean EOF (None) or decoded spans: no other
         exception, no endless loop.
    """
    import io
    import struct

    from veneur_tpu_torch.protocol import ssf_wire

    good_payload = span_bytes(trace_id=7, id=8, start_timestamp=1,
                              end_timestamp=2, service="fz", name="op")
    good_frame = struct.pack(">BI", 0, len(good_payload)) + good_payload
    n = 0
    while time.time() < t_end:
        for _ in range(2000):
            roll = rng.random()
            if roll < 0.5:
                # a bad payload in a well-formed frame + a good frame:
                # the recoverability property
                bad = rng.randbytes(rng.randrange(0, 64))
                stream = (struct.pack(">BI", 0, len(bad)) + bad
                          + good_frame)
                f = io.BytesIO(stream)
                try:
                    ssf_wire.read_ssf(f)
                    first_ok = True
                except ssf_wire.SSFUnmarshalError:
                    first_ok = False
                except ssf_wire.FramingError:
                    print("ssf_stream DIVERGE: well-formed frame raised "
                          f"non-recoverable FramingError: {bad!r}")
                    return -1
                span = ssf_wire.read_ssf(f)
                if span is None or span.service != "fz":
                    print(f"ssf_stream DIVERGE: good frame lost after "
                          f"{'decoded' if first_ok else 'unmarshal-err'} "
                          f"frame: {bad!r}")
                    return -1
            else:
                # arbitrary bytes: bounded reads, bounded error surface
                base = bytearray(good_frame * rng.randrange(1, 3))
                for _ in range(rng.randrange(1, 6)):
                    base[rng.randrange(len(base))] = rng.randrange(256)
                f = io.BytesIO(bytes(base))
                for _ in range(8):  # > frames in the stream
                    try:
                        if ssf_wire.read_ssf(f) is None:
                            break
                    except ssf_wire.FramingError:
                        break  # SSFUnmarshalError subclasses it: both ok
                    except Exception as e:
                        print(f"ssf_stream CRASH {type(e).__name__}: {e} "
                              f"on {bytes(base)!r}")
                        return -1
                else:
                    print(f"ssf_stream UNBOUNDED on {bytes(base)!r}")
                    return -1
            n += 1
    return n


def fuzz_loadgen(rng, t_end, dev, stats) -> int:
    """Generated-traffic differential (the loadgen ring synthesizer is a
    third codec): every DogStatsD line a random WorkloadSpec synthesizes
    is accepted by the Python parser and the native parser, and the ring's
    line tally, Python's parses and the native processed count agree; the
    same for SSF span rings through parse_ssf and the native span path. A
    generator that emitted unparseable traffic would deflate every
    sustained-rate number (the loss would be synthetic)."""
    from veneur_tpu_torch import native as native_mod
    from veneur_tpu_torch.core.metrics import DEFAULT_TENANT, tenant_of
    from veneur_tpu_torch.loadgen.spec import WorkloadSpec
    from veneur_tpu_torch.protocol import dogstatsd, ssf_wire

    if not native_mod.loadgen_available():
        print("loadgen: native library unavailable — 0 cases")
        return 0
    ni = native_mod.NativeIngest()
    n = 0
    while time.time() < t_end:
        mix = [rng.random() for _ in range(5)]
        mix[rng.randrange(5)] += 0.2  # guarantee a positive sum
        tenants = rng.choice([1, 1, 2, 5, 16])
        spec = WorkloadSpec(
            seed=rng.randrange(1 << 30),
            num_keys=rng.choice([1, 3, 97, 1000]),
            zipf_s=rng.choice([0.0, 0.7, 1.1, 2.5]),
            type_mix=mix,
            num_tags=rng.randrange(0, 7),
            tag_cardinality=rng.choice([1, 5, 50]),
            prefix=rng.choice(["lg", "fz.deep.prefix", "a"]),
            datagram_bytes=rng.choice([64, 512, 1400, 8192]),
            ring_lines=2000,
            tenant_count=tenants,
            tenant_abusive_frac=(
                0.0 if tenants == 1 else rng.choice([0.0, 0.3, 1.0])),
            tenant_zipf_s=rng.choice([0.0, 1.0]),
            tenant_churn_keys=rng.choice([0, 500]))
        valid_tenants = {f"t{i}" for i in range(tenants)}
        ring = spec.build_ring()
        py_total = native_total = 0
        for i in range(len(ring)):
            dgram = ring.datagram(i)
            for line in dgram.split(b"\n"):
                try:
                    m = dogstatsd.parse_metric(line)
                except dogstatsd.ParseError as e:
                    print(f"loadgen DIVERGE py rejects generated line "
                          f"({e}): {line!r} spec={spec.to_dict()}")
                    return -1
                if not m.key.name.startswith(spec.prefix + "."):
                    print(f"loadgen DIVERGE name outside prefix: "
                          f"{m.key.name!r} spec={spec.to_dict()}")
                    return -1
                # tenant stamping: multi-tenant specs put a valid
                # tenant:tN tag on every line, single-tenant specs on none
                t = tenant_of(m.tags, "tenant")
                if tenants == 1 and t != DEFAULT_TENANT:
                    print(f"loadgen DIVERGE tenant tag on single-tenant"
                          f" line: {line!r} spec={spec.to_dict()}")
                    return -1
                if tenants > 1 and t not in valid_tenants:
                    print(f"loadgen DIVERGE bad tenant {t!r}: {line!r} "
                          f"spec={spec.to_dict()}")
                    return -1
                py_total += 1
            before = ni.processed
            ni.ingest(dgram)
            native_total += ni.processed - before
        if not (py_total == native_total == ring.total_lines):
            print(f"loadgen TALLY py={py_total} native={native_total} "
                  f"ring={ring.total_lines} spec={spec.to_dict()}")
            return -1
        ssf_ring = spec.build_ssf_ring(n_spans=50)
        for i in range(len(ssf_ring)):
            payload = ssf_ring.datagram(i)
            try:
                ssf_wire.parse_ssf(payload)
            except Exception as e:
                print(f"loadgen DIVERGE py rejects generated span "
                      f"({type(e).__name__}: {e}): {payload!r}")
                return -1
            rc = ni.ingest_ssf(payload, b"ind.t", b"obj.t")
            if rc != 1:
                print(f"loadgen DIVERGE native rc={rc} on generated "
                      f"span: {payload!r}")
                return -1
        n += py_total + len(ssf_ring)
    return n


def fuzz_reader_commit(rng, t_end, dev, stats) -> int:
    """Shared-nothing reader-commit differential (the reader-shard line
    path): R private owned contexts (one per reader) vs one legacy
    context processing the same per-reader streams serialized in reader
    order. Everything keyed agrees exactly: processed and error tallies
    and the per-series folds (counter sums, timer (value, weight)
    multisets, set (index, rank) updates, last-value gauges). Gauge keys
    are per-reader-disjoint: the last writer across readers is not part
    of the contract; counters, timers and sets overlap across readers."""
    from veneur_tpu_torch import native as native_mod

    R = 3
    owned = [native_mod.NativeIngest() for _ in range(R)]
    legacy = native_mod.NativeIngest()
    for ctx in owned + [legacy]:
        ctx.set_spill_cap(1 << 20)

    # (pool, row) -> key maps live as long as their context:
    # drain_new_series reports only rows created since the last drain
    name_maps = {id(c): {} for c in owned + [legacy]}

    def drain_keyed(ctx):
        names = name_maps[id(ctx)]
        names.update({(p, r): (nm, tg) for p, r, _k, _s, nm, tg
                      in ctx.drain_new_series()})
        out = {"h": {}, "c": {}, "g": {}, "s": {}}
        while True:
            hr, hv, hw = ctx.drain_histo(4096)
            for r, v, w in zip(hr.tolist(), hv.tolist(), hw.tolist()):
                out["h"].setdefault(names[(0, r)], []).append((v, w))
            sr, si, sk = ctx.drain_set(4096)
            for r, i, k in zip(sr.tolist(), si.tolist(), sk.tolist()):
                out["s"].setdefault(names[(1, r)], set()).add((i, k))
            cr, cc = ctx.drain_counter(4096)
            for r, c in zip(cr.tolist(), cc.tolist()):
                key = names[(2, r)]
                out["c"][key] = out["c"].get(key, 0.0) + c
            gr, gv = ctx.drain_gauge(4096)
            for r, v in zip(gr.tolist(), gv.tolist()):
                out["g"][names[(3, r)]] = v
            if not (ctx.pending_histo or ctx.pending_set
                    or ctx.pending_counter or ctx.pending_gauge):
                break
        for v in out["h"].values():
            v.sort()
        return out

    n = 0
    seen = [0] * (2 * (R + 1))  # processed/errors offsets per context
    while time.time() < t_end:
        keys = [b"fz.k%d" % j for j in range(rng.randrange(1, 40))]
        streams = []
        for r in range(R):
            lines = []
            for _ in range(rng.randrange(20, 200)):
                roll = rng.random()
                if roll < 0.08:
                    lines.append(rng.choice(
                        [b"bad line", b":|c", b"fz.x:|g", b"fz.x:1|zz",
                         b"fz.x:nope|c", b""]))
                    continue
                name = rng.choice(keys)
                if roll < 0.30:
                    line = name + b":%d|c" % rng.randrange(-50, 50)
                    if rng.random() < 0.3:
                        line += b"|@0.5"
                elif roll < 0.55:
                    line = name + b":%d.%d|ms" % (rng.randrange(500),
                                                  rng.randrange(100))
                elif roll < 0.75:
                    line = name + b":u%d|s" % rng.randrange(200)
                else:  # per-reader-disjoint gauge namespace
                    line = b"fz.g%d.%s:%d|g" % (r, name, rng.randrange(999))
                if rng.random() < 0.4:
                    line += b"|#t:%d" % rng.randrange(4)
                lines.append(line)
            dgrams = [b"\n".join(lines[i:i + 20])
                      for i in range(0, len(lines), 20)]
            streams.append(dgrams)

        for r in range(R):
            for d in streams[r]:
                owned[r].ingest_owned(d)
        for r in range(R):  # reader (context) order: the parity contract
            for d in streams[r]:
                legacy.ingest(d)

        tallies = []
        for i, ctx in enumerate(owned + [legacy]):
            p = int(ctx.processed) - seen[2 * i]
            e = int(ctx.errors) - seen[2 * i + 1]
            seen[2 * i], seen[2 * i + 1] = int(ctx.processed), int(ctx.errors)
            if int(ctx.overload_dropped):
                print("reader_commit spill cap hit — raise cap")
                return -1
            tallies.append((p, e))
        sp = sum(t[0] for t in tallies[:R])
        se = sum(t[1] for t in tallies[:R])
        if (sp, se) != tallies[R]:
            print(f"reader_commit TALLY sharded=({sp},{se}) "
                  f"legacy={tallies[R]}")
            return -1

        got = {"h": {}, "c": {}, "g": {}, "s": {}}
        for ctx in owned:  # fold per-reader drains in reader order
            part = drain_keyed(ctx)
            for key, vw in part["h"].items():
                got["h"].setdefault(key, []).extend(vw)
            for key, pairs in part["s"].items():
                got["s"].setdefault(key, set()).update(pairs)
            for key, c in part["c"].items():
                got["c"][key] = got["c"].get(key, 0.0) + c
            got["g"].update(part["g"])
        for v in got["h"].values():
            v.sort()
        want = drain_keyed(legacy)
        if got != want:
            for cls in ("h", "c", "g", "s"):
                if got[cls] != want[cls]:
                    diff = (set(got[cls]) ^ set(want[cls])) or {
                        k for k in got[cls]
                        if got[cls][k] != want[cls].get(k)}
                    print(f"reader_commit DIVERGE class={cls} "
                          f"keys={sorted(diff)[:5]}")
            return -1
        n += sp + se
    return n


def fuzz_query(rng, t_end, dev, stats) -> int:
    """Live-query differential (veneur_tpu_torch/query/): the query
    programs on ``dev`` vs their independent numpy references on random
    pools:

      quantile_rows  vs np_quantile      (f32 vs f64, tolerance)
      hll.estimate   vs np_hll_estimate  (random register fields, both
                     the linear-counting and raw-harmonic branches; K5 on
                     the card)
      heavyhitter.query vs np_cms_query  (exact: same int32 counters)
                     + CMS upper-bound and read_totals-exact properties
      SpaceSavingTopK with capacity >= distinct keys vs an exact Counter
    """
    import torch

    from veneur_tpu_torch.ops import heavyhitter as hh
    from veneur_tpu_torch.ops import hll
    from veneur_tpu_torch.ops import query as qops

    def on_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    nprng = np.random.default_rng(rng.randrange(1 << 30))
    S, C = 16, 32
    n = 0
    while time.time() < t_end:
        for _ in range(10):
            # t-digest quantiles: left-packed digests (k live centroids,
            # zero-weight tail), one always-empty row for the NaN path
            means = np.sort(nprng.uniform(-1e3, 1e3, (S, C)),
                            axis=1).astype(np.float32)
            weights = nprng.uniform(0.1, 8.0, (S, C)).astype(np.float32)
            for i in range(S):
                weights[i, nprng.integers(0 if i == 0 else 1, C + 1):] = 0.0
            dmin = means[:, 0] - nprng.uniform(0, 10, S).astype(np.float32)
            kmax = np.maximum((weights > 0).sum(axis=1) - 1, 0)
            dmax = (means[np.arange(S), kmax]
                    + nprng.uniform(0, 10, S).astype(np.float32))
            qs = np.sort(nprng.uniform(0.0, 1.0, rng.choice([1, 3, 5, 8])))
            if rng.random() < 0.3:
                qs[0], qs[-1] = 0.0, 1.0
            qpad, norig = qops.pad_quantiles(qs)
            rows, nrows = qops.pad_rows(
                nprng.integers(0, S, rng.choice([3, 4, 7, 8])))
            got = qops.quantile_rows(
                on_dev(means), on_dev(weights), on_dev(dmin), on_dev(dmax),
                on_dev(rows), on_dev(qpad)).cpu().numpy()
            ref = qops.np_quantile(means, weights, dmin, dmax,
                                   qpad)[rows]
            if not np.allclose(got[:nrows, :norig], ref[:nrows, :norig],
                               rtol=1e-3, atol=1e-2, equal_nan=True):
                stats["failed_check"] = "quantile"
                stats["case"] = {"means": means, "weights": weights,
                                 "dmin": dmin, "dmax": dmax, "rows": rows,
                                 "qs": qpad, "nrows": nrows,
                                 "norig": norig, "got": got, "ref": ref,
                                 "index": n}
                print(f"query QUANTILE DIVERGE rows={rows[:nrows]} "
                      f"qs={qs!r}\n dev={got[:nrows, :norig]!r}\n "
                      f"ref={ref[:nrows, :norig]!r}")
                return -1

            # HLL estimate: random register fields, forcing both branches
            p = rng.choice([6, 10])
            m = 1 << p
            regs = nprng.integers(0, 64 - p + 2, (8, m)).astype(np.int8)
            regs[0, :] = 0  # empty row: pure linear counting
            regs[1, nprng.random(m) < 0.99] = 0  # sparse: zeros > 0
            got_e = hll.estimate(on_dev(regs), p).cpu().numpy()
            ref_e = qops.np_hll_estimate(regs, p)
            if not np.allclose(got_e, ref_e, rtol=1e-3):
                stats["failed_check"] = "hll"
                print(f"query HLL DIVERGE p={p}\n dev={got_e!r}\n "
                      f"ref={ref_e!r}")
                return -1

            # CMS: the point query equals the reference's bits and
            # bounds the truth from above; the totals are exact
            T, D, W = 4, 4, 256
            keys = [f"qk{j}" for j in range(rng.randrange(1, 60))]
            nins = rng.randrange(1, 200)
            ins_rows = nprng.integers(0, T, nins).astype(np.int32)
            ins_keys = [rng.choice(keys) for _ in range(nins)]
            counts = nprng.integers(1, 1000, nins).astype(np.int32)
            cols = hh.split_hashes(hh.hash_keys(ins_keys), D, W)
            pool = hh.insert_chunked(hh.init_pool(T, D, W, device=dev),
                                     ins_rows, cols, counts, chunk=256)
            qrows = np.repeat(np.arange(T, dtype=np.int32), len(keys))
            qcols = np.tile(hh.split_hashes(hh.hash_keys(keys), D, W), T)
            got_c = hh.query(pool, on_dev(qrows), on_dev(qcols)).cpu().numpy()
            ref_c = qops.np_cms_query(pool.cpu().numpy(), qrows, qcols)
            if not np.array_equal(got_c, ref_c):
                stats["failed_check"] = "cms"
                print(f"query CMS DIVERGE keys={len(keys)} nins={nins}")
                return -1
            truth = Counter()
            for t, k, c in zip(ins_rows.tolist(), ins_keys,
                               counts.tolist()):
                truth[(t, k)] += c
            est = got_c.reshape(T, len(keys))
            for t in range(T):
                for j, k in enumerate(keys):
                    if est[t, j] < truth[(t, k)]:
                        stats["failed_check"] = "cms_bound"
                        print(f"query CMS UNDER-estimate t={t} key={k}: "
                              f"{est[t, j]} < {truth[(t, k)]}")
                        return -1
            tot = hh.read_totals(pool)
            want_tot = np.bincount(ins_rows, weights=counts,
                                   minlength=T).astype(np.int64)
            if not np.array_equal(tot, want_tot):
                stats["failed_check"] = "totals"
                print(f"query TOTALS DIVERGE {tot!r} != {want_tot!r}")
                return -1

            # space-saving with room for every distinct key == exact
            ss = hh.SpaceSavingTopK(capacity=len(keys))
            stream = Counter()
            for _ in range(rng.randrange(1, 300)):
                k = rng.choice(keys)
                c = rng.randrange(1, 20)
                ss.offer(k, c)
                stream[k] += c
            got_t = {k: (c, e) for k, c, e in ss.items()}
            want_t = {k: (c, 0) for k, c in stream.items()}
            if got_t != want_t:
                stats["failed_check"] = "topk"
                print(f"query TOPK DIVERGE {got_t!r} != {want_t!r}")
                return -1
            n += 1
    return n


def slot_past_last_live(case) -> np.ndarray:
    """bool[K', P'] over a ``fuzz_query`` quantile case (its gathered rows
    and padded quantiles): where ops/tdigest.quantile's slot search lands
    past the row's last live centroid. The f32 Hillis-Steele prefix at
    that centroid can fall an ulp below the row's total when the row's
    weights are not sums the scan adds exactly, as the target's random
    weights are not; a target at the total then reaches a zero-weight
    slot, whose bounds come from the means past the live centroids. The
    JAX package's quantile and the flush extract (K1) search the same
    way, bit for bit. Rows that add_batch writes, whose weights are
    differences of one prefix scan, do not show it in
    tests/test_torch_tools.py (ROADMAP §3, F9)."""
    import torch

    from veneur_tpu_torch.ops import exactnum as exn

    z = exn.flush_denormals
    w = z(torch.from_numpy(case["weights"][case["rows"]]))
    w_cum = exn.cumsum(w, flush=True)
    target = exn.block(z(torch.from_numpy(case["qs"])[None, :]
                         * w_cum[:, -1:]))
    first = torch.searchsorted(w_cum, target.contiguous(), right=False)
    last = (w > 0).sum(dim=-1) - 1
    return (first.clamp_max(w.shape[1] - 1) > last[:, None]).numpy()


def quantile_case_past_last_live(case) -> bool:
    """Whether every entry on which a ``fuzz_query`` quantile case's
    result disagrees with np_quantile is one whose slot search landed
    past the row's last live centroid (``slot_past_last_live``)."""
    k, p = case["nrows"], case["norig"]
    bad = ~np.isclose(case["got"][:k, :p], case["ref"][:k, :p], rtol=1e-3,
                      atol=1e-2, equal_nan=True)
    return bool(bad.any()) and bool(
        (slot_past_last_live(case)[:k, :p] | ~bad).all())


def fuzz_forward_codec(rng, t_end, dev, stats) -> int:
    """Native VSF1/VDE1 forward-frame codec vs the pinned Python
    reference: encoded bytes identical, decodes round-trip through both
    paths, and corrupted blobs draw the same typed verdict (accept with
    an equal value, or ValueError) from both. Runs against whichever
    dispatch is live: with VENEUR_CODEC_NATIVE=0 it is a Python
    self-consistency sweep."""
    from veneur_tpu_torch.distributed import codec

    if codec._native_codec() is None:
        print("forward_codec: native codec not loaded "
              "(Python self-consistency only)")

    def rand_sender() -> str:
        chars = []
        for _ in range(rng.randrange(0, 14)):
            r = rng.random()
            if r < 0.55:
                chars.append(chr(rng.randrange(0x20, 0x7F)))
            elif r < 0.70:   # controls + DEL: the \u00xx escape path
                chars.append(chr(rng.choice(
                    list(range(0x00, 0x20)) + [0x7F])))
            elif r < 0.85:   # BMP non-ASCII: \uxxxx escapes
                chars.append(chr(rng.randrange(0x80, 0x3000)))
            elif r < 0.95:   # astral: surrogate-pair escapes
                chars.append(chr(rng.randrange(0x10000, 0x10400)))
            else:            # lone surrogate: native must decline,
                chars.append(chr(rng.randrange(0xD800, 0xE000)))
        return "".join(chars)  # ... and fall back per call

    def verdict(fn, blob):
        try:
            return ("ok", fn(blob))
        except ValueError:
            return ("reject", None)

    n = 0
    while time.time() < t_end:
        for _ in range(1500):
            seq = rng.randrange(0, 1 << 64)
            body = bytes(rng.randrange(256)
                         for _ in range(rng.randrange(0, 48)))
            frame = codec.encode_stream_frame(seq, body)
            if frame != codec.encode_stream_frame_py(seq, body):
                print(f"forward_codec FRAME ENC DIVERGE seq={seq}")
                return -1
            if (codec.decode_stream_frame(frame) != (seq, body)
                    or codec.decode_stream_frame_py(frame) != (seq, body)):
                print(f"forward_codec FRAME DEC DIVERGE seq={seq}")
                return -1
            status = rng.randrange(0, 256)
            ack = codec.encode_stream_ack(seq, status)
            if (ack != codec.encode_stream_ack_py(seq, status)
                    or codec.decode_stream_ack(ack)
                    != codec.decode_stream_ack_py(ack)):
                print(f"forward_codec ACK DIVERGE seq={seq} st={status}")
                return -1
            sender = rand_sender()
            did = rng.randrange(-(1 << 66), 1 << 66)  # straddles i64
            cnt = rng.randrange(0, 1 << 40)
            env = codec.encode_dedup_envelope(sender, did, cnt, body)
            if env != codec.encode_dedup_envelope_py(
                    sender, did, cnt, body):
                print(f"forward_codec ENV ENC DIVERGE {sender!r} {did}")
                return -1
            # ground truth is the JSON escape round trip: two adjacent
            # lone surrogates re-merge into one astral char on decode
            want = ((json.loads(json.dumps(sender)), did, cnt), body)
            if (codec.decode_dedup_envelope(env) != want
                    or codec.decode_dedup_envelope_py(env) != want):
                print(f"forward_codec ENV DEC DIVERGE {sender!r} {did}")
                return -1
            # corruption: one flipped bit draws the same verdict (and
            # value, when accepted) from both decode paths
            blob = env if rng.random() < 0.5 else frame
            pos = rng.randrange(len(blob))
            mutated = (blob[:pos]
                       + bytes([blob[pos] ^ (1 << rng.randrange(8))])
                       + blob[pos + 1:])
            for pub, ref in ((codec.decode_dedup_envelope,
                              codec.decode_dedup_envelope_py),
                             (codec.decode_stream_frame,
                              codec.decode_stream_frame_py),
                             (codec.decode_stream_ack,
                              codec.decode_stream_ack_py)):
                if verdict(pub, mutated) != verdict(ref, mutated):
                    print(f"forward_codec CORRUPT DIVERGE {pub.__name__}"
                          f" pos={pos} blob={mutated!r}")
                    return -1
            n += 1
    return n


def fuzz_device_fallback(rng, t_end, dev, stats) -> int:
    """Device fault-domain differential (ops/device_guard): a worker on
    ``dev`` under a random seeded DeviceFaultPlan (random fault kind,
    per-op dispatch windows and breaker streak, micro-folds on or off)
    flushes the same arrays, bitwise, as a clean worker fed the same
    lines, for every metric class: whatever subset of device ops fault,
    and whether or not the breaker trips, the failover to the CPU loses
    nothing (only the ``degraded`` flag may differ). ``stats["injected"]``
    counts the faults injected by kind."""
    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates
    from veneur_tpu_torch.core.worker import DeviceWorker
    from veneur_tpu_torch.protocol.dogstatsd import parse_metric
    from veneur_tpu_torch.utils import faults as fl

    qs = device_quantiles(
        [0.5, 0.9, 0.99], HistogramAggregates.from_names(
            ["min", "max", "sum", "count"]))
    ops_all = ("fold", "spill", "staged", "micro", "extract", "sets",
               "grow", "import")
    injected_by_kind = stats.setdefault("injected", dict.fromkeys(
        FAULT_KINDS, 0))

    def mk(streak, micro, set_store, stage_depth):
        return DeviceWorker(compression=100, stage_depth=stage_depth,
                            batch_size=8,
                            initial_histo_rows=8, initial_set_rows=8,
                            set_store=set_store, micro_fold=micro,
                            micro_fold_rows=1, micro_fold_max_age_s=1e9,
                            device_fault_streak=streak, device=dev)

    def drive(w, lines, micro):
        for ln in lines:
            if ln is None:
                if micro and w.micro_fold_due():
                    w.micro_fold_once()
                continue
            w.process_metric(parse_metric(ln.encode()))
        return w.flush(qs)

    n = 0
    while time.time() < t_end:
        seed = rng.randrange(1 << 30)
        # the worker's form, from the case seed's low bits (no draw of
        # the JAX tool's sequence added): its set store, and a staging
        # depth past which a row's samples spill through K2b
        set_store = ("staged", "dense")[seed & 1]
        stage_depth = (32, 4)[seed >> 1 & 1]
        nprng = np.random.default_rng(seed)
        micro = rng.random() < 0.5
        streak = rng.choice([1, 2, 3])
        nser = rng.randrange(3, 20)
        lines = []
        for _ in range(rng.randrange(3, 9)):
            for _ in range(rng.randrange(4, 14)):
                k = int(nprng.integers(nser))
                t = rng.random()
                if t < 0.4:
                    lines.append(f"h{k}:{nprng.normal():.6f}|ms|#a:{k % 3}")
                elif t < 0.6:
                    lines.append(f"c{k}:{1 + k % 5}|c")
                elif t < 0.8:
                    lines.append(f"s{k}:v{nprng.integers(50)}|s")
                else:
                    lines.append(f"g{k}:{nprng.normal():.6f}|g")
            lines.append(None)  # micro-fold point
        kind = rng.choice(["oom", "compile", "lost", "other"])
        ops = rng.sample(ops_all, rng.randrange(1, len(ops_all) + 1))
        start = rng.randrange(0, 8)
        width = rng.randrange(1, 12)
        plan = fl.DeviceFaultPlan(seed=seed, op_windows={
            op: [(start, start + width, kind)] for op in ops})

        base = drive(mk(streak, micro, set_store, stage_depth), lines,
                     micro)
        w = mk(streak, micro, set_store, stage_depth)
        with fl.DeviceFaultInjector(plan) as inj:
            got = drive(w, lines, micro)
        for k in FAULT_KINDS:
            injected_by_kind[k] += inj.injected[k]
        injected = sum(inj.injected[k] for k in FAULT_KINDS)
        ctx = (f"seed={seed} kind={kind} ops={ops} "
               f"window=({start},{start + width}) micro={micro} "
               f"streak={streak} set_store={set_store} "
               f"stage_depth={stage_depth} injected={injected} "
               f"quarantined={w.guard.quarantined}")
        for f in dataclasses.fields(base):
            if f.name == "degraded":
                continue
            va, vb = getattr(base, f.name), getattr(got, f.name)
            if not (isinstance(va, np.ndarray)
                    or isinstance(vb, np.ndarray)):
                continue
            if (va is None or vb is None or va.dtype != vb.dtype
                    or va.shape != vb.shape
                    or va.tobytes() != vb.tobytes()):
                print(f"device_fallback DIVERGE field={f.name} {ctx}\n"
                      f" base={va!r}\n got={vb!r}")
                return -1
        if got.degraded and not injected:
            print(f"device_fallback PHANTOM degraded flush {ctx}")
            return -1
        n += 1
    return n


TARGETS = {"dogstatsd": fuzz_dogstatsd, "ssf": fuzz_ssf,
           "metricpb": fuzz_metricpb, "gob": fuzz_gob,
           "ssf_stream": fuzz_ssf_stream, "loadgen": fuzz_loadgen,
           "reader_commit": fuzz_reader_commit, "query": fuzz_query,
           "forward_codec": fuzz_forward_codec,
           "device_fallback": fuzz_device_fallback}


def run_round(targets, seconds: float, seed: int, device) -> dict:
    """One sweep of ``targets`` (names), each for ``seconds`` from
    ``random.Random(seed)``, device work on ``device``: the cases per
    clean target, the diverging targets, the seconds each took and the
    other stats the targets kept."""
    from veneur_tpu_torch.device import resolve

    dev = resolve(device)
    out = {"seed": seed, "device": str(dev), "per_target": {},
           "divergences": [], "seconds": {}, "stats": {}}
    for name in targets:
        stats: dict = {}
        t0 = time.time()
        n = TARGETS[name](random.Random(seed), t0 + seconds, dev, stats)
        out["seconds"][name] = time.time() - t0
        if stats:
            out["stats"][name] = stats
        if n < 0:
            out["divergences"].append(f"{name} seed={seed}")
            print(f"{name}: DIVERGENCE (seed {seed})", flush=True)
            continue
        out["per_target"][name] = n
        print(f"{name}: {n} cases clean", flush=True)
    return out


def _git_rev() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            capture_output=True, text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _update_tally(path: str, seed: int, per_target: dict[str, int],
                  divergences: list[str]) -> None:
    """Accumulate a round's results into the tally file at ``path``."""
    tally = {"total_cases": 0, "runs": 0, "seeds": [], "per_target": {},
             "divergences_found": []}
    if os.path.exists(path):
        try:
            with open(path) as f:
                loaded = json.load(f)
            if isinstance(loaded, dict) and isinstance(
                    loaded.get("per_target"), dict):
                tally = loaded
        except (OSError, ValueError):
            pass
    tally["runs"] = tally.get("runs", 0) + 1
    tally["seeds"] = (tally.get("seeds", []) + [seed])[-50:]
    for name, n in per_target.items():
        tally["per_target"][name] = tally["per_target"].get(name, 0) + n
    tally["total_cases"] = sum(tally["per_target"].values())
    tally["divergences_found"] = (
        tally.get("divergences_found", []) + divergences)
    tally["last_run_utc"] = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())
    tally["last_rev"] = _git_rev()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(tally, f, indent=1)
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the device targets "
                         "(default: the card)")
    ap.add_argument("--seconds", type=float, default=30.0,
                    help="budget per target")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--targets", default=DEFAULT_TARGETS)
    ap.add_argument("--tally", default=None, metavar="PATH",
                    help="accumulate results into this JSON file")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the whole target sweep N times with a "
                         "fresh seed each round (long-run mode)")
    args = ap.parse_args(argv)
    targets = args.targets.split(",")
    unknown = [t for t in targets if t not in TARGETS]
    if unknown:
        ap.error(f"unknown targets {unknown}")
    from veneur_tpu_torch.device import resolve

    device = resolve(args.device)
    for rnd in range(args.rounds):
        seed = (args.seed + rnd if args.seed is not None
                else int(time.time()))
        print(f"round {rnd + 1}/{args.rounds} seed {seed} on {device}",
              flush=True)
        res = run_round(targets, args.seconds, seed, device)
        if args.tally:
            _update_tally(args.tally, seed, res["per_target"],
                          res["divergences"])
        if res["divergences"]:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
