#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (veneur_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, each printed on its own lines; any mismatch raises and the
script exits non-zero:

1. setup: card name and power limit (nvidia-smi), nvcc build of every
   kernel of the path from the sources in this checkout (the flush
   extract and the HLL library, one nvcc each) and g++ build of the
   native C++ ingest library from native/'s sources into build/native/,
   all three started together; ptxas's report of each kernel.
2. kernel vs plain on the card: the flush extract kernel against its
   plain PyTorch version at S = 1,048,576 and S = 1,000,003 rows and at
   the main path's shapes (131,072 and 1,024 rows), C = 128,
   qs = [0.5, 0.9, 0.99], a seeded numpy pool with empty, single-centroid
   and full rows. Then every built variant R (rows per warp) over S
   around each chunk and block round, 4,099, 131,072 and 1,000,003 rows,
   P = 1, 3 and 16 (qs [1.0], the above, 16 from 0 to 1), a 4,099-row
   pool of edge rows (tools/port_probe_extract.edge_pool) and row-offset
   views [1:] of every field. All P+10 columns bitwise equal (NaN
   positions equal); median times of kernel and plain at S = 1,048,576,
   and of the kernel at the main path's shapes.
3. the variant probe (tools/port_probe_extract.py): per variant its
   ptxas report, bitwise equality at S = 1,000,003 and its time at
   S = 1,048,576; a torch.sum read-rate yardstick.
3b. the HLL kernels (tools/port_probe_hll.py): hll_insert bytewise and
   hll_estimate in f32 bits equal to their plain versions over pools of
   1 to 32,768 rows at p = 4, 8, 14 and 18 in every estimator regime;
   their times at the main path's shapes, the plain versions', the
   bounds, and scatter_reduce_ beside the insert; the insert also on
   all-distinct words and on 1,048,576 updates, beside an empty kernel at
   its grid (the launch floor).
4. one worker interval at the mixed configuration of BASELINE.md
   (100k series, bench.py's "mixed" mix): 80,000 histogram/timer series
   made through process_metric, 40 samples each staged through
   _device_histo_step, 1,000 hot series with 200 samples each (past stage
   depth 64, so the spill fold runs), 10,000 counters, 9,000 gauges,
   sampled timers, and 25,000 set series: one line each through
   process_metric, then about 1.02 M set inserts through _device_set_step
   in 16,384-sample batches (64 series of 8,192 members, past the staged
   store's promotion to its dense tier; the rest of 20 members, sparse;
   members are strings, hashed as the parser hashes them);
   count_unique_timeseries on; then flush. The same interval on a second
   worker on the CPU must give bitwise the same snapshot (set estimates
   and registers and the unique-timeseries registers included).
4b. the same set traffic through set_store="dense" workers, card against
   CPU: a 32,768 x 16,384 int8 pool (512 MiB) on the card; every batch
   launches hll_insert and the flush hll_estimate over the whole pool.
4c. phase 4's interval rendered as about 45,000 DogStatsD datagrams
   (4.4 M lines: every bulk sample its series' line, every set member a
   set line) through workers with attach_native(), the C++ parser
   staging the samples: the card's snapshot must be bitwise equal to a
   native worker's on the CPU and to phase 4's Python-path snapshot. The
   flush compacts the C++ staging plane on the host, uploads it flat and
   rebuilds it on the card. Prints native_ingest_s, fold_s, the plane's
   upload bytes and the launches of the three kernels.
   In phases 4, 4b and 4c the CPU worker runs after the card's, in this
   process, so nothing else loads the host while the card's steps are
   timed; compare_snapshots holds the two snapshots to each other.
5. server: the port's Server built by its factory with a UDP listener on
   port 0, a channel sink, a Datadog, a Prometheus-repeater and a
   forward-statsd sink on local listeners (HTTP, TCP, TCP), and
   count_unique_timeseries answers a few hundred real datagrams (set
   lines among them); one flush, columnar, through the native emit tier;
   its InterMetrics, its unique-timeseries tally and every byte its
   sinks sent equal a CPU server's over the same datagrams (one ``now``,
   one hostname, the idempotency keys' sender pinned). Two runs: the default configuration on traffic
   with no series past the staging depth, and micro_fold off on traffic
   whose two untagged series take 300 samples each, past the 64-deep
   staging plane, so the spill folds run (with micro-folds on, the
   native server's scheduler drains spill at times of its own, and spill
   cut at other points folds to other bits: ROADMAP.md section 3).
5b. each run's datagrams through a server with tpu_native_ingest and
   tpu_native_readers on: a C++ reader thread reads the socket (the
   script fails if a Python reader runs or native mode is off); its
   InterMetrics and tally equal the CPU server's of phase 5, and so do
   its sinks' Datadog series and other requests and its repeater and
   forward lines, as multisets.
   Phases 4 to 5b run the configuration's defaults, micro-folds and the
   device guard on (the workers' flush streams the staging plane through
   the mirror; the servers run the micro-fold scheduler; phase 5's spill
   run turns micro-folds off), and each fails on any guard fault, trip
   or degraded flush.
6. micro-folds at full width: phase 4's interval with micro_fold_once
   every 16 staging batches, on the card and on the CPU, and with
   micro-folds off on both; phase 4c's native interval with a micro-fold
   after every fourth drain, on the card. Every snapshot bitwise equal to
   phase 4's; micro-folds, mirror chunks and bytes, fold_s and the
   guarded calls of each run printed.
7. the guard on the card: phase 4's interval with faults injected at the
   dispatch seam (utils/faults.py): the first pool-growth pre-flight,
   spill fold, micro-fold scatter and set op each fault once (retried,
   replayed or dropped to the staging plane) and every extract faults;
   two faults in a row trip the breaker, the epoch goes on and flushes
   on the CPU: phase 4's snapshot, degraded. A first probe faults, a
   second re-admits the card, and a smaller interval runs on it,
   launching K1, K4 and K5 again. Then tools/port_guard_faults.py:
   a real allocator OOM through the HBM valve, and a device-side assert
   in a child process (classified lost, the probe fails, the CPU flushes
   on). The guard's host cost per call: a one-kernel op called directly
   and through the guard, in turns.
8. the egress at full width, after phase 5b (host work: no kernel
   runs): phase 4's card snapshot through generate_columnar
   (generate_s, object path against columnar), its materialize() equal
   to the object path as a multiset and its arrays bitwise the CPU
   snapshot's batch; then every ported metric sink (Datadog, SignalFx,
   the Prometheus repeater and pushgateway, forward-statsd, New Relic)
   of one factory-built server, on local listeners, flushes it through
   the server's negotiation in turn: the native tier on and off on the
   card's batch, on for the CPU's. Every byte from the card's batch
   equals the CPU's (the Datadog bodies raw and inflated); native equals
   Python byte for byte for the lines, the exposition text and New
   Relic, and by value for the Datadog series and SignalFx points; the
   native encoders took every group of every native-capable sink. Each
   sink's seconds (native, Python), requests and bytes are printed.
9. on the line before the last two, the card's name and power limit;
   then a ``kernels`` JSON line: every kernel with its launches on the
   main path (phases 4 to 5b: counts reset just before, read just
   after), its agreement with the plain version, its time, the plain
   time and its bound; its launches in phase 6 (``launches_micro``), in
   phase 7's intervals (``launches_guard``) and in the real-OOM run of
   tools/port_guard_faults.py (``launches_guard_oom``), each counted
   from 0 just before its run; the probe's variants beside it, with
   their build report and launches (only the variant flush_extract
   launches has any).
10. the last line: {"ok": true, "device": {...}}.

Without CUDA, or without the veneur_tpu_torch package beside it, the
script prints no result and exits 2. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

S_FULL = 1_048_576
S_RAGGED = 1_000_003
QS = [0.5, 0.9, 0.99]
# the worker interval (BASELINE.md mixed configuration, 100k series)
N_HIST, N_HOT, N_COUNTERS, N_GAUGES = 80_000, 1_000, 10_000, 9_000
# its sets: a quarter of bench.py's mixed series; the big ones promote to
# the staged store's dense tier (8,192 members give ~6,300 registers of
# 16,384, past promote_entries = 2,048)
N_SETS, N_SETS_BIG, BIG_MEMBERS, SMALL_MEMBERS = 25_000, 64, 8_192, 20
EDGE_ROWS = 4099
DEVICE = "cuda"
probe = None  # tools/port_probe_extract.py, imported by main()
probe_hll = None  # tools/port_probe_hll.py, imported by main()
guard_faults = None  # tools/port_guard_faults.py, imported by main()
# micro-folds in phase 6: one every this many 16,384-sample staging
# batches (Python path) or drains (native path)
MICRO_EVERY, MICRO_EVERY_NATIVE = 16, 4
# phase 7's interval after re-admission: the big sets' first members,
# four of the staged store's 65,536-update compactions, past which they
# promote to its dense tier (hll_insert, then hll_estimate at the flush)
READMIT_SET_SAMPLES = 262_144


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


# -- phase 2 ------------------------------------------------------------------


def sweep_sizes(variants) -> list[int]:
    """Row counts around each variant's chunk (R rows) and block round
    (4 warps x R rows), plus larger ragged and main-path sizes."""
    small = {1}
    for r in variants:
        for t in (r, 4 * r):
            small.update({t - 1, t, t + 1})
    return sorted(n for n in small if n > 0) + [4099, 131_072, S_RAGGED]


def _compare(got, ref, what: str) -> float:
    same, err = probe.bitwise_equal(got, ref)
    if not same:
        import torch

        bad = (got != ref) & ~(torch.isnan(got) & torch.isnan(ref))
        rows = torch.nonzero(bad.any(1)).flatten()[:5].tolist()
        raise AssertionError(f"kernel != plain at {what}, rows {rows}")
    return err


def phase_kernel_vs_plain(ek):
    """The production kernel at the main path's shapes, every variant
    over the sweep of sizes, quantile counts, a row-offset view and the
    edge-row pool; all bitwise against the plain version. Returns the
    pool (kept for the probe) and the numbers for the kernels line."""
    import numpy as np
    import torch

    dev = torch.device(DEVICE)
    fields = [torch.from_numpy(a).to(dev)
              for a in probe.make_pool(S_FULL, seed=11)]
    qs = torch.tensor(QS, dtype=torch.float32, device=dev)
    # the main path's shapes too: the worker interval's and the server's
    # effective pool rows (the pow2 bucket extract_snapshot slices to)
    s_main = [max(1024, 1 << (N_HIST + N_HOT - 1).bit_length()), 1024]
    errs = []
    for s in [S_FULL, S_RAGGED] + s_main:
        sub = [f[:s] for f in fields]
        got = ek.flush_extract(*sub, qs)
        sync()
        ref = ek.flush_extract_plain(*sub, qs)
        sync()
        errs.append(_compare(got, ref, f"S={s}"))
        n_nan = int(torch.isnan(got[:, 0]).sum())
        log(f"[kernel] S={s}: bitwise_equal=True max_abs_err={errs[-1]} "
            f"empty_rows={n_nan} shape={tuple(got.shape)}")
        if s == S_RAGGED:
            plain_check = ref
    qs_by_p = {1: [1.0], 3: QS, 16: list(np.linspace(0.0, 1.0, 16))}
    edge = [torch.from_numpy(a).to(dev)
            for a in probe.edge_pool(EDGE_ROWS, seed=13)]
    cases = []  # (label, fields, qs)
    for p, qv in qs_by_p.items():
        q = torch.tensor(qv, dtype=torch.float32, device=dev)
        cases += [(f"S={s} P={p}", [f[:s] for f in fields], q)
                  for s in sweep_sizes(ek.VARIANTS)]
        cases.append((f"edge rows S={EDGE_ROWS} P={p}", edge, q))
        cases.append((f"edge rows [1:] P={p}", [f[1:] for f in edge], q))
    cases.append((f"[1:] S={S_FULL - 1} P=3", [f[1:] for f in fields], qs))
    for label, sub, q in cases:
        ref = ek.flush_extract_plain(*sub, q)
        for r in ek.VARIANTS:
            got = ek._flush_extract_variant(r, *sub, q)
            sync()
            errs.append(_compare(got, ref, f"r{r} {label}"))
        del ref, got
    log(f"[kernel] variants r{', r'.join(map(str, ek.VARIANTS))}: each "
        f"bitwise equal to the plain version in {len(cases)} cases (S in "
        f"{sweep_sizes(ek.VARIANTS)} x P in 1, 3, 16; the {EDGE_ROWS}-row "
        f"edge pool ({', '.join(probe.EDGE_KINDS)}) and row-offset views "
        f"[1:] of it and of the {S_FULL}-row pool)")
    sub = fields
    k_ms = probe.cuda_ms(lambda: ek.flush_extract(*sub, qs), reps=21,
                         spin_cycles=2_000_000)
    p_ms = probe.cuda_ms(lambda: ek.flush_extract_plain(*sub, qs), reps=5)
    b_ms, b_by = probe.bound(S_FULL, len(QS))
    log(f"[kernel] S={S_FULL} P={len(QS)}: kernel r{ek.ROWS_PER_WARP} "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), {b_ms / k_ms * 100:.1f}% of bound")
    at_main = {}
    for s in s_main:
        sub = [f[:s] for f in fields]
        t = probe.cuda_ms(lambda: ek.flush_extract(*sub, qs), reps=21,
                          spin_cycles=2_000_000)
        at_main[s] = {"ms": t, "bound_ms": probe.bound(s, len(QS))[0]}
        log(f"[kernel] S={s} P={len(QS)} (main path): kernel {t:.4f} ms, "
            f"bound {at_main[s]['bound_ms']:.4f} ms")
    return fields, qs, plain_check, {
        "max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "at_main_path": at_main}


# -- phase 4 ------------------------------------------------------------------


def interval_plan(seed: int):
    """The 100k-series interval: series lines (one sample each, made
    through process_metric), bulk staged samples in 16,384-sample
    batches, scalars and sampled timers."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_hist, n_hot = N_HIST, N_HOT
    series = []
    for i in range(n_hist):
        kind = "ms" if i % 2 else "h"
        rate = "|@0.5" if i % 10 == 0 else ""
        series.append(f"svc.lat.{i}:{rng.gamma(2.0, 20.0):.4f}|{kind}"
                      f"{rate}|#shard:{i % 16}".encode())
    for i in range(n_hot):
        series.append(f"hot.{i}:{rng.exponential(50.0):.4f}|ms".encode())
    scalars = [f"req.{i}:{1 + i % 5}|c|#code:{i % 7}".encode()
               for i in range(N_COUNTERS)]
    scalars += [f"queue.{i}:{rng.normal(10.0, 3.0):.5f}|g".encode()
                for i in range(N_GAUGES)]
    # bulk samples: 39 more per regular series (40 with the first), 199
    # more per hot series; shuffled so hot rows spill across batches
    rows = np.concatenate([np.repeat(np.arange(n_hist), 39),
                           np.repeat(np.arange(n_hist, n_hist + n_hot),
                                     199)]).astype(np.int32)
    perm = rng.permutation(len(rows))
    rows = rows[perm]
    vals = rng.gamma(2.0, 20.0, len(rows)).astype(np.float32)
    wts = np.where(rows % 10 == 0, np.float32(2.0),
                   np.float32(1.0)).astype(np.float32)
    return series, scalars, rows, vals, wts, set_plan(rng)


def member_hashes(ids):
    """hll_hash (FNV-1a 64, then murmur3's finalizer) of the member
    strings b"m%09d" % id, vectorized over the ids: the hash the port's
    Python path and the C++ parser give those set values."""
    import numpy as np

    d = np.empty((len(ids), 10), np.uint8)
    d[:, 0] = ord("m")
    v = np.asarray(ids, np.int64)
    for k in range(9, 0, -1):
        d[:, k] = 48 + v % 10
        v = v // 10
    h = np.full(len(ids), 0xCBF29CE484222325, np.uint64)
    for k in range(d.shape[1]):
        h ^= d[:, k].astype(np.uint64)
        h *= np.uint64(0x100000001B3)
    for mult in (0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53):
        h ^= h >> np.uint64(33)
        h *= np.uint64(mult)
    return h ^ (h >> np.uint64(33))


def set_plan(rng):
    """The sets of the interval: one line per set series (registers set
    rows 0..N_SETS-1 in order), then the bulk members, the strings
    b"m%09d" % id with a distinct id each, as (set row, register, rank)
    at p = 14 from their hashes, shuffled. Returns the ids too, so the
    members can be rendered as DogStatsD lines."""
    import numpy as np

    from veneur_tpu_torch.ops.hll import split_hashes

    lines = [f"users.{i}:u{int(rng.integers(0, 1 << 30))}|s|#shard:{i % 16}"
             .encode() for i in range(N_SETS)]
    rows = np.concatenate([
        np.repeat(np.arange(N_SETS_BIG), BIG_MEMBERS),
        np.repeat(np.arange(N_SETS_BIG, N_SETS), SMALL_MEMBERS),
    ]).astype(np.int32)
    perm = rng.permutation(len(rows))
    rows = rows[perm]
    ids = np.arange(len(rows), dtype=np.int64)
    idx, rank = split_hashes(member_hashes(ids), 14)
    return lines, rows, idx, rank, ids


def run_interval(worker, plan, parse, qs, step=contextlib.nullcontext,
                 micro_every: int = 0):
    """Drive one interval through a worker; returns (snapshot, seconds
    by step: lines through process_metric, bulk staging with its spill
    folds, and the flush with its staged fold and extract). ``step(name)``
    wraps each step (a profiler range in tools/port_profile_interval.py);
    with ``micro_every`` a micro-fold runs after every that many staging
    batches."""
    series, scalars, rows, vals, wts, (set_lines, srows, sidx, srank,
                                       _ids) = plan
    t0 = time.perf_counter()
    with step("process_metric"):
        for line in series:
            worker.process_metric(parse(line))
        for line in scalars:
            worker.process_metric(parse(line))
        for line in set_lines:
            worker.process_metric(parse(line))
        worker._flush_pending_histos()
        worker._flush_pending_sets()
        worker._sync()
    t1 = time.perf_counter()
    with step("staging"):
        # series lines registered rows 0..N-1 in order (one per line)
        b = worker.batch_size
        for k, i in enumerate(range(0, len(rows), b)):
            worker._device_histo_step(rows[i:i + b], vals[i:i + b],
                                      wts[i:i + b])
            if micro_every and k % micro_every == micro_every - 1:
                worker.micro_fold_once()
        worker._sync()
    t2 = time.perf_counter()
    set_insert_s = insert_sets(worker, srows, sidx, srank, step)
    t3 = time.perf_counter()
    with step("flush"):
        snap = worker.flush(qs)
    t4 = time.perf_counter()
    return snap, {"process_metric_s": t1 - t0, "staging_s": t2 - t1,
                  "set_insert_s": set_insert_s, "flush_s": t4 - t3,
                  **worker.last_extract_phases, **micro_stats(worker)}


def micro_stats(worker) -> dict:
    """The flushed epoch's micro-folds and the mirror's uploads."""
    return {"micro_folds": worker.micro_folds_swapped,
            "mirror_chunks": worker.last_micro_chunks,
            "mirror_bytes": worker.last_micro_bytes}


def check_guard_clean(worker, snap, what: str) -> None:
    """No guard fault, trip or degraded flush where none was injected."""
    c = worker.guard.counters()
    if c or worker.guard.quarantined or snap.degraded \
            or worker.host_fallback_flushes:
        raise AssertionError(f"{what}: guard counters {c}, degraded "
                             f"{snap.degraded}")


def insert_sets(worker, rows, idx, rank, step=contextlib.nullcontext
                ) -> float:
    """The bulk set members through _device_set_step in batch_size
    batches; seconds, ended by a device sync."""
    t0 = time.perf_counter()
    with step("sets"):
        b = worker.batch_size
        for i in range(0, len(rows), b):
            worker._device_set_step(rows[i:i + b], idx[i:i + b],
                                    rank[i:i + b])
        worker._sync()
    return time.perf_counter() - t0


def compare_snapshots(a, b, what: str) -> None:
    """Every array of two snapshots bitwise equal (NaN positions equal),
    the counters and gauges, and the directories' keys in row order."""
    import dataclasses

    import numpy as np
    import torch

    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if va is None or vb is None or va.shape != vb.shape \
                    or va.dtype != vb.dtype:
                raise AssertionError(f"{what}: snapshot field {f.name} "
                                     "differs in shape/type")
            ta, tb = torch.from_numpy(np.ascontiguousarray(va)), \
                torch.from_numpy(np.ascontiguousarray(vb))
            if ta.dtype == torch.float32:
                same, err = probe.bitwise_equal(ta, tb)
            else:
                same, err = va.tobytes() == vb.tobytes(), 0.0
            if not same:
                raise AssertionError(f"{what}: snapshot field {f.name} "
                                     f"differs (max abs err {err})")
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        if pa.values[:pa.used].tobytes() != pb.values[:pb.used].tobytes():
            raise AssertionError(f"{what}: {pool} differ")
    for pool in ("histo", "sets"):
        if [r.key for r in getattr(a.directory, pool).rows] != \
                [r.key for r in getattr(b.directory, pool).rows]:
            raise AssertionError(f"{what}: {pool} directory differs")


def check_set_estimates(est) -> None:
    """The repo's own check of an HLL: each estimate within its error
    envelope of the true count, the bulk members plus the series line's
    one (1.04/sqrt(m) = 0.8% at p = 14; at 21 of 16,384 registers linear
    counting is off only by the values that share a register, about one
    set in 75 losing one)."""
    import numpy as np

    if est is None or est.shape != (N_SETS,) or not np.isfinite(est).all():
        raise AssertionError("set estimates missing or not finite")
    big, small = est[:N_SETS_BIG], est[N_SETS_BIG:]
    if np.abs(big / (BIG_MEMBERS + 1) - 1).max() > 0.05 \
            or np.abs(small - (SMALL_MEMBERS + 1)).max() > 3.0:
        raise AssertionError(f"set estimates off: big {big.min()}..."
                             f"{big.max()}, small {small.min()}..."
                             f"{small.max()}")


# the worker configuration of phases 4 and 4c, and of 4b, with the
# config's defaults micro_fold and device_guard on (micro_fold_rows 1:
# phase 6's micro_fold_once calls always find their drain due)
INTERVAL_KW = dict(compression=100.0, stage_depth=64, batch_size=16384,
                   initial_histo_rows=4096, count_unique_timeseries=True,
                   micro_fold=True, micro_fold_rows=1, device_guard=True)
DENSE_KW = dict(batch_size=16384, set_store="dense",
                count_unique_timeseries=True, micro_fold=True,
                device_guard=True)


def phase_worker(tw, generate, parse, qs):
    """Phase 4 on the card, then its CPU twin; the snapshots bitwise
    equal."""
    import numpy as np

    plan = interval_plan(seed=5)
    per_row = np.bincount(plan[2]) + 1  # + the series line's sample
    spilled = int(np.maximum(per_row - INTERVAL_KW["stage_depth"], 0).sum())
    gpu = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    snap_g, t_g = run_interval(gpu, plan, parse, qs)
    check_guard_clean(gpu, snap_g, "phase 4, card")
    del gpu
    cpu = tw.DeviceWorker(**INTERVAL_KW, device="cpu")
    snap_c, t_c = run_interval(cpu, plan, parse, qs)
    check_guard_clean(cpu, snap_c, "phase 4, CPU")
    del cpu
    compare_snapshots(snap_g, snap_c, "phase 4, card against CPU")
    n = snap_g.directory.num_histo_rows
    qv = snap_g.quantile_values
    if qv.shape != (n, len(qs)) or not (qv == qv).all():
        raise AssertionError("quantiles not finite for every series")
    check_set_estimates(snap_g.set_estimates)
    if snap_g.set_registers.shape != (N_SETS, 1 << 14) \
            or not snap_g.unique_timeseries_registers.any():
        raise AssertionError("set registers or unique-timeseries "
                             "registers missing")
    t0 = time.perf_counter()
    metrics = generate(snap_g)
    t_g["generate_s"] = time.perf_counter() - t0
    samples = len(plan[0]) + len(plan[2])
    set_samples = len(plan[5][0]) + len(plan[5][1])
    log(f"[worker] {n} histogram series ({samples} samples, {spilled} "
        f"past stage depth {INTERVAL_KW['stage_depth']} through the spill "
        f"fold), "
        f"{snap_g.directory.num_set_rows} set series ({set_samples} set "
        f"samples; {N_SETS_BIG} promoted to the dense tier), "
        f"{len(snap_g.scalars.counter_meta)} counters, "
        f"{len(snap_g.scalars.gauge_meta)} gauges -> {len(metrics)} "
        f"InterMetrics; CUDA snapshot bitwise equal to CPU snapshot")
    for where, t in (("card", t_g), ("cpu", t_c)):
        log(f"[worker] {where}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    return {"card": t_g, "cpu": t_c, "series": n, "samples": samples,
            "spilled": spilled, "set_series": N_SETS,
            "set_samples": set_samples}, plan, snap_g, snap_c


# -- phase 4c -----------------------------------------------------------------


def render_datagrams(plan, lines_per_datagram: int = 100):
    """Phase 4's interval as DogStatsD datagrams, in the steps
    run_interval takes: the series, scalar and set lines; then the bulk
    histogram samples and the bulk set members, each cut into the
    worker's 16,384-sample batches. A bulk sample is its row's series
    line with the value written as the shortest decimal of the f64 that
    holds its f32 exactly (so it parses back to the same f32) and a
    weight of 2 as @0.5; a member is the string "m%09d" % id. Returns
    ([(step, [datagrams])], bytes), a step being what run_interval hands
    the worker between two drains. Vectorized with numpy's string
    arrays."""
    import numpy as np

    series, scalars, rows, vals, wts, (set_lines, srows, _i, _r, ids) = plan

    def grams(lines):
        return [b"\n".join(lines[i:i + lines_per_datagram])
                for i in range(0, len(lines), lines_per_datagram)]

    def text_grams(lines):
        lines = lines.tolist()
        return ["\n".join(lines[i:i + lines_per_datagram]).encode()
                for i in range(0, len(lines), lines_per_datagram)]

    steps = [("lines", grams(series + scalars + set_lines))]
    # each row's line around its value: name, then type, rate and tags
    # (the hot rows' lines carry no tags)
    r = np.arange(N_HIST)
    kind = np.where(r % 2 == 1, "ms", "h")
    shard = np.char.add("#shard:", (r % 16).astype(str))
    head = np.concatenate([
        np.char.add(np.char.add("svc.lat.", r.astype(str)), ":"),
        np.char.add(np.char.add("hot.", np.arange(N_HOT).astype(str)), ":")])
    tail1 = np.concatenate([
        np.char.add(np.char.add(np.char.add("|", kind), "|"), shard),
        np.full(N_HOT, "|ms")])
    tail2 = np.concatenate([
        np.char.add(np.char.add(np.char.add("|", kind), "|@0.5|"), shard),
        np.full(N_HOT, "|ms|@0.5")])
    b = 16_384
    for i in range(0, len(rows), b):
        rr = rows[i:i + b]
        tail = np.where(wts[i:i + b] == 2.0, tail2[rr], tail1[rr])
        v = vals[i:i + b].astype(np.float64).astype(str)
        steps.append(("histo", text_grams(
            np.char.add(np.char.add(head[rr], v), tail))))
    s = np.arange(N_SETS)
    set_head = np.char.add(np.char.add("users.", s.astype(str)), ":m")
    set_tail = np.char.add("|s|#shard:", (s % 16).astype(str))
    for i in range(0, len(srows), b):
        rr = srows[i:i + b]
        member = np.char.zfill(ids[i:i + b].astype(str), 9)
        steps.append(("sets", text_grams(np.char.add(
            np.char.add(set_head[rr], member), set_tail[rr]))))
    n = sum(len(g) for _s, gs in steps for g in gs)
    return steps, n


def run_native_interval(worker, steps, qs, micro_every: int = 0):
    """The datagrams through a worker with attach_native(): each step's
    datagrams, then a drain (the spill of a 16,384-sample batch folds as
    one batch, as run_interval's staging folds it), then the flush; with
    ``micro_every`` a micro-fold after every that many drains (it finds
    the batches drained, so the spill batches stay the same). Returns
    (snapshot, seconds by step)."""
    t_ingest = t_drain = 0.0
    for k, (_kind, grams) in enumerate(steps):
        t0 = time.perf_counter()
        for d in grams:
            worker.ingest_datagram(d)
        t1 = time.perf_counter()
        worker.drain_native()
        if micro_every and k % micro_every == micro_every - 1:
            worker.micro_fold_once()
        worker._sync()
        t_drain += time.perf_counter() - t1
        t_ingest += t1 - t0
    t1 = time.perf_counter()
    snap = worker.flush(qs)
    t2 = time.perf_counter()
    if worker.parse_errors or worker.overload_dropped_total:
        raise AssertionError(f"native worker on {worker.device}: "
                             f"{worker.parse_errors} parse errors, "
                             f"{worker.overload_dropped_total} shed")
    return snap, {"native_ingest_s": t_ingest + t_drain,
                  "ingest_datagram_s": t_ingest, "drain_s": t_drain,
                  "flush_s": t2 - t1, **worker.last_extract_phases,
                  "plane_upload_bytes": worker.last_plane_upload_bytes,
                  **micro_stats(worker)}


def phase_native(tw, ek, hll, qs, plan, python_snap):
    """Phase 4's interval as datagrams through native workers on the card
    and then on the CPU: bitwise equal to each other and to phase 4's
    Python-path snapshot on the card."""
    t0 = time.perf_counter()
    steps, n_bytes = render_datagrams(plan)
    render_s = time.perf_counter() - t0
    w = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    w.attach_native()
    k1, k4, k5 = (ek.flush_extract.launches, hll.insert_batch.launches,
                  hll.estimate.launches)
    snap, card = run_native_interval(w, steps, qs)
    card.update({
        "flush_extract_launches": ek.flush_extract.launches - k1,
        "hll_insert_launches": hll.insert_batch.launches - k4,
        "hll_estimate_launches": hll.estimate.launches - k5})
    check_guard_clean(w, snap, "phase 4c, card")
    del w
    compare_snapshots(snap, python_snap, "phase 4c, native against phase 4")
    check_set_estimates(snap.set_estimates)
    if min(card[k] for k in ("flush_extract_launches", "hll_insert_launches",
                             "hll_estimate_launches")) < 1:
        raise AssertionError(f"native interval launches {card}")
    w = tw.DeviceWorker(**INTERVAL_KW, device="cpu")
    w.attach_native()
    snap_c, cpu = run_native_interval(w, steps, qs)
    check_guard_clean(w, snap_c, "phase 4c, CPU")
    del w
    compare_snapshots(snap, snap_c, "phase 4c, card against CPU")
    del snap_c
    dense = snap.directory.num_histo_rows * INTERVAL_KW["stage_depth"] * 4 * 2
    grams = sum(len(g) for _k, g in steps)
    log(f"[native] {grams} datagrams ({n_bytes} bytes; rendered in "
        f"{render_s:.2f} s) through attach_native() workers: the card's "
        f"snapshot bitwise equal to phase 4's Python-path snapshot and to "
        f"the native CPU worker's; plane upload "
        f"{card['plane_upload_bytes']} bytes (a dense plane of the used "
        f"rows: {dense}); launches flush_extract "
        f"{card['flush_extract_launches']}, hll_insert "
        f"{card['hll_insert_launches']}, hll_estimate "
        f"{card['hll_estimate_launches']}")
    for where, t in (("card", card), ("cpu", cpu)):
        log(f"[native] {where}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    return {"card": card, "cpu": cpu, "render_s": render_s,
            "datagrams": grams, "bytes": n_bytes}, steps


def dense_interval(worker, parse):
    """Phase 4b's set traffic (seed 6) through a set_store="dense"
    worker: the set lines, the bulk members, the flush. Returns
    (snapshot, seconds by step, pool rows, samples)."""
    import numpy as np

    set_lines, rows, idx, rank, _ids = set_plan(np.random.default_rng(6))
    t0 = time.perf_counter()
    for line in set_lines:
        worker.process_metric(parse(line))
    worker._flush_pending_sets()
    worker._sync()
    t1 = time.perf_counter()
    set_insert_s = insert_sets(worker, rows, idx, rank)
    pool_rows = worker._sets.shape[0]
    t2 = time.perf_counter()
    snap = worker.flush(np.asarray(QS))
    t3 = time.perf_counter()
    return snap, {"process_metric_s": t1 - t0, "set_insert_s": set_insert_s,
                  "flush_s": t3 - t2, **worker.last_extract_phases}, \
        pool_rows, len(set_lines) + len(rows)


def phase_dense_sets(tw, parse, hll):
    """The interval's set traffic alone through set_store="dense"
    workers, the card's then the CPU's: every batch scatters into the
    32,768-row pool on the card (hll_insert), the flush estimates all of
    it (hll_estimate)."""
    w = tw.DeviceWorker(**DENSE_KW, device=DEVICE)
    k0, e0 = hll.insert_batch.launches, hll.estimate.launches
    snap, card, pool_rows, samples = dense_interval(w, parse)
    card.update({"hll_insert_launches": hll.insert_batch.launches - k0,
                 "hll_estimate_launches": hll.estimate.launches - e0})
    check_guard_clean(w, snap, "phase 4b, card")
    del w
    w = tw.DeviceWorker(**DENSE_KW, device="cpu")
    snap_c, cpu, _rows, _n = dense_interval(w, parse)
    check_guard_clean(w, snap_c, "phase 4b, CPU")
    del w
    compare_snapshots(snap, snap_c, "phase 4b, card against CPU")
    del snap_c
    out = {"card": card, "cpu": cpu}
    check_set_estimates(snap.set_estimates)
    if pool_rows != 1 << N_SETS.bit_length():  # + its scratch row
        raise AssertionError(f"dense pool of {pool_rows} rows")
    log(f"[dense sets] {N_SETS} set series, {samples} "
        f"samples into a {pool_rows} x {1 << 14} int8 pool: CUDA snapshot "
        f"bitwise equal to CPU snapshot; card launches hll_insert "
        f"{out['card']['hll_insert_launches']}, hll_estimate "
        f"{out['card']['hll_estimate_launches']}")
    for where, t in out.items():
        log(f"[dense sets] {where}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    return out


# -- phases 6 and 7 -----------------------------------------------------------


def counting_guard():
    """A fault injector with an empty plan: it injects nothing and counts
    the guarded dispatches (utils/faults.DeviceFaultInjector)."""
    from veneur_tpu_torch.utils import faults as fl

    return fl.DeviceFaultInjector(fl.DeviceFaultPlan())


def phase_micro(tw, parse, qs, plan, steps, python_snap, phase4):
    """Phase 4's interval with micro-folds every MICRO_EVERY staging
    batches, card and CPU, and with micro-folds off, card and CPU; phase
    4c's native interval with a micro-fold every MICRO_EVERY_NATIVE
    drains on the card. Every snapshot bitwise phase 4's."""
    out = {}
    off = {**INTERVAL_KW, "micro_fold": False}
    for name, dev, kw, every in (("card_on", DEVICE, INTERVAL_KW, MICRO_EVERY),
                                 ("card_off", DEVICE, off, 0),
                                 ("cpu_on", "cpu", INTERVAL_KW, MICRO_EVERY),
                                 ("cpu_off", "cpu", off, 0)):
        w = tw.DeviceWorker(**kw, device=dev)
        with counting_guard() as inj:
            snap, t = run_interval(w, plan, parse, qs, micro_every=every)
        t["guarded_calls"] = inj.calls
        check_guard_clean(w, snap, f"phase 6 {name}")
        compare_snapshots(snap, python_snap, f"phase 6 {name} against "
                          f"phase 4")
        if every and (t["micro_folds"] < 2 or not t["mirror_chunks"]):
            raise AssertionError(f"phase 6 {name}: {t}")
        out[name] = t
        del w, snap
    w = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    w.attach_native()
    with counting_guard() as inj:
        snap, t = run_native_interval(w, steps, qs,
                                      micro_every=MICRO_EVERY_NATIVE)
    t["guarded_calls"] = inj.calls
    check_guard_clean(w, snap, "phase 6 native")
    compare_snapshots(snap, python_snap, "phase 6 native against phase 4")
    if t["micro_folds"] < 2 or t["plane_upload_bytes"]:
        raise AssertionError(f"phase 6 native: {t}")
    out["card_native_on"] = t
    del w, snap
    keys = ("micro_folds", "mirror_chunks", "mirror_bytes", "fold_s",
            "flush_s", "guarded_calls")
    for name, t in [("phase 4 card (residual only)", phase4["card"]),
                    ("phase 4 cpu (residual only)", phase4["cpu"])] + \
            list(out.items()):
        log(f"[micro] {name}: " + ", ".join(
            f"{k} {t[k]:.4f}" if isinstance(t.get(k), float)
            else f"{k} {t.get(k)}" for k in keys))
    log("[micro] every snapshot bitwise equal to phase 4's")
    return out


def guard_cost(n: int = 20_000) -> dict:
    """The guard's host cost per call on the card: one tiny kernel
    launched n times directly and n times through DeviceGuard.call, in
    turns (direct, guarded, guarded, direct), each run ended by a
    sync."""
    import torch

    from veneur_tpu_torch.ops import device_guard as dg

    g = dg.DeviceGuard()
    x = torch.zeros(1, device=DEVICE)

    def op():
        x.add_(1.0)

    def run(guarded):
        sync()
        t0 = time.perf_counter()
        if guarded:
            for _ in range(n):
                g.call("extract", op)
        else:
            for _ in range(n):
                op()
        sync()
        return (time.perf_counter() - t0) / n * 1e9

    run(False), run(True)  # warm up
    t = [run(False), run(True), run(True), run(False)]
    direct, guarded = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    out = {"direct_ns": direct, "guarded_ns": guarded,
           "cost_ns": guarded - direct, "calls": n, "turns_ns": t}
    log(f"[guard] one kernel launch {direct:.0f} ns direct, {guarded:.0f} "
        f"ns through the guard: {guarded - direct:.0f} ns a guarded call "
        f"(turns {', '.join(f'{v:.0f}' for v in t)})")
    return out


# phase 7's faults: the first dispatch of each ingest op and of the probe,
# and every extract; two faults in a row trip the breaker. At phase 4's
# size the growth pre-flight's fault is retried, the micro-fold's drops
# the mirror and the spill fold's right after it trips the breaker, so
# the rest of the interval and its flush run on the CPU. Where no two
# ingest faults meet (smaller intervals), the extract and its retry trip
# it at the flush. tests/test_torch_guard.py faults every op on the CPU.
PHASE7_ONCE = ("grow", "fold", "micro", "sets", "probe")


def phase_guard(tw, ek, hll, parse, qs, plan, python_snap):
    """Phase 4's interval with faults in the guarded ops; the probe's
    re-admission and a smaller interval on the card; the real OOM and the
    child's sticky fault (tools/port_guard_faults.py)."""
    from veneur_tpu_torch.utils import faults as fl

    w = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE, device_fault_streak=2)
    windows = {op: [(0, 1, "lost")] for op in PHASE7_ONCE}
    windows["extract"] = [(0, 10**6, "lost")]
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=7, op_windows=windows)) as inj:
        snap, t = run_interval(w, plan, parse, qs, micro_every=MICRO_EVERY)
        w.guard.probe_interval_s = 0.0
        w.device_guard_tick()  # quarantines the live epoch; the probe faults
        failed_probe = w.guard.quarantined and w._host_live
        w.device_guard_tick()  # the probe passes: re-admission
    c = w.guard.counters()
    fired = dict(inj.op_injected)
    if not (snap.degraded and failed_probe and c.get("device.guard.trips")
            == 1 and c.get("device.guard.quarantines") == 1
            and c.get("device.guard.readmissions") == 1
            and len(set(fired) - {"probe"}) >= 3):
        raise AssertionError(f"phase 7: degraded {snap.degraded}, faults "
                             f"by op {fired}, counters {c}")
    compare_snapshots(snap, python_snap, "phase 7 faulted interval against "
                      "phase 4")
    faulted = {"faults_by_op": fired, "counters": c, **t}
    del snap
    if w.guard.quarantined or w._host_live:
        raise AssertionError(f"phase 7: not re-admitted {c}")
    # a smaller interval on the readmitted card: timers, and the bulk
    # members of the 64 big sets (they promote past the staged store's
    # compaction, so hll_insert runs, and hll_estimate at the flush)
    series, _sc, _r, _v, _w, (set_lines, srows, sidx, srank, _i) = plan
    big = srows < N_SETS_BIG
    k1, k4, k5 = (ek.flush_extract.launches, hll.insert_batch.launches,
                  hll.estimate.launches)
    for line in series[:20_000] + set_lines[:N_SETS_BIG]:
        w.process_metric(parse(line))
    w._flush_pending_sets()
    insert_sets(w, srows[big][:READMIT_SET_SAMPLES],
                sidx[big][:READMIT_SET_SAMPLES],
                srank[big][:READMIT_SET_SAMPLES])
    after = w.flush(qs)
    launched = {"flush_extract": ek.flush_extract.launches - k1,
                "hll_insert": hll.insert_batch.launches - k4,
                "hll_estimate": hll.estimate.launches - k5}
    if after.degraded or min(launched.values()) < 1:
        raise AssertionError(f"phase 7 after re-admission: degraded "
                             f"{after.degraded}, launches {launched}")
    ref = tw.DeviceWorker(**INTERVAL_KW, device="cpu")
    for line in series[:20_000] + set_lines[:N_SETS_BIG]:
        ref.process_metric(parse(line))
    ref._flush_pending_sets()
    insert_sets(ref, srows[big][:READMIT_SET_SAMPLES],
                sidx[big][:READMIT_SET_SAMPLES],
                srank[big][:READMIT_SET_SAMPLES])
    compare_snapshots(after, ref.flush(qs), "phase 7 after re-admission "
                      "against the CPU")
    del w, ref, after
    log(f"[guard] phase 4's interval under faults by op {fired}: counters "
        f"{c}; the flush equals phase 4's, degraded; a failed probe, then "
        f"re-admission; a smaller interval on the card equal to the CPU's, "
        f"launches {launched}")
    log("[guard] faulted interval: " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items() if isinstance(v, float)))
    return {"faulted": faulted, "readmitted_launches": launched}


def phase_real_faults() -> dict:
    """tools/port_guard_faults.py: the real OOM here, the sticky fault in
    a child process."""
    oom = guard_faults.run_grow_oom()
    log(f"[guard] real OOM through the valve: growth to {oom['rows']} "
        f"rows, pre-flight {oom['preflight_bytes']} bytes with "
        f"{oom['headroom']} free: counters {oom['counters']}; degraded "
        f"flush equal to the CPU's, re-admitted, next flush on the card "
        f"equal too")
    sticky = guard_faults.run_sticky_fault()
    log(f"[guard] sticky fault in a child: kind {sticky['kind']}, CUDA "
        f"error {sticky['error_code']}, counters {sticky['counters']}, the "
        f"next interval on the CPU equal to a CPU worker's "
        f"({sticky['wall_s']:.1f} s)")
    return {"grow_oom": oom, "sticky_fault": sticky}


# -- phase 5 ------------------------------------------------------------------


# -- sink listeners (phases 5, 5b and 8) --------------------------------------


# request headers a sink sets; urllib's own (Host, User-Agent, ...) vary
SINK_HEADERS = ("content-type", "content-encoding", "x-sf-token",
                "x-insert-key")


class HttpTap:
    """A local HTTP listener that records every POST (path, the sink's
    headers, body) and answers 202."""

    def __init__(self) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        tap = self
        self.lock = threading.Lock()
        self.requests: list = []
        self.keys: set = set()

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                hdrs = tuple(sorted((k.lower(), v)
                                    for k, v in self.headers.items()
                                    if k.lower() in SINK_HEADERS))
                with tap.lock:
                    tap.requests.append((self.path, hdrs, body))
                    key = self.headers.get("Idempotency-Key")
                    if key is not None:
                        tap.keys.add(key)
                self.send_response(202)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def opener(self, req, timeout: float) -> bytes:
        """The sinks' opener: a request for another host goes to this
        listener instead, path and query kept (New Relic's collector URL
        is fixed by its region); nothing leaves the machine."""
        import urllib.parse
        import urllib.request

        from veneur_tpu_torch.utils.http import default_opener

        u = urllib.parse.urlsplit(req.full_url)
        local = urllib.request.Request(
            self.base + u.path + (f"?{u.query}" if u.query else ""),
            data=req.data, method=req.get_method(),
            headers=dict(req.header_items()))
        return default_opener(local, timeout)

    def taken(self) -> list:
        with self.lock:
            return sorted(self.requests)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class TcpTap:
    """A local TCP listener keeping the byte stream of each connection."""

    def __init__(self) -> None:
        import socket
        import threading

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.1)
        self.address = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.lock = threading.Lock()
        self.streams: list[bytearray] = []
        self.readers: list = []
        self.stop = False
        self.thread = threading.Thread(target=self._accept, daemon=True)
        self.thread.start()

    def _accept(self) -> None:
        import socket
        import threading

        while not self.stop:
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            buf = bytearray()
            reader = threading.Thread(target=self._read, args=(conn, buf),
                                      daemon=True)
            with self.lock:
                self.streams.append(buf)
                self.readers.append(reader)
            reader.start()

    def _read(self, conn, buf: bytearray) -> None:
        import socket

        conn.settimeout(0.1)
        with conn:
            while not self.stop:
                try:
                    data = conn.recv(1 << 20)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                with self.lock:
                    buf += data

    def taken(self) -> bytes:
        """Every byte received, once the sink's connection was accepted
        and closed (close_sink_sockets)."""
        deadline = time.monotonic() + 60
        while not self.readers and time.monotonic() < deadline:
            time.sleep(0.01)
        with self.lock:
            readers = list(self.readers)
        if not readers:
            raise AssertionError("the sink never connected")
        for reader in readers:
            reader.join(timeout=60)
            if reader.is_alive():
                raise AssertionError("a sink kept its TCP connection open")
        with self.lock:
            return b"".join(bytes(s) for s in self.streams)

    def close(self) -> None:
        self.stop = True
        self.thread.join(timeout=2)
        self.sock.close()


class SinkTaps:
    """Local listeners behind a server's Datadog (HTTP), Prometheus
    repeater (TCP) and forward-statsd (TCP) sinks."""

    def __init__(self) -> None:
        self.http, self.repeater, self.forward = (HttpTap(), TcpTap(),
                                                  TcpTap())

    def config(self) -> dict:
        return {"datadog_api_key": "smoke",
                "datadog_api_hostname": self.http.base,
                "datadog_flush_max_per_body": 2000,
                "prometheus_repeater_address": self.repeater.address,
                "prometheus_network_type": "tcp",
                "forward_statsd_address": self.forward.address,
                "forward_statsd_network": "tcp"}

    def taken(self) -> dict:
        return {"datadog": self.http.taken(),
                "prometheus": self.repeater.taken(),
                "forward_statsd": self.forward.taken()}

    def close(self) -> None:
        for tap in (self.http, self.repeater, self.forward):
            tap.close()


def pin_idempotency(server) -> None:
    """Idempotency keys carry a random sender token per process: pin it,
    so two servers' requests compare byte for byte."""
    for sink in server.metric_sinks:
        if getattr(sink, "delivery", None) is not None:
            sink.delivery._mint_sender = "chip-smoke"


def close_sink_sockets(server) -> None:
    for sink in server.metric_sinks:
        sock = getattr(sink, "_sock", None)
        if sock is not None:
            sock.close()
            sink._sock = None


def datadog_entries(requests) -> list:
    """The series entries of Datadog requests, inflated and parsed, as a
    sorted list of canonical JSON strings (a point's value as a float:
    the native tier writes an integral rate as an integer, which JSON
    reads as the same number); the other requests as they came."""
    import zlib

    out = []
    for path, _hdrs, body in requests:
        if path.startswith("/api/v1/series"):
            for e in json.loads(zlib.decompress(body))["series"]:
                e["points"] = [[ts, None if v is None else float(v)]
                               for ts, v in e["points"]]
                out.append(json.dumps(e, sort_keys=True))
        else:
            out.append(json.dumps([path, body.decode()]))
    return sorted(out)


def lines_of(stream: bytes) -> list:
    return sorted(stream.split(b"\n"))


# -- phases 5 and 5b ----------------------------------------------------------


def server_datagrams(seed: int, spill: bool, n: int = 300) -> list[bytes]:
    """Phase 5's traffic. spill=False: no series passes the staging depth
    (at most 60 samples a series), so the interval is bitwise the same on
    every path whenever the micro-fold scheduler drains. spill=True: the
    histograms api.payload and api.slow carry no tags and take all 300
    samples each, past the 64-deep staging plane, so the spill folds run;
    such an interval is bitwise the same only with matching batch cuts
    (micro_fold off)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    route = "" if spill else "|#route:r{}"
    out = []
    for i in range(n):
        k = i % 37
        tag = route.format(i % 5)
        lines = [
            f"api.requests:{1 + k % 3}|c|#route:r{k % 5}",
            f"api.sampled:{1 + k % 2}|c|@0.5",
            f"api.inflight:{rng.normal(20.0, 4.0):.4f}|g|#pod:p{k % 4}",
            f"api.latency:{rng.gamma(2.0, 12.0):.4f}|ms|"
            f"#route:r{(k if spill else i) % 5}",
            f"api.payload:{rng.lognormal(6.0, 1.0):.3f}|h{tag}",
            f"api.slow:{rng.exponential(200.0):.3f}|ms|@0.25{tag}",
            f"api.users:u{int(rng.integers(0, 5000))}|s",
            f"api.users:u{k}|s|#veneurlocalonly",
        ]
        out.append("\n".join(lines).encode())
    out.append(b"_sc|api.health|0|#pod:p1|m:serving")
    # the event carries its date (else it is the time it was parsed)
    out.append(b"_e{7,13}:deploy!|api v2 rolled|d:1700000000|#team:core")
    return out


def canonical(metrics) -> list[tuple]:
    return sorted(
        (m.name, m.timestamp, struct.pack("<d", float(m.value)),
         tuple(m.tags), m.type.name, m.message, m.hostname,
         None if m.sinks is None else tuple(sorted(m.sinks)))
        for m in metrics)


def server_config(native: bool, spill: bool) -> dict:
    cfg = {"statsd_listen_addresses": ["udp://127.0.0.1:0"],
           "interval": "1h", "percentiles": [0.5, 0.9, 0.99],
           "aggregates": ["min", "max", "count", "sum", "avg", "median"],
           "hostname": "chip-smoke", "tpu_native_ingest": native,
           "tpu_native_readers": native, "count_unique_timeseries": True}
    if spill:
        # the spill run's batch cuts are the datagrams' on every path
        cfg["micro_fold"] = False
    else:
        # the scheduler drains the native staging plane while the
        # datagrams arrive (the Python path stages at the flush)
        cfg["micro_fold_max_age_s"] = 0.02
    return cfg


def check_server_guard_clean(server, what: str, micro: bool = True) -> None:
    """The guard on, micro-folds as asked, no fault, trip or degraded
    flush."""
    w = server.workers[0]
    if not (w.micro_fold == micro and w.guard.enabled):
        raise AssertionError(f"{what}: micro_fold {w.micro_fold}, guard "
                             f"{w.guard.enabled}: not the defaults")
    if server.guard_counters() or server.host_fallbacks \
            or server.quarantined_workers:
        raise AssertionError(f"{what}: guard counters "
                             f"{server.guard_counters()}, host fallbacks "
                             f"{server.host_fallbacks}")


def serve_once(data: dict, grams: list, now: int):
    """A factory-built server on the card with a channel sink and the
    network sinks of SinkTaps: the datagrams over UDP to its listener,
    one flush. Returns (server, InterMetrics of the flush, InterMetrics
    the channel sink got, what each network sink's listener took)."""
    import socket

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    sink = ChannelMetricSink()
    taps = SinkTaps()
    server = build_server(load_config(data={**data, **taps.config()}),
                          extra_metric_sinks=[sink], device=DEVICE)
    pin_idempotency(server)
    ports = server.start()
    try:
        if data["tpu_native_readers"]:
            # the C++ reader took the socket: no Python reader runs
            import threading

            py_readers = [t.name for t in threading.enumerate()
                          if t.name.startswith("statsd-udp")]
            if not server.native_mode or server.native_reader_threads != 1 \
                    or py_readers:
                raise AssertionError(
                    f"native server: native_mode {server.native_mode}, C++ "
                    f"readers {server.native_reader_threads}, Python readers "
                    f"{py_readers}")
        port = ports["udp://127.0.0.1:0"]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for d in grams:
                s.sendto(d, ("127.0.0.1", port))
                time.sleep(0.0005)
        deadline = time.time() + 60
        while server.packets_received < len(grams) \
                and time.time() < deadline:
            time.sleep(0.05)
        if server.packets_received != len(grams):
            raise AssertionError(f"received {server.packets_received} of "
                                 f"{len(grams)} datagrams")
        got = server.flush(now=now)
    finally:
        server.shutdown()
        close_sink_sockets(server)
    try:
        taken = taps.taken()
    finally:
        taps.close()
    delivered = []
    while not sink.queue.empty():
        delivered.extend(sink.queue.get_nowait())
    return server, got.materialize(), delivered, taken


def check_sink_counts(server, taken: dict, what: str) -> None:
    """Every network sink flushed without an error and its listener took
    bytes; nothing is left spilled."""
    counts = server.sink_counters()
    for name in taken:
        c = counts.get(name)
        if c is None or c["flush_error_total"] or \
                c["metrics_flushed_total"] < 1 or not taken[name]:
            raise AssertionError(f"{what}: sink {name}: {c}")
    for name, d in server.delivery_stats().items():
        if d["spilled_payloads"] or d["dropped_payloads"] or \
                d["delivered_payloads"] < 1:
            raise AssertionError(f"{what}: delivery of {name}: {d}")


def phase_server(ek, spill: bool):
    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server

    data = server_config(native=False, spill=spill)
    grams = server_datagrams(seed=9, spill=spill)
    what = "phase 5 (spill, micro_fold off)" if spill else "phase 5"
    before = ek.flush_extract.launches
    now = 1_700_000_000
    server, got, delivered, taken = serve_once(data, grams, now)
    check_server_guard_clean(server, what, micro=not spill)
    check_sink_counts(server, taken, what)
    launched = ek.flush_extract.launches - before
    taps = SinkTaps()
    ref_server = build_server(load_config(data={
        **data, "statsd_listen_addresses": [], **taps.config()}),
        device="cpu")
    pin_idempotency(ref_server)
    for d in grams:
        ref_server.process_metric_packet(d)
    try:
        ref = ref_server.flush(now=now).materialize()
        close_sink_sockets(ref_server)
        ref_taken = taps.taken()
    finally:
        ref_server.shutdown()
        taps.close()
    check_server_guard_clean(ref_server, f"{what}, CPU server",
                             micro=not spill)
    if canonical(got) != canonical(ref) or \
            canonical(delivered) != canonical(got):
        raise AssertionError("CUDA server InterMetrics != CPU server's")
    if taken != ref_taken:
        raise AssertionError(f"{what}: the card server's sinks sent other "
                             "bytes than the CPU server's")
    tally = server.last_unique_timeseries
    if tally is None or tally != ref_server.last_unique_timeseries \
            or tally < 1:
        raise AssertionError(f"unique-timeseries tally {tally} != CPU "
                             f"server's {ref_server.last_unique_timeseries}")
    users = [m.value for m in got if m.name == "api.users"]
    if len(users) != 2:
        raise AssertionError("the set gauges are missing")
    if launched < 1:
        raise AssertionError("the server flush launched no kernel")
    vals = [m.value for m in got]
    if not vals or any(v != v for v in vals):
        raise AssertionError("server emitted no or non-finite values")
    log(f"[server{' spill' if spill else ''}] {len(grams)} UDP datagrams -> "
        f"{len(got)} InterMetrics "
        f"on {server.device}, equal to the CPU server's; set gauges "
        f"api.users {sorted(users)}; unique timeseries {tally} on both; "
        f"flush_extract launches during the flush: {launched}; micro-folds "
        f"{server.workers[0].micro_folds_total}; sinks: " + ", ".join(
            f"{k} {len(v)} {'requests' if k == 'datadog' else 'bytes'}"
            for k, v in taken.items()) + ", equal to the CPU server's")
    return grams, canonical(ref), ref_server.last_unique_timeseries, taken


def phase_native_server(grams, ref, ref_tally, ref_taken, spill: bool):
    """Phase 5's datagrams through a server with tpu_native_ingest and
    tpu_native_readers on (a C++ reader thread on the UDP socket): its
    InterMetrics equal the Python-path CPU server's of phase 5, and so
    does what its sinks sent, as multisets (the C++ directory may order
    the rows otherwise): the Datadog series entries and the other
    requests, the repeater's and forward-statsd's lines."""
    t0 = time.perf_counter()
    server, got, delivered, taken = serve_once(
        server_config(native=True, spill=spill), grams, 1_700_000_000)
    wall = time.perf_counter() - t0
    what = "phase 5b (spill, micro_fold off)" if spill else "phase 5b"
    check_server_guard_clean(server, what, micro=not spill)
    check_sink_counts(server, taken, what)
    if datadog_entries(taken["datadog"]) != \
            datadog_entries(ref_taken["datadog"]) or any(
            lines_of(taken[k]) != lines_of(ref_taken[k])
            for k in ("prometheus", "forward_statsd")):
        raise AssertionError(f"{what}: the native server's sinks sent "
                             "other metrics than the CPU server's")
    if not spill and server.workers[0].micro_folds_total < 1:
        raise AssertionError("the native server's scheduler ran no "
                             "micro-fold")
    if canonical(got) != ref or canonical(delivered) != ref:
        raise AssertionError("native server InterMetrics != the Python-path "
                             "CPU server's")
    if server.last_unique_timeseries != ref_tally:
        raise AssertionError(f"native server tally "
                             f"{server.last_unique_timeseries} != {ref_tally}")
    if server.native_reader_threads != 0:
        raise AssertionError("a C++ reader outlived shutdown")
    log(f"[native server{' spill' if spill else ''}] {len(grams)} UDP "
        f"datagrams read by a C++ reader "
        f"thread (native_mode on, no Python reader) -> {len(got)} "
        f"InterMetrics on {server.device}, equal to the Python-path CPU "
        f"server's, and so are its sinks' series and lines; unique "
        f"timeseries {ref_tally}; micro-folds "
        f"{server.workers[0].micro_folds_total}; {wall:.2f} s")


# -- phase 8 ------------------------------------------------------------------


EGRESS_AGGS = ["min", "max", "count", "sum", "avg", "median", "hmean"]
EGRESS_NOW = 1_700_000_000
# the port's native encoders, each counted while phase 8's sinks flush
ENCODERS = ("encode_datadog_series", "encode_signalfx_body",
            "encode_prometheus_lines", "encode_forward_lines",
            "encode_prometheus_exposition")


@contextlib.contextmanager
def counting_encoders():
    """Count each native encoder's calls and the calls that returned a
    payload (None sends the group to the Python formatter)."""
    from veneur_tpu_torch import native

    counts = {name: [0, 0] for name in ENCODERS}
    saved = {name: getattr(native, name) for name in ENCODERS}

    def wrap(name):
        def call(*args, **kw):
            out = saved[name](*args, **kw)
            counts[name][0] += 1
            counts[name][1] += out is not None
            return out
        return call

    for name in ENCODERS:
        setattr(native, name, wrap(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def batch_arrays_equal(a, b, what: str) -> None:
    """Two ColumnarMetrics batches: every group's arrays bitwise, arenas
    and row metadata equal, the extras equal."""
    if len(a.groups) != len(b.groups):
        raise AssertionError(f"{what}: groups differ")
    for gi, (ga, gb) in enumerate(zip(a.groups, b.groups)):
        if (ga.nrows, ga.has_routing) != (gb.nrows, gb.has_routing) or \
                bytes(ga.meta_blob or b"") != bytes(gb.meta_blob or b"") \
                or (ga.meta_blob is None) != (gb.meta_blob is None):
            raise AssertionError(f"{what}: group {gi} rows or arena differ")
        if [(f.suffix, f.type) for f in ga.families] != \
                [(f.suffix, f.type) for f in gb.families]:
            raise AssertionError(f"{what}: group {gi} families differ")
        for fa, fb in zip(ga.families, gb.families):
            if fa.values.tobytes() != fb.values.tobytes() or \
                    (fa.mask is None) != (fb.mask is None) or (
                        fa.mask is not None
                        and fa.mask.tobytes() != fb.mask.tobytes()):
                raise AssertionError(f"{what}: group {gi} family "
                                     f"{fa.suffix!r} differs")
    if canonical(a.extras) != canonical(b.extras):
        raise AssertionError(f"{what}: extras differ")


def egress_server(http: HttpTap, repeater: TcpTap, forward: TcpTap):
    """A factory-built server on the card whose metric sinks are every
    ported network sink, pointed at the local listeners."""
    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server

    data = {"interval": "1h", "hostname": "chip-smoke",
            "percentiles": QS, "aggregates": EGRESS_AGGS,
            "tags": ["smoke:8"],
            "datadog_api_key": "smoke", "datadog_api_hostname": http.base,
            "signalfx_api_key": "smoke", "signalfx_endpoint_base": http.base,
            "prometheus_repeater_address": repeater.address,
            "prometheus_network_type": "tcp",
            "prometheus_pushgateway_address":
                f"{http.base}/metrics/job/smoke",
            "forward_statsd_address": forward.address,
            "forward_statsd_network": "tcp",
            "newrelic_insert_key": "smoke", "newrelic_account_id": 8}
    server = build_server(load_config(data=data), device=DEVICE,
                          opener=http.opener)
    pin_idempotency(server)
    for sink in server.metric_sinks:
        # New Relic's URL names its public collector: its requests must
        # go through the listener's opener
        if getattr(sink, "opener", http.opener) != http.opener:
            raise AssertionError(f"sink {sink.name()} has its own opener")
    return server


def emit_once(batch, native: bool) -> dict:
    """Each sink of egress_server flushes the batch in turn through the
    server's negotiation, the native tier on or off; per sink its
    seconds, what its listener took, and the native encoder calls."""
    http, repeater, forward = HttpTap(), TcpTap(), TcpTap()
    server = egress_server(http, repeater, forward)
    server.flush_emit_native = native
    out = {}
    try:
        for sink in server.metric_sinks:
            with counting_encoders() as enc:
                t0 = time.perf_counter()
                server._flush_sink_columnar(sink, batch, None)
                secs = time.perf_counter() - t0
            out[type(sink).__name__] = {"s": secs, "encoders": {
                k: v for k, v in enc.items() if v[0]}}
        close_sink_sockets(server)
        taken = {"http": http.taken(), "http_keys": sorted(http.keys),
                 "repeater": repeater.taken(), "forward": forward.taken()}
        counts = server.sink_counters()
        delivery = server.delivery_stats()
    finally:
        server.shutdown()
        for tap in (http, repeater, forward):
            tap.close()
    for name, c in counts.items():
        if c["flush_error_total"] or c["metrics_flushed_total"] < 1:
            raise AssertionError(f"phase 8: sink {name}: {c}")
    for name, d in delivery.items():
        if d["spilled_payloads"] or d["dropped_payloads"]:
            raise AssertionError(f"phase 8: delivery of {name}: {d}")
    return {"sinks": out, "taken": taken}


def http_by_sink(requests) -> dict:
    """The HTTP requests by sink, from their paths."""
    out = {"datadog": [], "signalfx": [], "exposition": [], "newrelic": []}
    for r in requests:
        path = r[0]
        key = ("datadog" if path.startswith(("/api/", "/intake")) else
               "signalfx" if path.startswith("/v2/") else
               "exposition" if path.startswith("/metrics/") else
               "newrelic" if path.startswith("/v1/accounts/") else None)
        if key is None:
            raise AssertionError(f"phase 8: request to {path}")
        out[key].append(r)
    return out


def signalfx_points(requests) -> list:
    out = []
    for path, _hdrs, body in requests:
        if path.startswith("/v2/datapoint"):
            for kind, pts in json.loads(body).items():
                for p in pts:
                    p["value"] = float(p["value"])
                    out.append(json.dumps([kind, p], sort_keys=True))
    return sorted(out)


def phase_egress(snap_g, snap_c) -> dict:
    """Phase 8: phase 4's 100k-series snapshot from the card through
    generate_columnar (held to the object path, and to the CPU
    snapshot's batch bitwise), then through every ported metric sink to
    local listeners: native tier on and off on the card's batch, native
    on the CPU's. Raises on any difference."""
    import zlib

    from veneur_tpu_torch.core.flusher import (generate_columnar,
                                               generate_inter_metrics)
    from veneur_tpu_torch.core.metrics import HistogramAggregates

    aggs = HistogramAggregates.from_names(EGRESS_AGGS)
    t0 = time.perf_counter()
    objs = generate_inter_metrics(snap_g, False, QS, aggs, now=EGRESS_NOW)
    t_obj = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = generate_columnar(snap_g, False, QS, aggs, now=EGRESS_NOW)
    t_col = time.perf_counter() - t0
    t0 = time.perf_counter()
    mats = batch.materialize()
    t_mat = time.perf_counter() - t0
    if len(batch) != len(objs) or canonical(mats) != canonical(objs):
        raise AssertionError("phase 8: materialize() != the object path")
    del objs, mats
    batch_c = generate_columnar(snap_c, False, QS, aggs, now=EGRESS_NOW)
    batch_arrays_equal(batch, batch_c, "phase 8, card against CPU")
    plans = batch.emit_plan()
    if not plans or any(p is None for p in plans):
        raise AssertionError("phase 8: a group has no native emit plan")
    log(f"[egress] {len(batch)} metrics in {len(batch.groups)} groups; "
        f"generate_s object {t_obj:.4f}, columnar {t_col:.4f} "
        f"(materialize {t_mat:.4f}); materialize() equal to the object "
        f"path; the batch bitwise equal to the CPU snapshot's")

    runs = {"native": emit_once(batch, True),
            "python": emit_once(batch, False),
            "cpu_native": emit_once(batch_c, True)}
    # the native tier took every group of every native-capable sink
    for name, rec in runs["native"]["sinks"].items():
        enc = rec["encoders"]
        if name == "NewRelicMetricSink":
            if enc:
                raise AssertionError("phase 8: New Relic called an encoder")
            continue
        calls = sum(v[0] for v in enc.values())
        done = sum(v[1] for v in enc.values())
        if calls != len(batch.groups) or done != calls:
            raise AssertionError(f"phase 8: {name}: native encoders took "
                                 f"{done} of {len(batch.groups)} groups")
    for name, rec in runs["python"]["sinks"].items():
        if rec["encoders"]:
            raise AssertionError(f"phase 8: {name} encoded natively with "
                                 "the tier off")
    nat, py, cpu = (runs[k]["taken"] for k in ("native", "python",
                                                "cpu_native"))
    # card against CPU: every byte, the Datadog bodies raw and inflated
    if nat != cpu:
        raise AssertionError("phase 8: the card batch's sinks sent other "
                             "bytes than the CPU batch's")
    hn, hp, hc = (http_by_sink(x["http"]) for x in (nat, py, cpu))
    inflate = [zlib.decompress(b) for p, _h, b in hn["datadog"]
               if p.startswith("/api/v1/series")]
    if inflate != [zlib.decompress(b) for p, _h, b in hc["datadog"]
                   if p.startswith("/api/v1/series")]:
        raise AssertionError("phase 8: inflated Datadog bodies differ")
    # native against Python: byte for byte where the formats are one
    # (lines, exposition text, New Relic), else the same series and
    # points (the native JSON bodies are compact and chunked per group)
    if nat["repeater"] != py["repeater"] or nat["forward"] != py["forward"]:
        raise AssertionError("phase 8: native lines != Python lines")
    if hn["exposition"] != hp["exposition"] or \
            hn["newrelic"] != hp["newrelic"]:
        raise AssertionError("phase 8: native exposition or New Relic "
                             "bytes != Python's")
    if datadog_entries(hn["datadog"]) != datadog_entries(hp["datadog"]):
        raise AssertionError("phase 8: native Datadog series != Python's")
    if signalfx_points(hn["signalfx"]) != signalfx_points(hp["signalfx"]):
        raise AssertionError("phase 8: native SignalFx points != Python's")

    sinks = {name: {f"{run}_s": runs[run]["sinks"][name]["s"]
                    for run in runs} for name in runs["native"]["sinks"]}
    for name, key in (("DatadogMetricSink", "datadog"),
                      ("SignalFxMetricSink", "signalfx"),
                      ("PrometheusExpositionSink", "exposition"),
                      ("NewRelicMetricSink", "newrelic")):
        sinks[name].update(
            requests=len(hn[key]), python_requests=len(hp[key]),
            bytes=sum(len(b) for _p, _h, b in hn[key]))
    sinks["PrometheusMetricSink"].update(
        requests=1, bytes=len(nat["repeater"]))
    sinks["ForwardStatsdSink"].update(requests=1, bytes=len(nat["forward"]))
    for name, s in sinks.items():
        log(f"[egress] {name}: native {s['native_s']:.4f} s, Python "
            f"{s['python_s']:.4f} s (CPU batch native "
            f"{s['cpu_native_s']:.4f} s); {s['requests']} requests, "
            f"{s['bytes']} bytes")
    log("[egress] every sink's bytes from the card batch equal the CPU "
        "batch's; native equal to Python; the native tier took every "
        "group of every native-capable sink")
    return {"metrics": len(batch), "groups": len(batch.groups),
            "generate_object_s": t_obj, "generate_columnar_s": t_col,
            "materialize_s": t_mat, "sinks": sinks}


# -- main ---------------------------------------------------------------------


def reset_launches(ek, hll) -> None:
    ek.flush_extract.launches = 0
    for r in ek.variant_launches:
        ek.variant_launches[r] = 0
    hll.insert_batch.launches = hll.estimate.launches = 0


def read_launches(ek, hll) -> dict:
    """Each kernel's launches since reset_launches, by kernels-line name."""
    return {"flush_extract": ek.flush_extract.launches,
            **{f"flush_extract_r{r}": n
               for r, n in ek.variant_launches.items()},
            "hll_insert": hll.insert_batch.launches,
            "hll_estimate": hll.estimate.launches}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: the port's smoke test needs a card",
              file=sys.stderr)
        return 2
    if not (ROOT / "veneur_tpu_torch" / "csrc").is_dir():
        print("veneur_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    global probe, probe_hll, guard_faults
    import port_guard_faults as guard_faults
    import port_probe_extract as probe
    import port_probe_hll as probe_hll

    # 1. setup
    card = probe.card_line()
    log(f"[setup] card: {card}")
    log(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}"
        f", cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from veneur_tpu_torch.core import worker as tw
    from veneur_tpu_torch.core.flusher import (device_quantiles,
                                               generate_inter_metrics)
    from veneur_tpu_torch.core.metrics import HistogramAggregates
    from veneur_tpu_torch.ops import extract_kernel as ek
    from veneur_tpu_torch.ops import hll, hll_kernel
    from veneur_tpu_torch.protocol.dogstatsd import parse_metric
    from veneur_tpu_torch import native

    t_start = t0 = time.perf_counter()
    # one nvcc per kernel source and the g++ of the native library,
    # started together
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(ek.build), pool.submit(hll_kernel.build),
                  pool.submit(native.build)]
        lib_paths = [f.result() for f in builds]
    ek.load()
    hll_kernel.load()
    if native.source_hash() != native.source_stamp():
        raise AssertionError("the native library's source stamp is not its "
                             "sources' hash")
    log(f"[setup] built and loaded "
        f"{', '.join(str(p.relative_to(ROOT)) for p in lib_paths)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for r, rep in sorted(ek.build_report().items()):
        log(f"[setup] ptxas flush_extract r{r}: " + ", ".join(
            f"{k} {v}" for k, v in rep.items()))
    hll_build = hll_kernel.build_report()
    for name, rep in sorted(hll_build.items()):
        log(f"[setup] ptxas {name}: " + ", ".join(
            f"{k} {v}" for k, v in rep.items()))
    wall = {"setup_s": time.perf_counter() - t_start}

    # 2. kernel vs plain, 3. the variant probe, 3b. the HLL kernels
    t0 = time.perf_counter()
    fields, qs3, plain_check, kres = phase_kernel_vs_plain(ek)
    wall["kernel_vs_plain_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    variants = probe.probe_variants(fields, qs3, plain_check)
    if not all(v["bitwise"] for v in variants):
        raise AssertionError("a variant is not bitwise equal to the plain "
                             "version")
    yardstick = probe.read_yardstick(fields)
    del fields, plain_check
    wall["variant_probe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hll_checks = {"hll_insert": probe_hll.check_insert(hll),
                  "hll_estimate": probe_hll.check_estimate(hll)}
    hll_times = probe_hll.time_kernels(hll)
    wall["hll_kernels_s"] = time.perf_counter() - t0

    # 4 + 5: the main path, launch counts reset just before
    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    qs = device_quantiles(QS, aggs)

    def generate(snap):
        """A standalone server's InterMetrics for the snapshot."""
        return generate_inter_metrics(snap, False, QS, aggs, now=0)

    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases, plan, python_snap, cpu_snap = phase_worker(
        tw, generate, parse_metric, qs)
    wall["worker_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phases["dense_sets"] = phase_dense_sets(tw, parse_metric, hll)
    wall["dense_sets_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phases["native"], steps = phase_native(tw, ek, hll, qs, plan,
                                           python_snap)
    wall["native_s"] = time.perf_counter() - t0
    wall["server_s"] = wall["native_server_s"] = 0.0
    for spill in (False, True):
        t0 = time.perf_counter()
        server_grams, server_ref, server_tally, server_taken = \
            phase_server(ek, spill)
        wall["server_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_native_server(server_grams, server_ref, server_tally,
                            server_taken, spill)
        wall["native_server_s"] += time.perf_counter() - t0
    launches = read_launches(ek, hll)
    for name in ("flush_extract", "hll_insert", "hll_estimate"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main "
                                 f"path")
    # 8: the egress of phase 4's snapshot (host work: no kernel runs)
    t0 = time.perf_counter()
    phases["egress"] = phase_egress(python_snap, cpu_snap)
    del cpu_snap
    wall["egress_s"] = time.perf_counter() - t0
    # this slice's own paths, each counted from 0 just before its run
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["micro"] = phase_micro(tw, parse_metric, qs, plan, steps,
                                  python_snap, phases)
    del steps
    wall["micro_s"] = time.perf_counter() - t0
    launches_micro = read_launches(ek, hll)
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["guard"] = phase_guard(tw, ek, hll, parse_metric, qs, plan,
                                  python_snap)
    del plan, python_snap
    launches_guard = read_launches(ek, hll)
    reset_launches(ek, hll)
    phases["guard"].update(phase_real_faults())
    launches_guard_oom = read_launches(ek, hll)
    phases["guard"]["guard_cost"] = guard_cost()
    wall["guard_s"] = time.perf_counter() - t0

    def counts(name: str) -> dict:
        return {"launches": launches[name],
                "launches_micro": launches_micro[name],
                "launches_guard": launches_guard[name],
                "launches_guard_oom": launches_guard_oom[name]}

    source = "veneur_tpu_torch/csrc/flush_extract.cu"
    kernels = {"kernels": [{
        "name": "flush_extract", "route": "cuda", "source": source,
        "replaces": "veneur_tpu/ops/pallas_kernels.py:36",
        **counts("flush_extract"), "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"], "plain_ms": kres["plain_ms"],
        "bound_ms": kres["bound_ms"], "bound_by": kres["bound_by"],
        "library_ms": None, "rows_per_warp": ek.ROWS_PER_WARP,
        "at_main_path": kres["at_main_path"]}]}
    for v in variants:
        r = v["rows_per_warp"]
        kernels["kernels"].append({
            "name": f"flush_extract_r{r}", "route": "cuda",
            "source": source,
            "replaces": "tools/probe_pallas_variants.py:130",
            **counts(f"flush_extract_r{r}"),
            "max_abs_err": v["max_abs_err"],
            "ms": v["ms"], "plain_ms": kres["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None, "rows_per_warp": r,
            "bitwise": v["bitwise"], "build": v["build"],
            **{k: v.get(k) for k in (
                "registers", "spill_stores", "spill_loads", "local_bytes",
                "static_smem_bytes", "dynamic_smem_bytes",
                "blocks_per_sm")}})
    for name, line in (("hll_insert", 73), ("hll_estimate", 126)):
        t = hll_times[name]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "veneur_tpu_torch/csrc/hll.cu",
            "replaces": f"veneur_tpu/ops/hll.py:{line}",
            **counts(name),
            "max_abs_err": hll_checks[name]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "build": hll_build.get(name, "no ptxas report"),
            **{k: t[k] for k in ("rows", "precision", "batch",
                                 "library_note", "noop_ms", "noop_grid",
                                 "ms_main_path", "ms_distinct", "ms_big",
                                 "big_batch", "bound_ms_big",
                                 "library_ms_big") if k in t}})
    wall["total_s"] = time.perf_counter() - t_start
    log("[timing] " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, **kernels, "worker": phases,
             "yardstick": yardstick, "wall_s": wall, **result},
            indent=1))
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
