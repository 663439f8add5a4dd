"""The port's set path against the JAX package's, on the CPU.

* ``StagedSetStore`` (sparse host tier, dense device tier) against the
  reference's store with no guard: a small ``compact_every`` and
  ``promote_entries`` so compaction and promotion run many times,
  ``import_dense`` in between; ``estimates``, ``registers``,
  ``sparse_entries`` and ``dense_rows`` equal after every step, at
  p = 4, 8, 14 and 18.
* Three worker intervals with set lines (mixed-scope, local-only and
  global-only sets; other metric types beside them) through both
  ``DeviceWorker``s: at p = 8, where sets of a few hundred members
  promote, and at p = 14 with one set of about 3,000 members; for both
  set stores and both set hashes, with count_unique_timeseries on. Every
  snapshot array bitwise equal (set estimates and registers and the
  unique-timeseries registers included), and the InterMetrics each
  package's flusher makes of them equal, as a local and as a global tier.
* The servers: set datagrams through the JAX server and the port's server
  (built by its factory, count_unique_timeseries on) give equal
  InterMetrics, and the port's ``last_unique_timeseries`` is the value the
  JAX server sends as flush.unique_timeseries_total.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import pytest
import torch

from veneur_tpu import scopedstatsd
from veneur_tpu.core import flusher as jflusher
from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.ops import hll as jhll
from veneur_tpu.ops.staged_sets import StagedSetStore as JStore
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.core import flusher as tflusher
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.ops.staged_sets import StagedSetStore as TStore
from veneur_tpu_torch.protocol import dogstatsd as tdog
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TChannel

NOW = 1_700_000_000


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    if a.dtype.kind == "f":
        assert np.array_equal(np.isnan(a), np.isnan(b)), what
        ok = ~np.isnan(a)
        a, b = a[ok], b[ok]
    assert a.tobytes() == b.tobytes(), what


def _canonical(metrics) -> list[tuple]:
    return sorted(
        (m.name, m.timestamp, struct.pack("<d", float(m.value)),
         tuple(m.tags), m.type.name, m.message, m.hostname,
         None if m.sinks is None else tuple(sorted(m.sinks)))
        for m in metrics)


# -- the staged store ---------------------------------------------------------


def _store_states_equal(js, ts, n, what):
    assert js.sparse_entries == ts.sparse_entries, what
    assert js.dense_rows == ts.dense_rows, what
    _same(js.estimates(n), ts.estimates(n), (what, "estimates"))
    _same(js.registers(n), ts.registers(n), (what, "registers"))
    assert js.sparse_entries == ts.sparse_entries, what


@pytest.mark.parametrize("p", [4, 8, 14, 18])
def test_staged_store_bitwise(p):
    m = 1 << p
    promote = min(m // 2, 40)
    js = JStore(p, promote_entries=promote, compact_every=64)
    ts = TStore(p, promote_entries=promote, compact_every=64, device="cpu")
    rng = np.random.default_rng(p)
    n_rows = 30
    for step in range(14):
        k = int(rng.integers(1, 300))
        # rows 0-3 are hot (many distinct registers: they promote)
        rows = np.where(rng.random(k) < 0.5, rng.integers(0, 4, k),
                        rng.integers(0, n_rows, k)).astype(np.int32)
        idx, rank = thll.split_hashes(
            rng.integers(0, 2**64, k, dtype=np.uint64), p)
        js.insert(rows, idx, rank)
        ts.insert(rows, idx, rank)
        assert js.sparse_entries == ts.sparse_entries, step
        assert js.dense_rows == ts.dense_rows, step
        if step in (4, 9):
            for row in (0, 7, n_rows + 2):  # dense, sparse, new
                regs = np.zeros(m, np.int8)
                live = rng.random(m) < 0.3
                regs[live] = rng.integers(1, 64 - p + 2, int(live.sum()))
                js.import_dense(row, regs)
                ts.import_dense(row, regs)
        if step in (6, 13):
            _store_states_equal(js, ts, n_rows + 3, f"step {step}")
    assert ts.dense_rows >= 4  # promotion ran
    assert ts._dense.dtype == torch.int8 and ts._dense.device.type == "cpu"


# -- worker intervals ---------------------------------------------------------


def _set_lines(seed, p):
    """One interval's lines: sets of 1 to a few hundred members
    (mixed-scope by default, local-only, global-only), at p = 14 one set
    of about 3,000 members; histograms, counters and gauges beside them."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(24):
        tag = ("|#veneurlocalonly" if i % 3 == 1 else
               "|#veneurglobalonly" if i % 5 == 2 else f"|#s:{i % 4}")
        members = int(rng.integers(1, 400)) if i % 4 == 0 else \
            int(rng.integers(1, 30))
        for j in range(members):
            out.append(f"users.{i}:u{int(rng.integers(0, 10 * members))}"
                       f"|s{tag}")
    if p == 14:
        out += [f"big:m{j}|s" for j in range(3000 + seed)]
    for i in range(40):
        out.append(f"lat{i % 9}:{rng.normal(50, 9):.3f}|ms")
        out.append(f"c{i % 5}:1|c")
        out.append(f"g{i % 6}:{i}|g|#veneurlocalonly")
    order = rng.permutation(len(out))
    return [out[k].encode() for k in order]


def _snapshots_equal(a, b, what):
    for f in dataclasses.fields(a):
        if f.name in ("directory", "scalars"):
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, (what, f.name)
            _same(va, vb, (what, f.name))
        else:
            assert va == vb, (what, f.name, va, vb)
    rows = [[(r.key.name, r.key.type, r.key.joined_tags, list(r.tags),
              int(r.scope_class)) for r in s.directory.sets.rows]
            for s in (a, b)]
    assert rows[0] == rows[1], what


@pytest.mark.parametrize("p", [8, 14])
@pytest.mark.parametrize("set_hash", ["fnv", "metro"])
@pytest.mark.parametrize("store", ["staged", "dense"])
def test_three_intervals_with_sets_bitwise(store, set_hash, p):
    is_local = (store == "staged") != (set_hash == "metro")
    kw = dict(hll_precision=p, set_store=store, set_hash=set_hash,
              count_unique_timeseries=True, is_local=is_local,
              batch_size=64, initial_set_rows=8, initial_histo_rows=8,
              stage_depth=8)
    jworker = jw.DeviceWorker(**kw)
    tworker = tw.DeviceWorker(**kw, device="cpu")
    aggs = jflusher.HistogramAggregates.from_names(["min", "max", "count"])
    qs = jflusher.device_quantiles([0.5, 0.99], aggs)
    promoted = 0
    for seed in (1, 2, 3):
        lines = _set_lines(seed, p)
        if store == "staged":
            # compact (and so promote) every 128 pending inserts, not the
            # default 65,536, so a small interval promotes rows
            jworker._staged_sets.compact_every = 128
            tworker._staged_sets.compact_every = 128
        for line in lines:
            jworker.process_metric(jdog.parse_metric(line))
            tworker.process_metric(tdog.parse_metric(line))
        tstore = tworker._staged_sets
        if tstore is not None:
            assert jworker._staged_sets.dense_rows == tstore.dense_rows
            promoted = max(promoted, tstore.dense_rows)
        js, ts = jworker.flush(qs), tworker.flush(qs)
        assert ts.set_estimates is not None
        assert ts.unique_timeseries_registers.any()
        _snapshots_equal(js, ts, f"interval {seed}")
        assert "sets_s" in tworker.last_extract_phases
        jm = jflusher.generate_inter_metrics(js, is_local, [0.5, 0.99],
                                             aggs, now=NOW)
        tm = tflusher.generate_inter_metrics(ts, is_local, [0.5, 0.99],
                                             aggs, now=NOW)
        assert _canonical(jm) == _canonical(tm), f"interval {seed}"
        gauges = {m.name for m in tm if m.name.startswith("users.")}
        # local-only sets always flush, mixed ones only on a global tier
        assert "users.1" in gauges
        assert ("users.0" in gauges) == (not is_local)
    if store == "staged":
        assert promoted >= 1
    assert jworker.processed_total == tworker.processed_total


def test_dense_pool_grows_like_the_reference():
    kw = dict(hll_precision=6, set_store="dense", batch_size=16,
              initial_set_rows=4)
    jworker = jw.DeviceWorker(**kw)
    tworker = tw.DeviceWorker(**kw, device="cpu")
    sizes = []
    for n in (1, 3, 4, 9, 40):
        for i in range(n):
            line = f"set{i}:v{n}|s".encode()
            jworker.process_metric(jdog.parse_metric(line))
            tworker.process_metric(tdog.parse_metric(line))
        sizes.append((jworker._sets.shape, tuple(tworker._sets.shape)))
    assert all(a == b for a, b in sizes), sizes
    jworker._flush_pending_sets()
    tworker._flush_pending_sets()
    _same(np.asarray(jworker._sets), tworker._sets.numpy(), "dense pool")


def test_pool_carried_across_into_a_worker_epoch():
    """A JAX-built dense pool carried into the port's worker with
    pool_from_numpy and continued there and in the reference."""
    kw = dict(hll_precision=8, set_store="dense", batch_size=32,
              initial_set_rows=16)
    jworker = jw.DeviceWorker(**kw)
    tworker = tw.DeviceWorker(**kw, device="cpu")
    lines = [f"s{i % 5}:x{i}|s".encode() for i in range(200)]
    for line in lines:
        jworker.process_metric(jdog.parse_metric(line))
        tworker.process_metric(tdog.parse_metric(line))
    jworker._flush_pending_sets()
    tworker._flush_pending_sets()
    tworker._sets = thll.pool_from_numpy(np.asarray(jworker._sets), "cpu")
    for line in [f"s{i % 7}:y{i}|s".encode() for i in range(300)]:
        jworker.process_metric(jdog.parse_metric(line))
        tworker.process_metric(tdog.parse_metric(line))
    qs = np.array([0.5])
    js, ts = jworker.flush(qs), tworker.flush(qs)
    _same(js.set_estimates, ts.set_estimates, "estimates")
    _same(js.set_registers, ts.set_registers, "registers")
    _same(jhll.estimate(js.set_registers, precision=8),
          thll.estimate(torch.from_numpy(ts.set_registers), 8).numpy(),
          "re-estimated")


# -- servers ------------------------------------------------------------------

BASE = {
    # each flush is itself a span that derives an ssf.names_unique set
    # at this rate from the unseeded global random; 0 keeps multi-flush
    # comparisons deterministic (test_torch_spans.py seeds it)
    "ssf_span_uniqueness_rate": 0.0,
    "percentiles": [0.5, 0.99],
    "aggregates": ["min", "max", "count"],
    "interval": "10s",
    "hostname": "parity-host",
    "tpu_native_ingest": False,
    "tpu_native_readers": False,
    "flush_emit_native": False,
    "micro_fold": False,
    "tpu_stage_depth": 8,
    "tpu_batch_size": 64,
    "tpu_initial_histo_rows": 16,
    "tpu_initial_set_rows": 8,
    "count_unique_timeseries": True,
}


def _datagrams(seed: int, n: int = 50) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = i % 17
        lines = [
            f"api.users:u{int(rng.integers(0, 300))}|s",
            f"api.users:u{k}|s|#route:r{k % 3}",
            f"api.ips:10.0.{k}.{int(rng.integers(0, 99))}|s|#veneurlocalonly",
            f"req.count:{1 + k % 3}|c|#route:{k % 4}",
            f"lat.ms:{rng.gamma(2.0, 15.0):.4f}|ms|#ep:e{k}",
            f"cpu.load:{rng.normal(1.0, 0.3):.5f}|g|#host:h{k % 3}",
        ]
        out.append("\n".join(lines).encode())
    return out


def _drain(q):
    out = []
    while not q.empty():
        out.extend(q.get_nowait())
    return out


@pytest.mark.parametrize("store,set_hash,workers,p", [
    ("staged", "fnv", 1, 14), ("dense", "metro", 2, 10),
    ("staged", "metro", 2, 4)])
def test_server_sets_and_unique_timeseries(store, set_hash, workers, p):
    extra = {"tpu_set_store": store, "set_hash": set_hash,
             "num_workers": workers, "tpu_hll_precision": p}
    jcfg = jload(data={**BASE, **extra})
    jsink = JChannel()
    js = JServer(jcfg, metric_sinks=[jsink])
    cap = scopedstatsd.CaptureSender()
    js.stats = scopedstatsd.ScopedClient(cap, namespace="veneur.")
    tsink = TChannel()
    ts = build_server(tload(data={**BASE, **extra}),
                      extra_metric_sinks=[tsink], device="cpu")
    for rnd in range(2):
        cap.lines.clear()
        for d in _datagrams(p * 10 + rnd):
            js.process_metric_packet(d)
            ts.process_metric_packet(d)
        js.flush(now=NOW + rnd)
        ts.flush(now=NOW + rnd)
        jm, tm = _drain(jsink.queue), _drain(tsink.queue)
        assert any(m.name == "api.users" for m in tm)
        assert _canonical(jm) == _canonical(tm), f"interval {rnd}"
        sent = [line for line in cap.lines
                if line.startswith("veneur.flush.unique_timeseries_total:")]
        assert len(sent) == 1, cap.lines
        tally = int(sent[0].split(":", 1)[1].split("|", 1)[0])
        assert tally > 0
        assert ts.last_unique_timeseries == tally, (rnd, tally)
    js.shutdown()
    ts.shutdown()
