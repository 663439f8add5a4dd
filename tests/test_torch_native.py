"""The port's native C++ ingest path against the JAX package's, on the CPU.

* The library: ``veneur_tpu_torch.native`` builds native/'s sources with
  g++ into build/native/ (never into native/, whose committed library
  stays byte for byte as it was), and the stamp compiled into it is the
  sources' hash, the one the JAX package's committed library carries.
* Worker intervals: the same seeded DogStatsD datagrams through a JAX
  ``DeviceWorker`` with ``attach_native()`` (micro-fold off) and through
  the port's: every snapshot array bitwise equal (quantiles, the ten
  aggregates, digests, set estimates and registers, unique-timeseries
  registers), counters, gauges and directories equal, for both set
  stores and both set hashes, three intervals each. With a small
  ``stage_depth`` and ``batch_size`` hot rows spill past the staging
  plane and drain mid-interval; with a large ``batch_size`` the spill is
  deferred to the flush; with a small ``spill_cap`` the C++ context sheds
  samples, and both count the same number shed.
* The port's native path equals its own Python path on the same
  datagrams.
* Servers: a port server with ``tpu_native_ingest`` and
  ``tpu_native_readers`` on (C++ reader threads on the UDP socket) gives
  the InterMetrics of a Python-path port server and of a native JAX
  server.
"""

from __future__ import annotations

import dataclasses
import hashlib
import socket
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu.core import flusher as jflusher
from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.core import flusher as tflusher
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server
from veneur_tpu_torch.protocol import dogstatsd as tdog
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TChannel

ROOT = Path(__file__).resolve().parent.parent
NOW = 1_700_000_000
AGGS = jflusher.HistogramAggregates.from_names(
    ["min", "max", "count", "sum", "avg", "median", "hmean"])
PCTS = [0.5, 0.9, 0.99]


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


def _datagrams(seed: int, n: int = 120, hot: int = 4) -> list[bytes]:
    """One interval's datagrams, several lines each: timers and
    histograms (some sampled), ``hot`` series with many samples each,
    counters (some sampled), gauges, sets (mixed-scope, local-only,
    global-only), an event, a service check and a few bad lines."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = i % 23
        lines = [
            f"lat.{k}:{rng.gamma(2.0, 15.0):.4f}|ms|#ep:e{k % 5}",
            f"size.{k % 7}:{rng.lognormal(5.0, 1.0):.3f}|h|@0.5",
            f"hot.{i % hot}:{rng.exponential(40.0):.4f}|ms",
            f"hot.{(i + 1) % hot}:{rng.normal(100.0, 9.0):.4f}|h|@0.25",
            f"req.{k % 6}:{1 + k % 4}|c|#code:{k % 3}",
            f"sampled.{k % 3}:2|c|@0.1",
            f"temp.{k % 8}:{rng.normal(20.0, 4.0):.5f}|g",
            f"users:u{int(rng.integers(0, 400))}|s",
            f"ips.{k % 4}:10.0.0.{int(rng.integers(0, 60))}|s|#veneurlocalonly",
            f"gsets:{int(rng.integers(0, 90))}|s|#veneurglobalonly",
            f"only.local:{rng.normal(5.0, 1.0):.4f}|ms|#veneurlocalonly",
        ]
        if i % 29 == 0:
            lines.append("bad line without a type")
            lines.append(f"_sc|svc.health|{k % 3}|#pod:p{k % 2}|m:ok")
        if i % 31 == 0:
            lines.append(f"_e{{5,9}}:title|body text|#k:{k}")
        out.append("\n".join(lines).encode())
    return out


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
    for pool in ("histo", "sets"):
        rows = [[(r.key.name, r.key.type, r.key.joined_tags, list(r.tags),
                  int(r.scope_class), r.sinks)
                 for r in getattr(s.directory, pool).rows] for s in (a, b)]
        assert rows[0] == rows[1], (what, pool)
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        assert pa.used == pb.used, (what, pool)
        _same(pa.values[:pa.used], pb.values[:pb.used], (what, pool))
        _same(pa.present[:pa.used], pb.present[:pb.used], (what, pool))
        assert [(m[0].name, m[0].type, m[0].joined_tags, list(m[1]),
                 int(m[2]), m[3]) for m in pa.meta] == \
            [(m[0].name, m[0].type, m[0].joined_tags, list(m[1]), int(m[2]),
              m[3]) for m in pb.meta], (what, pool)


def _metrics(flusher, snap, is_local):
    return _canonical(flusher.generate_inter_metrics(
        snap, is_local, PCTS, AGGS, now=NOW))


# -- the library ----------------------------------------------------------------


def test_library_builds_from_native_sources_into_build_dir():
    # the JAX package's loader first (it runs make in native/, a no-op
    # while its library is current); from here on only the port builds
    jlib = jnative.load_library()
    committed = ROOT / "native" / "libveneur_native.so"
    before = hashlib.sha256(committed.read_bytes()).hexdigest()
    path = tnative.build()
    assert path == tnative.library_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert tnative.source_hash() == tnative.source_stamp()
    srcs = b"".join((ROOT / "native" / s).read_bytes()
                    for s in ("dogstatsd.cpp", "emit.cpp", "forward_codec.cpp"))
    assert tnative.source_stamp() == hashlib.sha256(srcs).hexdigest()[:16]
    assert jlib.vn_source_hash().decode() == tnative.source_hash()
    assert tnative.available()
    assert hashlib.sha256(committed.read_bytes()).hexdigest() == before


def test_library_build_failure_raises_with_the_compiler_message(
        monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "CXXFLAGS",
                        tnative.CXXFLAGS + ("-fno-such-flag-anywhere",))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        tnative.build()


# -- worker intervals -----------------------------------------------------------


def _workers(**kw):
    jworker = jw.DeviceWorker(**kw)
    assert jworker.attach_native()
    tworker = tw.DeviceWorker(**kw, device="cpu")
    assert tworker.attach_native()
    return jworker, tworker


@pytest.mark.parametrize("store,set_hash,p,is_local", [
    ("staged", "fnv", 14, True), ("dense", "metro", 10, False),
    ("staged", "metro", 8, False), ("dense", "fnv", 4, True)])
def test_native_worker_matches_jax_native_worker(store, set_hash, p,
                                                 is_local):
    """Three intervals; stage_depth 8 and batch_size 64, so the hot rows
    spill past the C++ staging plane and drain mid-interval through the
    direct fold, and the last spill is deferred to the flush."""
    kw = dict(hll_precision=p, set_store=store, set_hash=set_hash,
              count_unique_timeseries=True, is_local=is_local,
              batch_size=64, initial_set_rows=8, initial_histo_rows=8,
              stage_depth=8)
    jworker, tworker = _workers(**kw)
    qs = jflusher.device_quantiles(PCTS, AGGS)
    for seed in (1, 2, 3):
        for d in _datagrams(seed * 7 + p):
            jworker.ingest_datagram(d)
            tworker.ingest_datagram(d)
        js, ts = jworker.flush(qs), tworker.flush(qs)
        _snapshots_equal(js, ts, f"interval {seed}")
        assert ts.set_estimates is not None and ts.quantile_values.size
        assert _metrics(jflusher, js, is_local) == \
            _metrics(tflusher, ts, is_local), f"interval {seed}"
        assert tworker.pending_other_lines == jworker.pending_other_lines
        assert tworker.parse_errors == jworker.parse_errors > 0
        assert tworker.overload_dropped == jworker.overload_dropped == 0
    assert tworker.processed_total == jworker.processed_total > 0


def test_deferred_spill_and_spill_cap_shedding():
    """A batch_size no drain reaches: every spilled sample waits in the
    C++ batch until the flush, which folds it in chunks (shrunk here so
    several run); a spill_cap below the spill sheds the excess in C++.
    The shed count and every output equal the reference's."""
    kw = dict(batch_size=1 << 20, stage_depth=4, spill_cap=300,
              initial_histo_rows=8, count_unique_timeseries=True)
    jworker, tworker = _workers(**kw)
    grams = _datagrams(5, n=200, hot=2)
    qs = jflusher.device_quantiles(PCTS, AGGS)
    chunk = (jw._FOLD_CHUNK, tw._FOLD_CHUNK)
    jw._FOLD_CHUNK = tw._FOLD_CHUNK = 64
    try:
        for d in grams:
            jworker.ingest_datagram(d)
            tworker.ingest_datagram(d)
        jsw, tsw = jworker.swap(qs), tworker.swap(qs)
        assert len(tsw.spill_histo[0]) == len(jsw.spill_histo[0]) == 300
        js = jworker.extract_snapshot(jsw, qs)
        ts = tworker.extract_snapshot(tsw, qs)
    finally:
        jw._FOLD_CHUNK, tw._FOLD_CHUNK = chunk
    _snapshots_equal(js, ts, "deferred spill")
    shed = tworker.overload_dropped
    assert shed == jworker.overload_dropped > 0
    assert shed == tworker.overload_dropped_total


def test_fold_budget_sheds_the_oldest_spill_as_the_reference_does():
    kw = dict(batch_size=1 << 20, stage_depth=2, initial_histo_rows=8)
    jworker, tworker = _workers(**kw)
    chunk = (jw._FOLD_CHUNK, tw._FOLD_CHUNK)
    jw._FOLD_CHUNK = tw._FOLD_CHUNK = 50
    try:
        for w in (jworker, tworker):
            # the budget is max(_FOLD_CHUNK, rate * budget_s) samples
            w.fold_budget_s, w._fold_rate_ewma = 1.0, 120.0
        for d in _datagrams(8, n=150, hot=3):
            jworker.ingest_datagram(d)
            tworker.ingest_datagram(d)
        qs = jflusher.device_quantiles(PCTS, AGGS)
        js, ts = jworker.flush(qs), tworker.flush(qs)
    finally:
        jw._FOLD_CHUNK, tw._FOLD_CHUNK = chunk
    _snapshots_equal(js, ts, "fold budget")
    assert tworker.overload_dropped == jworker.overload_dropped > 0


def test_python_side_upserts_share_the_native_directory():
    """Lines parsed on the Python path (process_metric) beside native
    datagrams land in the native directory's rows, as in the reference."""
    kw = dict(batch_size=32, stage_depth=8, initial_histo_rows=8,
              count_unique_timeseries=True)
    jworker, tworker = _workers(**kw)
    from veneur_tpu.protocol import dogstatsd as jdog

    grams = _datagrams(11, n=60)
    for i, d in enumerate(grams):
        jworker.ingest_datagram(d)
        tworker.ingest_datagram(d)
        line = f"py.side.{i % 5}:{i}|ms".encode()
        jworker.process_metric(jdog.parse_metric(line))
        tworker.process_metric(tdog.parse_metric(line))
        line = f"req.{i % 6}:3|c|#code:{i % 3}".encode()
        jworker.process_metric(jdog.parse_metric(line))
        tworker.process_metric(tdog.parse_metric(line))
    qs = jflusher.device_quantiles(PCTS, AGGS)
    _snapshots_equal(jworker.flush(qs), tworker.flush(qs), "mixed paths")


@pytest.mark.parametrize("store", ["staged", "dense"])
def test_native_path_equals_python_path(store):
    """With every row inside the staging plane (no spill), the native
    path and the Python path of the port give the same snapshot. (Past
    the depth they cut the spill into other batches, as the reference's
    two paths do.)"""
    kw = dict(batch_size=4096, stage_depth=256, initial_histo_rows=8,
              set_store=store, count_unique_timeseries=True, hll_precision=12)
    native = tw.DeviceWorker(**kw, device="cpu")
    native.attach_native()
    python = tw.DeviceWorker(**kw, device="cpu")
    qs = jflusher.device_quantiles(PCTS, AGGS)
    for seed in (4, 5):
        grams = _datagrams(seed, n=80)
        for d in grams:
            native.ingest_datagram(d)
            for line in d.split(b"\n"):
                if line.startswith((b"_e{", b"_sc")):
                    continue
                try:
                    m = tdog.parse_metric(line)
                except tdog.ParseError:
                    continue
                python.process_metric(m)
        _snapshots_equal(native.flush(qs), python.flush(qs),
                         f"interval {seed}")
        assert native.processed_total == python.processed_total


# -- servers --------------------------------------------------------------------

BASE = {
    "percentiles": PCTS,
    "aggregates": ["min", "max", "count"],
    "interval": "10s",
    "hostname": "parity-host",
    "flush_emit_native": False,
    "micro_fold": False,
    "device_guard": False,
    "tpu_stage_depth": 8,
    "tpu_batch_size": 64,
    "tpu_initial_histo_rows": 16,
    "tpu_initial_set_rows": 8,
    "count_unique_timeseries": True,
}


def _drain(q):
    out = []
    while not q.empty():
        out.extend(q.get_nowait())
    return out


@pytest.mark.parametrize("workers", [1, 3])
def test_native_server_packets_equal_jax_native_server(workers):
    """Datagrams through process_metric_packet of a JAX server and of a
    port server, both with tpu_native_ingest on: equal InterMetrics over
    two intervals, events and service checks included."""
    extra = {"num_workers": workers, "tpu_native_ingest": True,
             "tpu_native_readers": False}
    jsink, tsink = JChannel(), TChannel()
    js = JServer(jload(data={**BASE, **extra}), metric_sinks=[jsink])
    ts = build_server(tload(data={**BASE, **extra}),
                      extra_metric_sinks=[tsink], device="cpu")
    assert js.native_mode and ts.native_mode
    try:
        for rnd in range(2):
            for d in _datagrams(40 + rnd):
                js.process_metric_packet(d)
                ts.process_metric_packet(d)
            jm = js.flush(now=NOW + rnd)
            tm = ts.flush(now=NOW + rnd)
            assert _canonical(jm) == _canonical(tm), f"interval {rnd}"
            assert _canonical(_drain(jsink.queue)) == \
                _canonical(_drain(tsink.queue))
            assert ts.parse_errors == js.parse_errors > 0
            assert ts.last_unique_timeseries > 0
    finally:
        js.shutdown()
        ts.shutdown()


def test_native_readers_server_equals_python_server():
    """A port server reading its UDP socket with a C++ reader thread gives
    the InterMetrics of a Python-path port server fed the same datagrams;
    no Python reader thread runs beside it. One reader keeps the
    datagrams' order, which the gauges' last write depends on; a staging
    plane deeper than any row's samples keeps the two paths' spill folds
    out of the comparison (the Python path cuts its batches where the
    pool grows, the native one where its C++ batch fills: as in the
    reference, a row past the depth is digested in other batches)."""
    data = {**BASE, "statsd_listen_addresses": ["udp://127.0.0.1:0"],
            "num_readers": 1, "num_workers": 2, "tpu_native_ingest": True,
            "tpu_native_readers": True, "interval": "1h",
            "tpu_stage_depth": 256}
    sink = TChannel()
    server = build_server(tload(data=data), extra_metric_sinks=[sink],
                          device="cpu")
    grams = _datagrams(50, n=150)
    ports = server.start()
    try:
        assert server.native_mode and server.native_reader_threads == 1
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("statsd-udp")]
        port = ports["udp://127.0.0.1:0"]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for d in grams:
                s.sendto(d, ("127.0.0.1", port))
                time.sleep(0.0005)
        deadline = time.time() + 30
        while server.packets_received < len(grams) and time.time() < deadline:
            time.sleep(0.02)
        assert server.packets_received == len(grams)
        got = server.flush(now=NOW)
    finally:
        assert server.shutdown()
    assert server.native_reader_threads == 0
    assert server.packets_received == len(grams)
    ref = build_server(tload(data={
        **data, "statsd_listen_addresses": [], "tpu_native_ingest": False,
        "tpu_native_readers": False}), device="cpu")
    for d in grams:
        ref.process_metric_packet(d)
    want = ref.flush(now=NOW)
    ref.shutdown()
    assert _canonical(got) == _canonical(want)
    assert _canonical(_drain(sink.queue)) == _canonical(got)
    assert server.parse_errors == ref.parse_errors > 0
    assert server.last_unique_timeseries == ref.last_unique_timeseries > 0
