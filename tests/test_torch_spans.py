"""The span→metric path of the PyTorch port against the JAX package, on
the CPU.

* ``core/spans``: ``convert_metrics``, ``convert_indicator_metrics`` and
  ``convert_span_uniqueness_metrics`` give the same UDPMetrics (key,
  digest, value, rate, tags, scope) on numpy-seeded spans, the
  uniqueness draws under the same ``random`` seed.
* ``spans/``: ``derive_batch`` over the columnizer's sealed batches
  gives, in order, what the per-span extraction sink routes, and the
  same as the JAX package's.
* Servers over three pinned intervals (spans with attached samples,
  indicator and objective timers, DogStatsD lines beside them), with
  ``VENEUR_SPAN_COLUMNAR`` on (the columnar pipeline) and off (the
  ``SpanWorker`` lanes, drained by the test, never waited on): every
  InterMetric equal to the JAX server's, with
  ``ssf_span_uniqueness_rate`` 0.0 and 1.0, and at the default 0.01
  with ``random.seed`` before each package's run. That includes the
  ``ssf.names_unique`` set of each flush's own span, derived at the next
  flush. Span conservation from ``ingress_stats()["spans"]``.
* The native SSF path: ``ingest_ssf``/``ingest_ssf_many`` into a worker's
  C++ context (rc, STATUS fall-backs, per-service counts, span and
  invalid counts, and the flushed snapshot bitwise), a native server
  against the JAX one and against the port's Python path, and the
  reader shards' owned contexts handing their SSF fall-backs to the
  swap (the seventh element of the drain).
"""

from __future__ import annotations

import dataclasses
import random
import socket
import struct
import time

import numpy as np
import pytest

from veneur_tpu import ssf as jssf
from veneur_tpu.core import spans as jspans
from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.flusher import device_quantiles
from veneur_tpu.core.metrics import HistogramAggregates
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import ssf_wire as jwire
from veneur_tpu.spans import ColumnarSpanPipeline as JPipeline
from veneur_tpu_torch import ssf as tssf
from veneur_tpu_torch.core import spans as tspans
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import Config as TConfig
from veneur_tpu_torch.core.server import Server as TServer
from veneur_tpu_torch.spans import ColumnarSpanPipeline as TPipeline

PCTS = [0.5, 0.9, 0.99]
AGGS = HistogramAggregates.from_names(["min", "max", "count", "sum"])
QS = device_quantiles(PCTS, AGGS)
IND, OBJ = "sp.indicator", "sp.objective"
NOW = 1_700_000_000


@pytest.fixture(autouse=True)
def _env_neutral(monkeypatch):
    monkeypatch.delenv("VENEUR_SPAN_COLUMNAR", raising=False)


def span_specs(seed: int, n: int, status: bool = True) -> list[dict]:
    """Plain-data spans from a numpy seed: counters, gauges, histograms,
    timers, sets and (with ``status``) status checks attached, unknown
    metric enums, empty sample names, roots, invalid trace spans (end
    0), indicator and error flags, ssf_objective overrides, and empty
    services."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        samples = []
        for _ in range(int(rng.integers(0, 5))):
            kind = int(rng.integers(0, 8 if status else 4))
            metric = kind if kind < 5 else (4 if kind == 5 else 9)
            samples.append(dict(
                metric=metric,
                name="" if kind == 7 else f"sp.m{int(rng.integers(0, 6))}",
                value=float(np.round(rng.gamma(2.0, 10.0), 4)),
                timestamp=NOW + i,
                message=f"u{int(rng.integers(0, 40))}",
                status=int(rng.integers(0, 4)),
                sample_rate=(0.5, 1.0)[int(rng.integers(0, 2))],
                tags=({"k": f"v{int(rng.integers(0, 3))}"}
                      if rng.random() < 0.5 else {}),
                unit="ns" if kind == 3 else ""))
        tid = int(rng.integers(1, 1 << 40))
        tags = {"host": f"h{i % 3}"}
        if i % 5 == 0:
            tags["ssf_objective"] = f"obj{i % 2}"
        start = 1_000_000_000 + i * 1000
        out.append(dict(
            trace_id=tid, id=tid if i % 4 == 0 else tid + 1 + i,
            parent_id=int(rng.integers(0, 9)), start_timestamp=start,
            end_timestamp=0 if i % 13 == 7 else start + int(
                rng.gamma(2.0, 5e6)),
            error=bool(rng.random() < 0.2),
            service="" if i % 9 == 8 else f"svc{int(rng.integers(0, 3))}",
            tags=tags, indicator=bool(rng.random() < 0.6),
            name=f"op{int(rng.integers(0, 4))}", metrics=samples))
    return out


def build_span(mod, spec: dict):
    s = dict(spec)
    s["metrics"] = [mod.SSFSample(**{**m, "tags": dict(m["tags"])})
                    for m in spec["metrics"]]
    s["tags"] = dict(spec["tags"])
    return mod.SSFSpan(**s)


def _udp(m) -> tuple:
    return (m.key.name, m.key.type, m.key.joined_tags, m.digest,
            repr(m.value), m.sample_rate, tuple(m.tags), int(m.scope),
            m.message)


def _canonical(metrics) -> list[tuple]:
    return sorted(
        (m.name, m.timestamp, struct.pack("<d", float(m.value)),
         tuple(m.tags), m.type.name, m.message, m.hostname)
        for m in metrics)


# -- conversion ---------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_convert_functions_equal(rate):
    specs = span_specs(1, 120)
    out = []
    for mod, sp in ((jssf, jspans), (tssf, tspans)):
        random.seed(5)
        got = []
        for spec in specs:
            span = build_span(mod, spec)
            metrics, invalid = sp.convert_metrics(span)
            got.append(("m", invalid, [_udp(m) for m in metrics]))
            got.append(("i", [_udp(m) for m in sp.convert_indicator_metrics(
                span, IND, OBJ)]))
            if rate > 0:
                got.append(("u", [_udp(m) for m in
                                  sp.convert_span_uniqueness_metrics(
                                      span, rate)]))
        out.append(got)
    assert out[0] == out[1]


@pytest.mark.parametrize("rate", [0.0, 0.25, 1.0])
def test_derive_batch_equals_per_span_path(rate):
    """The columnar pipeline routes, in order, what the per-span
    extraction sink routes, in both packages; all four lists equal."""
    specs = span_specs(2, 300)
    got = []
    for mod, sp, pipe_cls in ((jssf, jspans, JPipeline),
                              (tssf, tspans, TPipeline)):
        per_span, columnar = [], []
        sink = sp.MetricExtractionSink(per_span.append, IND, OBJ, rate)
        random.seed(9)
        for spec in specs:
            sink.ingest(build_span(mod, spec))
        pipe = pipe_cls(columnar.extend, indicator_timer_name=IND,
                        objective_timer_name=OBJ, uniqueness_rate=rate,
                        batch_rows=64)
        random.seed(9)
        for spec in specs:
            pipe.ingest(build_span(mod, spec))
        spans, rows = pipe.flush()
        assert spans == len(specs) and rows == len(columnar)
        assert [_udp(m) for m in per_span] == [_udp(m) for m in columnar]
        assert pipe.invalid_samples == sink.invalid_samples
        got.append([_udp(m) for m in columnar])
    assert got[0] == got[1]


# -- servers ------------------------------------------------------------------


def drain_span_worker(srv) -> None:
    """Run the span worker's loop in this thread up to a sentinel, then
    join every sink lane: each span accepted so far has reached every
    sink, with no clock involved."""
    sw = srv.span_worker
    sw.chan.put(None)
    sw.work()
    for lane in list(sw._lanes.values()):
        lane.q.join()


def _server_cfg(rate, **kw):
    return dict(interval="10s", percentiles=PCTS,
                aggregates=["min", "max", "count", "sum"], num_workers=2,
                tpu_native_ingest=False, indicator_span_timer_name=IND,
                objective_span_timer_name=OBJ, span_channel_capacity=100000,
                span_flush_drain_s=0.0, ssf_span_uniqueness_rate=rate,
                tpu_hll_precision=10, **kw)


def _intervals(seed: int, n_spans: int, status: bool = True):
    """Three intervals: each a list of SSF datagrams and DogStatsD lines."""
    rng = np.random.default_rng(seed + 1000)
    out = []
    for k in range(3):
        specs = span_specs(seed * 10 + k, n_spans, status)
        packets = [jwire.encode_datagram(build_span(jssf, s)) for s in specs]
        lines = [f"sv.t{i % 7}:{rng.gamma(2.0, 9.0):.4f}|ms|#x:{i % 3}"
                 .encode() for i in range(40)]
        lines += [f"sp.m{i % 6}:{1 + i % 3}|c".encode() for i in range(9)]
        out.append((packets, lines))
    return out


def _run_server(srv, intervals, lanes: bool) -> list:
    outs = []
    for k, (packets, lines) in enumerate(intervals):
        for pkt in packets:
            srv.handle_trace_packet(pkt)
        for ln in lines:
            srv.handle_metric_packet(ln)
        if lanes:
            drain_span_worker(srv)
        outs.append(_canonical(srv.flush(now=NOW + 10 * k)))
    return outs


@pytest.mark.parametrize("columnar", ["1", "0"], ids=["columnar", "lanes"])
@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_server_intervals_equal(columnar, rate, monkeypatch):
    monkeypatch.setenv("VENEUR_SPAN_COLUMNAR", columnar)
    intervals = _intervals(3, 150)
    js = JServer(JConfig(**_server_cfg(rate)))
    ts = TServer(TConfig(**_server_cfg(rate)), device="cpu")
    try:
        assert (ts.span_pipeline is not None) == (columnar == "1")
        a = _run_server(js, intervals, columnar == "0")
        b = _run_server(ts, intervals, columnar == "0")
        assert a == b
        names = {m[0] for out in b for m in out}
        assert {IND, OBJ} <= {n.rsplit(".", 1)[0] for n in names}
        # each flush's own span derives at the next flush
        uniq = [[m for m in out if m[0] == "ssf.names_unique"] for out in b]
        if rate == 1.0:
            assert all(any("service:veneur-tpu" in m[3] for m in u)
                       for u in uniq[1:])
            assert not any("service:veneur-tpu" in m[3] for m in uniq[0])
        else:
            assert not any(uniq)
        st = ts.ingress_stats()["spans"]
        assert st == js.ingress_stats()["spans"]
        assert st["received"] == st["derived"] + st["dropped"] + \
            st["pending"]
        assert st["received"] == 3 * 150 + 3
    finally:
        js.shutdown()
        ts.shutdown()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_server_default_uniqueness_rate_under_seed(seed):
    """At the default 0.01 the outputs are equal when each package's run
    starts from the same ``random`` state: the port draws from the
    module-global ``random`` in the JAX package's order (span ids, then
    uniqueness samples)."""
    intervals = _intervals(seed, 400)
    assert TConfig().ssf_span_uniqueness_rate == 0.01
    outs = []
    for cfg_cls, srv_cls, kw in ((JConfig, JServer, {}),
                                 (TConfig, TServer, {"device": "cpu"})):
        srv = srv_cls(cfg_cls(**_server_cfg(0.01)), **kw)
        try:
            random.seed(seed)
            outs.append(_run_server(srv, intervals, False))
        finally:
            srv.shutdown()
    assert outs[0] == outs[1]
    assert any(m[0] == "ssf.names_unique" for out in outs[1] for m in out)


def test_flush_span_lands_in_the_next_interval_only():
    """Two flushes of one timer line, uniqueness 1.0: the second flush
    holds the first flush's ``ssf.names_unique`` set, as in the JAX
    server."""
    got = []
    for cfg_cls, srv_cls, kw in ((JConfig, JServer, {}),
                                 (TConfig, TServer, {"device": "cpu"})):
        srv = srv_cls(cfg_cls(interval="10s", tpu_native_ingest=False,
                              ssf_span_uniqueness_rate=1.0), **kw)
        try:
            outs = []
            for k in range(3):
                srv.handle_metric_packet(b"a.t:1|ms")
                outs.append(_canonical(srv.flush(now=NOW + 10 * k)))
            got.append(outs)
        finally:
            srv.shutdown()
    assert got[0] == got[1]
    assert [sorted({m[0] for m in o} & {"ssf.names_unique"})
            for o in got[1]] == [[], ["ssf.names_unique"],
                                 ["ssf.names_unique"]]


# -- the native SSF path ------------------------------------------------------


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype.kind == "f":
        assert np.array_equal(np.isnan(a), np.isnan(b)), what
        ok = ~np.isnan(a)
        a, b = a[ok], b[ok]
    assert a.tobytes() == b.tobytes(), what


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
                  int(r.scope_class)) for r in getattr(s.directory, pool).rows]
                for s in (a, b)]
        assert rows[0] == rows[1], (what, pool)
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        assert pa.used == pb.used, (what, pool)
        _same(pa.values[:pa.used], pb.values[:pb.used], (what, pool))


def _native_workers():
    kw = dict(compression=100, stage_depth=16, batch_size=256,
              initial_histo_rows=8, initial_set_rows=8, is_local=False,
              hll_precision=10, micro_fold=False)
    jwk, twk = jw.DeviceWorker(**kw), tw.DeviceWorker(**kw, device="cpu")
    assert jwk.attach_native()
    twk.attach_native()
    return jwk, twk


@pytest.mark.parametrize("rate", [0.0, 0.01, 1.0])
def test_native_ssf_worker_equal(rate):
    ind, obj = IND.encode(), OBJ.encode()
    jwk, twk = _native_workers()
    for k in range(3):
        specs = span_specs(20 + k, 200)
        packets = [jwire.encode_datagram(build_span(jssf, s)) for s in specs]
        packets.append(b"\xff\xfe\xfd")
        single, burst = packets[:80], packets[80:]
        rcs = [[w.ingest_ssf_packet(p, ind, obj, rate) for p in single]
               for w in (jwk, twk)]
        assert rcs[0] == rcs[1] and -1 in rcs[1] and 1 in rcs[1]
        many = [w._native.ingest_ssf_many(burst, ind, obj, rate)
                for w in (jwk, twk)]
        assert many[0] == many[1] and many[1][1] == 1 and many[1][2]
        assert jwk._native.ssf_spans == twk._native.ssf_spans
        assert jwk._native.ssf_invalid == twk._native.ssf_invalid
        svc = [w._native.drain_ssf_services() for w in (jwk, twk)]
        assert svc[0] == svc[1] and sum(svc[1].values()) == (
            rcs[1].count(1) + many[1][0])
        _snapshots_equal(jwk.flush(QS), twk.flush(QS), (rate, k))


def _native_server_run(pkg: str, native: bool, rate: float, intervals):
    cfg_cls, srv_cls, kw = ((JConfig, JServer, {}) if pkg == "jax"
                            else (TConfig, TServer, {"device": "cpu"}))
    srv = srv_cls(cfg_cls(**{**_server_cfg(rate), "num_workers": 1,
                             "tpu_native_ingest": native,
                             "micro_fold": False}), **kw)
    try:
        assert srv._native_ssf is native
        got = []
        for k, (packets, lines) in enumerate(intervals):
            if native:
                srv.handle_trace_packets_native(packets[:60])
            else:
                for pkt in packets[:60]:
                    srv.handle_trace_packet(pkt)
            for pkt in packets[60:]:
                srv.handle_trace_packet(pkt)
            for ln in lines:
                srv.handle_metric_packet(ln)
            got.append(_canonical(srv.flush(now=NOW + 10 * k)))
        st = srv.ingress_stats()["spans"]
        assert st["received"] == st["derived"] + st["dropped"] + \
            st["pending"] == 3 * len(intervals[0][0]) + 3
        return got, ({k: v for k, v in srv.stats.totals().items()
                      if k[0] == "ssf.spans.received_total"}
                     if pkg == "port" else None)
    finally:
        srv.shutdown()


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_native_ssf_server_equals_jax_and_python_path(rate):
    """A native port server (one worker, no span sink) derives what the
    JAX native server derives, STATUS spans through the Python fall-back
    included. On spans without STATUS samples it derives what the port's
    Python path does, bit for bit (a STATUS span takes the Python path at
    once while native scalars apply at the drain, so with them the last
    gauge write and the order of float sums differ, in both packages)."""
    mixed = _intervals(7, 120)
    assert _native_server_run("jax", True, rate, mixed)[0] == \
        _native_server_run("port", True, rate, mixed)[0]
    plain = _intervals(8, 120, status=False)
    (a, ca), (b, cb) = (_native_server_run("port", n, rate, plain)
                        for n in (True, False))
    assert a == b
    # the native spans' service counts come from the C++ context at the
    # swap; both paths count every span, the flush spans included
    assert ca == cb and sum(cb.values()) == 3 * 120 + 2


def test_reader_shard_contexts_hand_back_ssf_fallbacks():
    """A C++ SSF reader committing into a reader shard's owned context:
    STATUS spans buffer there and come out of the swap's drain in
    ``pending_ssf_fallback``, in both packages."""
    specs = span_specs(30, 60)
    status_specs = [s for s in specs if any(m["metric"] == 4
                                            for m in s["metrics"])]
    plain = [s for s in specs if s not in status_specs]
    assert status_specs and plain
    payloads = ([jwire.encode_datagram(build_span(jssf, s))
                 for s in status_specs]
                + [jwire.encode_datagram(build_span(jssf, s))
                   for s in plain])
    got = []
    for pkg in ("jax", "port"):
        kw = dict(compression=100, stage_depth=16, batch_size=256,
                  hll_precision=10, micro_fold=False)
        w = (jw.DeviceWorker(**kw) if pkg == "jax"
             else tw.DeviceWorker(**kw, device="cpu"))
        w.attach_native()
        assert w.attach_reader_shards(2)
        ctx = w._reader_ctxs[1]
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.bind(("127.0.0.1", 0))
        if pkg == "jax":
            from veneur_tpu.native import NativeRouter

            router = NativeRouter([w._native])
            h = router.start_ssf_reader(ctx, rx.fileno(), 65536, b"", b"",
                                        0.0)
            stop = router.stop_ssf_reader
        else:
            h = ctx.start_ssf_reader(rx.fileno(), 65536, b"", b"", 0.0)
            stop = ctx.stop_ssf_reader
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for p in payloads:
            tx.sendto(p, rx.getsockname())
        deadline = time.time() + 30
        while ctx.ssf_spans < len(plain) and time.time() < deadline:
            time.sleep(0.01)
        assert stop(h) == len(payloads)
        tx.close()
        rx.close()
        w.flush(QS)
        got.append(list(w.pending_ssf_fallback))
    assert got[0] == got[1] == payloads[:len(status_specs)]
