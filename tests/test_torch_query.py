"""The port's live query path (veneur_tpu_torch/query/, ops/query.py and
the worker's and server's query view) against the JAX package's on the
CPU, byte for byte: every op's JSON response from the same epochs
(quantiles at the flush quantiles and ad hoc, forced through the device
evaluator or served from the host arrays, filters and limits, scalars,
cardinality, top-k, tenant totals, count-min estimates, epoch), the
/metrics exposition against the exposition sink's body, both fronts
(HTTP and gRPC), the fenced sketch reads, a commit atomic across two
workers and snapshot isolation under concurrent ingest, the guard's
``query`` op under an injected fault, a server built from
``query_listen_addrs`` with budgets against the JAX server (answers,
counters, gauges), and ``pad_quantiles``, ``pad_rows``,
``quantile_rows`` and ``scalar_rows``. Inputs are made with numpy from a
seed and handed to both packages."""

from __future__ import annotations

import functools
import json
import struct
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.flusher import device_quantiles as jdevice_quantiles
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.tenancy import TenantLedger as JLedger
from veneur_tpu.core.tenancy import TenantSketch as JSketch
from veneur_tpu.ops import query as jqops
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu.query.engine import QueryEngine as JEngine
from veneur_tpu.utils import faults as jfaults
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server
from veneur_tpu_torch.core.flusher import device_quantiles, generate_columnar
from veneur_tpu_torch.core.metrics import DEFAULT_TENANT, HistogramAggregates
from veneur_tpu_torch.core.tenancy import TenantLedger as TLedger
from veneur_tpu_torch.core.tenancy import TenantSketch as TSketch
from veneur_tpu_torch.ops import heavyhitter as thh
from veneur_tpu_torch.ops import query as tqops
from veneur_tpu_torch.protocol import dogstatsd as tdog
from veneur_tpu_torch.query import QueryEngine as TEngine
from veneur_tpu_torch.sinks.prometheus import PrometheusExpositionSink
from veneur_tpu_torch.utils import faults as tfaults

AGGS = HistogramAggregates.from_names(["min", "max", "count", "sum"])
PCTS = [0.5, 0.9, 0.99]
QS = device_quantiles(PCTS, AGGS)
NOW = 1_700_000_000


def _bytes(resp: dict) -> bytes:
    return json.dumps(resp).encode()


def _lines(seed: int, n: int = 240) -> list[str]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = f"t{i % 3}"
        k = i % 17
        out += [f"q.t.{k}:{rng.gamma(2.0, 9.0):.4f}|ms|#tenant:{t},k:{k % 4}",
                f"q.h:{rng.normal(50.0, 9.0):.4f}|h|#env:{'prod' if i % 2 else 'dev'}",
                f"q.s.{k % 5}:u{int(rng.integers(0, 200))}|s|#tenant:{t}",
                f"q.c:{1 + k % 3}|c|#tenant:{t}",
                f"hot.{i % 2}:{rng.exponential(30.0):.4f}|ms|#tenant:{t}"]
    return out


class _Pair:
    """A JAX worker and a port worker (CPU), each publishing into its own
    package's engine, fed the same lines."""

    def __init__(self, workers=1, budgets=None, sketch=True, native=False,
                 **kw):
        kw.setdefault("initial_histo_rows", 8)
        kw.setdefault("stage_depth", 16)
        self.je = JEngine(PCTS, AGGS, is_local=True, topk=4)
        self.te = TEngine(PCTS, AGGS, is_local=True, topk=4)
        self.jw = [jw.DeviceWorker(**kw) for _ in range(workers)]
        self.tw = [tw.DeviceWorker(**kw, device="cpu")
                   for _ in range(workers)]
        jl = JLedger(budgets=budgets) if budgets else None
        tl = TLedger(budgets=budgets) if budgets else None
        for i, (a, b) in enumerate(zip(self.jw, self.tw)):
            if native:
                assert a.attach_native() and b.attach_native()
            a.query_publisher = functools.partial(self.je.stage, i)
            b.query_publisher = functools.partial(self.te.stage, i)
            a.tenancy, b.tenancy = jl, tl
            if sketch:
                a.tenant_sketch = JSketch(depth=4, width=256, topk=4)
                b.tenant_sketch = TSketch(depth=4, width=256, topk=4,
                                          device="cpu")
        self.native = native

    def feed(self, lines):
        n = len(self.jw)
        if self.native:
            for i in range(0, len(lines), 20):
                d = "\n".join(lines[i:i + 20]).encode()
                self.jw[(i // 20) % n].ingest_datagram(d)
                self.tw[(i // 20) % n].ingest_datagram(d)
            return
        for i, line in enumerate(lines):
            self.jw[i % n].process_metric(jdog.parse_metric(line.encode()))
            self.tw[i % n].process_metric(tdog.parse_metric(line.encode()))

    def flush(self, ts=NOW):
        js = [w.flush(QS, interval_s=10.0) for w in self.jw]
        tsn = [w.flush(QS, interval_s=10.0) for w in self.tw]
        self.je.commit(ts)
        self.te.commit(ts)
        return js, tsn

    def same(self, req: dict) -> dict:
        a, b = self.je.dispatch(dict(req)), self.te.dispatch(dict(req))
        assert _bytes(b) == _bytes(a), req
        return b


# -- parity: query == flush, bitwise ---------------------------------------


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("workers", [1, 2])
def test_flush_quantiles_parity_and_responses_equal_jax(native, workers):
    p = _Pair(workers=workers, native=native)
    p.feed(_lines(1))
    _js, tsnaps = p.flush()
    r = p.same({"op": "quantiles", "force_device": True, "limit": 10 ** 6})
    host = p.same({"op": "quantiles", "limit": 10 ** 6})
    assert [x["values"] for x in host["results"]] == \
        [x["values"] for x in r["results"]]
    got = [x["values"] for x in r["results"]]
    want = [list(map(float, row)) for s in tsnaps
            for row in s.quantile_values]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert struct.pack(f"<{len(g)}f", *g) == \
            struct.pack(f"<{len(w)}f", *w)


@pytest.mark.parametrize("qs", [[0.25], [0.25, 0.75], [0.1] * 5,
                                list(np.linspace(0.01, 0.99, 17)),
                                list(np.linspace(0.0, 1.0, 32))])
def test_adhoc_quantiles_equal_jax(qs):
    """Ad-hoc vectors pad to 4, 8 or 32 quantiles (the last two through
    the extract's quantile blocks past 16) and slice back."""
    p = _Pair()
    p.feed(_lines(2))
    p.flush()
    r = p.same({"op": "quantiles", "qs": [float(q) for q in qs]})
    assert r["results"] and len(r["results"][0]["values"]) == len(qs)
    p.same({"op": "quantiles", "qs": [float(q) for q in qs],
            "force_device": True, "name": "q.h"})


def test_filters_limit_scalars_cardinality_equal_jax():
    p = _Pair()
    p.feed(_lines(3))
    js, ts = p.flush()
    r = p.same({"op": "scalars", "name": "q.h", "tags": ["env:prod"]})
    assert len(r["results"]) == 1
    assert p.same({"op": "scalars", "limit": 3})["truncated"] is True
    assert p.same({"op": "quantiles", "limit": 2})["truncated"] is True
    p.same({"op": "quantiles", "tags": ["k:1"], "qs": [0.5, 0.95]})
    p.same({"op": "scalars"})
    c = p.same({"op": "cardinality", "limit": 10 ** 6})
    assert [x["estimate"] for x in c["results"]] == \
        [float(v) for v in ts[0].set_estimates]
    p.same({"op": "cardinality", "name": "q.s.3", "tags": ["tenant:t1"]})
    p.same({"op": "epoch"})
    p.same({"op": "nope"})
    assert p.te.queries_failed == p.je.queries_failed == 1


def test_topk_totals_cms_equal_jax():
    p = _Pair(workers=2, budgets={"t2": 4})
    for seed in (4, 5):
        p.feed(_lines(seed))
        p.flush(ts=NOW + seed)
        for t in ("t0", "t1", "t2", DEFAULT_TENANT, "nobody"):
            p.same({"op": "topk", "tenant": t})
            p.same({"op": "topk", "tenant": t, "k": 2})
        p.same({"op": "tenant_totals"})
        keys = [m.key.key_string() for m in
                p.te.epoch().views[0].snap.directory.histo.rows]
        for t in ("t0", "t2"):
            r = p.same({"op": "cms", "keys": keys + ["absent"], "tenant": t})
            assert len(r["results"]) == len(keys) + 1


def test_exposition_bytes_equal_sink_and_jax():
    p = _Pair(workers=2)
    p.feed(_lines(6))
    js, ts = p.flush(ts=1234)
    body, count, ctype = p.te.render_exposition()
    jbody, jcount, jctype = p.je.render_exposition()
    assert (body, count, ctype) == (jbody, jcount, jctype)
    assert p.te.render_exposition()[0] is body  # cached per epoch
    posted = []
    sink = PrometheusExpositionSink("http://example.invalid/push")
    sink._post = lambda b, c: posted.append((b, c))
    for snap in ts:
        sink.flush_columnar(generate_columnar(snap, True, PCTS, AGGS,
                                              now=1234))
    assert b"".join(b for b, _ in posted) == body
    assert sum(c for _, c in posted) == count
    del js


# -- fenced reads and epochs -----------------------------------------------


def test_sketch_view_is_fenced_from_later_folds():
    sk = TSketch(depth=4, width=256, topk=4, device="cpu")
    jsk = JSketch(depth=4, width=256, topk=4)
    keys = [f"series-{i}" for i in range(50)]
    tenants = ["default"] * 25 + ["acme"] * 25
    counts = np.arange(1, 51, dtype=np.int64)
    sk.fold(tenants, keys, counts, chunk=64)
    jsk.fold(tenants, keys, counts, chunk=64)
    view, jview = sk.snapshot(), jsk.snapshot()
    pool_ref, before = sk.pool, sk.pool.clone()
    assert np.array_equal(view.estimate("acme", keys[25:]),
                          jview.estimate("acme", keys[25:]))
    assert view.totals() == jview.totals()
    assert view.top_keys("acme") == jview.top_keys("acme")
    thh.read_query(sk.pool, 0, keys[:25])
    thh.read_totals(sk.pool)
    assert sk.pool is pool_ref and torch.equal(sk.pool, before)
    # a later fold replaces the pool; the view still answers the fence
    sk.fold(["default"], ["series-0"], np.asarray([100]), chunk=16)
    assert torch.equal(view.pool, before)
    assert view.totals()[DEFAULT_TENANT] == int(counts[:25].sum())
    assert sk.totals()[DEFAULT_TENANT] == int(counts[:25].sum()) + 100


def test_commit_is_atomic_across_two_workers():
    p = _Pair(workers=2, sketch=False)
    p.feed(["x:1|h", "x:1|h"])
    p.flush(ts=100)
    first = p.same({"op": "scalars", "name": "x"})
    assert first["epoch"] == 1
    assert [r["count"] for r in first["results"]] == [1.0, 1.0]
    p.feed(["x:2|h"] * 10)
    for w in p.tw:
        w.flush(QS, interval_s=10.0)  # staged, not committed
    again = p.te.dispatch({"op": "scalars", "name": "x"})
    assert again == first
    p.te.commit(200)
    now = p.te.dispatch({"op": "scalars", "name": "x"})
    assert now["epoch"] == 2
    assert [r["count"] for r in now["results"]] == [5.0, 5.0]


def test_snapshot_isolation_under_concurrent_ingest():
    """Pairs (iso.a, iso.b) ingest together with equal counts on two
    workers; a response mixing two epochs would see them differ."""
    eng = TEngine(PCTS, AGGS, is_local=True)
    workers = [tw.DeviceWorker(device="cpu") for _ in range(2)]
    for i, w in enumerate(workers):
        w.query_publisher = functools.partial(eng.stage, i)
    lock, stop = threading.Lock(), threading.Event()

    def ingest():
        v = 0
        while not stop.is_set():
            with lock:
                for w in workers:
                    w.process_metric(tdog.parse_metric(f"iso.a:{v}|h".encode()))
                    w.process_metric(tdog.parse_metric(f"iso.b:{v}|h".encode()))
            v += 1

    def flusher():
        while not stop.is_set():
            with lock:
                swapped = [w.swap(QS) for w in workers]
            for w, sw in zip(workers, swapped):
                w.extract_snapshot(sw, QS, 10.0)
            eng.commit()

    threads = [threading.Thread(target=ingest),
               threading.Thread(target=flusher)]
    for t in threads:
        t.start()
    try:
        deadline, checked, last = time.time() + 8.0, 0, 0
        while time.time() < deadline and checked < 25:
            r = eng.query_quantiles(name="iso.a", force_device=True)
            r2 = eng.query_scalars(name="iso.b")
            if not r["results"] or r["epoch"] != r2["epoch"]:
                continue
            assert r["epoch"] >= last
            last = r["epoch"]
            assert sorted(x["count"] for x in r["results"]) == \
                sorted(x["count"] for x in r2["results"])
            checked += 1
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert checked >= 5


# -- the fronts ------------------------------------------------------------


def test_http_and_grpc_fronts_answer_as_dispatch_and_jax():
    from veneur_tpu_torch.query.http import make_http_server
    from veneur_tpu_torch.query.service import QueryClient, make_query_server

    p = _Pair()
    p.feed(_lines(7))
    p.flush()
    hsrv, hport = make_http_server(p.te, "127.0.0.1:0")
    gsrv, gport = make_query_server(p.te, "127.0.0.1:0")
    client = QueryClient(f"127.0.0.1:{gport}")
    base = f"http://127.0.0.1:{hport}"
    try:
        with urllib.request.urlopen(base + "/healthz") as resp:
            assert json.load(resp) == {"ok": True, "epoch": 1}
        for req in ({"op": "scalars", "name": "q.h"},
                    {"op": "quantiles", "qs": [0.3, 0.7], "name": "q.h"},
                    {"op": "cardinality"}, {"op": "topk", "tenant": "t1"},
                    {"op": "tenant_totals"}, {"op": "epoch"},
                    {"op": "nope"}):
            want = p.je.dispatch(dict(req))
            post = urllib.request.Request(
                base + "/query", data=json.dumps(req).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(post) as resp:
                assert json.load(resp) == want, req
            assert client.query(req) == want, req
        with urllib.request.urlopen(base + "/query?op=scalars&name=q.h") as r:
            assert json.load(r) == p.je.dispatch({"op": "scalars",
                                                  "name": "q.h"})
        with urllib.request.urlopen(base + "/metrics") as resp:
            assert resp.read() == p.je.render_exposition()[0]
    finally:
        client.close()
        gsrv.stop(grace=0)
        hsrv.shutdown()
        hsrv.server_close()


# -- the guard's query op --------------------------------------------------


def test_query_fault_gives_the_plain_result():
    """A fault on op ``query`` fails the evaluation over to the plain
    version over host copies: the same bytes, the fault counted."""
    p = _Pair()
    p.feed(_lines(8))
    p.flush()
    req = {"op": "quantiles", "qs": [0.2, 0.4, 0.6, 0.8, 0.95],
           "force_device": True}
    healthy = p.te.dispatch(dict(req))
    p.te._eval_cache.clear()
    w = p.tw[0]
    with tfaults.DeviceFaultInjector(tfaults.DeviceFaultPlan(
            op_windows={"query": [(0, 10 ** 6, "lost")]})) as inj:
        got = p.te.dispatch(dict(req))
    assert inj.op_injected.get("query", 0) >= 1
    assert _bytes(got) == _bytes(healthy) == _bytes(p.je.dispatch(req))
    assert "degraded" not in got
    assert w.guard.counters().get("device.fault.lost", 0) >= 1


def test_failed_over_epoch_answers_degraded_as_jax():
    """An extract fault during the flush completes it on the failover
    engine: every response of that epoch carries ``degraded``, with the
    JAX package's bytes."""
    p = _Pair(budgets={"t1": 3})
    p.feed(_lines(9))
    plan = {"extract": [(0, 10 ** 6, "lost")]}
    jinj = jfaults.DeviceFaultInjector(jfaults.DeviceFaultPlan(
        op_windows=plan))
    jinj.install()
    try:
        js = p.jw[0].flush(QS, interval_s=10.0)
    finally:
        jinj.uninstall()
    with tfaults.DeviceFaultInjector(tfaults.DeviceFaultPlan(
            op_windows=plan)):
        ts = p.tw[0].flush(QS, interval_s=10.0)
    assert js.degraded and ts.degraded
    p.je.commit(NOW)
    p.te.commit(NOW)
    for req in ({"op": "quantiles", "force_device": True},
                {"op": "quantiles", "qs": [0.33]}, {"op": "scalars"},
                {"op": "tenant_totals"}, {"op": "topk", "tenant": "t0"}):
        r = p.same(req)
        assert r["degraded"] is True


# -- a server from config --------------------------------------------------


class _Rec:
    """Records the JAX server's self-telemetry counters and gauges."""

    def __init__(self):
        self.counts: dict = {}
        self.gauges: dict = {}

    def count(self, name, value, tags=None, rate=1.0):
        k = (name, tuple(tags or ()))
        self.counts[k] = self.counts.get(k, 0) + value

    def gauge(self, name, value, tags=None, rate=1.0):
        self.gauges[(name, tuple(tags or ()))] = value

    def __getattr__(self, name):
        return lambda *a, **k: None


def _ours(d: dict) -> dict:
    return {k: v for k, v in d.items()
            if k[0].startswith(("tenant.", "query."))}


@pytest.mark.parametrize("workers,native", [(1, True), (2, False)])
def test_server_query_and_tenancy_equal_jax(workers, native):
    data = {"interval": "10s", "num_workers": workers,
            "tpu_native_ingest": native,
            # the self-traced flush span's names_unique set draws from the
            # module-global random: off, so both servers see the same series
            "ssf_span_uniqueness_rate": 0.0,
            "percentiles": PCTS, "aggregates": ["min", "max", "count", "sum"],
            "tenant_budgets": {"t2": 5}, "tenant_topk": 4,
            "query_listen_addrs": ["http://127.0.0.1:0",
                                   "grpc://127.0.0.1:0"]}
    js = JServer(jload(data=data))
    rec = _Rec()
    js.stats = rec
    ts = build_server(tload(data=data), device="cpu")
    assert ts.tenant_ledger is not None and ts.query_engine is not None
    ports = ts._start_query_listeners()
    jports = js._start_query_listeners()
    from veneur_tpu_torch.query.service import QueryClient

    client = QueryClient(f"127.0.0.1:{ports['grpc://127.0.0.1:0']}")
    try:
        for rnd in range(2):
            grams = ["\n".join(_lines(10 + rnd)[i:i + 30]).encode()
                     for i in range(0, 1200, 30)]
            for d in grams:
                js.process_metric_packet(d)
                ts.process_metric_packet(d)
            js.flush(now=NOW + rnd)
            ts.flush(now=NOW + rnd)
            for req in ({"op": "quantiles", "limit": 10 ** 6},
                        {"op": "quantiles", "qs": [0.1, 0.42],
                         "force_device": True},
                        {"op": "scalars"}, {"op": "cardinality"},
                        {"op": "topk", "tenant": "t2"},
                        {"op": "tenant_totals"}, {"op": "epoch"}):
                want = js.query_engine.dispatch(dict(req))
                assert client.query(req) == want, req
                post = urllib.request.Request(
                    f"http://127.0.0.1:{ports['http://127.0.0.1:0']}/query",
                    data=json.dumps(req).encode())
                with urllib.request.urlopen(post) as resp:
                    assert json.load(resp) == want, req
                js.query_engine.dispatch(dict(req))  # count it as served
            url = f"http://127.0.0.1:{ports['http://127.0.0.1:0']}/metrics"
            with urllib.request.urlopen(url) as resp:
                assert resp.read() == js.query_engine.render_exposition()[0]
        # the counters are read at the flush: one more to report them
        js.flush(now=NOW + 5)
        ts.flush(now=NOW + 5)
        assert _ours(ts.stats.totals()) == _ours(rec.counts)
        assert _ours(ts.stats.gauges()) == _ours(rec.gauges)
        # the Python path refuses samples; the native path keeps the
        # refused rows (counted as refused series)
        assert any(k[0] == "tenant.samples_rejected_total"
                   for k in ts.stats.totals()) != native
        assert ts.stats.gauges()[("tenant.series_rejected",
                                  ("tenant:t2",))] > 0
        assert any(k[0] == "query.served_total" for k in ts.stats.totals())
        assert set(jports) == set(ports)
    finally:
        client.close()
        js.shutdown()
        assert ts.shutdown()
    assert ts._query_servers == []


# -- ops/query -------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 17, 33])
def test_pad_quantiles_and_rows_equal_jax(n):
    q = np.linspace(0.05, 0.95, n)
    a, na = tqops.pad_quantiles(q)
    b, nb = jqops.pad_quantiles(q)
    assert na == nb == n and a.dtype == b.dtype and np.array_equal(a, b)
    if n:
        r = np.arange(n, dtype=np.int32)[::-1]
        a, na = tqops.pad_rows(r)
        b, nb = jqops.pad_rows(r)
        assert na == nb and np.array_equal(a, b)


def _digests(seed: int, s: int = 16, c: int = 32):
    rng = np.random.default_rng(seed)
    means = np.sort(rng.normal(size=(s, c)).astype(np.float32), axis=1)
    weights = rng.uniform(0.0, 4.0, size=(s, c)).astype(np.float32)
    weights[2, :] = 0.0  # an empty row
    weights[4, 5:] = 0.0
    weights[5, 3] = np.float32(1e-40)  # a denormal weight
    dmin = (means.min(axis=1) - 1.0).astype(np.float32)
    dmax = (means.max(axis=1) + 1.0).astype(np.float32)
    return means, weights, dmin, dmax, rng


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("qs", [[0.25, 0.5, 0.9, 0.99], [1.0],
                                list(np.linspace(0, 1, 32))])
def test_quantile_rows_equal_jax(seed, qs):
    means, weights, dmin, dmax, _ = _digests(seed)
    rows = np.asarray([3, 0, 15, 2, 4, 5, 3], np.int32)
    q = np.asarray(qs, np.float32)
    got = tqops.quantile_rows(*(torch.from_numpy(a) for a in
                                (means, weights, dmin, dmax, rows, q)))
    want = np.asarray(jqops.quantile_rows(means, weights, dmin, dmax,
                                          jnp.asarray(rows), jnp.asarray(q)))
    assert got.numpy().tobytes() == want.tobytes()
    # the independent f64 reference, on the rows whose empty slots hold
    # +inf means and no denormal weights (rows 3, 0, 15 and the empty 2)
    well = [0, 1, 2, 3]
    ref = jqops.np_quantile(means, weights, dmin, dmax, q)[rows[well]]
    assert np.allclose(got.numpy()[well], ref, rtol=1e-4, atol=1e-4,
                       equal_nan=True)


@pytest.mark.parametrize("seed", [7, 9])
def test_scalar_rows_equal_jax(seed):
    means, weights, dmin, dmax, rng = _digests(seed)
    drecip = rng.normal(size=16).astype(np.float32)
    drecip_c = (rng.normal(size=16) * 1e-6).astype(np.float32)
    drecip_c[1] = np.float32(-1e-39)
    rows = np.asarray([1, 2, 5, 5, 0], np.int32)
    got = tqops.scalar_rows(*(torch.from_numpy(a) for a in
                              (dmin, dmax, drecip, drecip_c, means, weights,
                               rows)))
    want = jqops.scalar_rows(dmin, dmax, drecip, drecip_c, means, weights,
                             jnp.asarray(rows))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_query_config_validation_equals_jax():
    from veneur_tpu.core.config import Config as JConfig
    from veneur_tpu.core.config import validate_config as jvalidate
    from veneur_tpu_torch.core.config import Config as TConfig
    from veneur_tpu_torch.core.config import validate_config as tvalidate

    tvalidate(TConfig(query_listen_addrs=["http://127.0.0.1:0",
                                          "grpc://0.0.0.0:9100"]))
    for bad in ["127.0.0.1:9100", "tcp://1.2.3.4:1", "http://:1",
                "grpc://host", "http://host:abc"]:
        for cfg, validate in ((JConfig(query_listen_addrs=[bad]), jvalidate),
                              (TConfig(query_listen_addrs=[bad]), tvalidate)):
            with pytest.raises(ValueError):
                validate(cfg)
    assert jdevice_quantiles(PCTS, AGGS).tolist() == QS.tolist()


@pytest.mark.parametrize("engine_cls", [JEngine, TEngine],
                         ids=["jax", "port"])
def test_eval_memo_can_serve_a_stale_block_in_both_packages(engine_cls):
    """Found in both packages, left as the reference has it: the
    per-epoch memo of device quantile blocks is written without the
    commit lock, so a device evaluation that a commit overtakes stores
    the old epoch's block, and the new epoch's next request for the same
    quantiles is served from it. The port copies the engine as it is."""
    import types

    eng = engine_cls(PCTS, AGGS)
    row = types.SimpleNamespace(key=types.SimpleNamespace(
        name="m", type="histogram"), tags=[])
    snap = types.SimpleNamespace(
        directory=types.SimpleNamespace(
            histo=types.SimpleNamespace(rows=[row])),
        quantile_values=np.zeros((1, len(QS)), np.float32),
        dcount=np.ones(1), degraded=False)

    def block(v):
        return np.full((1, 4 + 10), v, np.float32), 4

    def overtaken(qs):
        # a flush commits the next epoch while this evaluation runs
        eng.stage(0, 2, snap, lambda qs: block(2.0), None)
        eng.commit(2)
        return block(1.0)

    eng.stage(0, 1, snap, overtaken, None)
    eng.commit(1)
    first = eng.query_quantiles(qs=[0.3], force_device=True)
    assert first["epoch"] == 1 and first["results"][0]["values"] == [1.0]
    second = eng.query_quantiles(qs=[0.3], force_device=True)
    assert second["epoch"] == 2
    assert second["results"][0]["values"] == [1.0]  # epoch 1's block
