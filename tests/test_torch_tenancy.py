"""The port's per-tenant QoS (veneur_tpu_torch/core/tenancy.py and its
worker and server wiring) against the JAX package's on the CPU, bitwise:
admission on the Python path, the native path and reader-shard
contexts (refused series absent from every sink line), the per-tenant
tallies and their lifetime fold, the tenant-aware spill shed and its
governor attribution, the heavy-hitter fold at the flush, the delivery
spill's eviction order, and the config gates. Inputs are made with numpy
from a seed and handed to both packages."""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import pytest

from veneur_tpu.core import flusher as jflusher
from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.config import validate_config as jvalidate
from veneur_tpu.core.metrics import tenant_of as jtenant_of
from veneur_tpu.core.tenancy import TenantLedger as JLedger
from veneur_tpu.core.tenancy import TenantSketch as JSketch
from veneur_tpu.health.governor import FlushDeadlineGovernor as JGov
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu_torch.core import flusher as tflusher
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import Config as TConfig
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.config import validate_config as tvalidate
from veneur_tpu_torch.core.metrics import DEFAULT_TENANT, HistogramAggregates
from veneur_tpu_torch.core.metrics import tenant_of as ttenant_of
from veneur_tpu_torch.core.tenancy import TenantLedger as TLedger
from veneur_tpu_torch.core.tenancy import TenantSketch as TSketch
from veneur_tpu_torch.core.tenancy import TenantTallies
from veneur_tpu_torch.health import FlushDeadlineGovernor as TGov
from veneur_tpu_torch.protocol import dogstatsd as tdog

AGGS = HistogramAggregates.from_names(["min", "max", "count", "sum"])
PCTS = [0.5, 0.99]
NOW = 1_700_000_000


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype.kind == "f":
        assert np.array_equal(np.isnan(a), np.isnan(b)), what
        ok = ~np.isnan(a)
        a, b = a[ok], b[ok]
    assert a.tobytes() == b.tobytes(), what


def _rows(pool) -> list[tuple]:
    return [(r.key.name, r.key.type, r.key.joined_tags, int(r.scope_class),
             r.tenant, r.admitted) for r in pool.rows]


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
        assert _rows(getattr(a.directory, pool)) == \
            _rows(getattr(b.directory, pool)), (what, pool)
        assert getattr(a.directory, pool).rejected_rows == \
            getattr(b.directory, pool).rejected_rows, (what, pool)
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        assert pa.used == pb.used, (what, pool)
        _same(pa.values[:pa.used], pb.values[:pb.used], (what, pool))
        assert list(pa.admit_codes[:pa.used]) == \
            list(pb.admit_codes[:pb.used]), (what, pool)
        assert pa.rejected_rows == pb.rejected_rows, (what, pool)


def _canonical(metrics) -> list[tuple]:
    return sorted((m.name, m.timestamp, struct.pack("<d", float(m.value)),
                   tuple(m.tags), m.type.name) for m in metrics)


def _lines(seed: int, n: int = 400) -> list[str]:
    """Series of four tenants and untagged ones: timers, counters,
    gauges and sets; tenant t3 registers far more series than the
    others."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = f"t{i % 4}"
        k = (i * 7) % (90 if t == "t3" else 12)
        out += [f"lat.{k}:{rng.gamma(2.0, 15.0):.4f}|ms|#tenant:{t}",
                f"req.{k % 9}:{1 + k % 3}|c|#tenant:{t},code:{k % 2}",
                f"temp.{k % 5}:{rng.normal(20, 4):.5f}|g|#tenant:{t}",
                f"users.{k % 4}:u{int(rng.integers(0, 300))}|s|#tenant:{t}",
                f"plain.{i % 6}:{rng.normal(5.0, 1.0):.4f}|h"]
    return out


def _datagrams(lines: list[str], per: int = 25) -> list[bytes]:
    return ["\n".join(lines[i:i + per]).encode()
            for i in range(0, len(lines), per)]


def _pair(budget=0, budgets=None, sketch=True, **kw):
    jwk = jw.DeviceWorker(**kw)
    twk = tw.DeviceWorker(**kw, device="cpu")
    jwk.tenancy = JLedger(default_budget=budget, budgets=budgets or {})
    twk.tenancy = TLedger(default_budget=budget, budgets=budgets or {})
    if sketch:
        jwk.tenant_sketch = JSketch(depth=4, width=256, topk=4)
        twk.tenant_sketch = TSketch(depth=4, width=256, topk=4,
                                    device="cpu")
    return jwk, twk


def _ledgers_equal(jl, tl):
    assert tl.live_counts() == jl.live_counts()
    assert tl.series_rejected_counts() == jl.series_rejected_counts()
    assert tl.over_budget() == jl.over_budget()


def _sketches_equal(js, ts):
    _same(np.asarray(js.pool), ts.pool.numpy(), "sketch pool")
    assert ts.totals() == js.totals()
    assert ts._row_of == js._row_of
    for t in js.topk:
        assert ts.top_keys(t) == js.top_keys(t), t
    assert set(ts.topk) == set(js.topk)


def _emitted(flusher, snap):
    return _canonical(flusher.generate_inter_metrics(
        snap, True, PCTS, AGGS, now=NOW))


def _refused_absent(snap, metrics):
    """No sink line names a refused series (its name with its tags)."""
    refused = {(r.key.name, r.key.joined_tags)
               for pool in (snap.directory.histo, snap.directory.sets)
               for r in pool.rows if not r.admitted}
    for pool in (snap.scalars.counters, snap.scalars.gauges):
        refused |= {(m[0].name, m[0].joined_tags)
                    for m, code in zip(pool.meta, pool.admit_codes)
                    if not code}
    for name, _ts, _v, tags, _t in metrics:
        base = name.rsplit(".", 1)[0] if "." in name else name
        for cand in (name, base):
            assert (cand, ",".join(sorted(tags))) not in refused and \
                (cand, ",".join(tags)) not in refused, name
    return refused


# -- host parts ------------------------------------------------------------


@pytest.mark.parametrize("tags,key", [
    (["env:prod", "tenant:acme"], "tenant"), (["tenantx:no"], "tenant"),
    ([], "tenant"), (["tenant:"], "tenant"), (["team:x"], "team")])
def test_tenant_of_equals_jax(tags, key):
    assert ttenant_of(tags, key) == jtenant_of(tags, key)


def test_ledger_decisions_equal_jax():
    rng = np.random.default_rng(4)
    jl = JLedger(default_budget=3, budgets={"vip": 0, "tiny": 1})
    tl = TLedger(default_budget=3, budgets={"vip": 0, "tiny": 1})
    for _ in range(2000):
        t = ["a", "b", "vip", "tiny"][int(rng.integers(4))]
        s = f"s{int(rng.integers(12))}"
        assert tl.admit(t, s) == jl.admit(t, s)
    _ledgers_equal(jl, tl)
    tl.set_budgets(10, {"a": 1})
    jl.set_budgets(10, {"a": 1})
    for s in ("x1", "x2", "x3"):
        assert tl.admit("b", s) == jl.admit("b", s)
    _ledgers_equal(jl, tl)


def test_tallies_accumulate_and_conserve():
    epoch, total = TenantTallies(), TenantTallies()
    epoch.accepted["a"], epoch.kept["a"] = 10, 7
    epoch.rejected["a"], epoch.dropped["a"] = 2, 1
    assert epoch.conservation_gaps() == {"a": 0}
    epoch.accumulate_into(total)
    epoch.reset()
    assert epoch.accepted == {}
    merged = total.merged_with(epoch)
    assert merged["accepted"]["a"] == 10 and merged["dropped"]["a"] == 1


def test_governor_tenant_shed_attribution_equals_jax():
    jg, tg = JGov(interval_s=10.0), TGov(interval_s=10.0)
    for t, n in (("evil", 7), ("evil", 3), ("other", 1)):
        jg.note_tenant_shed(t, n)
        tg.note_tenant_shed(t, n)
    assert tg.tenant_shed_counts() == jg.tenant_shed_counts() == \
        {"evil": 10, "other": 1}
    tg.tenant_shed_counts()["evil"] = 0  # a copy
    assert tg.tenant_shed_counts()["evil"] == 10


# -- admission on every ingest path ----------------------------------------


@pytest.mark.parametrize("budget,budgets", [(0, {"t3": 5}), (4, {}),
                                            (6, {"t1": 0, "t3": 2})])
def test_python_path_admission_equals_jax(budget, budgets):
    jwk, twk = _pair(budget, budgets, stage_depth=8, batch_size=64,
                     initial_histo_rows=8, initial_set_rows=8)
    qs = jflusher.device_quantiles(PCTS, AGGS)
    for seed in (1, 2):
        for line in _lines(seed):
            jwk.process_metric(jdog.parse_metric(line.encode()))
            twk.process_metric(tdog.parse_metric(line.encode()))
        assert twk.tenant_lifetime() == jwk.tenant_lifetime()
        js, ts = jwk.flush(qs), twk.flush(qs)
        _snapshots_equal(js, ts, f"interval {seed}")
        got = _emitted(tflusher, ts)
        assert got == _emitted(jflusher, js)
        _refused_absent(ts, got)
        _ledgers_equal(jwk.tenancy, twk.tenancy)
        _sketches_equal(jwk.tenant_sketch, twk.tenant_sketch)
    life = twk.tenant_lifetime()
    assert sum(life["rejected"].values()) > 0
    for t, acc in life["accepted"].items():
        assert acc == (life["kept"].get(t, 0) + life["rejected"].get(t, 0)
                       + life["dropped"].get(t, 0)), t


@pytest.mark.parametrize("budget,budgets", [(0, {"t3": 5}), (4, {})])
def test_native_path_admission_keeps_refused_rows(budget, budgets):
    """C++ assigns the row before the ledger runs: a refused series keeps
    its row, marked admitted=False, and no sink line carries it."""
    jwk, twk = _pair(budget, budgets, stage_depth=8, batch_size=64,
                     initial_histo_rows=8, initial_set_rows=8)
    assert jwk.attach_native() and twk.attach_native()
    qs = jflusher.device_quantiles(PCTS, AGGS)
    for seed in (3, 4):
        for d in _datagrams(_lines(seed)):
            jwk.ingest_datagram(d)
            twk.ingest_datagram(d)
        js, ts = jwk.flush(qs), twk.flush(qs)
        _snapshots_equal(js, ts, f"interval {seed}")
        assert ts.directory.histo.rejected_rows > 0
        got = _emitted(tflusher, ts)
        assert got == _emitted(jflusher, js)
        refused = _refused_absent(ts, got)
        assert refused
        _ledgers_equal(jwk.tenancy, twk.tenancy)
        _sketches_equal(jwk.tenant_sketch, twk.tenant_sketch)
        # refused rows do not ride the forward path either
        fwd = [(i[0], i[1].name, i[1].joined_tags)
               for i in tflusher.forwardable_rows(ts)]
        assert fwd == [(i[0], i[1].name, i[1].joined_tags)
                       for i in jflusher.forwardable_rows(js)]
        assert not {(n, t) for _k, n, t in fwd} & refused


@pytest.mark.parametrize("readers", [2, 3])
def test_reader_shard_admission_equals_jax(readers):
    """Each reader's owned context reconciles its series into the
    canonical directory; admission runs once per series however many
    readers saw it."""
    jwk, twk = _pair(0, {"t3": 4, "t0": 2}, stage_depth=8, batch_size=64,
                     initial_histo_rows=8, initial_set_rows=8)
    for w in (jwk, twk):
        assert w.attach_native() and w.attach_reader_shards(readers)
    qs = jflusher.device_quantiles(PCTS, AGGS)
    grams = _datagrams(_lines(6), per=10)
    for i, d in enumerate(grams):
        jwk._reader_ctxs[i % readers].ingest_owned(d)
        twk._reader_ctxs[i % readers].ingest_owned(d)
    # Python-path lines in reader-shard mode take the Python gate
    for line in ("late.py:3|c|#tenant:t3", "late.py2:1|ms|#tenant:t0"):
        jwk.process_metric(jdog.parse_metric(line.encode()))
        twk.process_metric(tdog.parse_metric(line.encode()))
    assert twk.tenant_lifetime() == jwk.tenant_lifetime()
    js, ts = jwk.flush(qs), twk.flush(qs)
    _snapshots_equal(js, ts, "reader shards")
    got = _emitted(tflusher, ts)
    assert got == _emitted(jflusher, js)
    assert _refused_absent(ts, got)
    _ledgers_equal(jwk.tenancy, twk.tenancy)
    assert twk.tenancy.live("t3") == 4 and twk.tenancy.live("t0") == 2


def test_lifetime_tallies_survive_intervals():
    _jwk, twk = _pair(2, sketch=False)
    qs = tflusher.device_quantiles([], AGGS)
    for interval in range(3):
        for i in range(4):
            twk.process_metric(tdog.parse_metric(
                f"im{i}:1|c|#tenant:rt".encode()))
        sw = twk.swap(qs)
        assert twk.tenant_tallies.accepted == {}
        life = twk.tenant_lifetime()
        assert life["accepted"]["rt"] == 4 * (interval + 1)
        twk.extract_snapshot(sw, qs, 10.0)
    life = twk.tenant_lifetime()
    assert (life["accepted"]["rt"], life["kept"]["rt"],
            life["rejected"]["rt"]) == (12, 6, 6)


def test_budget_spans_metric_types_and_default_tenant():
    _jwk, twk = _pair(3, sketch=False)
    for line in (b"h:1|ms|#tenant:x", b"s:a|s|#tenant:x", b"c:1|c|#tenant:x",
                 b"g:1|g|#tenant:x", b"a:1|c", b"b:1|c", b"_sc|chk|0"):
        twk.process_metric(tdog.parse_metric(line) if not line.startswith(
            b"_sc") else tdog.parse_service_check(line))
    t = twk.tenant_tallies
    assert t.kept["x"] == 3 and t.rejected["x"] == 1
    assert t.kept[DEFAULT_TENANT] == 2
    assert twk.scalars.counters.rejected_rows == 0  # no row on this path


# -- the tenant-aware shed -------------------------------------------------


@pytest.mark.parametrize("abusive", [True, False])
def test_tenant_aware_spill_shed_equals_jax(abusive):
    """Spill past the fold budget sheds over-budget tenants' samples
    first; with none over budget it is the blanket oldest-first rule.
    The kept samples, the per-tenant drops and the governor's
    attribution equal the JAX package's."""
    budgets = {"t3": 3} if abusive else {}
    kw = dict(batch_size=1 << 20, stage_depth=2, initial_histo_rows=8)
    jwk, twk = _pair(0, budgets, sketch=False, **kw)
    jwk.governor, twk.governor = JGov(interval_s=10.0), TGov(interval_s=10.0)
    for w in (jwk, twk):
        assert w.attach_native()
        w.fold_budget_s, w._fold_rate_ewma = 1.0, 700.0
    chunk = (jw._FOLD_CHUNK, tw._FOLD_CHUNK)
    jw._FOLD_CHUNK = tw._FOLD_CHUNK = 50
    try:
        lines = []
        for i in range(900):
            t = f"t{i % 4}"
            lines.append(f"hot.{i % 3}:{(i * 37) % 101}.5|ms|#tenant:{t}")
        for d in _datagrams(lines, per=30):
            jwk.ingest_datagram(d)
            twk.ingest_datagram(d)
        qs = jflusher.device_quantiles(PCTS, AGGS)
        js, ts = jwk.flush(qs), twk.flush(qs)
    finally:
        jw._FOLD_CHUNK, tw._FOLD_CHUNK = chunk
    _snapshots_equal(js, ts, "shed")
    assert twk.overload_dropped == jwk.overload_dropped > 0
    assert twk.tenant_lifetime() == jwk.tenant_lifetime()
    assert sum(twk.tenant_lifetime()["dropped"].values()) == \
        twk.overload_dropped
    assert twk.governor.tenant_shed_counts() == \
        jwk.governor.tenant_shed_counts()
    if abusive:
        assert set(twk.governor.tenant_shed_counts()) == {"t3"}


# -- the delivery spill's eviction order -----------------------------------


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_spill_buffer_evicts_abusive_first_as_jax(cap):
    from veneur_tpu.sinks.delivery import SpillBuffer as JBuf
    from veneur_tpu.sinks.delivery import _SpillEntry as JEntry
    from veneur_tpu_torch.sinks.delivery import SpillBuffer as TBuf
    from veneur_tpu_torch.sinks.delivery import _SpillEntry as TEntry

    order = ["good", "evil", "good", "evil", "evil", "good"]
    out = []
    for buf_cls, entry in ((JBuf, JEntry), (TBuf, TEntry)):
        buf = buf_cls(max_bytes=1 << 20, max_payloads=cap)
        ev = []
        for t in order:
            ev += buf.push(entry(lambda _: None, 10, None, t),
                           abusive=frozenset({"evil"}))
        plain = buf_cls(max_bytes=1 << 20, max_payloads=cap)
        pev = []
        for t in order:
            pev += plain.push(entry(lambda _: None, 10, None, t))
        out.append(([e.tenant for e in ev],
                    [e.tenant for e in buf.pop_all()],
                    [e.tenant for e in pev]))
    assert out[0] == out[1]


# -- config and the server's wiring ----------------------------------------


@pytest.mark.parametrize("bad", [
    dict(tenant_default_budget=-1), dict(tenant_tag_key=""),
    dict(tenant_budgets={"a": -2}), dict(tenant_sketch_depth=0),
    dict(tenant_sketch_depth=9), dict(tenant_sketch_width=1000),
    dict(tenant_sketch_width=32), dict(tenant_topk=0)])
def test_config_tenant_validation_equals_jax(bad):
    for cfg, validate in ((JConfig(**bad), jvalidate),
                          (TConfig(**bad), tvalidate)):
        with pytest.raises(ValueError):
            validate(cfg)
    tvalidate(TConfig(tenant_default_budget=100,
                      tenant_budgets={"vip": 0, "x": 5}))


def test_config_tenant_budgets_env_overlay():
    env = {"VENEUR_TENANT_BUDGETS": "vip:0,noisy:25"}
    tc = tload(data={"tenant_default_budget": 10}, env=env)
    jc = jload(data={"tenant_default_budget": 10}, env=env)
    assert tc.tenant_budgets == jc.tenant_budgets == {"vip": 0, "noisy": 25}


def test_server_installs_ledger_only_when_budgeted():
    from veneur_tpu_torch.core.server import Server

    s = Server(tload(data={"interval": "10s"}), device="cpu")
    try:
        assert s.tenant_ledger is None and s.workers[0].tenancy is None
        assert s.workers[0].governor is s.flush_governor
    finally:
        s.shutdown()
    s2 = Server(tload(data={"interval": "10s", "num_workers": 2,
                            "tenant_budgets": {"noisy": 4},
                            "tenant_sketch_width": 512}), device="cpu")
    try:
        assert s2.tenant_ledger is not None
        for w in s2.workers:
            assert w.tenancy is s2.tenant_ledger
            assert tuple(w.tenant_sketch.pool.shape) == (64, 4, 512)
            assert w.tenant_sketch.pool.device.type == "cpu"
    finally:
        s2.shutdown()


# -- budgets on the global tier's import path ------------------------------


def _import_pair(**cfg_kw):
    from veneur_tpu.core.server import Server as JServer
    from veneur_tpu.distributed.import_server import ImportServer as JImp
    from veneur_tpu_torch.core.server import Server as TServer
    from veneur_tpu_torch.distributed.import_server import (
        ImportServer as TImp)

    cfg_kw.setdefault("interval", "10s")
    cfg_kw.setdefault("num_workers", 2)
    js = JServer(JConfig(**cfg_kw))
    ts = TServer(TConfig(**cfg_kw), device="cpu")
    return (js, JImp(js)), (ts, TImp(ts))


def _imp_batch(n, tenant=None, name="imp", start=0, kind="counter"):
    from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb

    batch = pb.MetricBatch()
    for i in range(start, start + n):
        m = batch.metrics.add()
        m.name = f"{name}{i}"
        m.scope = pb.SCOPE_GLOBAL
        if kind == "counter":
            m.kind = pb.KIND_COUNTER
            m.counter.value = 1 + i
        else:
            m.kind = pb.KIND_GAUGE
            m.gauge.value = 0.5 * i
        if tenant:
            m.tags.append(f"tenant:{tenant}")
    return batch


def _import_tallies(srv):
    out: dict = {}
    for w in srv.workers:
        for kind in TenantTallies.KINDS:
            acc = out.setdefault(kind, {})
            for t, n in getattr(w.tenant_tallies, kind).items():
                acc[t] = acc.get(t, 0) + n
    return out


_IMPORT_CASES = {
    "enforce": (dict(tenant_default_budget=3),
                [("batch", 8, "noisy", "imp", 0)]),
    "keep_flowing": (dict(tenant_default_budget=2),
                     [("batch", 2, "t", "imp", 0), ("batch", 2, "t", "imp", 0),
                      ("batch", 1, "t", "imp", 5), ("batch", 2, "t", "imp", 0)]),
    "independent": (dict(tenant_default_budget=2,
                         tenant_budgets={"vip": 100}),
                    [("batch", 5, "vip", "v", 0),
                     ("batch", 5, "small", "s", 0)]),
    "no_ledger": (dict(), [("batch", 5, "anyone", "imp", 0)]),
    "wire": (dict(tenant_default_budget=2), [("wire", 6, "noisy", "imp", 0)]),
}


@pytest.mark.parametrize("case", sorted(_IMPORT_CASES))
def test_import_budgets_equal_jax(case):
    """The port's ImportServer enforces the same budgets with the same
    ledger and tallies as the JAX package's (the wire path takes the
    Python batch path when a ledger is set), and the flush after the
    import emits the same lines, refused series absent."""
    cfg_kw, steps = _IMPORT_CASES[case]
    (js, jimp), (ts, timp) = _import_pair(**cfg_kw)
    try:
        for how, n, tenant, name, start in steps:
            for kind in ("counter", "gauge"):
                batch = _imp_batch(n, tenant, name + kind[0], start, kind)
                if how == "wire":
                    blob = batch.SerializeToString()
                    assert timp.handle_wire(blob) == \
                        jimp.handle_wire(blob) == n
                else:
                    jimp.handle_batch(batch)
                    timp.handle_batch(batch)
        assert timp.received_metrics == jimp.received_metrics
        assert timp.tenant_rejected_metrics == jimp.tenant_rejected_metrics
        assert _import_tallies(ts) == _import_tallies(js)
        if js.tenant_ledger is None:
            assert ts.tenant_ledger is None
            assert _import_tallies(ts) == {k: {} for k in
                                           TenantTallies.KINDS}
        else:
            _ledgers_equal(js.tenant_ledger, ts.tenant_ledger)
            assert ts.tenant_ledger.series_rejected_counts() or \
                case == "keep_flowing"
        jm = js.flush(now=NOW)
        tm = ts.flush(now=NOW)
        assert _canonical(tm) == _canonical(jm)
        for w in ts.workers:
            for t, n in w.tenant_lifetime()["accepted"].items():
                life = w.tenant_lifetime()
                assert n == life["kept"].get(t, 0) + \
                    life["rejected"].get(t, 0), t
    finally:
        js.shutdown()
        ts.shutdown()
