"""The port's columnar flush batch against the JAX package's, on the CPU.

The same DogStatsD lines go through ``veneur_tpu.core.worker.DeviceWorker``
and ``veneur_tpu_torch.core.worker.DeviceWorker(device="cpu")``, on the
Python path and on the native C++ path, and each snapshot through
``generate_columnar``: every group's row count, routing flag, frag arena
(``meta_blob``), row metadata, family suffixes, types, value columns and
masks are equal bit for bit, as are the extras, ``emit_plan()`` and
``materialize()``. The traffic covers local and global instances, mixed,
local-only and global-only scopes, sets, status checks, routed rows,
non-finite values (f32 overflow in the digests, f64 overflow in a
counter), and rows rejected from the flush. The port's columnar batch also
equals its own object path (``generate_inter_metrics``) as a multiset,
after tests/test_columnar.py.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

from veneur_tpu.core import columnar as jcol
from veneur_tpu.core import flusher as jflusher
from veneur_tpu.core import worker as jw
from veneur_tpu.core.metrics import HistogramAggregates as JAggs
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu_torch.core import columnar as tcol
from veneur_tpu_torch.core import flusher as tflusher
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.metrics import HistogramAggregates as TAggs
from veneur_tpu_torch.protocol import dogstatsd as tdog

NOW = 1_700_000_000
ALL = ["min", "max", "count", "sum", "average", "median", "hmean"]
CONFIGS = [
    ([0.5, 0.9, 0.99], ALL),
    ([], ["min", "max", "count"]),
    ([0.99], ["median", "hmean", "sum"]),
]


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    assert a.tobytes() == b.tobytes(), what


def _lines(seed: int) -> list[bytes]:
    """One interval: histograms and timers of every scope, sampled
    timers, counters (one overflowing f64), gauges, sets of every scope,
    routed series, status checks, and digests whose f32 samples overflow
    (+inf max, NaN sum)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        for v in rng.gamma(2.0, 50.0, 12):
            out.append(f"h{i}:{v:.3f}|ms|#k:{i}")
        out.append(f"hs{i % 4}:{rng.normal(9.0, 2.0):.4f}|ms|@0.5")
    for i in range(10):
        out.append(f"hl{i}:{i}|h|#veneurlocalonly")
        out.append(f"hg{i}:{i}|ms|#veneurglobalonly")
    out += ["huge:1e308|h", "huge:-1e308|h", "huge:1e308|h",
            "big.c:1e308|c", "big.c:1e308|c", "zero.h:0|h"]
    for i in range(25):
        out.append(f"c{i}:3|c|#a:{i}")
        out.append(f"cg{i}:2|c|#veneurglobalonly")
        out.append(f"g{i}:{rng.normal(7.0, 1.0):.6f}|g")
    for i in range(15):
        for j in range(30):
            out.append(f"s{i}:item{j}|s")
        out.append(f"sl{i}:only{i}|s|#veneurlocalonly")
        out.append(f"sg{i}:g{i}|s|#veneurglobalonly")
    out += ["routed:1|c|#veneursinkonly:datadog",
            "routed.h:4|h|#veneursinkonly:datadog,env:x",
            "routed.s:a|s|#veneursinkonly:channel",
            f"_sc|svc.check|1|#role:r{seed}|m:all good",
            "_sc|svc.other|2|m:bad"]
    return [ln.encode() for ln in out]


def _feed(w, dog, lines, native):
    if native:
        # the server hands service checks to the Python parser
        w.ingest_datagram(b"\n".join(
            ln for ln in lines if not ln.startswith(b"_sc")))
        lines = [ln for ln in lines if ln.startswith(b"_sc")]
    for ln in lines:
        w.process_metric(dog.parse_service_check(ln) if ln.startswith(b"_sc")
                         else dog.parse_metric(ln))


def _workers(native: bool, is_local: bool):
    kw = dict(is_local=is_local, stage_depth=8, batch_size=64,
              initial_histo_rows=8, initial_set_rows=8)
    jwk, twk = jw.DeviceWorker(**kw), tw.DeviceWorker(**kw, device="cpu")
    if native:
        assert jwk.attach_native() and twk.attach_native()
    return jwk, twk


def _snapshots(native, is_local, pcts, aggs, seed=3):
    jwk, twk = _workers(native, is_local)
    lines = _lines(seed)
    _feed(jwk, jdog, lines, native)
    _feed(twk, tdog, lines, native)
    qs = jflusher.device_quantiles(pcts, JAggs.from_names(aggs))
    return jwk.flush(qs), twk.flush(qs)


def _meta(meta):
    name, tags, sinks = meta
    return name, list(tags), None if sinks is None else sorted(sinks)


def _metric(m):
    return (m.name, m.timestamp, struct.pack("<d", float(m.value)),
            tuple(m.tags), m.type.name, m.message, m.hostname,
            None if m.sinks is None else tuple(sorted(m.sinks)))


def assert_batches_equal(jb, tb):
    """Every array of two ColumnarMetrics batches bitwise, every row's
    metadata and the extras equal; emit plans and materializations
    equal in order."""
    assert jb.timestamp == tb.timestamp
    assert len(jb.groups) == len(tb.groups)
    for gi, (jg, tg) in enumerate(zip(jb.groups, tb.groups)):
        assert (jg.nrows, jg.has_routing) == (tg.nrows, tg.has_routing), gi
        if jg.meta_blob is None:
            assert tg.meta_blob is None, gi
        else:
            assert bytes(jg.meta_blob) == bytes(tg.meta_blob), gi
        assert [_meta(jg.meta_at(i)) for i in range(jg.nrows)] == \
            [_meta(tg.meta_at(i)) for i in range(tg.nrows)], gi
        assert [jg.frag_at(i) for i in range(jg.nrows)] == \
            [tg.frag_at(i) for i in range(tg.nrows)], gi
        assert [(f.suffix, f.type.name) for f in jg.families] == \
            [(f.suffix, f.type.name) for f in tg.families], gi
        for jf, tf in zip(jg.families, tg.families):
            _same(jf.values, tf.values, (gi, jf.suffix, "values"))
            if jf.mask is None:
                assert tf.mask is None, (gi, jf.suffix)
            else:
                _same(jf.mask, tf.mask, (gi, jf.suffix, "mask"))
    assert [_metric(m) for m in jb.extras] == [_metric(m) for m in tb.extras]
    for jp, tp in zip(jb.emit_plan(), tb.emit_plan(), strict=True):
        if jp is None:
            assert tp is None
            continue
        assert (jp.nrows, jp.suffixes) == (tp.nrows, tp.suffixes)
        assert bytes(jp.meta_blob) == bytes(tp.meta_blob)
        for f in ("family_types", "values", "masks"):
            _same(getattr(jp, f), getattr(tp, f), f)
    assert [_metric(m) for m in jb.materialize()] == \
        [_metric(m) for m in tb.materialize()]
    assert jb.count() == tb.count() == len(tb.materialize())


@pytest.mark.parametrize("pcts,aggs", CONFIGS, ids=["all", "mmc", "mhs"])
@pytest.mark.parametrize("is_local", [True, False], ids=["local", "global"])
@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_batch_bitwise_equals_jax(native, is_local, pcts, aggs):
    js, ts = _snapshots(native, is_local, pcts, aggs)
    jb = jflusher.generate_columnar(js, is_local, pcts,
                                    JAggs.from_names(aggs), now=NOW)
    tb = tflusher.generate_columnar(ts, is_local, pcts,
                                    TAggs.from_names(aggs), now=NOW)
    assert_batches_equal(jb, tb)
    # the traffic reaches what the batch must handle
    kinds = {g.families[0].type.name for g in tb.groups}
    assert kinds == {"GAUGE", "COUNTER"}
    assert any(g.has_routing for g in tb.groups) and tb.extras
    vals = np.concatenate([f.values for g in tb.groups for f in g.families])
    assert not np.isfinite(vals).all()
    # every group without separators has its arena, scalars included
    assert all(g.meta_blob is not None for g in tb.groups)


@pytest.mark.parametrize("pcts,aggs", CONFIGS, ids=["all", "mmc", "mhs"])
@pytest.mark.parametrize("is_local", [True, False], ids=["local", "global"])
def test_port_columnar_equals_port_object_path(is_local, pcts, aggs):
    _, ts = _snapshots(False, is_local, pcts, aggs)
    taggs = TAggs.from_names(aggs)
    objs = tflusher.generate_inter_metrics(ts, is_local, pcts, taggs,
                                           now=NOW)
    tb = tflusher.generate_columnar(ts, is_local, pcts, taggs, now=NOW)
    assert len(tb) == len(objs)
    assert sorted(map(_metric, tb.materialize())) == \
        sorted(map(_metric, objs))
    assert sorted(map(_metric, tb)) == sorted(map(_metric, objs))


@pytest.mark.parametrize("is_local", [True, False], ids=["local", "global"])
@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_rejected_rows_are_cut_as_in_jax(native, is_local):
    """Rows rejected from the flush (a tenant budget's verdict in the JAX
    package) leave every family, percentiles included, in both."""
    js, ts = _snapshots(native, is_local, [0.5, 0.99], ALL)
    for snap in (js, ts):
        pools = [snap.directory.histo, snap.directory.sets,
                 snap.scalars.counters, snap.scalars.gauges]
        for pool in pools:
            for row in range(1, len(pool.admit_codes), 3):
                pool.admit_codes[row] = 0
                pool.rejected_rows += 1
    args = (is_local, [0.5, 0.99])
    jb = jflusher.generate_columnar(js, *args, JAggs.from_names(ALL),
                                    now=NOW)
    tb = tflusher.generate_columnar(ts, *args, TAggs.from_names(ALL),
                                    now=NOW)
    assert_batches_equal(jb, tb)
    full = tflusher.generate_columnar(
        _snapshots(native, is_local, [0.5, 0.99], ALL)[1], *args,
        TAggs.from_names(ALL), now=NOW)
    assert 0 < tb.count() < full.count()


def test_iter_rows_routing_and_exclusion_as_in_jax():
    js, ts = _snapshots(False, True, [0.5], ALL)
    jb = jflusher.generate_columnar(js, True, [0.5], JAggs.from_names(ALL),
                                    now=NOW)
    tb = tflusher.generate_columnar(ts, True, [0.5], TAggs.from_names(ALL),
                                    now=NOW)
    for sink, excl in (("datadog", None), ("channel", {"k"}),
                       ("prometheus", {"a", "role"}), (None, None)):
        rows = [[(n, struct.pack("<d", v), list(t), ty.name, s)
                 for n, v, t, ty, s in b.iter_rows(sink, excl)]
                for b in (jb, tb)]
        assert rows[0] == rows[1] and rows[1], sink
        if sink is not None:
            assert jb.count_for(sink) == tb.count_for(sink)
    assert tb.count_for("prometheus") < tb.count_for("datadog")


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_scalar_frag_arenas_as_in_jax(native):
    """The scalar pools keep the wire-frag arena the native emit tier
    reads; on the Python path a separator inside a tag poisons it, in
    both packages."""
    jwk, twk = _workers(native, True)
    lines = [b"c.a:1|c|#x:1", b"c.b:2|c", b"g.a:3|g|#y:2,z",
             b"g.b:4|g|#tab:a\tb"]
    _feed(jwk, jdog, lines, native)
    _feed(twk, tdog, lines, native)
    qs = jflusher.device_quantiles([], JAggs.from_names(["count"]))
    js, ts = jwk.flush(qs), twk.flush(qs)
    for pool in ("counters", "gauges"):
        jb = getattr(js.scalars, pool).frag_blob()
        tb = getattr(ts.scalars, pool).frag_blob()
        assert tb is not None and bytes(jb) == bytes(tb), pool
    # the C++ parser rewrites the separator, the Python parser keeps it
    bad = b"g.c:5|g|#sep:a\x1fb"
    _feed(jwk, jdog, [bad], native)
    _feed(twk, tdog, [bad], native)
    js, ts = jwk.flush(qs), twk.flush(qs)
    jb, tb = js.scalars.gauges.frag_blob(), ts.scalars.gauges.frag_blob()
    if native:
        assert bytes(jb) == bytes(tb) == b"g.c\x1fsep:a_b"
    else:
        assert jb is None and tb is None
    assert ts.scalars.gauges.used == js.scalars.gauges.used == 1


def test_unpack_extract_columns_as_in_jax():
    rng = np.random.default_rng(11)
    packed = rng.normal(size=(9, 3 + tcol.EXTRACT_AGG_COLUMNS)).astype(
        np.float32)
    perm = rng.permutation(9)
    for p in (None, perm):
        jq, ja = jcol.unpack_extract_columns(packed, 3, p)
        tq, ta = tcol.unpack_extract_columns(packed, 3, p)
        _same(jq, tq, "quantiles")
        for a, b in zip(ja, ta, strict=True):
            _same(a, b, "aggregate")
