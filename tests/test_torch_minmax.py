"""Digest min and max in XLA's order: the port against the JAX package.

XLA on the CPU orders -0.0 below +0.0 in every min and max it runs
(``jnp.minimum``, ``jnp.min``, a scatter's ``.at[].min``, ``lax.pmin``)
and lets a NaN operand win. The port computes them through
``ops/exactnum.py`` (``minimum``, ``maximum``, ``amin``, ``amax``,
``scatter_amin_``, ``scatter_amax_``) on every device. Held here, bitwise
(a NaN by its sign: which payload wins among NaNs of one sign is not
pinned), on rows that mix +0.0, -0.0 and NaN at widths 1, 9, 33 and 64:

* the six functions themselves;
* every site that takes a min or a max of digest scalars: the spill
  fold's scatter of lmin and lmax (``_histo_ingest_step``), the import
  step, the staged fold, ``merge_pools``, ``merge_many``, ``add_batch``
  (its plain version) and the mesh's cross-host merge;
* a server interval over Python ingest and over native ingest with
  ``h:0|h`` and ``h:-0|h`` in both orders, staged and spilled past the
  staging depth: the InterMetrics equal the JAX server's.

The card's run of the same rows is tests/test_torch_cuda.py's.
"""

from __future__ import annotations

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.distributed import mesh as jmesh
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server
from veneur_tpu_torch.distributed import mesh as tmesh
from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TChannel

WIDTHS = [1, 9, 33, 64]
C = 128
NAN_POS = np.array([0x7FC00001], np.uint32).view(np.float32)[0]
NAN_NEG = np.array([0xFFC00002], np.uint32).view(np.float32)[0]
NOW = 1_700_000_000


def _bits(a) -> np.ndarray:
    """f32 bits, a NaN as the quiet NaN of its sign."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    sign = u & np.uint32(0x80000000)
    return np.where(np.isnan(a.astype(np.float32)),
                    sign | np.uint32(0x7FC00000), u)


def _same(a, b, what=""):
    ba, bb = _bits(a), _bits(b)
    assert ba.shape == bb.shape, (what, ba.shape, bb.shape)
    bad = np.argwhere(ba != bb)
    assert not len(bad), (what, bad[:5].tolist(), ba[tuple(bad[0])],
                          bb[tuple(bad[0])])


def mixed(rng, shape, nan: bool = True) -> np.ndarray:
    """f32 values drawn from +0.0 and -0.0 (most of them), +-1, +-inf
    and, with ``nan``, NaNs of both signs."""
    pool = [0.0, -0.0, 0.0, -0.0, 1.0, -1.0, np.inf, -np.inf]
    if nan:
        pool += [NAN_POS, NAN_NEG]
    out = rng.choice(np.array(pool, np.float32), shape).astype(np.float32)
    # rows of zeros alone, in both orders, where the sign decides
    zeros = np.where(np.arange(out.shape[-1]) % 2 == 0, 0.0, -0.0)
    out.reshape(-1, out.shape[-1])[0] = zeros
    if out.reshape(-1, out.shape[-1]).shape[0] > 1:
        out.reshape(-1, out.shape[-1])[1] = -zeros
    return out.astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the functions


@pytest.mark.parametrize("w", WIDTHS)
def test_minmax_functions_bitwise_reference(w):
    rng = np.random.default_rng(w)
    a, b = mixed(rng, (8, w)), mixed(rng, (8, w))
    _same(jnp.minimum(a, b), exn.minimum(_t(a), _t(b)), "minimum")
    _same(jnp.maximum(a, b), exn.maximum(_t(a), _t(b)), "maximum")
    _same(jnp.minimum(b, a), exn.minimum(_t(b), _t(a)), "minimum swapped")
    for axis in (0, -1):
        _same(jnp.min(a, axis=axis), exn.amin(_t(a), axis), f"min {axis}")
        _same(jnp.max(a, axis=axis), exn.amax(_t(a), axis), f"max {axis}")
    dst = mixed(rng, (1, 5))[0]
    idx = rng.integers(0, 5, w)
    src = mixed(rng, (1, w))[0]
    _same(jnp.asarray(dst).at[idx].min(src),
          exn.scatter_amin_(_t(dst.copy()), _t(idx), _t(src)), "scatter min")
    _same(jnp.asarray(dst).at[idx].max(src),
          exn.scatter_amax_(_t(dst.copy()), _t(idx), _t(src)), "scatter max")


def test_zero_order_is_xla_s_in_both_operand_orders():
    """-0.0 below +0.0 whichever comes first, at every width torch's own
    ops disagree among (1, 9 and 33 elements)."""
    for w in (1, 9, 33):
        p = torch.zeros(w)
        m = torch.full((w,), -0.0)
        for a, b in ((p, m), (m, p)):
            assert torch.all(torch.signbit(exn.minimum(a, b)))
            assert not torch.any(torch.signbit(exn.maximum(a, b)))
        both = torch.stack([p, m])
        assert torch.all(torch.signbit(exn.amin(both, 0)))
        assert not torch.any(torch.signbit(exn.amax(both.flip(0), 0)))


# ---------------------------------------------------------------------------
# the sites


def _pool_fields(rng, s: int, c: int = C):
    """The worker's 14 pool fields over s rows: a few centroids a row,
    the digest and sampler-local min and max drawn from ``mixed``."""
    means = np.full((s, c), np.inf, np.float32)
    w = np.zeros((s, c), np.float32)
    means[:, :3] = np.sort(rng.normal(0.0, 1.0, (s, 3)), axis=1)
    w[:, :3] = 1.0
    dmin, dmax = mixed(rng, (2, s))
    lmin, lmax = mixed(rng, (2, s))
    z = np.zeros(s, np.float32)
    return [means, w, dmin, dmax, z, z, lmin, lmax, z, z, z, z, z, z]


@pytest.mark.parametrize("w", WIDTHS)
def test_staged_fold_bitwise_reference(w):
    rng = np.random.default_rng(100 + w)
    s = 8
    fields = _pool_fields(rng, s)
    svals = mixed(rng, (s, w))
    swts = rng.choice(np.array([0.0, 1.0, 1.0], np.float32), (s, w))
    swts[:2] = 1.0
    jo = jw._histo_fold_staged(*(jnp.asarray(a) for a in fields),
                               jnp.asarray(svals), jnp.asarray(swts))
    to = tw._histo_fold_staged(*(_t(a.copy()) for a in fields), _t(svals),
                               _t(swts))
    for i in (2, 3, 6, 7):  # dmin, dmax, lmin, lmax
        _same(jo[i], to[i], f"field {i}")


def _ingest_inputs(rng, w: int):
    """w active rows (pool of w + 1, the last the scratch row, two pads),
    a batch of 4w samples drawn from ``mixed``."""
    s = w + 1
    fields = _pool_fields(rng, s)
    active = np.concatenate([np.arange(w), [w, w]]).astype(np.int32)
    n = 4 * w
    lids = rng.integers(0, w, n).astype(np.int32)
    vals = mixed(rng, (1, n))[0]
    wts = np.ones(n, np.float32)
    wts[rng.random(n) < 0.2] = 0.0
    return fields, active, lids, vals, wts


@pytest.mark.parametrize("w", WIDTHS)
def test_spill_fold_scatter_bitwise_reference(w):
    rng = np.random.default_rng(200 + w)
    fields, active, lids, vals, wts = _ingest_inputs(rng, w)
    jo = jw._histo_ingest_step(*(jnp.asarray(a) for a in fields),
                               jnp.asarray(active), jnp.asarray(lids),
                               jnp.asarray(vals), jnp.asarray(wts))
    tf = [_t(a.copy()) for a in fields]
    tw._histo_ingest_step(*tf, _t(active).long(), _t(lids), _t(vals),
                          _t(wts))
    for i in (2, 3, 6, 7):
        _same(jo[i], tf[i], f"field {i}")


@pytest.mark.parametrize("w", WIDTHS)
def test_import_step_bitwise_reference(w):
    rng = np.random.default_rng(300 + w)
    fields = _pool_fields(rng, w + 1)[:6]
    rows = np.arange(w).astype(np.int32)
    imp_m = np.full((w, 16), np.inf, np.float32)
    imp_w = np.zeros((w, 16), np.float32)
    imp_m[:, 0], imp_w[:, 0] = 0.5, 1.0
    imp_min, imp_max = mixed(rng, (2, w))
    imp_recip = np.zeros(w, np.float32)
    args = (rows, imp_m, imp_w, imp_min, imp_max, imp_recip)
    jo = jw._histo_import_step(*(jnp.asarray(a) for a in fields),
                               *(jnp.asarray(a) for a in args))
    tf = [_t(a.copy()) for a in fields]
    tw._histo_import_step(*tf, _t(rows).long(), *(_t(a) for a in args[1:]))
    for i in (2, 3):
        _same(jo[i], tf[i], f"field {i}")


def _digest_pool(rng, s: int):
    means = np.full((s, C), np.inf, np.float32)
    w = np.zeros((s, C), np.float32)
    means[:, 0], w[:, 0] = 1.0, 1.0
    mn, mx = mixed(rng, (2, s))
    return (means, w, mn, mx, np.zeros(s, np.float32))


@pytest.mark.parametrize("w", WIDTHS)
def test_merges_bitwise_reference(w):
    rng = np.random.default_rng(400 + w)
    a, b = _digest_pool(rng, w), _digest_pool(rng, w)
    jo = jtd.merge_pools(jtd.TDigestPool(*(jnp.asarray(x) for x in a)),
                         jtd.TDigestPool(*(jnp.asarray(x) for x in b)))
    to = ttd.merge_pools(ttd.TDigestPool(*(_t(x) for x in a)),
                         ttd.TDigestPool(*(_t(x) for x in b)))
    _same(jo.min, to.min, "merge_pools min")
    _same(jo.max, to.max, "merge_pools max")
    stacked = [np.stack(f) for f in zip(a, b, _digest_pool(rng, w))]
    jo = jtd.merge_many(jtd.TDigestPool(*(jnp.asarray(x) for x in stacked)))
    to = ttd.merge_many(ttd.TDigestPool(*(_t(x) for x in stacked)))
    _same(jo.min, to.min, "merge_many min")
    _same(jo.max, to.max, "merge_many max")


@pytest.mark.parametrize("w", WIDTHS)
def test_add_batch_bitwise_reference(w):
    rng = np.random.default_rng(500 + w)
    pool = _digest_pool(rng, w)
    n = 4 * w
    rows = rng.integers(0, w, n).astype(np.int32)
    vals = mixed(rng, (1, n))[0]
    wts = np.ones(n, np.float32)
    jo = jtd.add_batch(*(jnp.asarray(x) for x in pool), jnp.asarray(rows),
                       jnp.asarray(vals), jnp.asarray(wts))
    to = ttd.add_batch(*(_t(x) for x in pool), _t(rows), _t(vals), _t(wts))
    _same(jo[2], to[2], "min")
    _same(jo[3], to[3], "max")
    _same(jo[5].min, to[5].min, "batch min")
    _same(jo[5].max, to[5].max, "batch max")


@pytest.fixture(scope="module", params=[2, 4], ids=["h2", "h4"])
def meshes(request):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    h = request.param
    return jmesh.make_mesh(8, h), tmesh.make_mesh(8, h, devices=["cpu"] * 8)


def test_mesh_cross_host_merge_bitwise_reference(meshes):
    """Each host's digest min and max from ``mixed`` (and ±0 samples):
    the extract step's pmin and pmax over hosts."""
    jm, tm = meshes
    hosts, d = jm.shape["hosts"], jm.shape["series"]
    s, n = 8 * d, 64 * d
    rng = np.random.default_rng(600 + hosts)
    state = [np.full((hosts, s, C), np.inf, np.float32),
             np.zeros((hosts, s, C), np.float32),
             mixed(rng, (hosts, s)), mixed(rng, (hosts, s)),
             np.zeros((hosts, s), np.float32)]
    batch = [rng.integers(0, 8, (hosts, n)).astype(np.int32),
             mixed(rng, (hosts, n), nan=False),
             np.ones((hosts, n), np.float32)]
    specs = [P("hosts", "series", None)] * 2 + [P("hosts", "series")] * 6
    jst = jmesh.build_mesh_ingest_step(jm, carry_recip=True)(
        *(jax.device_put(a, NamedSharding(jm, sp))
          for a, sp in zip(state + batch, specs)))
    tst = tmesh.build_mesh_ingest_step(tm, carry_recip=True)(
        *(tmesh.place_mesh(tm, a) for a in state + batch))
    for k in (2, 3):
        _same(np.asarray(jst[k]), tmesh.gather_mesh(tst[k]), f"ingest {k}")
    qs = np.asarray([0.0, 0.5, 1.0], np.float32)
    jx = jmesh.build_mesh_extract_step(jm)(*jst, jnp.asarray(qs))
    tx = tmesh.build_mesh_extract_step(tm)(*tst, torch.from_numpy(qs))
    for k in range(6):
        _same(np.asarray(jx[k]), tmesh.gather_mesh(tx[k]), f"extract {k}")


# ---------------------------------------------------------------------------
# a server interval

BASE = {
    "ssf_span_uniqueness_rate": 0.0,
    "percentiles": [0.0, 0.5, 1.0],
    "aggregates": ["min", "max", "count", "sum"],
    "interval": "10s",
    "hostname": "minmax-host",
    "tpu_native_readers": False,
    "flush_emit_native": False,
    "micro_fold": False,
    "tpu_stage_depth": 8,
    "tpu_batch_size": 16,
    "tpu_initial_histo_rows": 16,
}


def _canonical(metrics) -> list[tuple]:
    return sorted((m.name, m.timestamp, struct.pack("<d", float(m.value)),
                   tuple(m.tags), m.type.name) for m in metrics)


def _signed_zero_datagrams(first: str) -> list[bytes]:
    """``first`` then the other zero into h (staged) and t (a timer past
    the staging depth: spill folds), 0 and -0 into g (a gauge)."""
    other = "-0" if first == "0" else "0"
    out = [f"h:{first}|h\nh:{other}|h".encode()]
    for i in range(24):
        out.append(f"t:{first if i % 2 == 0 else other}|ms".encode())
    out.append(f"t.mixed:{first}|ms\nt.mixed:1.5|ms\nt.mixed:{other}|ms"
               .encode())
    return out


def _drain(q):
    out = []
    while not q.empty():
        out.extend(q.get_nowait())
    return out


@pytest.mark.parametrize("first", ["0", "-0"])
@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_server_interval_signed_zeros_equal_jax_server(native, first):
    extra = {"tpu_native_ingest": native}
    jsink, tsink = JChannel(), TChannel()
    js = JServer(jload(data={**BASE, **extra}), metric_sinks=[jsink])
    ts = build_server(tload(data={**BASE, **extra}),
                      extra_metric_sinks=[tsink], device="cpu")
    try:
        for d in _signed_zero_datagrams(first):
            js.process_metric_packet(d)
            ts.process_metric_packet(d)
        js.flush(now=NOW)
        ts.flush(now=NOW)
        jm, tm = _drain(jsink.queue), _drain(tsink.queue)
        assert _canonical(jm) == _canonical(tm)
        got = {m.name: m.value for m in tm}
        assert np.signbit(got["h.min"]) and not np.signbit(got["h.max"])
        assert np.signbit(got["t.min"]) and not np.signbit(got["t.max"])
    finally:
        js.shutdown()
        ts.shutdown()
