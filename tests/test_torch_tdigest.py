"""t-digest pool programs of the PyTorch port against the JAX package.

Same numpy-seeded inputs through veneur_tpu/ops/tdigest and
veneur_tpu_torch/ops/tdigest on the CPU; every output bitwise equal
(NaN positions equal). Cases: ties, empty and single-centroid rows,
non-unit weights, and a JAX-built pool carried across with
pool_from_numpy and continued in both packages.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch.ops import tdigest as ttd

C = 128
QS = np.array([0.01, 0.25, 0.5, 0.9, 0.99, 0.999], np.float32)


def _assert_bitwise(jax_out, torch_out, what=""):
    j = np.asarray(jax_out)
    t = torch_out.numpy() if isinstance(torch_out, torch.Tensor) \
        else np.asarray(torch_out)
    assert j.shape == t.shape, (what, j.shape, t.shape)
    assert np.array_equal(np.isnan(j), np.isnan(t)), what
    ok = ~np.isnan(j)
    assert np.array_equal(j[ok].view(np.uint32),
                          t[ok].astype(np.float32).view(np.uint32)), what


def _candidates(s, m, seed, *, ties=False, weighted=False):
    """Candidate centroid rows [s, m]: row 0 empty, row 1 a single
    centroid, the rest random fill."""
    rng = np.random.default_rng(seed)
    means = rng.normal(50.0, 20.0, (s, m)).astype(np.float32)
    if ties:
        means = np.round(means / 5.0).astype(np.float32) * 5
    w = (rng.lognormal(0.0, 1.0, (s, m)) if weighted
         else np.ones((s, m))).astype(np.float32)
    w[rng.random((s, m)) < 0.3] = 0.0
    w[0] = 0.0
    w[1] = 0.0
    w[1, 3] = 2.5
    means[w == 0] = np.inf
    return means, w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m", [C, 2 * C, C + 64])
def test_compress_rows_bitwise(ties, weighted, m):
    means, w = _candidates(24, m, m + 2 * ties + weighted, ties=ties,
                           weighted=weighted)
    jm, jw = jtd.compress_rows(jnp.asarray(means), jnp.asarray(w),
                               compression=100.0, capacity=C)
    tm, tw = ttd.compress_rows(torch.from_numpy(means), torch.from_numpy(w),
                               100.0, C)
    _assert_bitwise(jm, tm, "means")
    _assert_bitwise(jw, tw, "weights")


def _batch(k, n, seed, *, ties=False, weighted=False, pad=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, k, n).astype(np.int32)
    rows[rows == 0] = 1  # row 0 receives nothing
    vals = rng.gamma(2.0, 30.0, n).astype(np.float32)
    if ties:
        vals = np.round(vals).astype(np.float32)
    wts = (rng.choice([0.5, 1.0, 2.0, 10.0], n) if weighted
           else np.ones(n)).astype(np.float32)
    if pad:
        rows = np.concatenate([rows, np.full(pad, k - 1, np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, np.float32)])
        wts = np.concatenate([wts, np.zeros(pad, np.float32)])
    return rows, vals, wts


def _both_add(jpool, tpool, rows, vals, wts, compression=100.0):
    jout = jtd.add_batch(*jpool, jnp.asarray(rows), jnp.asarray(vals),
                         jnp.asarray(wts), compression=compression)
    tout = ttd.add_batch(*tpool, torch.from_numpy(rows),
                         torch.from_numpy(vals), torch.from_numpy(wts),
                         compression=compression)
    return jout, tout


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [1, 300, 2000])
def test_add_batch_bitwise(ties, weighted, n):
    k = 16
    rows, vals, wts = _batch(k, n, n + 10 * ties + weighted, ties=ties,
                             weighted=weighted, pad=37)
    jpool = tuple(jtd.init_pool(k, C))
    tpool = tuple(ttd.init_pool(k, C, device="cpu"))
    for rnd in range(2):  # a second batch merges into non-empty rows
        (jm, jw, jmin, jmax, jr, jst), (tm, tw, tmin, tmax, tr, tst) = \
            _both_add(jpool, tpool, rows, vals + rnd, wts)
        for name, a, b in (("means", jm, tm), ("weights", jw, tw),
                           ("min", jmin, tmin), ("max", jmax, tmax),
                           ("recip", jr, tr)):
            _assert_bitwise(a, b, f"round {rnd} {name}")
        for f in jtd.BatchStats._fields:
            _assert_bitwise(getattr(jst, f), getattr(tst, f), f"stats.{f}")
        jpool = (jm, jw, jmin, jmax, jr)
        tpool = (tm, tw, tmin, tmax, tr)


def _filled_pool(k, seed, weighted=False):
    rows, vals, wts = _batch(k, 40 * k, seed, weighted=weighted)
    pool = jtd.init_pool(k, C)
    out = jtd.add_batch(*pool, jnp.asarray(rows), jnp.asarray(vals),
                        jnp.asarray(wts))
    return jtd.TDigestPool(*out[:5])


@pytest.mark.parametrize("weighted", [False, True])
def test_quantile_sum_count_bitwise(weighted):
    jpool = _filled_pool(32, 5 + weighted, weighted)
    tpool = ttd.pool_from_numpy(jtd.pool_to_numpy(jpool), "cpu")
    _assert_bitwise(
        jtd.quantile(jpool.means, jpool.weights, jpool.min, jpool.max,
                     jnp.asarray(QS)),
        ttd.quantile(tpool.means, tpool.weights, tpool.min, tpool.max,
                     torch.from_numpy(QS)), "quantile")
    _assert_bitwise(jtd.row_sum(jpool.means, jpool.weights),
                    ttd.row_sum(tpool.means, tpool.weights), "row_sum")
    _assert_bitwise(jtd.row_count(jpool.weights),
                    ttd.row_count(tpool.weights), "row_count")


def test_quantile_edge_rows_bitwise():
    """Empty, single-centroid, two-centroid, full and skewed rows (the
    Pallas test's occupancy extremes)."""
    s = 8
    means = np.full((s, C), np.inf, np.float32)
    weights = np.zeros((s, C), np.float32)
    means[1, 0], weights[1, 0] = 42.0, 5.0
    means[2, :2], weights[2, :2] = [10.0, 20.0], [1.0, 3.0]
    means[3], weights[3] = np.linspace(0, 127, C), 1.0
    means[4, :3], weights[4, :3] = [1.0, 2.0, 3.0], [1.0, 1e6, 1.0]
    nz = weights.sum(1) > 0
    dmin = np.where(nz, np.min(np.where(weights > 0, means, np.inf), 1),
                    np.inf).astype(np.float32)
    dmax = np.where(nz, np.max(np.where(weights > 0, means, -np.inf), 1),
                    -np.inf).astype(np.float32)
    qs = np.array([0.0, 0.01, 0.5, 0.99, 1.0], np.float32)
    j = jtd.quantile(*(jnp.asarray(a) for a in (means, weights, dmin, dmax,
                                                 qs)))
    t = ttd.quantile(*(torch.from_numpy(a) for a in (means, weights, dmin,
                                                      dmax, qs)))
    _assert_bitwise(j, t, "quantile")
    assert np.isnan(t.numpy()[0]).all() and np.isfinite(t.numpy()[1:5]).all()


def test_pool_carried_across_and_continued():
    """A pool built by the JAX package continues in both packages: the
    same next batch gives the same bits."""
    k = 12
    jpool = _filled_pool(k, 21)
    tpool = ttd.pool_from_numpy(jtd.pool_to_numpy(jpool), "cpu")
    for a, b in zip(jpool, tpool):
        _assert_bitwise(a, b, "carried")
    rows, vals, wts = _batch(k, 500, 22, weighted=True)
    jout, tout = _both_add(tuple(jpool), tuple(tpool), rows, vals, wts)
    for a, b in zip(jout[:5], tout[:5]):
        _assert_bitwise(a, b, "continued")
    _assert_bitwise(
        jtd.quantile(*jout[:4], jnp.asarray(QS)),
        ttd.quantile(*tout[:4], torch.from_numpy(QS)), "quantile")


def test_init_pool_matches():
    j = jtd.pool_to_numpy(jtd.init_pool(5, C))
    t = ttd.init_pool(5, C, device="cpu")
    for key, b in zip(("means", "weights", "min", "max", "recip"), t):
        _assert_bitwise(j[key], b, key)
    assert ttd.capacity_for(100.0) == jtd.capacity_for(100.0)
    assert ttd.capacity_for(200.0) == jtd.capacity_for(200.0)


def _bad_rows(j, t) -> np.ndarray:
    """Rows where the two outputs differ in bits (NaN positions equal)."""
    j, t = np.asarray(j), t.numpy()
    same = (j.view(np.uint32) == t.view(np.uint32)) | (np.isnan(j)
                                                        & np.isnan(t))
    return ~same.reshape(len(same), -1).all(axis=1)


def test_denormal_samples():
    """Denormal sample values and weights, and normal samples whose
    products, quotients and partial sums underflow, through add_batch and
    _compress_rows: bitwise equal to the reference, which runs on XLA on
    the CPU with denormals-are-zero and flush-to-zero (ROADMAP.md section
    3). The batch min and max are gathers, so a denormal there keeps its
    bits in both."""
    rng = np.random.default_rng(3)
    s, n = 10, 400
    tiny = np.finfo(np.float32).tiny
    rows = rng.integers(0, s, n).astype(np.int32)
    vals = rng.normal(50.0, 10.0, n).astype(np.float32)
    wts = np.ones(n, np.float32)
    dv = rows < 4  # rows 0-3: denormal values; rows 4-5: denormal weights
    vals[dv] = rng.integers(-2**20, 2**20, int(dv.sum())) * np.float32(1e-45)
    dw = (rows >= 4) & (rows < 6)
    wts[dw] = rng.integers(1, 2**20, int(dw.sum())) * np.float32(1e-45)
    # rows 6-7: normal values of both signs in [tiny, 2 tiny) and weights
    # near 1, so v·w and the prefixes underflow; rows 8-9: values near
    # the f32 maximum, so the reciprocals w/v do
    uf = (rows >= 6) & (rows < 8)
    vals[uf] = (rng.choice([-1.0, 1.0], int(uf.sum()))
                * tiny * (1.0 + rng.random(int(uf.sum()))))
    wts[uf] = rng.uniform(0.5, 1.5, int(uf.sum()))
    big = rows >= 8
    vals[big] = rng.uniform(1e38, 3e38, int(big.sum()))
    jo = jtd.add_batch(*jtd.init_pool(s, C), jnp.asarray(rows),
                       jnp.asarray(vals), jnp.asarray(wts))
    to = ttd.add_batch(*ttd.init_pool(s, C, device="cpu"),
                       torch.from_numpy(rows), torch.from_numpy(vals),
                       torch.from_numpy(wts))
    for i, name in enumerate(("means", "weights", "min", "max", "recip")):
        _assert_bitwise(jo[i], to[i], name)
    for f in jtd.BatchStats._fields:
        _assert_bitwise(getattr(jo[5], f), getattr(to[5], f), f"stats.{f}")
    # the raw bits survive in the batch min/max, not in the digest's
    smin = to[5].min.numpy()
    assert ((np.abs(smin) < tiny) & (smin != 0)).any()
    assert not ((np.abs(to[2].numpy()) < tiny) & (to[2].numpy() != 0)).any()

    m = 2 * C
    means = rng.normal(50.0, 20.0, (s, m)).astype(np.float32)
    w = np.ones((s, m), np.float32)
    means[:3] = rng.integers(-2**20, 2**20, (3, m)) * np.float32(1e-45)
    w[3:5] = rng.integers(1, 2**20, (2, m)) * np.float32(1e-45)
    means[5:8] = (rng.choice([-1.0, 1.0], (3, m))
                  * tiny * (1.0 + rng.random((3, m))))
    w[5:8] = rng.uniform(0.25, 2.0, (3, m))
    jm, jw = jtd.compress_rows(jnp.asarray(means), jnp.asarray(w),
                               compression=100.0, capacity=C)
    tm, tw = ttd.compress_rows(torch.from_numpy(means), torch.from_numpy(w),
                               compression=100.0, capacity=C)
    _assert_bitwise(jm, tm, "means")
    _assert_bitwise(jw, tw, "weights")
