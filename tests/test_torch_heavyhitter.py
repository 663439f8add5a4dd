"""The port's heavy-hitter sketches (veneur_tpu_torch/ops/heavyhitter.py)
against the JAX package's on the CPU, bitwise: the count-min pools as
int32 arrays, chunked inserts against one shot, merges, point queries,
per-tenant totals in int32 past 2^31, the fenced reads, and the
space-saving top-k on the same offers. Inputs are made with numpy from a
seed and handed to both."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import heavyhitter as jhh
from veneur_tpu_torch.ops import heavyhitter as thh

CPU = "cpu"


def _batch(seed: int, n: int, num_tenants: int = 4, num_keys: int = 500,
           depth: int = thh.DEFAULT_DEPTH, width: int = thh.DEFAULT_WIDTH):
    rng = np.random.default_rng(seed)
    keys = [f"k{rng.integers(num_keys)}" for _ in range(n)]
    rows = rng.integers(0, num_tenants, size=n).astype(np.int32)
    counts = rng.integers(1, 20, size=n).astype(np.int32)
    cols = thh.split_hashes(thh.hash_keys(keys), depth, width)
    return keys, rows, cols, counts


def _jfold(pool, rows, cols, counts):
    return jhh.insert_batch(pool, jnp.asarray(rows), jnp.asarray(cols),
                            jnp.asarray(counts))


def _same(jarr, tt: torch.Tensor) -> bool:
    a = np.asarray(jarr)
    b = tt.numpy()
    return a.dtype == b.dtype == np.int32 and a.shape == b.shape and \
        np.array_equal(a, b)


def test_init_pool_shape_dtype_and_width_check():
    assert _same(jhh.init_pool(3, 2, 64), thh.init_pool(3, 2, 64, CPU))
    with pytest.raises(ValueError):
        thh.init_pool(2, width=1000, device=CPU)


@pytest.mark.parametrize("depth,width", [(4, 2048), (2, 64), (8, 1024)])
def test_hashes_and_columns_equal(depth, width):
    keys = [f"svc{i}.latency|#tenant:t{i % 5}" for i in range(300)]
    h = thh.hash_keys(keys)
    assert np.array_equal(h, jhh.hash_keys(keys))
    cols = thh.split_hashes(h, depth, width)
    assert np.array_equal(cols, jhh.split_hashes(h, depth, width))
    for j in range(cols.shape[1]):  # odd stride: distinct probes
        assert len(set(cols[:, j].tolist())) == depth


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_insert_batch_pool_equals_jax(seed):
    _, rows, cols, counts = _batch(seed, 700)
    j = _jfold(jhh.init_pool(4), rows, cols, counts)
    t = thh.insert_batch(thh.init_pool(4, device=CPU), rows, cols, counts)
    assert _same(j, t)


def test_insert_batch_returns_a_new_tensor():
    """A fenced view shares the pool by reference: a fold must leave the
    tensor it was given as it was."""
    _, rows, cols, counts = _batch(5, 300)
    pool = thh.insert_batch(thh.init_pool(4, device=CPU), rows, cols, counts)
    before = pool.clone()
    out = thh.insert_batch(pool, rows, cols, counts)
    assert out.data_ptr() != pool.data_ptr()
    assert torch.equal(pool, before)
    assert torch.equal(out, before * 2)


@pytest.mark.parametrize("chunk", [64, 256, 1024, 4096])
def test_chunked_equals_single_shot_and_jax(chunk):
    _, rows, cols, counts = _batch(7, 1000)
    single = thh.insert_batch(thh.init_pool(4, device=CPU), rows, cols,
                              counts)
    chunked = thh.insert_chunked(thh.init_pool(4, device=CPU), rows, cols,
                                 counts, chunk)
    assert torch.equal(chunked, single)
    assert _same(jhh.insert_chunked(jhh.init_pool(4), rows, cols, counts,
                                    chunk), chunked)


def test_merge_algebra_equals_jax():
    jp, tp = [], []
    for seed in range(3):
        _, rows, cols, counts = _batch(seed, 200)
        jp.append(_jfold(jhh.init_pool(4), rows, cols, counts))
        tp.append(thh.insert_batch(thh.init_pool(4, device=CPU), rows, cols,
                                   counts))
    a, b, c = tp
    assert torch.equal(thh.merge(a, b), thh.merge(b, a))
    assert torch.equal(thh.merge(thh.merge(a, b), c),
                       thh.merge(a, thh.merge(b, c)))
    assert _same(jhh.merge(jhh.merge(jp[0], jp[1]), jp[2]),
                 thh.merge(thh.merge(a, b), c))


def test_merge_equals_joint_insert():
    _, rows, cols, counts = _batch(11, 400)
    joint = thh.insert_batch(thh.init_pool(4, device=CPU), rows, cols, counts)
    half_a = thh.insert_batch(thh.init_pool(4, device=CPU), rows[:200],
                              cols[:, :200], counts[:200])
    half_b = thh.insert_batch(thh.init_pool(4, device=CPU), rows[200:],
                              cols[:, 200:], counts[200:])
    assert torch.equal(thh.merge(half_a, half_b), joint)


@pytest.mark.parametrize("num_keys", [1000, 100_000])
def test_query_equals_jax_and_bounds(num_keys):
    rng = np.random.default_rng(num_keys)
    n = 20_000
    key_ids = rng.zipf(1.3, size=n) % num_keys
    truth: dict[int, int] = {}
    for k in key_ids.tolist():
        truth[k] = truth.get(k, 0) + 1
    keys = [f"key{k}" for k in truth]
    exact = np.array([truth[k] for k in truth], dtype=np.int64)
    cols = thh.split_hashes(thh.hash_keys(keys))
    rows = np.zeros(len(keys), dtype=np.int32)
    tpool = thh.insert_chunked(thh.init_pool(1, device=CPU), rows, cols,
                               exact.astype(np.int32), 4096)
    jpool = jhh.insert_chunked(jhh.init_pool(1), rows, cols,
                               exact.astype(np.int32), 4096)
    assert _same(jpool, tpool)
    est = thh.query(tpool, torch.from_numpy(rows), torch.from_numpy(cols))
    jest = jhh.query(jpool, jnp.asarray(rows), jnp.asarray(cols))
    assert _same(jest, est)
    est = est.numpy().astype(np.int64)
    assert (est >= exact).all()
    over = est - exact
    assert float((over > np.e / thh.DEFAULT_WIDTH * n).mean()) <= \
        np.exp(-thh.DEFAULT_DEPTH) + 0.01
    assert int(thh.tenant_totals(tpool)[0]) == n


@pytest.mark.parametrize("per_key", [1 << 29, (1 << 30) + 12345])
def test_tenant_totals_int32_past_2_31(per_key):
    """One depth row sums past 2^31: both packages wrap in int32."""
    keys = [f"big{i}" for i in range(8)]
    cols = thh.split_hashes(thh.hash_keys(keys))
    rows = np.array([0, 0, 0, 0, 0, 1, 1, 1], dtype=np.int32)
    counts = np.full(8, per_key, dtype=np.int32)
    tpool = thh.insert_batch(thh.init_pool(2, device=CPU), rows, cols, counts)
    jpool = _jfold(jhh.init_pool(2), rows, cols, counts)
    tt = thh.tenant_totals(tpool)
    assert tt.dtype == torch.int32
    assert _same(jhh.tenant_totals(jpool), tt)
    assert int(5 * per_key) > 2 ** 31 - 1  # the row really wraps
    assert np.array_equal(thh.read_totals(tpool), jhh.read_totals(jpool))


def test_tenant_rows_isolated():
    _, _, cols, counts = _batch(2, 100, num_tenants=1)
    pool = thh.insert_batch(thh.init_pool(2, device=CPU),
                            np.zeros(100, np.int32), cols, counts)
    before = pool[0].clone()
    pool = thh.insert_batch(pool, np.ones(100, np.int32), cols, counts)
    assert torch.equal(pool[0], before)
    assert torch.equal(pool[1], before)


@pytest.mark.parametrize("bad", ["row", "negative_row", "col", "shape"])
def test_out_of_range_slots_are_refused(bad):
    """The JAX program drops them (mode="drop"); the port never makes
    one and refuses one handed to it."""
    _, rows, cols, counts = _batch(4, 50)
    rows, cols = rows.copy(), cols.copy()
    if bad == "row":
        rows[3] = 4
    elif bad == "negative_row":
        rows[0] = -1
    elif bad == "col":
        cols[1, 7] = thh.DEFAULT_WIDTH
    else:
        cols = cols[:, :10]
    with pytest.raises(ValueError):
        thh.insert_batch(thh.init_pool(4, device=CPU), rows, cols, counts)


@pytest.mark.parametrize("row", [0, 2])
def test_fenced_reads_equal_jax(row):
    keys, rows, cols, counts = _batch(13, 600)
    tpool = thh.insert_batch(thh.init_pool(4, device=CPU), rows, cols, counts)
    jpool = _jfold(jhh.init_pool(4), rows, cols, counts)
    before = tpool.clone()
    asked = sorted(set(keys))[:40] + ["never-seen"]
    got = thh.read_query(tpool, row, asked)
    assert got.dtype == np.int64
    assert np.array_equal(got, jhh.read_query(jpool, row, asked))
    assert np.array_equal(thh.read_totals(tpool), jhh.read_totals(jpool))
    assert thh.read_query(tpool, row, []).shape == (0,)
    assert torch.equal(tpool, before)


# -- space-saving top-k (host code, copied) --------------------------------


def _offers(seed: int):
    rng = np.random.default_rng(seed)
    heavy = {f"hot{i}": 300 + 60 * i for i in range(4)}
    offers = [(k, int(rng.integers(1, 4))) for k, n in heavy.items()
              for _ in range(n // 2)]
    offers += [(f"cold{rng.integers(900)}", int(rng.integers(1, 3)))
               for _ in range(2500)]
    rng.shuffle(offers)
    return offers


@pytest.mark.parametrize("cap", [1, 2, 8, 64])
@pytest.mark.parametrize("seed", [0, 9])
def test_topk_equals_jax(cap, seed):
    js, ts = jhh.SpaceSavingTopK(cap), thh.SpaceSavingTopK(cap)
    for k, n in _offers(seed):
        js.offer(k, n)
        ts.offer(k, n)
    assert ts.items() == js.items()


@pytest.mark.parametrize("cap", [2, 8])
def test_topk_merge_equals_jax(cap):
    jsh = [jhh.SpaceSavingTopK(cap) for _ in range(2)]
    tsh = [thh.SpaceSavingTopK(cap) for _ in range(2)]
    for i, (k, n) in enumerate(_offers(21)):
        jsh[i % 2].offer(k, n)
        tsh[i % 2].offer(k, n)
    jm, tm = jhh.SpaceSavingTopK(cap), thh.SpaceSavingTopK(cap)
    for j, t in zip(jsh, tsh):
        jm.merge(j)
        tm.merge(t)
    assert tm.items() == jm.items()
    tb = thh.SpaceSavingTopK(cap)
    tb.merge(tsh[1])
    tb.merge(tsh[0])
    assert tb.items() == tm.items()


def test_topk_eviction_inherits_floor():
    s = thh.SpaceSavingTopK(2)
    s.offer("a", 10)
    s.offer("b", 4)
    s.offer("c", 1)
    assert s.items() == [("a", 10, 0), ("c", 5, 4)]
    s.merge(thh.SpaceSavingTopK(2))
    assert s.items() == [("a", 10, 0), ("c", 5, 4)]
    with pytest.raises(ValueError):
        thh.SpaceSavingTopK(0)
