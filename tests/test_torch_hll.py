"""The port's HyperLogLog programs against the JAX package's, on the CPU.

Same numpy-seeded inputs through veneur_tpu/ops/hll (and its NumPy twin
in ops/host_engine) and veneur_tpu_torch/ops/hll; every output bitwise
equal, at p = 4, 8, 14 and 18:

* ``split_hashes`` (NumPy in both);
* ``insert_batch`` against the reference's ``insert_batch`` (sorted
  run-end scatter) and ``insert_batch_scatter``: duplicate slots, rank-0
  padding, out-of-range rows dropped, negative rows wrapped once as the
  reference indexes; the kernel's packed records and the host inserter;
* ``merge``;
* ``estimate`` against the reference's ``estimate`` and
  ``host_engine.np_hll_estimate_exact`` in every regime: empty rows,
  linear counting, both sides of the raw <= 2.5m switch, raw, saturated
  rows, and int8 values outside the rank range;
* the estimator tables, the wire helpers, and a JAX-built pool carried
  across with ``pool_from_numpy`` and continued in both packages.

The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import exactnum as jexn
from veneur_tpu.ops import hll as jhll
from veneur_tpu.ops import host_engine as he
from veneur_tpu_torch.ops import exactnum as texn
from veneur_tpu_torch.ops import hll as thll
from veneur_tpu_torch.ops import hll_kernel

PRECISIONS = [4, 8, 14, 18]


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    assert a.tobytes() == b.tobytes(), what


def _hashes(n, seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 2**64, n, dtype=np.uint64)
    # all-zero and all-one tails, a power of two
    h[:4] = [0, 2**64 - 1, 1, 2**40]
    return h


def _updates(s, p, n, seed):
    """n updates into an s-row pool: random hashes, duplicate slots,
    rank-0 padding on the last row, rows past the pool (dropped)."""
    rng = np.random.default_rng(seed)
    idx, rank = jhll.split_hashes(_hashes(n, seed), p)
    rows = rng.integers(0, s - 1, n).astype(np.int32)
    dup = rng.integers(0, n, n // 4)
    rows[dup[: len(dup) // 2]] = rows[dup[len(dup) // 2:]]
    idx[dup[: len(dup) // 2]] = idx[dup[len(dup) // 2:]]
    pad = rng.random(n) < 0.1
    rows[pad], rank[pad] = s - 1, 0
    bad = rng.random(n) < 0.05
    rows[bad] = rng.choice([s, s + 3, s + 100], int(bad.sum()))
    return rows, idx.astype(np.int32), rank.astype(np.int8)


@pytest.mark.parametrize("p", PRECISIONS)
def test_split_hashes_bitwise(p):
    h = _hashes(5000, p)
    for a, b in zip(jhll.split_hashes(h, p), thll.split_hashes(h, p)):
        _same(a, b, f"p={p}")


def _start_pool(s, p, seed):
    rng = np.random.default_rng(seed)
    regs = np.zeros((s, 1 << p), np.int8)
    live = rng.random(regs.shape) < 0.2
    regs[live] = rng.integers(1, 64 - p + 2, int(live.sum()))
    return regs


@pytest.mark.parametrize("p", PRECISIONS)
def test_insert_batch_bitwise(p):
    s = 37
    start = _start_pool(s, p, p)
    rows, idx, rank = _updates(s, p, 6000, p + 1)
    j_sorted = np.asarray(jhll.insert_batch(
        jnp.asarray(start), jnp.asarray(rows), jnp.asarray(idx),
        jnp.asarray(rank)))
    j_scatter = np.asarray(jhll.insert_batch_scatter(
        jnp.asarray(start), jnp.asarray(rows), jnp.asarray(idx),
        jnp.asarray(rank)))
    j_np = he.np_hll_insert_batch(start, rows, idx, rank)
    pool = thll.pool_from_numpy(start, "cpu")
    before = thll.insert_batch.launches
    out = thll.insert_batch(pool, torch.from_numpy(rows),
                            torch.from_numpy(idx), torch.from_numpy(rank))
    assert out is pool  # updated in place
    assert thll.insert_batch.launches == before  # the CPU launches none
    for ref, what in ((j_sorted, "insert_batch"),
                      (j_scatter, "insert_batch_scatter"),
                      (j_np, "np_hll_insert_batch")):
        _same(ref, out.numpy(), f"p={p} {what}")
    assert (out.numpy() != start).any()


def test_negative_rows():
    """Negative rows: the reference's device programs index like numpy
    (a flat slot in [-S·m, -1] wraps once to slot + S·m) and raise the
    register there; the port does the same, bitwise, where the
    reference's NumPy twin host_engine.np_hll_insert_batch drops such
    updates (ROADMAP.md section 3). Slots below -S·m are dropped by
    both."""
    s, p = 6, 8
    m = 1 << p
    start = _start_pool(s, p, 3)
    start[s - 1, 5] = 0
    start[0, 3] = 0
    rows = np.array([-1, 2, -s, -s - 1, -3, -1], np.int32)
    idx = np.array([5, 7, 3, 9, m - 1, 5], np.int32)
    rank = np.array([9, 9, 4, 7, 11, 2], np.int8)
    args = [jnp.asarray(a) for a in (start, rows, idx, rank)]
    refs = [np.asarray(fn(*args)) for fn in (jhll.insert_batch,
                                             jhll.insert_batch_scatter)]
    port = thll.insert_batch(thll.pool_from_numpy(start, "cpu"),
                             torch.from_numpy(rows), torch.from_numpy(idx),
                             torch.from_numpy(rank)).numpy()
    for ref in refs:
        _same(ref, port, "negative rows")
    assert port[s - 1, 5] == 9 and port[0, 3] == 4 and port[2, 7] == 9
    assert (port != he.np_hll_insert_batch(start, rows, idx, rank)).any()


def test_packed_records_decode_to_the_updates():
    """pack_updates writes the int32[N, 2] records into the head of a
    larger buffer (a pinned buffer's numpy view on the card), records
    gives the same records as a tensor, and the
    kernel's decode of them (row, register in the low 24 bits, the rank
    in the high 8 as int8) gives back every update, negative ranks
    included; registers outside [0, 2^24) are refused; HostInserter on a
    CPU pool is the plain version."""
    s, p = 37, 14
    rows, idx, rank = _updates(s, p, 5000, 9)
    rank[:7] = [-128, -1, 0, 1, 50, 127, -65]
    host = np.full((8192, 2), -7, np.int32)
    assert thll.pack_updates(rows, idx, rank, host) == len(rows)
    assert (host[len(rows):] == -7).all()
    t = host[:len(rows)]
    hi = t[:, 1].view(np.uint32)
    _same(t[:, 0], rows, "rows")
    _same((hi & 0xFFFFFF).astype(np.int32), idx, "registers")
    _same((hi >> 24).astype(np.uint8).view(np.int8), rank, "ranks")
    _same(thll.records(torch.from_numpy(rows), torch.from_numpy(idx),
                       torch.from_numpy(rank), "cpu").numpy(), t, "records")
    for bad in (1 << 24, -1):
        with pytest.raises(ValueError, match="2\\^24"):
            thll.pack_updates(rows[:1], np.array([bad], np.int32),
                              rank[:1], host)
    start = _start_pool(s, p, 4)
    a = thll.HostInserter().insert(thll.pool_from_numpy(start, "cpu"),
                                   rows, idx, rank)
    b = thll.insert_batch_plain(thll.pool_from_numpy(start, "cpu"),
                                torch.from_numpy(rows), torch.from_numpy(idx),
                                torch.from_numpy(rank))
    _same(a.numpy(), b.numpy(), "HostInserter on the CPU")


@pytest.mark.parametrize("p", [4, 14])
def test_merge_bitwise(p):
    a, b = _start_pool(9, p, 1), _start_pool(9, p, 2)
    _same(jhll.merge(jnp.asarray(a), jnp.asarray(b)),
          thll.merge(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
          f"p={p}")


def _regime_rows(p, seed):
    """Rows in every estimator regime: empty; a few distinct values
    (linear counting); n distinct values swept across the raw <= 2.5m
    switch; many distinct values (raw); every register at the largest
    rank 64 - p + 1."""
    m = 1 << p
    rng = np.random.default_rng(seed)
    counts = [0, 1, 3, m // 4, m]
    counts += list(np.linspace(2.0 * m, 3.0 * m, 24).astype(int))
    counts += [8 * m, 40 * m]
    rows = []
    for n in counts:
        r = np.zeros(m, np.int8)
        if n:
            idx, rank = thll.split_hashes(
                rng.integers(0, 2**64, n, dtype=np.uint64), p)
            np.maximum.at(r, idx, rank)
        rows.append(r)
    rows.append(np.full(m, 64 - p + 1, np.int8))
    return np.stack(rows)


def _odd_rows(p, seed):
    """int8 values outside the rank range [0, 64]: the reference's gather
    wraps a negative index once and clamps."""
    m = 1 << p
    rng = np.random.default_rng(seed)
    odd = np.zeros((2, m), np.int8)
    odd[0] = rng.integers(-128, 128, m)
    odd[1, : m // 2] = rng.choice([-1, -64, -65, -66, 65, 127], m // 2)
    return odd


@pytest.mark.parametrize("p", PRECISIONS)
def test_estimate_bitwise_in_every_regime(p):
    regs = _regime_rows(p, p)
    m = 1 << p
    j = np.asarray(jhll.estimate(jnp.asarray(regs), precision=p))
    j_np = he.np_hll_estimate_exact(regs, p)
    before = thll.estimate.launches
    t = thll.estimate(torch.from_numpy(regs), p)
    assert thll.estimate.launches == before
    assert t.dtype == torch.float32 and t.shape == (len(regs),)
    _same(j, t.numpy(), f"p={p} estimate")
    _same(j_np, t.numpy(), f"p={p} np_hll_estimate_exact")
    # both sides of the switch were taken
    zeros = (regs == 0).sum(axis=1)
    inv = jexn.np_tsum(jexn.exp2_neg_table()[regs.astype(np.int32)
                                            .clip(0, 64)])
    raw = jexn.hll_alpha_m2(p) / inv
    lin = (raw <= np.float32(2.5 * m)) & (zeros > 0)
    assert lin.any() and (~lin & (zeros > 0)).any() and (zeros == 0).any()
    assert t[0] == 0  # the empty row
    odd = _odd_rows(p, p)
    _same(jhll.estimate(jnp.asarray(odd), precision=p),
          thll.estimate(torch.from_numpy(odd), p).numpy(), "odd values")


def test_plain_estimate_in_blocks_of_rows(monkeypatch):
    regs = _regime_rows(8, 3)
    whole = thll.estimate(torch.from_numpy(regs), 8)
    monkeypatch.setattr(thll, "_PLAIN_ESTIMATE_ELEMS", 3 * 256)
    _same(whole.numpy(), thll.estimate(torch.from_numpy(regs), 8).numpy(),
          "3 rows at a time")


@pytest.mark.parametrize("p", PRECISIONS)
def test_estimator_tables_bitwise(p):
    _same(jexn.hll_linear_table(p), texn.hll_linear_table(p), "linear")
    _same(jexn.hll_alpha_m2(p), texn.hll_alpha_m2(p), "alpha_m2")
    _same(jexn.exp2_neg_table(), texn.exp2_neg_table(), "exp2(-r)")


def test_registers_wire_round_trip():
    row = _start_pool(1, 14, 5)[0]
    data = thll.registers_to_bytes(row)
    assert data == jhll.registers_to_bytes(row)
    _same(thll.registers_from_bytes(data), jhll.registers_from_bytes(data))
    with pytest.raises(ValueError):
        thll.registers_from_bytes(data[:-1])


@pytest.mark.parametrize("p", [8, 14])
def test_pool_carried_across_and_continued(p):
    """A register pool built by the JAX package, carried across and
    continued in both packages with the same next batch."""
    s = 20
    rows, idx, rank = _updates(s, p, 3000, 7)
    jpool = jhll.insert_batch(jhll.init_pool(s, p), jnp.asarray(rows),
                              jnp.asarray(idx), jnp.asarray(rank))
    tpool = thll.pool_from_numpy(np.asarray(jpool), "cpu")
    rows, idx, rank = _updates(s, p, 3000, 8)
    jpool = jhll.insert_batch(jpool, jnp.asarray(rows), jnp.asarray(idx),
                              jnp.asarray(rank))
    thll.insert_batch(tpool, torch.from_numpy(rows), torch.from_numpy(idx),
                      torch.from_numpy(rank))
    _same(np.asarray(jpool), tpool.numpy(), "continued pool")
    _same(jhll.estimate(jpool, precision=p), thll.estimate(tpool, p).numpy(),
          "its estimates")


def test_init_pool_and_device():
    pool = thll.init_pool(5, 8, device="cpu")
    _same(np.asarray(jhll.init_pool(5, 8)), pool.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            thll.init_pool(5, 8)


def test_kernel_launchers_take_cuda_tensors_only():
    pool = thll.init_pool(4, 8, device="cpu")
    recs = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        hll_kernel.insert(pool, recs)
    with pytest.raises(ValueError, match="cuda"):
        hll_kernel.estimate(pool, 8)


_PTXAS = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117hll_insert_kernelILi1EEEvPjPK4int2xxi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117hll_insert_kernelILi1EEEvPjPK4int2xxi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 18 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117hll_insert_kernelILi4EEEvPjPK4int2xxi' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117hll_insert_kernelILi4EEEvPjPK4int2xxi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 17 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115hll_noop_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115hll_noop_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 4 registers, 352 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119hll_estimate_kernelILi256EEEvPKhPKfS4_Pfiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119hll_estimate_kernelILi256EEEvPKhPKfS4_Pfiiff
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 1088 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119hll_estimate_kernelILi1EEEvPKhPKfS4_Pfiiff' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119hll_estimate_kernelILi1EEEvPKhPKfS4_Pfiiff
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 32 registers, 1088 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_parses_per_kernel():
    rep = hll_kernel.parse_ptxas(_PTXAS)
    assert rep == {
        "hll_insert": {"registers": 18, "spill_stores": 0, "spill_loads": 0,
                       "local_bytes": 0, "static_smem_bytes": 0},
        "hll_estimate": {"registers": 40, "spill_stores": 4,
                         "spill_loads": 4, "local_bytes": 8,
                         "static_smem_bytes": 1088}}
