"""The t-digest folds (K2) of the PyTorch port on the CPU.

* The dispatchers ``compress_rows`` / ``_compress_rows`` and
  ``add_batch`` take the plain version on a CPU tensor and are bitwise
  veneur_tpu/ops/tdigest.py's at every width their callers use (M = C +
  64, the staged fold; 2C, the pool merge and a 2-host mesh; C + 256, an
  import; 4C, a 4-host merge) and at K = 64 and 1,024 rows by N = 256 and
  65,536 samples, and on edge rows: +0.0 and -0.0 means in both orders,
  f32 denormal means and weights, +-inf means, a row of one centroid, an
  all-empty row, ties, a row of -0.0 means (sums that stay -0.0 unless a
  pad lane adds +0.0).
* What either fold refuses, it refuses with ValueError on the CPU too;
  the kernel wrappers refuse a CPU tensor.
* The kernel source itself, csrc/tdigest.cu, built with g++ under its
  TD_EMULATE hooks (every block run in turn, its SIMT sections stepped
  thread by thread, shuffles and ballots lane-stepped copies between the
  threads' values, MXCSR set to flush to zero and denormals-are-zero, as
  -ftz=true sets the card), launched through ops/tdigest_kernel's own
  launch helpers: bitwise the plain versions on the same inputs, NaN
  means and values, a warp a row, a block of up to 16 warps a row and
  the global scratch path of rows past it, both branches of every
  sorted-run shortcut, ragged N, hot rows, a batch all in one row (the
  sort's merge passes) and signed-zero min and max included. The card's
  own run is tests/test_torch_cuda.py's.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core import worker as jw
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import nvcc
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.ops import tdigest_kernel as tk

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import port_probe_tdigest as probe_td  # noqa: E402

C = 128
TINY = np.finfo(np.float32).tiny


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a = np.ascontiguousarray(a, np.float32)
    return np.where(np.isnan(a), np.uint32(0x7FC00000), a.view(np.uint32))


def _assert_bitwise(a, b, what=""):
    ba, bb = _bits(a), _bits(b)
    assert ba.shape == bb.shape, (what, ba.shape, bb.shape)
    bad = np.argwhere(ba != bb)
    assert not len(bad), (what, bad[:5].tolist())


def _edge_candidates(m: int, seed: int, nan: bool = False):
    """[24, m] candidate rows: the edge rows of the module docstring, then
    random fill (ties, weights, empty slots). ``nan`` adds NaN means."""
    rng = np.random.default_rng(seed)
    s = 24
    means = rng.normal(50.0, 20.0, (s, m)).astype(np.float32)
    w = rng.lognormal(0.0, 1.0, (s, m)).astype(np.float32)
    w[rng.random((s, m)) < 0.3] = 0.0
    half = m // 2
    w[0] = 0.0                                          # empty
    w[1] = 0.0
    w[1, 3] = 2.5                                       # one centroid
    means[2, :half] = np.where(np.arange(half) % 2 == 0, 0.0, -0.0)
    means[2, half:] = np.where(np.arange(m - half) % 2 == 0, -0.0, 0.0)
    means[3] = rng.integers(-2**20, 2**20, m) * np.float32(1e-45)
    w[4] = rng.integers(1, 2**20, m) * np.float32(1e-45)
    w[5, ::2] = -0.0
    means[6, ::3] = np.inf
    means[6, 1::5] = -np.inf
    means[7] = np.round(means[7] / 10.0) * 10.0         # ties
    means[8, : m // 3] = 7.0                            # one long tie run
    means[9] = (rng.choice([-1.0, 1.0], m) * TINY
                * (1.0 + rng.random(m))).astype(np.float32)
    w[10] = 1.0
    means[11] = np.arange(m, 0, -1, dtype=np.float32)
    means[14] = -0.0                                    # -0.0 sums
    if nan:
        means[12, ::4] = np.nan
        means[12, 1::9] = -np.nan
        w[13, ::5] = np.nan
    means[w == 0] = np.where(rng.random(int((w == 0).sum())) < 0.5, np.inf,
                             rng.normal(0.0, 1.0, int((w == 0).sum())))
    return means.astype(np.float32), w.astype(np.float32)


def _batch(k: int, n: int, seed: int, edge: bool = False, nan: bool = False):
    """A spill batch over k rows: a tenth zero-weight padding; ``edge``:
    +-0.0 values, denormal values and weights, +-inf values, ties, a hot
    row and a row of one sample; ``nan``: NaN values too."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, k, n).astype(np.int32)
    vals = rng.gamma(2.0, 30.0, n).astype(np.float32)
    wts = rng.choice([0.5, 1.0, 2.0, 10.0], n).astype(np.float32)
    pad = rng.random(n) < 0.1
    rows[pad] = k - 1
    wts[pad] = 0.0
    if edge:
        r = rows % 16
        vals[r == 0] = np.where(np.arange(int((r == 0).sum())) % 2 == 0,
                                0.0, -0.0)
        vals[r == 1] = rng.integers(-2**20, 2**20, int((r == 1).sum())) \
            * np.float32(1e-45)
        wts[r == 2] = rng.integers(1, 2**20, int((r == 2).sum())) \
            * np.float32(1e-45)
        vals[(r == 3) & (np.arange(n) % 3 == 0)] = np.inf
        vals[(r == 4) & (np.arange(n) % 3 == 0)] = -np.inf
        vals[r == 5] = np.float32(TINY * 1.5)
        vals[r == 6] = np.round(vals[r == 6] / 10.0) * 10.0
        vals[r == 11] = -0.0
        rows[: n // 4] = min(7, k - 1)                  # a hot row
        rows[rows == 8] = 9
        rows[0], wts[0] = 8 % k, 1.0                    # one sample
        if nan:
            vals[(r == 10) & (np.arange(n) % 4 == 0)] = np.nan
    return rows, vals.astype(np.float32), wts.astype(np.float32)


# ---------------------------------------------------------------------------
# the dispatchers on the CPU against the JAX package


@pytest.mark.parametrize("m", [C + 64, 2 * C, C + 256, 4 * C])
def test_compress_dispatcher_bitwise_reference(m):
    means, w = _edge_candidates(m, m)
    jm, jw = jtd.compress_rows(jnp.asarray(means), jnp.asarray(w),
                               compression=100.0, capacity=C)
    before = ttd.compress_rows.launches
    for fn in (ttd.compress_rows, ttd._compress_rows):
        tm, tw = fn(torch.from_numpy(means), torch.from_numpy(w), 100.0, C)
        _assert_bitwise(jm, tm, f"means m={m}")
        _assert_bitwise(jw, tw, f"weights m={m}")
    assert ttd.compress_rows.launches == before  # the CPU launches nothing


@pytest.mark.parametrize("k,n", [(64, 256), (64, 65_536), (1_024, 256),
                                 (1_024, 65_536)])
def test_add_batch_dispatcher_bitwise_reference(k, n):
    rows, vals, wts = _batch(k, n, k + n)
    jpool = tuple(jtd.init_pool(k, C))
    tpool = tuple(ttd.init_pool(k, C, device="cpu"))
    before = ttd.add_batch.launches
    for rnd in range(2):
        jo = jtd.add_batch(*jpool, jnp.asarray(rows),
                           jnp.asarray(vals + rnd), jnp.asarray(wts))
        to = ttd.add_batch(*tpool, torch.from_numpy(rows),
                           torch.from_numpy(vals + rnd),
                           torch.from_numpy(wts))
        for i, name in enumerate(("means", "weights", "min", "max",
                                  "recip")):
            _assert_bitwise(jo[i], to[i], f"round {rnd} {name}")
        for f in jtd.BatchStats._fields:
            _assert_bitwise(getattr(jo[5], f), getattr(to[5], f), f)
        jpool, tpool = tuple(jo[:5]), tuple(to[:5])
    assert ttd.add_batch.launches == before


def test_add_batch_edge_batch_bitwise_reference():
    k = 16
    rows, vals, wts = _batch(k, 4_096, 5, edge=True)
    means, w = _edge_candidates(C, 9)
    dmin = np.where(w.sum(1) > 0, -1.0, np.inf).astype(np.float32)
    dmax = np.where(w.sum(1) > 0, 1e3, -np.inf).astype(np.float32)
    dmin[3], dmax[3] = -0.0, 0.0
    recip = np.zeros(24, np.float32)
    pool = tuple(a[:k] for a in (means, w, dmin, dmax, recip))
    jo = jtd.add_batch(*(jnp.asarray(a) for a in pool), jnp.asarray(rows),
                       jnp.asarray(vals), jnp.asarray(wts))
    to = ttd.add_batch(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in pool), torch.from_numpy(rows),
                       torch.from_numpy(vals), torch.from_numpy(wts))
    for i in range(5):
        _assert_bitwise(jo[i], to[i], f"field {i}")
    for f in jtd.BatchStats._fields:
        _assert_bitwise(getattr(jo[5], f), getattr(to[5], f), f)


def test_merge_pools_and_merge_many_take_the_dispatcher(monkeypatch):
    """merge_pools and merge_many compress through the dispatcher (so a
    CUDA pool launches K2a): on the CPU it hands them the plain version."""
    seen = []
    real = ttd._compress_rows_plain

    def spy(means, weights, compression, capacity):
        seen.append(tuple(means.shape))
        return real(means, weights, compression, capacity)

    monkeypatch.setattr(ttd, "_compress_rows_plain", spy)
    a = ttd.init_pool(8, C, device="cpu")
    ttd.merge_pools(a, a)
    stacked = ttd.TDigestPool(*(torch.stack([t, t, t]) for t in a))
    ttd.merge_many(stacked)
    assert seen == [(8, 2 * C), (8, 3 * C)]


# ---------------------------------------------------------------------------
# what the folds refuse


def _pool(k=4, c=C):
    return tuple(ttd.init_pool(k, c, device="cpu"))


@pytest.mark.parametrize("case", [
    "m_below_capacity", "three_dims", "shapes_differ", "f64",
    "not_contiguous", "capacity_zero"])
def test_compress_refuses(case):
    m = torch.zeros((4, 2 * C))
    w = torch.zeros((4, 2 * C))
    cap = C
    if case == "m_below_capacity":
        m, w = m[:, :C - 1].contiguous(), w[:, :C - 1].contiguous()
    elif case == "three_dims":
        m, w = m[None], w[None]
    elif case == "shapes_differ":
        w = w[:, :-1].contiguous()
    elif case == "f64":
        m, w = m.double(), w.double()
    elif case == "not_contiguous":
        m, w = m.t(), w.t()
    else:
        cap = 0
    with pytest.raises(ValueError):
        ttd.compress_rows(m, w, 100.0, cap)


@pytest.mark.parametrize("case", [
    "no_samples", "capacity_too_wide", "dmin_shape", "rows_float",
    "values_shape", "f64_weights", "rows_2d"])
def test_add_batch_refuses(case):
    pool = list(_pool())
    rows = torch.zeros(8, dtype=torch.int32)
    vals = torch.ones(8)
    wts = torch.ones(8)
    if case == "no_samples":
        rows, vals, wts = rows[:0], vals[:0], wts[:0]
    elif case == "capacity_too_wide":
        pool = list(_pool(4, tk.MAX_ADD_CAPACITY + 128))
    elif case == "dmin_shape":
        pool[2] = pool[2][:3]
    elif case == "rows_float":
        rows = rows.float()
    elif case == "values_shape":
        vals = vals[:7]
    elif case == "f64_weights":
        wts = wts.double()
    else:
        rows = rows.reshape(2, 4)
    with pytest.raises(ValueError):
        ttd.add_batch(*pool, rows, vals, wts)


def test_kernel_wrappers_refuse_a_cpu_tensor():
    m = torch.zeros((2, 2 * C))
    with pytest.raises(ValueError):
        tk.compress(m, m, C, torch.zeros(100))
    pool = _pool(2)
    one = torch.ones(4)
    with pytest.raises(ValueError):
        tk.add_batch(*pool, torch.zeros(4, dtype=torch.int64), one, one,
                     torch.zeros(100))


# ---------------------------------------------------------------------------
# the kernel source under emulation against the plain versions

_SHIM = r"""
#include <stdint.h>
#include <string.h>
#include <math.h>
#include <stddef.h>
#include <vector>
#include <xmmintrin.h>
struct TdDim3 { unsigned x, y, z; };
static TdDim3 blockIdx, blockDim, gridDim;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define TD_EMULATE 1
static unsigned char* td_emu_smem;
#define TD_DYNAMIC_SMEM(name) unsigned char* name = td_emu_smem
typedef int cudaError_t;
typedef void* cudaStream_t;
#define cudaSuccess 0
static int cudaGetLastError() { return 0; }
static inline float __uint_as_float(uint32_t u) {
  float f; memcpy(&f, &u, 4); return f; }
static inline uint32_t __float_as_uint(float f) {
  uint32_t u; memcpy(&u, &f, 4); return u; }
// every block in turn, its threads stepped by the source's SIMT layer,
// with flush to zero and denormals-are-zero (the card's -ftz=true)
template <class F> static void td_emu_launch(long long grid, int block,
                                             size_t smem, F f) {
  std::vector<unsigned char> buf(smem + 16);
  td_emu_smem = (unsigned char*)(((uintptr_t)buf.data() + 15)
                                 & ~(uintptr_t)15);
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040);
  blockDim = {(unsigned)block, 1, 1};
  gridDim = {(unsigned)grid, 1, 1};
  for (long long b = 0; b < grid; ++b) { blockIdx.x = (unsigned)b; f(); }
  _mm_setcsr(csr);
}
#define TD_LAUNCH(kernel, grid, block, smem, stream, ...) \
  td_emu_launch((grid), (block), (smem), [&] { kernel(__VA_ARGS__); })
#include "tdigest.cu"
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/tdigest.cu built with g++ under the shim, bound as the card's
    library is (tdigest_kernel.bind)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the kernel source's emulation (as native.py)"
    d = tmp_path_factory.mktemp("tdigest_emu")
    shutil.copy(nvcc.CSRC / "tdigest.cu", d / "tdigest.cu")
    (d / "shim.cc").write_text(_SHIM)
    lib = d / "libtdigest_emu.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-fno-fast-math",
         "-fPIC", "-shared", "-o", str(lib), str(d / "shim.cc")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return tk.bind(ctypes.CDLL(str(lib)))


def _table():
    return exn._table(100.0, torch.device("cpu"))


@pytest.mark.parametrize("m", [C, C + 64, 2 * C, C + 256, 4 * C, 1_152,
                               4_000, 4_100])
def test_emulated_compress_bitwise_plain(emulated, m):
    """A warp a row up to 256 candidates, a block of up to 16 warps a row
    up to 4,096 (4,000: 16 warps), the global slab past that (4,100)."""
    means, w = _edge_candidates(m, 100 + m, nan=True)
    mt, wt = torch.from_numpy(means), torch.from_numpy(w)
    pm, pw = ttd._compress_rows_plain(mt, wt, 100.0, C)
    km, kw = tk.run_compress(emulated, mt, wt, C, _table(), None)
    _assert_bitwise(pm, km, "means")
    _assert_bitwise(pw, kw, "weights")


def test_emulated_compress_scratch_path(emulated):
    """Rows past a block's shared memory work in a global slab: the
    launcher's scratch argument, the same routine."""
    m, s = 600, 24
    means, w = _edge_candidates(m, 3, nan=True)
    mt, wt = torch.from_numpy(means), torch.from_numpy(w)
    pm, pw = ttd._compress_rows_plain(mt, wt, 100.0, C)
    row_bytes = emulated.td_compress_row_bytes(m)
    assert row_bytes <= emulated.td_compress_smem_limit()  # forced here
    scratch = torch.empty(s * row_bytes, dtype=torch.uint8)
    om, ow = torch.empty(s, C), torch.empty(s, C)
    tbl = _table()
    rc = emulated.td_compress_launch(
        mt.data_ptr(), wt.data_ptr(), s, m, C, tbl.data_ptr(), tbl.numel(),
        scratch.data_ptr(), om.data_ptr(), ow.data_ptr(), None)
    assert rc == 0
    _assert_bitwise(pm, om, "means")
    _assert_bitwise(pw, ow, "weights")
    assert emulated.td_compress_row_bytes(8_192) \
        > emulated.td_compress_smem_limit()


@pytest.mark.parametrize("k,n,edge", [
    (64, 256, False), (1_024, 65_536, False), (16, 300, False),
    (5, 1_000, False), (1, 70_000, False), (16, 4_096, True),
    (3, 129, True)])
def test_emulated_add_batch_bitwise_plain(emulated, k, n, edge):
    rows, vals, wts = _batch(k, n, 7 * k + n, edge=edge, nan=edge)
    pool = tuple(ttd.init_pool(k, C, device="cpu"))
    names = ("means", "weights", "min", "max", "recip") + tuple(
        f"stats.{f}" for f in ttd.BatchStats._fields)
    for rnd in range(2):
        args = (torch.from_numpy(rows), torch.from_numpy(vals + rnd),
                torch.from_numpy(wts))
        plain = ttd.add_batch_plain(*pool, *args)
        got = tk.run_add_batch(emulated, *pool, *args, _table(), None)
        for name, a, b in zip(names, list(plain[:5]) + list(plain[5]), got):
            _assert_bitwise(a, b, f"round {rnd} {name}")
        pool = tuple(plain[:5])


@pytest.mark.parametrize("s", [101, 32_771])
def test_emulated_compress_many_rows(emulated, s):
    """More rows than a block's warps take, a ragged last block: one row a
    warp under 32,768 rows, else 4 a warp, each loaded ahead into the
    warp's other buffer."""
    rng = np.random.default_rng(11)
    m = C + 64
    means = rng.normal(0.0, 10.0, (s, m)).astype(np.float32)
    w = rng.lognormal(0.0, 1.0, (s, m)).astype(np.float32)
    w[rng.random((s, m)) < 0.4] = 0.0
    mt, wt = torch.from_numpy(means), torch.from_numpy(w)
    pm, pw = ttd._compress_rows_plain(mt, wt, 100.0, C)
    km, kw = tk.run_compress(emulated, mt, wt, C, _table(), None)
    _assert_bitwise(pm, km, "means")
    _assert_bitwise(pw, kw, "weights")


def _emulated_add_rounds(emulated, pool, rows, vals, wts, rounds=2):
    names = ("means", "weights", "min", "max", "recip") + tuple(
        f"stats.{f}" for f in ttd.BatchStats._fields)
    for rnd in range(rounds):
        args = (torch.from_numpy(rows), torch.from_numpy(vals + rnd),
                torch.from_numpy(wts))
        plain = ttd.add_batch_plain(*pool, *args)
        got = tk.run_add_batch(emulated, *pool, *args, _table(), None)
        for name, a, b in zip(names, list(plain[:5]) + list(plain[5]), got):
            _assert_bitwise(a, b, f"round {rnd} {name}")
            if name in ("min", "max"):  # the sign of a zero, NaN's too
                assert np.array_equal(np.signbit(a.numpy()),
                                      np.signbit(b.numpy())), name
        pool = tuple(plain[:5])


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_emulated_add_batch_one_row(emulated, dtype):
    """Every sample in one row: the sort's merge passes (20,000 samples,
    three passes over 4,096-sample tiles) and the scans' global steps
    carry the whole batch; padding samples keep their own weights."""
    rng = np.random.default_rng(3)
    k, n = 4, 20_000
    rows = np.full(n, 2, dtype)
    vals = rng.gamma(2.0, 30.0, n).astype(np.float32)
    vals[::7] = np.round(vals[::7])                     # ties
    wts = rng.choice([0.5, 1.0, 2.0], n).astype(np.float32)
    wts[rng.random(n) < 0.05] = 0.0
    wts[5] = -1.0                                       # padding, negative
    pool = tuple(ttd.init_pool(k, C, device="cpu"))
    _emulated_add_rounds(emulated, pool, rows, vals, wts)


def test_emulated_add_batch_signed_zero_min_max(emulated):
    """The digest min and max of +0.0 and -0.0 (and NaN) in XLA's order:
    the pool's scalars and the batch's values drawn from both zeros."""
    rng = np.random.default_rng(4)
    k, n = 33, 600
    rows = rng.integers(0, k, n).astype(np.int32)
    zeros = np.array([0.0, -0.0], np.float32)
    vals = rng.choice(zeros, n).astype(np.float32)
    vals[rows == 5] = np.nan
    wts = np.ones(n, np.float32)
    means, w, dmin, dmax, recip = (t.clone() for t in ttd.init_pool(
        k, C, device="cpu"))
    dmin[:] = torch.from_numpy(rng.choice(np.array([0.0, -0.0, np.inf,
                                                    np.nan], np.float32), k))
    dmax[:] = torch.from_numpy(rng.choice(np.array([0.0, -0.0, -np.inf,
                                                    np.nan], np.float32), k))
    _emulated_add_rounds(emulated, (means, w, dmin, dmax, recip), rows, vals,
                         wts)


def test_emulated_add_batch_wide_rows(emulated):
    """C = 256: the batch digest and the row beside it, 512 candidates,
    compressed by a block of warps a row."""
    k, n = 6, 3_000
    rows, vals, wts = _batch(k, n, 8, edge=True, nan=True)
    pool = tuple(ttd.init_pool(k, 2 * C, device="cpu"))
    _emulated_add_rounds(emulated, pool, rows, vals, wts)


@pytest.mark.parametrize("m,c", [(2 * C, C), (4 * C, C), (9 * C, C),
                                 (C + 64, C), (300, 100), (3 * 96, 96)])
def test_emulated_compress_sorted_runs(emulated, m, c):
    """Candidates that are sorted runs, as the merges give them: digest
    rows of c slots side by side (the network starts at the merges of 2c
    keys where c is a power of two), [0, c) and a sorted rest (the last
    merge alone), and, in half the rows, one slot out of order (the whole
    network); ties and +inf padding inside the runs."""
    rng = np.random.default_rng(m + c)
    s = 16
    means = np.round(rng.normal(0.0, 5.0, (s, m)), 1).astype(np.float32)
    w = rng.lognormal(0.0, 1.0, (s, m)).astype(np.float32)
    w[rng.random((s, m)) < 0.2] = 0.0
    means[w == 0] = np.inf
    for r0 in range(0, m, c):
        means[:, r0:r0 + c] = np.sort(means[:, r0:r0 + c], axis=1)
    w[means == np.inf] = 0.0
    if m % c:
        means[:, c:] = np.sort(means[:, c:], axis=1)
    means[::2, c + 1], means[::2, c + 2] = means[::2, c + 2] + 1.0, -7.0
    mt, wt = torch.from_numpy(means), torch.from_numpy(w)
    pm, pw = ttd._compress_rows_plain(mt, wt, 100.0, c)
    km, kw = tk.run_compress(emulated, mt, wt, c, _table(), None)
    _assert_bitwise(pm, km, "means")
    _assert_bitwise(pw, kw, "weights")


# ---------------------------------------------------------------------------
# K3, the staged fold, under emulation against the plain chain

F7 = np.float32


def _fold_fields(rng, s: int) -> list:
    """The worker's 14 pool fields over s rows: compressed digest rows
    of a few centroids (some rows empty), the scalars drawn from normal
    values, +-0.0, +-inf, NaN and denormals (the sums' compensations
    among them)."""
    means = np.full((s, C), np.inf, F7)
    w = np.zeros((s, C), F7)
    k = rng.integers(0, 6, s)
    for r in range(s):
        means[r, :k[r]] = np.sort(rng.normal(10.0, 5.0, k[r]))
        w[r, :k[r]] = rng.choice([1.0, 2.0], k[r])
    pool = np.array([-1.0, 1.0, 0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40,
                     -2e-40, 3e-38, 1.5e-38, -1.3e-38], F7)
    return [means, w] + [rng.choice(pool, s).astype(F7) for _ in range(12)]


def _staged(rng, s: int, b: int, edge: bool):
    """A dense staged plane [s, b] as the host stages it (filled slots
    first, counts per row, empty slots 0.0 and weight 0.0) and its
    counts. With ``edge``, rows (i % 12) of +-0.0 samples, denormal
    samples, denormal weights, +-inf, NaN, samples whose w/v or v*w is
    denormal, an empty row, a full row and a row of one sample."""
    counts = rng.integers(0, b + 1, s).astype(np.int32)
    v = rng.normal(20.0, 15.0, (s, b)).astype(F7)
    w = rng.choice(np.array([1.0, 0.5, 2.0, 4.0], F7), (s, b))
    if edge:
        kind = np.arange(s) % 12
        n = (s, b)
        v = np.where((kind == 0)[:, None], rng.choice(
            np.array([0.0, -0.0], F7), n), v)
        v = np.where((kind == 1)[:, None], (rng.integers(
            -2**20, 2**20, n) * F7(1e-45)).astype(F7), v)
        w = np.where((kind == 2)[:, None], (rng.integers(
            1, 2**20, n) * F7(1e-45)).astype(F7), w)
        v = np.where((kind == 3)[:, None], rng.choice(
            np.array([np.inf, -np.inf, 3.0], F7), n), v)
        v = np.where((kind == 4)[:, None], rng.choice(
            np.array([np.nan, -np.nan, 1.0], F7), n), v)
        v = np.where((kind == 5)[:, None], rng.choice(
            np.array([1e38, -3e38, 1e-20], F7), n), v)
        w = np.where((kind == 5)[:, None], rng.choice(
            np.array([1.0, 1e-19], F7), n), w)
        w = np.where((kind == 6)[:, None], rng.choice(
            np.array([0.0, -1.0, np.nan, 1.0], F7), n), w)
        counts[kind == 7] = 0
        counts[kind == 8] = b
        counts[kind == 9] = 1
    valid = np.arange(b)[None, :] < counts[:, None]
    v = np.where(valid, v, F7(0.0)).astype(F7)
    w = np.where(valid, w, F7(0.0)).astype(F7)
    return v, w, counts


def _flat(v, w, counts, unit: bool):
    """The host's compaction of a staged plane: flat samples padded to
    the worker's pow2 length (at least 1,024), weights None if unit."""
    mask = np.arange(v.shape[1])[None, :] < counts[:, None]
    n_pad = max(1024, 1 << max(int(mask.sum()) - 1, 0).bit_length())
    fv = np.zeros(n_pad, F7)
    fv[:mask.sum()] = v[mask]
    fw = None
    if not unit:
        fw = np.zeros(n_pad, F7)
        fw[:mask.sum()] = w[mask]
    return fv, fw


def _emulated_fold(emulated, fields, stage, paths=None):
    """K3 under emulation, through the launcher wrapper of the card's;
    ``paths`` (int32 [4]) tallies the one-warp rows by path."""
    s = fields[0].shape[0]
    if isinstance(stage, tw.FlatStage):
        c64 = stage.counts.astype(np.int64)
        off = np.zeros(s, np.int32)
        np.cumsum(c64[:-1], out=off[1:], dtype=np.int64)
        return tk.run_fold_staged(
            emulated, fields, stage.vals, stage.wts, torch.from_numpy(off),
            int(c64.sum()), stage.depth, _table(), None, paths)
    return tk.run_fold_staged(emulated, fields, stage.vals, stage.wts, None,
                              stage.vals.shape[0], stage.vals.shape[1],
                              _table(), None, paths)


FOLD_NAMES = ("means", "weights", "dmin", "dmax", "drecip", "drecip_c",
              "lmin", "lmax", "lsum", "lsum_c", "lweight", "lweight_c",
              "lrecip", "lrecip_c")


@pytest.mark.parametrize("form", ["dense", "flat_unit", "flat_weighted",
                                  "dense_short"])
@pytest.mark.parametrize("s,b,edge", [(37, 64, True), (101, 40, True),
                                      (24, 64, False), (13, 1, True),
                                      (50, 33, False)])
def test_emulated_fold_staged_bitwise_plain(emulated, form, s, b, edge):
    """td_fold_warps (C + B <= 256) against the plain chain on the CPU:
    dense and flat planes, unit and weighted, a mirror plane shorter
    than the pool (its rows past the plane empty), ragged S, depths 64,
    40, 33 and 1, edge rows; all 14 fields bitwise."""
    rng = np.random.default_rng(31 * s + b + len(form))
    fields = [torch.from_numpy(a) for a in _fold_fields(rng, s)]
    v, w, counts = _staged(rng, s, b, edge)
    if form.startswith("flat"):
        unit = form == "flat_unit"
        if unit:
            w = (np.arange(b)[None, :] < counts[:, None]).astype(F7)
        fv, fw = _flat(v, w, counts, unit)
        stage = tw.FlatStage(torch.from_numpy(fv),
                             None if unit else torch.from_numpy(fw), counts,
                             b)
    else:
        r = s if form == "dense" else s - s // 3
        stage = tw.DenseStage(torch.from_numpy(v[:r].copy()),
                              torch.from_numpy(w[:r].copy()))
    plain = tw.fold_staged(fields, stage)
    got = _emulated_fold(emulated, fields, stage)
    for name, a, g in zip(FOLD_NAMES, plain, got):
        _assert_bitwise(a, g, f"{form} [{s}, {b}] {name}")


@pytest.mark.parametrize("form", ["dense", "flat_weighted"])
@pytest.mark.parametrize("b", [200, 1_100, 4_000])
def test_emulated_fold_staged_wide_bitwise_plain(emulated, form, b):
    """C + B past a warp's 256 candidates: td_stage_rows writes the
    candidates and the scalars, then K2a compresses them: a block of 2
    or 8 warps a row (B = 200, 1,100), the global slab past 4,096
    candidates (B = 4,000)."""
    rng = np.random.default_rng(b)
    s = 19
    fields = [torch.from_numpy(a) for a in _fold_fields(rng, s)]
    v, w, counts = _staged(rng, s, b, True)
    if form == "dense":
        stage = tw.DenseStage(torch.from_numpy(v), torch.from_numpy(w))
    else:
        fv, fw = _flat(v, w, counts, False)
        stage = tw.FlatStage(torch.from_numpy(fv), torch.from_numpy(fw),
                             counts, b)
    plain = tw.fold_staged(fields, stage)
    got = _emulated_fold(emulated, fields, stage)
    for name, a, g in zip(FOLD_NAMES, plain, got):
        _assert_bitwise(a, g, f"{form} [{s}, {b}] {name}")


def test_emulated_fold_staged_many_rows(emulated):
    """Past 32,768 rows a warp folds 4 consecutive rows, each loaded
    ahead into its other buffer while the one before is folded; a ragged
    last block."""
    rng = np.random.default_rng(5)
    s, b = 32_771, 64
    fields = _fold_fields(rng, 64)
    fields = [torch.from_numpy(np.resize(a, (s,) + a.shape[1:]))
              for a in fields]
    v, w, counts = _staged(rng, s, b, False)
    fv, _ = _flat(v, w, counts, True)
    stage = tw.FlatStage(torch.from_numpy(fv), None, counts, b)
    plain = tw.fold_staged(fields, stage)
    got = _emulated_fold(emulated, fields, stage)
    for name, a, g in zip(FOLD_NAMES, plain, got):
        _assert_bitwise(a, g, f"{name}")


def _rank_stage(form: str, v, w, counts):
    """The plane of a rank case as ``form`` takes it, and the dense
    weights the kernel reads (a flat unit plane's 1.0 below the count)."""
    b = v.shape[1]
    if form == "dense":
        return tw.DenseStage(torch.from_numpy(v), torch.from_numpy(w)), w
    unit = form == "flat_unit"
    if unit:
        w = (np.arange(b)[None, :] < counts[:, None]).astype(F7)
    fv, fw = _flat(v, w, counts, unit)
    return tw.FlatStage(torch.from_numpy(fv),
                        None if unit else torch.from_numpy(fw), counts,
                        b), w


@pytest.mark.parametrize("b", probe_td.RANK_DEPTHS)
@pytest.mark.parametrize("kind", probe_td.RANK_KINDS)
def test_emulated_fold_rank_path_bitwise_plain(emulated, kind, b):
    """K3's rank path (the pool row sorted, the staged tail placed by
    rank on 32-bit keys) on probe_td.rank_case's edge rows: samples equal
    in order key to a centroid (+0.0 against -0.0), runs of equal
    samples, NaN and +-inf samples (a +inf sample beside zero-weight
    slots), denormal samples and weights, empty rows and rows of one
    live centroid, full rows; and rows whose pool part is unsorted (the
    whole network). Each of the dense, flat unit and flat weighted
    planes: the JAX package's fold, the port's plain chain and the
    emulated kernel bitwise in all 14 fields, and the kernel's tally of
    its rows' paths equal to the host's prediction (probe_td.row_paths).
    The case's path: B = 1 the sorted runs (a tail of one is sorted),
    "unsorted" the network, B = 128 the tail sort (past the rank path's
    64), every other case the rank path."""
    fields_np, v, w, counts = probe_td.rank_case(kind, b)
    fields = [torch.from_numpy(a) for a in fields_np]
    for form in ("dense", "flat_unit", "flat_weighted"):
        stage, wd = _rank_stage(form, v, w, counts)
        want = np.bincount(probe_td.row_paths(fields_np[0], fields_np[1],
                                              v, wd), minlength=len(tk.PATHS))
        if kind == "unsorted":
            assert want[3] == len(counts)
        elif b == 1:
            assert want[0] == len(counts)
        elif b <= probe_td.RANK_MAX:
            assert want[1] > len(counts) // 2 and want[2] == want[3] == 0
        else:
            assert want[2] > len(counts) // 2 and want[3] == 0
        ref = jw._histo_fold_staged(*(jnp.asarray(a) for a in fields_np),
                                    jnp.asarray(v), jnp.asarray(wd))
        plain = tw.fold_staged(fields, stage)
        paths = torch.zeros(len(tk.PATHS), dtype=torch.int32)
        got = _emulated_fold(emulated, fields, stage, paths)
        assert paths.tolist() == want.tolist(), (form, paths.tolist())
        for name, r, a, g in zip(FOLD_NAMES, ref, plain, got):
            _assert_bitwise(np.asarray(r), a, f"{kind} {form} B {b} {name} "
                                              f"(JAX)")
            _assert_bitwise(a, g, f"{kind} {form} B {b} {name}")
