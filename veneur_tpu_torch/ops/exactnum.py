"""Order-pinned exact numerics, PyTorch twins of veneur_tpu/ops/exactnum.py.

The reference pins every float reduction to an explicit association
(a Hillis-Steele doubling scan for prefix sums, an adjacent-pair halving
tree for sums), rounds every product before it meets an add, and reads
transcendentals from host-built f32 tables. Those rules make its results
reproducible across backends; the functions here run the identical
operation sequence on torch tensors, so the port's results are bitwise
equal to the JAX package's on the same inputs, on the CPU and on the card.

PyTorch runs eagerly, one kernel per op, so nothing fuses a multiply into
an add behind our back; ``block`` is kept anyway for its NaN semantics
(NaN → 0), which the reference's outputs carry.

The table builders are NumPy and copied from the reference, which builds
them next to a ``jax.numpy`` import. Min and max follow XLA on the CPU
(``minimum``, ``amin``, ``scatter_amin_``, ``pmin0`` and their max
twins: see the section below).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def next_pow2(n: int, floor: int = 1) -> int:
    v = max(int(n), floor)
    return 1 << (v - 1).bit_length()


def block(x: torch.Tensor) -> torch.Tensor:
    """``where(x == x, x, 0)``: the identity for every non-NaN value, NaN
    mapped to 0 (the reference's FMA blocker, same semantics)."""
    return torch.where(x == x, x, torch.zeros_like(x))


def _shift_right(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """``pad(x, (k, 0))[..., :n]`` along the last axis."""
    pad = torch.full(x.shape[:-1] + (k,), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :x.shape[-1] - k]], dim=-1)


def cumsum(x: torch.Tensor, flush: bool = False) -> torch.Tensor:
    """Inclusive prefix sum along the last axis as a Hillis-Steele
    doubling scan: ``x + pad(x, shift)[..., :n]`` for shift = 1, 2, 4, ...
    (the padded lanes add 0.0, as in the reference).

    ``flush`` flushes every step's denormal sums, as XLA on the CPU
    does. Callers whose values are all of one sign leave it off: a sum of
    zeros and normal values of one sign is never denormal."""
    n = x.shape[-1]
    shift = 1
    while shift < n:
        x = x + _shift_right(x, min(shift, n), 0)
        if flush:
            x = flush_denormals(x)
        shift *= 2
    return x


def tsum(x: torch.Tensor, flush: bool = False) -> torch.Tensor:
    """Sum along the last axis as an adjacent-pair halving tree,
    zero-padded to a power of two; ``flush`` as in ``cumsum``."""
    n = x.shape[-1]
    p = next_pow2(n)
    if p != n:
        pad = torch.zeros(x.shape[:-1] + (p - n,), dtype=x.dtype,
                          device=x.device)
        x = torch.cat([x, pad], dim=-1)
    while p > 1:
        x = x[..., 0::2] + x[..., 1::2]
        if flush:
            x = flush_denormals(x)
        p //= 2
    return x[..., 0]


def tsum0(x: torch.Tensor, flush: bool = False) -> torch.Tensor:
    """``tsum`` over axis 0 (the stacked-pool merges)."""
    return tsum(torch.movedim(x, 0, -1), flush=flush)


# ---------------------------------------------------------------------------
# t-digest k-function bucketing, table form (see the reference module for
# the derivation: floor(k1_δ(q)) is the number of boundaries <= q)


@functools.lru_cache(maxsize=None)
def kscale_boundaries(compression: float) -> np.ndarray:
    """f32[⌊δ⌋] ascending bucket boundaries for floor(k1_δ(q)),
    computed in f64 and rounded once."""
    delta = float(compression)
    j = np.arange(1, int(math.floor(delta)) + 1, dtype=np.float64)
    q = (np.sin(np.pi * (j / delta - 0.5)) + 1.0) / 2.0
    return np.clip(q, 0.0, 1.0).astype(np.float32)


_TABLES: dict = {}


def _table(compression: float, device: torch.device) -> torch.Tensor:
    key = (float(compression), str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(kscale_boundaries(compression)).to(device)
        _TABLES[key] = t
    return t


def kscale_bucket(q: torch.Tensor, compression: float) -> torch.Tensor:
    """floor(k1_δ(q)) for f32 q in [0, 1]: searchsorted(side="right")
    over the f32 boundary table. Returns int64."""
    return torch.searchsorted(_table(compression, q.device),
                              q.contiguous(), right=True)


_EXP2_NEG_TABLE = np.exp2(-np.arange(65, dtype=np.float64)).astype(np.float32)


def exp2_neg_table() -> np.ndarray:
    """f32[65]: exp2(-r) for register ranks r = 0..64."""
    return _EXP2_NEG_TABLE


@functools.lru_cache(maxsize=None)
def hll_linear_table(precision: int) -> np.ndarray:
    """f32[m+1]: m·ln(m / max(z, 1)) by zero-register count z."""
    m = float(1 << precision)
    z = np.maximum(np.arange((1 << precision) + 1, dtype=np.float64), 1.0)
    return (m * np.log(m / z)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hll_alpha_m2(precision: int) -> np.float32:
    """f32: α_m · m² for the harmonic-mean estimator, rounded once."""
    m = float(1 << precision)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    return np.float32(alpha * m * m)


# ---------------------------------------------------------------------------
# f32 denormals as XLA reads them on the CPU

_F32_TINY = float(np.finfo(np.float32).tiny)


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """f32 denormals → zero of the same sign; every other value as is.

    XLA on the CPU runs with denormals-are-zero and flush-to-zero: an
    arithmetic op or a comparison (a sort's included) reads a denormal
    input as ±0 and writes a denormal result as ±0, while a copy, a
    gather or a select passes the bits through. The port applies this
    where such an op reads a function's inputs and to every arithmetic
    result that can come out denormal."""
    return torch.where(torch.abs(x) < _F32_TINY, x * 0.0, x)


# ---------------------------------------------------------------------------
# min and max as XLA on the CPU computes them
#
# XLA on the CPU orders -0.0 below +0.0 in the min and max of one program
# (jnp.minimum, jnp.min, a scatter's .at[].min), whichever operand comes
# first, and a NaN operand wins. Its cross-device collectives do not:
# lax.pmin and pmax fold the devices in order from the identity, never
# take a NaN and keep the earlier device's value on a tie (``pmin0``,
# ``pmax0``). Of two NaNs, min keeps a positive one
# and max a negative one (LLVM's minimum on x86: the operands swapped when
# the first is negative, then the first kept if it is a NaN). torch's own
# min and max keep whichever zero their loop meets first, which changes
# with the width on the CPU, so the port writes its own: elementwise as
# selects, reductions and scatters over an integer order of the bits
# (exact in any order, -0.0 and +0.0 apart).

_NAN_SHIFT = 1 << 33


def _bits_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys that order f32 ``x`` as its values order, -0.0 below
    +0.0 (NaNs wherever their bits put them: the callers move them)."""
    i = x.view(torch.int32)
    return (i ^ ((i >> 31) & 0x7FFFFFFF)).to(torch.int64)


def _from_bits_key(k: torch.Tensor) -> torch.Tensor:
    i = k.to(torch.int32)
    return (i ^ ((i >> 31) & 0x7FFFFFFF)).view(torch.float32)


def _min_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys whose least is ``x``'s XLA min: every NaN below every
    number, a positive NaN below a negative one."""
    k = _bits_key(x)
    return torch.where(torch.isnan(x), -_NAN_SHIFT - k, k)


def _from_min_key(k: torch.Tensor) -> torch.Tensor:
    return _from_bits_key(torch.where(k < -(1 << 32), -_NAN_SHIFT - k, k))


def _max_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys whose greatest is ``x``'s XLA max: every NaN above
    every number, a negative NaN above a positive one."""
    k = _bits_key(x)
    return torch.where(torch.isnan(x), _NAN_SHIFT - k, k)


def _from_max_key(k: torch.Tensor) -> torch.Tensor:
    return _from_bits_key(torch.where(k > 1 << 32, _NAN_SHIFT - k, k))


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.minimum`` as XLA on the CPU computes it (see above), as
    selects: the operands swapped where ``a`` is negative, then the first
    kept if it is a NaN or the lesser."""
    neg = torch.signbit(a)
    x, y = torch.where(neg, b, a), torch.where(neg, a, b)
    return torch.where(torch.isnan(x) | (x < y), x, y)


def maximum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.maximum`` as XLA on the CPU computes it (see ``minimum``)."""
    neg = torch.signbit(a)
    x, y = torch.where(neg, a, b), torch.where(neg, b, a)
    return torch.where(torch.isnan(x) | (x > y), x, y)


def amin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.min(x, axis=dim)`` as XLA on the CPU reduces it."""
    return _from_min_key(torch.amin(_min_key(x), dim=dim))


def amax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.max(x, axis=dim)`` as XLA on the CPU reduces it."""
    return _from_max_key(torch.amax(_max_key(x), dim=dim))


def pmin0(x: torch.Tensor) -> torch.Tensor:
    """``lax.pmin`` over the devices stacked along axis 0, as XLA on the
    CPU reduces across devices: from +inf, each device in order taken
    where it is less (so a NaN is never taken, and of -0.0 and +0.0 the
    earlier stays)."""
    acc = torch.full_like(x[0], float("inf"))
    for v in x:
        acc = torch.where(v < acc, v, acc)
    return acc


def pmax0(x: torch.Tensor) -> torch.Tensor:
    """``lax.pmax`` over axis 0, from -inf (see ``pmin0``)."""
    acc = torch.full_like(x[0], float("-inf"))
    for v in x:
        acc = torch.where(v > acc, v, acc)
    return acc


def _touched(dst: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``dst`` with its denormals flushed where ``index`` scatters into
    it: XLA's scatter combiner reads both operands as an arithmetic op
    does (a denormal as the zero of its sign) and writes its result so,
    while the slots it never touches keep their bits."""
    hit = torch.zeros(dst.shape, dtype=torch.bool, device=dst.device)
    hit.index_fill_(0, index, True)
    return torch.where(hit, flush_denormals(dst), dst)


def scatter_amin_(dst: torch.Tensor, index: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``dst.at[index].min(src)`` in place, as XLA on the CPU scatters it:
    an ``amin`` scatter of the keys of the flushed operands, then one
    write of ``dst``."""
    k = _min_key(_touched(dst, index))
    k.scatter_reduce_(0, index, _min_key(flush_denormals(src)),
                      reduce="amin")
    return dst.copy_(_from_min_key(k))


def scatter_amax_(dst: torch.Tensor, index: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``dst.at[index].max(src)`` in place (see ``scatter_amin_``)."""
    k = _max_key(_touched(dst, index))
    k.scatter_reduce_(0, index, _max_key(flush_denormals(src)),
                      reduce="amax")
    return dst.copy_(_from_max_key(k))
