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
them next to a ``jax.numpy`` import.
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
