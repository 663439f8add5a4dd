"""Query programs for the live read path (veneur_tpu_torch/query/),
PyTorch port of veneur_tpu/ops/query.py.

The flush extract evaluates the WHOLE pool, because a flush wants every
row. ``quantile_rows`` and ``scalar_rows`` are the gather-then-evaluate
form for a handful of rows: pick the K requested digest rows, run the
t-digest quantile program (ops/tdigest.quantile) or the scalar
aggregates (ops/tdigest.row_sum, row_count) over the [K, C] sub-pool.
They are XLA programs in the JAX package and torch ops here, on the
tensors' device. The query engine does not call them: its ad-hoc
quantiles run the flush extract kernel again over the epoch's fields
(core/worker.py ``_make_query_eval``).

Two padding helpers keep ad-hoc request shapes to a few sizes, as the
JAX package pads them to bound its compiles:

* `pad_quantiles` pads an arbitrary quantile vector to the next power of
  two (min 4) by repeating the last value; callers slice the result
  columns back down.
* `pad_rows` pads a row-index vector the same way by repeating the last
  index; duplicate gathers are harmless and callers slice rows back.

This module also holds the host-side numpy references of the JAX
package's differential fuzzer: independent re-implementations of the
quantile / HLL-estimate / CMS-point math, copied.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import tdigest as td

# smallest padded quantile-vector shape: dashboards ask for 1-3 points;
# one compile covers them all
MIN_QS = 4


def _next_pow2(n: int, floor: int = 1) -> int:
    v = max(n, floor)
    return 1 << (v - 1).bit_length()


def pad_quantiles(qs) -> tuple[np.ndarray, int]:
    """Pow2-pad an arbitrary quantile vector (repeat the last value) →
    (padded f32[P'], original length). Repeating a quantile is free to
    evaluate and keeps the compile ladder at log2 variants."""
    q = np.asarray(qs, dtype=np.float32).reshape(-1)
    n = q.shape[0]
    target = _next_pow2(n, MIN_QS)
    if target == n:
        return q, n
    fill = q[-1] if n else np.float32(0.5)
    return np.concatenate([q, np.full(target - n, fill, np.float32)]), n


def pad_rows(rows) -> tuple[np.ndarray, int]:
    """Pow2-pad a row-index vector (repeat the last index) →
    (padded i32[K'], original length). A duplicated gather row just
    recomputes one digest; callers slice back to the true K."""
    r = np.asarray(rows, dtype=np.int32).reshape(-1)
    n = r.shape[0]
    target = _next_pow2(n, 1)
    if target == n:
        return r, n
    return np.concatenate([r, np.full(target - n, r[-1], np.int32)]), n


def quantile_rows(means: torch.Tensor, weights: torch.Tensor,
                  dmin: torch.Tensor, dmax: torch.Tensor, rows: torch.Tensor,
                  qs: torch.Tensor) -> torch.Tensor:
    """Gather-then-evaluate: [K] digest rows × [P] quantiles → [K, P].

    Same interpolation as the flush extract (ops/tdigest.quantile); the
    gather bounds per-query device work by the request size, not the
    pool size."""
    rows = rows.to(torch.int64)
    return td.quantile(means[rows], weights[rows], dmin[rows], dmax[rows],
                       qs)


def scalar_rows(dmin: torch.Tensor, dmax: torch.Tensor,
                drecip: torch.Tensor, drecip_c: torch.Tensor,
                means: torch.Tensor, weights: torch.Tensor,
                rows: torch.Tensor) -> tuple:
    """Gathered scalar aggregates per requested row:
    (min, max, sum, count, recip) — the non-quantile half of the flush
    extract's packed columns, for K rows only (denormals as the extract's
    plain version treats them, ops/extract_kernel.py)."""
    rows = rows.to(torch.int64)
    z = exn.flush_denormals
    w = weights[rows]
    m = means[rows]
    return (dmin[rows], dmax[rows], td.row_sum(m, w), td.row_count(w),
            z(z(drecip[rows]) + z(drecip_c[rows])))


# ---------------------------------------------------------------------------
# Host-side numpy references (the JAX package's differential fuzzer).
# Independent math, same semantics: the fuzzer randomizes pools and
# compares these against the device programs within float32 tolerance.


def np_quantile(means: np.ndarray, weights: np.ndarray, dmin: np.ndarray,
                dmax: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """Numpy mirror of ops/tdigest.quantile: [S, C] digests × [P]
    quantiles → [S, P], NaN for empty digests."""
    means = np.asarray(means, np.float64)
    weights = np.asarray(weights, np.float64)
    dmin = np.asarray(dmin, np.float64)
    dmax = np.asarray(dmax, np.float64)
    qs = np.asarray(qs, np.float64)
    s, c = means.shape
    nonempty = weights > 0
    count = nonempty.sum(axis=-1)
    next_means = np.concatenate(
        [means[:, 1:], np.full((s, 1), np.inf)], axis=-1)
    mid = (means + next_means) / 2.0
    idx = np.arange(c)
    is_last = idx[None, :] == (count - 1)[:, None]
    ub = np.where(is_last, dmax[:, None], mid)
    w_cum = np.cumsum(weights, axis=-1)
    total = w_cum[:, -1]
    lb = np.concatenate([dmin[:, None], ub[:, :-1]], axis=-1)
    target = qs[None, :] * total[:, None]
    out = np.empty((s, qs.shape[0]))
    for i in range(s):
        fi = np.minimum(np.searchsorted(w_cum[i], target[i], side="left"),
                        c - 1)
        w_at = weights[i, fi]
        w_before = w_cum[i, fi] - w_at
        lb_at = lb[i, fi]
        ub_at = ub[i, fi]
        prop = (target[i] - w_before) / np.maximum(w_at, 1e-30)
        out[i] = lb_at + prop * (ub_at - lb_at)
    empty = (total <= 0) | (count <= 0)
    out[empty, :] = np.nan
    return out


def np_hll_estimate(registers: np.ndarray, precision: int) -> np.ndarray:
    """Numpy mirror of ops/hll.estimate: int8[S, m] → f64[S]."""
    m = float(1 << precision)
    regs = np.asarray(registers, np.float64)
    inv_sum = np.sum(np.exp2(-regs), axis=-1)
    zeros = np.sum(np.asarray(registers) == 0, axis=-1).astype(np.float64)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / inv_sum
    linear = m * np.log(m / np.maximum(zeros, 1.0))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return np.where(use_linear, linear, raw)


def np_cms_query(pool: np.ndarray, rows: np.ndarray,
                 col_idx: np.ndarray) -> np.ndarray:
    """Numpy mirror of ops/heavyhitter.query: min over depth of the
    addressed counters. i32[T,D,W] × i32[N] × i32[D,N] → i64[N]."""
    pool = np.asarray(pool)
    d = pool.shape[1]
    picked = pool[rows[None, :], np.arange(d)[:, None], col_idx]
    return picked.min(axis=0).astype(np.int64)
