"""Batched t-digest pool programs, PyTorch twins of veneur_tpu/ops/tdigest.py.

A pool of S digests is a pair of dense tensors ``means/weights: f32[S, C]``
(rows sorted by mean, empty slots mean=+inf/weight=0) plus per-row
min/max/reciprocal-sum scalars. Compression is one data-parallel program
over all rows: stable sort by mean, Hillis-Steele cumulative weight,
k-function bucket from the f32 boundary table, per-bucket run sums as
prefix-sum differences, re-sort. See the reference module for the design.

Bit contract: every op below is the reference's op in the reference's
order. Sorts are stable (``lax.sort`` is stable; tie order decides the
bits) and run on an integer order key (``_order_key``: -0.0 and +0.0
equal, every NaN equal and after +inf, as ``lax.sort`` and ``torch.sort``
on the CPU order floats), so they give one order on every device; the
reference's two-key sort is two stable sorts, secondary key first. Scans
and sums go through ``ops/exactnum.py``, and so do min and max
(``exactnum.minimum``, ``amin``...: -0.0 below +0.0 and a NaN operand
winning, as XLA on the CPU orders them; the sort's order key keeps -0.0
and +0.0 equal, as ``lax.sort`` does).

K2: the two folds, ``compress_rows`` (also ``_compress_rows``) and
``add_batch``, are dispatchers. A CPU tensor takes the plain version
(``_compress_rows_plain``, ``add_batch_plain``); a CUDA tensor launches
the hand kernel of csrc/tdigest.cu (ops/tdigest_kernel.py) or raises.
``compress_rows.launches`` and ``add_batch.launches`` count kernel
launches, nothing else. A shape that either kernel does not take raises
ValueError on both devices.

Denormals as XLA on the CPU treats them (``exactnum.flush_denormals``):
arithmetic, comparisons and sorts read a denormal input as a zero of its
sign, every arithmetic result that can come out denormal is flushed, and
a gather or select passes the raw bits (the batch min and max of
``add_batch``). Sums of values of one sign need no flush: a sum of zeros
and normal values of one sign is zero or normal.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from veneur_tpu_torch.device import resolve
from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import segments
from veneur_tpu_torch.ops import tdigest_kernel

DEFAULT_COMPRESSION = 100.0
DEFAULT_CAPACITY = 128

_INF = float("inf")
_TINY = 1e-30


class TDigestPool(NamedTuple):
    """A pool of S t-digests as dense tensors (see module docstring)."""

    means: torch.Tensor
    weights: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    recip: torch.Tensor


def capacity_for(compression: float) -> int:
    """Smallest multiple of 128 that can hold δ+1 bucket centroids."""
    need = int(math.floor(compression)) + 2
    return max(128, ((need + 127) // 128) * 128)


def init_pool(num_rows: int, capacity: int = DEFAULT_CAPACITY,
              device=None) -> TDigestPool:
    """An empty pool on ``device`` (none asked for: the card)."""
    device = resolve(device)
    f32 = torch.float32
    return TDigestPool(
        means=torch.full((num_rows, capacity), _INF, dtype=f32,
                         device=device),
        weights=torch.zeros((num_rows, capacity), dtype=f32, device=device),
        min=torch.full((num_rows,), _INF, dtype=f32, device=device),
        max=torch.full((num_rows,), -_INF, dtype=f32, device=device),
        recip=torch.zeros((num_rows,), dtype=f32, device=device),
    )


def pool_from_numpy(d: dict, device) -> TDigestPool:
    """A pool from the JAX package's ``pool_to_numpy`` dict (keys means,
    weights, min, max, recip), as f32 tensors on ``device``."""
    return TDigestPool(*(
        torch.from_numpy(np.array(d[k], np.float32, copy=True)).to(device)
        for k in ("means", "weights", "min", "max", "recip")))


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys that order flushed f32 ``x`` as ``lax.sort`` does:
    ascending, -0.0 == +0.0, every NaN equal and above +inf
    (csrc/tdigest.cu's ``order_key``). A float sort on the card need not
    order signed zeros and NaNs so; an integer sort is exact on every
    device. ``x + 0.0`` turns -0.0 into +0.0; a negative float's
    magnitude bits are flipped so it orders below the smaller
    magnitudes."""
    i = (x + 0.0).view(torch.int32)
    key = i ^ ((i >> 31) & 0x7FFFFFFF)
    return torch.where(torch.isnan(x), 0x7FFFFFFF, key)


def _stable_sort_pair(keys: torch.Tensor, payload: torch.Tensor):
    """``lax.sort((keys, payload), num_keys=1)`` along the last axis."""
    order = torch.sort(_order_key(keys), dim=-1, stable=True).indices
    return torch.gather(keys, -1, order), torch.gather(payload, -1, order)


def _k_bucket(q: torch.Tensor, compression: float, capacity: int
              ) -> torch.Tensor:
    """floor of the k1 scale function, clipped to the row capacity."""
    return torch.clamp(exn.kscale_bucket(q, compression), 0, capacity - 1)


def _compress_rows_plain(means: torch.Tensor, weights: torch.Tensor,
                         compression: float, capacity: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress candidate centroid rows [S, M] → [S, capacity], the plain
    version of K2a.

    Empty candidate slots must have weight 0 (their mean is ignored).
    Output rows are sorted by mean with +inf padding."""
    s, _ = means.shape
    z = exn.flush_denormals
    # 1. sort each row by mean; zero-weight slots keyed +inf sort last.
    #    The sort and every use below read the flushed values
    weights = z(weights)
    sort_keys = torch.where(weights > 0, z(means), _INF)
    sorted_means, sorted_w = _stable_sort_pair(sort_keys, weights)
    # 2. per-row cumulative weight (weights >= 0) and left-edge quantile
    w_cum = exn.cumsum(sorted_w)
    total = w_cum[:, -1:]
    q_left = z(z(w_cum - sorted_w) / torch.clamp_min(total, _TINY))
    # 3. k-function buckets
    bucket = _k_bucket(q_left, compression, capacity)
    # 4. bucket runs are contiguous along a sorted row: each run's sum is
    #    a difference of row-prefix sums at the run ends
    mw_cum = exn.cumsum(
        torch.where(sorted_w > 0, z(sorted_means * sorted_w), 0.0),
        flush=True)
    nxt = torch.cat([bucket[:, 1:],
                     torch.full((s, 1), -1, dtype=bucket.dtype,
                                device=bucket.device)], dim=-1)
    is_end = bucket != nxt
    w_before, mw_before = segments.last_marked_carry(is_end, w_cum, mw_cum)
    seg_w = z(w_cum - w_before)
    seg_mw = z(mw_cum - mw_before)
    live = is_end & (seg_w > 0)
    new_means = torch.where(live, z(seg_mw / torch.clamp_min(seg_w, _TINY)),
                            _INF)
    new_w = torch.where(live, seg_w, 0.0)
    # 5. sort by mean and keep the first `capacity` slots (contiguous:
    #    the result becomes pool rows the extract kernel reads)
    new_means, new_w = _stable_sort_pair(new_means, new_w)
    return (new_means[:, :capacity].contiguous(),
            new_w[:, :capacity].contiguous())


def _check_compress(means: torch.Tensor, weights: torch.Tensor,
                    capacity: int) -> None:
    """What K2a takes, refused alike on every device."""
    if means.dim() != 2 or means.shape != weights.shape:
        raise ValueError(f"candidate rows must be two [S, M] tensors of one "
                         f"shape, not {tuple(means.shape)} and "
                         f"{tuple(weights.shape)}")
    if means.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError("candidate rows must be float32")
    if means.device != weights.device:
        raise ValueError("candidate means and weights on two devices")
    m = means.shape[1]
    if not 1 <= capacity <= m or m >= 1 << 30:
        raise ValueError(f"{m} candidates a row cannot compress to "
                         f"{capacity} slots")
    if not (means.is_contiguous() and weights.is_contiguous()):
        raise ValueError("candidate rows must be contiguous")


def compress_rows(means, weights, compression: float = DEFAULT_COMPRESSION,
                  capacity: int = DEFAULT_CAPACITY):
    """Compress candidate centroid rows [S, M] → [S, capacity] (see
    ``_compress_rows_plain``): K2a on a CUDA tensor, the plain version on
    a CPU one."""
    _check_compress(means, weights, capacity)
    if means.device.type == "cpu":
        return _compress_rows_plain(means, weights, compression, capacity)
    out = tdigest_kernel.compress(means, weights, capacity,
                                  exn._table(compression, means.device))
    if means.shape[0]:
        compress_rows.launches += 1
    return out


compress_rows.launches = 0
_compress_rows = compress_rows


def merge_pools(a: TDigestPool, b: TDigestPool,
                compression: float = DEFAULT_COMPRESSION) -> TDigestPool:
    """Row-wise merge of two digest pools (the global-aggregation
    reduce): one concat and compress pass. The scalars read and write
    denormals as XLA on the CPU does."""
    z = exn.flush_denormals
    c = a.means.shape[1]
    means, weights = _compress_rows(torch.cat([a.means, b.means], dim=-1),
                                    torch.cat([a.weights, b.weights], dim=-1),
                                    compression, c)
    return TDigestPool(
        means=means, weights=weights,
        min=z(exn.minimum(a.min, b.min)),
        max=z(exn.maximum(a.max, b.max)),
        recip=z(z(a.recip) + z(b.recip)))


def merge_many(stacked: TDigestPool,
               compression: float = DEFAULT_COMPRESSION) -> TDigestPool:
    """Merge H digests per series, fields shaped [H, S, ...] → [S, ...]:
    the cross-host merge. Every host's centroid rows concatenate along
    the capacity axis (host-major) and compress once; ``recip`` is the
    host axis's halving tree (``exactnum.tsum0``)."""
    z = exn.flush_denormals
    h, s, c = stacked.means.shape
    means = stacked.means.permute(1, 0, 2).reshape(s, h * c)
    weights = stacked.weights.permute(1, 0, 2).reshape(s, h * c)
    means, weights = _compress_rows(means, weights, compression, c)
    return TDigestPool(
        means=means, weights=weights,
        min=z(exn.amin(stacked.min, dim=0)),
        max=z(exn.amax(stacked.max, dim=0)),
        recip=exn.tsum0(z(stacked.recip), flush=True))


class BatchStats(NamedTuple):
    """Per-row statistics of one raw-sample batch."""

    weight: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor
    sum: torch.Tensor
    recip: torch.Tensor


def _prefix_scans(srows, svals, sw):
    """The reference's scan stack: three prefix sums and the forward/
    backward segmented sums, in its order (sw >= 0, both flushed)."""
    z = exn.flush_denormals
    zero1 = torch.zeros((1,), dtype=sw.dtype, device=sw.device)
    pre_w = torch.cat([zero1, exn.cumsum(sw)])
    pre_vw = torch.cat([zero1, exn.cumsum(exn.block(z(svals * sw)),
                                          flush=True)])
    pre_recip = torch.cat(
        [zero1, exn.cumsum(torch.where(sw > 0, z(sw / svals), 0.0),
                           flush=True)])
    one = torch.ones((1,), dtype=torch.bool, device=sw.device)
    row_starts = torch.cat([one, srows[1:] != srows[:-1]])
    seg_cum = segments.segmented_cumsum(sw, row_starts)
    row_ends = torch.cat([row_starts[1:], one])
    suffix = segments.segmented_cumsum(
        sw.flip(0), row_ends.flip(0)).flip(0)
    return pre_w, pre_vw, pre_recip, seg_cum, suffix


def _sort_batch(rows, values, sample_weights, k: int):
    """Step 1 of ``add_batch_plain``, the plain version of K2b's sort: the
    batch sorted by (row, value), two stable sorts, secondary key first;
    padding samples (weight <= 0) keyed to row k, past every real row.
    Returns (rows int64, flushed values, flushed weights, raw values)."""
    z = exn.flush_denormals
    wts = z(sample_weights)
    live = wts > 0
    rows = torch.where(live, rows.to(torch.int64), k)
    # the raw values, for the min/max gathers; the sort and the
    # arithmetic read them flushed
    raw_vals = torch.where(live, values, 1.0)
    safe_vals = z(raw_vals)
    o1 = torch.sort(_order_key(safe_vals), stable=True).indices
    o2 = torch.sort(rows[o1], stable=True).indices
    order = o1[o2]
    return rows[order], safe_vals[order], wts[order], raw_vals[order]


def _check_add(means, weights, dmin, dmax, drecip, rows, values,
               sample_weights) -> None:
    """What K2b takes, refused alike on every device."""
    if means.dim() != 2 or means.shape != weights.shape:
        raise ValueError(f"digest rows must be two [K, C] tensors of one "
                         f"shape, not {tuple(means.shape)} and "
                         f"{tuple(weights.shape)}")
    k, c = means.shape
    if k < 1 or not 1 <= c <= tdigest_kernel.MAX_ADD_CAPACITY \
            or k >= 1 << 31:
        raise ValueError(f"add_batch takes 1 <= K < 2^31 rows of 1 to "
                         f"{tdigest_kernel.MAX_ADD_CAPACITY} slots, not "
                         f"[{k}, {c}]")
    for name, t in (("dmin", dmin), ("dmax", dmax), ("drecip", drecip)):
        if t.shape != (k,):
            raise ValueError(f"{name} must be [{k}], not {tuple(t.shape)}")
    n = rows.shape[0] if rows.dim() == 1 else -1
    if n < 1 or n >= 1 << 30 or values.shape != (n,) \
            or sample_weights.shape != (n,):
        raise ValueError("rows, values and weights must be three [N] "
                         "tensors, 1 <= N < 2^30")
    if rows.dtype not in (torch.int32, torch.int64):
        raise ValueError("rows must be int32 or int64")
    floats = (means, weights, dmin, dmax, drecip, values, sample_weights)
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError("digest rows, scalars, values and weights must be "
                         "float32")
    if any(t.device != means.device for t in floats + (rows,)):
        raise ValueError("add_batch's tensors on more than one device")
    if not all(t.is_contiguous() for t in floats + (rows,)):
        raise ValueError("add_batch's tensors must be contiguous")


def add_batch(means, weights, dmin, dmax, drecip, rows, values,
              sample_weights, compression: float = DEFAULT_COMPRESSION):
    """Ingest a batch of raw samples into digest rows (see
    ``add_batch_plain``): on a CUDA tensor K2b, its sort included (no
    torch op runs); on a CPU one the plain version."""
    _check_add(means, weights, dmin, dmax, drecip, rows, values,
               sample_weights)
    if means.device.type == "cpu":
        return add_batch_plain(means, weights, dmin, dmax, drecip, rows,
                               values, sample_weights, compression)
    out = tdigest_kernel.add_batch(
        means, weights, dmin, dmax, drecip, rows, values, sample_weights,
        exn._table(compression, means.device))
    add_batch.launches += 1
    return (*out[:5], BatchStats(*out[5:]))


add_batch.launches = 0


def add_batch_plain(means, weights, dmin, dmax, drecip, rows, values,
                    sample_weights, compression: float = DEFAULT_COMPRESSION):
    """Ingest a batch of raw samples into digest rows, the plain version
    of K2b (with the sort before it).

    means/weights: f32[K, C]; dmin/dmax/drecip: f32[K]; rows: int[N] in
    [0, K) (padding samples carry sample_weights == 0); values,
    sample_weights: f32[N]. Returns (means, weights, dmin, dmax, drecip,
    BatchStats), all new tensors."""
    k, c = means.shape
    n = rows.shape[0]
    dev = means.device
    z = exn.flush_denormals

    # 1. sort the batch by (row, value)
    srows, svals, sw, raw_svals = _sort_batch(rows, values, sample_weights,
                                              k)

    # 2. per-row stats from prefix-sum differences and boundary gathers
    pre_w, pre_vw, pre_recip, seg_cum, suffix = _prefix_scans(
        srows, svals, sw)
    kbins = torch.arange(k, dtype=torch.int64, device=dev)
    row_upper = torch.searchsorted(srows.contiguous(), kbins, right=True)
    row_lower = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                           row_upper[:-1]])
    seg_w = z(pre_w[row_upper] - pre_w[row_lower])
    seg_sum = z(pre_vw[row_upper] - pre_vw[row_lower])
    seg_recip = z(pre_recip[row_upper] - pre_recip[row_lower])
    has = seg_w > 0
    seg_min = torch.where(has, raw_svals[row_lower.clamp(max=n - 1)], _INF)
    seg_max = torch.where(has, raw_svals[torch.clamp_min(row_upper - 1, 0)],
                          -_INF)
    stats = BatchStats(seg_w, seg_min, seg_max, seg_sum, seg_recip)

    # 3. batch digest: k-bucket per sample, per-(row, bucket) run sums
    # (seg_cum, suffix >= 0: sums of weights)
    row_total = z(z(seg_cum + suffix) - sw)
    q_left = z(z(seg_cum - sw) / torch.clamp_min(row_total, _TINY))
    bucket = _k_bucket(q_left, compression, c)
    seg_id = srows * c + bucket
    one = torch.ones((1,), dtype=torch.bool, device=dev)
    starts = torch.cat([one, seg_id[1:] != seg_id[:-1]])
    grank = torch.cumsum(starts.to(torch.int64), 0) - 1
    pos = torch.where(starts, torch.arange(n, device=dev), n)
    pos_ext = torch.cat([torch.sort(pos).values,
                         torch.full((1,), n, dtype=torch.int64, device=dev)])
    run_lo = grank[row_lower.clamp(0, n - 1)]
    run_hi = grank[torch.clamp_min(row_upper - 1, 0)] + 1
    n_runs_row = torch.where(has, run_hi - run_lo, 0)
    j = torch.arange(c, dtype=torch.int64, device=dev)
    runs = torch.clamp(run_lo[:, None] + j[None, :], 0, n - 1)
    valid = j[None, :] < n_runs_row[:, None]
    r_start = pos_ext[runs]
    last = j[None, :] == (n_runs_row - 1)[:, None]
    pre = torch.stack([pre_w, pre_vw], dim=-1)  # [N+1, 2]
    at_start = pre[r_start]  # [K, C, 2]
    at_row_end = pre[row_upper]  # [K, 2]
    at_next = torch.cat(
        [at_start[:, 1:, :],
         torch.zeros((k, 1, 2), dtype=at_start.dtype, device=dev)], dim=1)
    at_end = torch.where(last[:, :, None], at_row_end[:, None, :], at_next)
    diff = z(at_end - at_start)
    bd_w = torch.where(valid, diff[..., 0], 0.0)
    bd_mw = torch.where(valid, diff[..., 1], 0.0)
    bd_means = torch.where(bd_w > 0,
                           z(bd_mw / torch.clamp_min(bd_w, _TINY)), _INF)

    # 4. merge with the existing rows and recompress
    cat_means = torch.cat([means, bd_means], dim=-1)
    cat_w = torch.cat([weights, bd_w], dim=-1)
    new_means, new_w = _compress_rows_plain(cat_means, cat_w, compression,
                                            c)

    # 5. digest scalars (the min and max of flushed values are flushed)
    new_min = exn.minimum(z(dmin), z(seg_min))
    new_max = exn.maximum(z(dmax), z(seg_max))
    new_recip = z(z(drecip) + seg_recip)
    return new_means, new_w, new_min, new_max, new_recip, stats


def _row_bounds(means: torch.Tensor, weights: torch.Tensor,
                dmax: torch.Tensor):
    """Per-slot upper value bounds under the uniform-centroid assumption
    (midpoints of adjacent means, dmax at the last nonempty slot)."""
    s, c = means.shape
    z = exn.flush_denormals
    count = (weights > 0).sum(dim=-1)
    idx = torch.arange(c, device=means.device)
    next_means = torch.cat(
        [means[:, 1:], torch.full((s, 1), _INF, dtype=means.dtype,
                                  device=means.device)], dim=-1)
    mid = z(z(means + next_means) / 2.0)
    is_last = idx[None, :] == (count - 1)[:, None]
    ub = torch.where(is_last, dmax[:, None], mid)
    return ub, count


def quantile(means, weights, dmin, dmax, qs) -> torch.Tensor:
    """Batched quantile extraction: [S, C] digests × [P] f32 quantiles →
    [S, P] (the reference's gather form). Empty digests yield NaN."""
    z = exn.flush_denormals
    means, weights, dmin, dmax, qs = (z(a) for a in (means, weights, dmin,
                                                      dmax, qs))
    c = means.shape[1]
    ub, count = _row_bounds(means, weights, dmax)
    w_cum = exn.cumsum(weights, flush=True)
    total = w_cum[:, -1]
    lb = torch.cat([dmin[:, None], ub[:, :-1]], dim=-1)
    target = exn.block(z(qs[None, :] * total[:, None]))  # [S, P]
    # first slot whose cumulative weight reaches the target
    first_idx = torch.searchsorted(w_cum, target.contiguous(), right=False)
    first_idx = torch.clamp_max(first_idx, c - 1)

    def _at(x):
        return torch.gather(x, 1, first_idx)

    w_at = _at(weights)
    w_before = z(_at(w_cum) - w_at)
    lb_at = _at(lb)
    ub_at = _at(ub)
    proportion = z(z(target - w_before) / torch.clamp_min(w_at, _TINY))
    out = z(lb_at + exn.block(z(proportion * z(ub_at - lb_at))))
    ok = (total[:, None] > 0) & (count[:, None] > 0)
    return torch.where(ok, out, float("nan"))


def cdf(means, weights, dmin, dmax, values) -> torch.Tensor:
    """Batched CDF: [S, C] digests × [S] f32 values → [S] fractions of
    the weight below each value, each slot's weight spread uniformly
    over its bounds. A value at or below the row's min gives 0.0, at or
    above its max 1.0; an empty row gives NaN.

    The JAX package sums with ``jnp.sum``, which has no fixed order; here
    the sums are ``exactnum.tsum`` trees, so the card gives the CPU's
    bits."""
    z = exn.flush_denormals
    means, weights, dmin, dmax, values = (z(a) for a in (
        means, weights, dmin, dmax, values))
    ub, count = _row_bounds(means, weights, dmax)
    total = exn.tsum(weights, flush=True)
    lb = torch.cat([dmin[:, None], ub[:, :-1]], dim=-1)
    v = values[:, None]
    inside = (v >= lb) & (v < ub)
    part = z(z(weights * z(v - lb)) / torch.clamp_min(z(ub - lb), _TINY))
    frac = torch.where(inside, part,
                       torch.where(v >= ub, weights, torch.zeros_like(part)))
    out = z(exn.tsum(frac, flush=True) / torch.clamp_min(total, _TINY))
    out = torch.where(values <= dmin, 0.0, out)
    out = torch.where(values >= dmax, 1.0, out)
    return torch.where((total > 0) & (count > 0), out, float("nan"))


def row_sum(means, weights) -> torch.Tensor:
    """Σ mean·weight per row, tree-summed."""
    z = exn.flush_denormals
    weights = z(weights)
    return exn.tsum(torch.where(weights > 0, z(z(means) * weights), 0.0),
                    flush=True)


def row_count(weights) -> torch.Tensor:
    """Total weight per row, tree-summed."""
    return exn.tsum(exn.flush_denormals(weights), flush=True)
