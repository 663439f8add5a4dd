"""Reader-shard plane stacking: fold N per-reader staging planes into
ONE flat batch in canonical row space.

Shared-nothing ingest (core/worker.attach_reader_shards) gives every
reader its own C++ context — private directory, staging plane, SoA
spill epoch — so the commit hot path takes no shared lock. The price is
paid here, once per flush: each context's detached [rows, B] plane
carries CONTEXT-LOCAL rows, and the flush needs one batch in the
worker's canonical row space.

The merge is a host-side stacked concatenation, NOT a new device
kernel: per context the filled slots compact to a 1-D row-major flat
array (exactly what the legacy single-context fold uploads, see
DeviceWorker._fold_one_plane), local rows translate through the
reconciliation map built at series sync, and a stable sort by canonical
row groups every series' samples in context order. The result — flat
values (+ weights) and per-row counts — feeds the EXACT legacy device
program (core/worker.fold_staged over the flat plane), which is what makes
reader-sharded == legacy bit-identical: same slot order, same values,
same fold.

Rows whose stacked total exceeds the staging depth B keep their first B
samples in the plane (the same membership the legacy path produces:
each context's plane caps at B and per-context overflow rode that
context's SoA spill) and route the excess to the spill fold, so
conservation stays exact — committed == folded + shed.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def merge_reader_planes(planes: list, s_eff: int):
    """Merge per-context detached staging planes into one canonical
    flat batch.

    planes: [(stage, rowmap), ...] in context order, where stage is the
    NativeIngest.detach_stage tuple (vals[rows, B], wts[rows, B],
    counts[rows], unit, free) — vals/wts/counts may alias C++ memory;
    this function copies out of them and does NOT free (the caller owns
    the release hooks) — and rowmap is an int32 array mapping context-
    local histo row → canonical directory row.

    Returns (flat_v, flat_w_or_None, counts, spill, per_ctx_samples):
      flat_v    f32 [total_kept] — kept samples, canonical-row-major,
                context order within each row
      flat_w    f32 [total_kept] or None when every weight is 1.0
      counts    i32 [s_eff] — kept samples per canonical row (≤ B)
      spill     (rows, vals, wts) SoA of the over-depth excess, or None
      per_ctx_samples  [int] — staged samples contributed per context
                (transfer-ledger attribution)
    Returns (None, None, None, None, per_ctx) when nothing is staged.
    """
    unit_all = all(st[3] for st, _m in planes)
    crows_parts = []
    vals_parts = []
    wts_parts = []
    per_ctx = []
    depth = 0
    for st, rowmap in planes:
        sv, sw, counts, unit, _free = st
        B = sv.shape[1]
        depth = max(depth, B)
        rows_avail = min(sv.shape[0], len(rowmap))
        counts_k = np.minimum(counts[:rows_avail], B).astype(np.int64)
        n_k = int(counts_k.sum())
        per_ctx.append(n_k)
        if not n_k:
            continue
        mask = (np.arange(B, dtype=np.int64)[None, :]
                < counts_k[:, None])
        vals_parts.append(sv[:rows_avail][mask])  # copies out of C++
        if unit_all:
            pass  # weights rebuilt on device from counts
        elif unit:
            wts_parts.append(np.ones(n_k, np.float32))
        else:
            wts_parts.append(sw[:rows_avail][mask])
        crows_parts.append(
            np.repeat(np.asarray(rowmap[:rows_avail], np.int64), counts_k))
    if not vals_parts:
        return None, None, None, None, per_ctx

    crows = np.concatenate(crows_parts)
    flat_v = np.concatenate(vals_parts)
    flat_w = None if unit_all else np.concatenate(wts_parts)
    # stable sort: per canonical row, samples stay in context-concat
    # order — the serialized-reader-order ground truth the parity tests
    # pin against
    order = np.argsort(crows, kind="stable")
    srows = crows[order]
    flat_v = flat_v[order]
    if flat_w is not None:
        flat_w = flat_w[order]
    totals = np.bincount(srows, minlength=s_eff)
    offs = np.cumsum(totals) - totals
    within = np.arange(len(srows), dtype=np.int64) - offs[srows]
    keep = within < depth
    counts_out = np.minimum(totals[:s_eff], depth).astype(np.int32)
    spill = None
    if not keep.all():
        ex = ~keep
        sp_v = flat_v[ex]
        sp_w = (np.ones(len(sp_v), np.float32) if flat_w is None
                else flat_w[ex])
        spill = (srows[ex].astype(np.int32), sp_v, sp_w)
        flat_v = flat_v[keep]
        if flat_w is not None:
            flat_w = flat_w[keep]
    return flat_v, flat_w, counts_out, spill, per_ctx
