"""DeviceWorker: the batched aggregation engine, PyTorch port.

The counterpart of veneur_tpu/core/worker.py. One worker owns, on its
device,

  t-digest rows   f32[S_h, C]×2 + scalars   (histogram & timer series)
  local stats     f32[S_h] × 5 (+ compensation halves)
  HLL registers   int8[S_s, 2^p]            (set series)

and ingests samples in batches: histogram/timer samples stage host-side
in a [S, B] plane (``_device_histo_step``), rows whose plane is full
spill through a gather → add_batch → scatter fold (``_fold_batch_direct``),
and one staged fold per interval folds the plane into the pool at
extraction (``fold_staged``: on the card one launch of the K3 kernel,
on the CPU its plain chain ``_expand_flat_planes`` →
``_histo_fold_staged``). Set samples hash on the host into
(register, rank) and go to the set store: the staged store (sparse host
tier, dense device tier; ops/staged_sets.py) by default, or one dense
device pool (``set_store="dense"``). Counters, gauges, status checks and
the unique-timeseries HLL stay host-side. On the card the t-digest
folds, the flush extract, the set inserts and the set estimates run
hand-written CUDA kernels (ops/tdigest_kernel.py, ops/extract_kernel.py,
ops/hll.py).

With ``attach_native()`` the C++ ingest pipeline (veneur_tpu_torch/
native.py, built from native/) parses datagrams, assigns rows and stages
raw histogram samples in its own [S, B] plane: ``ingest_datagram`` feeds
it, ``drain_native`` moves its batches (hot-row spill, set updates,
counters, gauges) into the pools and adopts its new series into the
directory, and at flush the plane is compacted on the host and uploaded
flat with its rows' offsets, which the staged fold reads in place (the
plain chain rebuilds the dense plane first, ``_expand_flat_planes``).
The Python-side paths share the native directory through its upsert.

With ``micro_fold`` on, a scheduler calls ``micro_fold_once`` during the
interval: the staged samples drained since the last call stream as COO
deltas into a device mirror of the staging plane (ops/microfold.py), and
the flush folds the mirror instead of uploading the plane, bitwise the
same fold.

The device fault domain (ops/device_guard.py): every device entry point
runs under ``self.guard`` with the reference's op names, its sync or
readback inside the guarded call. A classified fault during a flush
completes that flush on the CPU from the last good state and the
retained host inputs (``FlushSnapshot.degraded``); a tripped breaker
moves the live epoch's pools to the CPU (``_quarantine_live``), where
the same torch programs run their plain versions, until a probe
re-admits the card (``device_guard_tick``). The CPU programs are bitwise
the card's, so a degraded flush equals a healthy one.

The device steps keep the reference's names and argument order. Where
the reference donates its pool buffers, the port may update the pool
tensors in place; a swapped epoch owns its tensors outright (the live
epoch starts a fresh pool), so no swapped epoch aliases the live pool.

With ``attach_reader_shards(n)`` (after ``attach_native``) each of n
reader threads commits into a native context of its own: each context's
local rows map to the worker's canonical Python directory at the series
sync, and the flush merges the contexts' staging planes on the host into
one flat plane (ops/reader_stack.py) that folds as a compacted native
plane does. Micro-folds stay off in that mode.

The global tier's import surface (``import_digest``,
``import_digests_soa``, ``import_counter_rows``, ``import_gauge_rows``,
``import_hll_row``, ``import_hll``, ``import_counter``,
``import_gauge``) buffers what downstream instances forwarded;
``_merge_imports`` merges it at the swap, under the guard's ``import``
op: digest rows through ``_histo_import_step`` (one compress over
[K, C + W]), HLL rows of the dense pool by a row max (the staged store
merges its own at the flush).

Per-tenant QoS (core/tenancy.py), installed by the server when budgets
are configured: a shared ``TenantLedger`` admits each new series on
every ingest path (the Python path refuses the sample before a row
exists; the native and reader-shard paths keep the row C++ assigned and
mark it ``admitted=False``, which the flusher skips), the epoch's
per-tenant tallies fold into lifetime totals at the swap, the spill shed
takes over-budget tenants first, and a ``TenantSketch`` (count-min pool
on this worker's device, host top-k) folds each flush's per-series
counts.

The live query view: with a ``query_publisher`` wired, extract_snapshot
ends by handing it the epoch's snapshot, a device evaluator closed over
the retained post-fold field tensors (``_make_query_eval``: the flush
extract again, at any quantile vector, under the guard's ``query`` op)
and a fenced sketch view.

Flush governance (health/): with a governor whose
``flush_chunk_target_ms`` is set, the extraction runs the flush extract
once per pow2 row chunk the governor sizes from the measured rate
(``_extract_chunked``), bitwise the single launch; every bounded fold
step beats the governor's progress clock, which the server's watchdog
reads. ``ledger`` (a ``TransferLedger``) books every flush-path upload
and readback by kind, one window per extraction, byte for byte the JAX
worker's books.

Series sharding (``series_shards``, ops/series_shard.py): the digest
pool, the dense set pool, the staged store's dense tier and the
micro-fold mirror partition their rows over D devices (``shard_devices``,
default the first D cards; the CPU when the worker runs there), each
pool a tuple of D per-shard tensors in physical row order; every device
step runs once per shard and every readback goes through the logical
permutation, so a sharded flush is bitwise an unsharded one. A
quarantine reads the pools back in logical order and the failover runs
unsharded on the CPU; re-admission splits them again. The global tier's
mesh (``attach_mesh_pool``, distributed/mesh.MeshHistoPool) takes the
histogram samples and imported digests instead of the local pool and
merges them across its hosts at the swap.
"""

from __future__ import annotations

import logging
import time
from array import array
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from veneur_tpu_torch.core.columnar import unpack_extract_columns
from veneur_tpu_torch.core.directory import (RowMeta, ScopeClass,
                                             SeriesDirectory, build_frag,
                                             classify)
from veneur_tpu_torch.core.metrics import (DEFAULT_TENANT, MetricKey,
                                           UDPMetric, route_info, tenant_of)
from veneur_tpu_torch.core.tenancy import TenantTallies
from veneur_tpu_torch.device import resolve
from veneur_tpu_torch.health.ledger import TransferLedger
from veneur_tpu_torch.ops import device_guard as dg
from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import extract_kernel as ek
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import hll_kernel
from veneur_tpu_torch.ops import microfold as mf
from veneur_tpu_torch.ops import reader_stack as rstack
from veneur_tpu_torch.ops import series_shard as ss
from veneur_tpu_torch.ops import tdigest as td
from veneur_tpu_torch.ops import tdigest_kernel
from veneur_tpu_torch.ops.staged_sets import StagedSetStore
from veneur_tpu_torch.utils.hashing import (fmix64, hll_hash, metric_digest,
                                           metro_hash64)

log = logging.getLogger("veneur_tpu_torch.worker")

_INF = float("inf")
# samples per spill fold: a native drain after a stall can hold millions
# of spilled samples; folding them in bounded chunks keeps the padded
# per-fold arrays small (the reference's _FOLD_CHUNK)
_FOLD_CHUNK = 1 << 18
# HBM valve (_ensure_histo): pool growths whose device footprint stays
# under this skip the allocation pre-flight, which a kB-scale grow cannot
# need
_GROW_PREFLIGHT_MIN_BYTES = 4 << 20


def _series_budget_id(scope_class: ScopeClass, key: MetricKey) -> str:
    """The tenant ledger's series identity: distinct (key, scope_class)
    pairs occupy distinct rows (see SeriesDirectory), so each consumes
    budget separately."""
    return f"{int(scope_class)}\x1f{key.key_string()}"


def _next_pow2(n: int, floor: int = 1) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def counter_contribution(value: float, sample_rate: float) -> int:
    """One counter sample's contribution, with the reference's double
    truncation (samplers/samplers.go:142-144)."""
    return int(value) * int(1.0 / sample_rate)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sync_on(t) -> None:
    """Wait for the work queued on ``t``'s device (a CPU tensor has
    none), or on each shard's device of a sharded array. Inside a
    guarded call it surfaces that work's CUDA errors."""
    for dev in {p.device for p in (t if isinstance(t, tuple) else (t,))}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _is_sharded(fields) -> bool:
    """Whether a tuple of pool arrays is series-sharded (each array a
    tuple of per-shard tensors) rather than plain tensors."""
    return isinstance(fields[0], tuple)


def _rows(a) -> int:
    """Pool rows of a tensor or a sharded array."""
    return (ss.SeriesSharding.rows_of(a) if isinstance(a, tuple)
            else int(a.shape[0]))


def _unguarded(op: str, fn, *args, retryable: bool = False, **kwargs):
    """DeviceGuard.call's signature without the guard: the failover
    engine's programs run on the CPU and are never injected into."""
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Device steps


def _comp_add(s, c, x):
    """Neumaier compensated add: (sum, compensation) += x, in f32. The
    true value is s + c, resolved at flush extraction. Every input and
    every intermediate result has its denormals flushed, as the
    reference's jitted steps run it on the CPU (XLA reads a denormal
    input as zero and flushes a denormal result)."""
    z = exn.flush_denormals
    s, c, x = z(s), z(c), z(x)
    t = z(s + x)
    # larger-magnitude operand is the residual's base; an overflow (t
    # infinite) drops the residual so the sum saturates like a bare add
    resid = torch.where(torch.abs(s) >= torch.abs(x), z(z(s - t) + x),
                        z(z(x - t) + s))
    resid = torch.where(torch.isfinite(t), resid, 0.0)
    return t, z(c + resid)


def _comp_adds(*triples):
    """``_comp_add`` of several (sum, compensation, addend) triples of one
    shape, stacked into one program (a quarter of the kernel launches of
    four calls); [(sum, compensation), ...] in their order."""
    s, c, x = (torch.stack(v) for v in zip(*triples))
    t, cc = _comp_add(s, c, x)
    return list(zip(t.unbind(0), cc.unbind(0)))


def _histo_ingest_rows(
    means, weights, dmin, dmax, drecip, drecip_c,
    lmin, lmax, lsum, lsum_c, lweight, lweight_c, lrecip, lrecip_c,
    active, lids, values, wts,
    compression: float = td.DEFAULT_COMPRESSION,
):
    """The new values of the active digest rows after one sample batch:
    gather, fold the batch in, and the sampler-local scalars of those
    rows. Reads the pool and writes none of it, so a fault here (an
    allocation that fails) leaves the pool as it was. Returns the update
    ``_write_ingest_rows`` lands: ``active`` and the rows' new values."""
    g_means = means[active]
    g_w = weights[active]
    g_min = dmin[active]
    g_max = dmax[active]
    g_recip = drecip[active]

    n_means, n_w, n_min, n_max, _, stats = td.add_batch(
        g_means, g_w, g_min, g_max, g_recip, lids, values, wts,
        compression=compression)
    ((n_recip, n_recip_c), (n_lsum, n_lsum_c), (n_lw, n_lw_c),
     (n_lr, n_lr_c)) = _comp_adds(
        (g_recip, drecip_c[active], stats.recip),
        (lsum[active], lsum_c[active], stats.sum),
        (lweight[active], lweight_c[active], stats.weight),
        (lrecip[active], lrecip_c[active], stats.recip))
    return (active, n_means, n_w, n_min, n_max, n_recip, n_recip_c,
            stats.min, stats.max, n_lsum, n_lsum_c, n_lw, n_lw_c, n_lr,
            n_lr_c)


def _write_ingest_rows(fields, update) -> None:
    """Land ``_histo_ingest_rows``'s update in the 14 pool tensors, in
    place. Idempotent: every write is an assignment of a computed value
    or a min/max, so writing an update again after a fault partway
    through gives the pool one write gives. `active` is padded with the
    scratch row; every duplicate writes an identical value, as in the
    reference's scatter."""
    (means, weights, dmin, dmax, drecip, drecip_c, lmin, lmax, lsum, lsum_c,
     lweight, lweight_c, lrecip, lrecip_c) = fields
    (active, n_means, n_w, n_min, n_max, n_recip, n_recip_c, s_min, s_max,
     n_lsum, n_lsum_c, n_lw, n_lw_c, n_lr, n_lr_c) = update
    means[active] = n_means
    weights[active] = n_w
    dmin[active] = n_min
    dmax[active] = n_max
    drecip[active] = n_recip
    drecip_c[active] = n_recip_c
    exn.scatter_amin_(lmin, active, s_min)
    exn.scatter_amax_(lmax, active, s_max)
    lsum[active] = n_lsum
    lsum_c[active] = n_lsum_c
    lweight[active] = n_lw
    lweight_c[active] = n_lw_c
    lrecip[active] = n_lr
    lrecip_c[active] = n_lr_c


def _histo_ingest_step(*args, compression: float = td.DEFAULT_COMPRESSION):
    """Gather the active digest rows, fold one sample batch in, scatter
    back; also updates the sampler-local scalars of those rows. Takes
    the 14 pool tensors, then active, lids, values and weights; updates
    the pool IN PLACE, every new value computed before the first write,
    and returns it."""
    fields = args[:14]
    _write_ingest_rows(fields, _histo_ingest_rows(
        *args, compression=compression))
    return fields


def _histo_import_rows(means, weights, dmin, dmax, drecip, drecip_c,
                       rows, imp_means, imp_w, imp_min, imp_max, imp_recip,
                       compression: float = td.DEFAULT_COMPRESSION):
    """The new values of the pool rows that imported digest rows [K, W]
    merge into (the global tier): gather, one compress over [K, C + W],
    min, max and the compensated recip. Reads the pool and writes none
    of it. Returns the update ``_write_import_rows`` lands."""
    z = exn.flush_denormals
    c = means.shape[1]
    n_means, n_w = td._compress_rows(
        torch.cat([means[rows], imp_means], dim=-1),
        torch.cat([weights[rows], imp_w], dim=-1), compression, c)
    n_min = z(exn.minimum(dmin[rows], imp_min))
    n_max = z(exn.maximum(dmax[rows], imp_max))
    n_recip, n_recip_c = _comp_add(drecip[rows], drecip_c[rows], imp_recip)
    return rows, n_means, n_w, n_min, n_max, n_recip, n_recip_c


def _write_import_rows(fields, update) -> None:
    """Land ``_histo_import_rows``'s update in the six pool tensors, in
    place. The rows are unique but for the padding, which points at the
    scratch row with an empty import, so every duplicate write carries
    the same value; the writes are assignments, so landing an update
    twice gives the pool one landing gives."""
    means, weights, dmin, dmax, drecip, drecip_c = fields
    rows, n_means, n_w, n_min, n_max, n_recip, n_recip_c = update
    means[rows] = n_means
    weights[rows] = n_w
    dmin[rows] = n_min
    dmax[rows] = n_max
    drecip[rows] = n_recip
    drecip_c[rows] = n_recip_c


def _histo_import_step(means, weights, dmin, dmax, drecip, drecip_c,
                       rows, imp_means, imp_w, imp_min, imp_max, imp_recip,
                       compression: float = td.DEFAULT_COMPRESSION):
    """Merge imported digest rows [K, W] into pool rows (global tier),
    the six pool tensors updated IN PLACE, every new value computed
    before the first write; returns them."""
    fields = (means, weights, dmin, dmax, drecip, drecip_c)
    _write_import_rows(fields, _histo_import_rows(
        *fields, rows, imp_means, imp_w, imp_min, imp_max, imp_recip,
        compression=compression))
    return fields


class StagedPlane(NamedTuple):
    """One raw-sample staging plane handed to the flush. Python plane:
    host arrays vals/wts [S, B] (empty slots weigh 0), counts and free
    None. Native plane: vals/wts [rows, B] alias C++ memory until
    ``free()``; counts [rows] per-row fills; wts None when every weight
    is 1.0. A native plane compacted for its upload is re-staged as its
    host copies: flat vals/wts and counts, free None."""

    vals: np.ndarray
    wts: Optional[np.ndarray]
    counts: Optional[np.ndarray] = None
    free: Optional[object] = None


def _free_staged_planes(planes) -> None:
    """Release the native memory of the planes not yet freed."""
    for p in planes or ():
        if p.free is not None:
            p.free()


def _compact_plane(vals, wts, counts, rows: int) -> StagedPlane:
    """A native plane's first ``rows`` rows as host copies: the filled
    slots row-major (flat values, and weights unless ``wts`` is None)
    and the per-row counts."""
    depth = vals.shape[1]
    counts_np = np.minimum(counts[:rows], depth).astype(np.int32)
    mask = np.arange(depth, dtype=np.int32)[None, :] < counts_np[:, None]
    flat_w = None if wts is None else wts[:rows][mask]
    return StagedPlane(vals[:rows][mask], flat_w, counts_np, None)


def _expand_flat_planes(flat_v, flat_w, counts, depth: int, unit: bool):
    """Rebuild the dense [S, depth] value+weight staging planes on the
    device from their row-major compaction (filled slots only) and
    per-row counts. unit=True ignores flat_w and uses the validity mask
    as the weights plane."""
    dev = flat_v.device
    b = torch.arange(depth, dtype=torch.int64, device=dev)[None, :]
    counts = counts.to(torch.int64)
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)[:-1]])
    idx = torch.clamp(offsets[:, None] + b, 0, flat_v.shape[0] - 1)
    valid = b < counts[:, None]
    sv = torch.where(valid, flat_v[idx], 0.0)
    if unit:
        sw = valid.to(torch.float32)
    else:
        sw = torch.where(valid, flat_w[idx], 0.0)
    return sv, sw


def _histo_fold_staged(
    means, weights, dmin, dmax, drecip, drecip_c,
    lmin, lmax, lsum, lsum_c, lweight, lweight_c, lrecip, lrecip_c,
    svals, swts,
    compression: float = td.DEFAULT_COMPRESSION,
):
    """Fold the staged raw-sample plane [S, B] into the digest pool: one
    compress over [S, C+B] per interval plus masked [S, B] tree sums for
    the scalar stats. Empty slots carry weight 0. Returns the 14 updated
    tensors (new tensors; the inputs may be dropped). The plain version
    of K3's fold (``fold_staged`` launches the kernel).

    Denormals as the reference's jitted fold meets them on the CPU: a
    denormal sample or weight reads as zero (so a denormal weight is not
    live), and every product, quotient, tree-sum level, min and max
    comes out flushed. The compress reads the raw plane and flushes it
    itself."""
    z = exn.flush_denormals
    c = means.shape[1]
    v, w = z(svals), z(swts)
    live = w > 0
    s_w = exn.tsum(w, flush=True)
    s_sum = exn.tsum(torch.where(live, z(v * w), 0.0), flush=True)
    s_recip = exn.tsum(torch.where(live, z(w / v), 0.0), flush=True)
    s_min = exn.amin(torch.where(live, v, _INF), dim=-1)
    s_max = exn.amax(torch.where(live, v, -_INF), dim=-1)

    cat_means = torch.cat([means, svals], dim=-1)
    cat_w = torch.cat([weights, swts], dim=-1)
    means, weights = td._compress_rows(cat_means, cat_w, compression, c)

    dmin = z(exn.minimum(dmin, s_min))
    dmax = z(exn.maximum(dmax, s_max))
    lmin = z(exn.minimum(lmin, s_min))
    lmax = z(exn.maximum(lmax, s_max))
    ((drecip, drecip_c), (lsum, lsum_c), (lweight, lweight_c),
     (lrecip, lrecip_c)) = _comp_adds(
        (drecip, drecip_c, s_recip), (lsum, lsum_c, s_sum),
        (lweight, lweight_c, s_w), (lrecip, lrecip_c, s_recip))
    return (means, weights, dmin, dmax, drecip, drecip_c,
            lmin, lmax, lsum, lsum_c, lweight, lweight_c, lrecip, lrecip_c)


class FlatStage(NamedTuple):
    """A compacted staged plane for the staged fold: the filled slots
    row-major on the fold's device (``vals``; ``wts``, or None when every
    weight is 1.0) and the per-row counts on the host (int [S], each at
    most ``depth``), as ``_compact_plane`` makes them."""

    vals: torch.Tensor
    wts: Optional[torch.Tensor]
    counts: np.ndarray
    depth: int


class DenseStage(NamedTuple):
    """A dense staged plane [R, B] on the fold's device, R at most the
    pool's rows; rows past R are empty (a mirror the directory outgrew)."""

    vals: torch.Tensor
    wts: torch.Tensor


def fold_staged(fields, stage, compression: float = td.DEFAULT_COMPRESSION):
    """Fold a staged plane (``FlatStage`` or ``DenseStage``) into the 14
    pool fields; returns the 14 new fields, the inputs untouched. On a
    CUDA pool K3 (ops/tdigest_kernel.fold_staged: one launch while C + B
    fits a warp's row), a flat plane's per-row offsets computed here on
    the host (int64 cumsum of the counts) and uploaded in place of the
    counts; on a CPU pool the plain chain, ``_expand_flat_planes`` (the
    counts as the reference takes them) or a zero pad of a short dense
    plane, then ``_histo_fold_staged``. ``fold_staged.launches`` counts
    the kernel's launches, nothing else."""
    means = fields[0]
    dev = means.device
    s = means.shape[0]
    flat = isinstance(stage, FlatStage)
    depth = stage.depth if flat else stage.vals.shape[1]
    if flat and len(stage.counts) != s:
        raise ValueError(f"{len(stage.counts)} staged counts for {s} rows")
    if not flat and (stage.vals.shape[0] > s
                     or stage.wts.shape != stage.vals.shape):
        raise ValueError("a dense staged plane has at most the pool's rows "
                         "and one weight a value")
    if dev.type == "cpu":
        return _fold_staged_plain(fields, stage, compression)
    table = exn._table(compression, dev)
    if flat:
        counts = np.asarray(stage.counts, np.int64)
        total = int(counts.sum())
        if total > stage.vals.shape[0] or total >= 1 << 31:
            raise ValueError(f"{total} staged samples in a flat plane of "
                             f"{stage.vals.shape[0]}")
        offsets = np.zeros(s, np.int32)
        np.cumsum(counts[:-1], out=offsets[1:], dtype=np.int64)
        out = tdigest_kernel.fold_staged(
            fields, stage.vals, stage.wts, _to_device(offsets, dev), total,
            depth, table)
    else:
        out = tdigest_kernel.fold_staged(
            fields, stage.vals, stage.wts, None, stage.vals.shape[0], depth,
            table)
    if s:
        fold_staged.launches += 1
    return out


fold_staged.launches = 0


def _fold_staged_plain(fields, stage, compression: float =
                       td.DEFAULT_COMPRESSION):
    """``fold_staged``'s plain chain on the plane's device: the dense
    [S, B] planes rebuilt from a flat plane (``_expand_flat_planes``,
    the counts uploaded as the reference takes them) or a short dense
    plane zero-padded, then ``_histo_fold_staged``."""
    s = fields[0].shape[0]
    if isinstance(stage, FlatStage):
        unit = stage.wts is None
        counts = _to_device(np.asarray(stage.counts, np.int32),
                            stage.vals.device)
        sv, sw = _expand_flat_planes(
            stage.vals, stage.vals if unit else stage.wts, counts,
            stage.depth, unit)
    else:
        sv = mf.mirror_dense(stage.vals, s)
        sw = mf.mirror_dense(stage.wts, s)
    return _histo_fold_staged(*fields, sv, sw, compression=compression)


# the reference's XLA extract and pack, as plain tensor ops; the worker
# runs the fused kernel instead (``_extract``), and these stay the
# readable statement of what that kernel computes
_histo_flush_extract = ek.histo_flush_extract
_pack_extract_columns = ek.pack_extract_columns


def _grow_2d(old, new_rows: int):
    s, c = old.shape
    out = torch.zeros((new_rows, c), dtype=old.dtype, device=old.device)
    out[:s] = old
    return out


def _grow_1d(old, new_rows: int, fill: float):
    out = torch.full((new_rows,), fill, dtype=old.dtype, device=old.device)
    out[:old.shape[0]] = old
    return out


# ---------------------------------------------------------------------------
# Host-side state containers


class ScalarPool:
    """Growable f64 value array + per-row metadata, rows in append order."""

    def __init__(self, initial: int = 256) -> None:
        self.index: dict = {}  # (key, class) → row
        self.meta: list = []  # (key, tags, scope_class, sinks)
        # packed per-row scope and admission codes, the flusher's masks
        self.scope_codes = array("b")
        self.routed_rows = 0
        self.admit_codes = array("b")
        self.rejected_rows = 0
        # incremental \x1e-joined wire-frag arena (see directory._Pool):
        # the native emit tier reads this buffer zero-copy at flush
        self.frag_arena = bytearray()
        self.frag_clean = True
        self.values = np.zeros(initial, np.float64)
        self.present = np.zeros(initial, bool)
        self.used = 0

    def frag_blob(self):
        return self.frag_arena if self.frag_clean else None

    def ensure(self, rows: int) -> None:
        if rows > len(self.values):
            cap = len(self.values)
            while cap < rows:
                cap *= 2
            self.values = np.resize(self.values, cap)
            self.values[self.used:] = 0.0
            newp = np.zeros(cap, bool)
            newp[: self.used] = self.present[: self.used]
            self.present = newp

    def upsert(self, key, scope_class, tags, sinks) -> int:
        k = (key, scope_class)
        row = self.index.get(k)
        if row is None:
            row = self.used
            self.index[k] = row
            self.adopt_row(row, key, tags, scope_class, sinks)
        return row

    def adopt_row(self, row: int, key, tags, scope_class, sinks,
                  frag=False, admitted=True) -> None:
        """Register metadata for a row assigned externally (native path).
        ``frag`` carries a prebuilt wire_frag (the worker's cross-epoch
        RowMeta cache); False = build here (the Python upsert path)."""
        assert row == len(self.meta), "rows must be adopted in order"
        self.meta.append((key, tags, scope_class, sinks))
        self.scope_codes.append(int(scope_class))
        self.admit_codes.append(1 if admitted else 0)
        if not admitted:
            self.rejected_rows += 1
        if sinks is not None:
            self.routed_rows += 1
        if self.frag_clean:
            if frag is False:
                frag = build_frag(getattr(key, "name", key), list(tags))
            if frag is None:
                self.frag_clean = False
            else:
                if row:
                    self.frag_arena += b"\x1e"
                self.frag_arena += frag
        # grow BEFORE bumping used: ensure() copies relative to used
        self.ensure(row + 1)
        self.used = row + 1


@dataclass
class HostScalars:
    """Exact host-side counter/gauge/status state for one interval."""

    counters: ScalarPool = field(default_factory=ScalarPool)
    gauges: ScalarPool = field(default_factory=ScalarPool)

    status_index: dict = field(default_factory=dict)
    status_meta: list = field(default_factory=list)
    status_values: list = field(default_factory=list)  # (value, msg, host)

    @property
    def counter_meta(self):
        return self.counters.meta

    @property
    def counter_values(self):
        return self.counters.values[: self.counters.used]

    @property
    def gauge_meta(self):
        return self.gauges.meta

    @property
    def gauge_values(self):
        return self.gauges.values[: self.gauges.used]


@dataclass
class HistoDeviceState:
    means: torch.Tensor
    weights: torch.Tensor
    dmin: torch.Tensor
    dmax: torch.Tensor
    drecip: torch.Tensor
    # compensation halves of the compensated-f32 accumulators (see
    # _comp_add); true value = base + _c, resolved at flush extract
    drecip_c: torch.Tensor
    lmin: torch.Tensor
    lmax: torch.Tensor
    lsum: torch.Tensor
    lsum_c: torch.Tensor
    lweight: torch.Tensor
    lweight_c: torch.Tensor
    lrecip: torch.Tensor
    lrecip_c: torch.Tensor

    @classmethod
    def create(cls, rows: int, capacity: int, device=None, shard=None
               ) -> "HistoDeviceState":
        """An empty state on ``device`` (none asked for: the card), or
        with ``shard`` (ops/series_shard.SeriesSharding) over its shards'
        devices, each field a sharded array."""
        if shard is not None:
            return cls(*shard.empty_pools(
                lambda cap, dev: cls.create(cap, capacity, dev).fields(),
                rows))
        device = resolve(device)
        # every field its own tensor: the ingest step updates in place
        pool = td.init_pool(rows, capacity, device=device)

        def _full(v):
            return torch.full((rows,), v, dtype=torch.float32,
                              device=device)

        return cls(
            means=pool.means, weights=pool.weights, dmin=pool.min,
            dmax=pool.max, drecip=pool.recip, drecip_c=_full(0.0),
            lmin=_full(_INF), lmax=_full(-_INF), lsum=_full(0.0),
            lsum_c=_full(0.0), lweight=_full(0.0), lweight_c=_full(0.0),
            lrecip=_full(0.0), lrecip_c=_full(0.0),
        )

    @classmethod
    def from_numpy(cls, fields, device) -> "HistoDeviceState":
        """The state from the JAX package's 14 arrays in
        ``HistoDeviceState.fields()`` order (copied, f32, on device)."""
        fields = list(fields)
        if len(fields) != 14:
            raise ValueError(f"expected 14 fields, got {len(fields)}")
        return cls(*(torch.from_numpy(np.array(a, np.float32, copy=True))
                     .to(device) for a in fields))

    @property
    def num_rows(self) -> int:
        return _rows(self.means)

    def fields(self) -> tuple:
        """The 14 tensors in the kernel argument order."""
        return (self.means, self.weights, self.dmin, self.dmax,
                self.drecip, self.drecip_c, self.lmin, self.lmax,
                self.lsum, self.lsum_c, self.lweight, self.lweight_c,
                self.lrecip, self.lrecip_c)

    def set_fields(self, fields) -> None:
        (self.means, self.weights, self.dmin, self.dmax, self.drecip,
         self.drecip_c, self.lmin, self.lmax, self.lsum, self.lsum_c,
         self.lweight, self.lweight_c, self.lrecip, self.lrecip_c) = fields

    def to(self, device) -> "HistoDeviceState":
        """The state copied to ``device`` (a copy-free view where it
        already lives there)."""
        return HistoDeviceState(*(t.to(device) for t in self.fields()))

    def grow(self, new_rows: int, shard=None) -> "HistoDeviceState":
        # zero-filled new mean rows are safe: every kernel keys empty
        # slots off weight == 0, never the stored mean. A sharded state
        # pads each shard's local block (ops/series_shard.grow_2d), which
        # keeps every logical row on its shard at its local index
        if isinstance(self.means, tuple):
            g2, g1 = shard.grow_2d, shard.grow_1d
        else:
            g2, g1 = _grow_2d, _grow_1d
        return HistoDeviceState(
            means=g2(self.means, new_rows),
            weights=g2(self.weights, new_rows),
            dmin=g1(self.dmin, new_rows, _INF),
            dmax=g1(self.dmax, new_rows, -_INF),
            drecip=g1(self.drecip, new_rows, 0.0),
            drecip_c=g1(self.drecip_c, new_rows, 0.0),
            lmin=g1(self.lmin, new_rows, _INF),
            lmax=g1(self.lmax, new_rows, -_INF),
            lsum=g1(self.lsum, new_rows, 0.0),
            lsum_c=g1(self.lsum_c, new_rows, 0.0),
            lweight=g1(self.lweight, new_rows, 0.0),
            lweight_c=g1(self.lweight_c, new_rows, 0.0),
            lrecip=g1(self.lrecip, new_rows, 0.0),
            lrecip_c=g1(self.lrecip_c, new_rows, 0.0),
        )


@dataclass
class FlushSnapshot:
    """Everything one interval produced, in host memory: the input to
    InterMetric generation (core/flusher.py). Field for field the
    reference's. ``degraded`` is True when some of the interval's device
    work ran on the CPU failover engine (a fault during the flush, or a
    quarantined epoch): bitwise the same numbers, flagged."""

    directory: SeriesDirectory
    scalars: HostScalars
    interval_s: float
    # histogram/timer extraction [rows in directory.histo order]:
    quantile_values: Optional[np.ndarray] = None  # [S, P]
    quantile_qs: Optional[np.ndarray] = None  # [P]
    dmin: Optional[np.ndarray] = None
    dmax: Optional[np.ndarray] = None
    dsum: Optional[np.ndarray] = None
    dcount: Optional[np.ndarray] = None
    drecip: Optional[np.ndarray] = None
    lmin: Optional[np.ndarray] = None
    lmax: Optional[np.ndarray] = None
    lsum: Optional[np.ndarray] = None
    lweight: Optional[np.ndarray] = None
    lrecip: Optional[np.ndarray] = None
    # raw digest rows (for forwarding):
    digest_means: Optional[np.ndarray] = None
    digest_weights: Optional[np.ndarray] = None
    # sets:
    set_estimates: Optional[np.ndarray] = None
    set_registers: Optional[np.ndarray] = None
    unique_timeseries_registers: Optional[np.ndarray] = None
    degraded: bool = False


@dataclass
class SwappedEpoch:
    """A closed interval's state, detached from the live worker by
    DeviceWorker.swap(); extract_snapshot() turns it into a
    FlushSnapshot. Field for field the reference's (the fields of
    features outside this slice stay None), and ``host``: the epoch
    closed quarantined, so its pools are the failover engine's.

    With micro-folds the staging plane travels as ``micro_residual``
    (the epoch's mirror and the COO deltas not yet fed to it, fed at
    extraction) and ``micro_replay`` (the plane's host content the
    mirror duplicates, folded on the CPU if the mirror's device state is
    lost to a fault); extraction turns the residual into
    ``device_stage``, the finished mirror."""

    directory: SeriesDirectory
    scalars: HostScalars
    histo: Optional[HistoDeviceState]
    sets: Optional[torch.Tensor]
    staged_sets: object
    umts: Optional[np.ndarray]
    mesh_out: Optional[dict]
    # raw-sample staging planes still unfolded at swap
    staged_histo: Optional[list] = None
    spill_histo: Optional[tuple] = None
    device_stage: Optional[object] = None
    micro_residual: Optional[tuple] = None
    reader_planes: Optional[list] = None
    micro_replay: Optional[object] = None
    host: bool = False


class DeviceWorker:
    """Batched aggregation engine for one shard of the metric space,
    running its device programs on ``device`` (CUDA unless asked)."""

    def __init__(
        self,
        batch_size: int = 16384,
        compression: float = td.DEFAULT_COMPRESSION,
        capacity: int = td.DEFAULT_CAPACITY,
        hll_precision: int = hll_ops.DEFAULT_PRECISION,
        initial_histo_rows: int = 1024,
        initial_set_rows: int = 256,
        count_unique_timeseries: bool = False,
        is_local: bool = True,
        set_hash: str = "fnv",
        set_store: str = "staged",
        stage_depth: int = 64,
        spill_cap: int = 1 << 22,
        micro_fold: bool = False,
        micro_fold_rows: int = 8192,
        micro_fold_max_age_s: float = 0.25,
        device_guard: bool = True,
        device_fault_streak: int = dg.DEFAULT_STREAK_LIMIT,
        device_probe_interval_s: float = dg.DEFAULT_PROBE_INTERVAL_S,
        series_shards: int = 0,
        shard_devices=None,
        device=None,
    ) -> None:
        self.device = resolve(device)
        if self.device.type == "cuda":
            # both kernel libraries build here: a broken build raises at
            # startup, never as a fault the guard would fail over
            ek.load()
            hll_kernel.load()
        self.batch_size = batch_size
        # native pending-batch bound; beyond it samples shed, counted in
        # overload_dropped (drop-don't-block under overload)
        self.spill_cap = spill_cap
        # raw-sample staging slots per digest row (B in the staged fold);
        # rows whose staged count reaches B spill through the direct fold
        self.stage_depth = stage_depth
        self.compression = compression
        self.capacity = capacity
        self.hll_precision = hll_precision
        self.set_hash = set_hash
        self._set_hash64 = metro_hash64 if set_hash == "metro" else hll_hash
        self._initial_histo_rows = initial_histo_rows
        self._initial_set_rows = initial_set_rows
        # the series-sharded pools (ops/series_shard.py), resolved through
        # the VENEUR_SERIES_SHARDS hatch; a request that cannot be honored
        # (not a power of two, fewer devices) runs unsharded, logged, as
        # the reference's does. On the CPU the shards share the CPU; on
        # the card they take the first D cards unless ``shard_devices``
        # names them (a list may repeat a card)
        shards = ss.resolve_series_shards(series_shards)
        self._shard: Optional[ss.SeriesSharding] = None
        if shards > 1:
            if ss.shards_usable(shards, self.device, shard_devices):
                devs = shard_devices
                if devs is None and self.device.type == "cpu":
                    devs = [self.device] * shards
                self._shard = ss.SeriesSharding(shards, compression,
                                                devices=devs)
                # pool row counts stay pow2 multiples of the shard count
                # so every growth and slice divides evenly
                self._initial_histo_rows = _next_pow2(
                    max(initial_histo_rows, shards))
                self._initial_set_rows = _next_pow2(
                    max(initial_set_rows, shards))
            else:
                log.warning(
                    "series_shards=%d unusable (need a power of two <= the "
                    "device count); using the single-device pool", shards)
        self.series_shards = self._shard.shards if self._shard else 1
        # the dense set pool's per-shard inserters
        self._shard_inserters = (
            [hll_ops.HostInserter() for _ in range(self._shard.shards)]
            if self._shard is not None else None)
        # the global tier's mesh pool (attach_mesh_pool)
        self._mesh_pool = None
        self.count_unique_timeseries = count_unique_timeseries
        self.is_local = is_local
        self.set_store = set_store
        # the C++ context (attach_native); None keeps the Python path
        self._native = None
        # shared-nothing reader shards (attach_reader_shards): one more
        # native context per reader thread, each with its own directory,
        # staging plane and spill epoch. Empty: the legacy single-context
        # path everywhere
        self._reader_ctxs: list = []
        # per-reader-context rebasing baselines (the home context keeps
        # the _native_*_seen fields)
        self._reader_errs_seen: list[int] = []
        self._reader_proc_seen: list[int] = []
        self._reader_drop_seen: list[int] = []
        # lifetime per-context attribution, [home] + one per reader shard:
        # samples committed (counted at swap's fence) and samples shed at
        # that context's spill caps
        self.reader_committed: list[int] = []
        self.reader_dropped: list[int] = []
        # digests, counters, gauges and set rows merged from downstream
        # instances this epoch (the global tier's import surface)
        self.imported = 0
        self._native_epoch_closed = False
        self._native_errs_seen = 0
        self._native_proc_seen = 0
        self._native_drop_seen = 0
        # Python-path samples this epoch (``processed`` adds the native
        # contexts' own counts)
        self._processed_py = 0
        self.processed_total = 0
        # native parse errors drained so far (reset per process)
        self.parse_errors = 0
        # overload shedding: per interval (the server's telemetry resets
        # it) and lifetime
        self.overload_dropped = 0
        self.overload_dropped_total = 0
        # seconds of spill-fold work one flush may inherit, and the
        # measured fold rate (samples/s) that turns it into samples:
        # backlog past it sheds at swap, counted
        self.fold_budget_s: float = 5.0
        self._fold_rate_ewma: float = 1e6
        # event and service-check lines the C++ parser handed back at
        # epoch close; the server parses them into the next epoch
        self.pending_other_lines: list[bytes] = []
        # SSF payloads the C++ SSF reader handed back (STATUS samples
        # aboard) and caught at epoch close; the server sends them through
        # its Python span path
        self.pending_ssf_fallback: list[bytes] = []
        # cross-epoch series metadata (_sync_native_series): the same
        # series re-register every interval, so RowMeta is built once per
        # series lifetime
        self._adopt_cache: dict = {}
        # bytes of the last flush's staging-plane uploads
        self.last_plane_upload_bytes = 0
        # wall seconds of the last extract_snapshot's staged fold, packed
        # extract (+ readback) and set estimates (+ readbacks), each ended
        # by a device sync
        self.last_extract_phases: dict[str, float] = {}
        # the dense set pool's uploads (its pinned buffers outlive epochs)
        self._set_inserter = hll_ops.HostInserter()
        # micro-folds (ops/microfold.py): a scheduler calls
        # micro_fold_once() whenever micro_fold_rows samples are staged or
        # the oldest is micro_fold_max_age_s old, streaming the staging
        # plane to a device mirror during the interval
        self.micro_fold = bool(micro_fold)
        self.micro_fold_rows = int(micro_fold_rows)
        self.micro_fold_max_age_s = float(micro_fold_max_age_s)
        self._micro: Optional[mf.MicroFoldMirror] = None
        self._micro_last_drain = time.monotonic()
        # drains: lifetime, this epoch, the epoch the last swap closed
        self.micro_folds_total = 0
        self.micro_folds_epoch = 0
        self.micro_folds_swapped = 0
        # host seconds the last swap spent on the residual drain and the
        # mirror handoff (the flush's drain_s phase)
        self.micro_drain_swapped_s = 0.0
        # the last extract_snapshot's mirror: upload chunks and bytes
        self.last_micro_chunks = 0
        self.last_micro_bytes = 0
        # the device fault domain (ops/device_guard.py): one breaker over
        # every device entry point. While quarantined (_host_live) the
        # live pools are CPU tensors the same programs run on;
        # device_guard_tick(), run by the server after each extraction
        # under the ingest lock, quarantines, probes and re-admits.
        self.guard = dg.DeviceGuard(
            streak_limit=device_fault_streak,
            probe_interval_s=device_probe_interval_s,
            enabled=bool(device_guard) and dg.guard_enabled_default())
        self._host_live = False
        # a fault voided this epoch's mirror: the staging plane keeps
        # every sample and the epoch folds it as if micro-folds were off
        self._micro_fault_epoch = False
        # flushes that ran some of their device work on the CPU
        self.host_fallback_flushes = 0
        # the flush governor (health/governor.py), set by the server:
        # chunked extraction with flush_chunk_target_ms, progress beats,
        # per-tenant shed attribution
        self.governor = None
        # flush-path transfer bytes by kind (health/ledger.py), one window
        # an extraction
        self.ledger = TransferLedger()
        # per-tenant QoS (core/tenancy.py), installed by the server when
        # budgets are configured; None keeps every tenant path dormant.
        # The ledger is shared across workers (admission is a host-wide
        # decision: a tenant's series spread across workers by digest)
        self.tenancy = None
        self.tenant_sketch = None
        # the live query view (veneur_tpu_torch/query/): with a publisher
        # wired, extract_snapshot hands it the epoch's snapshot, a device
        # evaluator over the retained post-fold fields and a fenced sketch
        # view; the server commits every worker's view as one epoch. None
        # retains nothing
        self.query_publisher = None
        self.query_epoch_seq = 0
        # per-epoch and lifetime per-tenant sample tallies; the epoch's
        # fold into the totals at the swap (the processed_total pattern)
        self.tenant_tallies = TenantTallies()
        self.tenant_tallies_total = TenantTallies()
        self._reset_epoch()

    def attach_mesh_pool(self, pool) -> None:
        """Shard histogram state over a device mesh
        (distributed/mesh.MeshHistoPool): raw samples and imported
        centroids route to the mesh instead of the local pool, and the
        cross-host merge runs at the swap. For the global tier
        (tpu_mesh_devices); mixed-scope rows' local aggregates are not
        tracked on the mesh path (a global emits digest values)."""
        if self._shard is not None:
            # the mesh owns its own layout: rows routed into both would
            # split series state (config validation refuses the pair;
            # this covers direct construction)
            log.warning("series sharding disabled: mesh pool attached "
                        "(tpu_mesh_devices and series_shards are exclusive)")
            self._shard = None
            self._shard_inserters = None
            self.series_shards = 1
            self._reset_epoch_sets()
        self._mesh_pool = pool
        if self._native is not None:
            # staging would divert samples from the mesh pool
            self._native.set_stage_depth(0)

    @property
    def processed(self) -> int:
        """Samples accepted this epoch, the native context's (committed
        off the Python path) included."""
        n = self._processed_py
        if self._native is not None:
            n += int(self._native.processed) - self._native_proc_seen
        for i, ctx in enumerate(self._reader_ctxs):
            n += int(ctx.processed) - self._reader_proc_seen[i]
        return n

    def _reset_epoch(self) -> None:
        if self._native_epoch_closed:
            # swap reset the context with its last drain; resetting again
            # would destroy what readers committed since
            self._native_epoch_closed = False
        else:
            if self._native is not None:
                self._native.reset()
            self._native_errs_seen = 0
            self._native_proc_seen = 0
            self._native_drop_seen = 0
            for i, ctx in enumerate(self._reader_ctxs):
                ctx.reset()
                self._reader_errs_seen[i] = 0
                self._reader_proc_seen[i] = 0
                self._reader_drop_seen[i] = 0
        # per-context local-row -> canonical-row maps, one int32 array per
        # pool kind (histo, set, counter, gauge), [home] + readers; rebuilt
        # every epoch (context resets restart local rows at 0)
        self._ctx_maps = [tuple(array("i") for _ in range(4))
                          for _ in range(1 + len(self._reader_ctxs))]
        self._processed_py = 0
        # the swap folded the epoch's tallies into the lifetime totals
        # before this reset
        self.tenant_tallies.reset()
        self.directory = SeriesDirectory()
        self.scalars = HostScalars()
        self._micro_fault_epoch = False
        self._histo: Optional[HistoDeviceState] = None
        self._reset_epoch_sets()
        # host raw-sample staging planes (see _device_histo_step)
        self._stage_vals: Optional[np.ndarray] = None
        self._stage_wts: Optional[np.ndarray] = None
        self._stage_count: Optional[np.ndarray] = None
        # micro-fold watermark of the Python plane: slots
        # [mark[r], count[r]) are staged but not yet mirrored
        self._ustage_mark: Optional[np.ndarray] = None
        self.micro_folds_epoch = 0
        self._micro_last_drain = time.monotonic()
        # pending SoA buffers (host)
        self._ph_rows: list[int] = []
        self._ph_vals: list[float] = []
        self._ph_wts: list[float] = []
        self._ps_rows: list[int] = []
        self._ps_idx: list[int] = []
        self._ps_rank: list[int] = []
        # spill batches whose device fold faulted, oldest first
        self._fold_queue: list[tuple] = []
        # import buffers (global tier), merged at swap
        self._imp_digests: dict[int, list] = {}
        self._imp_hll: dict[int, np.ndarray] = {}
        # unique-timeseries HLL registers (host, tiny)
        m = hll_ops.num_registers(self.hll_precision)
        self._umts = (np.zeros(m, dtype=np.int8)
                      if self.count_unique_timeseries else None)

    def _reset_epoch_sets(self) -> None:
        # dense set pool (set_store="dense"); the staged store (the
        # default) keeps its own dense tier
        self._sets = None
        self._staged_sets = (StagedSetStore(self.hll_precision,
                                            device=self.device,
                                            guard=self.guard,
                                            host=self._host_live,
                                            shard=self._shard)
                             if self.set_store == "staged" else None)

    @property
    def _live_device(self) -> torch.device:
        """Where the live epoch's pools are: the CPU while quarantined."""
        return torch.device("cpu") if self._host_live else self.device

    def _ensure_histo(self, needed_rows: int) -> None:
        # a tripped breaker fails the live epoch over before any pool is
        # made or grown on the failing device
        if self.guard.quarantined and not self._host_live:
            self._quarantine_live()
        # keep one scratch row free at the top for gather/scatter padding
        # (sharded, the scratch row — logical S-1 — is physical S-1, shard
        # D-1's last local row, so the sizing is the same)
        if self._histo is None:
            rows = _next_pow2(needed_rows + 1, self._initial_histo_rows)
            self._histo = HistoDeviceState.create(
                rows, self.capacity, self._live_device,
                shard=None if self._host_live else self._shard)
            return
        if needed_rows + 1 <= self._histo.num_rows:
            return
        self._flush_pending_histos()  # pending lids reference old layout
        new_rows = _next_pow2(needed_rows + 1, self._histo.num_rows * 2)
        if self._host_live:
            self._histo = self._histo.grow(new_rows)
            return
        # HBM valve: growth holds the old pool and the new one at once.
        # A throwaway allocation of the new means+weights pre-flights it,
        # so an OOM is a clean fault with the old pool untouched; it trips
        # the breaker at once and the epoch grows and goes on on the CPU.
        try:
            if (self.guard.enabled and new_rows * self.capacity * 12
                    >= _GROW_PREFLIGHT_MIN_BYTES):
                self.guard.call("grow", self._grow_preflight, new_rows,
                                retryable=True)
            self._histo = self.guard.call("grow", self._histo.grow,
                                          new_rows, shard=self._shard)
        except dg.DeviceFaultError as exc:
            self.guard.bump("device.valve.grow_oom")
            self.guard.trip(f"pool growth to {new_rows} rows faulted "
                            f"[{exc.kind}]: HBM valve")
            self._quarantine_live()
            self._histo = self._histo.grow(new_rows)

    def _grow_preflight(self, new_rows: int) -> None:
        if isinstance(self._histo.means, tuple):
            d = self._shard.shards
            probes = [torch.empty((new_rows // d, 2 * self.capacity),
                                  dtype=torch.float32, device=dev)
                      for dev in self._shard.devices]
            del probes
            return
        probe = torch.empty((new_rows, 2 * self.capacity),
                            dtype=torch.float32, device=self.device)
        del probe

    def _sets_on_host(self) -> bool:
        """The dense set pool runs on the failover engine: the live epoch
        is quarantined, or a set fault moved the pool to the CPU on its
        own (a CPU worker's unsharded pool has nowhere to move; a sharded
        pool moves to one logical CPU tensor)."""
        s = self._sets
        return self._host_live or (
            s is not None and not isinstance(s, tuple)
            and (self._shard is not None
                 or s.device.type != self.device.type))

    def _ensure_sets(self, needed_rows: int) -> None:
        if self.guard.quarantined and not self._host_live:
            self._quarantine_live()
        if self._staged_sets is not None:
            return  # the staged store sizes itself
        # one scratch row at the top pads the insert batches
        p = self.hll_precision
        if self._sets is None:
            rows = _next_pow2(needed_rows + 1, self._initial_set_rows)
            if self._shard is not None and not self._host_live:
                self._sets = self._shard.empty_pools(
                    lambda cap, dev: (hll_ops.init_pool(cap, p, dev),),
                    rows)[0]
            else:
                self._sets = hll_ops.init_pool(rows, p, self._live_device)
            return
        if needed_rows + 1 <= _rows(self._sets):
            return
        self._flush_pending_sets()  # pending rows use the old scratch
        new_rows = _next_pow2(needed_rows + 1, _rows(self._sets) * 2)
        if self._sets_on_host():
            self._sets = _grow_2d(self._sets, new_rows)
            return
        grow = (self._shard.grow_2d if isinstance(self._sets, tuple)
                else _grow_2d)
        try:
            self._sets = self.guard.call("grow", grow, self._sets,
                                         new_rows)
        except dg.DeviceFaultError as exc:
            self.guard.trip(f"set pool growth to {new_rows} rows faulted "
                            f"[{exc.kind}]")
            self._quarantine_live()
            self._sets = _grow_2d(self._sets, new_rows)

    # -- ingest -------------------------------------------------------------

    def process_metric(self, m: UDPMetric) -> None:
        """Route one parsed sample into the right pool
        (reference Worker.ProcessMetric, worker.go:344-394)."""
        self._processed_py += 1
        mtype = m.key.type
        scope_class = classify(mtype, m.scope)
        tenant = ""
        if self.tenancy is not None:
            # budgeted admission (core/tenancy.py): a sample for a series
            # the ledger refuses is rejected here, before any row exists;
            # admitted series always pass (the ledger is idempotent).
            # Status checks are never budgeted
            tenant = tenant_of(m.tags, self.tenancy.tag_key)
            tt = self.tenant_tallies
            tt.accepted[tenant] = tt.accepted.get(tenant, 0) + 1
            # reader-shard mode takes this branch too: its Python-path
            # series live in the Python pools (the canonical row space)
            if ((self._native is None or self._reader_ctxs)
                    and mtype != "status"):
                if not self._admit_sample(tenant, m.key, scope_class,
                                          mtype):
                    tt.rejected[tenant] = tt.rejected.get(tenant, 0) + 1
                    return
                tt.kept[tenant] = tt.kept.get(tenant, 0) + 1
        if self._umts is not None and self._should_count_timeseries(
                mtype, scope_class):
            self._insert_timeseries(m.digest)
        if mtype == "counter":
            self._host_counter(m.key, scope_class, m.tags,
                               counter_contribution(m.value, m.sample_rate))
        elif mtype == "gauge":
            self._host_gauge(m.key, scope_class, m.tags, float(m.value))
        elif mtype in ("histogram", "timer"):
            row = self._upsert_histo(m.key, scope_class, m.tags, tenant)
            if self._mesh_pool is not None:
                self._mesh_pool.add_sample(row, float(m.value),
                                           1.0 / m.sample_rate,
                                           host_slot=m.digest)
                return
            self._ensure_histo(max(self.directory.num_histo_rows, row + 1))
            self._ph_rows.append(row)
            self._ph_vals.append(float(m.value))
            self._ph_wts.append(1.0 / m.sample_rate)
            if len(self._ph_rows) >= self.batch_size:
                self._flush_pending_histos()
        elif mtype == "set":
            row = self._upsert_set(m.key, scope_class, m.tags, tenant)
            self._ensure_sets(max(self.directory.num_set_rows, row + 1))
            h = self._set_hash64(str(m.value).encode("utf-8"))
            idx, rank = hll_ops.split_hashes(
                np.array([h], dtype=np.uint64), self.hll_precision)
            self._ps_rows.append(row)
            self._ps_idx.append(int(idx[0]))
            self._ps_rank.append(int(rank[0]))
            if len(self._ps_rows) >= self.batch_size:
                self._flush_pending_sets()
        elif mtype == "status":
            self._host_status(m)

    def _admit_sample(self, tenant: str, key: MetricKey,
                      scope_class: ScopeClass, mtype: str) -> bool:
        """Python-path budget gate: a series already rowed this epoch was
        admitted (refused series never get rows here); otherwise ask the
        shared ledger, which is free for admitted series and takes budget
        only for new ones."""
        if mtype in ("histogram", "timer"):
            index = self.directory.histo.index
        elif mtype == "set":
            index = self.directory.sets.index
        elif mtype == "counter":
            index = self.scalars.counters.index
        else:
            index = self.scalars.gauges.index
        if (key, scope_class) in index:
            return True
        return self.tenancy.admit(tenant, _series_budget_id(scope_class, key))

    def _upsert_histo(self, key: MetricKey, scope_class: ScopeClass,
                      tags: list[str], tenant: str = "") -> int:
        # in reader-shard mode the canonical row space is the Python
        # directory: a native upsert would hand back a context-local row
        if self._native is not None and not self._reader_ctxs:
            # the native directory assigns the row; its metadata is
            # adopted in batches (every 1,024 new series, and always
            # before extraction: swap's drain syncs)
            row = self._native.upsert(key.name, key.type, key.joined_tags,
                                      int(scope_class))
            if self._native.pending_new_series >= 1024:
                self.sync_native_series()
            return row
        row, _ = self.directory.upsert_histo(key, scope_class, tags,
                                             tenant=tenant)
        return row

    def _upsert_set(self, key: MetricKey, scope_class: ScopeClass,
                    tags: list[str], tenant: str = "") -> int:
        if self._native is not None and not self._reader_ctxs:
            row = self._native.upsert(key.name, "set", key.joined_tags,
                                      int(scope_class))
            if self._native.pending_new_series >= 1024:
                self.sync_native_series()
            return row
        row, _ = self.directory.upsert_set(key, scope_class, tags,
                                           tenant=tenant)
        return row

    def _should_count_timeseries(self, mtype: str, cls: ScopeClass) -> bool:
        """Forwarding-aware unique-timeseries gating (reference
        SampleTimeseries, worker.go:300-341): a local instance skips series
        it forwards upstream (the global instance counts those)."""
        if not self.is_local:
            return True
        if mtype in ("counter", "gauge"):
            return cls != ScopeClass.GLOBAL
        if mtype in ("histogram", "set", "timer"):
            return cls == ScopeClass.LOCAL
        return True

    def _insert_timeseries(self, digest: int) -> None:
        idx, rank = hll_ops.split_hashes(
            np.array([fmix64(digest)], dtype=np.uint64), self.hll_precision)
        self._umts[idx[0]] = max(self._umts[idx[0]], rank[0])

    def _sample_timeseries_key(self, name: str, mtype: str, joined: str,
                               cls: ScopeClass) -> None:
        """Native-path unique-timeseries sampling, once per new series
        (the insert is idempotent, so it agrees with per-sample
        feeding)."""
        if self._umts is not None and self._should_count_timeseries(mtype,
                                                                    cls):
            self._insert_timeseries(metric_digest(name, mtype, joined))

    def _host_counter(self, key: MetricKey, scope_class: ScopeClass,
                      tags: list[str], contribution: int) -> None:
        pool = self.scalars.counters
        if self._native is not None and not self._reader_ctxs:
            row = self._native.upsert(key.name, "counter", key.joined_tags,
                                      int(scope_class))
            self.sync_native_series()
        else:
            row = pool.upsert(key, scope_class, tags, route_info(tags))
        pool.values[row] += contribution
        pool.present[row] = True

    def _host_gauge(self, key: MetricKey, scope_class: ScopeClass,
                    tags: list[str], value: float) -> None:
        pool = self.scalars.gauges
        if self._native is not None and not self._reader_ctxs:
            row = self._native.upsert(key.name, "gauge", key.joined_tags,
                                      int(scope_class))
            self.sync_native_series()
        else:
            row = pool.upsert(key, scope_class, tags, route_info(tags))
        pool.values[row] = value
        pool.present[row] = True

    def _host_status(self, m: UDPMetric) -> None:
        sc = self.scalars
        k = (m.key, ScopeClass.LOCAL)
        row = sc.status_index.get(k)
        if row is None:
            row = len(sc.status_values)
            sc.status_index[k] = row
            sc.status_meta.append(
                (m.key, m.tags, ScopeClass.LOCAL, route_info(m.tags)))
            sc.status_values.append(None)
        sc.status_values[row] = (float(m.value), m.message, m.hostname)

    # -- native front-end ---------------------------------------------------

    def attach_native(self) -> bool:
        """Attach the C++ ingest pipeline (native/dogstatsd.cpp through
        veneur_tpu_torch/native.py): parsing, tag normalization, row
        assignment and raw-sample staging leave the Python path. Builds
        the library at first use and raises if it cannot: the worker
        never falls back to the Python parser behind its caller's back.
        Returns True (the reference's signature)."""
        from veneur_tpu_torch.native import NativeIngest

        self._native = NativeIngest(self.hll_precision,
                                    set_hash=self.set_hash)
        if self._mesh_pool is None and self.stage_depth > 0:
            self._native.set_stage_depth(self.stage_depth)
        if self.spill_cap:
            self._native.set_spill_cap(self.spill_cap)
        return True

    def attach_reader_shards(self, n: int) -> bool:
        """Shared-nothing multi-reader ingest: give each of ``n`` reader
        threads its OWN native context (directory, staging plane, spill
        epoch), so the commit path takes no shared mutex; a context's
        lock is held only at swap's fence and the drains.

        Series identity becomes (reader, local row), reconciled into
        this worker's canonical Python directory at the series sync
        (each context's local rows map to canonical rows); the flush
        folds every reader's plane as ONE stacked batch
        (ops/reader_stack.py), so downstream sees what the legacy
        digest-routed path produces. Needs an attached home context
        (attach_native). Returns False (the legacy path keeps working)
        when it is missing; True once attached."""
        if n < 1 or self._reader_ctxs:
            return bool(self._reader_ctxs)
        if self._native is None or self._mesh_pool is not None:
            return False
        from veneur_tpu_torch.native import NativeIngest

        ctxs = []
        for _ in range(n):
            ctx = NativeIngest(self.hll_precision, set_hash=self.set_hash)
            if self.stage_depth > 0:
                ctx.set_stage_depth(self.stage_depth)
            if self.spill_cap:
                ctx.set_spill_cap(self.spill_cap)
            ctxs.append(ctx)
        self._reader_ctxs = ctxs
        self._reader_errs_seen = [0] * n
        self._reader_proc_seen = [0] * n
        self._reader_drop_seen = [0] * n
        self.reader_committed = [0] * (n + 1)
        self.reader_dropped = [0] * (n + 1)
        # the maps were sized for zero reader contexts at construction
        self._ctx_maps = [tuple(array("i") for _ in range(4))
                          for _ in range(n + 1)]
        return True

    def _all_ctxs(self) -> list:
        """[home context] + reader-shard contexts: the order every
        reconciliation structure is indexed by."""
        return [self._native] + self._reader_ctxs

    def ingest_datagram(self, datagram: bytes) -> int:
        """Native-path ingest of one (possibly multi-line) datagram; drains
        when the spill or set batch reaches batch_size. Event and
        service-check lines wait in the context for the caller's
        drain_other."""
        n = self._native.ingest(datagram)
        if (self._native.pending_histo >= self.batch_size
                or self._native.pending_set >= self.batch_size):
            self.drain_native()
        return n

    def ingest_ssf_packet(self, packet: bytes, indicator_name: bytes,
                          objective_name: bytes,
                          uniqueness_rate: float = 0.0) -> int:
        """Native-path SSF span ingest (decode and span->metric
        extraction in C++). The rc of ``vn_ingest_ssf``: 1 ok, 0 a decode
        error, -1 the caller takes the Python path (STATUS samples
        aboard)."""
        rc = self._native.ingest_ssf(packet, indicator_name, objective_name,
                                     uniqueness_rate)
        if rc == 1:
            self._processed_py += 1
            if (self._native.pending_histo >= self.batch_size
                    or self._native.pending_set >= self.batch_size):
                self.drain_native()
        return rc

    def _scalar_upsert_meta(self, pool: ScalarPool, meta: RowMeta) -> int:
        """ScalarPool twin of the directory's upsert_meta: dedup by (key,
        class), adopting a row only for a new series."""
        k = (meta.key, meta.scope_class)
        row = pool.index.get(k)
        if row is not None:
            return row
        row = len(pool.meta)
        pool.index[k] = row
        pool.adopt_row(row, meta.key, meta.tags, meta.scope_class,
                       meta.sinks, frag=meta.wire_frag(),
                       admitted=meta.admitted)
        return row

    def _sync_native_series(self, ctx=None, ctx_i: int = 0) -> None:
        """Adopt a context's new-series records into the directory and
        the scalar pools. Legacy mode: at the rows the context assigned
        (in order). Reader-shard mode: each context's rows are LOCAL, so
        each record is reconciled into the canonical directory (the same
        series through several readers shares one row) and its canonical
        row appended to the context's map. Caller holds the context
        lock."""
        from veneur_tpu_torch.native import NativeIngest

        if ctx is None:
            ctx = self._native
        if not ctx.pending_new_series:
            return
        shard_maps = self._ctx_maps[ctx_i] if self._reader_ctxs else None
        cache = self._adopt_cache
        for pool, row, kind, scope, name, joined in ctx.drain_new_series():
            ck = (pool, kind, scope, name, joined)
            meta = cache.get(ck)
            if meta is None:
                key = MetricKey(name=name, type=NativeIngest.TYPE_BY_KIND[kind],
                                joined_tags=joined)
                tags = joined.split(",") if joined else []
                tenant = ""
                admitted = True
                if self.tenancy is not None:
                    # the native budget gate: C++ already assigned the
                    # row, so a refused series keeps it, marked
                    # admitted=False (the flusher skips it); the decision
                    # caches with the RowMeta (admission is per series
                    # lifetime)
                    tenant = tenant_of(tags, self.tenancy.tag_key)
                    admitted = self.tenancy.admit(
                        tenant, _series_budget_id(ScopeClass(scope), key))
                meta = RowMeta(key=key, tags=tags,
                               scope_class=ScopeClass(scope),
                               sinks=route_info(tags),
                               tenant=tenant, admitted=admitted)
                if len(cache) >= 4_000_000:
                    # unbounded series churn: drop the cache rather than
                    # grow without limit
                    cache.clear()
                cache[ck] = meta
            if self.count_unique_timeseries:
                self._sample_timeseries_key(name, meta.key.type, joined,
                                            meta.scope_class)
            if shard_maps is not None:
                arr = shard_maps[pool]
                if row != len(arr):
                    raise RuntimeError(
                        "reader-shard series must drain in row order")
                if pool == 0:
                    crow, _ = self.directory.histo.upsert_meta(meta)
                elif pool == 1:
                    crow, _ = self.directory.sets.upsert_meta(meta)
                else:
                    crow = self._scalar_upsert_meta(
                        self.scalars.counters if pool == 2
                        else self.scalars.gauges, meta)
                arr.append(crow)
            elif pool == 0:
                self.directory.histo.adopt_meta(row, meta)
            elif pool == 1:
                self.directory.sets.adopt_meta(row, meta)
            else:
                scalars = (self.scalars.counters if pool == 2
                           else self.scalars.gauges)
                scalars.adopt_row(row, meta.key, meta.tags,
                                  meta.scope_class, meta.sinks,
                                  frag=meta.wire_frag(),
                                  admitted=meta.admitted)

    def sync_native_series(self) -> None:
        """Adopt pending new-series registrations mid-epoch, so swap only
        adopts the tail. Caller holds the worker lock; takes the context
        lock itself."""
        if self._native is None:
            return
        for i, ctx in enumerate(self._all_ctxs()):
            with ctx.hold():
                self._sync_native_series(ctx, i)

    def native_series_pending(self) -> bool:
        """Lock-free probe for undrained new-series records in any
        native context."""
        return self._native is not None and any(
            ctx.pending_new_series for ctx in self._all_ctxs())

    def drain_native(self) -> None:
        """Move everything pending in the native pipeline into device and
        host state. The context lock is held across the raw drain, so a
        reader thread's commit cannot land between its calls; the device
        work runs after it is released."""
        if self._native is None:
            return
        # each context's lock is held only for its own drain (reader-shard
        # mode: the shared-nothing shape extends to the drain); its rows
        # then translate to canonical rows (identity in legacy mode)
        for i, ctx in enumerate(self._all_ctxs()):
            with ctx.hold():
                raw = self._drain_native_raw_ctx(ctx, i)
            self._apply_native_raw(self._map_raw_rows(i, raw))

    def _map_raw_rows(self, ctx_i: int, raw):
        """One context's drained batches with their LOCAL rows translated
        to canonical rows through the maps built at series sync (samples
        drain after their series record, so every row has an entry).
        Identity in legacy mode."""
        if not self._reader_ctxs:
            return raw
        h, s, c, g, st, others, ssf_fb = raw
        maps = self._ctx_maps[ctx_i]

        def translate(pool_i: int, rows):
            return np.frombuffer(maps[pool_i], dtype=np.int32)[rows]

        if h is not None and len(h[0]):
            h = (translate(0, h[0]), h[1], h[2])
        if s is not None and len(s[0]):
            s = (translate(1, s[0]), s[1], s[2])
        rows, contribs = c
        if len(rows):
            c = (translate(2, rows), contribs)
        rows, vals = g
        if len(rows):
            g = (translate(3, rows), vals)
        return h, s, c, g, st, others, ssf_fb

    def native_rows_canonical(self, rows, kinds, sel):
        """Translate rows handed back by the home context's batched
        upsert (native.upsert_many, the import wire path) to canonical
        rows. Identity on the legacy path; in reader-shard mode through
        the home context's map (the caller synced new series first)."""
        if not self._reader_ctxs:
            return rows
        maps = self._ctx_maps[0]
        out = np.asarray(rows).copy()
        for pool_i, kmask in ((0, (kinds == 2) | (kinds == 3)),
                              (1, kinds == 4),
                              (2, kinds == 0),
                              (3, kinds == 1)):
            m = sel & kmask
            if m.any():
                lookup = np.frombuffer(maps[pool_i], dtype=np.int32)
                out[m] = lookup[out[m]]
        return out

    def reader_stats(self, lock_stats: bool = False) -> dict:
        """Per-context ingest attribution, [home] + reader shards:
        samples committed and shed. ``lock_stats`` also reads each
        context's commit-mutex record (recorded while the library's
        lock timing is on)."""
        out = {
            "shards": len(self._reader_ctxs),
            "committed": list(self.reader_committed),
            "dropped": list(self.reader_dropped),
        }
        if lock_stats and self._native is not None:
            def pct(sorted_ns, q):
                if not sorted_ns:
                    return 0
                return sorted_ns[min(len(sorted_ns) - 1,
                                     int(q * len(sorted_ns)))]

            locks = []
            for ctx in self._all_ctxs():
                st = ctx.lock_stats()
                acq = st["acquisitions"]
                waits = sorted(st["wait_ns_samples"])
                holds = sorted(st["hold_ns_samples"])
                locks.append({
                    "acquisitions": acq,
                    "contended": st["contended"],
                    "contended_fraction": (st["contended"] / acq
                                           if acq else 0.0),
                    "wait_ns_p50": pct(waits, 0.50),
                    "wait_ns_p99": pct(waits, 0.99),
                    "hold_ns_p50": pct(holds, 0.50),
                    "hold_ns_p99": pct(holds, 0.99),
                })
            out["lock"] = locks
        return out

    def _drain_native_raw(self, detach_stage: bool = False):
        return self._drain_native_raw_ctx(self._native, 0, detach_stage)

    def _drain_native_raw_ctx(self, ctx, ctx_i: int,
                              detach_stage: bool = False):
        """Pull the raw sample batches and bookkeeping out of one context.
        Caller holds the context lock. Samples drain before the series
        sync: a sample's series record is committed with or before it, so
        no drained sample lacks its row's metadata. ``detach_stage``
        (swap only) also detaches the staging plane and the event lines,
        in the same critical section as the epoch's reset."""
        errs = int(ctx.errors)
        dropped = int(ctx.overload_dropped)
        if ctx_i == 0:
            e_seen, d_seen = self._native_errs_seen, self._native_drop_seen
            self._native_errs_seen = errs
            self._native_drop_seen = dropped
        else:
            j = ctx_i - 1
            e_seen = self._reader_errs_seen[j]
            d_seen = self._reader_drop_seen[j]
            self._reader_errs_seen[j] = errs
            self._reader_drop_seen[j] = dropped
        self.parse_errors += errs - e_seen
        delta = dropped - d_seen
        self.overload_dropped += delta
        self.overload_dropped_total += delta
        if self.reader_dropped:
            # per-context shed attribution (committed == folded + shed,
            # per reader)
            self.reader_dropped[ctx_i] += delta
        n = ctx.pending_histo
        h = ctx.drain_histo(n) if n else None
        n = ctx.pending_set
        s = ctx.drain_set(n) if n else None
        c = ctx.drain_counter(ctx.pending_counter)
        g = ctx.drain_gauge(ctx.pending_gauge)
        st, others, ssf_fb = None, [], []
        if detach_stage:
            # epoch close: the event and service-check lines and the SSF
            # payloads handed back for Python come out in the same
            # critical section as the detach (the reset right after
            # clears both buffers)
            st = ctx.detach_stage()
            others = ctx.drain_other()
            ssf_fb = ctx.drain_ssf_fallback()
        self._sync_native_series(ctx, ctx_i)
        return h, s, c, g, st, others, ssf_fb

    def _apply_native_raw(self, raw, defer_histo_spill: bool = False):
        """Apply drained batches to the pools (no context lock held). With
        staging on, the histogram batch is hot-row spill: folded directly
        in bounded chunks, or with ``defer_histo_spill`` (swap) returned
        for extract_snapshot to fold; None when nothing was deferred."""
        h, s, c, g, _st, _others, _ssf_fb = raw
        deferred = None
        if h is not None and len(h[0]) and self._mesh_pool is not None:
            self._mesh_pool.add_samples_bulk(*h)
        elif h is not None and len(h[0]):
            self._ensure_histo(self.directory.num_histo_rows)
            if self.stage_depth > 0:
                if defer_histo_spill:
                    deferred = h
                else:
                    rows, vals, wts = h
                    for i in range(0, len(rows), _FOLD_CHUNK):
                        self._fold_batch_direct(rows[i:i + _FOLD_CHUNK],
                                                vals[i:i + _FOLD_CHUNK],
                                                wts[i:i + _FOLD_CHUNK])
            else:
                self._device_histo_step(*h)
        if s is not None and len(s[0]):
            self._ensure_sets(self.directory.num_set_rows)
            self._device_set_step(*s)
        rows, contribs = c
        if len(rows):
            pool = self.scalars.counters
            np.add.at(pool.values, rows, contribs)
            pool.present[rows] = True
        rows, vals = g
        if len(rows):
            pool = self.scalars.gauges
            pool.values[rows] = vals  # in order: the last write wins
            pool.present[rows] = True
        return deferred

    def _shed_spill_budget(self, spill_histo):
        """Bound the spill-fold work a flush inherits: past what the
        measured fold rate absorbs in ``fold_budget_s`` the oldest samples
        shed (the newest kept), counted as overload drops. With a tenant
        ledger the over-budget tenants' samples shed first
        (health/policy.shed_spill_keep), attributed per tenant in the
        epoch's tallies and on the governor."""
        if spill_histo is None:
            return None
        budget = max(_FOLD_CHUNK,
                     int(self._fold_rate_ewma * self.fold_budget_s))
        total = len(spill_histo[0])
        if total <= budget:
            return spill_histo
        shed = total - budget
        self.overload_dropped += shed
        self.overload_dropped_total += shed
        led = self.tenancy
        if led is None:
            return tuple(a[-budget:] for a in spill_histo)
        # with no over-budget tenant the keep set is the slice above
        from veneur_tpu_torch.health.policy import shed_spill_keep

        sp_rows = spill_histo[0]
        row_tenants = np.array(
            [m.tenant or DEFAULT_TENANT for m in self.directory.histo.rows],
            dtype=object)
        abusive = led.over_budget()
        if abusive:
            is_abusive = np.isin(row_tenants[sp_rows],
                                 np.array(sorted(abusive), dtype=object))
            keep = shed_spill_keep(is_abusive, budget)
        else:
            keep = np.arange(total - budget, total, dtype=np.int64)
        drop_mask = np.ones(total, bool)
        drop_mask[keep] = False
        t_list, t_counts = np.unique(row_tenants[sp_rows[drop_mask]],
                                     return_counts=True)
        tt = self.tenant_tallies
        gov = self.governor
        for t, c in zip(t_list.tolist(), t_counts.tolist()):
            tt.dropped[t] = tt.dropped.get(t, 0) + int(c)
            if gov is not None:
                gov.note_tenant_shed(t, int(c))
        return tuple(a[keep] for a in spill_histo)

    # -- micro-folds --------------------------------------------------------

    def _micro_active(self) -> bool:
        """Micro-folds run where the staged fold exists (staging on) and
        the device path is healthy: a quarantined worker has no device
        to mirror into, and an epoch whose mirror faulted keeps every
        sample in its staging plane instead. Reader-shard mode opts out:
        the mirror would need one COO stream per context re-keyed to
        canonical rows mid-interval, and the stacked merge at the flush
        does the same work."""
        return (self.micro_fold and self.stage_depth > 0
                and self._mesh_pool is None and not self._reader_ctxs
                and not self._host_live and not self.guard.quarantined
                and not self._micro_fault_epoch)

    def _new_mirror(self) -> mf.MicroFoldMirror:
        return mf.MicroFoldMirror(self.stage_depth, self.device,
                                  initial_rows=self._initial_histo_rows,
                                  guard=self.guard, ledger=self.ledger,
                                  shard=self._shard)

    def _ensure_micro(self) -> mf.MicroFoldMirror:
        if self._micro is None:
            self._micro = self._new_mirror()
        return self._micro

    def micro_fold_pending(self) -> int:
        """Staged samples not yet streamed to the mirror (the scheduler's
        due check; lock-free on the native path)."""
        if not self._micro_active():
            return 0
        if self._native is not None:
            return self._native.stage_pending
        if self._stage_count is None:
            return 0
        total = int(self._stage_count.sum())
        mark = self._ustage_mark
        if mark is not None:
            total -= int(mark[:len(self._stage_count)].sum())
        return total

    def micro_fold_due(self) -> bool:
        pending = self.micro_fold_pending()
        if pending <= 0:
            return False
        if pending >= self.micro_fold_rows:
            return True
        return (time.monotonic() - self._micro_last_drain
                >= self.micro_fold_max_age_s)

    def micro_fold_once(self) -> int:
        """One micro-fold: stream the samples staged since the last drain
        into the mirror and, on the native path, drain the pending spill,
        set and scalar batches too, so the swap inherits none of them.
        Caller holds the worker's ingest lock. Returns samples streamed."""
        if not self._micro_active():
            return 0
        self._micro_last_drain = time.monotonic()
        try:
            if self._native is not None:
                # counters add in drain order and gauges keep the last
                # write, so more frequent drains give the same result
                self.drain_native()
                fed = self._micro_drain_native()
            else:
                fed = self._micro_drain_python()
        except dg.DeviceFaultError as exc:
            # the mirror is a cache of the staging plane, which kept every
            # sample (the drains advanced watermarks, not counts): drop it
            # and fold the plane at the flush as if micro-folds were off
            log.error("micro-fold device fault (%s); mirror dropped, the "
                      "epoch folds its staging plane", exc)
            self._micro = None
            self._micro_fault_epoch = True
            return 0
        if fed:
            self.micro_folds_total += 1
            self.micro_folds_epoch += 1
            if self.governor is not None:
                # micro-folds are flush-path progress for the watchdog
                self.governor.note_micro_fold(fed)
        return fed

    def _micro_drain_native(self) -> int:
        """COO-drain the C++ staging plane's undrained delta into the
        mirror (the plane's watermark advances, its counts do not)."""
        if self._native.stage_pending <= 0:
            return 0
        micro = self._ensure_micro()
        fed = 0
        cap = 1 << 18
        while True:
            rows, slots, vals, wts = self._native.drain_stage_delta(cap)
            n = len(rows)
            if n == 0:
                break
            micro.feed(rows, slots, vals, wts)
            fed += n
            if n < cap:
                break
        return fed

    def _python_stage_delta(self) -> Optional[tuple]:
        """The Python plane's [mark, count) delta per row as one COO
        tuple (rows, slots, vals, wts, all copies), advancing the
        watermark; None when nothing is undrained. It reads only what
        _device_histo_step wrote, so the spill batches stay the batch
        path's."""
        counts = self._stage_count
        if counts is None:
            return None
        rows_n = len(counts)
        mark = self._ustage_mark
        if mark is None or len(mark) < rows_n:
            nm = np.zeros(rows_n, np.int32)
            if mark is not None:
                nm[:len(mark)] = mark
            mark = self._ustage_mark = nm
        delta = counts - mark[:rows_n]
        live = np.flatnonzero(delta > 0)
        if not len(live):
            return None
        reps = delta[live]
        total = int(reps.sum())
        rows = np.repeat(live.astype(np.int32), reps)
        run_starts = np.cumsum(reps) - reps
        intra = (np.arange(total, dtype=np.int32)
                 - np.repeat(run_starts, reps).astype(np.int32))
        slots = np.repeat(mark[live], reps).astype(np.int32) + intra
        coo = (rows, slots, self._stage_vals[rows, slots],
               self._stage_wts[rows, slots])
        mark[live] = counts[live]
        return coo

    def _micro_drain_python(self) -> int:
        coo = self._python_stage_delta()
        if coo is None:
            return 0
        self._ensure_micro().feed(*coo)
        return len(coo[0])

    # -- the device fault domain --------------------------------------------

    def _fields_to_host(self, fields) -> tuple:
        """The 14 fold-state tensors on the CPU, a sharded pool's in
        LOGICAL row order. Where the readback fails (a sticky CUDA error
        took the state with it) an empty pool of the same rows, logged:
        honest data loss, not a dead flush."""
        try:
            if _is_sharded(fields):
                return tuple(torch.from_numpy(self._shard.logical(f))
                             for f in fields)
            return tuple(t.cpu() for t in fields)
        except Exception:
            log.exception("device fold state unreadable during failover; "
                          "restarting from an empty pool on the CPU")
            return HistoDeviceState.create(_rows(fields[0]),
                                           self.capacity, "cpu").fields()

    def _sets_to_host(self, regs) -> torch.Tensor:
        """A dense register pool on the CPU, a sharded one in LOGICAL row
        order; zeros where the readback fails (logged)."""
        if not isinstance(regs, tuple):
            return dg.host_copy(regs, "set pool")
        try:
            return torch.from_numpy(self._shard.logical(regs))
        except Exception:
            log.exception("set pool readback failed during failover; "
                          "restarting it empty on the CPU")
            return torch.zeros((_rows(regs), regs[0].shape[1]),
                               dtype=torch.int8)

    def _quarantine_live(self) -> None:
        """Move the LIVE epoch's pools to the CPU, where the same torch
        programs run their plain versions. Caller holds the ingest lock.
        Idempotent. A pool whose readback fails restarts empty; the
        staging plane and the pending batches still hold their samples."""
        if self._host_live:
            return
        self._host_live = True
        if self._histo is not None:
            self._histo = HistoDeviceState(
                *self._fields_to_host(self._histo.fields()))
        if self._sets is not None:
            self._sets = self._sets_to_host(self._sets)
        if self._staged_sets is not None:
            self._staged_sets.to_host()
        # the mirror is device memory; the staging plane kept every
        # sample it mirrored, so the swap folds the plane
        self._micro = None
        self._micro_fault_epoch = True
        self.guard.bump("device.guard.quarantines")
        log.error("live epoch quarantined to the CPU (%s)",
                  self.guard.trip_reason)

    def _readmit_device(self) -> bool:
        """Move the live pools back to the card and leave host mode (the
        probe succeeded; caller holds the ingest lock). The uploads run
        as one guarded op; if it faults, nothing changes and the worker
        stays quarantined."""
        if not self._host_live:
            return True

        sh = self._shard

        def upload():
            if sh is not None:
                # the logical host pools split over the shards again
                h = None if self._histo is None else HistoDeviceState(*(
                    sh.from_logical(t.numpy())
                    for t in self._histo.fields()))
                sets = (None if self._sets is None
                        else sh.from_logical(self._sets.numpy()))
                for dev in set(sh.devices):
                    _sync_on(torch.empty(0, device=dev))
            else:
                h = (None if self._histo is None
                     else self._histo.to(self.device))
                sets = (None if self._sets is None
                        else self._sets.to(self.device))
                _sync_on(torch.empty(0, device=self.device))
            if self._staged_sets is not None:
                self._staged_sets.to_device()  # last: it commits itself
            return h, sets

        try:
            self._histo, self._sets = self.guard.call("probe", upload)
        except dg.DeviceFaultError:
            return False
        self._host_live = False
        self.guard.readmit()
        return True

    def _device_probe(self) -> bool:
        """A tiny fold and extract on throwaway tensors through the guard
        (op "probe"): the half-open breaker's health check. After a
        sticky CUDA error it fails at its first CUDA call."""
        def probe():
            st = HistoDeviceState.create(64, self.capacity, self.device)
            out = self._fold_spill_chunk(
                st.fields(), np.array([1, 2, 3], np.int32),
                np.array([1.0, 2.0, 3.0], np.float32),
                np.ones(3, np.float32))
            qs = _to_device(np.array([0.25, 0.5, 0.75, 0.99], np.float32),
                            self.device)
            ext = self._extract(out, qs).cpu()
            return bool(torch.isfinite(ext[1:4, 0]).all())

        try:
            return bool(self.guard.call("probe", probe))
        except dg.DeviceFaultError:
            return False
        except Exception:
            log.exception("device probe raised a non-device error")
            return False

    def device_guard_tick(self) -> None:
        """Per-flush guard maintenance, run by the server after each
        extraction with this worker's ingest lock held: quarantine the
        live epoch if the breaker tripped during the flush, and while
        quarantined run the re-admission probe when it is due."""
        if not self.guard.enabled:
            return
        if self.guard.quarantined and not self._host_live:
            self._quarantine_live()
        if self._host_live and self.guard.quarantined \
                and self.guard.probe_due():
            ok = self._device_probe() and self._readmit_device()
            self.guard.note_probe(ok)
            if ok:
                log.warning("device path re-admitted after a probe; the "
                            "live pools are back on %s", self.device)
            else:
                log.error("device probe failed; the worker stays on the "
                          "CPU")

    # -- pending-batch device steps ----------------------------------------

    def _flush_pending_histos(self) -> None:
        if not self._ph_rows:
            return
        rows = np.asarray(self._ph_rows, dtype=np.int32)
        vals = np.asarray(self._ph_vals, dtype=np.float32)
        wts = np.asarray(self._ph_wts, dtype=np.float32)
        self._ph_rows, self._ph_vals, self._ph_wts = [], [], []
        self._device_histo_step(rows, vals, wts)

    def _flush_pending_sets(self) -> None:
        if not self._ps_rows:
            return
        rows = np.asarray(self._ps_rows, dtype=np.int32)
        idx = np.asarray(self._ps_idx, dtype=np.int32)
        rank = np.asarray(self._ps_rank, dtype=np.int8)
        self._ps_rows, self._ps_idx, self._ps_rank = [], [], []
        self._device_set_step(rows, idx, rank)

    def _device_set_step(self, rows: np.ndarray, idx: np.ndarray,
                         rank: np.ndarray) -> None:
        """One batch of (set row, register, rank) updates: into the
        staged store, or scattered into the dense pool in place (on the
        card: one packed upload and one kernel launch, no padding)."""
        if self._staged_sets is not None:
            self._staged_sets.insert(rows, idx, rank)
            return
        assert self._sets is not None
        if self._sets_on_host():
            self._set_inserter.insert(self._sets, rows, idx, rank)
            return
        try:
            if isinstance(self._sets, tuple):
                # int8 scatter-max is order- and placement-independent:
                # each shard takes its own rows' records
                sh = self._shard
                self.guard.call(
                    "sets", sh.hll_insert, self._sets,
                    sh.phys_rows(rows, _rows(self._sets)), idx, rank,
                    self._shard_inserters, retryable=True)
            else:
                self.guard.call("sets", self._set_inserter.insert,
                                self._sets, rows, idx, rank, retryable=True)
        except dg.DeviceFaultError:
            # max-merges: a partly applied update applied again on the
            # CPU only re-asserts ranks
            if self.guard.quarantined:
                self._quarantine_live()
            else:
                self._sets = self._sets_to_host(self._sets)
            self._device_set_step(rows, idx, rank)

    # -- import path (global tier) ------------------------------------------

    def import_digest(
        self, key: MetricKey, tags: list[str], mtype: str,
        scope_class: ScopeClass, means: np.ndarray, weights: np.ndarray,
        dmin: float, dmax: float, drecip: float,
    ) -> None:
        """Buffer a downstream instance's digest for the row-wise merge
        at swap (reference Histo.Merge path, worker.go:438-495)."""
        self.imported += 1
        row = self._upsert_histo(key, scope_class, tags)
        if self._mesh_pool is not None:
            # the mesh re-ingests the centroids as weighted samples (the
            # reference's Merge semantics; reciprocalSum carried exactly)
            self._mesh_pool.add_centroids(
                row, np.asarray(means, np.float32),
                np.asarray(weights, np.float32), float(drecip))
            return
        self._ensure_histo(max(self.directory.num_histo_rows, row + 1))
        self._imp_digests.setdefault(row, []).append(
            (np.asarray(means, np.float32), np.asarray(weights, np.float32),
             float(dmin), float(dmax), float(drecip)))

    def import_digests_soa(self, rows: np.ndarray, lo: np.ndarray,
                           hi: np.ndarray, means_flat: np.ndarray,
                           weights_flat: np.ndarray, dmin: np.ndarray,
                           dmax: np.ndarray, drecip: np.ndarray) -> None:
        """Batched digest import from a decoded wire batch: the native
        batched upsert assigned the rows, so only views of the flat
        centroid arrays are buffered for the merge."""
        k = len(rows)
        if not k:
            return
        self.imported += k
        if self._mesh_pool is not None:
            for i in range(k):
                self._mesh_pool.add_centroids(
                    int(rows[i]), means_flat[lo[i]:hi[i]],
                    weights_flat[lo[i]:hi[i]], float(drecip[i]))
            return
        self._ensure_histo(max(self.directory.num_histo_rows,
                               int(rows.max()) + 1))
        setdefault = self._imp_digests.setdefault
        rl = rows.tolist()
        lol = lo.tolist()
        hil = hi.tolist()
        mnl = dmin.tolist()
        mxl = dmax.tolist()
        rcl = drecip.tolist()
        for i in range(k):
            setdefault(rl[i], []).append(
                (means_flat[lol[i]:hil[i]], weights_flat[lol[i]:hil[i]],
                 mnl[i], mxl[i], rcl[i]))

    def import_counter_rows(self, rows: np.ndarray,
                            values: np.ndarray) -> None:
        """Batched counter import by pre-assigned rows (forced-global
        semantics were applied at upsert)."""
        k = len(rows)
        if not k:
            return
        self.imported += k
        pool = self.scalars.counters
        pool.ensure(int(rows.max()) + 1)
        np.add.at(pool.values, rows, values.astype(np.int64))
        pool.present[rows] = True

    def import_gauge_rows(self, rows: np.ndarray,
                          values: np.ndarray) -> None:
        """Batched gauge import: duplicates resolve in batch order (the
        reference's global gauges are random-write-wins, README.md:262)."""
        k = len(rows)
        if not k:
            return
        self.imported += k
        pool = self.scalars.gauges
        pool.ensure(int(rows.max()) + 1)
        pool.values[rows] = values
        pool.present[rows] = True

    def import_hll_row(self, row: int, registers: np.ndarray) -> None:
        """Register import by pre-assigned row."""
        self.imported += 1
        if len(registers) != (1 << self.hll_precision):
            raise ValueError(
                f"HLL payload has {len(registers)} registers, expected"
                f" {1 << self.hll_precision}")
        self._buffer_hll(row, registers)

    def import_hll(self, key: MetricKey, tags: list[str],
                   scope_class: ScopeClass, registers: np.ndarray) -> None:
        self.imported += 1
        self._buffer_hll(self._upsert_set(key, scope_class, tags),
                         registers)

    def _buffer_hll(self, row: int, registers: np.ndarray) -> None:
        """The staged store max-merges an imported row itself; the dense
        pool's rows buffer (max-merged) for the swap's row max."""
        if self._staged_sets is not None:
            self._staged_sets.import_dense(row, registers)
            return
        self._ensure_sets(max(self.directory.num_set_rows, row + 1))
        prev = self._imp_hll.get(row)
        regs = np.asarray(registers, np.int8)
        self._imp_hll[row] = regs if prev is None else np.maximum(prev, regs)

    def import_counter(self, key: MetricKey, tags: list[str],
                       value: int) -> None:
        """Imported counters are global by definition
        (reference worker.go:404-407, 449-451)."""
        self.imported += 1
        self._host_counter(key, ScopeClass.GLOBAL, tags, int(value))

    def import_gauge(self, key: MetricKey, tags: list[str],
                     value: float) -> None:
        self.imported += 1
        self._host_gauge(key, ScopeClass.GLOBAL, tags, float(value))

    def _merge_imports(self) -> None:
        """Merge the epoch's buffered imports into the live pools (swap
        runs it under the ingest lock). Digests: rows sorted, each row's
        digests packed in arrival order, K padded to a power of two (>=
        16) with rows pointing at the scratch row, W to a power of two (>=
        the capacity); one import step, guarded op "import". HLL rows of
        the dense pool: a row max (unique rows: gather, max, write). A
        fault trips the breaker (the merge has no later retry point),
        the live epoch goes to the CPU and the merge finishes there: an
        update computed on the card lands as it is, else the merge runs
        again on the CPU."""
        if self._imp_digests:
            h = self._histo
            rows = sorted(self._imp_digests)
            c = self.capacity
            widths = {r: sum(len(m) for m, *_ in self._imp_digests[r])
                      for r in rows}
            w_bucket = _next_pow2(max(widths.values()), c)
            k = _next_pow2(len(rows), 16)
            scratch = h.num_rows - 1
            arows = np.full(k, scratch, dtype=np.int64)
            imp_means = np.full((k, w_bucket), np.inf, dtype=np.float32)
            imp_w = np.zeros((k, w_bucket), dtype=np.float32)
            imp_min = np.full(k, np.inf, dtype=np.float32)
            imp_max = np.full(k, -np.inf, dtype=np.float32)
            imp_recip = np.zeros(k, dtype=np.float32)
            for i, r in enumerate(rows):
                arows[i] = r
                off = 0
                for m, wts, mn, mx, rc in self._imp_digests[r]:
                    nz = wts > 0
                    cnt = int(nz.sum())
                    imp_means[i, off:off + cnt] = m[nz]
                    imp_w[i, off:off + cnt] = wts[nz]
                    off += cnt
                    imp_min[i] = min(imp_min[i], mn)
                    imp_max[i] = max(imp_max[i], mx)
                    imp_recip[i] += rc
            self._imp_digests = {}
            args = (arows, imp_means, imp_w, imp_min, imp_max, imp_recip)
            if self._host_live:
                self._import_digest_rows(h.fields()[:6], args)
            else:
                held: dict = {}
                try:
                    self.guard.call("import", self._import_digest_rows,
                                    h.fields()[:6], args, held=held)
                except dg.DeviceFaultError as exc:
                    self.guard.trip(f"import merge faulted [{exc.kind}]")
                    self._quarantine_live()
                    fields = self._histo.fields()[:6]
                    update = held.get("update")
                    try:
                        update = (None if update is None
                                  else self._update_to_host(update))
                    except Exception:
                        log.exception("import update unreadable during "
                                      "failover; merging again on the CPU")
                        update = None
                    if update is None:
                        self._import_digest_rows(fields, args)
                    else:
                        _write_import_rows(fields, update)

        if self._imp_hll:
            rows = sorted(self._imp_hll)
            arows = np.asarray(rows, dtype=np.int64)
            imp = np.stack([self._imp_hll[r] for r in rows])
            self._imp_hll = {}
            if self._sets_on_host():
                self._import_hll_rows(self._sets, arows, imp)
                return
            try:
                self.guard.call("import", self._import_hll_rows_any,
                                self._sets, arows, imp, retryable=True)
            except dg.DeviceFaultError as exc:
                # a row max applied again only re-asserts registers
                self.guard.trip(f"HLL import merge faulted [{exc.kind}]")
                self._quarantine_live()
                self._import_hll_rows(self._sets, arows, imp)

    def _import_digest_rows(self, fields: tuple, args: tuple,
                            held: Optional[dict] = None) -> None:
        """One import step on ``fields`` (their device, or every shard's
        with the import replicated and its rows physical), with its sync;
        ``held["update"]`` keeps the computed update while it lands."""
        if _is_sharded(fields):
            sh = self._shard
            rows = sh.phys_rows(args[0], _rows(fields[0]))
            update = sh.import_rows(fields, sh.replicate(rows),
                                    *(sh.replicate(a) for a in args[1:]))
            write = sh.write_import_rows
        else:
            dev = fields[0].device
            update = _histo_import_rows(
                *fields, *(_to_device(a, dev) for a in args),
                compression=self.compression)
            write = _write_import_rows
        if held is not None:
            held["update"] = update
        write(fields, update)
        _sync_on(fields[0])
        if held is not None:
            held["update"] = None

    def _update_to_host(self, update: tuple) -> tuple:
        """A held ingest or import update on the CPU, for the logical CPU
        pool: a sharded update's local rows become logical rows."""
        if isinstance(update[0], tuple):
            return self._shard.logical_update(update)
        return tuple(t.cpu() for t in update)

    def _import_hll_rows_any(self, sets, rows: np.ndarray,
                             regs: np.ndarray) -> None:
        """``_import_hll_rows`` on the dense pool, or on every shard of a
        sharded one (rows logical, each shard taking its own)."""
        if isinstance(sets, tuple):
            sh = self._shard
            sh.hll_max_rows(sets, sh.phys_rows(rows, _rows(sets)), regs)
            _sync_on(sets)
            return
        self._import_hll_rows(sets, rows, regs)

    @staticmethod
    def _import_hll_rows(sets: torch.Tensor, rows: np.ndarray,
                         regs: np.ndarray) -> None:
        """Row max of imported registers into the dense pool, in place
        (rows unique: gather, max, write, deterministic on the card)."""
        at = _to_device(rows, sets.device)
        sets[at] = torch.maximum(sets[at], _to_device(regs, sets.device))
        _sync_on(sets)

    def _ensure_stage(self) -> None:
        """Size the host staging planes to the digest pool's row count."""
        rows = self._histo.num_rows
        if self._stage_count is None:
            self._stage_vals = np.zeros((rows, self.stage_depth), np.float32)
            self._stage_wts = np.zeros((rows, self.stage_depth), np.float32)
            self._stage_count = np.zeros(rows, np.int32)
        elif len(self._stage_count) < rows:
            old = len(self._stage_count)
            nv = np.zeros((rows, self.stage_depth), np.float32)
            nw = np.zeros((rows, self.stage_depth), np.float32)
            nc = np.zeros(rows, np.int32)
            nv[:old] = self._stage_vals
            nw[:old] = self._stage_wts
            nc[:old] = self._stage_count
            self._stage_vals, self._stage_wts, self._stage_count = nv, nw, nc

    def _device_histo_step(self, rows: np.ndarray, vals: np.ndarray,
                           wts: np.ndarray) -> None:
        """Stage a raw-sample batch host-side (vectorized numpy, no device
        work); the digest compress is paid once per interval in
        _histo_fold_staged. Samples past a row's staging depth spill
        through the direct device fold."""
        n = len(rows)
        if n == 0:
            return
        B = self.stage_depth
        self._ensure_stage()
        order = np.argsort(rows, kind="stable")
        srows = rows[order]
        svals = vals[order]
        swts = wts[order]
        newrun = np.empty(n, bool)
        newrun[0] = True
        np.not_equal(srows[1:], srows[:-1], out=newrun[1:])
        starts = np.flatnonzero(newrun)
        runid = np.cumsum(newrun) - 1
        # rank of each sample within its row's run → its staging slot
        slots = self._stage_count[srows] + (np.arange(n) - starts[runid])
        run_rows = srows[starts]
        run_len = np.diff(np.append(starts, n))
        fit = slots < B
        if fit.all():
            self._stage_vals[srows, slots] = svals
            self._stage_wts[srows, slots] = swts
            self._stage_count[run_rows] += run_len.astype(np.int32)
            return
        keep = fit
        self._stage_vals[srows[keep], slots[keep]] = svals[keep]
        self._stage_wts[srows[keep], slots[keep]] = swts[keep]
        self._stage_count[run_rows] = np.minimum(
            self._stage_count[run_rows] + run_len, B).astype(np.int32)
        spill = ~keep
        self._fold_batch_direct(srows[spill], svals[spill], swts[spill])

    @staticmethod
    def _pad_spill_batch(rows: np.ndarray, vals: np.ndarray,
                         wts: np.ndarray, scratch: int):
        """Pow2-pad one spill batch for the ingest step: padding sample
        slots point at `scratch` with weight 0, which the step treats
        as absent."""
        uniq, inverse = np.unique(rows, return_inverse=True)
        k = _next_pow2(len(uniq), 64)
        n = _next_pow2(len(vals), 256)
        active = np.full(k, scratch, dtype=np.int64)
        active[: len(uniq)] = uniq
        lids = np.full(n, k - 1, dtype=np.int64)
        lids[: len(vals)] = inverse
        v = np.zeros(n, dtype=np.float32)
        v[: len(vals)] = vals
        w = np.zeros(n, dtype=np.float32)
        w[: len(vals)] = wts
        return active, lids, v, w

    def _fold_batch_direct(self, rows: np.ndarray, vals: np.ndarray,
                           wts: np.ndarray) -> None:
        """Gather→add_batch→scatter device fold of one sample batch, the
        spill path for rows whose staging plane is full (in place), as
        guarded op "fold" with its sync. The batch joins the queue of
        batches whose fold faulted, which fold first, in order, each as
        its own batch."""
        self._fold_queue.append((rows, vals, wts))
        self._drain_fold_queue()

    def _drain_fold_queue(self) -> None:
        """Fold the queued spill batches in order. A fault that trips the
        breaker quarantines the epoch and the batches fold on the CPU;
        any other fault before the batch's first write leaves it at the
        head of the queue for the next fold or the swap. The reference
        puts a faulted batch back into the pending batch instead, which
        joins it to the next one; keeping it whole keeps the healthy
        run's batch cuts, so the faulted interval's bits are the healthy
        interval's. A fault among the writes is finished at once: the
        writes are repeated, under the guard, until they land or the
        breaker trips, and then they land on the CPU copy of the pool."""
        while self._fold_queue:
            h = self._histo
            batch = self._fold_queue[0]
            if self._host_live:
                self._fold_spill_chunk(h.fields(), *batch)
                self._fold_queue.pop(0)
                continue
            held: dict = {}
            try:
                self.guard.call("fold", self._fold_spill_chunk, h.fields(),
                                *batch, sync=True, held=held)
            except dg.DeviceFaultError:
                update = held.get("update")
                if update is not None:
                    self._finish_writes(update, batch)
                elif not self.guard.quarantined:
                    return
                else:
                    self._quarantine_live()
                    continue
            self._fold_queue.pop(0)

    def _finish_writes(self, update: tuple, batch: tuple) -> None:
        """Repeat a spill fold's faulted writes on the live pool until
        they land; once the breaker trips, land them on the CPU."""
        while not self.guard.quarantined:
            try:
                self.guard.call("fold", self._write_synced,
                                self._histo.fields(), update)
                return
            except dg.DeviceFaultError:
                pass
        self._quarantine_live()
        self._land_held_update(self._histo.fields(), update, batch)

    def _write_synced(self, fields: tuple, update: tuple) -> None:
        if _is_sharded(fields):
            self._shard.write_ingest_rows(fields, update)
        else:
            _write_ingest_rows(fields, update)
        _sync_on(fields[0])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _extract(self, fields: tuple, qs: torch.Tensor) -> torch.Tensor:
        """Flush extraction, packed [S, P+10]: the hand-written kernel on
        the card, its plain version on the CPU (ops/extract_kernel.py)."""
        return ek.flush_extract(*fields, qs)

    # -- flush --------------------------------------------------------------

    def swap(self, quantiles: np.ndarray) -> SwappedEpoch:
        """Close the current epoch and return the old-interval state (the
        map-swap analog of worker.go:498-517). The new epoch starts with
        no pool, so nothing of the swapped epoch is shared with it.

        With micro-folds the epoch's mirror is handed over with the COO
        deltas not yet fed to it (collected here, under the ingest lock,
        so nothing lands twice or not at all; fed at extraction), and the
        plane it mirrors is kept on the host as the fault replay."""
        shards = self._native is not None and bool(self._reader_ctxs)
        # a native context's commits are counted inside its lock hold
        # below, with the drain and the reset: its C++ reader commits
        # without the worker lock, so a read here would miss the lines
        # committed between it and the lock, drained into this epoch and
        # then zeroed by the reset (F8)
        self.processed_total += (self._processed_py
                                 if self._native is not None
                                 else self.processed)
        native_stage = None
        spill_histo = None
        micro_s = 0.0
        micro_coo: list = []
        native_mirrored = False
        reader_planes = None
        if shards:
            # the shared-nothing fence: each context's lock is held only
            # for its own drain, detach and reset, so a committing reader
            # waits once a flush, when the fence reaches its context
            raws = []
            for i, ctx in enumerate(self._all_ctxs()):
                seen = (self._native_proc_seen if i == 0
                        else self._reader_proc_seen[i - 1])
                with ctx.hold():
                    raw = self._drain_native_raw_ctx(ctx, i,
                                                     detach_stage=True)
                    delta = int(ctx.processed) - seen
                    self.reader_committed[i] += delta
                    self.processed_total += delta
                    ctx.reset()
                    if i == 0:
                        self._native_errs_seen = 0
                        self._native_proc_seen = 0
                        self._native_drop_seen = 0
                    else:
                        self._reader_errs_seen[i - 1] = 0
                        self._reader_proc_seen[i - 1] = 0
                        self._reader_drop_seen[i - 1] = 0
                raws.append(raw)
            self._native_epoch_closed = True
            # off the locks: each context's rows to canonical rows, applied
            # in context order (counters add in order, gauges keep the
            # last write in context order), and the detached planes kept
            # with copies of their maps for the stacked fold
            others: list = []
            ssf_fb: list = []
            spills: list = []
            planes: list = []
            for i, raw in enumerate(raws):
                d = self._apply_native_raw(self._map_raw_rows(i, raw),
                                           defer_histo_spill=True)
                if d is not None and len(d[0]):
                    spills.append(d)
                others.extend(raw[5])
                ssf_fb.extend(raw[6])
                if raw[4] is not None:
                    planes.append((raw[4], np.frombuffer(
                        self._ctx_maps[i][0], dtype=np.int32).copy()))
            self.pending_other_lines = others
            self.pending_ssf_fallback = ssf_fb
            if spills:
                spill_histo = (spills[0] if len(spills) == 1 else tuple(
                    np.concatenate([sp[k] for sp in spills])
                    for k in range(3)))
            spill_histo = self._shed_spill_budget(spill_histo)
            reader_planes = planes or None
            if reader_planes:
                # the stacked fold lands in the canonical pool
                self._ensure_histo(self.directory.num_histo_rows)
        elif self._native is not None:
            # drain, detach the staging plane and close the native epoch
            # under one lock hold (the collector paused: native.hold): a
            # routed commit could otherwise land between the last drain and
            # the reset and die with the epoch
            with self._native.hold():
                if self._micro_active():
                    # the residual delta in the same critical section as
                    # the detach (host copies only; the device feeds run
                    # at extraction)
                    t = time.perf_counter()
                    cap = 1 << 18
                    while True:
                        coo = self._native.drain_stage_delta(cap)
                        if not len(coo[0]):
                            break
                        micro_coo.append(coo)
                        if len(coo[0]) < cap:
                            break
                    native_mirrored = self._native.stage_pending == 0
                    micro_s += time.perf_counter() - t
                raw = self._drain_native_raw(detach_stage=True)
                native_stage = raw[4]
                # event and service-check lines caught at epoch close; the
                # server parses them into the new epoch
                self.pending_other_lines = raw[5]
                self.pending_ssf_fallback = raw[6]
                self.processed_total += (int(self._native.processed)
                                         - self._native_proc_seen)
                self._native.reset()
                self._native_errs_seen = 0
                self._native_proc_seen = 0
                self._native_drop_seen = 0
                self._native_epoch_closed = True
            spill_histo = self._shed_spill_budget(
                self._apply_native_raw(raw, defer_histo_spill=True))
            if native_stage is not None and self._mesh_pool is not None:
                # samples staged before attach_mesh_pool() turned staging
                # off belong to the mesh, not to the local fold
                sv, sw, counts, _unit, free = native_stage
                depth = sv.shape[1]
                mask = np.arange(depth)[None, :] < counts[:, None]
                rows = np.repeat(np.arange(len(counts), dtype=np.int32),
                                 np.minimum(counts, depth))
                vals, wts = sv[mask], sw[mask]  # copies: the plane can go
                free()
                native_stage = None
                self._mesh_pool.add_samples_bulk(rows, vals, wts)
            if native_stage is not None:
                # every sample may be staged: the pool must exist for the
                # fold to land in
                self._ensure_histo(self.directory.num_histo_rows)
        self._flush_pending_histos()
        self._drain_fold_queue()
        if self._fold_queue:
            # folds still faulting: the epoch reset would drop their
            # batches, so they lead the spill backlog the extraction folds
            queued = [np.concatenate([b[k] for b in self._fold_queue])
                      for k in range(3)]
            self._fold_queue = []
            spill_histo = tuple(queued if spill_histo is None else (
                np.concatenate([queued[k], spill_histo[k]])
                for k in range(3)))
        self._flush_pending_sets()
        self._merge_imports()
        mesh_out = None
        if self._mesh_pool is not None and self.directory.num_histo_rows:
            # the cross-host merge and extraction, per series shard
            mesh_out = self._mesh_pool.extract(
                quantiles, self.directory.num_histo_rows)
            self._mesh_pool.reset()
        micro_residual = None
        if self._micro_active():
            t = time.perf_counter()
            if self._native is None:
                coo = self._python_stage_delta()
                if coo is not None:
                    micro_coo.append(coo)
            mirror, self._micro = self._micro, None
            if (mirror is not None and mirror.samples > 0) or any(
                    len(c[0]) for c in micro_coo):
                mirror = mirror or self._new_mirror()
                # the residual feeds run in the extraction: they book into
                # its flush window
                mirror.book_in_flush = True
                micro_residual = (mirror, micro_coo)
            micro_s += time.perf_counter() - t
        self.micro_drain_swapped_s = micro_s
        self.micro_folds_swapped = self.micro_folds_epoch
        # the epoch's micro-fold uploads belong to the flush that extracts
        # it: queued for that flush's window
        self.ledger.roll_epoch()
        # exactly one of the mirror and a staged plane carries a sample;
        # a mirrored plane stays as the host replay
        micro_replay = None
        staged_histo = []
        python_mirrored = micro_residual is not None and self._native is None
        if self._stage_count is not None and self._stage_count.any():
            if python_mirrored:
                micro_replay = StagedPlane(self._stage_vals, self._stage_wts)
            else:
                # hand the host staging plane to the closed epoch; the
                # fold runs in extract_snapshot
                self._ensure_stage()  # pool may have grown since staging
                staged_histo.append(StagedPlane(self._stage_vals,
                                                self._stage_wts))
        if native_stage is not None:
            sv, sw, counts, unit, free = native_stage
            if native_mirrored and micro_residual is not None:
                # the mirror and the residual hold the plane: keep a
                # compacted host copy for a fault, release the C++ memory
                micro_replay = _compact_plane(sv, None if unit else sw,
                                              counts, sv.shape[0])
                free()
            else:
                # unit weights (no sampled metric this epoch): the weights
                # plane is rebuilt from the counts, not uploaded
                staged_histo.append(
                    StagedPlane(sv, None if unit else sw, counts, free))
        swapped = SwappedEpoch(
            directory=self.directory, scalars=self.scalars,
            histo=self._histo, sets=self._sets,
            staged_sets=self._staged_sets, umts=self._umts,
            mesh_out=mesh_out, staged_histo=staged_histo or None,
            spill_histo=spill_histo, micro_residual=micro_residual,
            reader_planes=reader_planes, micro_replay=micro_replay,
            host=self._host_live)
        # the per-tenant lifetime fold, under the caller's ingest lock and
        # before the reset zeroes the epoch's tallies
        self.tenant_tallies.accumulate_into(self.tenant_tallies_total)
        self.imported = 0
        self._reset_epoch()
        return swapped

    def tenant_lifetime(self) -> dict:
        """Lifetime + current-epoch per-tenant tallies as plain dicts.
        Caller holds this worker's ingest lock."""
        return self.tenant_tallies_total.merged_with(self.tenant_tallies)

    def _fold_one_plane(self, fields: tuple, pending: list, s_eff: int,
                        call) -> tuple:
        """Fold pending[0] into the digest fields and pop it. A native
        plane is first compacted on the host (the filled slots row-major
        and the per-row counts: O(samples) bytes where the dense plane is
        O(S·B)), released, and re-staged as those host copies, so a fault
        in the fold leaves it replayable; a compacted plane uploads flat
        (on the card its per-row offsets in place of the counts, the same
        bytes), a dense Python plane as it is; ``fold_staged`` folds
        either. The upload and the fold are one ``call("staged", ...)``.
        On the device path the uploads book into the ledger before the
        call, as the JAX worker books them; the CPU failover books none."""
        plane: StagedPlane = pending[0]
        if plane.free is not None:
            # the native plane grows on its own pow2 schedule and may
            # trail the pool's; rows past its end are empty
            host = _compact_plane(plane.vals, plane.wts, plane.counts,
                                  min(plane.vals.shape[0], s_eff))
            plane.free()
            plane = pending[0] = host
        depth = self.stage_depth
        led = self.ledger if call is not _unguarded else None
        # a sharded pool takes per-shard uploads: the flat samples split
        # into per-shard segments, the counts and a dense plane permuted
        # to the physical layout (each shard's block its own rows)
        sh = self._shard if _is_sharded(fields) else None
        if plane.counts is not None:
            counts = plane.counts
            if len(counts) < s_eff:
                counts = np.pad(counts, (0, s_eff - len(counts)))
            else:
                counts = counts[:s_eff]
            counts = counts.astype(np.int32)
            unit = plane.wts is None
            if sh is not None:
                fv, fw, counts = self._shard_flat_split(
                    plane.vals, plane.wts, counts, s_eff)
            else:
                n_pad = _next_pow2(max(len(plane.vals), 1), 1024)
                fv = np.zeros(n_pad, np.float32)
                fv[:len(plane.vals)] = plane.vals
                if not unit:
                    fw = np.zeros(n_pad, np.float32)
                    fw[:len(plane.wts)] = plane.wts
            uploads = [(fv, "staged_flat"), (counts, "staged_counts")]
            if not unit:
                uploads.append((fw, "staged_flat"))
        elif sh is not None:
            sv = np.asarray(plane.vals[:s_eff], np.float32)
            sw = np.asarray(plane.wts[:s_eff], np.float32)
            if sv.shape[0] < s_eff:
                pad = ((0, s_eff - sv.shape[0]), (0, 0))
                sv, sw = np.pad(sv, pad), np.pad(sw, pad)
            p2l = sh.perm_p2l(s_eff)
            sv, sw = sv[p2l], sw[p2l]
            uploads = [(sv, "staged_dense"), (sw, "staged_dense")]
        else:
            uploads = [(plane.vals[:s_eff], "staged_dense"),
                       (plane.wts[:s_eff], "staged_dense")]
        self.last_plane_upload_bytes += sum(a.nbytes for a, _ in uploads)
        if led is not None:
            for a, kind in uploads:
                if sh is not None:
                    led.count_h2d_shards([a.nbytes // sh.shards] * sh.shards,
                                         kind)
                else:
                    led.count_h2d(a.nbytes, kind)

        def fold_flat(fl):
            if sh is not None:
                fvj = sh.place(fv)
                fwj = (None,) * sh.shards if unit else sh.place(fw)
                blocks = counts.reshape(sh.shards, -1)
                return sh.fold_staged(fl, [
                    FlatStage(fvj[d], fwj[d], blocks[d], depth)
                    for d in range(sh.shards)])
            dev = fl[0].device
            stage = FlatStage(_to_device(fv, dev),
                              None if unit else _to_device(fw, dev), counts,
                              depth)
            return fold_staged(fl, stage, compression=self.compression)

        def fold_dense(fl):
            if sh is not None:
                svj, swj = sh.place(sv), sh.place(sw)
                return sh.fold_staged(fl, [DenseStage(svj[d], swj[d])
                                           for d in range(sh.shards)])
            dev = fl[0].device
            stage = DenseStage(_to_device(plane.vals[:s_eff], dev),
                               _to_device(plane.wts[:s_eff], dev))
            return fold_staged(fl, stage, compression=self.compression)

        fields = call("staged", fold_flat if plane.counts is not None
                      else fold_dense, fields)
        pending.pop(0)
        return fields

    def _shard_flat_split(self, flat_v, flat_w, counts_np, s_eff: int):
        """One compacted staged plane (flat samples in LOGICAL row order,
        per-row counts [s_eff]) split for the sharded expand: each shard's
        segment holds its local rows' samples in local order, padded to
        a common pow2 length (an upload of O(samples / D) a shard).
        Returns the flat values and weights [D * Lmax] (weights None with
        unit weights) and the counts in physical order."""
        sh = self._shard
        d = sh.shards
        p2l = sh.perm_p2l(s_eff)
        counts64 = counts_np.astype(np.int64)
        # logical sample offsets per row, then gathered shard-major
        off = np.zeros(s_eff, np.int64)
        np.cumsum(counts64[:-1], out=off[1:])
        reps = counts64[p2l]
        total = int(reps.sum())
        run_starts = np.cumsum(reps) - reps
        gidx = (np.repeat(off[p2l], reps)
                + np.arange(total, dtype=np.int64)
                - np.repeat(run_starts, reps))
        seg_len = reps.reshape(d, -1).sum(axis=1)
        lmax = _next_pow2(int(seg_len.max()) if total else 1, 1024)
        seg_off = np.cumsum(seg_len) - seg_len
        col = np.arange(total, dtype=np.int64) - np.repeat(seg_off, seg_len)
        srd = np.repeat(np.arange(d), seg_len)

        def split(flat):
            out = np.zeros((d, lmax), np.float32)
            out[srd, col] = flat[gidx]
            return out.reshape(-1)

        return (split(flat_v), None if flat_w is None else split(flat_w),
                counts_np[p2l].astype(np.int32))

    def _fold_spill_chunk(self, fields: tuple, rows: np.ndarray,
                          vals: np.ndarray, wts: np.ndarray,
                          sync: bool = False,
                          held: Optional[dict] = None) -> tuple:
        """Fold one spill batch into the full-pool ``fields`` (the live
        pool's or a swapped epoch's, on their device; the top row is the
        padding scratch), in place; ``sync`` waits for it. Every new value
        is computed before the first write, and ``held["update"]`` keeps
        them while the writes run: a fault among the writes leaves the
        pool partly written, and ``_land_held_update`` finishes the
        writes instead of folding the batch again."""
        pool_rows = _rows(fields[0])
        active, lids, v, w = self._pad_spill_batch(
            rows, vals, wts, pool_rows - 1)
        if _is_sharded(fields):
            # the replicated batch, `active` in physical slots: every
            # shard folds the bit-identical batch and keeps only the
            # writes it owns (ops/series_shard.ingest_rows)
            sh = self._shard
            update = sh.ingest_rows(
                fields, sh.replicate(sh.phys_rows(active, pool_rows)),
                sh.replicate(lids), sh.replicate(v), sh.replicate(w))
            write = sh.write_ingest_rows
        else:
            dev = fields[0].device
            update = _histo_ingest_rows(
                *fields, _to_device(active, dev), _to_device(lids, dev),
                _to_device(v, dev), _to_device(w, dev),
                compression=self.compression)
            write = _write_ingest_rows
        if held is not None:
            held["update"] = update
        write(fields, update)
        if sync:
            _sync_on(fields[0])
        if held is not None:
            held["update"] = None
        return fields

    def _land_held_update(self, fields: tuple, update: tuple,
                          batch: tuple) -> tuple:
        """Finish, on the CPU pool ``fields``, a spill fold whose device
        writes faulted partway: the held update, read back, is written
        again (the writes are idempotent). Where it cannot be read back
        (a sticky error took the context, and the pool restarted empty
        with it) the batch folds again on the CPU."""
        try:
            update = self._update_to_host(update)
        except Exception:
            log.exception("spill update unreadable during failover; folding "
                          "the batch again on the CPU")
            return self._fold_spill_chunk(fields, *batch)
        _write_ingest_rows(fields, update)
        return fields

    def _fold_mirror(self, fields: tuple, dstage: mf.MirrorState,
                     s_eff: int) -> tuple:
        """The staged fold over the micro-fold mirror: the plane is
        already on the device, its first s_eff rows (fewer where the
        directory outgrew the mirror: the rows past it are empty) bitwise
        the plane the batch path would upload (sharded, per shard)."""
        if _is_sharded(fields):
            sh = self._shard
            ecap = s_eff // sh.shards
            return sh.fold_staged(fields, [
                DenseStage(v[:ecap], w[:ecap])
                for v, w in zip(dstage.vals, dstage.wts)])
        return fold_staged(fields, DenseStage(dstage.vals[:s_eff],
                                              dstage.wts[:s_eff]),
                           compression=self.compression)

    def extract_snapshot(self, swapped: SwappedEpoch,
                         quantiles: np.ndarray,
                         interval_s: float = 10.0) -> FlushSnapshot:
        """Fold and read back a swapped epoch. Touches only the swapped
        objects, never the live epoch. A classified device fault finishes
        the flush on the CPU (flagged ``degraded``)."""
        # one extraction is one transfer window; the reset is here, not in
        # swap, so a pipelined tick's swap cannot clobber the window of an
        # extraction still running
        self.ledger.begin_flush()
        snap = FlushSnapshot(directory=swapped.directory,
                             scalars=swapped.scalars, interval_s=interval_s,
                             unique_timeseries_registers=swapped.umts)

        def mark_degraded():
            if not snap.degraded:
                snap.degraded = True
                self.host_fallback_flushes += 1
                self.ledger.note_fallback()
                log.error("flush completed on the CPU failover engine "
                          "(degraded)")

        pending = list(swapped.staged_histo or ())
        swapped.staged_histo = None
        # the deferred spill backlog is taken whatever happens below: with
        # no pool to fold into, its samples are counted as shed
        spill = swapped.spill_histo
        swapped.spill_histo = None
        rplanes = swapped.reader_planes
        swapped.reader_planes = None
        if rplanes:
            # reader shards: the per-context planes merge on the host into
            # ONE canonical flat plane (per row in context order), which
            # folds as a compacted legacy plane does; rows past the
            # staging depth send their excess to the spill fold
            t0 = time.perf_counter()
            s_eff = (0 if swapped.histo is None else min(
                swapped.histo.num_rows,
                _next_pow2(swapped.directory.num_histo_rows, 1024)))
            try:
                flat_v, flat_w, rcounts, rspill, per_ctx = (
                    rstack.merge_reader_planes(rplanes, s_eff))
            finally:
                for st, _m in rplanes:
                    st[4]()
            if any(per_ctx):
                # who contributed the merged upload (booked once, below)
                self.ledger.count_h2d_readers([int(k) * 4 for k in per_ctx])
            if flat_v is not None:
                pending.append(StagedPlane(flat_v, flat_w, rcounts, None))
            if rspill is not None:
                spill = (rspill if spill is None else tuple(
                    np.concatenate([spill[k], rspill[k]])
                    for k in range(3)))
        phases: dict[str, float] = {}
        if rplanes:
            phases["reader_merge_s"] = time.perf_counter() - t0
        self.last_plane_upload_bytes = 0
        self.last_micro_chunks = self.last_micro_bytes = 0
        # the fully folded fields the extract read, kept for the query view
        view_fields = None
        if swapped.histo is not None and swapped.directory.num_histo_rows:
            try:
                view_fields = self._extract_histo(
                    snap, swapped, pending, spill, quantiles, phases,
                    mark_degraded)
            finally:
                # an upload or fold failure must not leak the C++ planes
                _free_staged_planes(pending)
            self._fold_tenant_sketch(snap, phases)
        else:
            _free_staged_planes(pending)
            if spill is not None and len(spill[0]):
                self.overload_dropped += len(spill[0])
                self.overload_dropped_total += len(spill[0])
        # a mirror with no rows to fold into holds nothing to lose
        swapped.device_stage = None
        swapped.micro_residual = None
        swapped.micro_replay = None
        if swapped.mesh_out is not None:
            mout = swapped.mesh_out
            n = swapped.directory.num_histo_rows
            snap.quantile_values = mout["quant"]
            snap.quantile_qs = np.asarray(quantiles, dtype=np.float64)
            snap.dmin, snap.dmax = mout["dmin"], mout["dmax"]
            snap.dsum = mout["dsum"]
            snap.dcount = mout["dcount"]
            snap.drecip = mout["drecip"]
            # mesh rows carry no host-local scalar aggregates (a global
            # emits digest-derived values; see attach_mesh_pool)
            snap.lmin = np.full(n, np.inf, np.float32)
            snap.lmax = np.full(n, -np.inf, np.float32)
            snap.lsum = np.zeros(n, np.float64)
            snap.lweight = np.zeros(n, np.float64)
            snap.lrecip = np.zeros(n, np.float64)
        if swapped.directory.num_set_rows:
            t0 = time.perf_counter()
            self._extract_sets(snap, swapped, phases, mark_degraded)
            phases["sets_s"] = time.perf_counter() - t0
        self.last_extract_phases = phases
        pub = self.query_publisher
        if pub is not None:
            # publish the epoch's read view; a failed publish leaves the
            # query surface one interval stale, never fails the flush
            self.query_epoch_seq += 1
            sk = self.tenant_sketch
            try:
                pub(self.query_epoch_seq, snap,
                    self._make_query_eval(view_fields),
                    sk.snapshot() if sk is not None else None)
            except Exception:
                log.exception("query view publish failed")
        return snap

    def _fold_tenant_sketch(self, snap: FlushSnapshot, phases: dict) -> None:
        """The heavy-hitter fold (core/tenancy.TenantSketch): one
        (tenant, series key, folded sample count) triple per histogram
        series, scatter-added into the count-min pool on the device. On
        a degraded flush it is best effort: one interval of heavy-hitter
        attribution is expendable, the flush is not."""
        sk = self.tenant_sketch
        n = snap.directory.num_histo_rows
        if sk is None or not n:
            return
        t0 = time.perf_counter()
        hrows = snap.directory.histo.rows
        tenants = [m.tenant or DEFAULT_TENANT for m in hrows]
        skeys = [m.key.key_string() for m in hrows]
        kcounts = np.maximum(np.nan_to_num(snap.dcount[:n]), 0).astype(
            np.int64)
        chunk = _next_pow2(min(len(skeys), 1 << 15), 256)
        if snap.degraded:
            try:
                sk.fold(tenants, skeys, kcounts, chunk)
            except Exception:
                log.exception("tenant sketch fold skipped during CPU "
                              "failover")
        else:
            sk.fold(tenants, skeys, kcounts, chunk)
        phases["sketch_s"] = time.perf_counter() - t0

    def _make_query_eval(self, fields):
        """The epoch's query evaluator: a closure over the retained
        post-fold field tensors that runs the flush extract again at any
        quantile vector, f32[P] -> (packed [s_eff, P+10] host array, P).
        The same kernel over the same tensors is what makes a query at
        the flush quantiles bitwise the flush's readback. Nothing writes
        these tensors after the extract: a swapped epoch owns its pool.

        It runs under the guard's ``query`` op on the worker's device (the
        kernel on the card); a classified fault, or an epoch that failed
        over (its fields on the CPU of a card's worker), runs the plain
        version over host copies: the same bits. None when the epoch had
        no histogram rows."""
        if fields is None:
            return None

        def host(flds, qnp):
            out = ek.flush_extract(*flds, torch.from_numpy(qnp))
            return out.numpy(), qnp.shape[0]

        if _is_sharded(fields):
            # the kernel once per shard, the readback in logical order
            sh = self._shard
            perm = sh.perm_l2p(_rows(fields[0]))

            def evaluate_sharded(qs_np: np.ndarray) -> tuple[np.ndarray, int]:
                qnp = np.asarray(qs_np, dtype=np.float32)

                def run():
                    blocks = sh.flush_extract(fields, sh.replicate(qnp))
                    return np.concatenate([b.cpu().numpy()
                                           for b in blocks])[perm]

                try:
                    return (self.guard.call("query", run, retryable=True),
                            qnp.shape[0])
                except dg.DeviceFaultError:
                    return host(self._fields_to_host(fields), qnp)

            return evaluate_sharded

        if fields[0].device.type != self.device.type:
            return lambda qs_np: host(fields, np.asarray(qs_np, np.float32))

        def evaluate(qs_np: np.ndarray) -> tuple[np.ndarray, int]:
            qnp = np.asarray(qs_np, dtype=np.float32)

            def run():
                qs = _to_device(qnp, fields[0].device)
                return self._extract(fields, qs).cpu().numpy()

            try:
                return (self.guard.call("query", run, retryable=True),
                        qnp.shape[0])
            except dg.DeviceFaultError:
                return host(self._fields_to_host(fields), qnp)

        return evaluate

    def _extract_histo(self, snap: FlushSnapshot, swapped: SwappedEpoch,
                       pending: list, spill: Optional[tuple],
                       quantiles: np.ndarray, phases: dict,
                       mark_degraded) -> tuple:
        """The histogram half of the extraction, on the device under the
        guard. A classified fault moves the newest fold state to the CPU
        and the same steps resume there from where the device stopped
        (``progress``: the fold state and the spill samples in it), with
        the mirror replaced by its host replay. A quarantined epoch runs
        on the CPU throughout. Returns the folded fields the extract read
        (on the CPU after a failover)."""
        progress = {"fields": swapped.histo.fields(), "spill_off": 0}
        if swapped.host:
            mark_degraded()
            self._histo_steps(snap, swapped, pending, spill, quantiles,
                              phases, progress, _unguarded)
            return progress["fields"]
        try:
            self._histo_steps(snap, swapped, pending, spill, quantiles,
                              phases, progress, self.guard.call)
        except dg.DeviceFaultError as exc:
            log.error("device fault during extraction (%s); completing the "
                      "flush on the CPU", exc)
            mark_degraded()
            progress["fields"] = self._fields_to_host(progress["fields"])
            self._histo_steps(snap, swapped, pending, spill, quantiles,
                              phases, progress, _unguarded)
        return progress["fields"]

    def _histo_steps(self, snap: FlushSnapshot, swapped: SwappedEpoch,
                     pending: list, spill: Optional[tuple],
                     quantiles: np.ndarray, phases: dict, progress: dict,
                     call) -> None:
        """Spill fold, staged folds, mirror fold, extract and readbacks,
        each device step through ``call`` (the guard, or a plain call on
        the CPU), resuming from ``progress``. Every bounded step beats the
        governor, so the watchdog sees a long fold as progress. With the
        governor's ``flush_chunk_target_ms`` the device extract runs in
        pow2 row chunks (``_extract_chunked``); the device path's
        transfers book into the ledger."""
        n = snap.directory.num_histo_rows
        on_device = call is not _unguarded
        gov = self.governor
        beat = gov.beat if gov is not None else (lambda: None)
        full = progress["fields"]
        t0 = time.perf_counter()
        if spill is not None and progress["spill_off"] < len(spill[0]):
            # the hot-row spill backlog swap deferred, folded in bounded
            # chunks at the full pool's shape; the measured rate sizes the
            # next swap's shed budget
            sp_rows, sp_vals, sp_wts = spill
            start = progress["spill_off"]

            def chunk(i):
                return (sp_rows[i:i + _FOLD_CHUNK], sp_vals[i:i + _FOLD_CHUNK],
                        sp_wts[i:i + _FOLD_CHUNK])

            if progress.get("update") is not None:
                # the device's writes of this chunk faulted partway: they
                # land on the CPU pool, not a second fold
                full = self._land_held_update(full, progress["update"],
                                              chunk(start))
                progress["update"] = None
                start = progress["spill_off"] = min(start + _FOLD_CHUNK,
                                                    len(sp_rows))
            for k, i in enumerate(range(start, len(sp_rows), _FOLD_CHUNK)):
                full = call("spill", self._fold_spill_chunk, full, *chunk(i),
                            held=progress)
                progress["spill_off"] = min(i + _FOLD_CHUNK, len(sp_rows))
                if k % 8 == 7:
                    beat()
            call("spill", _sync_on, full[0])
            beat()
            t_fold = time.perf_counter() - t0
            if on_device and t_fold > 0.01:
                self._fold_rate_ewma = (0.5 * self._fold_rate_ewma + 0.5
                                        * (len(sp_rows) - start) / t_fold)
        # fold + extract over the used rows only (pow2-bucketed, as the
        # reference does): the pool is up to 2x oversized from growth
        s_eff = min(swapped.histo.num_rows, _next_pow2(n, 1024))
        # a sharded pool shrinks per shard (each keeps its local prefix:
        # the interleave closure property); after a failover the fields
        # are the logical CPU pool
        sh = self._shard if _is_sharded(full) else None
        if sh is not None:
            fields = tuple(sh.slice_field(a, s_eff) for a in full)
        else:
            fields = tuple(a if a.shape[0] == s_eff else a[:s_eff]
                           for a in full)
        progress["fields"] = fields
        while pending:
            fields = self._fold_one_plane(fields, pending, s_eff, call)
            progress["fields"] = fields
            beat()
        if on_device:
            if swapped.micro_residual is not None:
                # the deltas the scheduler had not streamed by the swap
                # land on the device here, as the batch path's upload would
                mirror, coos = swapped.micro_residual
                swapped.micro_residual = None
                for coo in coos:
                    mirror.feed(*coo)
                swapped.device_stage = mirror.finish()
            dstage = swapped.device_stage
            swapped.device_stage = None
            if dstage is not None:
                self.last_micro_chunks = dstage.chunks
                self.last_micro_bytes = dstage.nbytes
                fields = call("staged", self._fold_mirror, fields, dstage,
                              s_eff)
                progress["fields"] = fields
                beat()
        else:
            # the mirror is device state: its samples fold from the host
            # replay swap kept
            swapped.device_stage = swapped.micro_residual = None
            if swapped.micro_replay is not None:
                fields = self._fold_one_plane(
                    fields, [swapped.micro_replay], s_eff, call)
                progress["fields"] = fields
                beat()
        # the mirror's content is folded: its replay is not needed
        swapped.micro_replay = None
        call("staged", _sync_on, fields[0])
        t1 = time.perf_counter()
        # quantiles travel as f64 on the host; f32 at the device boundary
        qnp = np.asarray(quantiles, dtype=np.float32)
        d = sh.shards if sh is not None else 1
        run = (gov.begin_extract(s_eff, d)
               if on_device and gov is not None and gov.enabled else None)
        if on_device:
            # replicated on every shard: booked once a shard
            self.ledger.count_h2d(qnp.nbytes * d, "quantiles")
        perm = None
        if sh is not None:
            # the kernel once per shard, each shard's packed block read
            # back; the assembled physical order goes to logical through
            # the permutation
            qs = call("extract", sh.replicate, qnp, retryable=True)

            def extract(fl):
                return [t.cpu().numpy() for t in sh.flush_extract(fl, qs)]
        else:
            qs = call("extract", _to_device, qnp, fields[0].device,
                      retryable=True)

            def extract(fl):
                return self._extract(fl, qs).cpu().numpy()

        if run is None:
            packed = call("extract", extract, fields, retryable=True)
            if sh is not None:
                self.ledger.count_d2h_shards([b.nbytes for b in packed],
                                             "extract_packed")
                packed = np.concatenate(packed)
                perm = sh.perm_l2p(s_eff)
            elif on_device:
                self.ledger.count_d2h(packed.nbytes, "extract_packed")
        else:
            packed = self._extract_chunked(fields, run, extract, call, sh)
        phases["fold_s"] = t1 - t0
        phases["extract_s"] = time.perf_counter() - t1
        p = qnp.shape[0]
        qv, (dmin, dmax, dsum, dcount, drecip, lmin, lmax, lsum, lweight,
             lrecip) = unpack_extract_columns(packed, p, perm)
        snap.quantile_values = qv[:n]
        snap.quantile_qs = np.asarray(quantiles, dtype=np.float64)
        snap.dmin, snap.dmax = dmin[:n], dmax[:n]
        snap.dsum, snap.dcount, snap.drecip = dsum[:n], dcount[:n], drecip[:n]
        snap.lmin, snap.lmax = lmin[:n], lmax[:n]
        snap.lsum, snap.lweight, snap.lrecip = lsum[:n], lweight[:n], lrecip[:n]
        # the centroid rows are read back only where forwarding could
        # consume them (a local tier), as in the reference
        if self.is_local:
            if sh is not None:
                means, weights = call(
                    "extract", lambda fl: (sh.to_host(fl[0]),
                                           sh.to_host(fl[1])),
                    fields, retryable=True)
                self.ledger.count_d2h_shards(
                    [(means.nbytes + weights.nbytes) // d] * d,
                    "forward_digests")
                l2p = sh.perm_l2p(s_eff)[:n]
                snap.digest_means = means[l2p]
                snap.digest_weights = weights[l2p]
                return
            means, weights = call(
                "extract", lambda fl: (fl[0].cpu().numpy(),
                                       fl[1].cpu().numpy()),
                fields, retryable=True)
            if on_device:
                self.ledger.count_d2h(means.nbytes + weights.nbytes,
                                      "forward_digests")
            snap.digest_means, snap.digest_weights = means[:n], weights[:n]

    def _extract_chunked(self, fields: tuple, run, extract, call,
                         sh=None) -> np.ndarray:
        """The governed extraction (the JAX worker's degraded mode): one
        flush extract over each pow2 row chunk the governor's ChunkRun
        hands out, each chunk its own guarded launch and packed readback,
        then the chunks concatenated in row order. A chunk of a pow2 pool
        is a contiguous row slice of every field, so its base stays
        16-byte aligned for the kernel's bulk copies; the kernel checks
        that and raises on a misaligned base rather than copying. The
        governor chunks only pow2 totals, so a slice never runs past the
        pool: the JAX package's dynamic_slice would clamp such a start
        and a torch slice would truncate it, and neither happens. Each
        chunk is timed up to its readback (``.cpu()`` waits for the
        launch), since the measured rate sizes the next chunk. Sharded
        (``sh``), a chunk is the lockstep local slice of every shard
        (slice_chunk), its readback put in logical order by the chunk's
        permutation, so the concatenation is logical end to end."""
        parts = []
        while (c := run.next_rows()):
            t0 = time.perf_counter()
            lo = run.start
            if sh is not None:
                blocks = call("extract", extract,
                              tuple(sh.slice_chunk(a, lo, c) for a in fields),
                              retryable=True)
                self.ledger.count_d2h_shards([b.nbytes for b in blocks],
                                             "extract_packed")
                pk = np.concatenate(blocks)[sh.chunk_perm(c)]
            else:
                pk = call("extract", extract,
                          tuple(a[lo:lo + c] for a in fields),
                          retryable=True)
                self.ledger.count_d2h(pk.nbytes, "extract_packed")
            parts.append(pk)
            run.note(c, time.perf_counter() - t0)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def _extract_sets(self, snap: FlushSnapshot, swapped: SwappedEpoch,
                      phases: dict, mark_degraded) -> None:
        """Set estimates (the hll_estimate kernel on the card) and, where
        the reference reads them back, the register rows (their wall time
        is ``set_registers_s``, a part of ``sets_s``). A fault, or a pool
        already on the CPU, gives the CPU's bitwise-equal estimate."""
        n = snap.directory.num_set_rows
        staged = swapped.staged_sets
        if staged is not None:
            snap.set_estimates = staged.estimates(n)
            # register materialization is [n, 2^p] host bytes — only pay
            # it where forwarding can read it (locals forward mixed sets)
            if self.is_local:
                t0 = time.perf_counter()
                snap.set_registers = staged.registers(n)
                phases["set_registers_s"] = time.perf_counter() - t0
            if staged.host_mode:
                mark_degraded()
            return
        sets = swapped.sets
        if sets is None:
            return
        p = self.hll_precision
        if isinstance(sets, tuple):
            # the estimate kernel once per shard; both readbacks in
            # logical order
            sh = self._shard
            try:
                snap.set_estimates = self.guard.call(
                    "extract",
                    lambda: sh.logical(sh.hll_estimate(sets, p))[:n],
                    retryable=True)
                t0 = time.perf_counter()
                snap.set_registers = self.guard.call(
                    "extract", lambda: sh.logical(sets)[:n], retryable=True)
                phases["set_registers_s"] = time.perf_counter() - t0
                return
            except dg.DeviceFaultError:
                sets = self._sets_to_host(sets)
        elif not swapped.host and sets.device.type == self.device.type:
            try:
                snap.set_estimates = self.guard.call(
                    "extract",
                    lambda: hll_ops.estimate(sets, p).cpu().numpy()[:n],
                    retryable=True)
                t0 = time.perf_counter()
                snap.set_registers = self.guard.call(
                    "extract", lambda: sets[:n].cpu().numpy(),
                    retryable=True)
                phases["set_registers_s"] = time.perf_counter() - t0
                return
            except dg.DeviceFaultError:
                sets = dg.host_copy(sets, "set pool")
        mark_degraded()
        snap.set_estimates = hll_ops.estimate(sets, p).numpy()[:n]
        snap.set_registers = sets[:n].numpy()

    def flush(self, quantiles: np.ndarray, interval_s: float = 10.0
              ) -> FlushSnapshot:
        """Swap state and extract the finished interval in one call."""
        return self.extract_snapshot(self.swap(quantiles), quantiles,
                                     interval_s)
