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
extraction (``_histo_fold_staged``). Set samples hash on the host into
(register, rank) and go to the set store: the staged store (sparse host
tier, dense device tier; ops/staged_sets.py) by default, or one dense
device pool (``set_store="dense"``). Counters, gauges, status checks and
the unique-timeseries HLL stay host-side. On the card the flush extract,
the set inserts and the set estimates run hand-written CUDA kernels
(ops/extract_kernel.py, ops/hll.py).

With ``attach_native()`` the C++ ingest pipeline (veneur_tpu_torch/
native.py, built from native/) parses datagrams, assigns rows and stages
raw histogram samples in its own [S, B] plane: ``ingest_datagram`` feeds
it, ``drain_native`` moves its batches (hot-row spill, set updates,
counters, gauges) into the pools and adopts its new series into the
directory, and at flush the plane is compacted on the host, uploaded
flat and rebuilt on the device (``_expand_flat_planes``) before the
staged fold. The Python-side paths share the native directory through
its upsert.

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

Not in this slice (config refuses them, see core/factory.py): series
sharding, reader shards, tenancy, the query view, imports, the mesh.
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
from veneur_tpu_torch.core.metrics import MetricKey, UDPMetric, route_info
from veneur_tpu_torch.device import resolve
from veneur_tpu_torch.ops import device_guard as dg
from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import extract_kernel as ek
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import hll_kernel
from veneur_tpu_torch.ops import microfold as mf
from veneur_tpu_torch.ops import tdigest as td
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


def _sync_on(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s device (a CPU tensor has
    none). Inside a guarded call it surfaces that work's CUDA errors."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _unguarded(op: str, fn, *args, retryable: bool = False, **kwargs):
    """DeviceGuard.call's signature without the guard: the failover
    engine's programs run on the CPU and are never injected into."""
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Device steps


def _comp_add(s, c, x):
    """Neumaier compensated add: (sum, compensation) += x, in f32. The
    true value is s + c, resolved at flush extraction."""
    t = s + x
    # larger-magnitude operand is the residual's base; an overflow (t
    # infinite) drops the residual so the sum saturates like a bare add
    resid = torch.where(torch.abs(s) >= torch.abs(x), (s - t) + x,
                        (x - t) + s)
    resid = torch.where(torch.isfinite(t), resid, 0.0)
    return t, c + resid


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
    n_recip, n_recip_c = _comp_add(g_recip, drecip_c[active], stats.recip)
    n_lsum, n_lsum_c = _comp_add(lsum[active], lsum_c[active], stats.sum)
    n_lw, n_lw_c = _comp_add(lweight[active], lweight_c[active],
                             stats.weight)
    n_lr, n_lr_c = _comp_add(lrecip[active], lrecip_c[active], stats.recip)
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
    lmin.scatter_reduce_(0, active, s_min, reduce="amin")
    lmax.scatter_reduce_(0, active, s_max, reduce="amax")
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
    tensors (new tensors; the inputs may be dropped)."""
    c = means.shape[1]
    live = swts > 0
    s_w = exn.tsum(swts)
    s_sum = exn.tsum(torch.where(live, svals * swts, 0.0))
    s_recip = exn.tsum(torch.where(live, swts / svals, 0.0))
    s_min = torch.amin(torch.where(live, svals, _INF), dim=-1)
    s_max = torch.amax(torch.where(live, svals, -_INF), dim=-1)

    cat_means = torch.cat([means, svals], dim=-1)
    cat_w = torch.cat([weights, swts], dim=-1)
    means, weights = td._compress_rows(cat_means, cat_w, compression, c)

    dmin = torch.minimum(dmin, s_min)
    dmax = torch.maximum(dmax, s_max)
    drecip, drecip_c = _comp_add(drecip, drecip_c, s_recip)
    lmin = torch.minimum(lmin, s_min)
    lmax = torch.maximum(lmax, s_max)
    lsum, lsum_c = _comp_add(lsum, lsum_c, s_sum)
    lweight, lweight_c = _comp_add(lweight, lweight_c, s_w)
    lrecip, lrecip_c = _comp_add(lrecip, lrecip_c, s_recip)
    return (means, weights, dmin, dmax, drecip, drecip_c,
            lmin, lmax, lsum, lsum_c, lweight, lweight_c, lrecip, lrecip_c)


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
    def create(cls, rows: int, capacity: int, device=None
               ) -> "HistoDeviceState":
        """An empty state on ``device`` (none asked for: the card)."""
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
        return self.means.shape[0]

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

    def grow(self, new_rows: int) -> "HistoDeviceState":
        # zero-filled new mean rows are safe: every kernel keys empty
        # slots off weight == 0, never the stored mean
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
        self.count_unique_timeseries = count_unique_timeseries
        self.is_local = is_local
        self.set_store = set_store
        # the C++ context (attach_native); None keeps the Python path
        self._native = None
        self._native_epoch_closed = False
        self._native_errs_seen = 0
        self._native_proc_seen = 0
        self._native_drop_seen = 0
        self.processed = 0
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
        self._reset_epoch()

    @property
    def processed(self) -> int:
        """Samples accepted this epoch, the native context's (committed
        off the Python path) included."""
        n = self._processed_py
        if self._native is not None:
            n += int(self._native.processed) - self._native_proc_seen
        return n

    @processed.setter
    def processed(self, v: int) -> None:
        # keeps `processed += k` exact: the native delta the getter adds
        # is taken back out
        nd = 0
        if self._native is not None:
            nd = int(self._native.processed) - self._native_proc_seen
        self._processed_py = v - nd

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
        self._processed_py = 0
        self.directory = SeriesDirectory()
        self.scalars = HostScalars()
        self._micro_fault_epoch = False
        self._histo: Optional[HistoDeviceState] = None
        # dense set pool (set_store="dense"); the staged store (the
        # default) keeps its own dense tier
        self._sets: Optional[torch.Tensor] = None
        self._staged_sets = (StagedSetStore(self.hll_precision,
                                            device=self.device,
                                            guard=self.guard,
                                            host=self._host_live)
                             if self.set_store == "staged" else None)
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
        # unique-timeseries HLL registers (host, tiny)
        m = hll_ops.num_registers(self.hll_precision)
        self._umts = (np.zeros(m, dtype=np.int8)
                      if self.count_unique_timeseries else None)

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
        if self._histo is None:
            rows = _next_pow2(needed_rows + 1, self._initial_histo_rows)
            self._histo = HistoDeviceState.create(rows, self.capacity,
                                                  self._live_device)
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
                                          new_rows)
        except dg.DeviceFaultError as exc:
            self.guard.bump("device.valve.grow_oom")
            self.guard.trip(f"pool growth to {new_rows} rows faulted "
                            f"[{exc.kind}]: HBM valve")
            self._quarantine_live()
            self._histo = self._histo.grow(new_rows)

    def _grow_preflight(self, new_rows: int) -> None:
        probe = torch.empty((new_rows, 2 * self.capacity),
                            dtype=torch.float32, device=self.device)
        del probe

    def _sets_on_host(self) -> bool:
        """The dense set pool runs on the failover engine: the live epoch
        is quarantined, or a set fault moved the pool to the CPU on its
        own (a CPU worker's pool has nowhere to move)."""
        return self._host_live or (
            self._sets is not None
            and self._sets.device.type != self.device.type)

    def _ensure_sets(self, needed_rows: int) -> None:
        if self.guard.quarantined and not self._host_live:
            self._quarantine_live()
        if self._staged_sets is not None:
            return  # the staged store sizes itself
        # one scratch row at the top pads the insert batches
        if self._sets is None:
            rows = _next_pow2(needed_rows + 1, self._initial_set_rows)
            self._sets = hll_ops.init_pool(rows, self.hll_precision,
                                           self._live_device)
            return
        if needed_rows + 1 <= self._sets.shape[0]:
            return
        self._flush_pending_sets()  # pending rows use the old scratch
        new_rows = _next_pow2(needed_rows + 1, self._sets.shape[0] * 2)
        if self._sets_on_host():
            self._sets = _grow_2d(self._sets, new_rows)
            return
        try:
            self._sets = self.guard.call("grow", _grow_2d, self._sets,
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
        self.processed += 1
        mtype = m.key.type
        scope_class = classify(mtype, m.scope)
        if self._umts is not None and self._should_count_timeseries(
                mtype, scope_class):
            self._insert_timeseries(m.digest)
        if mtype == "counter":
            self._host_counter(m.key, scope_class, m.tags,
                               counter_contribution(m.value, m.sample_rate))
        elif mtype == "gauge":
            self._host_gauge(m.key, scope_class, m.tags, float(m.value))
        elif mtype in ("histogram", "timer"):
            row = self._upsert_histo(m.key, scope_class, m.tags)
            self._ensure_histo(max(self.directory.num_histo_rows, row + 1))
            self._ph_rows.append(row)
            self._ph_vals.append(float(m.value))
            self._ph_wts.append(1.0 / m.sample_rate)
            if len(self._ph_rows) >= self.batch_size:
                self._flush_pending_histos()
        elif mtype == "set":
            row = self._upsert_set(m.key, scope_class, m.tags)
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

    def _upsert_histo(self, key: MetricKey, scope_class: ScopeClass,
                      tags: list[str]) -> int:
        if self._native is not None:
            # the native directory assigns the row; its metadata is
            # adopted in batches (every 1,024 new series, and always
            # before extraction: swap's drain syncs)
            row = self._native.upsert(key.name, key.type, key.joined_tags,
                                      int(scope_class))
            if self._native.pending_new_series >= 1024:
                self.sync_native_series()
            return row
        row, _ = self.directory.upsert_histo(key, scope_class, tags)
        return row

    def _upsert_set(self, key: MetricKey, scope_class: ScopeClass,
                    tags: list[str]) -> int:
        if self._native is not None:
            row = self._native.upsert(key.name, "set", key.joined_tags,
                                      int(scope_class))
            if self._native.pending_new_series >= 1024:
                self.sync_native_series()
            return row
        row, _ = self.directory.upsert_set(key, scope_class, tags)
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
        if self._native is not None:
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
        if self._native is not None:
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
        if self.stage_depth > 0:
            self._native.set_stage_depth(self.stage_depth)
        if self.spill_cap:
            self._native.set_spill_cap(self.spill_cap)
        return True

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

    def _sync_native_series(self) -> None:
        """Adopt the context's new-series records into the directory and
        the scalar pools, at the rows the context assigned (in order).
        Caller holds the context lock."""
        from veneur_tpu_torch.native import NativeIngest

        ctx = self._native
        if not ctx.pending_new_series:
            return
        cache = self._adopt_cache
        for pool, row, kind, scope, name, joined in ctx.drain_new_series():
            ck = (pool, kind, scope, name, joined)
            meta = cache.get(ck)
            if meta is None:
                key = MetricKey(name=name, type=NativeIngest.TYPE_BY_KIND[kind],
                                joined_tags=joined)
                tags = joined.split(",") if joined else []
                meta = RowMeta(key=key, tags=tags,
                               scope_class=ScopeClass(scope),
                               sinks=route_info(tags))
                if len(cache) >= 4_000_000:
                    # unbounded series churn: drop the cache rather than
                    # grow without limit
                    cache.clear()
                cache[ck] = meta
            if self.count_unique_timeseries:
                self._sample_timeseries_key(name, meta.key.type, joined,
                                            meta.scope_class)
            if pool == 0:
                self.directory.histo.adopt_meta(row, meta)
            elif pool == 1:
                self.directory.sets.adopt_meta(row, meta)
            else:
                scalars = (self.scalars.counters if pool == 2
                           else self.scalars.gauges)
                scalars.adopt_row(row, meta.key, meta.tags,
                                  meta.scope_class, meta.sinks,
                                  frag=meta.wire_frag())

    def sync_native_series(self) -> None:
        """Adopt pending new-series registrations mid-epoch, so swap only
        adopts the tail. Caller holds the worker lock; takes the context
        lock itself."""
        if self._native is None:
            return
        self._native.lock()
        try:
            self._sync_native_series()
        finally:
            self._native.unlock()

    def native_series_pending(self) -> bool:
        """Lock-free probe for undrained new-series records."""
        return self._native is not None and bool(
            self._native.pending_new_series)

    def drain_native(self) -> None:
        """Move everything pending in the native pipeline into device and
        host state. The context lock is held across the raw drain, so a
        reader thread's commit cannot land between its calls; the device
        work runs after it is released."""
        if self._native is None:
            return
        self._native.lock()
        try:
            raw = self._drain_native_raw()
        finally:
            self._native.unlock()
        self._apply_native_raw(raw)

    def _drain_native_raw(self, detach_stage: bool = False):
        """Pull the raw sample batches and bookkeeping out of the context.
        Caller holds the context lock. Samples drain before the series
        sync: a sample's series record is committed with or before it, so
        no drained sample lacks its row's metadata. ``detach_stage``
        (swap only) also detaches the staging plane and the event lines,
        in the same critical section as the epoch's reset."""
        ctx = self._native
        errs = int(ctx.errors)
        dropped = int(ctx.overload_dropped)
        self.parse_errors += errs - self._native_errs_seen
        self._native_errs_seen = errs
        delta = dropped - self._native_drop_seen
        self._native_drop_seen = dropped
        self.overload_dropped += delta
        self.overload_dropped_total += delta
        n = ctx.pending_histo
        h = ctx.drain_histo(n) if n else None
        n = ctx.pending_set
        s = ctx.drain_set(n) if n else None
        c = ctx.drain_counter(ctx.pending_counter)
        g = ctx.drain_gauge(ctx.pending_gauge)
        st, others = None, []
        if detach_stage:
            st = ctx.detach_stage()
            others = ctx.drain_other()
        self._sync_native_series()
        return h, s, c, g, st, others

    def _apply_native_raw(self, raw, defer_histo_spill: bool = False):
        """Apply drained batches to the pools (no context lock held). With
        staging on, the histogram batch is hot-row spill: folded directly
        in bounded chunks, or with ``defer_histo_spill`` (swap) returned
        for extract_snapshot to fold; None when nothing was deferred."""
        h, s, c, g, _st, _others = raw
        deferred = None
        if h is not None and len(h[0]):
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
        shed (the newest kept), counted as overload drops."""
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
        return tuple(a[-budget:] for a in spill_histo)

    # -- micro-folds --------------------------------------------------------

    def _micro_active(self) -> bool:
        """Micro-folds run where the staged fold exists (staging on) and
        the device path is healthy: a quarantined worker has no device
        to mirror into, and an epoch whose mirror faulted keeps every
        sample in its staging plane instead."""
        return (self.micro_fold and self.stage_depth > 0
                and not self._host_live and not self.guard.quarantined
                and not self._micro_fault_epoch)

    def _new_mirror(self) -> mf.MicroFoldMirror:
        return mf.MicroFoldMirror(self.stage_depth, self.device,
                                  initial_rows=self._initial_histo_rows,
                                  guard=self.guard)

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
        """The 14 fold-state tensors on the CPU. Where the readback fails
        (a sticky CUDA error took the state with it) an empty pool of
        the same rows, logged: honest data loss, not a dead flush."""
        try:
            return tuple(t.cpu() for t in fields)
        except Exception:
            log.exception("device fold state unreadable during failover; "
                          "restarting from an empty pool on the CPU")
            return HistoDeviceState.create(int(fields[0].shape[0]),
                                           self.capacity, "cpu").fields()

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
            self._sets = dg.host_copy(self._sets, "set pool")
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

        def upload():
            h = None if self._histo is None else self._histo.to(self.device)
            sets = None if self._sets is None else self._sets.to(self.device)
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
            self.guard.call("sets", self._set_inserter.insert, self._sets,
                            rows, idx, rank, retryable=True)
        except dg.DeviceFaultError:
            # max-merges: a partly applied update applied again on the
            # CPU only re-asserts ranks
            if self.guard.quarantined:
                self._quarantine_live()
            else:
                self._sets = dg.host_copy(self._sets, "set pool")
            self._device_set_step(rows, idx, rank)

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

    @staticmethod
    def _write_synced(fields: tuple, update: tuple) -> None:
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
        self.processed_total += self.processed
        native_stage = None
        spill_histo = None
        micro_coo: list = []
        native_mirrored = False
        if self._native is not None:
            # drain, detach the staging plane and close the native epoch
            # under one lock hold: a routed commit could otherwise land
            # between the last drain and the reset and die with the epoch
            self._native.lock()
            try:
                if self._micro_active():
                    # the residual delta in the same critical section as
                    # the detach (host copies only; the device feeds run
                    # at extraction)
                    cap = 1 << 18
                    while True:
                        coo = self._native.drain_stage_delta(cap)
                        if not len(coo[0]):
                            break
                        micro_coo.append(coo)
                        if len(coo[0]) < cap:
                            break
                    native_mirrored = self._native.stage_pending == 0
                raw = self._drain_native_raw(detach_stage=True)
                native_stage = raw[4]
                # event and service-check lines caught at epoch close; the
                # server parses them into the new epoch
                self.pending_other_lines = raw[5]
                self._native.reset()
                self._native_errs_seen = 0
                self._native_proc_seen = 0
                self._native_drop_seen = 0
                self._native_epoch_closed = True
            finally:
                self._native.unlock()
            spill_histo = self._shed_spill_budget(
                self._apply_native_raw(raw, defer_histo_spill=True))
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
        micro_residual = None
        if self._micro_active():
            if self._native is None:
                coo = self._python_stage_delta()
                if coo is not None:
                    micro_coo.append(coo)
            mirror, self._micro = self._micro, None
            if (mirror is not None and mirror.samples > 0) or any(
                    len(c[0]) for c in micro_coo):
                micro_residual = (mirror or self._new_mirror(), micro_coo)
        self.micro_folds_swapped = self.micro_folds_epoch
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
            mesh_out=None, staged_histo=staged_histo or None,
            spill_histo=spill_histo, micro_residual=micro_residual,
            micro_replay=micro_replay, host=self._host_live)
        self.processed = 0
        self._reset_epoch()
        return swapped

    def _fold_one_plane(self, fields: tuple, pending: list, s_eff: int,
                        call) -> tuple:
        """Fold pending[0] into the digest fields and pop it. A native
        plane is first compacted on the host (the filled slots row-major
        and the per-row counts: O(samples) bytes where the dense plane is
        O(S·B)), released, and re-staged as those host copies, so a fault
        in the fold leaves it replayable; a compacted plane uploads flat
        and is rebuilt on the device by ``_expand_flat_planes``, a dense
        Python plane uploads as it is. The upload and the fold are one
        ``call("staged", ...)``."""
        plane: StagedPlane = pending[0]
        if plane.free is not None:
            # the native plane grows on its own pow2 schedule and may
            # trail the pool's; rows past its end are empty
            host = _compact_plane(plane.vals, plane.wts, plane.counts,
                                  min(plane.vals.shape[0], s_eff))
            plane.free()
            plane = pending[0] = host
        depth = self.stage_depth

        def fold_flat(fl):
            dev = fl[0].device
            counts = plane.counts
            if len(counts) < s_eff:
                counts = np.pad(counts, (0, s_eff - len(counts)))
            else:
                counts = counts[:s_eff]
            unit = plane.wts is None
            n_pad = _next_pow2(max(len(plane.vals), 1), 1024)
            fv = np.zeros(n_pad, np.float32)
            fv[:len(plane.vals)] = plane.vals
            fvj = _to_device(fv, dev)
            cj = _to_device(counts.astype(np.int32), dev)
            nbytes = fv.nbytes + counts.size * 4
            if unit:
                fwj = fvj  # ignored under unit=True
            else:
                fw = np.zeros(n_pad, np.float32)
                fw[:len(plane.wts)] = plane.wts
                fwj = _to_device(fw, dev)
                nbytes += fw.nbytes
            self.last_plane_upload_bytes += nbytes
            svj, swj = _expand_flat_planes(fvj, fwj, cj, depth, unit)
            return _histo_fold_staged(*fl, svj, swj,
                                      compression=self.compression)

        def fold_dense(fl):
            dev = fl[0].device
            svj = _to_device(plane.vals[:s_eff], dev)
            swj = _to_device(plane.wts[:s_eff], dev)
            self.last_plane_upload_bytes += (svj.numel() + swj.numel()) * 4
            if svj.shape[0] < s_eff:
                pad = torch.zeros((s_eff - svj.shape[0], svj.shape[1]),
                                  dtype=torch.float32, device=dev)
                svj = torch.cat([svj, pad])
                swj = torch.cat([swj, pad])
            return _histo_fold_staged(*fl, svj, swj,
                                      compression=self.compression)

        fields = call("staged", fold_flat if plane.counts is not None
                      else fold_dense, fields)
        pending.pop(0)
        return fields

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
        active, lids, v, w = self._pad_spill_batch(
            rows, vals, wts, fields[0].shape[0] - 1)
        dev = fields[0].device
        update = _histo_ingest_rows(
            *fields, _to_device(active, dev), _to_device(lids, dev),
            _to_device(v, dev), _to_device(w, dev),
            compression=self.compression)
        if held is not None:
            held["update"] = update
        _write_ingest_rows(fields, update)
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
            update = tuple(t.cpu() for t in update)
        except Exception:
            log.exception("spill update unreadable during failover; folding "
                          "the batch again on the CPU")
            return self._fold_spill_chunk(fields, *batch)
        _write_ingest_rows(fields, update)
        return fields

    def _fold_mirror(self, fields: tuple, dstage: mf.MirrorState,
                     s_eff: int) -> tuple:
        """The staged fold over the micro-fold mirror: the plane is
        already on the device, and mirror_dense is bitwise the plane the
        batch path would upload."""
        return _histo_fold_staged(*fields, mf.mirror_dense(dstage.vals, s_eff),
                                  mf.mirror_dense(dstage.wts, s_eff),
                                  compression=self.compression)

    def extract_snapshot(self, swapped: SwappedEpoch,
                         quantiles: np.ndarray,
                         interval_s: float = 10.0) -> FlushSnapshot:
        """Fold and read back a swapped epoch. Touches only the swapped
        objects, never the live epoch. A classified device fault finishes
        the flush on the CPU (flagged ``degraded``)."""
        snap = FlushSnapshot(directory=swapped.directory,
                             scalars=swapped.scalars, interval_s=interval_s,
                             unique_timeseries_registers=swapped.umts)

        def mark_degraded():
            if not snap.degraded:
                snap.degraded = True
                self.host_fallback_flushes += 1
                log.error("flush completed on the CPU failover engine "
                          "(degraded)")

        pending = list(swapped.staged_histo or ())
        swapped.staged_histo = None
        # the deferred spill backlog is taken whatever happens below: with
        # no pool to fold into, its samples are counted as shed
        spill = swapped.spill_histo
        swapped.spill_histo = None
        phases: dict[str, float] = {}
        self.last_plane_upload_bytes = 0
        self.last_micro_chunks = self.last_micro_bytes = 0
        if swapped.histo is not None and swapped.directory.num_histo_rows:
            try:
                self._extract_histo(snap, swapped, pending, spill,
                                    quantiles, phases, mark_degraded)
            finally:
                # an upload or fold failure must not leak the C++ planes
                _free_staged_planes(pending)
        else:
            _free_staged_planes(pending)
            if spill is not None and len(spill[0]):
                self.overload_dropped += len(spill[0])
                self.overload_dropped_total += len(spill[0])
        # a mirror with no rows to fold into holds nothing to lose
        swapped.device_stage = None
        swapped.micro_residual = None
        swapped.micro_replay = None
        if swapped.directory.num_set_rows:
            t0 = time.perf_counter()
            self._extract_sets(snap, swapped, phases, mark_degraded)
            phases["sets_s"] = time.perf_counter() - t0
        self.last_extract_phases = phases
        return snap

    def _extract_histo(self, snap: FlushSnapshot, swapped: SwappedEpoch,
                       pending: list, spill: Optional[tuple],
                       quantiles: np.ndarray, phases: dict,
                       mark_degraded) -> None:
        """The histogram half of the extraction, on the device under the
        guard. A classified fault moves the newest fold state to the CPU
        and the same steps resume there from where the device stopped
        (``progress``: the fold state and the spill samples in it), with
        the mirror replaced by its host replay. A quarantined epoch runs
        on the CPU throughout."""
        progress = {"fields": swapped.histo.fields(), "spill_off": 0}
        if swapped.host:
            mark_degraded()
            self._histo_steps(snap, swapped, pending, spill, quantiles,
                              phases, progress, _unguarded)
            return
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

    def _histo_steps(self, snap: FlushSnapshot, swapped: SwappedEpoch,
                     pending: list, spill: Optional[tuple],
                     quantiles: np.ndarray, phases: dict, progress: dict,
                     call) -> None:
        """Spill fold, staged folds, mirror fold, extract and readbacks,
        each device step through ``call`` (the guard, or a plain call on
        the CPU), resuming from ``progress``."""
        n = snap.directory.num_histo_rows
        on_device = call is not _unguarded
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
            for i in range(start, len(sp_rows), _FOLD_CHUNK):
                full = call("spill", self._fold_spill_chunk, full, *chunk(i),
                            held=progress)
                progress["spill_off"] = min(i + _FOLD_CHUNK, len(sp_rows))
            call("spill", _sync_on, full[0])
            t_fold = time.perf_counter() - t0
            if on_device and t_fold > 0.01:
                self._fold_rate_ewma = (0.5 * self._fold_rate_ewma + 0.5
                                        * (len(sp_rows) - start) / t_fold)
        # fold + extract over the used rows only (pow2-bucketed, as the
        # reference does): the pool is up to 2x oversized from growth
        s_eff = min(swapped.histo.num_rows, _next_pow2(n, 1024))
        fields = tuple(a if a.shape[0] == s_eff else a[:s_eff]
                       for a in full)
        progress["fields"] = fields
        while pending:
            fields = self._fold_one_plane(fields, pending, s_eff, call)
            progress["fields"] = fields
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
        else:
            # the mirror is device state: its samples fold from the host
            # replay swap kept
            swapped.device_stage = swapped.micro_residual = None
            if swapped.micro_replay is not None:
                fields = self._fold_one_plane(
                    fields, [swapped.micro_replay], s_eff, call)
                progress["fields"] = fields
        # the mirror's content is folded: its replay is not needed
        swapped.micro_replay = None
        call("staged", _sync_on, fields[0])
        t1 = time.perf_counter()
        # quantiles travel as f64 on the host; f32 at the device boundary
        qnp = np.asarray(quantiles, dtype=np.float32)

        def extract(fl):
            qs = _to_device(qnp, fl[0].device)
            return self._extract(fl, qs).cpu().numpy()

        packed = call("extract", extract, fields, retryable=True)
        phases["fold_s"] = t1 - t0
        phases["extract_s"] = time.perf_counter() - t1
        p = qnp.shape[0]
        qv, (dmin, dmax, dsum, dcount, drecip, lmin, lmax, lsum, lweight,
             lrecip) = unpack_extract_columns(packed, p)
        snap.quantile_values = qv[:n]
        snap.quantile_qs = np.asarray(quantiles, dtype=np.float64)
        snap.dmin, snap.dmax = dmin[:n], dmax[:n]
        snap.dsum, snap.dcount, snap.drecip = dsum[:n], dcount[:n], drecip[:n]
        snap.lmin, snap.lmax = lmin[:n], lmax[:n]
        snap.lsum, snap.lweight, snap.lrecip = lsum[:n], lweight[:n], lrecip[:n]
        # the centroid rows are read back only where forwarding could
        # consume them (a local tier), as in the reference
        if self.is_local:
            snap.digest_means, snap.digest_weights = call(
                "extract", lambda fl: (fl[0].cpu().numpy()[:n],
                                       fl[1].cpu().numpy()[:n]),
                fields, retryable=True)

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
        if not swapped.host and sets.device.type == self.device.type:
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
