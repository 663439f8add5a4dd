"""Series-axis device sharding, PyTorch port of veneur_tpu/ops/series_shard.py.

Partitions the series axis S of one worker's aggregation state over D
devices (``series_shards`` in config), so the t-digest pools, the HLL
register planes and the scalar segment ops all run shard-local: upload,
micro-fold and fold touch one device each until the readbacks at
extract.

Layout: logical row r lives on shard ``d = r % D`` at local index
``l = r // D``, round-robin, so append-ordered row adoption spreads live
rows evenly across shards. A sharded array is a tuple of D per-shard
tensors, shard d's on its device, holding the PHYSICAL rows
``[d * cap, (d + 1) * cap)`` with ``cap = pool_rows // D``: physical slot
``p = (r % D) * cap + r // D``. The interleave lives purely in the
host-side index translation (``phys_rows``, ``perm_l2p``, ``perm_p2l``),
which is the reference's, verbatim. Shards may share a device (the CPU
tests run D shards on the one CPU; one card runs D shards on itself);
their work then runs in turn on that device's stream.

Closure property (what makes growth, slicing and chunking shard-local):
each shard's local prefix ``[:ecap]`` keeps exactly logical rows
[0, s_eff) in s_eff-interleaved layout, because r % D and r // D are both
preserved when cap shrinks to ecap >= ceil(s_eff/D). Hence slice, grow
and chunk are per-shard prefix ops that move no row between devices.

Bit-identity (sharded == unsharded, pinned by
tests/test_torch_series_shard.py against the port's own unsharded run
and the JAX package's sharded one) holds because every kernel is per-row
independent (the staged fold, the flush extract, the import, the HLL
scatter-max, the segment ops) or, for the one batch-global kernel, the
spill ingest, the batch is kept BIT-IDENTICAL on every shard: the ingest
step's per-row stats are differences of global f32 prefix sums over the
whole sorted batch (ops/tdigest.add_batch), so a shard may not drop or
reweight foreign samples. Each shard folds the whole replicated batch;
its foreign ``active`` entries gather a clamped row (the reference's XLA
gather clamps the out-of-range local index ``cap``) whose result is
discarded, and only the owned rows' updates are written.

The kernels on this path: the flush extract (csrc/flush_extract.cu)
once per shard in ``flush_extract``, and the HLL insert and estimate
(csrc/hll.cu) once per shard in ``hll_insert`` and ``hll_estimate``.
The HLL insert filters each shard's records on the host (an int8 max
does not depend on order, so the filtered launch is bitwise the
replicated one), so only the owner's records travel to a shard.

Scope: this module owns the device list, the host-side permutation
caches and the per-shard programs. The worker keeps all policy (when to
grow, chunk, spill); the micro-fold mirror and the staged set store take
a SeriesSharding handle for their sharded layouts.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from veneur_tpu_torch.distributed.mesh import make_series_mesh
from veneur_tpu_torch.ops import extract_kernel as ek
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops import scalars
from veneur_tpu_torch.ops import tdigest as td

log = logging.getLogger("veneur_tpu_torch.ops.series_shard")

# escape hatch mirroring VENEUR_MICRO_FOLD: 0 forces the single-device
# path regardless of config
_ENV_KEY = "VENEUR_SERIES_SHARDS"
# the largest shard count (the governor's chunk floor must divide)
MAX_SHARDS = 1024


def resolve_series_shards(cfg_value: int) -> int:
    """Config value with the env escape hatch applied."""
    env = os.environ.get(_ENV_KEY)
    if env is not None:
        try:
            return int(env)
        except ValueError:
            log.warning("ignoring non-integer %s=%r", _ENV_KEY, env)
    return int(cfg_value)


def shards_usable(shards: int, device="cuda", devices=None) -> bool:
    """Whether a series_shards request can be honored: more than one
    shard, a power of two (pow2 pool sizes must divide), and that many
    devices. With an explicit ``devices`` list, its length; on the CPU,
    any power of two up to MAX_SHARDS (the shards share the CPU); on
    CUDA, that many cards."""
    if shards <= 1 or shards & (shards - 1):
        return False
    if devices is not None:
        return len(devices) >= shards
    if torch.device(device).type == "cpu":
        return shards <= MAX_SHARDS
    return torch.cuda.device_count() >= shards


def _part(fields, d: int) -> tuple:
    """Shard d's tensors of a tuple of sharded arrays."""
    return tuple(f[d] for f in fields)


def _transpose(per_shard: list) -> tuple:
    """[shard][field] -> (field: tuple over shards)."""
    return tuple(tuple(s[k] for s in per_shard)
                 for k in range(len(per_shard[0])))


class SeriesSharding:
    """The per-shard programs and index math for one worker's series
    shards, over ``devices`` (D of them; default the first D cards)."""

    def __init__(self, shards: int,
                 compression: float = td.DEFAULT_COMPRESSION,
                 devices=None) -> None:
        if shards & (shards - 1) or shards < 2:
            raise ValueError(f"series_shards must be a pow2 >= 2: {shards}")
        self.shards = int(shards)
        self.compression = float(compression)
        self.devices = tuple(make_series_mesh(self.shards,
                                              devices).devices.flat)
        # host-side permutation caches, keyed by row count
        self._l2p: dict[int, np.ndarray] = {}
        self._p2l: dict[int, np.ndarray] = {}

    # -- host-side index math ---------------------------------------------

    def perm_l2p(self, rows: int) -> np.ndarray:
        """perm_l2p(n)[r] = physical slot of logical row r. Gathering a
        PHYS-order readback with it yields logical order."""
        p = self._l2p.get(rows)
        if p is None:
            d = self.shards
            cap = rows // d
            r = np.arange(rows, dtype=np.int64)
            p = ((r % d) * cap + r // d).astype(np.int64)
            self._l2p[rows] = p
        return p

    def perm_p2l(self, rows: int) -> np.ndarray:
        """perm_p2l(n)[p] = logical row stored at physical slot p.
        Gathering a LOGICAL-order host array with it yields the physical
        layout for upload."""
        p = self._p2l.get(rows)
        if p is None:
            d = self.shards
            cap = rows // d
            r = np.arange(rows, dtype=np.int64)
            p = ((r % cap) * d + r // cap).astype(np.int64)
            self._p2l[rows] = p
        return p

    def phys_rows(self, rows: np.ndarray, pool_rows: int) -> np.ndarray:
        """Vectorized logical row ids -> physical slots. Sentinel ids >=
        pool_rows (microfold's DROP_ROW) pass through unchanged: they
        stay out of range on every shard."""
        d = self.shards
        cap = pool_rows // d
        r = np.asarray(rows, dtype=np.int64)
        p = (r % d) * cap + r // d
        return np.where(r < pool_rows, p, r).astype(np.int32)

    def chunk_perm(self, chunk_rows: int) -> np.ndarray:
        """Inverse permutation for ONE extraction chunk's readback: a
        chunk of c rows at a D-aligned logical offset covers local rows
        [start//D, start//D + c//D) on every shard, and its assembled
        readback is laid out as a whole pool of c rows."""
        return self.perm_l2p(chunk_rows)

    # -- placement and readback ---------------------------------------------

    def place(self, arr) -> tuple:
        """One pool array in PHYSICAL row order (numpy or a tensor) as a
        sharded array: D equal row blocks, block d on shard d's device."""
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        cap = t.shape[0] // self.shards
        return tuple(t[d * cap:(d + 1) * cap].to(dev, copy=True)
                     for d, dev in enumerate(self.devices))

    def replicate(self, arr) -> tuple:
        """One batch array replicated on every shard. The CALLER books
        the ledger bytes x D: replication is a transfer per shard."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return tuple(t.to(dev, copy=True) for dev in self.devices)

    @staticmethod
    def rows_of(parts) -> int:
        """The pool row count of a sharded array."""
        return sum(int(p.shape[0]) for p in parts)

    @staticmethod
    def to_host(parts) -> np.ndarray:
        """A sharded array read back in PHYSICAL row order."""
        return np.concatenate([p.cpu().numpy() for p in parts])

    def logical(self, parts) -> np.ndarray:
        """A sharded array read back in LOGICAL row order."""
        host = self.to_host(parts)
        return host[self.perm_l2p(host.shape[0])]

    def from_logical(self, arr) -> tuple:
        """A host array in LOGICAL row order as a sharded array."""
        a = np.asarray(arr)
        return self.place(a[self.perm_p2l(a.shape[0])])

    def empty_pools(self, make, rows: int) -> tuple:
        """``make(cap, device)`` (a tuple of fresh tensors) on every shard,
        as a tuple of sharded arrays."""
        cap = rows // self.shards
        return _transpose([make(cap, dev) for dev in self.devices])

    # -- t-digest programs ----------------------------------------------------

    def fold_staged(self, fields, stages) -> tuple:
        """The staged fold (per-row independent) on every shard: shard d
        folds ``stages[d]`` (core/worker.FlatStage or DenseStage: its
        own flat segment and physical counts block, or its dense block)
        through core/worker.fold_staged."""
        from veneur_tpu_torch.core.worker import fold_staged

        return _transpose([
            fold_staged(_part(fields, d), stages[d],
                        compression=self.compression)
            for d in range(self.shards)])

    def flush_extract(self, fields, qs) -> tuple:
        """The flush extract kernel on every shard: the packed
        [cap, P+10] blocks, physical order (``qs`` replicated)."""
        return tuple(ek.flush_extract(*_part(fields, d), qs[d])
                     for d in range(self.shards))

    def _owned(self, parts, rows, d: int):
        """Shard d's local indices of the physical ``rows`` (a tensor on
        its device): (clamped local index, owned mask). A foreign or
        out-of-range row maps to local ``cap`` in the reference; a gather
        there clamps to cap - 1, and the update is dropped."""
        cap = parts[d].shape[0]
        loc = rows.to(torch.int64) - d * cap
        owned = (loc >= 0) & (loc < cap)
        return torch.where(owned, loc, cap - 1), owned

    def ingest_rows(self, fields, active, lids, vals, wts) -> tuple:
        """The spill ingest's update on every shard, each shard folding
        the whole replicated batch (``active`` holds PHYSICAL slots):
        per shard, ``_histo_ingest_rows``'s update cut to the rows the
        shard owns (their LOCAL indices). Writes nothing."""
        from veneur_tpu_torch.core.worker import _histo_ingest_rows

        out = []
        for d in range(self.shards):
            fd = _part(fields, d)
            loc, owned = self._owned(fields[0], active[d], d)
            up = _histo_ingest_rows(*fd, loc, lids[d], vals[d], wts[d],
                                    compression=self.compression)
            out.append(tuple(u[owned] for u in up))
        return tuple(out)

    def write_ingest_rows(self, fields, updates) -> None:
        """Land ``ingest_rows``'s per-shard updates, in place."""
        from veneur_tpu_torch.core.worker import _write_ingest_rows

        for d in range(self.shards):
            _write_ingest_rows(_part(fields, d), updates[d])

    def import_rows(self, fields, rows, imp_means, imp_w, imp_min, imp_max,
                    imp_recip) -> tuple:
        """The import merge's update on every shard (``rows`` PHYSICAL,
        the imports replicated), cut to the owned rows. Writes nothing."""
        from veneur_tpu_torch.core.worker import _histo_import_rows

        out = []
        for d in range(self.shards):
            loc, owned = self._owned(fields[0], rows[d], d)
            up = _histo_import_rows(
                *_part(fields, d), loc, imp_means[d], imp_w[d], imp_min[d],
                imp_max[d], imp_recip[d], compression=self.compression)
            out.append(tuple(u[owned] for u in up))
        return tuple(out)

    def write_import_rows(self, fields, updates) -> None:
        from veneur_tpu_torch.core.worker import _write_import_rows

        for d in range(self.shards):
            _write_import_rows(_part(fields, d), updates[d])

    def logical_update(self, updates) -> tuple:
        """Per-shard updates (first element the LOCAL rows) as one update
        over the logical pool, on the CPU: local row l of shard d is
        logical row l * D + d whatever the pool size."""
        parts = []
        for d, up in enumerate(updates):
            rows = up[0].cpu() * self.shards + d
            parts.append((rows,) + tuple(t.cpu() for t in up[1:]))
        return tuple(torch.cat([p[k] for p in parts])
                     for k in range(len(parts[0])))

    # -- slicing / growth -------------------------------------------------

    def slice_field(self, parts, s_eff: int) -> tuple:
        """Shrink one pool array [S, ...] -> [s_eff, ...]: each shard
        keeps its local prefix (the interleave closure property)."""
        ecap = s_eff // self.shards
        return tuple(p if p.shape[0] == ecap else p[:ecap] for p in parts)

    def slice_chunk(self, parts, start: int, rows: int) -> tuple:
        """One extraction chunk: logical rows [start, start + rows), both
        D-aligned, are local rows [start//D, (start + rows)//D) on every
        shard: a lockstep slice (its base stays 16-byte aligned for the
        kernel, as an unsharded pow2 chunk's does)."""
        a, lc = start // self.shards, rows // self.shards
        return tuple(p[a:a + lc] for p in parts)

    def grow_2d(self, parts, new_rows: int) -> tuple:
        """Sharded pool growth: each shard zero-pads its local block.
        r % D is unchanged by growth (D fixed), so every existing logical
        row keeps its shard AND its local index: growth moves no data
        between devices."""
        from veneur_tpu_torch.core.worker import _grow_2d

        return tuple(_grow_2d(p, new_rows // self.shards) for p in parts)

    def grow_1d(self, parts, new_rows: int, fill: float) -> tuple:
        from veneur_tpu_torch.core.worker import _grow_1d

        return tuple(_grow_1d(p, new_rows // self.shards, fill)
                     for p in parts)

    # -- HLL programs -------------------------------------------------------

    def _split_rows(self, rows_phys, pool_rows: int):
        """For every shard, (its record mask, its local rows) of the
        PHYSICAL rows; sentinels and out-of-range rows belong to none."""
        cap = pool_rows // self.shards
        r = np.asarray(rows_phys, np.int64)
        shard = np.where((r >= 0) & (r < pool_rows), r // max(cap, 1), -1)
        return [(shard == d, (r - d * cap)) for d in range(self.shards)]

    def hll_insert(self, regs, rows_phys, reg_idx, rank,
                   inserters) -> tuple:
        """Sharded register scatter-max: each shard's records filtered on
        the host and inserted by that shard's ``inserters[d]``
        (ops/hll.HostInserter: the hll_insert kernel on the card, one
        launch a shard that has records). In place; returns ``regs``."""
        idx = np.asarray(reg_idx)
        rk = np.asarray(rank)
        for d, (m, loc) in enumerate(self._split_rows(
                rows_phys, self.rows_of(regs))):
            if m.any():
                inserters[d].insert(regs[d], loc[m].astype(np.int32),
                                    idx[m].astype(np.int32),
                                    rk[m].astype(np.int8))
        return regs

    def hll_max_rows(self, regs, rows_phys, imp) -> tuple:
        """Sharded register max-merge at explicit unique rows (the import
        path): gather, max, write on each owning shard. In place."""
        imp = np.asarray(imp, np.int8)
        for d, (m, loc) in enumerate(self._split_rows(
                rows_phys, self.rows_of(regs))):
            if m.any():
                dev = regs[d].device
                at = torch.from_numpy(loc[m]).to(dev)
                regs[d][at] = torch.maximum(
                    regs[d][at], torch.from_numpy(imp[m]).to(dev))
        return regs

    def hll_estimate(self, regs, precision: int) -> tuple:
        """Per-row estimates of every shard's register block (the
        hll_estimate kernel on the card, one launch a shard)."""
        return tuple(hll_ops.estimate(p, precision) for p in regs)

    # -- scalar segment ops -------------------------------------------------

    def segment_counter_sum(self, rows_phys, contributions,
                            num_rows: int) -> tuple:
        """Sharded device counter reduction: each shard segment-sums the
        samples of its own rows into its block (ops/scalars). The host's
        f64 pools stay the worker's exact path."""
        c = np.asarray(contributions, np.float32)
        out = []
        cap = num_rows // self.shards
        for d, (m, loc) in enumerate(self._split_rows(rows_phys, num_rows)):
            dev = self.devices[d]
            out.append(scalars.segment_counter_sum(
                torch.from_numpy(loc[m]).to(dev),
                torch.from_numpy(c[m]).to(dev), cap))
        return tuple(out)

    def segment_gauge_last(self, rows_phys, values, num_rows: int):
        """Sharded last-write-wins gauge plane: (values, present), each a
        sharded array. Each shard resolves its own rows from their
        samples in arrival order; a row with no sample reads 0 and is not
        present (the reference's sharded twin)."""
        v = np.asarray(values, np.float32)
        cap = num_rows // self.shards
        vals, pres = [], []
        for d, (m, loc) in enumerate(self._split_rows(rows_phys, num_rows)):
            dev = self.devices[d]
            nv, np_ = scalars.segment_gauge_last(
                torch.from_numpy(loc[m]).to(dev),
                torch.from_numpy(v[m]).to(dev), cap)
            vals.append(torch.where(np_, nv, 0.0))
            pres.append(np_)
        return tuple(vals), tuple(pres)


def from_jax_fields(fields_np, shards: int, devices=None,
                    compression: float = td.DEFAULT_COMPRESSION) -> tuple:
    """The JAX package's sharded pool (its 14 field arrays read back with
    ``np.asarray``: PHYSICAL row order) as the port's: 14 sharded arrays
    over ``devices`` (default the CPU, one entry per shard)."""
    devs = devices or ["cpu"] * shards
    sh = SeriesSharding(shards, compression, devices=devs)
    return tuple(sh.place(np.array(a, copy=True)) for a in fields_np)

