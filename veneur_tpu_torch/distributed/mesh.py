"""Device-mesh aggregation, PyTorch port of veneur_tpu/distributed/mesh.py.

The reference's distributed design: N local instances each aggregate a
shard of traffic, then forward mergeable sketches to global instances
that reduce them per series. The JAX package maps that onto a device
mesh with two axes:

  axis "series" — each device owns a shard of series rows; no
                  communication on this axis (row -> shard is
                  deterministic, ``r % D``).
  axis "hosts"  — each host-rank aggregates its own traffic for the SAME
                  series space; the global reduce is a gather of every
                  host's centroid rows, one batched compress, and the
                  quantile extraction.

Like the reference (veneur_tpu/distributed/mesh.py:22-24: "this module
covers the single-process multi-chip mesh"), the port is ONE process
driving a grid of devices. A ``Mesh`` is a (hosts x series) grid of
``torch.device``s, the counterpart of ``jax.sharding.Mesh``; a sharded
array is a tuple over hosts of tuples over series shards of tensors,
each on its grid device. The collectives are explicit and run in host
order: ``all_gather`` over "hosts" moves each host's tensor to the
series shard's device (``.to``) and stacks them; ``pmin``/``pmax`` are
elementwise; ``psum`` folds the hosts in order, ((h0 + h1) + h2) + h3,
the order XLA's CPU all-reduce sums in (pinned by
tests/test_torch_mesh.py at H = 2 and H = 4). No process group is
involved: the reference has none. A grid may repeat a device (the CPU
tests run the whole mesh on the one CPU, a card runs it on one H100).

The merged digests' quantiles, sums and counts come from the flush
extract kernel (ops/extract_kernel.flush_extract, csrc/flush_extract.cu
on the card), once per series shard on the device of host 0's copy of
that shard: bitwise the reference's XLA quantile.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import extract_kernel as ek
from veneur_tpu_torch.ops import tdigest as td

_INF = float("inf")


class Mesh:
    """A grid of torch devices with named axes (``jax.sharding.Mesh``'s
    counterpart): ``devices`` is an object ndarray of ``torch.device``,
    ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = np.empty(grid.shape, dtype=object)
        for i, d in np.ndenumerate(grid):
            self.devices[i] = torch.device(d)
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _cuda_devices() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, hosts: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a (hosts, series) mesh over the first n CUDA devices, or over
    ``devices``: a flat list (reshaped row-major to hosts x series) or a
    hosts x series grid; either may repeat a device.

    hosts defaults to 2 when the device count is even (so the cross-host
    reduce path is exercised), else 1. Raises when there are fewer
    devices than asked for, as the reference's reshape does."""
    if devices is not None and np.asarray(devices, dtype=object).ndim == 2:
        grid = np.asarray(devices, dtype=object)
        if hosts is not None and grid.shape[0] != hosts:
            raise ValueError(f"a {grid.shape[0]}-host grid for hosts={hosts}")
        return Mesh(grid, ("hosts", "series"))
    devs = list(_cuda_devices() if devices is None else devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if n > len(devs) or n < 1:
        raise ValueError(f"{n} mesh devices asked for, {len(devs)} "
                         f"available")
    devs = devs[:n]
    if hosts is None:
        hosts = 2 if n % 2 == 0 and n >= 2 else 1
    if n % hosts:
        raise ValueError(f"{n} devices not divisible by hosts={hosts}")
    grid = np.empty((hosts, n // hosts), dtype=object)
    for i, d in enumerate(devs):
        grid[i // (n // hosts), i % (n // hosts)] = d
    return Mesh(grid, ("hosts", "series"))


def make_series_mesh(shards: int, devices=None) -> Mesh:
    """1-D mesh over the first ``shards`` CUDA devices, or over
    ``devices``, for the within-host series-axis split
    (ops/series_shard.py). Named "series" so it composes with
    make_mesh's (hosts, series) convention: row -> shard by r % D at
    both tiers."""
    devs = list(_cuda_devices() if devices is None else devices)
    if shards > len(devs):
        raise ValueError(
            f"series_shards={shards} exceeds {len(devs)} visible devices")
    return Mesh(devs[:shards], ("series",))


# ---------------------------------------------------------------------------
# Sharded arrays: host numpy [H, S, ...] <-> a [H][D] nested tuple of
# per-device blocks (block d of host h holds rows [d*s_loc, (d+1)*s_loc))


def place_mesh(mesh: Mesh, arr) -> tuple:
    """Split a host array [H, S, ...] over the mesh: host h's rows in D
    equal blocks, block d on device (h, d)."""
    a = np.asarray(arr)
    hosts, d = mesh.devices.shape
    if a.shape[0] != hosts or a.shape[1] % d:
        raise ValueError(f"array {a.shape} does not split over {mesh}")
    s_loc = a.shape[1] // d
    return tuple(tuple(
        torch.from_numpy(np.ascontiguousarray(
            a[h, j * s_loc:(j + 1) * s_loc])).to(mesh.devices[h, j],
                                                 copy=True)
        for j in range(d)) for h in range(hosts))


def gather_mesh(parts) -> np.ndarray:
    """The host array [H, S, ...] of a sharded array."""
    return np.stack([np.concatenate([t.cpu().numpy() for t in row])
                     for row in parts])


def _all_gather(parts, d: int, dev: torch.device) -> torch.Tensor:
    """Every host's block d on ``dev``, stacked in host order [H, ...]."""
    return torch.stack([row[d].to(dev) for row in parts])


def _psum(parts, d: int, dev: torch.device) -> torch.Tensor:
    """The hosts' blocks d summed in host order, ((h0 + h1) + h2) + ...,
    as XLA's CPU all-reduce sums them."""
    acc = parts[0][d].to(dev)
    for row in parts[1:]:
        acc = acc + row[d].to(dev)
    return acc


def _merge_extract(means, weights, dmin, dmax, drecip, qs, d: int,
                   dev: torch.device, compression: float):
    """The cross-host merge of series shard d on ``dev``: all_gather the
    hosts' centroid rows, one compress over [s_loc, H*C], pmin/pmax/psum
    of the scalars, then the flush extract kernel for the quantiles, the
    sums and the counts. Returns (quant [s_loc, P], dmin, dmax, dsum,
    dcount, drecip), each [s_loc] but the first."""
    g_m = _all_gather(means, d, dev)
    g_w = _all_gather(weights, d, dev)
    h, s_loc, c = g_m.shape
    cat_m = g_m.permute(1, 0, 2).reshape(s_loc, h * c)
    cat_w = g_w.permute(1, 0, 2).reshape(s_loc, h * c)
    mg_m, mg_w = td.compress_rows(cat_m, cat_w, compression, c)
    mn = exn.pmin0(_all_gather(dmin, d, dev))
    mx = exn.pmax0(_all_gather(dmax, d, dev))
    rc = _psum(drecip, d, dev)
    zero = torch.zeros((s_loc,), dtype=torch.float32, device=dev)
    inf = torch.full((s_loc,), _INF, dtype=torch.float32, device=dev)
    packed = ek.flush_extract(mg_m, mg_w, mn, mx, rc, zero, inf, -inf,
                              zero, zero, zero, zero, zero, zero,
                              qs.to(dev))
    p = qs.shape[0]
    return (packed[:, :p], mn, mx, packed[:, p + 2], packed[:, p + 3], rc)


def _local_aggregate_step(means, weights, dmin, dmax, drecip, rows, values,
                          wts, compression):
    """The fused step on one device's blocks: ingest this (host, series
    shard)'s batch into its rows (no collective). Returns the new blocks
    (means, weights, dmin, dmax, drecip)."""
    m, w, mn, mx, rc, _stats = td.add_batch(
        means, weights, dmin, dmax, drecip, rows, values, wts,
        compression=compression)
    return m, w, mn, mx, rc


def _per_device(mesh: Mesh, fn, *arrays):
    """fn over every grid device's blocks; the results as sharded
    arrays (a tuple per output)."""
    hosts, d = mesh.devices.shape
    outs = [[fn(*(a[h][j] for a in arrays)) for j in range(d)]
            for h in range(hosts)]
    n_out = len(outs[0][0])
    return tuple(tuple(tuple(outs[h][j][k] for j in range(d))
                       for h in range(hosts)) for k in range(n_out))


def _replicated_merge(mesh: Mesh, state, qs, compression):
    """_merge_extract for every series shard on host 0's device, then
    copied to every host's device (the reference's outputs are
    replicated along "hosts"). Outputs as sharded arrays."""
    hosts, d = mesh.devices.shape
    per_d = [_merge_extract(*state, qs, j, mesh.devices[0, j], compression)
             for j in range(d)]
    return tuple(tuple(tuple(per_d[j][k].to(mesh.devices[h, j])
                             for j in range(d)) for h in range(hosts))
                 for k in range(len(per_d[0])))


def build_sharded_flush_step(mesh: Mesh,
                             compression: float = td.DEFAULT_COMPRESSION):
    """The fused multi-device aggregation + reduce + extract step.

    Arguments as sharded arrays: means/weights [H, S, C], dmin/dmax/
    drecip [H, S]; rows/values/wts [H, N], each (host, series-shard)
    block a batch whose row ids are LOCAL to its series shard; qs f32[P]
    (a tensor, copied to each device). Returns (updated per-host state...,
    quantiles [H, S, P]) where the quantiles' host copies are
    identical."""

    def step(means, weights, dmin, dmax, drecip, rows, values, wts, qs):
        state = _per_device(
            mesh, functools.partial(_local_aggregate_step,
                                    compression=compression),
            means, weights, dmin, dmax, drecip, rows, values, wts)
        quant = _replicated_merge(mesh, state, qs, compression)[0]
        return (*state, quant)

    return step


def make_example_state(mesh: Mesh, s_per_shard: int = 8,
                       n_per_shard: int = 64,
                       capacity: int = td.DEFAULT_CAPACITY, p: int = 3):
    """Tiny sharded example inputs for the sharded flush step (the
    reference's, from the same numpy seed)."""
    hosts = mesh.shape["hosts"]
    series_shards = mesh.shape["series"]
    s = s_per_shard * series_shards
    n = n_per_shard * series_shards
    rng = np.random.default_rng(0)
    means = place_mesh(mesh, np.full((hosts, s, capacity), np.inf,
                                     np.float32))
    weights = place_mesh(mesh, np.zeros((hosts, s, capacity), np.float32))
    dmin = place_mesh(mesh, np.full((hosts, s), np.inf, np.float32))
    dmax = place_mesh(mesh, np.full((hosts, s), -np.inf, np.float32))
    drecip = place_mesh(mesh, np.zeros((hosts, s), np.float32))
    rows = place_mesh(mesh, rng.integers(0, s_per_shard, (hosts, n))
                      .astype(np.int32))
    values = place_mesh(mesh, rng.uniform(1, 100, (hosts, n))
                        .astype(np.float32))
    wts = place_mesh(mesh, np.ones((hosts, n), np.float32))
    qs = torch.from_numpy(np.linspace(0.25, 0.99, p, dtype=np.float32))
    return (means, weights, dmin, dmax, drecip, rows, values, wts, qs)


# ---------------------------------------------------------------------------
# Product path: the mesh-sharded histogram pool for the global tier.
#
# A global terminates forwarded digests from many locals. With a mesh
# configured (tpu_mesh_devices / tpu_mesh_hosts), histogram state shards
# over the (hosts, series) grid: imported centroids re-ingest as
# weighted samples (the reference's shuffled re-Add merge: min/max
# evolve from centroid means, reciprocalSum carried exactly in a host
# f64 accumulator). The flush runs the cross-host gather + compress +
# extraction per series shard.


def build_mesh_ingest_step(mesh: Mesh,
                           compression: float = td.DEFAULT_COMPRESSION,
                           carry_recip: bool = True):
    """Per-device ingest of a (rows, values, weights) batch into sharded
    digest state; no collective. carry_recip=False is the import variant:
    re-ingested centroid means must not touch reciprocalSum (it travels
    on the wire)."""

    def one(means, weights, dmin, dmax, drecip, rows, values, wts):
        m, w, mn, mx, rc, _ = td.add_batch(
            means, weights, dmin, dmax, drecip, rows, values, wts,
            compression=compression)
        return m, w, mn, mx, (rc if carry_recip else drecip)

    def step(*arrays):
        return _per_device(mesh, one, *arrays)

    return step


def build_mesh_extract_step(mesh: Mesh,
                            compression: float = td.DEFAULT_COMPRESSION):
    """Cross-host merge + quantile/scalar extraction over the mesh.
    Returns (quant [H,S,P], dmin, dmax, dsum, dcount, drecip — each
    [H,S], identical along the hosts axis)."""

    def step(means, weights, dmin, dmax, drecip, qs):
        return _replicated_merge(mesh, (means, weights, dmin, dmax, drecip),
                                 qs, compression)

    return step


def _next_pow2(n: int, floor: int) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


class MeshHistoPool:
    """Mesh-sharded histogram aggregation state for one flush epoch.

    Global rows come from the owning worker's series directory; row r
    lives on series shard ``r % D`` at local index ``r // D``. Raw
    samples and imported centroids buffer host-side per (host slot,
    shard) and stream to the grid in batches; the flush merges across
    the hosts axis and extracts (the flush extract kernel once a series
    shard)."""

    def __init__(self, mesh: Mesh,
                 compression: float = td.DEFAULT_COMPRESSION,
                 capacity: int = td.DEFAULT_CAPACITY,
                 initial_rows_per_shard: int = 256,
                 batch_size: int = 65536) -> None:
        self.mesh = mesh
        self.hosts = mesh.shape["hosts"]
        self.shards = mesh.shape["series"]
        self.compression = compression
        self.capacity = capacity
        self.initial_rows = initial_rows_per_shard
        self.batch_size = batch_size
        self._ingest_raw = build_mesh_ingest_step(mesh, compression, True)
        self._ingest_imp = build_mesh_ingest_step(mesh, compression, False)
        self.reset()

    def reset(self) -> None:
        self._state = None  # (means, weights, dmin, dmax, drecip), sharded
        self._rows_per_shard = 0
        # pending [host][shard] SoA buffers: (local_row, value, weight)
        self._pend = [[([], [], []) for _ in range(self.shards)]
                      for _ in range(self.hosts)]
        self._pend_imp = [[([], [], []) for _ in range(self.shards)]
                          for _ in range(self.hosts)]
        self._pend_n = 0
        self._recip_extra: dict[int, float] = {}  # global row -> wire recip
        self._max_row = -1
        self._imp_rr = 0  # round-robin host slot for imports

    # -- ingestion ----------------------------------------------------------

    def add_sample(self, row: int, value: float, weight: float,
                   host_slot: int) -> None:
        d, loc = row % self.shards, row // self.shards
        b = self._pend[host_slot % self.hosts][d]
        b[0].append(loc)
        b[1].append(value)
        b[2].append(weight)
        self._max_row = max(self._max_row, row)
        self._pend_n += 1
        if self._pend_n >= self.batch_size:
            self._flush_pending()

    def add_samples_bulk(self, rows: np.ndarray, values: np.ndarray,
                         weights: np.ndarray) -> None:
        """Vectorized ingest of a drained native batch: samples group by
        (host slot, shard) with one stable sort instead of a per-sample
        Python loop."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        values = np.asarray(values)
        weights = np.asarray(weights)
        h = rows % self.hosts
        d = rows % self.shards
        loc = rows // self.shards
        key = h * self.shards + d
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        bounds = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
        bounds = np.r_[bounds, key_s.size]
        loc_s = loc[order]
        val_s = values[order]
        wt_s = weights[order]
        for i in range(len(bounds) - 1):
            a, b = int(bounds[i]), int(bounds[i + 1])
            hi, di = int(key_s[a]) // self.shards, int(key_s[a]) % self.shards
            buf = self._pend[hi][di]
            buf[0].extend(loc_s[a:b].tolist())
            buf[1].extend(val_s[a:b].tolist())
            buf[2].extend(wt_s[a:b].tolist())
        self._max_row = max(self._max_row, int(rows.max()))
        self._pend_n += int(rows.size)
        if self._pend_n >= self.batch_size:
            self._flush_pending()

    def add_centroids(self, row: int, means, weights, recip: float) -> None:
        """Merge one imported digest: centroids re-ingested as weighted
        samples (reference Merge semantics); the wire reciprocalSum
        carried exactly in f64 on the host."""
        slot = self._imp_rr % self.hosts
        self._imp_rr += 1
        d, loc = row % self.shards, row // self.shards
        b = self._pend_imp[slot][d]
        for m, w in zip(means, weights):
            if w > 0:
                b[0].append(loc)
                b[1].append(float(m))
                b[2].append(float(w))
                self._pend_n += 1
        self._recip_extra[row] = self._recip_extra.get(row, 0.0) + recip
        self._max_row = max(self._max_row, row)
        if self._pend_n >= self.batch_size:
            self._flush_pending()

    # -- device movement ----------------------------------------------------

    def _ensure_rows(self) -> None:
        need = (self._max_row // self.shards) + 1
        if self._state is not None and need <= self._rows_per_shard:
            return
        new_rps = _next_pow2(need, self.initial_rows)
        old_rps = self._rows_per_shard
        grid = self.mesh.devices
        c = self.capacity

        def fresh(dev):
            return [torch.full((new_rps, c), _INF, dtype=torch.float32,
                               device=dev),
                    torch.zeros((new_rps, c), dtype=torch.float32,
                                device=dev),
                    torch.full((new_rps,), _INF, dtype=torch.float32,
                               device=dev),
                    torch.full((new_rps,), -_INF, dtype=torch.float32,
                               device=dev),
                    torch.zeros((new_rps,), dtype=torch.float32,
                                device=dev)]

        blocks = [[fresh(grid[h, j]) for j in range(self.shards)]
                  for h in range(self.hosts)]
        if self._state is not None:
            # each shard's local block keeps its rows at their local index
            for k, arr in enumerate(self._state):
                for h in range(self.hosts):
                    for j in range(self.shards):
                        blocks[h][j][k][:old_rps] = arr[h][j]
        self._rows_per_shard = new_rps
        self._state = tuple(
            tuple(tuple(blocks[h][j][k] for j in range(self.shards))
                  for h in range(self.hosts)) for k in range(5))

    def _build_batch(self, pend) -> Optional[tuple]:
        widest = max((len(pend[h][d][0]) for h in range(self.hosts)
                      for d in range(self.shards)), default=0)
        if widest == 0:
            return None
        nd = _next_pow2(widest, 64)
        grid = self.mesh.devices
        out = ([], [], [])
        for hi in range(self.hosts):
            rr, rv, rw = [], [], []
            for di in range(self.shards):
                lr, lv, lw = pend[hi][di]
                rows = np.zeros(nd, np.int32)
                vals = np.ones(nd, np.float32)
                wts = np.zeros(nd, np.float32)  # 0 = padding
                n = len(lr)
                if n:
                    rows[:n] = lr
                    vals[:n] = lv
                    wts[:n] = lw
                pend[hi][di] = ([], [], [])
                dev = grid[hi, di]
                rr.append(torch.from_numpy(rows).to(dev))
                rv.append(torch.from_numpy(vals).to(dev))
                rw.append(torch.from_numpy(wts).to(dev))
            out[0].append(tuple(rr))
            out[1].append(tuple(rv))
            out[2].append(tuple(rw))
        return tuple(tuple(o) for o in out)

    def _flush_pending(self) -> None:
        if self._pend_n == 0:
            return
        self._ensure_rows()
        raw = self._build_batch(self._pend)
        if raw is not None:
            self._state = self._ingest_raw(*self._state, *raw)
        imp = self._build_batch(self._pend_imp)
        if imp is not None:
            self._state = self._ingest_imp(*self._state, *imp)
        self._pend_n = 0

    # -- flush --------------------------------------------------------------

    def extract(self, quantiles: np.ndarray, num_rows: int):
        """Merge across hosts and extract; returns a dict of numpy arrays
        in global-row order [num_rows], or None if nothing was
        ingested."""
        self._flush_pending()
        if self._max_row >= 0:
            # rows can be known without any positive-weight sample queued
            # (an imported digest whose centroids were all empty): the
            # state must still cover them
            self._ensure_rows()
        if self._state is None:
            return None
        qs = torch.from_numpy(np.asarray(quantiles, np.float32))
        cols = [[], [], [], [], [], []]
        for j in range(self.shards):
            out = _merge_extract(*self._state, qs, j,
                                 self.mesh.devices[0, j], self.compression)
            for k, t in enumerate(out):
                cols[k].append(t.cpu().numpy())
        quant, mn, mx, dsum, dcount, drecip = (np.concatenate(c)
                                               for c in cols)
        # invert the row interleave: global row r sits at shard-major
        # position (r % D) * rps + r // D
        rps, d = self._rows_per_shard, self.shards
        r = np.arange(num_rows)
        pos = (r % d) * rps + r // d
        out = {
            "quant": quant[pos],
            "dmin": mn[pos],
            "dmax": mx[pos],
            "dsum": dsum[pos].astype(np.float64),
            "dcount": dcount[pos].astype(np.float64),
            "drecip": drecip[pos].astype(np.float64),
        }
        for row, extra in self._recip_extra.items():
            if row < num_rows:
                out["drecip"][row] += extra
        return out


# ---------------------------------------------------------------------------
# Standalone collective merges


def build_hll_merge(mesh: Mesh):
    """HLL register merge across hosts: the elementwise max, on every
    host's device."""

    def merge(regs):
        hosts, d = mesh.devices.shape
        out = []
        for j in range(d):
            dev = mesh.devices[0, j]
            out.append(torch.amax(_all_gather(regs, j, dev), dim=0))
        return tuple(tuple(out[j].to(mesh.devices[h, j]) for j in range(d))
                     for h in range(hosts))

    return merge


def build_counter_merge(mesh: Mesh):
    """Counter sum across hosts (psum, in host order)."""

    def merge(vals):
        hosts, d = mesh.devices.shape
        out = [_psum(vals, j, mesh.devices[0, j]) for j in range(d)]
        return tuple(tuple(out[j].to(mesh.devices[h, j]) for j in range(d))
                     for h in range(hosts))

    return merge


def build_sharded_staged_fold(mesh: Mesh, compression: float = 100.0):
    """The local tier's staged fold over every device of the mesh: digest
    rows AND the raw-sample staging plane block-split over the flat
    (hosts x series) device list, each block folded on its device; no
    collective (cross-host merging is the global tier's job).

    Returns fn(fields14..., svals, swts) -> 14 sharded fields, each a
    tuple of the H*D row blocks in device order."""
    from veneur_tpu_torch.core.worker import DenseStage, fold_staged

    devs = list(mesh.devices.flat)

    def fold(*args):
        n = len(devs)
        blocks = []
        for a in args:
            t = torch.as_tensor(np.asarray(a) if not isinstance(
                a, torch.Tensor) else a)
            if t.shape[0] % n:
                raise ValueError(f"{t.shape[0]} rows do not split over "
                                 f"{n} devices")
            s = t.shape[0] // n
            blocks.append([t[i * s:(i + 1) * s].to(devs[i], copy=True)
                           for i in range(n)])
        outs = [fold_staged([b[i] for b in blocks[:14]],
                            DenseStage(blocks[14][i], blocks[15][i]),
                            compression=compression)
                for i in range(n)]
        return tuple(tuple(o[k] for o in outs) for k in range(14))

    return fold
