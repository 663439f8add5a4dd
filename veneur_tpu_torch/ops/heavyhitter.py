"""Mergeable heavy-hitter sketches: count-min + space-saving top-k,
PyTorch port.

The counterpart of veneur_tpu/ops/heavyhitter.py (Cormode &
Muthukrishnan's count-min sketch, Metwally et al.'s space-saving top-k).
The host parts are copied: ``hash_keys``, ``split_hashes``,
``SpaceSavingTopK`` and ``insert_chunked``'s padding. The device programs
(XLA programs in the JAX package, no Pallas kernel) are torch ops on the
pool's device:

* A pool of T per-tenant sketches is one dense ``int32[T, D, W]`` counter
  tensor. int32, not float, so the scatter-add is order-invariant and
  chunked inserts are bitwise a single shot. W is a power of two so the
  column index is a mask.

* ``insert_batch`` is one flattened scatter-add per batch over the whole
  pool, and RETURNS A NEW TENSOR (out-of-place ``index_add``): a fenced
  read view (core/tenancy.TenantSketch.snapshot) shares the pool by
  reference, so no fold may write into a tensor a view holds. The JAX
  program drops out-of-range indices (``mode="drop"``); here every row
  comes from ``TenantSketch.row_for`` (below T) and every column is
  masked by W - 1, so the bound is asserted on the host instead.
  ``merge`` is elementwise ``+``; ``query`` the min over D of the
  addressed counters; ``tenant_totals`` sums one depth row in int32
  (wrapping past 2^31 as ``jnp.sum`` does with x64 off: torch would
  promote to int64 unless told).

* The top-k half is host-side: ``SpaceSavingTopK``, fed per flush from
  the folded per-row counts.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.device import resolve
from veneur_tpu_torch.utils.hashing import fmix64, fnv1a_64

DEFAULT_DEPTH = 4
DEFAULT_WIDTH = 2048
DEFAULT_TOPK = 8


def init_pool(
    num_tenants: int,
    depth: int = DEFAULT_DEPTH,
    width: int = DEFAULT_WIDTH,
    device=None,
) -> torch.Tensor:
    if width & (width - 1):
        raise ValueError(f"count-min width must be a power of two, got {width}")
    return torch.zeros((num_tenants, depth, width), dtype=torch.int32,
                       device=resolve(device))


def hash_keys(keys: list[str]) -> np.ndarray:
    """One 64-bit digest per key, host-side: fmix64(fnv1a64(utf-8)).

    fmix64 on top of fnv1a matches the ring's hashing idiom
    (distributed/ring.py) and breaks fnv's low-bit correlation before the
    double-hash split below.
    """
    out = np.empty(len(keys), dtype=np.uint64)
    for i, k in enumerate(keys):
        out[i] = fmix64(fnv1a_64(k.encode("utf-8")))
    return out


def split_hashes(
    hashes: np.ndarray,
    depth: int = DEFAULT_DEPTH,
    width: int = DEFAULT_WIDTH,
) -> np.ndarray:
    """64-bit digests → i32[D, N] column indices via double hashing.

    h1 = low 32 bits, h2 = high 32 bits forced odd (odd stride is coprime
    with any pow2 width, so the D probes are distinct mod W for D ≤ W).
    """
    h = hashes.astype(np.uint64)
    h1 = (h & np.uint64(0xFFFFFFFF)).astype(np.int64)
    h2 = ((h >> np.uint64(32)) | np.uint64(1)).astype(np.int64)
    d = np.arange(depth, dtype=np.int64)[:, None]
    return ((h1[None, :] + d * h2[None, :]) & (width - 1)).astype(np.int32)


def _check_bounds(pool: torch.Tensor, rows: np.ndarray,
                  col_idx: np.ndarray) -> None:
    """The JAX program drops out-of-range slots; the port never makes
    one, and says so here rather than rely on torch raising."""
    t, d, w = pool.shape
    if col_idx.shape != (d, len(rows)):
        raise ValueError(f"col_idx must be [{d}, {len(rows)}], got "
                         f"{col_idx.shape}")
    if len(rows) and not (0 <= int(rows.min()) and int(rows.max()) < t):
        raise ValueError(f"count-min rows must lie in [0, {t})")
    if col_idx.size and not (0 <= int(col_idx.min())
                             and int(col_idx.max()) < w):
        raise ValueError(f"count-min columns must lie in [0, {w})")


def insert_batch(
    pool: torch.Tensor,
    rows,
    col_idx,
    counts,
) -> torch.Tensor:
    """Scatter-add a batch of (tenant row, key columns, count) into a NEW
    pool tensor (``pool`` is left as it was).

    rows: i32[N] tenant sketch row per sample; col_idx: i32[D, N] from
    `split_hashes`; counts: i32[N] (padding: count 0 — add is a no-op).
    Host arrays are bounds-checked and uploaded; tensors are taken as
    they are. Integer adds commute, so duplicate slots and any chunking
    of the batch produce bitwise-identical pools.
    """
    t, d, w = pool.shape
    dev = pool.device
    if isinstance(rows, np.ndarray):
        rows = np.asarray(rows, dtype=np.int32)
        col_idx = np.asarray(col_idx, dtype=np.int32)
        _check_bounds(pool, rows, col_idx)
        rows = torch.from_numpy(rows).to(dev)
        col_idx = torch.from_numpy(col_idx).to(dev)
        counts = torch.from_numpy(np.asarray(counts, dtype=np.int32)).to(dev)
    rows = rows.to(torch.int64)
    flat = ((rows[None, :] * d
             + torch.arange(d, dtype=torch.int64, device=dev)[:, None]) * w
            + col_idx.to(torch.int64))
    vals = counts.to(pool.dtype)[None, :].expand(d, -1)
    out = pool.reshape(-1).index_add(0, flat.reshape(-1), vals.reshape(-1))
    return out.reshape(t, d, w)


def insert_chunked(
    pool: torch.Tensor,
    rows: np.ndarray,
    col_idx: np.ndarray,
    counts: np.ndarray,
    chunk: int,
) -> torch.Tensor:
    """Feed a large batch through `insert_batch` in fixed-size chunks.

    The tail chunk is zero-padded to `chunk` (count 0 → no-op), as the
    JAX package pads it to keep one batch shape per chunk size. Bitwise a
    single `insert_batch` over the whole batch because int32 adds
    commute.
    """
    n = len(counts)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        r = np.zeros(chunk, dtype=np.int32)
        c = np.zeros((col_idx.shape[0], chunk), dtype=np.int32)
        v = np.zeros(chunk, dtype=np.int32)
        r[: hi - lo] = rows[lo:hi]
        c[:, : hi - lo] = col_idx[:, lo:hi]
        v[: hi - lo] = counts[lo:hi]
        pool = insert_batch(pool, r, c, v)
    return pool


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Counter-wise add — the associative cross-epoch/cross-host reduce."""
    return a + b


def query(pool: torch.Tensor, rows: torch.Tensor,
          col_idx: torch.Tensor) -> torch.Tensor:
    """CMS point estimate per sample: min over depth of the addressed
    counters. i32[T,D,W] × i32[N] × i32[D,N] → i32[N]."""
    d = pool.shape[1]
    depth = torch.arange(d, dtype=torch.int64, device=pool.device)
    picked = pool[rows.to(torch.int64)[None, :], depth[:, None],
                  col_idx.to(torch.int64)]
    return picked.min(dim=0).values


def tenant_totals(pool: torch.Tensor) -> torch.Tensor:
    """Total inserted count per tenant row, in int32: any single depth
    row sums to the exact insert total (every insert adds `count` to each
    depth)."""
    return pool[:, 0, :].sum(dim=-1, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Fenced reads (the live query path, veneur_tpu_torch/query/)
#
# Reads outside the flush: they take the pool reference captured at the
# epoch fence, hash keys host-side, run only the programs above that
# write nothing, and read the result back to the host. Every pool
# mutation goes through insert_batch/insert_chunked, which RETURN new
# tensors, so a captured reference stays bitwise as it was.


def read_query(pool: torch.Tensor, tenant_row: int,
               keys: list[str]) -> np.ndarray:
    """Fenced CMS point estimates for `keys` against one tenant's sketch
    row: i64[len(keys)], pool state untouched."""
    if not keys:
        return np.zeros(0, dtype=np.int64)
    _t, d, w = pool.shape
    rows = np.full(len(keys), int(tenant_row), dtype=np.int32)
    cols = split_hashes(hash_keys(keys), d, w)
    est = query(pool, torch.from_numpy(rows).to(pool.device),
                torch.from_numpy(cols).to(pool.device))
    return est.cpu().numpy().astype(np.int64)


def read_totals(pool: torch.Tensor) -> np.ndarray:
    """Fenced per-tenant exact insert totals: i64[T], pool untouched."""
    return tenant_totals(pool).cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# Host-side mergeable top-k (space-saving / stream-summary)


class SpaceSavingTopK:
    """Metwally-style space-saving summary over (key, count) offers.

    Holds at most ``capacity`` keys. A new key arriving into a full summary
    evicts the current minimum and inherits its count as error bound —
    the classic guarantee: stored_count - error <= true_count <=
    stored_count, and any key with true count > min_count is present.

    ``merge`` is the standard summary merge: counts add for shared keys;
    a key present on one side only is credited the other side's min-count
    as its possible undercount (added to the error bound, not the count),
    then the union is re-truncated to capacity. Merge is commutative in
    the reported counts (tests pin top-k stability under merge).
    """

    __slots__ = ("capacity", "counts", "errors")

    def __init__(self, capacity: int = DEFAULT_TOPK):
        if capacity < 1:
            raise ValueError("top-k capacity must be >= 1")
        self.capacity = capacity
        self.counts: dict[str, int] = {}
        self.errors: dict[str, int] = {}

    def _min_key(self) -> str:
        return min(self.counts, key=lambda k: (self.counts[k], k))

    def offer(self, key: str, count: int = 1) -> None:
        if count <= 0:
            return
        if key in self.counts:
            self.counts[key] += count
            return
        if len(self.counts) < self.capacity:
            self.counts[key] = count
            self.errors[key] = 0
            return
        victim = self._min_key()
        floor = self.counts.pop(victim)
        self.errors.pop(victim)
        self.counts[key] = floor + count
        self.errors[key] = floor

    def merge(self, other: "SpaceSavingTopK") -> None:
        if not other.counts:
            return
        self_floor = min(self.counts.values()) if (
            len(self.counts) >= self.capacity) else 0
        other_floor = min(other.counts.values()) if (
            len(other.counts) >= other.capacity) else 0
        merged_counts: dict[str, int] = {}
        merged_errors: dict[str, int] = {}
        for key in set(self.counts) | set(other.counts):
            a = self.counts.get(key)
            b = other.counts.get(key)
            if a is not None and b is not None:
                merged_counts[key] = a + b
                merged_errors[key] = self.errors[key] + other.errors[key]
            elif a is not None:
                merged_counts[key] = a + other_floor
                merged_errors[key] = self.errors[key] + other_floor
            else:
                merged_counts[key] = b + self_floor
                merged_errors[key] = other.errors[key] + self_floor
        keep = sorted(merged_counts, key=lambda k: (-merged_counts[k], k))
        keep = keep[: self.capacity]
        self.counts = {k: merged_counts[k] for k in keep}
        self.errors = {k: merged_errors[k] for k in keep}

    def items(self) -> list[tuple[str, int, int]]:
        """(key, count, error) descending by count, ties by key — the
        deterministic order telemetry and tests rely on."""
        return [
            (k, self.counts[k], self.errors[k])
            for k in sorted(self.counts, key=lambda k: (-self.counts[k], k))
        ]
