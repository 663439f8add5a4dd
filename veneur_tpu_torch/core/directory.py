"""Series directory: MetricKey → dense device-pool row assignment.

The reference keys per-flush sampler state with 13 Go maps split by type and
scope (worker.go:60-103). On TPU, sketch state must live in dense, fixed-
shape device arrays, so the maps become this directory: each (key, class)
gets a row index into one of two device pools (t-digest rows for
histogram/timer series, HLL rows for set series), and the scope split
becomes a per-row class label consulted only at flush/forward time — the
device programs are scope-oblivious and operate on whole pools.

Like the reference, all aggregation state lives exactly one flush interval:
the directory (and its pools) is swapped wholesale at flush (the map-swap of
worker.go:498-517 becomes a directory+buffer swap).
"""

from __future__ import annotations

import enum
from array import array
from dataclasses import dataclass, field
from typing import Optional

from veneur_tpu_torch.core.metrics import MetricKey, MetricScope, route_info


class ScopeClass(enum.IntEnum):
    """Which of the reference's map groups a series belongs to
    (worker.go:60-103: plain / global* / local* maps)."""

    MIXED = 0
    LOCAL = 1
    GLOBAL = 2


def classify(mtype: str, scope: MetricScope) -> ScopeClass:
    """Reference WorkerMetrics.Upsert routing (worker.go:108-177)."""
    if mtype in ("counter", "gauge"):
        return (
            ScopeClass.GLOBAL
            if scope == MetricScope.GLOBAL_ONLY
            else ScopeClass.MIXED
        )
    if mtype in ("histogram", "timer"):
        if scope == MetricScope.LOCAL_ONLY:
            return ScopeClass.LOCAL
        if scope == MetricScope.GLOBAL_ONLY:
            return ScopeClass.GLOBAL
        return ScopeClass.MIXED
    if mtype == "set":
        return (
            ScopeClass.LOCAL
            if scope == MetricScope.LOCAL_ONLY
            else ScopeClass.MIXED
        )
    if mtype == "status":
        return ScopeClass.LOCAL
    return ScopeClass.MIXED


def build_frag(name: str, tags: list[str]):
    """One blob record for the native batch encoders:
    "name \\x1f tag \\x1f tag ..." utf-8, or None when the data itself
    contains the record/field separators (those rows need the Python
    formatter)."""
    rec = name + "\x1f" + "\x1f".join(tags) if tags else name
    if "\x1e" in rec or "\x1f" in name or any(
            "\x1f" in t or "\x1e" in t for t in tags):
        return None
    return rec.encode("utf-8")


@dataclass
class RowMeta:
    """Host-side metadata for one pool row (what the dense arrays can't
    hold: names, tags, routing)."""

    key: MetricKey
    tags: list[str]
    scope_class: ScopeClass
    sinks: Optional[frozenset[str]]  # from veneursinkonly: tags
    # per-tenant QoS (core/tenancy.py): which tenant owns the series, and
    # whether the tenant ledger admitted it. The Python upsert path never
    # creates a row for a rejected series; the native path assigns rows in
    # C++ before Python sees them, so a rejected series lands here with
    # admitted=False and the flush skips it (both emit paths).
    tenant: str = ""
    admitted: bool = True
    # lazily-built wire fragment for the native encoders; False = not
    # yet built, None = contains the separators, use the Python path
    _frag: object = False

    def wire_frag(self):
        """Cached blob record for the native batch encoders. RowMeta
        objects outlive epochs (the worker's adopt cache), so this
        builds once per series lifetime."""
        frag = self._frag
        if frag is False:
            frag = build_frag(self.key.name, self.tags)
            self._frag = frag
        return frag


@dataclass
class _Pool:
    index: dict[tuple[MetricKey, ScopeClass], int] = field(default_factory=dict)
    rows: list[RowMeta] = field(default_factory=list)
    # per-row scope codes as a packed byte array (zero-copy numpy view for
    # the columnar flush — no O(rows) attribute walk at flush time), plus
    # a count of rows carrying veneursinkonly routing so the common
    # no-routing case skips per-row checks entirely
    scope_codes: array = field(default_factory=lambda: array("b"))
    routed_rows: int = 0
    # per-row admission codes (1 admitted / 0 rejected), same packed-byte
    # idiom as scope_codes so the columnar flush gets a zero-copy numpy
    # mask; rejected_rows counts them so the common all-admitted case
    # skips per-row checks entirely
    admit_codes: array = field(default_factory=lambda: array("b"))
    rejected_rows: int = 0
    # \x1e-joined wire_frag arena over rows [0, len(rows)), maintained
    # incrementally at adopt so the flush hands the native emit tier one
    # contiguous buffer with zero per-row work; poisoned (frag_clean
    # False, arena abandoned) the moment any row's frag is None
    frag_arena: bytearray = field(default_factory=bytearray)
    frag_clean: bool = True

    def frag_blob(self) -> Optional[bytearray]:
        """The native emitters' metadata buffer for this pool, or None
        when some row needs the Python path."""
        return self.frag_arena if self.frag_clean else None

    def upsert(self, key: MetricKey, scope_class: ScopeClass, tags: list[str],
               tenant: str = "") -> tuple[int, bool]:
        k = (key, scope_class)
        row = self.index.get(k)
        if row is not None:
            return row, False
        row = len(self.rows)
        self.adopt(row, key, scope_class, tags, tenant=tenant)
        return row, True

    def adopt(self, row: int, key: MetricKey, scope_class: ScopeClass,
              tags: list[str], tenant: str = "") -> None:
        """Register metadata for a row assigned externally (the native
        directory assigns rows in the same append order)."""
        self.adopt_meta(row, RowMeta(
            key=key, tags=tags, scope_class=scope_class,
            sinks=route_info(tags), tenant=tenant))

    def upsert_meta(self, meta: RowMeta) -> tuple[int, bool]:
        """Upsert with prebuilt metadata: the reader-shard reconcile path
        (core/worker._sync_native_series) folds N per-reader row spaces
        into this canonical directory, so the same series arriving via
        several readers must dedup here instead of adopting per-context
        rows verbatim."""
        k = (meta.key, meta.scope_class)
        row = self.index.get(k)
        if row is not None:
            return row, False
        row = len(self.rows)
        self.adopt_meta(row, meta)
        return row, True

    def adopt_meta(self, row: int, meta: RowMeta) -> None:
        """Adopt with prebuilt metadata (the worker's cross-epoch adopt
        cache reuses one RowMeta per series: the same series re-registers
        every interval, and rebuilding key/tags/routing per epoch was
        the global tier's import bottleneck)."""
        assert row == len(self.rows), "rows must be adopted in order"
        self.index[(meta.key, meta.scope_class)] = row
        if meta.sinks is not None:
            self.routed_rows += 1
        self.scope_codes.append(int(meta.scope_class))
        self.admit_codes.append(1 if meta.admitted else 0)
        if not meta.admitted:
            self.rejected_rows += 1
        self.rows.append(meta)
        if self.frag_clean:
            frag = meta.wire_frag()
            if frag is None:
                self.frag_clean = False
            else:
                if row:
                    self.frag_arena += b"\x1e"
                self.frag_arena += frag


class SeriesDirectory:
    """One flush interval's series → row mapping for both device pools.

    Distinct (key, scope_class) pairs get distinct rows, mirroring the
    reference where the same MetricKey can live in e.g. both `timers` and
    `globalTimers` maps simultaneously.
    """

    def __init__(self) -> None:
        self.histo = _Pool()  # histogram + timer series → t-digest rows
        self.sets = _Pool()  # set series → HLL rows

    def upsert_histo(self, key: MetricKey, scope_class: ScopeClass,
                     tags: list[str], tenant: str = "") -> tuple[int, bool]:
        return self.histo.upsert(key, scope_class, tags, tenant=tenant)

    def upsert_set(self, key: MetricKey, scope_class: ScopeClass,
                   tags: list[str], tenant: str = "") -> tuple[int, bool]:
        return self.sets.upsert(key, scope_class, tags, tenant=tenant)

    @property
    def num_histo_rows(self) -> int:
        return len(self.histo.rows)

    @property
    def num_set_rows(self) -> int:
        return len(self.sets.rows)

    def shard_counts(self, shards: int) -> tuple[list[int], list[int]]:
        """Live rows per device shard under the series-sharded row
        interleave (ops/series_shard.py: logical row r lives on shard
        r % shards): (histo_rows_per_shard, set_rows_per_shard).

        The interleave balances by construction — max−min ≤ 1 per pool —
        so this is a telemetry/bench readout (shard occupancy for
        capacity math), never a balancing input."""
        nh, ns = len(self.histo.rows), len(self.sets.rows)
        return ([(nh + shards - 1 - d) // shards for d in range(shards)],
                [(ns + shards - 1 - d) // shards for d in range(shards)])
