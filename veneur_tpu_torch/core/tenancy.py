"""Per-tenant QoS: series budgets, honest tallies, and heavy-hitter folds.

Copied from veneur_tpu/core/tenancy.py, with ``TenantSketch`` taking the
device its count-min pool lives on (the worker's) and its ``totals()``
reading through the fenced functions of ops/heavyhitter.py.

The reference has no tenant concept — its only defense against one client
exploding key cardinality is coarse worker shedding (PAPER.md L2/L7). At
production scale that is the failure mode that kills an aggregator
(ROADMAP open item 4), so this module adds the missing layer:

* ``TenantLedger`` — per-tenant *series budgets* enforced at directory
  adopt time. The semantics are deliberately reject-new-series, never
  evict-live: once a tenant crosses its budget, samples for series the
  tenant has not yet registered are refused, while every already-admitted
  series keeps aggregating — innocent dashboards never flap, and an
  abusive tenant's damage is capped at exactly its budget. Budget 0 means
  unlimited (the single-tenant default: the QoS layer costs nothing until
  configured).

* ``TenantTallies`` — the per-epoch sample accounting (accepted / kept /
  rejected / dropped per tenant) that the worker accumulates into
  lifetime totals pre-swap, exactly like ``Worker.processed_total``, so a
  tenant's drops in a swapped-out epoch survive a late pipelined extract.
  Conservation is exact per tenant: accepted == kept + rejected + dropped
  (the isolation soak's core assertion).

* ``TenantSketch`` — the detection half: a per-tenant count-min pool
  (ops/heavyhitter.py) folded on-device over the flushed columnar batch,
  plus a host-side space-saving top-k per tenant, so telemetry can name
  *which* keys a hot tenant is exploding without holding exact per-key
  state.

One ledger is shared by every worker on a host (admission must be a
global decision — a tenant's series spread across workers by digest), so
``admit`` takes a lock; it only runs on new-series adopts, never on the
per-sample hot path.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from veneur_tpu_torch.core.metrics import DEFAULT_TENANT

# Bounded dedup memory for the distinct-rejected-series counter: past this
# many tracked keys (across all tenants) the dedup sets are cleared, same
# discipline as the worker's adopt cache — after a clear a re-rejected
# series recounts, so `series_rejected` may overcount under extreme churn
# (documented; the alternative is unbounded memory, i.e. the attack).
REJECTED_SEEN_CAP = 1 << 16


class TenantLedger:
    """Per-tenant admitted-series sets + budget decisions (host-global)."""

    def __init__(self, default_budget: int = 0,
                 budgets: Optional[dict[str, int]] = None,
                 tag_key: str = "tenant") -> None:
        self.tag_key = tag_key
        self.default_budget = int(default_budget)
        self.budgets: dict[str, int] = {
            str(k): int(v) for k, v in (budgets or {}).items()}
        self._lock = threading.Lock()
        self._admitted: dict[str, set[str]] = {}
        self._rejected_seen: dict[str, set[str]] = {}
        self._rejected_seen_entries = 0
        self.series_rejected: dict[str, int] = {}  # lifetime, per tenant

    def budget_for(self, tenant: str) -> int:
        return self.budgets.get(tenant, self.default_budget)

    def set_budgets(self, default_budget: int,
                    budgets: Optional[dict[str, int]] = None) -> None:
        """Hot-swap the budget table (config reload). Admitted series are
        untouched — a lowered budget rejects *new* series only, keeping
        the reject-new-never-evict contract; a raised budget takes effect
        on the next adopt."""
        with self._lock:
            self.default_budget = int(default_budget)
            self.budgets = {
                str(k): int(v) for k, v in (budgets or {}).items()}

    def admit(self, tenant: str, series_key: str) -> bool:
        """True iff ``series_key`` may (continue to) aggregate for
        ``tenant``. Idempotent: an admitted series stays admitted for the
        ledger's lifetime (the directory swaps wholesale every interval and
        the adopt cache can be cleared — re-admission must be free and
        must not re-consume budget)."""
        with self._lock:
            adm = self._admitted.get(tenant)
            if adm is None:
                adm = self._admitted[tenant] = set()
            if series_key in adm:
                return True
            budget = self.budgets.get(tenant, self.default_budget)
            if budget <= 0 or len(adm) < budget:
                adm.add(series_key)
                return True
            seen = self._rejected_seen.setdefault(tenant, set())
            if series_key not in seen:
                if self._rejected_seen_entries >= REJECTED_SEEN_CAP:
                    for s in self._rejected_seen.values():
                        s.clear()
                    self._rejected_seen_entries = 0
                seen.add(series_key)
                self._rejected_seen_entries += 1
                self.series_rejected[tenant] = (
                    self.series_rejected.get(tenant, 0) + 1)
            return False

    def live(self, tenant: str) -> int:
        with self._lock:
            adm = self._admitted.get(tenant)
            return len(adm) if adm else 0

    def live_counts(self) -> dict[str, int]:
        with self._lock:
            return {t: len(s) for t, s in self._admitted.items()}

    def series_rejected_counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self.series_rejected)

    def over_budget(self) -> frozenset[str]:
        """Tenants at/over a finite budget — the shed-first set the
        tenant-aware spill partition (health/policy.py) consumes."""
        with self._lock:
            out = []
            for t, adm in self._admitted.items():
                budget = self.budgets.get(t, self.default_budget)
                if budget > 0 and len(adm) >= budget:
                    out.append(t)
            return frozenset(out)


class TenantTallies:
    """Per-epoch per-tenant sample accounting (one instance per worker).

    Not locked: every mutation happens under the owning worker's ingest
    lock (process_metric / swap), the same discipline as ``processed``.
    """

    KINDS = ("accepted", "kept", "rejected", "dropped")

    __slots__ = ("accepted", "kept", "rejected", "dropped")

    def __init__(self) -> None:
        self.accepted: dict[str, int] = {}
        self.kept: dict[str, int] = {}
        self.rejected: dict[str, int] = {}
        self.dropped: dict[str, int] = {}

    def reset(self) -> None:
        self.accepted.clear()
        self.kept.clear()
        self.rejected.clear()
        self.dropped.clear()

    def accumulate_into(self, totals: "TenantTallies") -> None:
        """The pre-swap lifetime fold (the ``processed_total +=
        processed`` pattern, per tenant per kind)."""
        for kind in self.KINDS:
            src = getattr(self, kind)
            dst = getattr(totals, kind)
            for t, n in src.items():
                dst[t] = dst.get(t, 0) + n

    def merged_with(self, other: "TenantTallies") -> dict[str, dict[str, int]]:
        """totals + current epoch, as plain dicts — the locked-read view
        (mirrors Server.ingress_stats' processed_total + processed)."""
        out: dict[str, dict[str, int]] = {}
        for kind in self.KINDS:
            acc: dict[str, int] = dict(getattr(self, kind))
            for t, n in getattr(other, kind).items():
                acc[t] = acc.get(t, 0) + n
            out[kind] = acc
        return out

    def conservation_gaps(self) -> dict[str, int]:
        """accepted - (kept + rejected + dropped) per tenant — all zeros
        when accounting is exact (the soak's invariant)."""
        tenants = set(self.accepted) | set(self.kept) | set(
            self.rejected) | set(self.dropped)
        return {
            t: self.accepted.get(t, 0) - self.kept.get(t, 0)
            - self.rejected.get(t, 0) - self.dropped.get(t, 0)
            for t in tenants
        }


class TenantSketch:
    """Per-tenant heavy-hitter state: a count-min pool row per tenant plus
    a host-side space-saving top-k, fed once per flush from the already-
    folded per-row counts (one offer per live series per interval, never
    per sample — the device pays one scatter-add batch per flush)."""

    def __init__(self, depth: int, width: int, topk: int,
                 max_tenants: int = 64, device=None) -> None:
        # import here so the zero-tenant path never touches torch for this
        from veneur_tpu_torch.ops import heavyhitter

        self._hh = heavyhitter
        self.depth = depth
        self.width = width
        self.max_tenants = max_tenants
        self.pool = heavyhitter.init_pool(max_tenants, depth, width, device)
        # row 0 is reserved for the default tenant; tenants past the cap
        # alias onto it rather than growing the pool
        self._row_of: dict[str, int] = {DEFAULT_TENANT: 0}
        self.topk: dict[str, "object"] = {}
        self._topk_cap = topk

    def row_for(self, tenant: str) -> int:
        row = self._row_of.get(tenant)
        if row is None:
            if len(self._row_of) >= self.max_tenants:
                return 0
            row = len(self._row_of)
            self._row_of[tenant] = row
        return row

    def fold(self, tenants: Iterable[str], keys: list[str],
             counts: np.ndarray, chunk: int) -> None:
        """Fold one flush interval's (tenant, series key, sample count)
        triples into the device pool and the host top-k summaries."""
        if not keys:
            return
        rows = np.fromiter((self.row_for(t) for t in tenants),
                           dtype=np.int32, count=len(keys))
        hashes = self._hh.hash_keys(keys)
        cols = self._hh.split_hashes(hashes, self.depth, self.width)
        cnts = np.asarray(counts, dtype=np.int32)
        self.pool = self._hh.insert_chunked(self.pool, rows, cols, cnts,
                                            chunk)
        for tenant, key, n in zip(tenants, keys, cnts.tolist()):
            if n <= 0:
                continue
            summ = self.topk.get(tenant)
            if summ is None:
                summ = self.topk[tenant] = self._hh.SpaceSavingTopK(
                    self._topk_cap)
            summ.offer(key, int(n))

    def totals(self) -> dict[str, int]:
        """Exact per-tenant inserted sample totals (one depth row of the
        CMS sums to the insert total)."""
        tt = self._hh.read_totals(self.pool)
        return {t: int(tt[row]) for t, row in self._row_of.items()}

    def top_keys(self, tenant: str) -> list[tuple[str, int, int]]:
        summ = self.topk.get(tenant)
        return summ.items() if summ is not None else []

    def snapshot(self) -> "SketchView":
        """Fenced read view for the live query path (veneur_tpu_torch/query/).

        Captured at the epoch fence — inside extract_snapshot, right
        after fold(), where extractions never overlap — so the view is a
        consistent point-in-time read. The pool reference is safe to
        share without copying: every pool mutation goes through
        insert_chunked, which REPLACES self.pool with a new array, never
        writes in place, so a captured reference stays bit-identical
        forever (ops/heavyhitter.insert_batch is out of place). The top-k
        summaries DO mutate in place (host dicts), so
        their items are copied out here."""
        return SketchView(
            pool=self.pool,
            row_of=dict(self._row_of),
            topk={t: s.items() for t, s in self.topk.items()},
        )


@dataclass
class SketchView:
    """Immutable heavy-hitter read view from TenantSketch.snapshot():
    what a live query serves between epoch fences. All reads go through
    the fenced (non-mutating) entry points in ops/heavyhitter."""

    pool: object  # i32[T, D, W] device tensor (reference, never mutated)
    row_of: dict[str, int]
    topk: dict[str, list[tuple[str, int, int]]]

    def totals(self) -> dict[str, int]:
        from veneur_tpu_torch.ops import heavyhitter

        tt = heavyhitter.read_totals(self.pool)
        return {t: int(tt[row]) for t, row in self.row_of.items()}

    def top_keys(self, tenant: str) -> list[tuple[str, int, int]]:
        return list(self.topk.get(tenant, ()))

    def estimate(self, tenant: str, keys: list[str]) -> np.ndarray:
        from veneur_tpu_torch.ops import heavyhitter

        return heavyhitter.read_query(
            self.pool, self.row_of.get(tenant, 0), keys)
