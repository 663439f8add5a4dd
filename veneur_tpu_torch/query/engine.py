"""QueryEngine: epoch-fenced read views and the query evaluators.

Publish protocol (two-phase, cross-worker atomic):

1. Each DeviceWorker.extract_snapshot ends by calling its wired
   ``query_publisher`` — ``engine.stage(worker_idx, seq, snap,
   evaluate, sketch)`` — handing over this epoch's FlushSnapshot, a
   device evaluator closed over the retained post-fold field arrays,
   and a fenced tenant-sketch view.
2. After the server's extract stage finishes EVERY worker, it calls
   ``engine.commit(ts)``: the staged per-worker views become the one
   committed epoch queries serve. A query thread reads the committed
   reference exactly once and answers entirely from it, so concurrent
   ingest/flush can never produce a torn (cross-epoch) response —
   pinned by tests/test_query.py.

Three query families, matching the three sketch types:

* quantiles — flush-qs requests are served from the snapshot's host
  arrays (zero device work); ad-hoc quantile vectors run the retained
  extraction program on device (pow2-padded qs, ops/query.pad_quantiles
  bounds the compile ladder). ``force_device`` runs the device program
  even at the flush qs — that is the bitwise parity path the CI lane
  pins.
* cardinality — HLL estimates straight from the snapshot (the flush
  already paid the estimate readback).
* top-k / heavy hitters — the fenced SketchView per worker; cross-worker
  merge through SpaceSavingTopK.merge (counts add, error bounds
  compose).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from veneur_tpu_torch.core import columnar
from veneur_tpu_torch.core.flusher import device_quantiles, generate_columnar
from veneur_tpu_torch.core.metrics import DEFAULT_TENANT
from veneur_tpu_torch.ops import query as qops
from veneur_tpu_torch.ops.heavyhitter import SpaceSavingTopK
from veneur_tpu_torch.sinks.exposition import CONTENT_TYPE, render_columnar

log = logging.getLogger("veneur_tpu_torch.query.engine")

# default cap on rows returned by an unfiltered query — a 1M-series pool
# must not serialize wholesale through the JSON surface
DEFAULT_LIMIT = 1000


@dataclass
class WorkerView:
    """One worker's staged epoch: everything a read needs, captured at
    the fence."""

    seq: int  # worker-local epoch sequence
    snap: object  # core.worker.FlushSnapshot
    evaluate: Optional[Callable]  # qs f32[P] -> (packed [s_eff,P+10], P)
    sketch: object  # core.tenancy.SketchView or None


@dataclass
class CommittedEpoch:
    """The one epoch queries serve: every worker's view, committed
    together after the server's extract stage completed all of them."""

    seq: int  # engine-global commit sequence
    ts: int  # epoch wall-clock (the flush timestamp)
    views: tuple[WorkerView, ...]


def _row_matches(meta, name: Optional[str], tags: Optional[list]) -> bool:
    if name is not None and meta.key.name != name:
        return False
    if tags:
        have = set(meta.tags)
        return all(t in have for t in tags)
    return True


class QueryEngine:
    """Stage/commit store plus the query evaluators over it."""

    def __init__(self, percentiles: list, aggregates,
                 is_local: bool = True, topk: int = 8) -> None:
        self.percentiles = list(percentiles)
        self.aggregates = aggregates
        self.is_local = is_local
        self.topk = topk
        # float64 — host lookups by configured value must round-trip
        self.flush_qs = device_quantiles(percentiles, aggregates)
        self._lock = threading.Lock()
        self._staged: dict[int, WorkerView] = {}
        self._committed: Optional[CommittedEpoch] = None
        self._commit_seq = 0
        # per-epoch device-eval memo: (worker_idx, qs bytes) -> unpacked
        # quantile block. Dashboards repeat the same ad-hoc qs every
        # refresh; one device pass per epoch serves them all.
        self._eval_cache: dict = {}
        self._expo_cache: Optional[tuple[int, bytes, int]] = None
        # served-query telemetry (read by the server's flush self-metrics)
        self.queries_served = 0
        self.queries_failed = 0

    # -- publish (called from the flush path) ---------------------------

    def stage(self, worker_idx: int, seq: int, snap, evaluate,
              sketch) -> None:
        """Stage one worker's epoch view (the worker's extract fence
        calls this; see DeviceWorker.query_publisher)."""
        with self._lock:
            self._staged[worker_idx] = WorkerView(
                seq=seq, snap=snap, evaluate=evaluate, sketch=sketch)

    def commit(self, ts: Optional[int] = None) -> int:
        """Atomically publish all staged views as the next epoch.

        Runs after the server's extract stage finished every worker, so
        the committed tuple is a consistent cross-worker cut; queries in
        flight keep serving the previous epoch (they hold its
        reference)."""
        with self._lock:
            self._commit_seq += 1
            self._committed = CommittedEpoch(
                seq=self._commit_seq,
                ts=int(time.time()) if ts is None else int(ts),
                views=tuple(v for _i, v in sorted(self._staged.items())))
            self._eval_cache.clear()
            return self._commit_seq

    def epoch(self) -> Optional[CommittedEpoch]:
        """The committed epoch (one atomic reference read — everything a
        single query answers from)."""
        return self._committed

    # -- quantile / scalar queries --------------------------------------

    def _flush_q_columns(self, qs: Optional[np.ndarray]
                         ) -> Optional[list[int]]:
        """Column indices into the snapshot's quantile block when every
        requested quantile was already evaluated at flush, else None."""
        if qs is None:
            return list(range(len(self.flush_qs)))
        idx = {float(q): i for i, q in enumerate(self.flush_qs)}
        cols = []
        for q in np.asarray(qs, dtype=np.float64):
            i = idx.get(float(q))
            if i is None:
                return None
            cols.append(i)
        return cols

    def _device_quantiles(self, epoch: CommittedEpoch, wi: int,
                          view: WorkerView, qs: np.ndarray) -> np.ndarray:
        """The [n, P] quantile block for one worker at an ad-hoc qs,
        evaluated on device through the retained extraction program
        (memoized per epoch)."""
        padded, norig = qops.pad_quantiles(qs)
        key = (wi, padded.tobytes())
        cached = self._eval_cache.get(key)
        if cached is None:
            packed, p = view.evaluate(padded)
            qv, _aggs = columnar.unpack_extract_columns(packed, p)
            cached = self._eval_cache[key] = qv
        n = len(view.snap.directory.histo.rows)
        return cached[:n, :norig]

    def query_quantiles(self, qs=None, name: Optional[str] = None,
                        tags: Optional[list] = None,
                        force_device: bool = False,
                        limit: int = DEFAULT_LIMIT) -> dict:
        """Quantile read over the committed epoch's histogram/timer rows.

        qs None or a subset of the flush vector → host arrays (unless
        force_device); anything else → the device path. force_device at
        the flush qs is the bitwise parity probe."""
        epoch = self._committed
        if epoch is None:
            return {"epoch": 0, "ts": 0, "results": []}
        qs_arr = (np.asarray(self.flush_qs, dtype=np.float64) if qs is None
                  else np.asarray(qs, dtype=np.float64))
        cols = None if force_device else self._flush_q_columns(
            None if qs is None else qs_arr)
        results = []
        for wi, view in enumerate(epoch.views):
            snap = view.snap
            hrows = snap.directory.histo.rows
            if not hrows or snap.quantile_values is None:
                continue
            block = None
            if cols is None:
                if view.evaluate is None:
                    continue
                block = self._device_quantiles(epoch, wi, view, qs_arr)
            for row, meta in enumerate(hrows):
                if not _row_matches(meta, name, tags):
                    continue
                if cols is not None:
                    vals = [float(snap.quantile_values[row, c])
                            for c in cols]
                else:
                    vals = [float(v) for v in block[row]]
                results.append({
                    "name": meta.key.name,
                    "type": meta.key.type,
                    "tags": list(meta.tags),
                    "qs": [float(q) for q in qs_arr],
                    "values": vals,
                    "count": float(snap.dcount[row]),
                })
                if len(results) >= limit:
                    return {"epoch": epoch.seq, "ts": epoch.ts,
                            "results": results, "truncated": True}
        return {"epoch": epoch.seq, "ts": epoch.ts, "results": results}

    def query_scalars(self, name: Optional[str] = None,
                      tags: Optional[list] = None,
                      limit: int = DEFAULT_LIMIT) -> dict:
        """Digest-side scalar aggregates (min/max/sum/count) per matching
        histogram/timer row — all host reads from the snapshot."""
        epoch = self._committed
        if epoch is None:
            return {"epoch": 0, "ts": 0, "results": []}
        results = []
        for view in epoch.views:
            snap = view.snap
            hrows = snap.directory.histo.rows
            if not hrows or snap.dcount is None:
                continue
            for row, meta in enumerate(hrows):
                if not _row_matches(meta, name, tags):
                    continue
                results.append({
                    "name": meta.key.name,
                    "type": meta.key.type,
                    "tags": list(meta.tags),
                    "min": float(snap.dmin[row]),
                    "max": float(snap.dmax[row]),
                    "sum": float(snap.dsum[row]),
                    "count": float(snap.dcount[row]),
                })
                if len(results) >= limit:
                    return {"epoch": epoch.seq, "ts": epoch.ts,
                            "results": results, "truncated": True}
        return {"epoch": epoch.seq, "ts": epoch.ts, "results": results}

    # -- cardinality ----------------------------------------------------

    def query_cardinality(self, name: Optional[str] = None,
                          tags: Optional[list] = None,
                          limit: int = DEFAULT_LIMIT) -> dict:
        """HLL cardinality estimates per matching set row, straight from
        the snapshot's already-read-back estimates (parity with the
        flush is identity)."""
        epoch = self._committed
        if epoch is None:
            return {"epoch": 0, "ts": 0, "results": []}
        results = []
        for view in epoch.views:
            snap = view.snap
            srows = snap.directory.sets.rows
            if not srows or snap.set_estimates is None:
                continue
            for row, meta in enumerate(srows):
                if not _row_matches(meta, name, tags):
                    continue
                results.append({
                    "name": meta.key.name,
                    "tags": list(meta.tags),
                    "estimate": float(snap.set_estimates[row]),
                })
                if len(results) >= limit:
                    return {"epoch": epoch.seq, "ts": epoch.ts,
                            "results": results, "truncated": True}
        return {"epoch": epoch.seq, "ts": epoch.ts, "results": results}

    # -- heavy hitters --------------------------------------------------

    def query_topk(self, tenant: str = DEFAULT_TENANT,
                   k: Optional[int] = None) -> dict:
        """Cross-worker top-k for one tenant: each worker's fenced
        space-saving items merge through the standard summary merge
        (counts add, error bounds compose), truncated to k."""
        epoch = self._committed
        if epoch is None:
            return {"epoch": 0, "ts": 0, "results": []}
        cap = k or self.topk
        merged = SpaceSavingTopK(cap)
        for view in epoch.views:
            if view.sketch is None:
                continue
            items = view.sketch.top_keys(tenant)
            if not items:
                continue
            part = SpaceSavingTopK(max(len(items), 1))
            for key, count, err in items:
                part.counts[key] = int(count)
                part.errors[key] = int(err)
            merged.merge(part)
        return {"epoch": epoch.seq, "ts": epoch.ts,
                "results": [{"key": key, "count": count, "error": err}
                            for key, count, err in merged.items()]}

    def query_tenant_totals(self) -> dict:
        """Exact per-tenant inserted-sample totals, summed across the
        workers' fenced sketch views."""
        epoch = self._committed
        if epoch is None:
            return {"epoch": 0, "ts": 0, "results": {}}
        totals: dict[str, int] = {}
        for view in epoch.views:
            if view.sketch is None:
                continue
            for t, n in view.sketch.totals().items():
                totals[t] = totals.get(t, 0) + int(n)
        return {"epoch": epoch.seq, "ts": epoch.ts, "results": totals}

    def query_cms(self, keys: list[str],
                  tenant: str = DEFAULT_TENANT) -> dict:
        """Count-min point estimates for explicit series keys (summing
        per-worker estimates: each series lives on one worker, and every
        per-worker estimate is already an upper bound, so the sum still
        upper-bounds the true total)."""
        epoch = self._committed
        if epoch is None:
            return {"epoch": 0, "ts": 0, "results": {}}
        est = np.zeros(len(keys), dtype=np.int64)
        for view in epoch.views:
            if view.sketch is None:
                continue
            est += view.sketch.estimate(tenant, list(keys))
        return {"epoch": epoch.seq, "ts": epoch.ts,
                "results": {k: int(v) for k, v in zip(keys, est)}}

    # -- dispatch (the wire entry both fronts share) ---------------------

    def dispatch(self, req: dict) -> dict:
        """One JSON request → one JSON-serializable response. Both the
        gRPC service and the HTTP /query endpoint call this, so the two
        fronts answer identically by construction."""
        try:
            op = req.get("op", "epoch")
            if op == "quantiles":
                out = self.query_quantiles(
                    qs=req.get("qs"), name=req.get("name"),
                    tags=req.get("tags"),
                    force_device=bool(req.get("force_device")),
                    limit=int(req.get("limit", DEFAULT_LIMIT)))
            elif op == "scalars":
                out = self.query_scalars(
                    name=req.get("name"), tags=req.get("tags"),
                    limit=int(req.get("limit", DEFAULT_LIMIT)))
            elif op == "cardinality":
                out = self.query_cardinality(
                    name=req.get("name"), tags=req.get("tags"),
                    limit=int(req.get("limit", DEFAULT_LIMIT)))
            elif op == "topk":
                out = self.query_topk(
                    tenant=req.get("tenant", DEFAULT_TENANT),
                    k=req.get("k"))
            elif op == "tenant_totals":
                out = self.query_tenant_totals()
            elif op == "cms":
                out = self.query_cms(
                    keys=list(req.get("keys", ())),
                    tenant=req.get("tenant", DEFAULT_TENANT))
            elif op == "epoch":
                epoch = self._committed
                out = {"epoch": epoch.seq if epoch else 0,
                       "ts": epoch.ts if epoch else 0,
                       "workers": len(epoch.views) if epoch else 0}
            else:
                raise ValueError(f"unknown query op: {op!r}")
            out["op"] = op
            # device fault domain: when any worker's epoch was completed
            # on the host fallback engine (snap.degraded — breaker open
            # or a mid-flush device fault), every response carries the
            # flag. The numbers are still exact (the host engine is
            # bit-identical), but readers deserve to know the device
            # path was out. Omitted entirely on healthy epochs.
            epoch = self._committed
            if epoch is not None and any(
                    getattr(v.snap, "degraded", False)
                    for v in epoch.views):
                out["degraded"] = True
            self.queries_served += 1
            return out
        except Exception as exc:
            self.queries_failed += 1
            log.debug("query dispatch failed", exc_info=True)
            return {"error": f"{type(exc).__name__}: {exc}"}

    # -- exposition (the HTTP /metrics surface) --------------------------

    def render_exposition(self) -> tuple[bytes, int, str]:
        """The committed epoch as one Prometheus exposition-text body →
        (body, sample count, content type). Rendered through the SAME
        pipeline the exposition sink uses (generate_columnar + the
        shared renderer, sinks/exposition.py) with routing disabled
        (sink_name None: a scrape sees every series), cached per epoch."""
        epoch = self._committed
        if epoch is None:
            return b"", 0, CONTENT_TYPE
        cached = self._expo_cache
        if cached is not None and cached[0] == epoch.seq:
            return cached[1], cached[2], CONTENT_TYPE
        chunks: list[bytes] = []
        count = 0
        for view in epoch.views:
            batch = generate_columnar(
                view.snap, self.is_local, self.percentiles,
                self.aggregates, now=epoch.ts)
            body, n = render_columnar(batch, sink_name=None)
            chunks.append(body)
            count += n
        body = b"".join(chunks)
        self._expo_cache = (epoch.seq, body, count)
        return body, count, CONTENT_TYPE
