"""ColumnarSpanPipeline: the flush-driven span path of the server.

Ingest appends spans into columnar batches (spans/batch.py); the flush
edge derives every pending batch's metrics (spans/derive.py) straight
into the device workers — grouped per worker so each worker lock is
taken once per flush instead of once per derived metric — and hands the
sealed batches to the batch-capable span sinks for egress. Derivation
runs at the flush edge *before* the epoch swap, so an interval's spans
land in the same epoch its statsd samples do, and the derived key space
flows through the existing staged-plane path: micro-fold, series_shards,
tenant budgets and QoS all apply unchanged.

Conservation is exact and cheap to assert (the SPAN_SUSTAINED soak
does): spans_ingested == spans_derived + spans_dropped + pending, all
monotonic for the life of the process.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

from veneur_tpu_torch.spans.batch import SpanColumnizer, StringArena
from veneur_tpu_torch.spans.derive import TemplateStore, derive_batch

log = logging.getLogger("veneur_tpu_torch.spans.pipeline")


class ColumnarSpanPipeline:
    def __init__(self, route_many: Callable[[list], None],
                 batch_sinks: Optional[list] = None,
                 common_tags: Optional[dict] = None,
                 indicator_timer_name: str = "",
                 objective_timer_name: str = "",
                 uniqueness_rate: float = 0.0,
                 batch_rows: int = 512,
                 pending_cap: int = 1 << 20) -> None:
        self.route_many = route_many
        self.batch_sinks = list(batch_sinks or [])
        self.uniqueness_rate = uniqueness_rate
        self.arena = StringArena()
        self.store = TemplateStore(
            self.arena,
            indicator_timer_name=indicator_timer_name,
            objective_timer_name=objective_timer_name)
        self.columnizer = SpanColumnizer(
            self.arena, self.store, common_tags=common_tags,
            batch_rows=batch_rows, pending_cap=pending_cap)
        # lifetime tallies (columnizer owns ingest-side ones)
        self.spans_derived = 0
        self.derived_rows = 0
        self.sink_errors = 0

    # -- ingest side ---------------------------------------------------

    def ingest(self, span) -> None:
        """Non-blocking columnar append; sheds at the pending cap
        (loss-over-stall, counted)."""
        self.columnizer.append(span)

    @property
    def spans_ingested(self) -> int:
        return self.columnizer.spans_appended

    @property
    def spans_dropped(self) -> int:
        return self.columnizer.spans_dropped

    @property
    def invalid_samples(self) -> int:
        return self.columnizer.invalid_samples

    @property
    def pending(self) -> int:
        return self.columnizer.pending

    # -- flush edge ----------------------------------------------------

    def flush(self) -> tuple[int, int]:
        """Derive and route every pending batch, then hand the sealed
        batches to the batch span sinks. Returns (spans, derived rows)
        this call processed. Runs on the flush tick before the epoch
        swap; ingest keeps appending into a fresh open batch meanwhile."""
        sealed = self.columnizer.take_sealed()
        if not sealed:
            return 0, 0
        spans = 0
        rows = 0
        for sb in sealed:
            derived: list = []
            rows += derive_batch(sb, self.uniqueness_rate, derived.append)
            if derived:
                self.route_many(derived)
            spans += sb.batch.rows
        self.spans_derived += spans
        self.derived_rows += rows
        for sink in self.batch_sinks:
            for sb in sealed:
                try:
                    sink.ingest_batch(sb)
                except Exception:
                    self.sink_errors += 1
                    log.exception("batch span sink %s ingest_batch failed",
                                  sink.name())
        return spans, rows

    def stats(self) -> dict:
        return {
            "spans_ingested": self.spans_ingested,
            "spans_derived": self.spans_derived,
            "spans_dropped": self.spans_dropped,
            "derived_rows": self.derived_rows,
            "invalid_samples": self.invalid_samples,
            "pending": self.pending,
            "sink_errors": self.sink_errors,
        }
