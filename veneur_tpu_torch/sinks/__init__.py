"""Sink interfaces and registry.

Parity spec: reference sinks/sinks.go — MetricSink (:32-47), SpanSink
(:85-103), and the canonical self-telemetry metric names (:11-29, :60-78).
"""

from __future__ import annotations

import abc
from typing import Iterable, Optional

from veneur_tpu_torch.core.metrics import InterMetric, route_to
from veneur_tpu_torch.ssf import SSFSample, SSFSpan

# Canonical sink self-telemetry metric names (reference sinks/sinks.go:11-29)
METRIC_KEY_TOTAL_SPANS_FLUSHED = "sink.spans_flushed_total"
METRIC_KEY_TOTAL_SPANS_DROPPED = "sink.spans_dropped_total"
METRIC_KEY_TOTAL_METRICS_FLUSHED = "sink.metrics_flushed_total"
METRIC_KEY_TOTAL_METRICS_SKIPPED = "sink.metrics_skipped_total"

# Canonical delivery-reliability counters (sinks/delivery.py): every
# network sink exposes one DeliveryManager whose cumulative stats()
# carry these keys; the server reports them as interval deltas under
# "delivery.<key>" tagged sink:<name>, so one dashboard query covers
# every sink. circuit_state_code (0 closed / 1 half-open / 2 open) and
# the spill occupancy are point-in-time gauges, not deltas.
DELIVERY_STAT_COUNTERS = (
    "delivered_payloads", "dropped_payloads", "dropped_bytes",
    "retries", "deferred_payloads", "deadline_clipped",
    "breaker_short_circuits", "journal_appended", "journal_recovered",
)


class MetricSink(abc.ABC):
    """A destination for flushed metrics (reference sinks/sinks.go:32-47)."""

    @abc.abstractmethod
    def name(self) -> str: ...

    def start(self, trace_client=None) -> None:
        """Called once before the server starts flushing."""

    @abc.abstractmethod
    def flush(self, metrics: list[InterMetric]) -> None: ...

    # Columnar flush path (core/columnar.py): sinks that can consume the
    # SoA batch directly set supports_columnar = True and override
    # flush_columnar — the server then never materializes per-metric
    # objects. The default here exists so an override-less sink still
    # behaves correctly if handed a batch.
    supports_columnar = False

    def flush_columnar(self, batch, excluded_tags: Optional[set] = None
                       ) -> None:
        metrics = filter_routed(batch.materialize(), self.name())
        self.flush(strip_excluded_tags(metrics, excluded_tags))

    # Native emit path (native/emit.cpp): sinks whose wire format the
    # native serializers produce set supports_native_emit = True and
    # override flush_columnar_native. The contract is negotiation by
    # return value: True = the batch was fully flushed (groups the
    # native encoders couldn't take were routed through the sink's own
    # Python formatter), False = nothing was flushed and the caller
    # must fall back to flush_columnar — so a sink can refuse a whole
    # batch when a configured feature (per-tag key routing, per-metric
    # tag excludes) isn't covered natively.
    supports_native_emit = False

    def flush_columnar_native(self, batch,
                              excluded_tags: Optional[set] = None) -> bool:
        return False

    def flush_other_samples(self, samples: list[SSFSample]) -> None:
        """Receive 'other' samples (events, service checks carried as SSF);
        sinks that can't represent them drop them."""

    def stop(self) -> None:
        """Graceful shutdown: flush buffered data, stop worker threads.
        Default no-op; sinks with background submitters override."""


class SpanSink(abc.ABC):
    """A destination for trace spans (reference sinks/sinks.go:85-103)."""

    @abc.abstractmethod
    def name(self) -> str: ...

    def start(self, trace_client=None) -> None: ...

    @abc.abstractmethod
    def ingest(self, span: SSFSpan) -> None: ...

    def flush(self) -> None: ...

    def stop(self) -> None:
        """Graceful shutdown: flush buffered data, stop worker threads.
        Default no-op; sinks with background submitters override."""


def filter_routed(metrics: Iterable[InterMetric], sink_name: str
                  ) -> list[InterMetric]:
    """Apply veneursinkonly: routing for one sink
    (reference sinks route check via RouteInformation.RouteTo)."""
    return [m for m in metrics if route_to(m.sinks, sink_name)]


def strip_excluded_tags(metrics: list[InterMetric],
                        excluded: Optional[set[str]]) -> list[InterMetric]:
    """Per-sink tag exclusion (reference setSinkExcludedTags,
    server.go:1522-1548): drops matching "key" or "key:value" tags."""
    if not excluded:
        return metrics
    out = []
    for m in metrics:
        tags = [
            t for t in m.tags
            if t.split(":", 1)[0] not in excluded
        ]
        if len(tags) != len(m.tags):
            m = InterMetric(
                name=m.name, timestamp=m.timestamp, value=m.value, tags=tags,
                type=m.type, message=m.message, hostname=m.hostname,
                sinks=m.sinks,
            )
        out.append(m)
    return out
