"""Debug sinks: log every flushed metric / ingested span.

Parity: reference sinks/debug/debug.go (enabled by debug_flushed_metrics /
debug_ingested_spans).
"""

from __future__ import annotations

import logging

from veneur_tpu_torch.sinks import MetricSink, SpanSink

log = logging.getLogger("veneur_tpu_torch.sinks.debug")


class DebugMetricSink(MetricSink):
    def name(self) -> str:
        return "debug"

    def flush(self, metrics) -> None:
        for m in metrics:
            log.info(
                "Flushed metric name=%s time=%s value=%s tags=%s type=%s",
                m.name, m.timestamp, m.value, m.tags, m.type.name,
            )

    def flush_other_samples(self, samples) -> None:
        for s in samples:
            log.info("Flushed other sample name=%s tags=%s", s.name, s.tags)


class DebugSpanSink(SpanSink):
    def name(self) -> str:
        return "debug"

    def ingest(self, span) -> None:
        log.info(
            "Ingested span service=%s name=%s trace_id=%s id=%s",
            span.service, span.name, span.trace_id, span.id,
        )

    def flush(self) -> None:
        pass
