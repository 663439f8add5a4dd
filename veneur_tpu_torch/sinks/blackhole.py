"""Blackhole sink: accepts and discards everything.

Parity: reference sinks/blackhole/blackhole.go (test/bench sink).
"""

from __future__ import annotations

from veneur_tpu_torch.sinks import MetricSink, SpanSink


class BlackholeMetricSink(MetricSink):
    supports_columnar = True

    def name(self) -> str:
        return "blackhole"

    def flush(self, metrics) -> None:
        pass

    def flush_columnar(self, batch, excluded_tags=None) -> None:
        pass

    def flush_other_samples(self, samples) -> None:
        pass


class BlackholeSpanSink(SpanSink):
    def name(self) -> str:
        return "blackhole"

    def ingest(self, span) -> None:
        pass

    def flush(self) -> None:
        pass
