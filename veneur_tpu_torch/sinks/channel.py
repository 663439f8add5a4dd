"""Channel sink: delivers every flush to a queue, for tests.

Parity: the reference's channelMetricSink test fixture
(server_test.go:171-201) — flush assertions read from the queue.
"""

from __future__ import annotations

import queue

from veneur_tpu_torch.sinks import MetricSink, SpanSink


class ChannelMetricSink(MetricSink):
    def __init__(self) -> None:
        self.queue: "queue.Queue[list]" = queue.Queue()
        self.other_samples: "queue.Queue[list]" = queue.Queue()

    def name(self) -> str:
        return "channel"

    def flush(self, metrics) -> None:
        self.queue.put(list(metrics))

    def flush_other_samples(self, samples) -> None:
        if samples:
            self.other_samples.put(list(samples))


class ChannelSpanSink(SpanSink):
    def __init__(self) -> None:
        self.spans: list = []

    def name(self) -> str:
        return "channel"

    def ingest(self, span) -> None:
        self.spans.append(span)

    def flush(self) -> None:
        pass
