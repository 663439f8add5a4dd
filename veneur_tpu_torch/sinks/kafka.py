"""Kafka sinks: metrics and spans to Kafka topics.

Parity: reference sinks/kafka/kafka.go — sarama async producer with
configurable topics, acks, retries, partitioner, and span serialization
(protobuf or json), plus percentage-based span sampling on trace id.

The producer is injectable; the default is the from-scratch wire
producer (kafka_wire.KafkaWireProducer) speaking the real broker
protocol — Metadata v0 + Produce v1 with CRC'd magic-1 message sets —
so the sink emits bytes an actual broker accepts. Tests (and embedders)
may supply their own producer with a ``send(topic, key, value)`` method.
"""

from __future__ import annotations

import json
import logging
import threading
import zlib
from typing import Optional, Protocol

from veneur_tpu_torch.core.metrics import InterMetric
from veneur_tpu_torch.protocol import ssf_wire
from veneur_tpu_torch.sinks import MetricSink, SpanSink
from veneur_tpu_torch.ssf import SSFSpan

log = logging.getLogger("veneur_tpu_torch.sinks.kafka")


class Producer(Protocol):
    def send(self, topic: str, key: bytes, value: bytes) -> None: ...

    def flush(self) -> None: ...


def default_producer(broker: str, retry_max: int = 3,
                     require_acks: str = "all",
                     buffer_bytes: int = 0,
                     buffer_ms: float = 0.0,
                     buffer_messages: int = 0,
                     partitioner: str = "hash") -> Producer:
    """Producer with the reference's per-sink tuning surface
    (sinks/kafka/kafka.go newProducerConfig :109-141): ack requirement,
    hash/random partitioner, retry max, and flush thresholds by bytes,
    time, and message count — served by the from-scratch wire producer
    (kafka_wire.py), which speaks the actual broker protocol."""
    from veneur_tpu_torch.sinks.kafka_wire import KafkaWireProducer

    return KafkaWireProducer(
        broker,
        require_acks=require_acks,
        retry_max=retry_max,
        partitioner=partitioner,
        buffer_bytes=buffer_bytes,
        buffer_messages=buffer_messages,
        buffer_ms=buffer_ms,
    )


class KafkaMetricSink(MetricSink):
    def __init__(self, producer: Producer, check_topic: str = "",
                 event_topic: str = "", metric_topic: str = "") -> None:
        self.producer = producer
        self.check_topic = check_topic
        self.event_topic = event_topic
        self.metric_topic = metric_topic
        self.flushed_metrics = 0
        self.flush_errors = 0

    def name(self) -> str:
        return "kafka"

    def flush(self, metrics: list[InterMetric]) -> None:
        if not self.metric_topic:
            return
        for m in metrics:
            payload = {
                "name": m.name,
                "timestamp": m.timestamp,
                "value": m.value,
                "tags": m.tags,
                "type": m.type.name.lower(),
            }
            try:
                self.producer.send(
                    self.metric_topic,
                    key=m.name.encode("utf-8"),
                    value=json.dumps(payload).encode("utf-8"),
                )
                self.flushed_metrics += 1
            except Exception as e:
                self.flush_errors += 1
                log.warning("kafka metric produce failed: %s", e)
        try:
            self.producer.flush()
        except Exception:
            pass


class KafkaSpanSink(SpanSink):
    def __init__(self, producer: Producer, span_topic: str,
                 serialization: str = "protobuf",
                 sample_rate_percent: float = 100.0,
                 sample_tag: str = "") -> None:
        self.producer = producer
        self.span_topic = span_topic
        self.serialization = serialization
        self.sample_rate_percent = sample_rate_percent
        self.sample_tag = sample_tag
        self.spans_flushed = 0
        self.spans_dropped = 0
        # ingest runs concurrently under num_span_workers > 1
        self._stats_lock = threading.Lock()

    def name(self) -> str:
        return "kafka"

    def ingest(self, span: SSFSpan) -> None:
        if self.sample_rate_percent < 100.0:
            # hash the sampling unit (a tag value, or the trace id) with a
            # process-independent hash: the keep/drop decision for a unit
            # must agree across instances and restarts (the reference
            # fnv-hashes the tag value, sinks/kafka/kafka.go)
            unit = (span.tags.get(self.sample_tag, "")
                    if self.sample_tag else str(span.trace_id))
            if (zlib.crc32(unit.encode()) % 10000) >= (
                    self.sample_rate_percent * 100):
                with self._stats_lock:
                    self.spans_dropped += 1
                return
        if self.serialization == "json":
            value = json.dumps({
                "trace_id": span.trace_id, "id": span.id,
                "parent_id": span.parent_id, "service": span.service,
                "name": span.name, "error": span.error,
                "start_timestamp": span.start_timestamp,
                "end_timestamp": span.end_timestamp,
                "tags": dict(span.tags),
            }).encode("utf-8")
        else:
            value = ssf_wire.encode_datagram(span)
        try:
            self.producer.send(self.span_topic,
                               key=str(span.trace_id).encode("ascii"),
                               value=value)
            with self._stats_lock:
                self.spans_flushed += 1
        except Exception as e:
            with self._stats_lock:
                self.spans_dropped += 1
            log.warning("kafka span produce failed: %s", e)

    def flush(self) -> None:
        try:
            self.producer.flush()
        except Exception:
            pass
