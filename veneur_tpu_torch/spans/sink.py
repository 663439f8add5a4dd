"""SpanBatchSink: columnar span egress through the DeliveryManager.

The reference's kafka span sink (and this repo's port of it,
sinks/kafka.py) is drop-only: a failed produce is a silent counter. This
sink replaces that lane for batch egress — each sealed columnar batch
serializes once (spans/wire.py VSB1 frames) and ships through the
sinks' ``DeliveryManager``: retry with jittered backoff, circuit breaker,
bounded spill retried ahead of fresh data next interval, optional
write-ahead journal — so span egress gets the same
accepted == delivered + dropped + spilled conservation contract metric
sinks have.

The wire itself is pluggable:

* ``KafkaBatchWriter``   — one Kafka message per batch over the
  from-scratch wire producer (sinks/kafka_wire.py), surfacing the
  producer's internal drop counter as a raising failure so the
  DeliveryManager owns the loss accounting.
* ``SegmentedLogWriter`` — a local segmented append-only log (size-
  bounded, rotated) for brokerless deployments and replay tooling.
* ``DiscardWriter``      — serialize-only (the loadgen harness: full
  encode cost, zero network variance).

On the columnar path the server's span pipeline hands sealed batches to
``ingest_batch``; with columnar derivation disabled
(VENEUR_SPAN_COLUMNAR=0) the sink still works — the per-span ``ingest``
fallback columnarizes locally through the same SpanColumnizer.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import zlib

from veneur_tpu_torch.sinks.delivery import make_manager
from veneur_tpu_torch.spans.batch import SealedBatch, SpanColumnizer, StringArena
from veneur_tpu_torch.spans.derive import TemplateStore
from veneur_tpu_torch.spans.wire import encode_batch

log = logging.getLogger("veneur_tpu_torch.spans.sink")


class _TransientWriteError(RuntimeError):
    """A write failure worth retrying (delivery.retryable honors the
    transient attribute)."""

    transient = True


class DiscardWriter:
    """Serialize-only writer: accepts every frame, writes nowhere."""

    def write(self, payload: bytes, timeout_s: float) -> None:
        pass


class KafkaBatchWriter:
    """One Kafka message per VSB1 frame through KafkaWireProducer.

    The producer buffers internally and folds failures into its own
    dropped counter; this wrapper flushes synchronously per write and
    raises when the drop counter moved, so the DeliveryManager — not the
    producer — owns retry/spill/loss accounting."""

    def __init__(self, producer, topic: str) -> None:
        self.producer = producer
        self.topic = topic
        self._lock = threading.Lock()

    def write(self, payload: bytes, timeout_s: float) -> None:
        with self._lock:
            before = self.producer.dropped
            self.producer.send(self.topic, None, payload)
            self.producer.flush()
            lost = self.producer.dropped - before
        if lost:
            raise _TransientWriteError(
                f"kafka producer dropped {lost} batch message(s)")

    def close(self) -> None:
        self.producer.close()


class SegmentedLogWriter:
    """Append-only local span-batch log, journal-style framed records
    (u32 length + u32 CRC + frame), size-rotated and segment-bounded:
    oldest segment unlinked first, never unbounded disk.

    ``prefix``/``suffix`` name the segment files — the metric archive
    (veneur_tpu/archive/sink.py) reuses this exact discipline for VMB1
    frames under ``metrics-*.vmb``."""

    def __init__(self, directory: str, max_segment_bytes: int = 16 << 20,
                 max_segments: int = 8, prefix: str = "spans-",
                 suffix: str = ".vsb") -> None:
        self.directory = directory
        self.max_segment_bytes = max(1, int(max_segment_bytes))
        self.max_segments = max(1, int(max_segments))
        self.prefix = prefix
        self.suffix = suffix
        self._lock = threading.Lock()
        self._fh = None
        self._seq = 0
        self._written = 0
        os.makedirs(directory, exist_ok=True)
        for name in sorted(os.listdir(directory)):
            if name.startswith(prefix) and name.endswith(suffix):
                try:
                    self._seq = max(
                        self._seq,
                        int(name[len(prefix):-len(suffix)]) + 1)
                except ValueError:
                    continue

    def _segments(self) -> list[str]:
        return sorted(
            n for n in os.listdir(self.directory)
            if n.startswith(self.prefix) and n.endswith(self.suffix))

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        path = os.path.join(
            self.directory, f"{self.prefix}{self._seq:08d}{self.suffix}")
        self._seq += 1
        self._fh = open(path, "ab")
        self._written = 0
        segs = self._segments()
        while len(segs) > self.max_segments:
            os.unlink(os.path.join(self.directory, segs.pop(0)))

    def write(self, payload: bytes, timeout_s: float) -> None:
        record = struct.pack("<II", len(payload),
                             zlib.crc32(payload)) + payload
        with self._lock:
            if self._fh is None or self._written >= self.max_segment_bytes:
                self._rotate_locked()
            self._fh.write(record)
            self._fh.flush()
            self._written += len(record)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_segmented_log(directory: str, prefix: str = "spans-",
                       suffix: str = ".vsb") -> list[bytes]:
    """Yield every frame across the log's segments in write order
    (replay tooling + tests); stops at a torn tail instead of raising."""
    frames: list[bytes] = []
    for name in sorted(os.listdir(directory)):
        if not (name.startswith(prefix) and name.endswith(suffix)):
            continue
        with open(os.path.join(directory, name), "rb") as fh:
            data = fh.read()
        off = 0
        while off + 8 <= len(data):
            size, crc = struct.unpack_from("<II", data, off)
            if off + 8 + size > len(data):
                break  # torn tail
            frame = data[off + 8:off + 8 + size]
            if zlib.crc32(frame) != crc:
                break
            frames.append(frame)
            off += 8 + size
    return frames


class SpanBatchSink:
    """Batch-capable span sink (SpanSink surface + ``ingest_batch``)."""

    # bound on sealed batches parked between flushes (each ≤ batch_rows
    # spans); beyond it new batches shed with honest spans_dropped
    MAX_PENDING_BATCHES = 256

    def __init__(self, writer, name: str = "span_batch",
                 delivery=None, batch_rows: int = 512,
                 pending_cap: int = 1 << 20) -> None:
        self._name = name
        self.writer = writer
        self.delivery = make_manager(name + "_spans", delivery)
        self._pending: list[SealedBatch] = []
        self._pending_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.spans_flushed = 0
        self.spans_dropped = 0
        self.spans_deferred = 0
        self.batches_encoded = 0
        # per-span fallback path (columnar derivation disabled): local
        # columnizer with the same intern/template discipline
        arena = StringArena()
        self._columnizer = SpanColumnizer(
            arena, TemplateStore(arena), batch_rows=batch_rows,
            pending_cap=pending_cap)

    def name(self) -> str:
        return self._name

    def start(self, trace_client=None) -> None:
        pass

    # -- ingest (both granularities) -----------------------------------

    def ingest(self, span) -> None:
        """Per-span fallback: columnarize locally; sealed batches are
        adopted at flush."""
        if not self._columnizer.append(span):
            with self._stats_lock:
                self.spans_dropped += 1

    def ingest_batch(self, sealed: SealedBatch) -> None:
        """Columnar path: adopt a sealed batch for the next flush."""
        with self._pending_lock:
            if len(self._pending) >= self.MAX_PENDING_BATCHES:
                with self._stats_lock:
                    self.spans_dropped += sealed.batch.rows
                return
            self._pending.append(sealed)

    # -- flush ---------------------------------------------------------

    def flush(self) -> None:
        for sb in self._columnizer.take_sealed():
            self.ingest_batch(sb)
        with self._pending_lock:
            pending, self._pending = self._pending, []
        if not pending and not len(self.delivery.spill):
            return
        self.delivery.begin_flush()
        self.delivery.retry_spill()
        writer = self.writer
        for sb in pending:
            payload = encode_batch(sb)
            rows = sb.batch.rows
            with self._stats_lock:
                self.batches_encoded += 1

            def send(timeout_s: float, _p=payload) -> None:
                writer.write(_p, timeout_s)

            status = self.delivery.deliver(send, len(payload),
                                           payload=payload)
            with self._stats_lock:
                if status == "delivered":
                    self.spans_flushed += rows
                elif status == "dropped":
                    self.spans_dropped += rows
                else:
                    # parked in the spill; payload-level conservation
                    # (accepted == delivered + dropped + spilled) is the
                    # manager's ledger from here on
                    self.spans_deferred += rows
        wflush = getattr(writer, "flush", None)
        if wflush is not None:
            try:
                wflush()
            except Exception:  # noqa: BLE001 - telemetry-only path
                log.exception("span batch writer flush failed")

    def stop(self) -> None:
        close = getattr(self.writer, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001
                log.exception("span batch writer close failed")
