"""MetricArchiveSink: the local segmented VMB1 archive.

One frame per flush interval, appended to a rotated, size-and-count-
bounded segment log (the span log's SegmentedLogWriter discipline, under
``metrics-*.vmb``) through the DeliveryManager — so archival gets the
same retry / breaker / bounded-spill / exact-conservation contract
every network sink has, and a full disk degrades to honest drop
counters instead of a wedged flush.

The sink is native-emit capable: ``flush_columnar_native`` serializes
each plan-capable ColumnGroup GIL-free (native/emit.cpp
vn_encode_archive_section), while routed groups, extras, and excluded
tags take the byte-compatible Python path inside the same frame.
``read_archive`` yields the frames back in write order, torn-tail
tolerant — the replay corpus surface (archive/replay.py).
"""

from __future__ import annotations

import logging
import threading

from veneur_tpu_torch.archive.wire import encode_flush, encode_metrics
from veneur_tpu_torch.sinks import MetricSink
from veneur_tpu_torch.sinks.delivery import make_manager
from veneur_tpu_torch.spans.sink import SegmentedLogWriter, read_segmented_log

log = logging.getLogger("veneur_tpu_torch.archive.sink")

ARCHIVE_PREFIX = "metrics-"
ARCHIVE_SUFFIX = ".vmb"


class SegmentedArchiveWriter(SegmentedLogWriter):
    """The span log's rotation/bounding/torn-tail discipline, applied to
    VMB1 flush frames (``metrics-%08d.vmb`` segments)."""

    def __init__(self, directory: str, max_segment_bytes: int = 64 << 20,
                 max_segments: int = 8) -> None:
        super().__init__(directory, max_segment_bytes, max_segments,
                         prefix=ARCHIVE_PREFIX, suffix=ARCHIVE_SUFFIX)


def read_archive(directory: str) -> list[bytes]:
    """Every VMB1 frame across the archive's segments in write order;
    stops at a torn tail instead of raising (decode_flush then rejects
    any frame whose own CRC fails — two independent checksum layers)."""
    return read_segmented_log(directory, prefix=ARCHIVE_PREFIX,
                              suffix=ARCHIVE_SUFFIX)


class MetricArchiveSink(MetricSink):
    """Flush archival as a first-class metric sink.

    Counter contract (the conservation the A/B artifact pins):
    ``metrics_flushed + metrics_dropped + metrics_deferred`` equals
    every sample accepted into a frame, and the delivery manager's own
    payload ledger (``accepted == delivered + dropped + spilled``) holds
    exactly underneath it."""

    supports_columnar = True
    supports_native_emit = True

    def __init__(self, writer, hostname: str = "", delivery=None,
                 name: str = "archive") -> None:
        self._name = name
        self.writer = writer
        self.hostname = hostname
        self.delivery = make_manager(name, delivery)
        self._stats_lock = threading.Lock()
        self.metrics_flushed = 0
        self.metrics_dropped = 0
        self.metrics_deferred = 0
        self.frames_encoded = 0
        self.bytes_encoded = 0

    def name(self) -> str:
        return self._name

    def start(self, trace_client=None) -> None:
        pass

    # -- flush surfaces (all three negotiate down to one frame) --------

    def flush_columnar_native(self, batch, excluded_tags=None) -> bool:
        frame, count = encode_flush(
            batch, self.hostname, sink_name=self._name,
            excluded_tags=excluded_tags, use_native=True)
        self._flush_frame(frame, count)
        return True

    def flush_columnar(self, batch, excluded_tags=None) -> None:
        frame, count = encode_flush(
            batch, self.hostname, sink_name=self._name,
            excluded_tags=excluded_tags, use_native=False)
        self._flush_frame(frame, count)

    def flush(self, metrics) -> None:
        metrics = list(metrics)
        frame, count = encode_metrics(metrics, hostname=self.hostname)
        self._flush_frame(frame, count)

    # -- delivery ------------------------------------------------------

    def _flush_frame(self, frame: bytes, count: int) -> None:
        man = self.delivery
        man.begin_flush()
        man.retry_spill()
        if count == 0:
            return  # nothing flushed this interval; spill still drained
        with self._stats_lock:
            self.frames_encoded += 1
            self.bytes_encoded += len(frame)
        writer = self.writer

        def send(timeout_s: float, _p=frame) -> None:
            writer.write(_p, timeout_s)

        status = man.deliver(send, len(frame), payload=frame)
        with self._stats_lock:
            if status == "delivered":
                self.metrics_flushed += count
            elif status == "dropped":
                self.metrics_dropped += count
            else:
                # parked in the bounded spill; payload-level
                # conservation is the manager's ledger from here on
                self.metrics_deferred += count

    def stop(self) -> None:
        close = getattr(self.writer, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001
                log.exception("archive writer close failed")
