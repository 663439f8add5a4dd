"""AWS X-Ray span sink: UDP segments to the X-Ray daemon.

Parity: reference sinks/xray/xray.go — spans become X-Ray segment JSON
datagrams prefixed with the daemon header, sampled by a percentage on the
trace id, with configured annotation tags lifted into annotations.
"""

from __future__ import annotations

import json
import logging
import socket

from veneur_tpu_torch.sinks import SpanSink
from veneur_tpu_torch.ssf import SSFSpan

log = logging.getLogger("veneur_tpu_torch.sinks.xray")

_HEADER = b'{"format": "json", "version": 1}\n'


def _trace_id_for(span: SSFSpan) -> str:
    """X-Ray trace id format: 1-<8 hex epoch seconds>-<24 hex>."""
    epoch = span.start_timestamp // 1_000_000_000
    return f"1-{epoch:08x}-{span.trace_id & ((1 << 96) - 1):024x}"


class XRaySpanSink(SpanSink):
    def __init__(self, daemon_address: str = "127.0.0.1:2000",
                 sample_percentage: float = 100.0,
                 annotation_tags: list[str] | None = None) -> None:
        host, _, port = daemon_address.rpartition(":")
        self.address = (host or "127.0.0.1", int(port))
        self.sample_percentage = max(0.0, min(100.0, sample_percentage))
        self.annotation_tags = set(annotation_tags or [])
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.spans_flushed = 0
        self.spans_dropped = 0

    def name(self) -> str:
        return "xray"

    def ingest(self, span: SSFSpan) -> None:
        if self.sample_percentage < 100.0:
            if (span.trace_id % 10000) >= self.sample_percentage * 100:
                self.spans_dropped += 1
                return
        annotations = {
            k: v for k, v in span.tags.items() if k in self.annotation_tags
        }
        segment = {
            "name": (span.service or "unknown")[:200],
            "id": f"{span.id & ((1 << 64) - 1):016x}",
            "trace_id": _trace_id_for(span),
            "start_time": span.start_timestamp / 1e9,
            "end_time": span.end_timestamp / 1e9,
            "error": span.error,
            "annotations": annotations,
            "metadata": {"tags": dict(span.tags), "name": span.name},
        }
        if span.parent_id:
            segment["parent_id"] = f"{span.parent_id & ((1 << 64) - 1):016x}"
            segment["type"] = "subsegment"
        try:
            self.sock.sendto(
                _HEADER + json.dumps(segment).encode("utf-8"), self.address)
            self.spans_flushed += 1
        except OSError as e:
            self.spans_dropped += 1
            log.debug("xray send failed: %s", e)

    def flush(self) -> None:
        pass
