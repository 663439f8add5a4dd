"""Lightstep span sink speaking the real collector report protocol.

Parity: reference sinks/lightstep/lightstep.go — spans forwarded to a
Lightstep collector through a pool of N clients, one trace always on one
client. The reference carries its reports through the vendored tracer's
collector protocol (vendor/.../collectorpb/collector.pb.go:
ReportRequest{reporter, auth, spans}); this sink builds the same
wire-compatible ReportRequest (proto/compat/lightstep_collector.proto)
and POSTs it, binary-proto over HTTP, to the collector's public report
endpoint ``/api/v2/reports`` with the access token both in the payload
Auth block and the ``Lightstep-Access-Token`` header. Reports are
chunked at ``max_spans_per_report`` spans.

The transport remains injectable for tests: any callable
``(client_index, [collector Span])``.
"""

from __future__ import annotations

import logging
import random
import threading
import urllib.request
from typing import Callable, Optional

from veneur_tpu_torch.gen import lightstep_collector_pb2 as lspb
from veneur_tpu_torch.sinks import SpanSink
from veneur_tpu_torch.ssf import SSFSpan
from veneur_tpu_torch.utils.http import default_opener

log = logging.getLogger("veneur_tpu_torch.sinks.lightstep")


def span_to_collector(span: SSFSpan) -> "lspb.Span":
    """SSF span -> Lightstep collector Span (the tracer's RawSpan
    translation: guids from ids, CHILD_OF reference, component tag)."""
    out = lspb.Span()
    out.span_context.trace_id = span.trace_id
    out.span_context.span_id = span.id
    out.operation_name = span.name
    if span.parent_id:
        ref = out.references.add()
        ref.relationship = lspb.Reference.CHILD_OF
        ref.span_context.trace_id = span.trace_id
        ref.span_context.span_id = span.parent_id
    start_ns = span.start_timestamp
    out.start_timestamp.seconds = start_ns // 1_000_000_000
    out.start_timestamp.nanos = start_ns % 1_000_000_000
    out.duration_micros = max(
        0, (span.end_timestamp - span.start_timestamp) // 1000)
    for k, v in span.tags.items():
        tag = out.tags.add()
        tag.key = k
        tag.string_value = v
    comp = out.tags.add()
    comp.key = "component"
    comp.string_value = span.service
    if span.error:
        err = out.tags.add()
        err.key = "error"
        err.bool_value = True
    return out


class LightStepSpanSink(SpanSink):
    def __init__(self, access_token: str,
                 collector_host: str = "https://collector.lightstep.com",
                 num_clients: int = 1,
                 maximum_spans: int = 100000,
                 reconnect_period_s: float = 0.0,
                 max_spans_per_report: int = 1000,
                 transport: Optional[Callable[[int, list], None]] = None,
                 opener=default_opener) -> None:
        self.access_token = access_token
        self.collector_host = collector_host.rstrip("/")
        self.num_clients = max(1, num_clients)
        self.maximum_spans = maximum_spans
        self.max_spans_per_report = max(1, max_spans_per_report)
        # reference lightstep.go sets ReconnectPeriod on its persistent
        # collector connections; this HTTP transport dials per report, so
        # every report already reconnects — the knob is an accepted upper
        # bound rather than a behavior change
        self.reconnect_period_s = reconnect_period_s
        self.opener = opener
        self.transport = transport or self._http_report
        # one reporter id per client, like the tracer's per-client guid
        self._reporter_ids = [
            random.getrandbits(63) | 1 for _ in range(self.num_clients)]
        # per-client span buffers; ingest may run from several span
        # workers concurrently (num_span_workers). One lock per client:
        # spans hash to disjoint buffers, so cross-client ingest never
        # contends
        self._buffers: list[list] = [[] for _ in range(self.num_clients)]
        self._locks = [threading.Lock() for _ in range(self.num_clients)]
        self._drop_lock = threading.Lock()
        self.spans_flushed = 0
        self.spans_dropped = 0
        self.flush_errors = 0

    def name(self) -> str:
        return "lightstep"

    def ingest(self, span: SSFSpan) -> None:
        # one trace → one client (reference round-robins on trace id)
        client = span.trace_id % self.num_clients
        with self._locks[client]:
            buf = self._buffers[client]
            if len(buf) >= self.maximum_spans // self.num_clients:
                with self._drop_lock:
                    self.spans_dropped += 1
                return
            buf.append(span_to_collector(span))

    def flush(self) -> None:
        for client in range(self.num_clients):
            with self._locks[client]:
                buf = self._buffers[client]
                if not buf:
                    continue
                self._buffers[client] = []
            # chunked reports, like the tracer's max-buffered-spans cap
            for i in range(0, len(buf), self.max_spans_per_report):
                chunk = buf[i:i + self.max_spans_per_report]
                try:
                    self.transport(client, chunk)
                    self.spans_flushed += len(chunk)
                except Exception as e:
                    self.flush_errors += 1
                    log.warning("lightstep report failed: %s", e)

    def build_report(self, client: int, spans: list) -> bytes:
        """Serialized collector ReportRequest for one chunk."""
        req = lspb.ReportRequest()
        req.reporter.reporter_id = self._reporter_ids[client]
        tag = req.reporter.tags.add()
        tag.key = "lightstep.component_name"
        tag.string_value = "veneur-tpu"
        req.auth.access_token = self.access_token
        req.spans.extend(spans)
        return req.SerializeToString()

    def _http_report(self, client: int, spans: list) -> None:
        body = self.build_report(client, spans)
        req = urllib.request.Request(
            f"{self.collector_host}/api/v2/reports",
            data=body,
            method="POST",
            headers={
                "Content-Type": "application/octet-stream",
                "Lightstep-Access-Token": self.access_token,
            },
        )
        self.opener(req, 10.0)  # raises HTTPError on >=400
