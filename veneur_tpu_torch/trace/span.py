"""Span model and in-process tracer.

Parity: reference trace/trace.go:52-95 (Trace/Span model: ids, parent
lineage, error flag, attached samples) with the inject/extract HTTP-header
propagation of trace/opentracing.go (TraceID/SpanID/ParentID headers).
"""

from __future__ import annotations

import random
import time
from typing import Optional

from veneur_tpu_torch import ssf

# HTTP propagation headers (the reference's opentracing text-map carrier
# uses these names for cross-hop propagation, handlers_global.go:81)
HEADER_TRACE_ID = "Trace-Id"
HEADER_SPAN_ID = "Span-Id"
HEADER_PARENT_ID = "Parent-Span-Id"


def _new_id() -> int:
    return random.getrandbits(62) + 1


class Span:
    """One timed operation; finishes into an SSFSpan."""

    def __init__(self, name: str, service: str = "",
                 trace_id: Optional[int] = None,
                 parent_id: Optional[int] = None,
                 indicator: bool = False,
                 tags: Optional[dict[str, str]] = None) -> None:
        self.id = _new_id()
        self.trace_id = trace_id or self.id
        self.parent_id = parent_id or 0
        self.name = name
        self.service = service
        self.indicator = indicator
        self.tags = dict(tags or {})
        self.error = False
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.samples: list[ssf.SSFSample] = []

    def child(self, name: str, **kw) -> "Span":
        return Span(
            name, service=self.service, trace_id=self.trace_id,
            parent_id=self.id, **kw,
        )

    def add(self, *samples: ssf.SSFSample) -> None:
        self.samples.extend(samples)

    def set_error(self) -> None:
        self.error = True

    def finish(self) -> ssf.SSFSpan:
        self.end_ns = time.time_ns()
        return ssf.SSFSpan(
            trace_id=self.trace_id,
            id=self.id,
            parent_id=self.parent_id,
            start_timestamp=self.start_ns,
            end_timestamp=self.end_ns,
            error=self.error,
            service=self.service,
            tags=dict(self.tags),
            indicator=self.indicator,
            name=self.name,
            metrics=list(self.samples),
        )

    def client_finish(self, client=None) -> ssf.SSFSpan:
        """Finish and best-effort record to a trace client
        (reference Span.ClientFinish)."""
        span = self.finish()
        if client is not None:
            try:
                client.record(span)
            except Exception:
                pass
        return span

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.error = True
        self.finish()

    # -- propagation --------------------------------------------------------

    def inject_headers(self, headers: dict[str, str]) -> None:
        headers[HEADER_TRACE_ID] = str(self.trace_id)
        headers[HEADER_SPAN_ID] = str(self.id)
        if self.parent_id:
            headers[HEADER_PARENT_ID] = str(self.parent_id)


def start_span(name: str, service: str = "", **kw) -> Span:
    return Span(name, service=service, **kw)


def extract_request_child(headers: dict[str, str], name: str,
                          service: str = "") -> Span:
    """Create a child span continuing a trace from HTTP headers
    (reference ExtractRequestChild, handlers_global.go:81)."""
    trace_id = int(headers.get(HEADER_TRACE_ID, 0) or 0)
    parent_id = int(headers.get(HEADER_SPAN_ID, 0) or 0)
    span = Span(name, service=service)
    if trace_id:
        span.trace_id = trace_id
        span.parent_id = parent_id
    return span
