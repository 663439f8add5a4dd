"""OpenTracing-compatible Tracer.

Parity: reference trace/opentracing.go:1-659 — Tracer with StartSpan
options (child-of / follows-from references, explicit start time, tags),
Inject/Extract over TextMap, HTTPHeaders and Binary carriers, span-context
baggage, and the multi-format header negotiation the proxy/import HTTP
hops use for cross-hop propagation (handlers_global.go:81,125).

The opentracing-python package is not a dependency; the surface mirrors
its API shapes (format constants, method names) so instrumented code
ports directly, while spans finish into this framework's SSF model
(trace/span.py → ssf.SSFSpan).
"""

from __future__ import annotations

import io
import time
from typing import Iterable, Optional, Union

from veneur_tpu_torch.gen import ssf_pb2
from veneur_tpu_torch.trace.span import Span

# Carrier formats (opentracing.Format analogs)
TEXT_MAP = "text_map"
HTTP_HEADERS = "http_headers"
BINARY = "binary"

RESOURCE_KEY = "resource"

# Reference reserved baggage keys (spanContext.Init): the context's ids
# ride in its baggage under these names.
_TRACE_ID_KEY = "traceid"
_PARENT_ID_KEY = "parentid"
_SPAN_ID_KEY = "spanid"


class HeaderGroup:
    """One supported tracing-header naming scheme
    (reference HeaderFormats, opentracing.go:38-67)."""

    def __init__(self, trace_id: str, span_id: str, hexfmt: bool = False,
                 outgoing: Optional[dict[str, str]] = None) -> None:
        self.trace_id = trace_id
        self.span_id = span_id
        self.hexfmt = hexfmt
        self.outgoing = outgoing or {}


# Tried in order on extract; the Envoy/Lightstep scheme first since an
# Envoy sidecar is most likely the nearest parent (reference comment).
HEADER_FORMATS = [
    HeaderGroup("ot-tracer-traceid", "ot-tracer-spanid", hexfmt=True,
                outgoing={"ot-tracer-sampled": "true"}),
    HeaderGroup("Trace-Id", "Span-Id"),
    HeaderGroup("X-Trace-Id", "X-Span-Id"),
    HeaderGroup("Traceid", "Spanid"),
]

DEFAULT_HEADER_FORMAT = HEADER_FORMATS[0]


class UnsupportedFormatError(ValueError):
    pass


class SpanExtractionError(ValueError):
    pass


class SpanContext:
    """Propagation state of one span: ids + resource + baggage
    (reference spanContext, opentracing.go:126-211)."""

    def __init__(self, trace_id: int = 0, span_id: int = 0,
                 parent_id: int = 0, resource: str = "",
                 baggage: Optional[dict[str, str]] = None) -> None:
        self.baggage = dict(baggage or {})
        self.baggage.setdefault(_TRACE_ID_KEY, str(trace_id))
        self.baggage.setdefault(_SPAN_ID_KEY, str(span_id))
        self.baggage.setdefault(_PARENT_ID_KEY, str(parent_id))
        if resource:
            self.baggage.setdefault(RESOURCE_KEY, resource)

    def _int(self, key: str) -> int:
        try:
            return int(self.baggage.get(key, "0") or "0")
        except ValueError:
            return 0

    @property
    def trace_id(self) -> int:
        return self._int(_TRACE_ID_KEY)

    @property
    def span_id(self) -> int:
        return self._int(_SPAN_ID_KEY)

    @property
    def parent_id(self) -> int:
        return self._int(_PARENT_ID_KEY)

    @property
    def resource(self) -> str:
        return self.baggage.get(RESOURCE_KEY, "")

    def foreach_baggage_item(self, handler) -> None:
        for k, v in self.baggage.items():
            if not handler(k, v):
                return


class OTSpan:
    """OpenTracing-API span wrapping the SSF span model."""

    def __init__(self, tracer: "Tracer", span: Span,
                 resource: str = "") -> None:
        self._tracer = tracer
        self.span = span
        self.resource = resource or span.name
        self._baggage: dict[str, str] = {}
        self._recorded = False

    # -- opentracing.Span surface -------------------------------------------

    def context(self) -> SpanContext:
        return SpanContext(
            trace_id=self.span.trace_id, span_id=self.span.id,
            parent_id=self.span.parent_id, resource=self.resource,
            baggage=dict(self._baggage))

    def tracer(self) -> "Tracer":
        return self._tracer

    def set_operation_name(self, name: str) -> "OTSpan":
        self.span.name = name
        return self

    def set_tag(self, key: str, value) -> "OTSpan":
        # reference stringifies non-string values (opentracing.go:284-304)
        self.span.tags[key] = value if isinstance(value, str) else str(value)
        if key == "name":
            self.span.name = str(value)
        return self

    def set_baggage_item(self, key: str, value: str) -> "OTSpan":
        self._baggage[key] = value
        return self

    def baggage_item(self, key: str) -> str:
        return self._baggage.get(key, "")

    def log_kv(self, *alternating_key_values) -> None:
        """reference LogKV is an intentional no-op pending sink support
        (opentracing.go:317-322)."""

    def set_error(self) -> None:
        self.span.set_error()

    def finish(self, finish_time: Optional[float] = None,
               client=None) -> None:
        if self._recorded:
            return
        self._recorded = True
        out = self.span.finish()
        if finish_time is not None:
            out.end_timestamp = int(finish_time * 1e9)
        cl = client or self._tracer.client
        if cl is not None:
            try:
                cl.record(out)
            except Exception:
                pass

    def __enter__(self) -> "OTSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.set_error()
        self.finish()


def child_of(parent: Union[OTSpan, SpanContext, Span]) -> tuple:
    return ("child_of", parent)


def follows_from(parent: Union[OTSpan, SpanContext, Span]) -> tuple:
    """The reference treats follows-from like child-of
    (opentracing.go:424-427)."""
    return ("follows_from", parent)


def _as_context(ref) -> Optional[SpanContext]:
    if isinstance(ref, SpanContext):
        return ref
    if isinstance(ref, OTSpan):
        return ref.context()
    if isinstance(ref, Span):
        return SpanContext(trace_id=ref.trace_id, span_id=ref.id,
                           parent_id=ref.parent_id)
    return None


class Tracer:
    """reference Tracer (opentracing.go:399-647). `client` is the trace
    client spans record to on finish (None = discard)."""

    def __init__(self, client=None, service: str = "") -> None:
        self.client = client
        self.service = service

    # -- span creation ------------------------------------------------------

    def start_span(self, operation_name: str = "", *,
                   child_of=None,
                   references: Iterable[tuple] = (),
                   start_time: Optional[float] = None,
                   tags: Optional[dict] = None) -> OTSpan:
        refs = list(references)
        if child_of is not None:
            refs.insert(0, ("child_of", child_of))
        parent: Optional[SpanContext] = None
        for _kind, ref in refs:
            ctx = _as_context(ref)
            if ctx is not None:
                parent = ctx
                break
        if parent is None:
            span = Span(operation_name, service=self.service)
            resource = operation_name
        else:
            span = Span(operation_name, service=self.service,
                        trace_id=parent.trace_id or None,
                        parent_id=parent.span_id or None)
            resource = parent.resource or operation_name
        if start_time is not None:
            span.start_ns = int(start_time * 1e9)
        ot = OTSpan(self, span, resource=resource)
        for k, v in (tags or {}).items():
            ot.set_tag(k, v)
        return ot

    # -- inject -------------------------------------------------------------

    def inject(self, span_context: SpanContext, fmt: str, carrier) -> None:
        if not isinstance(span_context, SpanContext):
            raise UnsupportedFormatError("unsupported SpanContext")
        if fmt == BINARY:
            # SSFSpan proto bytes (reference trace.ProtoMarshalTo)
            pb = ssf_pb2.SSFSpan()
            pb.trace_id = span_context.trace_id
            pb.id = span_context.span_id
            pb.parent_id = span_context.parent_id
            if span_context.resource:
                pb.tags[RESOURCE_KEY] = span_context.resource
            carrier.write(pb.SerializeToString())
            return
        if fmt == HTTP_HEADERS:
            base_hex = DEFAULT_HEADER_FORMAT.hexfmt
            sid = span_context.span_id
            tid = span_context.trace_id
            carrier[DEFAULT_HEADER_FORMAT.span_id] = (
                format(sid, "x") if base_hex else str(sid))
            carrier[DEFAULT_HEADER_FORMAT.trace_id] = (
                format(tid, "x") if base_hex else str(tid))
            for k, v in DEFAULT_HEADER_FORMAT.outgoing.items():
                carrier[k] = v
            return
        if fmt == TEXT_MAP or hasattr(carrier, "__setitem__"):
            # text maps carry the whole baggage (ids included)
            for k, v in span_context.baggage.items():
                carrier[k] = v
            return
        raise UnsupportedFormatError(fmt)

    # -- extract ------------------------------------------------------------

    def extract(self, fmt: str, carrier) -> SpanContext:
        if fmt == BINARY:
            data = carrier.read() if hasattr(carrier, "read") else bytes(
                carrier)
            pb = ssf_pb2.SSFSpan()
            pb.ParseFromString(data)
            return SpanContext(trace_id=pb.trace_id, span_id=pb.id,
                               resource=pb.tags.get(RESOURCE_KEY, ""))
        if hasattr(carrier, "items"):
            lowered = {str(k).lower(): str(v) for k, v in carrier.items()}
            trace_id = span_id = 0
            for group in HEADER_FORMATS:
                base = 16 if group.hexfmt else 10
                try:
                    trace_id = int(
                        lowered.get(group.trace_id.lower(), "") or "0", base)
                    span_id = int(
                        lowered.get(group.span_id.lower(), "") or "0", base)
                except ValueError:
                    trace_id = span_id = 0
                if trace_id and span_id:
                    break
            if not trace_id and not span_id:
                raise SpanExtractionError(
                    "no tracing headers found in carrier")
            # the reference restores only ids+resource; text maps here
            # also restore baggage (a compatible superset)
            baggage = lowered if fmt == TEXT_MAP else None
            return SpanContext(trace_id=trace_id, span_id=span_id,
                               resource=lowered.get(RESOURCE_KEY, ""),
                               baggage=baggage)
        raise UnsupportedFormatError(fmt)

    # -- HTTP convenience (the cross-hop propagation surface) ---------------

    def inject_header(self, span_context: SpanContext, headers) -> None:
        """reference InjectHeader (opentracing.go:492-497)."""
        self.inject(span_context, HTTP_HEADERS, headers)

    def extract_request_child(self, resource: str, headers,
                              name: str) -> OTSpan:
        """Continue a trace from incoming HTTP headers
        (reference ExtractRequestChild, opentracing.go:499-523; used by
        the proxy/import handlers, handlers_global.go:81,125)."""
        parent = self.extract(HTTP_HEADERS, headers)
        ot = self.start_span(name, child_of=parent)
        ot.resource = resource
        ot.set_tag(RESOURCE_KEY, resource)
        return ot


GLOBAL_TRACER = Tracer()


def start_span_from_headers(headers, name: str, resource: str = "",
                            tracer: Optional[Tracer] = None
                            ) -> Optional[OTSpan]:
    """Best-effort child-span start for server hops: returns None when the
    request carries no recognizable tracing headers."""
    t = tracer or GLOBAL_TRACER
    try:
        return t.extract_request_child(resource or name, headers, name)
    except (SpanExtractionError, UnsupportedFormatError):
        return None


class traced_server_hop:
    """Context manager for an HTTP handler continuing an incoming trace:
    starts a child span from the request headers (None when untraced),
    marks it errored on exception, finishes it either way. Shared by the
    import and proxy /import handlers (reference ExtractRequestChild
    call sites, handlers_global.go:28-58,60-72)."""

    def __init__(self, headers, name: str, resource: str = "",
                 tracer: Optional[Tracer] = None) -> None:
        self.span = start_span_from_headers(headers, name,
                                            resource=resource, tracer=tracer)

    def __enter__(self) -> Optional[OTSpan]:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.span is not None:
            if exc_type is not None:
                self.span.set_error()
            self.span.finish()
