"""SSF wire protocol: framed streams and datagram parsing.

Protocol spec (public; the reference implements it in protocol/wire.go):

    [ 8 bits  - version/type, must be 0 (protobuf ssf.SSFSpan follows) ]
    [ 32 bits - big-endian length of the SSF message in octets        ]
    [ <length> bytes - protobuf-encoded SSFSpan                        ]

Lengths above MAX_SSF_PACKET_LENGTH (16MB) are rejected. The protocol has
no resync hints: any framing error is fatal for the stream
(reference protocol/wire.go:29-53,108-212). UDP datagrams carry one bare
protobuf SSFSpan with no frame.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Optional

from veneur_tpu_torch.gen import ssf_pb2
from veneur_tpu_torch import ssf as ssf_model

MAX_SSF_PACKET_LENGTH = 16 * 1024 * 1024
SSF_FRAME_LENGTH = 5
VERSION_0 = 0


class FramingError(Exception):
    """The stream is unrecoverably broken and must be closed."""


class SSFUnmarshalError(FramingError):
    """The frame was well-formed but its protobuf payload didn't parse.

    Subclass of FramingError so packet-path callers keep one catch, but
    the framed-stream reader treats it as recoverable: the frame's bytes
    were fully consumed, so the connection can keep reading (reference
    ReadSSF returns a non-framing error and ReadSSFStreamSocket
    continues, server.go:1243-1248)."""


def _enum_or_raw(enum_cls, v: int):
    """proto3 semantics: unknown enum values are DATA, not errors — the
    Go reference decodes them as plain ints and the per-sample converter
    skips them (ConvertMetrics' invalid tally, samplers/parser.go:103).
    Rejecting the whole span here would drop its valid samples too (an
    extended SSF fuzz found it)."""
    try:
        return enum_cls(v)
    except ValueError:
        return v


def pb_to_span(pb: ssf_pb2.SSFSpan) -> ssf_model.SSFSpan:
    return ssf_model.SSFSpan(
        version=pb.version,
        trace_id=pb.trace_id,
        id=pb.id,
        parent_id=pb.parent_id,
        start_timestamp=pb.start_timestamp,
        end_timestamp=pb.end_timestamp,
        error=pb.error,
        service=pb.service,
        tags=dict(pb.tags),
        indicator=pb.indicator,
        name=pb.name,
        metrics=[
            ssf_model.SSFSample(
                metric=_enum_or_raw(ssf_model.SSFMetricType, s.metric),
                name=s.name,
                value=s.value,
                timestamp=s.timestamp,
                message=s.message,
                status=_enum_or_raw(ssf_model.SSFStatus, s.status),
                sample_rate=s.sample_rate,
                tags=dict(s.tags),
                unit=s.unit,
                scope=_enum_or_raw(ssf_model.SSFScope, s.scope),
            )
            for s in pb.metrics
        ],
    )


def span_to_pb(span: ssf_model.SSFSpan) -> ssf_pb2.SSFSpan:
    pb = ssf_pb2.SSFSpan(
        version=span.version,
        trace_id=span.trace_id,
        id=span.id,
        parent_id=span.parent_id,
        start_timestamp=span.start_timestamp,
        end_timestamp=span.end_timestamp,
        error=span.error,
        service=span.service,
        indicator=span.indicator,
        name=span.name,
    )
    for k, v in span.tags.items():
        pb.tags[k] = v
    for s in span.metrics:
        sp = pb.metrics.add(
            metric=int(s.metric),
            name=s.name,
            value=s.value,
            timestamp=s.timestamp,
            message=s.message,
            status=int(s.status),
            sample_rate=s.sample_rate,
            unit=s.unit,
            scope=int(s.scope),
        )
        for k, v in s.tags.items():
            sp.tags[k] = v
    return pb


def normalize_span(span: ssf_model.SSFSpan) -> ssf_model.SSFSpan:
    """Ingestion normalization (documented in the SSF spec): an empty span
    name is replaced by the "name" tag (which is then removed), and metric
    sample rates of 0 default to 1 (reference ParseSSF semantics)."""
    if not span.name and "name" in span.tags:
        span.name = span.tags.pop("name")
    for s in span.metrics:
        if s.sample_rate == 0:
            s.sample_rate = 1.0
    return span


def parse_ssf(packet: bytes) -> ssf_model.SSFSpan:
    """Parse one unframed protobuf SSFSpan (the UDP datagram form)."""
    try:
        pb = ssf_pb2.SSFSpan.FromString(packet)
    except Exception as e:
        raise SSFUnmarshalError(f"invalid SSF protobuf: {e}") from None
    return normalize_span(pb_to_span(pb))


def read_ssf(stream: BinaryIO,
             max_length: int = MAX_SSF_PACKET_LENGTH
             ) -> Optional[ssf_model.SSFSpan]:
    """Read one framed span from a stream.

    Returns None on clean EOF at a frame boundary. Raises FramingError on
    any framing violation (fatal for the stream). max_length caps the
    accepted frame size (config trace_max_length_bytes; the protocol's
    hard ceiling stays MAX_SSF_PACKET_LENGTH).
    """
    header = stream.read(1)
    if not header:
        return None
    version = header[0]
    if version != VERSION_0:
        raise FramingError(f"unknown SSF frame version {version}")
    length_bytes = _read_exact(stream, 4)
    (length,) = struct.unpack(">I", length_bytes)
    limit = min(max_length, MAX_SSF_PACKET_LENGTH)
    if length > limit:
        raise FramingError(
            f"frame length {length} exceeds {limit}")
    body = _read_exact(stream, length)
    return parse_ssf(body)


def _read_exact(stream: BinaryIO, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = stream.read(n - len(buf))
        if not chunk:
            raise FramingError("unexpected EOF inside SSF frame")
        buf += chunk
    return buf


def write_ssf(stream: BinaryIO, span: ssf_model.SSFSpan) -> int:
    """Write one framed span; returns bytes written
    (reference WriteSSF, protocol/wire.go)."""
    body = span_to_pb(span).SerializeToString()
    if len(body) > MAX_SSF_PACKET_LENGTH:
        raise FramingError("span exceeds max SSF packet length")
    frame = struct.pack(">BI", VERSION_0, len(body)) + body
    stream.write(frame)
    return len(frame)


def encode_datagram(span: ssf_model.SSFSpan) -> bytes:
    """The unframed UDP datagram form."""
    return span_to_pb(span).SerializeToString()
