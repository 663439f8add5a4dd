"""SSF (Sensor Sample Format) sample and span model.

Schema parity with the reference's ssf/sample.proto; the protobuf wire form
lives in veneur_tpu/ssf/ssf_pb2 (generated from proto/ssf.proto). This module
holds the Python-side model plus the sample-constructor helpers of the
reference's ssf/samples.go.
"""

from __future__ import annotations

import enum
import random
import time
from dataclasses import dataclass, field
from typing import Optional


class SSFMetricType(enum.IntEnum):
    # reference ssf/sample.proto Metric enum
    COUNTER = 0
    GAUGE = 1
    HISTOGRAM = 2
    SET = 3
    STATUS = 4


class SSFStatus(enum.IntEnum):
    # reference ssf/sample.proto Status enum (Nagios-style)
    OK = 0
    WARNING = 1
    CRITICAL = 2
    UNKNOWN = 3


class SSFScope(enum.IntEnum):
    # reference ssf/sample.proto Scope enum
    DEFAULT = 0
    LOCAL = 1
    GLOBAL = 2


@dataclass
class SSFSample:
    """One measurement attached to a span (reference ssf/sample.proto).

    The enum-typed fields may carry RAW INTS for values outside the
    known range: proto3 treats unknown enum values as data, and the
    decode passthrough (protocol/ssf_wire._enum_or_raw) preserves them
    so the per-sample converter can skip-and-count like the reference
    (samplers/parser.go:103-120). Don't assume .name/.value exist on
    them."""

    metric: SSFMetricType | int = SSFMetricType.COUNTER
    name: str = ""
    value: float = 0.0
    timestamp: int = 0
    message: str = ""
    status: SSFStatus | int = SSFStatus.OK
    sample_rate: float = 1.0
    tags: dict[str, str] = field(default_factory=dict)
    unit: str = ""
    scope: SSFScope | int = SSFScope.DEFAULT


@dataclass
class SSFSpan:
    """A trace span carrying samples (reference ssf/sample.proto SSFSpan)."""

    version: int = 0
    trace_id: int = 0
    id: int = 0
    parent_id: int = 0
    start_timestamp: int = 0  # nanoseconds
    end_timestamp: int = 0  # nanoseconds
    error: bool = False
    service: str = ""
    tags: dict[str, str] = field(default_factory=dict)
    indicator: bool = False
    name: str = ""
    metrics: list[SSFSample] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Sample constructors (reference ssf/samples.go)


def _mk(
    metric: SSFMetricType,
    name: str,
    value: float,
    tags: Optional[dict[str, str]] = None,
    unit: str = "",
    timestamp: Optional[int] = None,
) -> SSFSample:
    return SSFSample(
        metric=metric,
        name=name,
        value=value,
        timestamp=int(time.time()) if timestamp is None else timestamp,
        sample_rate=1.0,
        tags=dict(tags) if tags else {},
        unit=unit,
    )


def count(name: str, value: float, tags: Optional[dict[str, str]] = None) -> SSFSample:
    return _mk(SSFMetricType.COUNTER, name, value, tags)


def gauge(name: str, value: float, tags: Optional[dict[str, str]] = None) -> SSFSample:
    return _mk(SSFMetricType.GAUGE, name, value, tags)


def histogram(
    name: str, value: float, tags: Optional[dict[str, str]] = None, unit: str = ""
) -> SSFSample:
    return _mk(SSFMetricType.HISTOGRAM, name, value, tags, unit)


def timing_ns(
    name: str, duration_ns: int, tags: Optional[dict[str, str]] = None
) -> SSFSample:
    """A timer expressed in nanoseconds (reference ssf.Timing with
    time.Nanosecond resolution)."""
    return _mk(SSFMetricType.HISTOGRAM, name, float(duration_ns), tags, unit="ns")


def set_sample(
    name: str, value: str, tags: Optional[dict[str, str]] = None
) -> SSFSample:
    s = _mk(SSFMetricType.SET, name, 0.0, tags)
    s.message = value
    return s


def status(
    name: str, st: SSFStatus, message: str = "", tags: Optional[dict[str, str]] = None
) -> SSFSample:
    s = _mk(SSFMetricType.STATUS, name, 0.0, tags)
    s.status = st
    s.message = message
    return s


def randomly_sample(rate: float, *samples: SSFSample) -> list[SSFSample]:
    """Keep samples with probability ``rate``, recording the rate on the
    survivors (reference ssf/samples.go RandomlySample)."""
    if rate >= 1.0:
        return list(samples)
    out = []
    for s in samples:
        if random.random() < rate:
            s.sample_rate = rate
            out.append(s)
    return out


def valid_trace_span(span: SSFSpan) -> bool:
    """A span is a valid trace span if it has id, trace id, start, end and
    a name (reference protocol/wire.go:85-89 ValidTrace)."""
    return (
        span.id != 0
        and span.trace_id != 0
        and span.start_timestamp != 0
        and span.end_timestamp != 0
        and span.name != ""
    )
