"""Core metric model: keys, scopes, parsed samples, and flushed points.

Behavioral spec: reference samplers/parser.go:22-96 (UDPMetric, MetricKey,
MetricScope) and samplers/samplers.go:16-127 (MetricType, RouteInformation,
InterMetric, aggregates, sink-routing tags).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

# ---------------------------------------------------------------------------
# Scopes


class MetricScope(enum.IntEnum):
    """Where a metric is emitted (reference samplers/parser.go:66-70)."""

    MIXED = 0
    LOCAL_ONLY = 1
    GLOBAL_ONLY = 2


# Magic tags that set scope / sink routing at parse time
# (reference samplers/parser.go:394-408, samplers/samplers.go:110-127).
TAG_LOCAL_ONLY = "veneurlocalonly"
TAG_GLOBAL_ONLY = "veneurglobalonly"
SINK_ONLY_TAG_PREFIX = "veneursinkonly:"

# Tenant identity for the per-tenant QoS layer (core/tenancy.py). No
# reference analog — veneur has no tenant concept; the tag key is
# configurable (`tenant_tag_key`) and untagged traffic pools here.
DEFAULT_TENANT_TAG_KEY = "tenant"
DEFAULT_TENANT = "default"


# ---------------------------------------------------------------------------
# Metric identity


@dataclass(frozen=True)
class MetricKey:
    """Identity of a metric series: (name, type, deterministic joined tags).

    Reference: samplers/parser.go:72-96.
    """

    name: str
    type: str
    joined_tags: str

    def key_string(self) -> str:
        """Concatenation used for consistent-hash ring routing
        (reference samplers/parser.go:90-96)."""
        return self.name + self.type + self.joined_tags


# ---------------------------------------------------------------------------
# Parsed sample


@dataclass
class UDPMetric:
    """A single parsed client sample (reference samplers/parser.go:22-34).

    ``value`` is a float for counter/gauge/histogram/timer, a string for
    set, and an int status code for status checks.
    """

    key: MetricKey
    digest: int
    value: object
    sample_rate: float = 1.0
    tags: list[str] = field(default_factory=list)
    scope: MetricScope = MetricScope.MIXED
    timestamp: int = 0
    message: str = ""
    hostname: str = ""

    # Convenience accessors mirroring the embedded-struct style of the
    # reference's UDPMetric.
    @property
    def name(self) -> str:
        return self.key.name

    @property
    def type(self) -> str:
        return self.key.type

    @property
    def joined_tags(self) -> str:
        return self.key.joined_tags


def valid_metric(m: UDPMetric) -> bool:
    """Reference samplers/parser.go:211-216."""
    return bool(m.key.name) and m.value is not None


# ---------------------------------------------------------------------------
# Flushed points


class MetricType(enum.IntEnum):
    """Type of a flushed InterMetric (reference samplers/samplers.go:18-27)."""

    COUNTER = 0
    GAUGE = 1
    STATUS = 2


def route_info(tags: list[str]) -> Optional[frozenset[str]]:
    """Extract sink-routing info from ``veneursinkonly:`` tags.

    Returns None when the metric should go to every sink (the common case),
    else the set of sink names that should receive it.
    Reference: samplers/samplers.go:112-127.
    """
    info = None
    for tag in tags:
        if tag.startswith(SINK_ONLY_TAG_PREFIX):
            name = tag[len(SINK_ONLY_TAG_PREFIX):]
            info = frozenset([name]) if info is None else info | {name}
    return info


def tenant_of(tags: list[str], tag_key: str = DEFAULT_TENANT_TAG_KEY) -> str:
    """Extract the tenant id from a sample's tags at parse/ingest time.

    The tag key is configurable (``tenant_tag_key``); untagged traffic
    pools into ``DEFAULT_TENANT`` so single-tenant deployments see one
    uniform bucket. Same single-scan shape as ``route_info`` above —
    this runs on the per-sample hot path.
    """
    prefix = tag_key + ":"
    plen = len(prefix)
    for tag in tags:
        if tag.startswith(prefix):
            return tag[plen:] or DEFAULT_TENANT
    return DEFAULT_TENANT


def route_to(sinks: Optional[frozenset[str]], sink_name: str) -> bool:
    """A nil route table means every sink is eligible
    (reference samplers/samplers.go:38-44)."""
    return sinks is None or sink_name in sinks


@dataclass(slots=True)
class InterMetric:
    """A completed metric ready for sink flushing
    (reference samplers/samplers.go:48-61). slots: a flush materializes
    millions of these; slots cut per-instance memory ~3x and speed
    construction."""

    name: str
    timestamp: int
    value: float
    tags: list[str]
    type: MetricType
    message: str = ""
    hostname: str = ""
    # None => deliver to every sink; else only the named sinks.
    sinks: Optional[frozenset[str]] = None


# ---------------------------------------------------------------------------
# Histogram aggregate selection (reference samplers/samplers.go:63-98)


class Aggregate(enum.IntFlag):
    MIN = 1
    MAX = 2
    MEDIAN = 4
    AVERAGE = 8
    COUNT = 16
    SUM = 32
    HARMONIC_MEAN = 64


AGGREGATES_LOOKUP = {
    "min": Aggregate.MIN,
    "max": Aggregate.MAX,
    "median": Aggregate.MEDIAN,
    "avg": Aggregate.AVERAGE,
    "count": Aggregate.COUNT,
    "sum": Aggregate.SUM,
    "hmean": Aggregate.HARMONIC_MEAN,
}

AGGREGATE_NAMES = {
    Aggregate.MIN: "min",
    Aggregate.MAX: "max",
    Aggregate.MEDIAN: "median",
    Aggregate.AVERAGE: "avg",
    Aggregate.COUNT: "count",
    Aggregate.SUM: "sum",
    Aggregate.HARMONIC_MEAN: "hmean",
}


@dataclass
class HistogramAggregates:
    """Which aggregate series a histogram flush emits, plus their count
    (reference samplers/samplers.go:85-88)."""

    value: Aggregate
    count: int

    @classmethod
    def from_names(cls, names: list[str]) -> "HistogramAggregates":
        agg = Aggregate(0)
        n = 0
        for name in names:
            a = AGGREGATES_LOOKUP.get(name)
            if a is not None:
                agg |= a
                n += 1
        return cls(agg, n)


DEFAULT_AGGREGATES = HistogramAggregates.from_names(["min", "max", "count"])
