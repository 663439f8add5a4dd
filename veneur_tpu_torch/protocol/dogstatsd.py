"""DogStatsD datagram parsing.

Behavioral spec: reference samplers/parser.go (ParseMetric :298, ParseEvent
:431, ParseServiceCheck :579, ParseMetricSSF :239) including its malformed-
packet rules, magic scope tags, and digest accumulation order. The exhaustive
failure cases of the reference's parser_test.go are mirrored in
tests/test_parser.py.

This is the correctness-reference implementation; the C++ hot-loop parser in
native/ produces identical results and is preferred on the ingest path.
"""

from __future__ import annotations

import math
import time
from typing import Optional

from veneur_tpu_torch.core.metrics import (
    MetricKey,
    MetricScope,
    UDPMetric,
)
from veneur_tpu_torch.ssf import SSFSample, SSFMetricType, SSFStatus, SSFScope
from veneur_tpu_torch.utils.hashing import fnv1a_32_str, FNV1A_32_OFFSET

# Special tag keys used to carry DogStatsD event attributes on an SSFSample
# (reference protocol/dogstatsd/protocol.go).
EVENT_IDENTIFIER_KEY = "vdogstatsd_ev"
EVENT_AGGREGATION_KEY_TAG_KEY = "vdogstatsd_ak"
EVENT_ALERT_TYPE_TAG_KEY = "vdogstatsd_at"
EVENT_HOSTNAME_TAG_KEY = "vdogstatsd_hostname"
EVENT_PRIORITY_TAG_KEY = "vdogstatsd_pri"
EVENT_SOURCE_TYPE_TAG_KEY = "vdogstatsd_st"


class ParseError(ValueError):
    pass


def _parse_float(chunk: bytes) -> float:
    """Strict float parse: rejects the whitespace/underscore forms Python's
    float() accepts but a statsd value field must not contain."""
    if not chunk or chunk != chunk.strip() or b"_" in chunk:
        raise ParseError("Invalid number for metric value: %r" % chunk)
    try:
        return float(chunk)
    except ValueError:
        raise ParseError("Invalid number for metric value: %r" % chunk) from None


_TYPE_BY_LEAD = {
    ord("c"): "counter",
    ord("g"): "gauge",
    ord("d"): "histogram",  # DogStatsD "distribution" treated as histogram
    ord("h"): "histogram",
    ord("m"): "timer",  # "ms"
    ord("s"): "set",
}


def parse_metric(packet: bytes) -> UDPMetric:
    """Parse one DogStatsD metric datagram line.

    Reference: samplers/parser.go:298-423.
    """
    chunks = packet.split(b"|")

    first = chunks[0]
    colon = first.find(b":")
    if colon == -1:
        raise ParseError("Invalid metric packet, need at least 1 colon")
    name_chunk = first[:colon]
    value_chunk = first[colon + 1:]
    if not name_chunk:
        raise ParseError("Invalid metric packet, name cannot be empty")

    if len(chunks) < 2:
        raise ParseError("Invalid metric packet, need at least 1 pipe for type")
    type_chunk = chunks[1]
    if not type_chunk:
        # e.g. "foo:1||" — missing type
        raise ParseError("Invalid metric packet, metric type not specified")

    name = name_chunk.decode("utf-8", errors="replace")
    h = fnv1a_32_str(name)

    mtype = _TYPE_BY_LEAD.get(type_chunk[0])
    if mtype is None:
        raise ParseError("Invalid type for metric")
    h = fnv1a_32_str(mtype, h)

    value: object
    if mtype == "set":
        value = value_chunk.decode("utf-8", errors="replace")
    else:
        value = _parse_float(value_chunk)
        if math.isnan(value) or math.isinf(value):
            raise ParseError("Invalid number for metric value: %r" % value_chunk)

    sample_rate = 1.0
    scope = MetricScope.MIXED
    tags: Optional[list[str]] = None
    joined_tags = ""
    found_sample_rate = False

    for chunk in chunks[2:]:
        if not chunk:
            # e.g. "foo:1|g|" — empty section between pipes
            raise ParseError(
                "Invalid metric packet, empty string after/between pipes"
            )
        lead = chunk[0]
        if lead == ord("@"):
            if found_sample_rate:
                raise ParseError(
                    "Invalid metric packet, multiple sample rates specified"
                )
            try:
                sr = _parse_float(chunk[1:])
            except ParseError:
                raise ParseError(
                    "Invalid float for sample rate: %r" % chunk[1:]
                ) from None
            if not (0 < sr <= 1) or math.isnan(sr):
                raise ParseError("Sample rate %f must be >0 and <=1" % sr)
            sample_rate = sr
            found_sample_rate = True
        elif lead == ord("#"):
            if tags is not None:
                raise ParseError(
                    "Invalid metric packet, multiple tag sections specified"
                )
            tags = sorted(chunk[1:].decode("utf-8", errors="replace").split(","))
            # Magic scope tags: the first (in sorted order) tag carrying either
            # prefix sets the scope and is removed; only one is consumed.
            # Reference: samplers/parser.go:394-408 (prefix match).
            for i, tag in enumerate(tags):
                if tag.startswith("veneurlocalonly"):
                    del tags[i]
                    scope = MetricScope.LOCAL_ONLY
                    break
                elif tag.startswith("veneurglobalonly"):
                    del tags[i]
                    scope = MetricScope.GLOBAL_ONLY
                    break
            joined_tags = ",".join(tags)
            h = fnv1a_32_str(joined_tags, h)
        else:
            raise ParseError(
                "Invalid metric packet, contains unknown section %r" % chunk
            )

    return UDPMetric(
        key=MetricKey(name=name, type=mtype, joined_tags=joined_tags),
        digest=h,
        value=value,
        sample_rate=sample_rate,
        tags=tags if tags is not None else [],
        scope=scope,
    )


def parse_tag_slice_to_map(tags: list[str]) -> dict[str, str]:
    """Split "k:v" tags into a map; valueless tags map to ""
    (reference samplers/parser.go:696-707)."""
    out: dict[str, str] = {}
    for tag in tags:
        k, sep, v = tag.partition(":")
        out[k] = v if sep else ""
    return out


def parse_event(packet: bytes) -> SSFSample:
    """Parse a DogStatsD event packet into an SSF sample whose tags carry the
    Datadog-specific attributes. Reference: samplers/parser.go:431-573."""
    ret = SSFSample(
        timestamp=int(time.time()),
        tags={EVENT_IDENTIFIER_KEY: ""},
    )

    chunks = packet.split(b"|")
    first = chunks[0]
    colon = first.find(b":")
    if colon == -1:
        raise ParseError("Invalid event packet, need at least 1 colon")

    lengths = first[:colon]
    if not lengths.startswith(b"_e{") or not lengths.endswith(b"}"):
        raise ParseError(
            "Invalid event packet, must have _e{} wrapper around length section"
        )
    lengths = lengths[3:-1]
    comma = lengths.find(b",")
    if comma == -1:
        raise ParseError(
            "Invalid event packet, length section requires comma divider"
        )
    try:
        title_len = int(lengths[:comma])
    except ValueError:
        raise ParseError(
            "Invalid event packet, title length is not an integer"
        ) from None
    if title_len <= 0:
        raise ParseError("Invalid event packet, title length must be positive")
    try:
        text_len = int(lengths[comma + 1:])
    except ValueError:
        raise ParseError(
            "Invalid event packet, text length is not an integer"
        ) from None
    if text_len <= 0:
        raise ParseError("Invalid event packet, text length must be positive")

    title_chunk = first[colon + 1:]
    if len(title_chunk) != title_len:
        raise ParseError(
            "Invalid event packet, actual title length did not match encoded length"
        )
    ret.name = title_chunk.decode("utf-8", errors="replace")

    if len(chunks) < 2:
        raise ParseError("Invalid event packet, must have at least 1 pipe for text")
    text_chunk = chunks[1]
    if len(text_chunk) != text_len:
        raise ParseError(
            "Invalid event packet, actual text length did not match encoded length"
        )
    ret.message = text_chunk.decode("utf-8", errors="replace").replace("\\n", "\n")

    found = set()

    def _once(section: str):
        if section in found:
            raise ParseError(
                "Invalid event packet, multiple %s sections" % section
            )
        found.add(section)

    for chunk in chunks[2:]:
        if not chunk:
            raise ParseError(
                "Invalid event packet, empty string after/between pipes"
            )
        if chunk.startswith(b"d:"):
            _once("date")
            try:
                ret.timestamp = int(chunk[2:])
            except ValueError:
                raise ParseError(
                    "Invalid event packet, could not parse date as unix timestamp"
                ) from None
        elif chunk.startswith(b"h:"):
            _once("hostname")
            ret.tags[EVENT_HOSTNAME_TAG_KEY] = chunk[2:].decode(
                "utf-8", errors="replace"
            )
        elif chunk.startswith(b"k:"):
            _once("aggregation")
            ret.tags[EVENT_AGGREGATION_KEY_TAG_KEY] = chunk[2:].decode(
                "utf-8", errors="replace"
            )
        elif chunk.startswith(b"p:"):
            _once("priority")
            pri = chunk[2:].decode("utf-8", errors="replace")
            if pri not in ("normal", "low"):
                raise ParseError(
                    "Invalid event packet, priority must be normal or low"
                )
            ret.tags[EVENT_PRIORITY_TAG_KEY] = pri
        elif chunk.startswith(b"s:"):
            _once("source")
            ret.tags[EVENT_SOURCE_TYPE_TAG_KEY] = chunk[2:].decode(
                "utf-8", errors="replace"
            )
        elif chunk.startswith(b"t:"):
            _once("alert")
            alert = chunk[2:].decode("utf-8", errors="replace")
            if alert not in ("error", "warning", "info", "success"):
                raise ParseError(
                    "Invalid event packet, alert level must be error, warning,"
                    " info or success"
                )
            ret.tags[EVENT_ALERT_TYPE_TAG_KEY] = alert
        elif chunk[0] == ord("#"):
            _once("tags")
            tags = chunk[1:].decode("utf-8", errors="replace").split(",")
            ret.tags.update(parse_tag_slice_to_map(tags))
        else:
            raise ParseError(
                "Invalid event packet, unrecognized metadata section"
            )

    return ret


_STATUS_BY_BYTE = {
    b"0": SSFStatus.OK,
    b"1": SSFStatus.WARNING,
    b"2": SSFStatus.CRITICAL,
    b"3": SSFStatus.UNKNOWN,
}


def parse_service_check(packet: bytes) -> UDPMetric:
    """Parse a DogStatsD service-check packet into a status UDPMetric.

    Reference: samplers/parser.go:579-692. Note the magic scope tags here
    require exact equality, unlike the prefix match in parse_metric.
    """
    chunks = packet.split(b"|")
    if chunks[0] != b"_sc":
        raise ParseError("Invalid service check packet, no _sc prefix")
    if len(chunks) < 2:
        raise ParseError("Invalid service check packet, need name section")
    if not chunks[1]:
        raise ParseError("Invalid service check packet, empty name")
    name = chunks[1].decode("utf-8", errors="replace")

    if len(chunks) < 3:
        raise ParseError("Invalid service check packet, need status section")
    status = _STATUS_BY_BYTE.get(chunks[2])
    if status is None:
        raise ParseError(
            "Invalid service check packet, must have status of 0, 1, 2, or 3"
        )

    timestamp = int(time.time())
    hostname = ""
    message = ""
    tags: list[str] = []
    scope = MetricScope.MIXED
    found = set()
    found_message = False

    def _once(section: str):
        if section in found:
            raise ParseError(
                "Invalid service check packet, multiple %s sections" % section
            )
        found.add(section)

    for chunk in chunks[3:]:
        if not chunk:
            raise ParseError(
                "Invalid service packet packet, empty string after/between pipes"
            )
        if found_message:
            raise ParseError(
                "Invalid service check packet, message must be the last"
                " metadata section"
            )
        if chunk.startswith(b"d:"):
            _once("date")
            try:
                timestamp = int(chunk[2:])
            except ValueError:
                raise ParseError(
                    "Invalid service check packet, could not parse date as"
                    " unix timestamp"
                ) from None
        elif chunk.startswith(b"h:"):
            _once("hostname")
            hostname = chunk[2:].decode("utf-8", errors="replace")
        elif chunk.startswith(b"m:"):
            found_message = True
            message = chunk[2:].decode("utf-8", errors="replace").replace(
                "\\n", "\n"
            )
        elif chunk[0] == ord("#"):
            _once("tags")
            tags = sorted(chunk[1:].decode("utf-8", errors="replace").split(","))
            for i, tag in enumerate(tags):
                if tag == "veneurlocalonly":
                    del tags[i]
                    scope = MetricScope.LOCAL_ONLY
                    break
                elif tag == "veneurglobalonly":
                    del tags[i]
                    scope = MetricScope.GLOBAL_ONLY
                    break
        else:
            raise ParseError(
                "Invalid service check packet, unrecognized metadata section"
            )

    joined_tags = ",".join(tags)
    h = fnv1a_32_str(name)
    h = fnv1a_32_str("status", h)
    h = fnv1a_32_str(joined_tags, h)

    return UDPMetric(
        key=MetricKey(name=name, type="status", joined_tags=joined_tags),
        digest=h,
        value=status,
        sample_rate=1.0,
        tags=tags,
        scope=scope,
        timestamp=timestamp,
        message=message,
        hostname=hostname,
    )


_SSF_TYPE_NAMES = {
    SSFMetricType.COUNTER: "counter",
    SSFMetricType.GAUGE: "gauge",
    SSFMetricType.HISTOGRAM: "histogram",
    SSFMetricType.SET: "set",
    SSFMetricType.STATUS: "status",
}


def parse_metric_ssf(sample: SSFSample) -> UDPMetric:
    """Convert an SSF sample into a UDPMetric.

    Reference: samplers/parser.go:239-294.
    """
    mtype = _SSF_TYPE_NAMES.get(sample.metric)
    if mtype is None:
        raise ParseError("Invalid type for metric")

    h = fnv1a_32_str(sample.name)
    h = fnv1a_32_str(mtype, h)

    value: object
    if sample.metric == SSFMetricType.SET:
        value = sample.message
    elif sample.metric == SSFMetricType.STATUS:
        value = sample.status
    else:
        value = float(sample.value)

    scope = MetricScope.MIXED
    if sample.scope == SSFScope.LOCAL:
        scope = MetricScope.LOCAL_ONLY
    elif sample.scope == SSFScope.GLOBAL:
        scope = MetricScope.GLOBAL_ONLY

    tags = []
    for k, v in sample.tags.items():
        if k == "veneurlocalonly":
            scope = MetricScope.LOCAL_ONLY
            continue
        if k == "veneurglobalonly":
            scope = MetricScope.GLOBAL_ONLY
            continue
        tags.append(k + ":" + v)
    tags.sort()
    joined_tags = ",".join(tags)
    h = fnv1a_32_str(joined_tags, h)

    return UDPMetric(
        key=MetricKey(name=sample.name, type=mtype, joined_tags=joined_tags),
        digest=h,
        value=value,
        sample_rate=sample.sample_rate,
        tags=tags,
        scope=scope,
    )
