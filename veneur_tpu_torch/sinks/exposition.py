"""Shared Prometheus exposition-text renderer.

One formatter, two surfaces: the push-style PrometheusExpositionSink
(sinks/prometheus.py) and the pull-style live query endpoint
(veneur_tpu/query/http.py) must serialize series identically — same
sanitization, same label dedup, same value rendering, same native-emit
negotiation. Before this module each surface would have carried its own
copy of the format code; now both call render_columnar/render_metrics
and the byte-identity is structural, not a parity test away from
drifting.

The Python formatter (expo_sample) is pinned byte-identical to the
native serializer (vn_encode_prometheus_exposition) by
tests/test_emit_parity.py; the query surface inherits that pin through
this module.
"""

from __future__ import annotations

import re
from typing import Optional

from veneur_tpu_torch.core.metrics import MetricType

_INVALID_NAME = re.compile(r"[^a-zA-Z0-9_:.]")  # dots map to exporter paths
_INVALID_TAG = re.compile(r"[^a-zA-Z0-9_:,=\.]")
# exposition format: metric names allow [a-zA-Z0-9_:], label names
# [a-zA-Z0-9_] (the exposition writer has no dot-to-path mapping)
_INVALID_EXPO_NAME = re.compile(r"[^a-zA-Z0-9_:]")
_INVALID_EXPO_LABEL = re.compile(r"[^a-zA-Z0-9_]")

# the scrape/POST body content type for text format 0.0.4
CONTENT_TYPE = "text/plain; version=0.0.4"


def sanitize_name(name: str) -> str:
    return _INVALID_NAME.sub("_", name)


def sanitize_tag(tag: str) -> str:
    return _INVALID_TAG.sub("_", tag)


def expo_value(v: float) -> str:
    """Exposition sample value rendering (pinned == the native
    emitter's expo_value_append)."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return str(v)


def expo_sample(name: str, tags: list[str], value: float,
                excluded_tags=None) -> str:
    """One exposition text line: name{label="value",...} value\\n.
    Label keys dedup by their SANITIZED form (last value wins, first
    position kept); exclusion matches the RAW tag key. Pinned
    byte-identical to vn_encode_prometheus_exposition."""
    labels: dict[str, str] = {}
    for tag in tags:
        rawkey, _, val = tag.partition(":")
        if excluded_tags and rawkey in excluded_tags:
            continue
        key = _INVALID_EXPO_LABEL.sub("_", rawkey)
        labels[key] = val
    line = _INVALID_EXPO_NAME.sub("_", name)
    if labels:
        line += "{" + ",".join(
            '%s="%s"' % (k, v.replace("\\", "\\\\").replace('"', '\\"')
                         .replace("\n", "\\n"))
            for k, v in labels.items()) + "}"
    return f"{line} {expo_value(value)}\n"


def group_samples(g, sink_name: Optional[str], excluded_tags,
                  append) -> None:
    """Per-row Python formatter for one column group. sink_name=None
    skips routing (the pull surface exposes every series; a sink only
    serializes the rows routed to it)."""
    counter = MetricType.COUNTER
    gauge = MetricType.GAUGE
    for fam in g.families:
        if fam.type not in (counter, gauge):
            continue
        vals = fam.values.tolist()
        suffix = fam.suffix
        for i in g.rows_for(fam).tolist():
            name, tags, sinks = g.meta_at(i)
            if sink_name is not None and g.has_routing \
                    and sinks is not None and sink_name not in sinks:
                continue
            append(expo_sample(name + suffix if suffix else name,
                               tags, vals[i], excluded_tags))


def extra_samples(batch, sink_name: Optional[str], excluded_tags,
                  append) -> None:
    for m in batch.extras:
        if sink_name is not None and m.sinks is not None \
                and sink_name not in m.sinks:
            continue
        if m.type not in (MetricType.COUNTER, MetricType.GAUGE):
            continue
        append(expo_sample(m.name, m.tags, m.value, excluded_tags))


def render_metrics(metrics) -> tuple[bytes, int]:
    """InterMetric-object path: one exposition body from a metric list."""
    parts = []
    for m in metrics:
        if m.type in (MetricType.COUNTER, MetricType.GAUGE):
            parts.append(expo_sample(m.name, m.tags, m.value))
    return "".join(parts).encode("utf-8"), len(parts)


def render_columnar(batch, sink_name: Optional[str] = "prometheus",
                    excluded_tags=None, native: bool = True
                    ) -> tuple[bytes, int]:
    """One exposition-text body from a columnar batch → (body, samples).

    With native=True the whole body comes out of
    vn_encode_prometheus_exposition in one GIL-free pass per group when
    the emit tier is available; groups without a plan (routing,
    separator-laden names) fall back to the Python formatter. The two
    paths are byte-identical (tests/test_emit_parity.py)."""
    plans = None
    if native:
        from veneur_tpu_torch import native as native_mod

        if native_mod.emit_available():
            plans = batch.emit_plan()
    chunks: list[bytes] = []
    count = 0
    excl = sorted(excluded_tags) if excluded_tags else []
    for gi, g in enumerate(batch.groups):
        out = None
        if plans is not None and plans[gi] is not None:
            from veneur_tpu_torch import native as native_mod

            plan = plans[gi]
            out = native_mod.encode_prometheus_exposition(
                plan.meta_blob, plan.nrows, plan.suffixes,
                plan.family_types, plan.values, plan.masks, excl)
        if out is None:
            parts: list[str] = []
            group_samples(g, sink_name, excluded_tags, parts.append)
            chunks.append("".join(parts).encode("utf-8"))
            count += len(parts)
            continue
        blob, n = out
        chunks.append(blob)
        count += n
    parts = []
    extra_samples(batch, sink_name, excluded_tags, parts.append)
    chunks.append("".join(parts).encode("utf-8"))
    count += len(parts)
    return b"".join(chunks), count
