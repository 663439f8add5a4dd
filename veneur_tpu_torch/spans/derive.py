"""Batched span→metric derivation, bit-identical to the per-span path.

The per-span reference behavior lives in core/spans.py
(``convert_metrics`` / ``convert_indicator_metrics`` /
``convert_span_uniqueness_metrics``, themselves pinned to the Go
reference). This module reproduces it over a sealed columnar batch by
construction rather than by reimplementation: every distinct key
combination — an attached sample's (type, name, tags), an indicator
timer's (service, error), an objective timer's (service, objective,
error), a uniqueness set's (indicator, service, root_span) — is parsed
exactly once through ``protocol.dogstatsd.parse_metric_ssf`` (the same
fnv1a-32 digest chain, magic-tag scope extraction, and tag
canonicalization the per-span path runs per metric) and cached as a
``UDPMetric`` template. Each row then emits a copy of its template
varying only in ``value`` / ``sample_rate``, in exactly the per-span
emission order: attached samples first (span order), then the indicator
timer, the objective timer, and the uniqueness set. Identical inputs to
``DeviceWorker.process_metric`` in identical per-worker order ⇒
identical sketches, micro-fold and series_shards included — that is the
whole parity argument, and tests/test_spans_columnar.py pins it per
metric class.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

from veneur_tpu_torch import ssf
from veneur_tpu_torch.core.metrics import UDPMetric
from veneur_tpu_torch.protocol.dogstatsd import ParseError, parse_metric_ssf

from veneur_tpu_torch.spans.batch import SealedBatch, StringArena, frag_tags

_SET = int(ssf.SSFMetricType.SET)
_STATUS = int(ssf.SSFMetricType.STATUS)


def _clone(tpl: UDPMetric, value, sample_rate: float) -> UDPMetric:
    """A template copy varying only in value/sample_rate. key, digest,
    tags and scope are immutable downstream (the worker only reads
    them), so sharing is safe and keeps emission allocation-light."""
    return UDPMetric(key=tpl.key, digest=tpl.digest, value=value,
                     sample_rate=sample_rate, tags=tpl.tags,
                     scope=tpl.scope)


class TemplateStore:
    """Per-key-combination UDPMetric templates, all minted through
    parse_metric_ssf so the digest/scope/tag semantics cannot drift from
    the per-span path."""

    def __init__(self, arena: StringArena,
                 indicator_timer_name: str = "",
                 objective_timer_name: str = "") -> None:
        self.arena = arena
        self.indicator_timer_name = indicator_timer_name
        self.objective_timer_name = objective_timer_name
        # attached-sample templates; the batch's sample_tpl column
        # indexes self.templates, so this list is part of the wire model
        self.templates: list[tuple[int, UDPMetric]] = []
        self._sample_ids: dict[tuple, Optional[tuple[int, int]]] = {}
        self._indicator: dict[tuple[int, int], UDPMetric] = {}
        self._objective: dict[tuple[int, int, int], UDPMetric] = {}
        self._uniq: dict[tuple[int, int, int], UDPMetric] = {}

    # -- attached samples ----------------------------------------------

    def sample_template(self, sample) -> Optional[tuple[int, int]]:
        """(template id, metric kind) for an SSF sample, or None when
        the per-span path would count it invalid (unknown metric enum,
        empty metric name). One parse per distinct key combination."""
        try:
            kind = int(sample.metric)
        except (TypeError, ValueError):
            return None
        key = (kind, sample.name,
               tuple(sorted(sample.tags.items())) if sample.tags else ())
        hit = self._sample_ids.get(key, False)
        if hit is not False:
            return hit
        resolved: Optional[tuple[int, int]]
        try:
            tpl = parse_metric_ssf(ssf.SSFSample(
                metric=sample.metric, name=sample.name,
                tags=dict(sample.tags)))
        except ParseError:
            resolved = None
        else:
            if not tpl.key.name:
                resolved = None
            else:
                resolved = (len(self.templates), kind)
                self.templates.append((kind, tpl))
        self._sample_ids[key] = resolved
        return resolved

    @staticmethod
    def sample_value(sample, kind: int):
        """The value parse_metric_ssf would put on the UDPMetric: the
        message for sets, the raw status for status checks, float()
        otherwise. None ⇒ the per-span path's valid-metric check drops
        it."""
        if kind == _SET:
            return sample.message
        if kind == _STATUS:
            return sample.status
        return float(sample.value)

    # -- derived timers / sets -----------------------------------------

    def indicator_template(self, service_sid: int, error: int) -> UDPMetric:
        key = (service_sid, error)
        tpl = self._indicator.get(key)
        if tpl is None:
            tpl = parse_metric_ssf(ssf.timing_ns(
                self.indicator_timer_name, 0,
                {"service": self.arena.strings[service_sid],
                 "error": "true" if error else "false"}))
            self._indicator[key] = tpl
        return tpl

    def objective_template(self, service_sid: int, objective_sid: int,
                           error: int) -> UDPMetric:
        key = (service_sid, objective_sid, error)
        tpl = self._objective.get(key)
        if tpl is None:
            tpl = parse_metric_ssf(ssf.timing_ns(
                self.objective_timer_name, 0,
                {"service": self.arena.strings[service_sid],
                 "objective": self.arena.strings[objective_sid],
                 "error": "true" if error else "false",
                 "veneurglobalonly": "true"}))
            self._objective[key] = tpl
        return tpl

    def uniqueness_template(self, indicator: int, service_sid: int,
                            root: int) -> UDPMetric:
        key = (indicator, service_sid, root)
        tpl = self._uniq.get(key)
        if tpl is None:
            tpl = parse_metric_ssf(ssf.set_sample(
                "ssf.names_unique", "",
                {"indicator": "true" if indicator else "false",
                 "service": self.arena.strings[service_sid],
                 "root_span": "true" if root else "false"}))
            self._uniq[key] = tpl
        return tpl


def derive_batch(sealed: SealedBatch, uniqueness_rate: float,
                 emit: Callable[[UDPMetric], None]) -> int:
    """Emit every UDPMetric the per-span path would derive from this
    batch, in the per-span path's exact order (rows FIFO; within a row:
    attached samples, indicator timer, objective timer, uniqueness set).
    Returns the number of metrics emitted."""
    b, arena, store = sealed
    strings = arena.strings
    templates = store.templates
    ind_name = store.indicator_timer_name
    obj_name = store.objective_timer_name
    emitted = 0
    sp = 0
    nsamples = b.samples
    for row in range(b.rows):
        # 1) attached SSF samples (convert_metrics)
        while sp < nsamples and b.sample_row[sp] == row:
            kind, tpl = templates[b.sample_tpl[sp]]
            emit(_clone(tpl, b.sample_value[sp], b.sample_rate[sp]))
            emitted += 1
            sp += 1
        service_sid = b.service_id[row]
        name_sid = b.name_id[row]
        error = b.error[row]
        # 2) indicator/objective duration timers
        # (convert_indicator_metrics gate: indicator && valid_trace_span)
        if (b.indicator[row]
                and b.span_id[row] != 0 and b.trace_id[row] != 0
                and b.start_ns[row] != 0 and b.end_ns[row] != 0
                and strings[name_sid] != ""):
            duration = float(b.end_ns[row] - b.start_ns[row])
            if ind_name:
                emit(_clone(store.indicator_template(service_sid, error),
                            duration, 1.0))
                emitted += 1
            if obj_name:
                emit(_clone(store.objective_template(
                    service_sid, b.objective_id[row], error),
                    duration, 1.0))
                emitted += 1
        # 3) span-name uniqueness set (convert_span_uniqueness_metrics:
        # gated on a nonempty service, sampled through the same
        # module-global RNG contract as ssf.randomly_sample)
        if uniqueness_rate > 0 and strings[service_sid]:
            if uniqueness_rate >= 1.0:
                rate = 1.0
            elif random.random() < uniqueness_rate:
                rate = uniqueness_rate
            else:
                continue
            root = 1 if b.span_id[row] == b.trace_id[row] else 0
            emit(_clone(
                store.uniqueness_template(b.indicator[row], service_sid,
                                          root),
                strings[name_sid], rate))
            emitted += 1
    return emitted


def batch_tags(sealed: SealedBatch, row: int) -> dict:
    """The row's tag dict, reconstructed from the interned frag (egress
    and debugging helper)."""
    return frag_tags(sealed.arena.strings[sealed.batch.tags_id[row]])
