"""Datadog sinks: metrics (+service checks +events) and APM spans.

Parity: reference sinks/datadog/datadog.go — counter→rate conversion
divided by the flush interval (:353-358), host:/device: magic tags
(:300-330), metric-name prefix drops, per-metric-prefix tag exclusion,
chunked parallel POSTs sized by flush_max_per_body (:112-148), span sink
with a bounded ring buffer (:32, datadogSpanBufferSize 1<<14), events and
service checks unwound from their special SSF tags.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import threading
from typing import Optional

from veneur_tpu_torch.core.metrics import InterMetric, MetricType
from veneur_tpu_torch.protocol import dogstatsd as ddproto
from veneur_tpu_torch.sinks import MetricSink, SpanSink
from veneur_tpu_torch.sinks.delivery import make_manager
from veneur_tpu_torch.sinks.journal_codec import HttpEnvelope
from veneur_tpu_torch.ssf import SSFSample, SSFSpan
from veneur_tpu_torch.utils.http import default_opener, json_body, post_bytes

log = logging.getLogger("veneur_tpu_torch.sinks.datadog")

DEFAULT_SPAN_BUFFER_SIZE = 1 << 14


class DatadogMetricSink(MetricSink):
    def __init__(
        self,
        interval: float,
        flush_max_per_body: int,
        hostname: str,
        tags: list[str],
        dd_hostname: str,
        api_key: str,
        metric_name_prefix_drops: Optional[list[str]] = None,
        exclude_tags_prefix_by_prefix_metric: Optional[dict] = None,
        excluded_tags: Optional[list[str]] = None,
        opener=default_opener,
        delivery=None,
    ) -> None:
        self.interval = interval
        self.flush_max_per_body = flush_max_per_body or 25000
        self.hostname = hostname
        self.tags = list(tags)
        self.dd_hostname = dd_hostname.rstrip("/")
        self.api_key = api_key
        self.metric_name_prefix_drops = metric_name_prefix_drops or []
        self.exclude_tags_prefix_by_prefix_metric = (
            exclude_tags_prefix_by_prefix_metric or {})
        self.excluded_tags = list(excluded_tags or [])
        self.opener = opener
        self.delivery = make_manager("datadog", delivery)
        self.flushed_metrics = 0
        self.flush_errors = 0
        # host tags are immutable per process: serialize them for the
        # native body emitter once, not per flush
        self._common_tags_json = self._build_common_tags()

    def name(self) -> str:
        return "datadog"

    def _build_common_tags(self) -> bytes:
        """The pre-serialized common-tag JSON run ("t1","t2",...) every
        native series body shares."""
        return ",".join(
            json.dumps(t) for t in self.tags
            if not any(t.startswith(e) for e in self.excluded_tags)
        ).encode("utf-8")

    def set_excluded_tags(self, excluded: list[str]) -> None:
        self.excluded_tags = list(excluded)
        self._common_tags_json = self._build_common_tags()

    # -- conversion (reference finalizeMetrics :256-384) --------------------

    def _finalize_one(self, name: str, value: float, mtags: list[str],
                      mtype, ts: int, message: str,
                      dd_metrics: list, checks: list) -> None:
        if any(name.startswith(p) for p in self.metric_name_prefix_drops):
            return
        per_metric_excludes: list[str] = []
        for prefix, extags in (
            self.exclude_tags_prefix_by_prefix_metric.items()
        ):
            if name.startswith(prefix):
                per_metric_excludes = list(extags)
                break

        tags = [
            t for t in self.tags
            if not any(t.startswith(e) for e in self.excluded_tags)
        ]
        hostname = ""
        devicename = ""
        for tag in mtags:
            if tag.startswith("host:"):
                hostname = tag[5:]
            elif tag.startswith("device:"):
                devicename = tag[7:]
            elif any(tag.startswith(e) for e in self.excluded_tags):
                continue
            elif any(tag.startswith(e) for e in per_metric_excludes):
                continue
            else:
                tags.append(tag)
        if not hostname:
            hostname = self.hostname

        if mtype == MetricType.STATUS:
            checks.append({
                "check": name,
                "message": message,
                "timestamp": ts,
                "tags": tags,
                "status": int(value),
                "host_name": hostname,
            })
            return

        if mtype == MetricType.COUNTER:
            # counters are reported to Datadog as rates
            metric_type = "rate"
            value = value / self.interval
        elif mtype == MetricType.GAUGE:
            metric_type = "gauge"
        else:
            return

        if not math.isfinite(value):
            # json.dumps would emit bare NaN/Infinity — invalid JSON the
            # intake rejects; the native emitter writes null, match it
            value = None

        dd_metrics.append({
            "metric": name,
            "points": [[ts, value]],
            "tags": tags,
            "type": metric_type,
            "interval": int(self.interval),
            "host": hostname,
            "device_name": devicename,
        })

    def _finalize(self, metrics: list[InterMetric]
                  ) -> tuple[list[dict], list[dict]]:
        dd_metrics: list[dict] = []
        checks: list[dict] = []
        for m in metrics:
            self._finalize_one(m.name, m.value, m.tags, m.type,
                               m.timestamp, m.message, dd_metrics, checks)
        return dd_metrics, checks

    # -- flushing (reference Flush :112-160, chunked parallel posts) --------

    supports_columnar = True
    supports_native_emit = True

    def _finalize_group(self, g, ts: int, excluded_tags,
                        dd_metrics: list, checks: list) -> None:
        """Per-row Python formatter for one column group (the fallback
        when the native emit tier can't take it)."""
        for fam in g.families:
            suffix = fam.suffix
            vals = fam.values.tolist()
            for i in g.rows_for(fam).tolist():
                name, tags, sinks = g.meta_at(i)
                if g.has_routing and sinks is not None \
                        and self.name() not in sinks:
                    continue
                if excluded_tags:
                    tags = [t for t in tags
                            if t.split(":", 1)[0] not in excluded_tags]
                self._finalize_one(
                    name + suffix if suffix else name, vals[i],
                    tags, fam.type, ts, "", dd_metrics, checks)

    def _finalize_extras(self, batch, excluded_tags,
                         dd_metrics: list, checks: list) -> None:
        # extras (status checks) need message/hostname fields
        from veneur_tpu_torch.sinks import filter_routed, strip_excluded_tags

        for m in strip_excluded_tags(
                filter_routed(batch.extras, self.name()),
                excluded_tags):
            self._finalize_one(m.name, m.value, m.tags, m.type,
                               m.timestamp, m.message, dd_metrics, checks)

    def flush_columnar(self, batch, excluded_tags=None) -> None:
        """Columnar Python path (core/columnar.py): per-row dict
        building straight off the batch columns — no InterMetric
        objects. The native serializer path is flush_columnar_native;
        the server negotiates between the two per flush."""
        dd_metrics: list[dict] = []
        checks: list[dict] = []
        for g in batch.groups:
            self._finalize_group(g, batch.timestamp, excluded_tags,
                                 dd_metrics, checks)
        self._finalize_extras(batch, excluded_tags, dd_metrics, checks)
        self._post_all(dd_metrics, checks)

    def flush_columnar_native(self, batch, excluded_tags=None) -> bool:
        """Native emit path (native/emit.cpp): the chunked
        {"series": [...]} JSON bodies — deflate included — are built by
        vn_encode_datadog_series/vn_deflate_chunks straight from the
        batch's frag arenas and value columns, GIL released throughout.
        Groups the native tier can't take (routing, separator-laden
        names) go through the Python formatter; returns False (nothing
        flushed) when the whole path is unavailable or a configured
        feature (per-metric-prefix tag excludes) isn't covered."""
        from veneur_tpu_torch import native as native_mod

        if (self.exclude_tags_prefix_by_prefix_metric
                or not native_mod.emit_available()):
            return False
        plans = batch.emit_plan()

        dd_metrics: list[dict] = []
        checks: list[dict] = []
        bodies: list[bytes] = []
        native_count = 0
        excl_keys = sorted(excluded_tags) if excluded_tags else []

        for g, plan in zip(batch.groups, plans):
            out = None
            if plan is not None:
                out = native_mod.encode_datadog_series(
                    plan.meta_blob, plan.nrows, plan.suffixes,
                    plan.family_types, plan.values, plan.masks,
                    batch.timestamp, self.interval, self.hostname,
                    self._common_tags_json, excl_keys,
                    self.excluded_tags, self.metric_name_prefix_drops,
                    self.flush_max_per_body, compress=True)
            if out is None:
                # no plan for this group (or the library raced away):
                # python formatter
                self._finalize_group(g, batch.timestamp, excluded_tags,
                                     dd_metrics, checks)
                continue
            body_chunks, emitted = out
            bodies.extend(body_chunks)
            native_count += emitted

        self._finalize_extras(batch, excluded_tags, dd_metrics, checks)
        self._post_all(dd_metrics, checks, bodies, native_count,
                       precompressed=True)
        return True

    def flush(self, metrics: list[InterMetric]) -> None:
        dd_metrics, checks = self._finalize(metrics)
        self._post_all(dd_metrics, checks)

    def _deliver(self, url: str, body: bytes, headers: dict,
                 count: int, what: str) -> None:
        """Hand one serialized body to the delivery layer; the sink's
        own flushed counter advances inside the send closure so a
        spilled body delivered a later interval still counts."""
        # every body carries a crash-stable idempotency key: the header
        # is journaled WITH the body (HttpEnvelope below), so a replayed
        # POST after SIGKILL reuses the key and an idempotent receiver
        # can 2xx the replay without double-counting
        headers = dict(headers)
        headers["Idempotency-Key"] = self.delivery.mint_key()

        def send(timeout: float) -> None:
            post_bytes(url, body, headers, timeout, self.opener)
            self.flushed_metrics += count

        # the envelope is the entry's durable context: when a spill
        # journal is attached (core/server.py), a spilled body survives
        # SIGKILL and is re-POSTed by the next incarnation
        env = HttpEnvelope(url=url, body=body, headers=headers, count=count)
        if self.delivery.deliver(send, len(body), payload=env) != "delivered":
            self.flush_errors += 1
            log.warning("datadog %s post not delivered this flush", what)

    def _post_all(self, dd_metrics: list[dict], checks: list[dict],
                  raw_bodies: Optional[list[bytes]] = None,
                  raw_count: int = 0, precompressed: bool = False) -> None:
        self.delivery.begin_flush()
        self.delivery.retry_spill()
        threads = []
        if raw_bodies:
            # bodies are chunked at flush_max_per_body, so every body but
            # the last is full
            per = self.flush_max_per_body
            for bi, body in enumerate(raw_bodies):
                share = (per if bi < len(raw_bodies) - 1
                         else raw_count - per * (len(raw_bodies) - 1))
                t = threading.Thread(
                    target=self._post_raw_body,
                    args=(body, share, precompressed),
                    daemon=True)
                t.start()
                threads.append(t)
        for i in range(0, len(dd_metrics), self.flush_max_per_body):
            chunk = dd_metrics[i:i + self.flush_max_per_body]
            t = threading.Thread(
                target=self._post_series, args=(chunk,), daemon=True)
            t.start()
            threads.append(t)
        for check in checks:
            body, hdrs = json_body(check)
            self._deliver(
                f"{self.dd_hostname}/api/v1/check_run"
                f"?api_key={self.api_key}",
                body, hdrs, 0, "check_run")
        for t in threads:
            t.join(timeout=30)

    def _post_raw_body(self, body: bytes, count: int,
                       precompressed: bool = False) -> None:
        """POST one pre-built {"series": [...]} JSON body (the native
        emitter's output), deflate-compressed like post_json does —
        already compressed GIL-free by the native tier when
        ``precompressed``."""
        import zlib as _zlib

        self._deliver(
            f"{self.dd_hostname}/api/v1/series?api_key={self.api_key}",
            body if precompressed else _zlib.compress(body),
            {"Content-Type": "application/json",
             "Content-Encoding": "deflate"},
            count, "series")

    def _post_series(self, chunk: list[dict]) -> None:
        body, hdrs = json_body({"series": chunk}, compress=True)
        self._deliver(
            f"{self.dd_hostname}/api/v1/series?api_key={self.api_key}",
            body, hdrs, len(chunk), "series")

    # -- events (reference FlushOtherSamples :162-253) ----------------------

    def flush_other_samples(self, samples: list[SSFSample]) -> None:
        events = []
        for s in samples:
            if ddproto.EVENT_IDENTIFIER_KEY not in s.tags:
                continue
            tags = {
                k: v for k, v in s.tags.items()
                if k != ddproto.EVENT_IDENTIFIER_KEY
            }
            event = {
                "title": s.name,
                "text": s.message,
                "date_happened": s.timestamp,
                "tags": [
                    f"{k}:{v}" if v else k
                    for k, v in tags.items()
                    if not k.startswith("vdogstatsd_")
                ] + self.tags,
            }
            if ddproto.EVENT_HOSTNAME_TAG_KEY in tags:
                event["host"] = tags[ddproto.EVENT_HOSTNAME_TAG_KEY]
            if ddproto.EVENT_AGGREGATION_KEY_TAG_KEY in tags:
                event["aggregation_key"] = (
                    tags[ddproto.EVENT_AGGREGATION_KEY_TAG_KEY])
            if ddproto.EVENT_PRIORITY_TAG_KEY in tags:
                event["priority"] = tags[ddproto.EVENT_PRIORITY_TAG_KEY]
            if ddproto.EVENT_SOURCE_TYPE_TAG_KEY in tags:
                event["source_type_name"] = (
                    tags[ddproto.EVENT_SOURCE_TYPE_TAG_KEY])
            if ddproto.EVENT_ALERT_TYPE_TAG_KEY in tags:
                event["alert_type"] = tags[ddproto.EVENT_ALERT_TYPE_TAG_KEY]
            events.append(event)
        if not events:
            return
        body, hdrs = json_body({"events": {"api": events}})
        self._deliver(f"{self.dd_hostname}/intake?api_key={self.api_key}",
                      body, hdrs, 0, "event")


class DatadogSpanSink(SpanSink):
    """Buffers spans in a bounded ring and flushes them to the Datadog
    trace-agent API (reference datadogSpanSink, ring buffer :32)."""

    def __init__(self, trace_api_address: str,
                 buffer_size: int = DEFAULT_SPAN_BUFFER_SIZE,
                 opener=default_opener, delivery=None) -> None:
        self.trace_api_address = trace_api_address.rstrip("/")
        self.buffer: "collections.deque[SSFSpan]" = collections.deque(
            maxlen=buffer_size)
        self._lock = threading.Lock()
        self.opener = opener
        self.delivery = make_manager("datadog_spans", delivery)
        self.spans_flushed = 0
        self.flush_errors = 0

    def name(self) -> str:
        return "datadog"

    def ingest(self, span: SSFSpan) -> None:
        with self._lock:
            self.buffer.append(span)

    def flush(self) -> None:
        with self._lock:
            spans = list(self.buffer)
            self.buffer.clear()
        if not spans:
            return
        traces: dict[int, list[dict]] = {}
        for s in spans:
            traces.setdefault(s.trace_id, []).append({
                "trace_id": s.trace_id,
                "span_id": s.id,
                "parent_id": s.parent_id,
                "start": s.start_timestamp,
                "duration": s.end_timestamp - s.start_timestamp,
                "name": s.name,
                "resource": s.tags.get("resource", s.name),
                "service": s.service,
                "error": 1 if s.error else 0,
                "meta": dict(s.tags),
            })
        self.delivery.begin_flush()
        self.delivery.retry_spill()
        body, hdrs = json_body(list(traces.values()))
        hdrs = dict(hdrs)
        hdrs["Idempotency-Key"] = self.delivery.mint_key()

        def send(timeout: float) -> None:
            post_bytes(f"{self.trace_api_address}/v0.3/traces",
                       body, hdrs, timeout, self.opener)
            self.spans_flushed += len(spans)

        env = HttpEnvelope(url=f"{self.trace_api_address}/v0.3/traces",
                           body=body, headers=hdrs, count=len(spans))
        if self.delivery.deliver(send, len(body), payload=env) != "delivered":
            self.flush_errors += 1
            log.warning("datadog trace post not delivered this flush")
