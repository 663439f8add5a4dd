"""New Relic sinks: metrics as Insights events, spans to the trace API.

Parity: reference sinks/newrelic/newrelic.go — flushed metrics become
Insights custom events of a configured event type with common tags; spans
go to the distributed-tracing API.
"""

from __future__ import annotations

import logging

from veneur_tpu_torch.core.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import MetricSink, SpanSink
from veneur_tpu_torch.ssf import SSFSpan
from veneur_tpu_torch.utils.http import default_opener, post_json

log = logging.getLogger("veneur_tpu_torch.sinks.newrelic")

_REGION_INSERT = {
    "": "https://insights-collector.newrelic.com",
    "us": "https://insights-collector.newrelic.com",
    "eu": "https://insights-collector.eu01.nr-data.net",
}


class NewRelicMetricSink(MetricSink):
    def __init__(self, account_id: int, insert_key: str,
                 event_type: str = "veneur",
                 service_check_event_type: str = "veneurCheck",
                 common_tags: list[str] | None = None,
                 region: str = "", opener=default_opener) -> None:
        self.account_id = account_id
        self.insert_key = insert_key
        self.event_type = event_type or "veneur"
        self.service_check_event_type = (
            service_check_event_type or "veneurCheck")
        self.common_tags = common_tags or []
        base = _REGION_INSERT.get(region, _REGION_INSERT[""])
        self.url = f"{base}/v1/accounts/{account_id}/events"
        self.opener = opener
        self.flushed_metrics = 0
        self.flush_errors = 0

    def name(self) -> str:
        return "newrelic"

    def flush(self, metrics: list[InterMetric]) -> None:
        events = []
        for m in metrics:
            event_type = (self.service_check_event_type
                          if m.type == MetricType.STATUS else self.event_type)
            event = {
                "eventType": event_type,
                "name": m.name,
                "value": m.value,
                "timestamp": m.timestamp,
                "metricType": m.type.name.lower(),
            }
            for tag in list(m.tags) + self.common_tags:
                k, _, v = tag.partition(":")
                event.setdefault(k, v)
            if m.hostname:
                event["hostname"] = m.hostname
            if m.message:
                event["message"] = m.message
            events.append(event)
        if not events:
            return
        try:
            post_json(self.url, events,
                      headers={"X-Insert-Key": self.insert_key},
                      compress=True, opener=self.opener)
            self.flushed_metrics += len(events)
        except Exception as e:
            self.flush_errors += 1
            log.warning("newrelic insights post failed: %s", e)


class NewRelicSpanSink(SpanSink):
    def __init__(self, insert_key: str, trace_observer_url: str = "",
                 common_tags: list[str] | None = None,
                 opener=default_opener) -> None:
        self.insert_key = insert_key
        self.url = (trace_observer_url
                    or "https://trace-api.newrelic.com/trace/v1")
        self.common_tags = common_tags or []
        self.opener = opener
        self._buffer: list[SSFSpan] = []
        self.spans_flushed = 0
        self.flush_errors = 0

    def name(self) -> str:
        return "newrelic"

    def ingest(self, span: SSFSpan) -> None:
        self._buffer.append(span)

    def flush(self) -> None:
        spans, self._buffer = self._buffer, []
        if not spans:
            return
        payload = [{
            "common": {"attributes": dict(
                t.partition(":")[::2] for t in self.common_tags)},
            "spans": [{
                "trace.id": str(s.trace_id),
                "id": str(s.id),
                "attributes": {
                    "parent.id": str(s.parent_id),
                    "service.name": s.service,
                    "name": s.name,
                    "duration.ms": (s.end_timestamp - s.start_timestamp)
                    / 1e6,
                    "error": s.error,
                    **s.tags,
                },
                "timestamp": s.start_timestamp // 1_000_000,
            } for s in spans],
        }]
        try:
            post_json(self.url, payload,
                      headers={"Api-Key": self.insert_key,
                               "Data-Format": "newrelic",
                               "Data-Format-Version": "1"},
                      opener=self.opener)
            self.spans_flushed += len(spans)
        except Exception as e:
            self.flush_errors += 1
            log.warning("newrelic trace post failed: %s", e)
