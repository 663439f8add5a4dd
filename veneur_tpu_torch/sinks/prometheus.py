"""Prometheus sink: statsd repeater to a prometheus statsd-exporter.

Parity: reference sinks/prometheus/prometheus.go — each flushed metric is
re-emitted as a DogStatsD line to a statsd_exporter address over UDP or
TCP; metric names and tags are sanitized to the exporter's accepted
character set.
"""

from __future__ import annotations

import logging
import socket
from typing import Optional

from veneur_tpu_torch.core.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import MetricSink
from veneur_tpu_torch.sinks.delivery import make_manager
from veneur_tpu_torch.sinks.journal_codec import HttpEnvelope

# the exposition-text formatter lives in sinks/exposition.py so the
# live query surface (veneur_tpu/query/http.py) and this sink serialize
# series identically; the names are re-exported here for compatibility
from veneur_tpu_torch.sinks.exposition import (  # noqa: F401
    expo_sample,
    expo_value,
    render_columnar,
    render_metrics,
    sanitize_name,
    sanitize_tag,
)

log = logging.getLogger("veneur_tpu_torch.sinks.prometheus")


class PrometheusMetricSink(MetricSink):
    supports_columnar = True

    def __init__(self, repeater_address: str, network_type: str = "tcp",
                 flush_timeout_s: float = 10.0, delivery=None) -> None:
        host, _, port = repeater_address.rpartition(":")
        self.address = (host or "127.0.0.1", int(port))
        self.network_type = network_type
        self.flush_timeout_s = flush_timeout_s
        self._sock: Optional[socket.socket] = None
        self.delivery = make_manager("prometheus", delivery)
        self.flushed_metrics = 0
        self.flush_errors = 0

    def name(self) -> str:
        return "prometheus"

    def _connect(self, timeout: Optional[float] = None) -> socket.socket:
        if self._sock is None:
            if self.network_type == "udp":
                self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                self._sock.connect(self.address)
            else:
                self._sock = socket.create_connection(
                    self.address, timeout=timeout or self.flush_timeout_s)
        return self._sock

    def _statsd_line(self, m: InterMetric) -> Optional[bytes]:
        if m.type == MetricType.COUNTER:
            kind = "c"
        elif m.type == MetricType.GAUGE:
            kind = "g"
        else:
            return None  # statsd_exporter has no service-check concept
        line = f"{sanitize_name(m.name)}:{m.value}|{kind}"
        if m.tags:
            line += "|#" + ",".join(sanitize_tag(t) for t in m.tags)
        return line.encode("utf-8")

    def flush(self, metrics: list[InterMetric]) -> None:
        self._send([ln for ln in (self._statsd_line(m) for m in metrics)
                    if ln is not None])

    def _group_lines(self, g, excluded_tags, append) -> None:
        """Per-row Python formatter for one column group (the fallback
        when the native emit tier can't take it)."""
        counter = MetricType.COUNTER
        gauge = MetricType.GAUGE
        for fam in g.families:
            if fam.type == counter:
                kind = "c"
            elif fam.type == gauge:
                kind = "g"
            else:
                continue
            vals = fam.values.tolist()
            suffix = fam.suffix
            for i in g.rows_for(fam).tolist():
                name, tags, sinks = g.meta_at(i)
                if g.has_routing and sinks is not None \
                        and self.name() not in sinks:
                    continue
                if excluded_tags:
                    tags = [t for t in tags
                            if t.split(":", 1)[0] not in excluded_tags]
                line = (f"{sanitize_name(name + suffix if suffix else name)}"
                        f":{vals[i]}|{kind}")
                if tags:
                    line += "|#" + ",".join(
                        sanitize_tag(t) for t in tags)
                append(line.encode("utf-8"))

    def _extra_lines(self, batch, excluded_tags, append) -> None:
        counter = MetricType.COUNTER
        gauge = MetricType.GAUGE
        for m in batch.extras:
            if m.sinks is not None and self.name() not in m.sinks:
                continue
            if m.type == counter:
                kind = "c"
            elif m.type == gauge:
                kind = "g"
            else:
                continue
            tags = m.tags
            if excluded_tags:
                tags = [t for t in tags
                        if t.split(":", 1)[0] not in excluded_tags]
            line = f"{sanitize_name(m.name)}:{m.value}|{kind}"
            if tags:
                line += "|#" + ",".join(sanitize_tag(t) for t in tags)
            append(line.encode("utf-8"))

    def flush_columnar(self, batch, excluded_tags=None) -> None:
        """Columnar Python path: statsd lines straight from the batch
        columns, no InterMetric objects (core/columnar.py). The native
        serializer path is flush_columnar_native; the server negotiates
        between the two per flush."""
        lines: list[bytes] = []
        for g in batch.groups:
            self._group_lines(g, excluded_tags, lines.append)
        self._extra_lines(batch, excluded_tags, lines.append)
        self._send(lines)

    supports_native_emit = True

    def flush_columnar_native(self, batch, excluded_tags=None) -> bool:
        """Native emit path: the whole line blob comes out of
        vn_encode_prometheus_lines in one GIL-free pass over the batch's
        frag arena and value columns. Groups without a plan (routing,
        separator-laden names) fall back to the Python formatter;
        returns False when the native tier is unavailable."""
        from veneur_tpu_torch import native as native_mod

        if not native_mod.emit_available():
            return False
        plans = batch.emit_plan()
        lines: list[bytes] = []
        excl = sorted(excluded_tags) if excluded_tags else []
        for g, plan in zip(batch.groups, plans):
            out = None
            if plan is not None:
                out = native_mod.encode_prometheus_lines(
                    plan.meta_blob, plan.nrows, plan.suffixes,
                    plan.family_types, plan.values, plan.masks, excl)
            if out is None:
                self._group_lines(g, excluded_tags, lines.append)
                continue
            blob, n = out
            if n:
                lines.append(blob)
        self._extra_lines(batch, excluded_tags, lines.append)
        self._send(lines)
        return True

    # max UDP datagram payload: statsd exporters accept multi-line
    # datagrams; stay under a jumbo-frame-safe size
    UDP_DATAGRAM_BYTES = 8192

    def _send(self, lines: list[bytes]) -> None:
        if not lines:
            return
        self.delivery.begin_flush()
        self.delivery.retry_spill()
        sent_lines = sum(e.count(b"\n") + 1 for e in lines)

        def send(timeout: float) -> None:
            try:
                sock = self._connect(timeout)
                if self.network_type == "udp":
                    # entries may be multi-line blobs (native emitter);
                    # repack into datagram-sized, line-aligned chunks
                    for entry in lines:
                        if len(entry) <= self.UDP_DATAGRAM_BYTES:
                            sock.send(entry)
                            continue
                        start = 0
                        n = len(entry)
                        while start < n:
                            end = min(start + self.UDP_DATAGRAM_BYTES, n)
                            if end < n:
                                nl = entry.rfind(b"\n", start, end)
                                if nl > start:
                                    end = nl
                            sock.send(entry[start:end])
                            start = end + (1 if end < n and
                                           entry[end:end + 1] == b"\n"
                                           else 0)
                else:
                    sock.settimeout(timeout)
                    sock.sendall(b"\n".join(lines) + b"\n")
                self.flushed_metrics += sent_lines
            except OSError:
                # stale socket: force a fresh connect on the next attempt
                self._sock = None
                raise

        if self.delivery.deliver(send, sum(len(e) for e in lines)) \
                != "delivered":
            self.flush_errors += 1
            log.warning("prometheus repeater send not delivered this flush")


class PrometheusExpositionSink(MetricSink):
    """Pushgateway-style exposition sink: each flush POSTs one
    text-format body (`name{label="value",...} value` lines) to the
    configured address. Samples are untyped (a pushgateway body carries
    no TYPE/HELP comments); only counters and gauges are expressible.

    The native emit tier (vn_encode_prometheus_exposition) builds the
    whole body in one GIL-free pass; the Python formatter (expo_sample)
    is pinned byte-identical by tests/test_emit_parity.py."""

    supports_columnar = True
    supports_native_emit = True

    def __init__(self, address: str, opener=None, delivery=None) -> None:
        from veneur_tpu_torch.utils.http import default_opener

        self.address = address
        self.opener = opener or default_opener
        self.delivery = make_manager("prometheus", delivery)
        self.flushed_metrics = 0
        self.flush_errors = 0

    def name(self) -> str:
        return "prometheus"

    def flush(self, metrics) -> None:
        body, count = render_metrics(metrics)
        self._post(body, count)

    def flush_columnar(self, batch, excluded_tags=None) -> None:
        body, count = render_columnar(batch, self.name(), excluded_tags,
                                      native=False)
        self._post(body, count)

    def flush_columnar_native(self, batch, excluded_tags=None) -> bool:
        from veneur_tpu_torch import native as native_mod

        if not native_mod.emit_available():
            return False
        body, count = render_columnar(batch, self.name(), excluded_tags,
                                      native=True)
        self._post(body, count)
        return True

    def _post(self, body: bytes, count: int) -> None:
        from veneur_tpu_torch.utils.http import post_bytes

        self.delivery.begin_flush()
        self.delivery.retry_spill()
        if not count:
            return

        hdrs = {"Content-Type": "text/plain; version=0.0.4"}

        def send(timeout: float) -> None:
            post_bytes(self.address, body, hdrs, timeout, self.opener)
            self.flushed_metrics += count

        env = HttpEnvelope(url=self.address, body=body, headers=hdrs,
                           count=count)
        if self.delivery.deliver(send, len(body), payload=env) != "delivered":
            self.flush_errors += 1
            log.warning("prometheus exposition post not delivered "
                        "this flush")
