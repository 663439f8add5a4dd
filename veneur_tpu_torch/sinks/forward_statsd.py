"""Forward-statsd sink: re-emits flushed metrics as DogStatsD lines.

The reference's flush-to-statsd forwarding (veneur as a relay in front
of another DogStatsD-speaking aggregator) re-ingests flushed series
downstream, so — unlike the prometheus statsd-exporter repeater — names
and tags travel VERBATIM: any sanitization here would change series
identity at the next hop.

The native emit tier (vn_encode_forward_lines) builds the whole line
blob in one GIL-free pass; the Python formatter below is pinned
byte-identical by tests/test_emit_parity.py.
"""

from __future__ import annotations

import logging
import socket
from typing import Optional

from veneur_tpu_torch.core.metrics import InterMetric, MetricType
from veneur_tpu_torch.sinks import MetricSink
from veneur_tpu_torch.sinks.delivery import make_manager

log = logging.getLogger("veneur_tpu_torch.sinks.forward_statsd")


def forward_line(name: str, value: float, tags: list[str], kind: str
                 ) -> bytes:
    line = f"{name}:{value}|{kind}"
    if tags:
        line += "|#" + ",".join(tags)
    return line.encode("utf-8")


class ForwardStatsdSink(MetricSink):
    supports_columnar = True
    supports_native_emit = True

    def __init__(self, address: str, network_type: str = "udp",
                 flush_timeout_s: float = 10.0, delivery=None) -> None:
        host, _, port = address.rpartition(":")
        self.address = (host or "127.0.0.1", int(port))
        self.network_type = network_type
        self.flush_timeout_s = flush_timeout_s
        self._sock: Optional[socket.socket] = None
        self.delivery = make_manager("forward_statsd", delivery)
        self.flushed_metrics = 0
        self.flush_errors = 0

    def name(self) -> str:
        return "forward_statsd"

    def _connect(self, timeout: Optional[float] = None) -> socket.socket:
        if self._sock is None:
            if self.network_type == "udp":
                self._sock = socket.socket(socket.AF_INET,
                                           socket.SOCK_DGRAM)
                self._sock.connect(self.address)
            else:
                self._sock = socket.create_connection(
                    self.address, timeout=timeout or self.flush_timeout_s)
        return self._sock

    @staticmethod
    def _kind(mtype) -> Optional[str]:
        if mtype == MetricType.COUNTER:
            return "c"
        if mtype == MetricType.GAUGE:
            return "g"
        return None  # status checks don't survive a statsd hop

    def flush(self, metrics: list[InterMetric]) -> None:
        lines = []
        for m in metrics:
            kind = self._kind(m.type)
            if kind is not None:
                lines.append(forward_line(m.name, m.value, m.tags, kind))
        self._send(lines)

    def _group_lines(self, g, excluded_tags, append) -> None:
        for fam in g.families:
            kind = self._kind(fam.type)
            if kind is None:
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
                append(forward_line(
                    name + suffix if suffix else name, vals[i], tags,
                    kind))

    def _extra_lines(self, batch, excluded_tags, append) -> None:
        for m in batch.extras:
            if m.sinks is not None and self.name() not in m.sinks:
                continue
            kind = self._kind(m.type)
            if kind is None:
                continue
            tags = m.tags
            if excluded_tags:
                tags = [t for t in tags
                        if t.split(":", 1)[0] not in excluded_tags]
            append(forward_line(m.name, m.value, tags, kind))

    def flush_columnar(self, batch, excluded_tags=None) -> None:
        lines: list[bytes] = []
        for g in batch.groups:
            self._group_lines(g, excluded_tags, lines.append)
        self._extra_lines(batch, excluded_tags, lines.append)
        self._send(lines)

    def flush_columnar_native(self, batch, excluded_tags=None) -> bool:
        from veneur_tpu_torch import native as native_mod

        if not native_mod.emit_available():
            return False
        plans = batch.emit_plan()
        lines: list[bytes] = []
        excl = sorted(excluded_tags) if excluded_tags else []
        for g, plan in zip(batch.groups, plans):
            out = None
            if plan is not None:
                out = native_mod.encode_forward_lines(
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

    # max UDP datagram payload (multi-line datagrams, jumbo-frame safe)
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
            log.warning("forward statsd send not delivered this flush")
