"""Scoped statsd client for self-telemetry.

TPU-native equivalent of the reference's ``scopedstatsd/client.go:13-119``:
a DogStatsD client wrapper that force-appends per-metric-type scope tags
(``veneurlocalonly:true`` / ``veneurglobalonly:true``) as configured by
``veneur_metrics_scopes`` (reference config.go / README), so the server's
own metrics are aggregated at the intended tier without write-amplification.

The underlying transport is pluggable: UDP to ``stats_address`` (the
reference points datadog-go at veneur's own listen address), or a loopback
sender that feeds the server's packet handler directly (used for tests and
for zero-copy self-ingestion on the same process).
"""

from __future__ import annotations

import logging
import socket
from typing import Callable, Iterable, Optional

from veneur_tpu_torch.core.config import MetricsScopes

log = logging.getLogger(__name__)

# scope strings accepted in veneur_metrics_scopes (reference ssf.SSFSample_Scope)
SCOPE_LOCAL = "local"
SCOPE_GLOBAL = "global"

_SCOPE_TAG = {
    SCOPE_LOCAL: "veneurlocalonly:true",
    SCOPE_GLOBAL: "veneurglobalonly:true",
}


_INJECT = str.maketrans({"|": "_", "\n": "_"})


def _clean(s: str) -> str:
    """Strip statsd framing bytes from untrusted name/tag content —
    without this, a hostile tag value (e.g. an SSF service name) forges
    extra metric lines in the outgoing stats stream."""
    return s.translate(_INJECT) if ("|" in s or "\n" in s) else s


def _format_line(name: str, value, mtype: str, tags: Iterable[str],
                 rate: float) -> str:
    """Render one DogStatsD line: ``name:value|type[|@rate][|#t1,t2]``."""
    parts = [f"{_clean(name)}:{value}|{mtype}"]
    if rate != 1.0:
        parts.append(f"@{rate}")
    tags = [_clean(t) for t in tags if t]
    if tags:
        parts.append("#" + ",".join(tags))
    return "|".join(parts)


class Sender:
    """Transport for rendered statsd lines."""

    def send(self, line: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSender(Sender):
    def send(self, line: str) -> None:
        pass


class UDPSender(Sender):
    """Fire-and-forget UDP datagrams to ``stats_address``."""

    def __init__(self, address: str) -> None:
        raw = address
        if address.startswith("udp://"):
            address = address[len("udp://"):]
        host, port = "127.0.0.1", 8125
        try:
            if address.startswith("["):  # [::1]:8125
                host, _, rest = address[1:].partition("]")
                if rest.startswith(":"):
                    port = int(rest[1:])
            elif ":" in address:
                host, _, p = address.rpartition(":")
                port = int(p)
            elif address.isdigit():  # bare port, e.g. "8125"
                port = int(address)
            elif address:
                host = address
            info = socket.getaddrinfo(host, port, socket.AF_UNSPEC,
                                      socket.SOCK_DGRAM)[0]
        except (OSError, ValueError) as e:
            raise ValueError(f"invalid stats_address {raw!r}: {e}") from e
        self._addr = info[4]
        self._sock = socket.socket(info[0], socket.SOCK_DGRAM)

    def send(self, line: str) -> None:
        try:
            self._sock.sendto(line.encode("utf-8"), self._addr)
        except OSError as e:  # self-telemetry is expendable, like the reference
            log.debug("statsd send failed: %s", e)

    def close(self) -> None:
        self._sock.close()


class LoopbackSender(Sender):
    """Feeds lines straight into a packet handler (a ``Server`` on the same
    process), skipping the kernel round-trip the reference pays when it
    points its statsd client at its own UDP listener."""

    def __init__(self, handle_packet: Callable[[bytes], None]) -> None:
        self._handle = handle_packet

    def send(self, line: str) -> None:
        try:
            self._handle(line.encode("utf-8"))
        except Exception as e:
            log.debug("loopback statsd send failed: %s", e)


class CaptureSender(Sender):
    """Test sender that records every rendered line."""

    def __init__(self) -> None:
        self.lines: list[str] = []

    def send(self, line: str) -> None:
        self.lines.append(line)


class ScopedClient:
    """DogStatsD client with per-type scope tags
    (reference scopedstatsd.ScopedClient, scopedstatsd/client.go:40-111)."""

    def __init__(self, sender: Optional[Sender] = None,
                 add_tags: Optional[list[str]] = None,
                 scopes: Optional[MetricsScopes] = None,
                 namespace: str = "") -> None:
        self._sender = sender or NullSender()
        self._add_tags = list(add_tags or [])
        self._scopes = scopes or MetricsScopes()
        self._namespace = namespace

    def _emit(self, name: str, value, mtype: str,
              tags: Optional[list[str]], rate: float, scope: str) -> None:
        name = self._namespace + name
        all_tags = list(tags or []) + self._add_tags
        scope_tag = _SCOPE_TAG.get(scope)
        if scope_tag:
            all_tags.append(scope_tag)
        self._sender.send(_format_line(name, value, mtype, all_tags, rate))

    # the reference Client interface (scopedstatsd/client.go:13-20)
    def gauge(self, name: str, value: float,
              tags: Optional[list[str]] = None, rate: float = 1.0) -> None:
        self._emit(name, value, "g", tags, rate, self._scopes.gauge)

    def count(self, name: str, value: int,
              tags: Optional[list[str]] = None, rate: float = 1.0) -> None:
        self._emit(name, value, "c", tags, rate, self._scopes.counter)

    def incr(self, name: str,
             tags: Optional[list[str]] = None, rate: float = 1.0) -> None:
        self.count(name, 1, tags, rate)

    def histogram(self, name: str, value: float,
                  tags: Optional[list[str]] = None, rate: float = 1.0) -> None:
        self._emit(name, value, "h", tags, rate, self._scopes.histogram)

    def timing(self, name: str, seconds: float,
               tags: Optional[list[str]] = None, rate: float = 1.0) -> None:
        """Reports in milliseconds, like datadog-go's Timing."""
        self._emit(name, seconds * 1000.0, "ms", tags, rate,
                   self._scopes.histogram)

    def time_in_nanoseconds(self, name: str, ns: float,
                            tags: Optional[list[str]] = None,
                            rate: float = 1.0) -> None:
        self._emit(name, ns, "ms", tags, rate, self._scopes.histogram)

    def set(self, name: str, value: str,
            tags: Optional[list[str]] = None, rate: float = 1.0) -> None:
        self._emit(name, value, "s", tags, rate, self._scopes.set)

    def close(self) -> None:
        self._sender.close()


def ensure(client: Optional[ScopedClient]) -> ScopedClient:
    """Nil-safe accessor (reference scopedstatsd.Ensure)."""
    return client if client is not None else ScopedClient()
