"""Span-submission client with backpressure.

Parity: reference trace/client.go:56-575 — Record pushes spans into a
bounded channel and DROPS (ErrWouldBlock) instead of blocking when the
pipeline is saturated; N backend threads drain the channel to the network.
Backends (trace/backend.go:46-240): UDP packet backend (one datagram per
span) and buffered unix-stream backend (framed SSF, flushed on demand),
both reconnecting with linear backoff and discarding the poison span.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Optional

from veneur_tpu_torch import ssf
from veneur_tpu_torch.protocol import ssf_wire


class ErrWouldBlock(Exception):
    """The client's buffer is full; the span was dropped."""


class Backend:
    def send(self, span: ssf.SSFSpan) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class NoOpBackend(Backend):
    def send(self, span: ssf.SSFSpan) -> None:
        pass


class ChannelBackend(Backend):
    """Delivers spans to an in-process queue (reference trace/testbackend
    and NewChannelClient, used for a server's internal telemetry loop)."""

    def __init__(self, out: "queue.Queue[ssf.SSFSpan]",
                 send_error: Optional[Exception] = None) -> None:
        self.out = out
        self.send_error = send_error

    def send(self, span: ssf.SSFSpan) -> None:
        if self.send_error is not None:
            raise self.send_error
        self.out.put(span)


class _ReconnectingBackend(Backend):
    """Shared reconnect-with-linear-backoff behavior
    (reference trace/backend.go:71-91)."""

    def __init__(self, backoff_s: float = 0.2, max_backoff_s: float = 5.0
                 ) -> None:
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self._failures = 0

    def _connect(self):
        raise NotImplementedError

    def _ensure_connected(self):
        while True:
            try:
                self._connect()
                self._failures = 0
                return
            except OSError:
                self._failures += 1
                delay = min(self.backoff_s * self._failures,
                            self.max_backoff_s)
                time.sleep(delay)


class UDPBackend(Backend):
    """One datagram per span; no connection state to speak of."""

    def __init__(self, address: tuple[str, int]) -> None:
        self.address = address
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, span: ssf.SSFSpan) -> None:
        self.sock.sendto(ssf_wire.encode_datagram(span), self.address)

    def close(self) -> None:
        self.sock.close()


class UnixBackend(_ReconnectingBackend):
    """Buffered framed-SSF unix-stream backend; a failed write discards
    the poison span and reconnects (reference trace/backend.go:150-240)."""

    def __init__(self, path: str, **kw) -> None:
        super().__init__(**kw)
        self.path = path
        self._sock: Optional[socket.socket] = None
        self._file = None

    def _connect(self):
        if self._sock is not None:
            return
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(self.path)
        self._sock = sock
        self._file = sock.makefile("wb")

    def send(self, span: ssf.SSFSpan) -> None:
        self._ensure_connected()
        try:
            ssf_wire.write_ssf(self._file, span)
        except OSError:
            # discard the poison span, force a reconnect for the next one
            self.close()
            self._ensure_connected()

    def flush(self) -> None:
        if self._file is not None:
            try:
                self._file.flush()
            except OSError:
                self.close()

    def close(self) -> None:
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._file = None


class Client:
    """Buffered span pump: Record → channel → backend threads."""

    def __init__(self, backend: Backend, capacity: int = 1024,
                 num_backends: int = 1) -> None:
        self.backend = backend
        self.chan: "queue.Queue[Optional[ssf.SSFSpan]]" = queue.Queue(capacity)
        self.records_dropped = 0
        self.records_sent = 0
        self._threads = []
        self._closed = False
        for i in range(num_backends):
            t = threading.Thread(target=self._drain, daemon=True,
                                 name=f"trace-backend-{i}")
            t.start()
            self._threads.append(t)

    def _drain(self) -> None:
        while True:
            span = self.chan.get()
            if span is None:
                return
            try:
                self.backend.send(span)
                self.records_sent += 1
            except Exception:
                self.records_dropped += 1

    def record(self, span: ssf.SSFSpan) -> None:
        """Enqueue a span; raises ErrWouldBlock (after counting the drop)
        when the buffer is full (reference Record, trace/client.go:484-511).
        """
        if self._closed:
            raise ErrWouldBlock("client closed")
        try:
            self.chan.put_nowait(span)
        except queue.Full:
            self.records_dropped += 1
            raise ErrWouldBlock("trace client buffer full") from None

    def flush(self) -> None:
        """Drain-and-flush barrier (reference Flush, trace/client.go:521).
        Waits for the queue to empty, then flushes the backend."""
        deadline = time.time() + 5.0
        while not self.chan.empty() and time.time() < deadline:
            time.sleep(0.005)
        self.backend.flush()

    def close(self) -> None:
        self._closed = True
        for _ in self._threads:
            self.chan.put(None)
        for t in self._threads:
            t.join(timeout=2)
        self.backend.close()


def neutralize_client(client: Client) -> None:
    """Disarm a client so tests produce no telemetry
    (reference NeutralizeClient, trace/client.go:422-427)."""
    client.backend = NoOpBackend()
