"""Splunk sink: span events to the HTTP Event Collector (HEC).

Parity: reference sinks/splunk/splunk.go — batched HEC submissions from a
bounded ingest queue drained by N submission workers, probabilistic span
sampling (1/N keep with the trace id as the sampling unit), and real
connection-lifetime jitter: each worker holds a keep-alive HTTP session
and rotates it after a randomized lifetime so a fleet's connections don't
recycle (and re-balance across an LB) in lockstep. stop() performs a
bounded drain (see its docstring) — reference: Stop + hecSubmissionWorker
exit.
"""

from __future__ import annotations

import http.client
import json
import logging
import queue
import random
import ssl
import threading
import time
import urllib.parse
from typing import Optional

from dataclasses import replace

from veneur_tpu_torch.sinks import SpanSink
from veneur_tpu_torch.sinks.delivery import DeliveryPolicy, make_manager
from veneur_tpu_torch.ssf import SSFSpan
from veneur_tpu_torch.utils.http import HTTPError, post_bytes

log = logging.getLogger("veneur_tpu_torch.sinks.splunk")



class _SNIHTTPSConnection(http.client.HTTPSConnection):
    """HTTPS connection that validates the certificate against a
    configured name instead of the dialed host (reference
    splunk.go:111-113: tlsCfg.ServerName = validateServerName)."""

    def __init__(self, *args, server_name: str = "", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._server_name = server_name

    def connect(self) -> None:
        http.client.HTTPConnection.connect(self)
        self.sock = self._context.wrap_socket(
            self.sock, server_hostname=self._server_name or self.host)


class _RotatingSession:
    """Keep-alive HTTP(S) connection that re-establishes itself after a
    jittered lifetime (reference connection lifetime jitter,
    sinks/splunk/splunk.go hecConnectionLifetimeJitter)."""

    def __init__(self, url: str, lifetime_s: float,
                 jitter_s: float, timeout_s: float,
                 server_name: str = "") -> None:
        parsed = urllib.parse.urlsplit(url)
        self.scheme = parsed.scheme
        self.host = parsed.hostname or "localhost"
        self.port = parsed.port
        self.path = parsed.path or "/"
        self.lifetime_s = lifetime_s
        self.jitter_s = jitter_s
        self.timeout_s = timeout_s
        self.server_name = server_name
        self._conn: Optional[http.client.HTTPConnection] = None
        self._expires = 0.0
        self.rotations = 0

    def _connect(self) -> http.client.HTTPConnection:
        if self.scheme == "https":
            conn = _SNIHTTPSConnection(
                self.host, self.port, timeout=self.timeout_s,
                context=ssl.create_default_context(),
                server_name=self.server_name)
        else:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout_s)
        self._expires = (time.monotonic() + self.lifetime_s
                         + random.uniform(0, self.jitter_s))
        return conn

    def post(self, body: bytes, headers: dict[str, str]) -> tuple[int, bytes]:
        if self._conn is None or time.monotonic() >= self._expires:
            self.close()
            self._conn = self._connect()
            self.rotations += 1
        try:
            self._conn.request("POST", self.path, body=body, headers=headers)
        except Exception:
            # send-path failure (stale keep-alive): the server never got a
            # complete request, so one resend cannot duplicate events
            self.close()
            self._conn = self._connect()
            self.rotations += 1
            self._conn.request("POST", self.path, body=body, headers=headers)
        try:
            resp = self._conn.getresponse()
            return resp.status, resp.read()
        except Exception:
            # response-path failure: the server may already have indexed
            # the batch — resending would duplicate it, so surface the
            # error and let the caller count it (per-flush data is
            # expendable; duplication is not)
            self.close()
            raise

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None


class SplunkSpanSink(SpanSink):
    def __init__(
        self,
        hec_address: str,
        token: str,
        hostname: str = "",
        batch_size: int = 100,
        submission_workers: int = 1,
        span_sample_rate: int = 100,  # percent of traces kept
        ingest_timeout_s: float = 0.0,
        send_timeout_s: float = 10.0,
        connection_lifetime_s: float = 60.0,
        connection_lifetime_jitter_s: float = 30.0,
        tls_validate_hostname: str = "",
        opener=None,
        delivery=None,
    ) -> None:
        self.url = hec_address.rstrip("/") + "/services/collector/event"
        self.token = token
        self.hostname = hostname
        self.batch_size = batch_size
        self.span_sample_rate = span_sample_rate
        self.ingest_timeout_s = ingest_timeout_s
        self.send_timeout_s = send_timeout_s
        self.connection_lifetime_s = connection_lifetime_s
        self.connection_lifetime_jitter_s = connection_lifetime_jitter_s
        self.tls_validate_hostname = tls_validate_hostname
        self.opener = opener  # test injection; None = rotating sessions
        if isinstance(delivery, DeliveryPolicy):
            # resending a HEC batch the server may already have indexed
            # would duplicate events (the response-path rule in
            # _RotatingSession.post), so retry and spill are forced off:
            # the delivery layer contributes the breaker and the shared
            # delivery.* stats only
            delivery = replace(delivery, retry_max=0,
                               spill_max_bytes=0, spill_max_payloads=0)
        self.delivery = make_manager("splunk", delivery)
        # send-once semantics extend across incarnations too: a journaled
        # HEC batch replayed after a restart could double-index events the
        # server already accepted, so this manager refuses journal attach
        # (DeliveryManager.attach_journal returns False) no matter what
        # spill_journal_dir says
        self.delivery.journal_exempt = True
        self.queue: "queue.Queue" = queue.Queue(maxsize=batch_size * 16)
        self.spans_flushed = 0
        self.spans_dropped = 0
        self.flush_errors = 0
        self.session_rotations = 0
        self._workers = submission_workers
        self._threads: list[threading.Thread] = []
        self._stopping = threading.Event()

    def name(self) -> str:
        return "splunk"

    def start(self, trace_client=None) -> None:
        for i in range(self._workers):
            t = threading.Thread(target=self._submit_loop, daemon=True,
                                 name=f"splunk-submit-{i}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Bounded-drain shutdown: workers flush what they can within
        ~2 send timeouts; anything still queued after that is counted as
        dropped (per-flush data is expendable) and the workers, being
        daemons, die with the process."""
        if self._stopping.is_set():
            return
        self._stopping.set()
        deadline = time.monotonic() + max(self.send_timeout_s, 1.0) * 2
        for t in self._threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
        undrained = self.queue.qsize()
        if undrained or any(t.is_alive() for t in self._threads):
            self.spans_dropped += undrained
            log.warning("splunk stop: %d spans undrained at deadline",
                        undrained)
        self._threads.clear()

    def ingest(self, span: SSFSpan) -> None:
        if self._stopping.is_set():
            self.spans_dropped += 1
            return
        # sample on trace id so all spans of a trace share a fate
        if self.span_sample_rate < 100 and (
            span.trace_id % 100 >= self.span_sample_rate
        ):
            self.spans_dropped += 1
            return
        try:
            if self.ingest_timeout_s > 0:
                # bounded wait before surrendering the span (reference
                # ingestTimeout: block up to the timeout, then drop)
                self.queue.put(span, timeout=self.ingest_timeout_s)
            else:
                self.queue.put_nowait(span)
        except queue.Full:
            self.spans_dropped += 1

    def _submit_loop(self) -> None:
        session = _RotatingSession(
            self.url, self.connection_lifetime_s,
            self.connection_lifetime_jitter_s, self.send_timeout_s,
            server_name=self.tls_validate_hostname)
        batch: list[SSFSpan] = []
        last_send = time.time()
        while True:
            try:
                item = self.queue.get(timeout=0.2)
            except queue.Empty:
                item = None
            if item is not None:
                batch.append(item)
            # exit condition checked directly (not via a sentinel that a
            # full queue could drop): stopping and nothing left to read
            done = (item is None and self._stopping.is_set()
                    and self.queue.empty())
            if batch and (done or len(batch) >= self.batch_size
                          or time.time() - last_send > 5.0):
                self._send(batch, session)
                batch = []
                last_send = time.time()
            if done:
                break
        session.close()
        self.session_rotations += session.rotations

    def _send(self, batch: list[SSFSpan], session: _RotatingSession) -> None:
        events = []
        for s in batch:
            events.append({
                "time": s.start_timestamp / 1e9,
                "host": self.hostname,
                "sourcetype": "ssf_span",
                "event": {
                    "trace_id": str(s.trace_id),
                    "id": str(s.id),
                    "parent_id": str(s.parent_id),
                    "start_timestamp": s.start_timestamp,
                    "end_timestamp": s.end_timestamp,
                    "duration_ns": s.end_timestamp - s.start_timestamp,
                    "service": s.service,
                    "name": s.name,
                    "error": s.error,
                    "indicator": s.indicator,
                    "tags": dict(s.tags),
                },
            })
        headers = {
            "Authorization": f"Splunk {self.token}",
            "Content-Type": "application/json",
        }
        # HEC accepts newline-concatenated JSON events; a JSON array
        # body carries the same content for our purposes
        body = json.dumps(events).encode("utf-8")
        self.delivery.begin_flush()

        def send(timeout: float) -> None:
            if self.opener is not None:
                post_bytes(self.url, body, headers, timeout, self.opener)
            else:
                status, rbody = session.post(body, headers)
                if status >= 400:
                    # typed so the delivery layer classifies it: 5xx/429
                    # count against the breaker, other 4xx are permanent
                    raise HTTPError(status, rbody)
            self.spans_flushed += len(batch)

        if self.delivery.deliver(send, len(body)) != "delivered":
            # retry/spill are off here (duplication risk): any
            # non-delivered batch is gone, and says so
            self.flush_errors += 1
            self.spans_dropped += len(batch)
            log.warning("splunk HEC post failed; %d spans dropped",
                        len(batch))

    def flush(self) -> None:
        pass  # submission is continuous; flush is a no-op like the reference
