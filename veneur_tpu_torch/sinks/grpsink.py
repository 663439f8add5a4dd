"""Generic gRPC span sink, and the falconer wrapper.

Parity: reference sinks/grpsink (own proto service for streaming spans to
any gRPC endpoint, with a connection-state watcher that logs/repairs on
state changes, sinks/grpsink/grpsink.go:27-80) and sinks/falconer (a thin
named wrapper over grpsink for Stripe's falconer span store).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import grpc

from veneur_tpu_torch.gen import ssf_pb2
from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb
from veneur_tpu_torch.protocol import ssf_wire
from veneur_tpu_torch.sinks import SpanSink
from veneur_tpu_torch.ssf import SSFSpan

log = logging.getLogger("veneur_tpu_torch.sinks.grpsink")

SERVICE_NAME = "veneurtpu.SpanSink"
SEND_SPAN = f"/{SERVICE_NAME}/SendSpan"


class GRPCSpanSink(SpanSink):
    """Sends each span as one protobuf RPC to a remote span service.

    A failing endpoint backs the sink off linearly (the
    trace/client.py reconnect discipline: delay = backoff_s * failures,
    capped at max_backoff_s): spans arriving inside the backoff window
    are dropped cheaply instead of each eating a full RPC timeout."""

    def __init__(self, target: str, name: str = "grpc",
                 timeout_s: float = 9.0, backoff_s: float = 0.2,
                 max_backoff_s: float = 5.0) -> None:
        self._name = name
        self.target = target
        self.timeout_s = timeout_s
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.channel: Optional[grpc.Channel] = None
        self._call = None
        self.spans_flushed = 0
        self.spans_dropped = 0
        self.backoff_dropped = 0
        self.reconnects = 0
        self._failures = 0
        self._down_until = 0.0
        self._state_lock = threading.Lock()
        self.last_state: str = "IDLE"

    def name(self) -> str:
        return self._name

    def start(self, trace_client=None) -> None:
        self.channel = grpc.insecure_channel(self.target)
        self._call = self.channel.unary_unary(
            SEND_SPAN,
            request_serializer=ssf_pb2.SSFSpan.SerializeToString,
            response_deserializer=pb.SendResponse.FromString,
        )
        # connection-state watcher (reference grpsink.go:27-80)
        self.channel.subscribe(self._on_state, try_to_connect=True)

    def _on_state(self, state) -> None:
        with self._state_lock:
            self.last_state = str(state)
        log.debug("span sink %s channel state: %s", self._name, state)

    def ingest(self, span: SSFSpan) -> None:
        if self._call is None:
            self.spans_dropped += 1
            return
        now = time.monotonic()
        with self._state_lock:
            if now < self._down_until:
                self.backoff_dropped += 1
                self.spans_dropped += 1
                return
        try:
            self._call(ssf_wire.span_to_pb(span), timeout=self.timeout_s)
            with self._state_lock:
                if self._failures:
                    self.reconnects += 1
                    self._failures = 0
            self.spans_flushed += 1
        except grpc.RpcError as e:
            with self._state_lock:
                self._failures += 1
                self._down_until = time.monotonic() + min(
                    self.backoff_s * self._failures, self.max_backoff_s)
            self.spans_dropped += 1
            log.debug("span send to %s failed: %s", self.target, e.code())

    def flush(self) -> None:
        pass

    def stop(self) -> None:
        if self.channel is not None:
            self.channel.close()


def make_span_server(handler, address: str = "127.0.0.1:0"):
    """Serve the SpanSink service (for tests and span-receiving daemons)."""
    from concurrent import futures

    def send_span(request: ssf_pb2.SSFSpan, context) -> pb.SendResponse:
        handler(ssf_wire.pb_to_span(request))
        return pb.SendResponse()

    handlers = grpc.method_handlers_generic_handler(
        SERVICE_NAME,
        {
            "SendSpan": grpc.unary_unary_rpc_method_handler(
                send_span,
                request_deserializer=ssf_pb2.SSFSpan.FromString,
                response_serializer=pb.SendResponse.SerializeToString,
            )
        },
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handlers,))
    port = server.add_insecure_port(address)
    server.start()
    return server, port


class FalconerSpanSink(GRPCSpanSink):
    """Falconer is grpsink pointed at Stripe's falconer span store
    (reference sinks/falconer/falconer.go)."""

    def __init__(self, target: str, timeout_s: float = 9.0) -> None:
        super().__init__(target, name="falconer", timeout_s=timeout_s)
