"""Tracing client library.

Parity: reference trace/ — the backpressure-managed span client
(trace/client.go:56-575), network backends (trace/backend.go:46-240), span
model (trace/trace.go), and the metrics helpers (trace/metrics/client.go).
"""

from veneur_tpu_torch.trace.client import (  # noqa: F401
    Client,
    ErrWouldBlock,
    NoOpBackend,
    ChannelBackend,
    UDPBackend,
    UnixBackend,
    neutralize_client,
)
from veneur_tpu_torch.trace.span import Span, start_span  # noqa: F401
