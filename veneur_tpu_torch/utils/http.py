"""Small HTTP helper used by sinks and forwarding.

PyTorch port: a copy of veneur_tpu/utils/http.py with its imports
rebound. ``thread_stack_dump`` imports ``core/crash.py``, which is not
ported yet; only the HTTP API, also not ported, calls it.

Plays the role of the reference's http/http.go PostHelper (JSON body,
optional zlib deflate, tracing hooks kept simple). The opener is
injectable so sink tests stub the network.
"""

from __future__ import annotations

import json
import logging
import urllib.error
import urllib.request
import zlib
from typing import Callable, Optional

log = logging.getLogger("veneur_tpu_torch.http")


class HTTPError(Exception):
    def __init__(self, status: int, body: bytes) -> None:
        super().__init__(f"HTTP {status}: {body[:200]!r}")
        self.status = status
        self.body = body

    @property
    def retryable(self) -> bool:
        """Timeout/throttle/server-side statuses are worth resending;
        any other 4xx rejected the payload itself (the delivery layer,
        sinks/delivery.py, drops those instead of looping)."""
        return self.status in (408, 429) or self.status >= 500


def default_opener(req: urllib.request.Request, timeout: float) -> bytes:
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        raise HTTPError(e.code, e.read()) from None


Opener = Callable[[urllib.request.Request, float], bytes]


def json_body(obj, headers: Optional[dict[str, str]] = None,
              compress: bool = False) -> tuple[bytes, dict[str, str]]:
    """Serialize a JSON POST once: (body bytes, headers). The delivery
    layer (sinks/delivery.py) spills failed payloads as serialized
    bytes, so sinks build the body up front and retries resend the
    identical bytes."""
    body = json.dumps(obj).encode("utf-8")
    hdrs = {"Content-Type": "application/json"}
    if compress:
        body = zlib.compress(body)
        hdrs["Content-Encoding"] = "deflate"
    if headers:
        hdrs.update(headers)
    return body, hdrs


def post_bytes(url: str, body: bytes, headers: dict[str, str],
               timeout: float = 10.0,
               opener: Opener = default_opener) -> bytes:
    """One POST attempt of a pre-serialized body (no retry here — that
    is the delivery layer's job)."""
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    return opener(req, timeout)


def post_json(
    url: str,
    obj,
    headers: Optional[dict[str, str]] = None,
    timeout: float = 10.0,
    compress: bool = False,
    opener: Opener = default_opener,
) -> bytes:
    body, hdrs = json_body(obj, headers, compress)
    return post_bytes(url, body, hdrs, timeout, opener)


def thread_stack_dump() -> bytes:
    """Every live thread's stack — the /debug/pprof analog for a runtime
    without Go's pprof (reference wires net/http/pprof, http.go:52-57)."""
    from veneur_tpu_torch.core.crash import format_all_threads

    return format_all_threads().encode()


def parse_host_port(address: str, default_host: str = "127.0.0.1",
                    what: str = "address") -> tuple[str, int]:
    """Parse "host:port" / ":port" / "port" / "[v6]:port" with a clear
    config error instead of a bare int() traceback."""
    try:
        if address.startswith("["):
            host, _, rest = address[1:].partition("]")
            if not rest.startswith(":"):
                raise ValueError("missing port")
            return host, int(rest[1:])
        host, sep, port = address.rpartition(":")
        if not sep:
            # bare port, e.g. "8127"
            return default_host, int(address)
        return host or default_host, int(port)
    except ValueError as e:
        raise ValueError(f"invalid {what} {address!r}: {e}") from None


class APIHandlerBase:
    """Shared request plumbing for the small stdlib HTTP servers
    (global /import endpoint, proxy front): quiet logs, _respond, and the
    common GET routes (/healthcheck, /version, /debug/pprof)."""

    version_string_body = "unknown"

    def log_message(self, *a):  # quiet
        pass

    def _respond(self, code: int, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def handle_common_get(self) -> bool:
        """Serve a common GET route; returns False if the path is not one
        of them (caller then tries its own routes or 404s)."""
        if self.path in ("/healthcheck", "/healthcheck/tracing"):
            self._respond(200, b"ok\n")
        elif self.path == "/version":
            self._respond(200, self.version_string_body.encode())
        elif self.path.startswith("/debug/pprof"):
            self._respond(200, thread_stack_dump())
        else:
            return False
        return True
