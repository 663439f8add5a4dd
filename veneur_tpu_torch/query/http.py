"""HTTP front for the live query subsystem.

Three endpoints on a ThreadingHTTPServer:

* ``GET /metrics``  — the committed epoch in Prometheus exposition text
  (text format 0.0.4), rendered by the SAME shared renderer the
  exposition sink uses (sinks/exposition.py) so a scrape and a sink
  flush of the same epoch serialize byte-identically.
* ``GET|POST /query`` — the JSON query API. POST takes a JSON request
  document; GET takes the common fields as query parameters
  (?op=quantiles&name=...&tags=a:b,c:d&qs=0.5,0.99). Both go through
  QueryEngine.dispatch, the same entry the gRPC front uses.
* ``GET /healthz``  — liveness, reports the committed epoch seq.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

log = logging.getLogger("veneur_tpu_torch.query.http")


def _request_from_params(params: dict) -> dict:
    """?op=…&name=…&tags=a:b,c:d&qs=0.5,0.99 → a dispatch request."""
    req: dict = {}
    if "op" in params:
        req["op"] = params["op"][0]
    for key in ("name", "tenant"):
        if key in params:
            req[key] = params[key][0]
    if "tags" in params:
        req["tags"] = [t for t in params["tags"][0].split(",") if t]
    if "qs" in params:
        req["qs"] = [float(q) for q in params["qs"][0].split(",") if q]
    if "keys" in params:
        req["keys"] = [k for k in params["keys"][0].split(",") if k]
    for key in ("k", "limit"):
        if key in params:
            req[key] = int(params[key][0])
    if "force_device" in params:
        req["force_device"] = params["force_device"][0] not in (
            "0", "false", "")
    return req


class _QueryHandler(BaseHTTPRequestHandler):
    engine = None  # set per server class (make_http_server)
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # stdlib default logs to stderr
        log.debug("query http: " + fmt, *args)

    def _reply(self, status: int, body: bytes, content_type: str) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, doc: dict, status: int = 200) -> None:
        self._reply(status, json.dumps(doc).encode("utf-8"),
                    "application/json")

    def do_GET(self) -> None:
        url = urlparse(self.path)
        if url.path == "/metrics":
            body, _count, ctype = self.engine.render_exposition()
            self._reply(200, body, ctype)
        elif url.path == "/query":
            req = _request_from_params(parse_qs(url.query))
            self._reply_json(self.engine.dispatch(req))
        elif url.path == "/healthz":
            epoch = self.engine.epoch()
            self._reply_json({"ok": True,
                              "epoch": epoch.seq if epoch else 0})
        else:
            self._reply_json({"error": "not found"}, status=404)

    def do_POST(self) -> None:
        url = urlparse(self.path)
        if url.path != "/query":
            self._reply_json({"error": "not found"}, status=404)
            return
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b""
        try:
            req = json.loads(raw.decode("utf-8")) if raw else {}
        except (ValueError, UnicodeDecodeError) as exc:
            self._reply_json({"error": f"bad request: {exc}"}, status=400)
            return
        self._reply_json(self.engine.dispatch(req))


def make_http_server(engine, address: str = "127.0.0.1:0"
                     ) -> tuple[ThreadingHTTPServer, int]:
    """Start the query HTTP server over `engine` in a daemon thread;
    returns (server, bound_port)."""
    host, _, port = address.rpartition(":")
    handler = type("BoundQueryHandler", (_QueryHandler,),
                   {"engine": engine})
    server = ThreadingHTTPServer((host or "127.0.0.1", int(port or 0)),
                                 handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="query-http", daemon=True)
    thread.start()
    return server, server.server_address[1]
