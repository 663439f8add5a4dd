"""The port's ``emit`` and Prometheus-poller CLIs against the JAX package's,
on the CPU (after tests/test_cli.py's emit and poller cases).

Each CLI of each package runs with the same arguments against a UDP
receiver; the datagrams are equal byte for byte (SSF spans with
``random`` seeded alike and the nanosecond clock stepping the same), and
so are the poller's parse, its counter deltas and the lines it sends
after a scrape over HTTP or a unix socket.
"""

from __future__ import annotations

import random
import socket
import socketserver
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from veneur_tpu.cli import emit as jemit
from veneur_tpu.cli import prometheus_poller as jpoller
from veneur_tpu_torch.cli import emit as temit
from veneur_tpu_torch.cli import prometheus_poller as tpoller
from veneur_tpu_torch.protocol import ssf_wire
from veneur_tpu_torch.protocol.dogstatsd import (parse_event, parse_metric,
                                                 parse_service_check)

PKGS = {"jax": (jemit, jpoller), "port": (temit, tpoller)}


def _udp_receiver():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(5)
    return sock, sock.getsockname()[1]


@pytest.fixture
def stepping_clock(monkeypatch):
    """time.time_ns advancing 1 ms a call from a fixed origin; ``reset``
    starts it over (and seeds ``random``) before each package's run."""
    state = {"t": 0}

    def time_ns():
        state["t"] += 1_000_000
        return state["t"]

    def reset():
        state["t"] = 1_700_000_000 * 10**9
        random.seed(5)

    monkeypatch.setattr(time, "time_ns", time_ns)
    return reset


def emit_both(argv_tail, reset=None, n=1) -> dict:
    """``emit.main`` of each package with ``-hostport`` at a fresh
    receiver and ``argv_tail``; its exit code and ``n`` datagrams."""
    out = {}
    for pkg, (emit, _poller) in PKGS.items():
        sock, port = _udp_receiver()
        try:
            if reset is not None:
                reset()
            rc = emit.main(["-hostport", f"udp://127.0.0.1:{port}"]
                           + argv_tail)
            out[pkg] = (rc, [sock.recv(65536) for _ in range(n)])
        finally:
            sock.close()
    return out


def test_emit_statsd_metrics():
    got = emit_both(["-name", "cli.counter", "-count", "3",
                     "-tag", "env:dev,team:x"])
    assert got["port"] == got["jax"]
    rc, [data] = got["port"]
    assert rc == 0
    m = parse_metric(data)
    assert (m.name, m.value, m.tags) == ("cli.counter", 3.0,
                                         ["env:dev", "team:x"])


def test_emit_event():
    got = emit_both(["-mode", "event", "-e_title", "deploy", "-e_text",
                     "done", "-e_alert_type", "info"])
    assert got["port"] == got["jax"]
    rc, [data] = got["port"]
    assert rc == 0 and parse_event(data).name == "deploy"


def test_emit_service_check():
    got = emit_both(["-mode", "sc", "-sc_name", "svc", "-sc_status", "2",
                     "-sc_msg", "broken"])
    assert got["port"] == got["jax"]
    rc, [data] = got["port"]
    assert rc == 0 and parse_service_check(data).name == "svc"


def test_emit_command_mode_ssf_span(stepping_clock):
    got = emit_both(["-ssf", "-name", "cmd.duration", "-command", "true"],
                    reset=stepping_clock)
    assert got["port"] == got["jax"]
    rc, [data] = got["port"]
    assert rc == 0
    span = ssf_wire.parse_ssf(data)
    assert span.name == "cmd.duration" and not span.error
    assert span.metrics[0].name == "cmd.duration"


def test_emit_command_failure_propagates_exit(stepping_clock):
    got = emit_both(["-ssf", "-name", "cmd.duration", "-command", "false"],
                    reset=stepping_clock)
    assert got["port"] == got["jax"]
    rc, [data] = got["port"]
    assert rc == 1 and ssf_wire.parse_ssf(data).error


def test_emit_mode_specific_tags_and_span_times(stepping_clock):
    got = emit_both(["-mode", "sc", "-sc_name", "db.ok", "-sc_status", "0",
                     "-tag", "env:dev", "-sc_tags", "shard:3"])
    assert got["port"] == got["jax"]
    assert sorted(parse_service_check(got["port"][1][0]).tags) == [
        "env:dev", "shard:3"]
    got = emit_both(["-ssf", "-name", "op", "-span_service", "svc",
                     "-span_tags", "widget:a", "-span_starttime", "100",
                     "-span_endtime", "101.5"], reset=stepping_clock)
    assert got["port"] == got["jax"]
    span = ssf_wire.parse_ssf(got["port"][1][0])
    assert span.tags.get("widget") == "a"
    assert span.start_timestamp == 100 * 10**9
    assert span.end_timestamp == int(101.5 * 10**9)


# -- the Prometheus poller -------------------------------------------------------


PROM_BODY = """\
# HELP http_requests_total Requests.
# TYPE http_requests_total counter
http_requests_total{code="200"} 100
http_requests_total{code="500"} 5
# TYPE temp_gauge gauge
temp_gauge 21.5
# TYPE req_latency histogram
req_latency_bucket{le="0.1"} 50
req_latency_bucket{le="+Inf"} 60
req_latency_sum 12.5
req_latency_count 60
"""


def test_prometheus_text_parsing():
    types, samples = tpoller.parse_prometheus_text(PROM_BODY)
    assert (types, samples) == jpoller.parse_prometheus_text(PROM_BODY)
    assert types["http_requests_total"] == "counter"
    assert types["req_latency"] == "histogram"
    by_name = {}
    for name, labels, value in samples:
        by_name.setdefault(name, []).append((labels, value))
    assert ({"code": "200"}, 100.0) in by_name["http_requests_total"]
    assert by_name["temp_gauge"][0][1] == 21.5


def test_prometheus_counter_dedupe():
    body2 = PROM_BODY.replace('code="200"} 100', 'code="200"} 110')
    got = {}
    for pkg, (_emit, poller) in PKGS.items():
        cache = poller.CountCache()
        lines1 = poller.translate(*poller.parse_prometheus_text(PROM_BODY),
                                  cache, [])
        lines2 = poller.translate(*poller.parse_prometheus_text(body2),
                                  cache, ["x:y"])
        got[pkg] = (lines1, lines2)
    assert got["port"] == got["jax"]
    lines1, lines2 = got["port"]
    assert any(b"temp_gauge:21.5|g" in ln for ln in lines1)
    assert not any(b"http_requests_total" in ln for ln in lines1)
    assert [ln for ln in lines2 if b"http_requests_total" in ln] == [
        b"http_requests_total:10.0|c|#code:200,x:y"]


def _handler(body: bytes):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return Handler


def poll_both(argv, n=1) -> dict:
    out = {}
    for pkg, (_emit, poller) in PKGS.items():
        rx, port = _udp_receiver()
        try:
            rc = poller.main(argv + ["-s", f"127.0.0.1:{port}", "-once"])
            out[pkg] = (rc, [rx.recv(65536) for _ in range(n)])
        finally:
            rx.close()
    return out


def test_prometheus_poller_end_to_end():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                _handler(PROM_BODY.encode()))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        got = poll_both(["-h", f"http://127.0.0.1:{httpd.server_port}"
                         "/metrics", "-p", "svc."])
    finally:
        httpd.shutdown()
    assert got["port"] == got["jax"]
    rc, [data] = got["port"]
    assert rc == 0 and b"svc.temp_gauge:21.5|g" in data


def test_prometheus_poller_label_filter_and_unix_socket(tmp_path):
    body = (b"# TYPE req_depth gauge\n"
            b'req_depth{path="/x",internal_id="abc"} 5\n')

    class UDSServer(socketserver.ThreadingUnixStreamServer):
        pass

    sock_path = str(tmp_path / "prom.sock")
    httpd = UDSServer(sock_path, _handler(body))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        got = poll_both(["-h", "http://prom/metrics", "-socket", sock_path,
                         "-ignored-labels", "internal_.*"])
    finally:
        httpd.shutdown()
    assert got["port"] == got["jax"]
    rc, [data] = got["port"]
    assert rc == 0
    assert b"req_depth:5" in data and b"path:/x" in data
    assert b"internal_id" not in data
