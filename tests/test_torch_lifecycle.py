"""The port's process lifecycle and overload loop, on the CPU, against
the JAX package where it has the same surface.

- The spill-cap loop (``_adapt_spill_caps``): the JAX package's sequence
  of halvings and doublings gives the same caps on both servers, reaches
  every native and reader context, gauges ``ingest.spill_cap``, and runs
  after every serial flush of the ticker; ``_pipeline_overrun`` halves.
- Panic capture: a crashed server thread lands one crash report at
  ``sentry_dsn`` and exits 1.
- ``synchronize_with_interval``: the first tick lands on a wall-clock
  multiple of the interval.
- The CLI (``--device cpu``, each run in a subprocess with its own
  timeout): ``-validate-config`` and ``-validate-config-strict``; SIGHUP
  re-execs on the same UDP port and every datagram sent across the
  restart is counted; ``POST /quitquitquit`` ends the process with 0.
- ``stats_address``: the self-telemetry lines reach a UDP socket with
  the namespace and the additional tags; ``enable_profiling`` writes a
  torch.profiler trace at shutdown.
"""

from __future__ import annotations

import http.server
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.server import calculate_tick_delay as jdelay
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.cli.veneur_main import main as veneur_main
from veneur_tpu_torch.core.config import Config, load_config
from veneur_tpu_torch.core.server import Server, calculate_tick_delay
from veneur_tpu_torch.sinks.channel import ChannelMetricSink

ROOT = Path(__file__).resolve().parent.parent


def _free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- F1: the spill-cap loop ---------------------------------------------------


def test_adaptive_spill_cap_controller():
    """tests/test_worker.py's controller sequence on both servers."""
    kw = dict(interval="10s", tpu_spill_cap=1 << 20,
              tpu_native_ingest=False)
    js = JServer(JConfig(**kw), metric_sinks=[JChannel()])
    ts = Server(Config(**kw), metric_sinks=[ChannelMetricSink()],
                device="cpu")
    try:
        steps = [9.5] + [20.0] * 10 + [5.0] + [0.5] * 10
        seen = []
        for dur in steps:
            for srv in (js, ts):
                srv._adapt_spill_caps(dur)
            assert ts._spill_cap_now == js._spill_cap_now, dur
            assert ts.workers[0].spill_cap == js.workers[0].spill_cap
            seen.append(ts._spill_cap_now)
        assert seen[0] == 1 << 19
        assert seen[10] == 1 << 16  # the floor
        assert seen[11] == 1 << 16  # mid-band: hold
        assert seen[-1] == 1 << 20  # the ceiling
        assert ts.stats.gauges()[("ingest.spill_cap", ())] == 1 << 20
        ts._pipeline_overrun()  # a stage a full interval behind: halve
        assert ts._spill_cap_now == 1 << 19
        ts._adapt_spill_caps(9.5, allow_shrink=False)  # pipelined: no shrink
        assert ts._spill_cap_now == 1 << 19
    finally:
        js.shutdown()
        ts.shutdown()


def test_spill_caps_reach_native_and_reader_contexts():
    srv = Server(Config(interval="10s", tpu_native_ingest=True,
                        tpu_native_readers=True, num_readers=2,
                        tpu_spill_cap=1 << 18), device="cpu")
    try:
        w = srv.workers[0]
        assert srv._reader_shards == 2
        caps = {}
        for i, ctx in enumerate(w._all_ctxs()):
            ctx.set_spill_cap = (lambda cap, i=i: caps.__setitem__(i, cap))
        srv._adapt_spill_caps(20.0)
        assert caps == {i: 1 << 17 for i in range(3)}
        assert w.spill_cap == 1 << 17
    finally:
        srv.shutdown()


def test_flush_loop_adapts_after_every_serial_flush():
    """The ticker runs the loop after each flush: flushes that take the
    whole interval halve the cap tick by tick."""
    srv = Server(Config(interval="0.2s", tpu_spill_cap=1 << 20,
                        tpu_native_ingest=False), device="cpu")
    ticks = []

    def slow_flush(now=None):
        ticks.append(time.time())
        time.sleep(0.19)

    srv.flush = slow_flush
    try:
        t = threading.Thread(target=srv._flush_loop, daemon=True)
        t.start()
        deadline = time.time() + 10
        while len(ticks) < 4 and time.time() < deadline:
            time.sleep(0.02)
        assert len(ticks) >= 4
        assert srv._spill_cap_now <= 1 << 18
    finally:
        srv.shutdown()
        t.join(timeout=5)


# -- F2: panic capture --------------------------------------------------------


def test_worker_thread_crash_lands_one_http_post(monkeypatch):
    """A server thread that raises delivers exactly one Sentry store-API
    POST and exits the process with code 1 (the exit is recorded here)."""
    posts = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            posts.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"{}")

        def log_message(self, *a):
            pass

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    srv = Server(Config(interval="10s", tpu_native_ingest=False,
                        sentry_dsn=f"http://k@127.0.0.1:"
                                   f"{httpd.server_address[1]}/7"),
                 device="cpu")
    try:
        def boom():
            raise RuntimeError("worker died mid-flush")

        t = srv._spawn(boom, "worker-0")
        t.join(10.0)
        assert not t.is_alive()
        assert exits == [1]
        assert len(posts) == 1
        assert "worker died mid-flush" in posts[0]["message"]
        assert posts[0]["extra"]["component"] == "worker-0"
    finally:
        httpd.shutdown()
        monkeypatch.undo()
        srv.shutdown()


# -- F3: synchronize_with_interval --------------------------------------------


def test_calculate_tick_delay():
    for interval, now in ((10.0, 103.0), (10.0, 100.0), (0.5, 1234.56)):
        assert calculate_tick_delay(interval, now) == jdelay(interval, now)
    assert calculate_tick_delay(10.0, 103.0) == pytest.approx(7.0)
    assert calculate_tick_delay(10.0, 100.0) == pytest.approx(10.0)


def test_first_tick_aligned_to_the_wall_clock():
    """Started a quarter interval past a boundary, the aligned ticker's
    first flush lands on the next multiple of the interval (an unaligned
    one would land a quarter interval past it)."""
    interval = 0.5
    srv = Server(Config(interval="500ms", synchronize_with_interval=True,
                        tpu_native_ingest=False), device="cpu")
    ticks = []
    srv.flush = lambda now=None: ticks.append(time.time())
    try:
        while abs(time.time() % interval - 0.125) > 0.01:
            time.sleep(0.002)
        t = threading.Thread(target=srv._flush_loop, daemon=True)
        t.start()
        deadline = time.time() + 5
        while len(ticks) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert len(ticks) >= 2
        phase = [x % interval for x in ticks[:2]]
        assert all(min(p, interval - p) < 0.06 for p in phase), phase
    finally:
        srv.shutdown()
        t.join(timeout=5)


# -- F4: the CLI --------------------------------------------------------------


def test_veneur_main_validate_config(tmp_path, capsys):
    ok = tmp_path / "ok.yaml"
    ok.write_text("interval: 5s\npercentiles: [0.5]\n")
    assert veneur_main(["-f", str(ok), "-validate-config"]) == 0
    assert veneur_main(["-f", str(ok), "-validate-config-strict"]) == 0
    bad = tmp_path / "bad.yaml"
    bad.write_text("interval: nonsense\n")
    assert veneur_main(["-f", str(bad), "-validate-config"]) == 1
    unknown = tmp_path / "unknown.yaml"
    unknown.write_text("interval: 5s\nno_such_key: true\n")
    assert veneur_main(["-f", str(unknown), "-validate-config"]) == 0
    assert veneur_main(["-f", str(unknown), "-validate-config-strict"]) == 1
    # a config the port cannot take: series_shards must be a power of two
    refused = tmp_path / "refused.yaml"
    refused.write_text("series_shards: 3\n")
    assert veneur_main(["-f", str(refused), "-validate-config"]) == 1


def test_example_configs_load_strict():
    example = str(ROOT / "example.yaml")
    cfg = load_config(example, strict=True)
    assert cfg.interval == "10s"
    assert veneur_main(["-f", example, "-validate-config-strict"]) == 0


class _CountingListener:
    """A TCP forward-statsd target: sums the value of each counter line
    of one name across every connection."""

    def __init__(self, name: bytes) -> None:
        self.name = name
        self.total = 0.0
        self._lock = threading.Lock()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._read, args=(conn,),
                             daemon=True).start()

    def _read(self, conn) -> None:
        # the sink keeps its connection across flushes: count each
        # complete line as it arrives
        buf = b""
        with conn:
            while data := conn.recv(65536):
                *lines, buf = (buf + data).split(b"\n")
                for line in lines:
                    head, _, _ = line.partition(b"|")
                    name, _, value = head.rpartition(b":")
                    if name == self.name:
                        with self._lock:
                            self.total += float(value)

    def wait_total(self, want: float, timeout: float) -> float:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                if self.total >= want:
                    return self.total
            time.sleep(0.05)
        with self._lock:
            return self.total


def _start_cli(tmp_path, text: str):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(text)
    log = open(tmp_path / "server.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "veneur_tpu_torch.cli.veneur_main", "-f",
         str(cfg), "--device", "cpu"], cwd=ROOT, stdout=log, stderr=log,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return proc, tmp_path / "server.log"


def _wait_healthy(http_port: int, proc, deadline: float, log: Path,
                  images: int = 1) -> None:
    """The images-th process image has bound its listeners (its serving
    line is logged: the HTTP front answers earlier, from the build) and
    answers the healthcheck."""
    while time.time() < deadline:
        assert proc.poll() is None, "the server exited"
        if log.read_bytes().count(b" serving on ") < images:
            time.sleep(0.1)
            continue
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{http_port}/healthcheck", timeout=1):
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError("server never became healthy")


def _quit(http_port: int) -> None:
    urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{http_port}/quitquitquit", method="POST"),
        timeout=5).read()


def _send(port: int, n: int) -> None:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        for _ in range(n):
            s.sendto(b"lc.count:1|c", ("127.0.0.1", port))
            time.sleep(0.0005)


# the first process image's start (a torch import and the server's
# build): about 6 s on an idle host, past 20 s beside five busy test
# workers; the waits after it are budgeted from the start measured
_FIRST_START_S = 120.0


def test_veneur_main_sighup_graceful_restart(tmp_path):
    """SIGHUP drains and re-execs in place on the same UDP socket: the
    PID survives, and every datagram sent before, across and after the
    restart is counted by the flushes of the two process images. The
    second image's budget is three of the first's measured starts (its
    drain and final flush, then a start of its own) plus 10 s for the
    flushes of the last datagrams."""
    t0 = time.time()
    udp_port = _free_port(socket.SOCK_DGRAM)
    http_port = _free_port()
    tap = _CountingListener(b"lc.count")
    proc, log = _start_cli(tmp_path, (
        f"statsd_listen_addresses: [udp://127.0.0.1:{udp_port}]\n"
        f"http_address: 127.0.0.1:{http_port}\nhttp_quit: true\n"
        "interval: 1s\ntpu_native_ingest: false\n"
        f"forward_statsd_address: 127.0.0.1:{tap.port}\n"
        "forward_statsd_network: tcp\n"))
    try:
        _wait_healthy(http_port, proc, t0 + _FIRST_START_S, log)
        start_s = time.time() - t0
        t_end = time.time() + 3 * start_s + 10
        _send(udp_port, 150)
        proc.send_signal(signal.SIGHUP)
        _send(udp_port, 150)  # queued in the kernel across the re-exec
        while b"adopting inherited listener fds" not in log.read_bytes():
            assert proc.poll() is None, "exited instead of re-exec'ing"
            assert time.time() < t_end, "no re-exec"
            time.sleep(0.1)
        _wait_healthy(http_port, proc, t_end, log, images=2)
        _send(udp_port, 150)
        assert tap.wait_total(450, t_end - time.time()) == 450
        _quit(http_port)
        assert proc.wait(timeout=max(1, t_end - time.time())) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        tap.sock.close()


def test_quitquitquit_exits_0(tmp_path):
    t_end = time.time() + 25
    http_port = _free_port()
    proc, log = _start_cli(tmp_path, (
        f"http_address: 127.0.0.1:{http_port}\nhttp_quit: true\n"
        "interval: 10s\ntpu_native_ingest: false\n"))
    try:
        _wait_healthy(http_port, proc, t_end, log)
        _quit(http_port)
        assert proc.wait(timeout=max(1, t_end - time.time())) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


# -- self-telemetry and profiling ---------------------------------------------


def test_stats_address_reaches_a_udp_socket():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5.0)
    srv = Server(Config(interval="10s", tpu_native_ingest=False,
                        stats_address=f"127.0.0.1:{rx.getsockname()[1]}",
                        veneur_metrics_additional_tags=["team:obs"]),
                 metric_sinks=[ChannelMetricSink()], device="cpu")
    try:
        srv.process_metric_packet(b"st.t:3|ms\nst.c:1|c")
        srv.flush(now=1_700_000_000)
        srv._adapt_spill_caps(100.0)
        lines = []
        deadline = time.time() + 10
        want = {b"veneur.flush.post_metrics_total",
                b"veneur.ingest.spill_cap"}
        while time.time() < deadline:
            try:
                lines.append(rx.recv(65536))
            except socket.timeout:
                break
            if want <= {ln.partition(b":")[0] for ln in lines}:
                break
        by_name = {ln.partition(b":")[0]: ln for ln in lines}
        assert want <= set(by_name)
        post = by_name[b"veneur.flush.post_metrics_total"]
        assert post.startswith(b"veneur.flush.post_metrics_total:")
        assert b"|c" in post and b"team:obs" in post
        cap = by_name[b"veneur.ingest.spill_cap"]
        assert cap.split(b"|")[0] == b"veneur.ingest.spill_cap:%d" % (
            srv._spill_cap_now)
        # kept in the process as before
        assert srv.stats.gauges()[("ingest.spill_cap", ())] == \
            srv._spill_cap_now
    finally:
        srv.shutdown()
        rx.close()


def test_profiler_trace_written_on_the_cpu(tmp_path):
    prof_dir = tmp_path / "prof"
    srv = Server(Config(interval="10s", tpu_native_ingest=False,
                        enable_profiling=True, profile_dir=str(prof_dir)),
                 metric_sinks=[ChannelMetricSink()], device="cpu")
    srv.start()
    try:
        assert srv._profiler is not None
        for v in range(1, 50):
            srv.process_metric_packet(b"pr.t:%d|ms" % v)
        srv.flush()
    finally:
        srv.shutdown()
    traces = list(prof_dir.glob("*.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
