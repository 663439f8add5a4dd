"""The span sinks and their factory keys in the PyTorch port against the
JAX package, on the CPU.

* Servers built by each package's factory with the Datadog trace sink
  (``datadog_trace_api_address``), the New Relic span sink
  (``newrelic_trace_observer_url`` with ``newrelic_insert_key``) and the
  debug span sink (``debug_ingested_spans``), fed the same SSF spans over
  three intervals (the span worker's lanes drained by the test): every
  request the injected opener records (URL, method, headers with the
  Idempotency-Key, body) is byte for byte the JAX server's, each
  flush's own span included (ids from the same ``random`` seed, the
  clock pinned), and so are the debug sink's log lines.
* ``span_log_dir``: a ``SpanBatchSink`` over a ``SegmentedLogWriter``
  behind the columnar pipeline writes the same segment files, byte for
  byte, which read back to the spans sent.
* The factory: those keys build those sinks (and ``extra_span_sinks``
  rides along) as in the JAX factory, the native SSF path stands down
  with a span sink, and the Kafka, Splunk, X-Ray, LightStep and falconer
  keys build the JAX factory's span sinks.
* Splunk HEC, X-Ray, LightStep and falconer (after tests/test_sinks.py):
  each sink of each package fed the same spans sends the same bytes (HEC
  request bodies and headers, X-Ray datagrams, LightStep reports with
  ``random`` seeded alike for the reporter ids, falconer's protobuf
  messages as the gRPC servicer reads them), and a factory-built server
  of each package with all of them (and Kafka) fed the same SSF spans
  sends each sink's endpoint the same bytes.
"""

from __future__ import annotations

import json
import logging
import random
import socket
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from veneur_tpu import ssf as jssf
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.factory import build_server as jbuild
from veneur_tpu.gen import lightstep_collector_pb2 as jlspb
from veneur_tpu.protocol import ssf_wire as jwire
from veneur_tpu.sinks import grpsink as jgrpsink
from veneur_tpu.sinks import lightstep as jlightstep
from veneur_tpu.sinks import signalfx as jsignalfx
from veneur_tpu.sinks import splunk as jsplunk
from veneur_tpu.sinks import xray as jxray
from veneur_tpu_torch import ssf as tssf
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server as tbuild
from veneur_tpu_torch.gen import lightstep_collector_pb2 as tlspb
from veneur_tpu_torch.sinks import grpsink as tgrpsink
from veneur_tpu_torch.sinks import lightstep as tlightstep
from veneur_tpu_torch.sinks import signalfx as tsignalfx
from veneur_tpu_torch.sinks import splunk as tsplunk
from veneur_tpu_torch.sinks import xray as txray
from veneur_tpu_torch.sinks.debug import DebugSpanSink
from veneur_tpu_torch.spans import decode_batch
from veneur_tpu_torch.spans.sink import read_segmented_log

NOW = 1_700_000_000


class Recorder:
    """An opener that records every request and answers 200."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = []

    def __call__(self, req, timeout):
        with self.lock:
            self.requests.append((req.full_url, req.get_method(),
                                  sorted(req.header_items()), req.data))
        return b"{}"


@pytest.fixture
def pinned_clock(monkeypatch):
    """A nanosecond clock that advances one millisecond a call: the
    tracer's spans get the same start and end in both packages."""
    state = {"t": NOW * 10**9}

    def time_ns():
        state["t"] += 1_000_000
        return state["t"]

    def reset():
        state["t"] = NOW * 10**9

    monkeypatch.setattr(time, "time_ns", time_ns)
    return reset


def _span_packets(seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tid = int(rng.integers(1, 1 << 40))
        start = 1_000_000_000 + i * 1000
        tags = {"host": f"h{i % 3}"}
        if i % 4 == 0:
            tags["resource"] = f"/r{i % 3}"
        span = jssf.SSFSpan(
            trace_id=tid if i % 5 else 77, id=tid + i + 1,
            parent_id=int(rng.integers(0, 9)), start_timestamp=start,
            end_timestamp=start + int(rng.gamma(2.0, 5e6)),
            error=bool(i % 6 == 1), service=f"svc{i % 3}",
            indicator=bool(i % 2), name=f"op{i % 4}", tags=tags,
            metrics=[jssf.SSFSample(
                metric=jssf.SSFMetricType.COUNTER, name="sk.hits",
                value=1.0, timestamp=NOW)])
        out.append(jwire.encode_datagram(span))
    return out


def drain_span_worker(srv) -> None:
    """The span worker's loop in this thread up to a sentinel, then every
    sink lane joined: no clock involved."""
    sw = srv.span_worker
    sw.chan.put(None)
    sw.work()
    for lane in list(sw._lanes.values()):
        lane.q.join()


SINK_KEYS = {
    "interval": "10s", "hostname": "sink-host", "tpu_native_ingest": True,
    "tpu_native_readers": False, "num_workers": 1, "micro_fold": False,
    "ssf_span_uniqueness_rate": 1.0, "span_flush_drain_s": 0.0,
    "span_channel_capacity": 10000,
    "datadog_trace_api_address": "http://trace.local:8126",
    "newrelic_insert_key": "nk",
    "newrelic_trace_observer_url": "http://nr.local/trace/v1",
    "newrelic_common_tags": ["env:test", "team:obs"],
    "debug_ingested_spans": True,
}


def test_span_sink_requests_equal(pinned_clock, caplog):
    caplog.set_level(logging.INFO)
    got = []
    for pkg in ("jax", "port"):
        rec = Recorder()
        srv = (jbuild(jload(data=SINK_KEYS), opener=rec) if pkg == "jax"
               else tbuild(tload(data=SINK_KEYS), device="cpu", opener=rec))
        assert [s.name() for s in srv.span_sinks] == [
            "datadog", "newrelic", "debug"]
        assert srv.span_pipeline is None and not srv._native_ssf
        srv.span_sinks[0].delivery._mint_sender = "fixed-sender"
        caplog.clear()
        pinned_clock()
        random.seed(21)
        try:
            for k in range(3):
                for pkt in _span_packets(k, 40):
                    srv.handle_trace_packet(pkt)
                drain_span_worker(srv)
                srv.flush(now=NOW + 10 * k)
            logs = [r.getMessage() for r in caplog.records
                    if r.name.endswith("sinks.debug")]
            got.append((rec.requests, logs,
                        [(s.spans_flushed, s.flush_errors)
                         for s in srv.span_sinks[:2]]))
        finally:
            srv.shutdown()
    assert got[0] == got[1]
    urls = [r[0] for r in got[1][0]]
    assert urls.count("http://trace.local:8126/v0.3/traces") == 3
    assert urls.count("http://nr.local/trace/v1") == 3
    # 120 spans sent, and the first two flushes' own spans
    assert got[1][2] == [(122, 0), (122, 0)]
    assert sum("name=flush" in line for line in got[1][1]) == 2


def test_span_log_segments_equal(tmp_path, pinned_clock):
    dirs = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        data = {**SINK_KEYS, "span_log_dir": str(d), "span_batch_rows": 16}
        for k in ("datadog_trace_api_address", "newrelic_insert_key",
                  "newrelic_trace_observer_url", "debug_ingested_spans"):
            data.pop(k)
        srv = (jbuild(jload(data=data)) if pkg == "jax"
               else tbuild(tload(data=data), device="cpu"))
        assert [s.name() for s in srv.span_sinks] == ["span_log"]
        assert srv.span_pipeline is not None
        pinned_clock()
        random.seed(22)
        try:
            for k in range(3):
                for pkt in _span_packets(10 + k, 50):
                    srv.handle_trace_packet(pkt)
                srv.flush(now=NOW + 10 * k)
        finally:
            srv.shutdown()
        dirs.append(d)
    files = [sorted(p.name for p in Path(d).iterdir()) for d in dirs]
    assert files[0] == files[1] and files[1]
    for name in files[1]:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()
    batches = [decode_batch(f) for f in read_segmented_log(str(dirs[1]))]
    assert sum(b["rows"] for b in batches) == 150 + 2


# -- the factory --------------------------------------------------------------


def test_factory_builds_span_sinks_and_listeners(tmp_path):
    extra = DebugSpanSink()
    data = {**SINK_KEYS, "span_log_dir": str(tmp_path / "log"),
            "ssf_listen_addresses": ["udp://127.0.0.1:0"],
            "statsd_listen_addresses": ["tcp://127.0.0.1:0",
                                        f"unixgram://{tmp_path}/s.sock"]}
    srv = tbuild(tload(data=data), device="cpu", extra_span_sinks=[extra])
    jsrv = jbuild(jload(data=data), extra_span_sinks=[extra])
    try:
        names = [s.name() for s in srv.span_sinks]
        assert names == [s.name() for s in jsrv.span_sinks]
        assert names == ["debug", "datadog", "newrelic", "span_log", "debug"]
        assert srv.span_sinks[0] is extra
        assert set(srv.delivery_stats()) == {"datadog_spans", "span_log_spans"}
        # a span sink needs the Python span object: no native SSF path
        assert srv.native_mode and not srv._native_ssf
    finally:
        srv.shutdown()
        jsrv.shutdown()


# companions a key needs before the JAX factory builds its sink
SPAN_KEY_COMPANIONS = {
    "kafka_broker": {"kafka_span_topic": "spans"},
    "splunk_hec_address": {"splunk_hec_token": "tok"},
}


@pytest.mark.parametrize("key,value", [
    ("kafka_broker", "127.0.0.1:9092"),
    ("splunk_hec_address", "http://127.0.0.1:9"),
    ("xray_address", "127.0.0.1:2000"),
    ("lightstep_access_token", "t"),
    ("trace_lightstep_access_token", "t"),
    ("falconer_address", "127.0.0.1:9"),
])
def test_next_slice_span_sinks_refused_by_name(key, value):
    """The span sinks refused until their slice was ported: each key now
    builds the JAX factory's span sink, of the same class and name."""
    data = {"interval": "10s", key: value,
            **SPAN_KEY_COMPANIONS.get(key, {})}
    built = [jbuild(jload(data=data)),
             tbuild(tload(data=data), device="cpu")]
    try:
        kinds = [[(type(s).__name__, s.name()) for s in srv.span_sinks]
                 for srv in built]
        assert kinds[1] == kinds[0] and len(kinds[1]) == 1
    finally:
        for srv in built:
            srv.shutdown()


# -- Splunk HEC, X-Ray, LightStep, falconer (after tests/test_sinks.py) --------


SPAN_PKGS = {
    "jax": dict(ssf=jssf, splunk=jsplunk, xray=jxray,
                lightstep=jlightstep, lspb=jlspb, grpsink=jgrpsink,
                signalfx=jsignalfx, load=jload, build=jbuild, kw={}),
    "port": dict(ssf=tssf, splunk=tsplunk, xray=txray, lightstep=tlightstep,
                 lspb=tlspb, grpsink=tgrpsink, signalfx=tsignalfx,
                 load=tload, build=tbuild, kw={"device": "cpu"}),
}


class _StillClock:
    """A ``time`` whose wall clock stands still: the Splunk submit loop's
    batch cuts are then the batch size and the stop, and the Kafka
    messages' timestamps one value, in both packages. (Patched per
    module: gRPC computes its deadlines from the real wall clock.)"""

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)

    @staticmethod
    def time():
        return float(NOW)


@pytest.fixture
def still_splunk_clock(monkeypatch):
    for mod in (jsplunk, tsplunk):
        monkeypatch.setattr(mod, "time", _StillClock)


def _span(pkg, **kw):
    base = dict(trace_id=7, id=8, parent_id=2,
                start_timestamp=1_000_000_000, end_timestamp=3_000_000_000,
                service="svc", name="op", tags={"k": "v"})
    base.update(kw)
    return SPAN_PKGS[pkg]["ssf"].SSFSpan(**base)


class DictOpener:
    """tests/test_sinks.py's FakeOpener: each request as a dict."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = []

    def __call__(self, req, timeout):
        with self.lock:
            self.requests.append({"url": req.full_url,
                                  "method": req.get_method(),
                                  "headers": dict(req.headers),
                                  "body": req.data or b""})
        return b"{}"


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.02)
    assert pred()


def test_splunk_hec_batches(still_splunk_clock):
    got = {}
    for pkg, p in SPAN_PKGS.items():
        opener = DictOpener()
        sink = p["splunk"].SplunkSpanSink("https://splunk:8088", "tok",
                                          batch_size=2, opener=opener)
        sink.start()
        for i in range(4):
            sink.ingest(_span(pkg, id=i + 1))
        _wait(lambda: sink.spans_flushed >= 4)
        sink.stop()
        got[pkg] = (opener.requests, sink.spans_flushed, sink.spans_dropped)
    assert got["port"] == got["jax"]
    reqs = got["port"][0]
    assert len(reqs) == 2
    assert reqs[0]["headers"]["Authorization"] == "Splunk tok"
    events = json.loads(reqs[0]["body"])
    assert events[0]["event"]["service"] == "svc"


def test_splunk_stop_drains_and_joins(still_splunk_clock):
    got = {}
    for pkg, p in SPAN_PKGS.items():
        opener = DictOpener()
        sink = p["splunk"].SplunkSpanSink("https://splunk:8088", "tok",
                                          batch_size=1000, opener=opener)
        sink.start()
        for i in range(7):
            sink.ingest(_span(pkg, id=i + 1))
        sink.stop()
        assert sink.spans_flushed == 7
        assert not sink._threads
        sink.ingest(_span(pkg, id=99))
        assert sink.spans_dropped >= 1
        sink.stop()
        got[pkg] = (opener.requests, sink.spans_flushed, sink.spans_dropped,
                    sink.delivery.journal_exempt)
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 1 and got["port"][3] is True


def test_splunk_session_rotation_lifetime():
    import http.server

    hits = []

    class H(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            hits.append((self.path, self.headers.get("X-N"),
                         self.rfile.read(n)))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"ok")

        def log_message(self, *a):
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    got = {}
    try:
        url = f"http://127.0.0.1:{httpd.server_port}/services/collector/event"
        for pkg, p in SPAN_PKGS.items():
            s = p["splunk"]._RotatingSession(url, lifetime_s=0.05,
                                             jitter_s=0.0, timeout_s=5.0)
            rotations = []
            for n in ("1", "2", "3"):
                st, body = s.post(b"{}", {"X-N": n, "Content-Type": "a/b"})
                assert (st, body) == (200, b"ok")
                rotations.append(s.rotations)
                if n == "1":
                    time.sleep(0.1)
            s.close()
            got[pkg] = rotations
    finally:
        httpd.shutdown()
    assert got["port"] == got["jax"] == [1, 2, 2]
    assert hits[:3] == hits[3:]


def test_splunk_factory_plumbs_hec_tuning():
    data = {"interval": "10s",
            "splunk_hec_address": "https://hec.example.com:8088",
            "splunk_hec_token": "tok", "splunk_hec_ingest_timeout": "2s",
            "splunk_hec_max_connection_lifetime": "90s",
            "splunk_hec_connection_lifetime_jitter": "15s",
            "splunk_hec_tls_validate_hostname": "hec.internal"}
    got = {}
    for pkg, p in SPAN_PKGS.items():
        srv = p["build"](p["load"](data=data), **p["kw"])
        try:
            [splunk] = [s for s in srv.span_sinks if s.name() == "splunk"]
            got[pkg] = (splunk.ingest_timeout_s, splunk.connection_lifetime_s,
                        splunk.connection_lifetime_jitter_s,
                        splunk.tls_validate_hostname, splunk.url,
                        splunk.delivery.policy.retry_max,
                        splunk.delivery.policy.spill_max_payloads)
        finally:
            srv.shutdown()
    assert got["port"] == got["jax"]
    assert got["port"][:4] == (2.0, 90.0, 15.0, "hec.internal")


def _udp_receiver():
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(5)
    return sock, sock.getsockname()[1]


def test_xray_segments_over_udp():
    got = {}
    for pkg, p in SPAN_PKGS.items():
        recv, port = _udp_receiver()
        try:
            sink = p["xray"].XRaySpanSink(f"127.0.0.1:{port}", 100.0, ["k"])
            sink.ingest(_span(pkg))
            sink.ingest(_span(pkg, parent_id=0, trace_id=(1 << 100) + 3,
                              error=True, tags={"k": "w", "z": "1"}))
            got[pkg] = [recv.recv(65536), recv.recv(65536)]
            assert sink.spans_flushed == 2
        finally:
            recv.close()
    assert got["port"] == got["jax"]
    header, payload = got["port"][0].split(b"\n", 1)
    assert json.loads(header)["format"] == "json"
    seg = json.loads(payload)
    assert seg["name"] == "svc" and seg["annotations"] == {"k": "v"}
    assert seg["type"] == "subsegment"


def test_xray_sampling_equals_jax():
    got = {}
    for pkg, p in SPAN_PKGS.items():
        recv, port = _udp_receiver()
        try:
            sink = p["xray"].XRaySpanSink(f"127.0.0.1:{port}", 30.0, [])
            for t in range(40):
                sink.ingest(_span(pkg, trace_id=t * 997))
            got[pkg] = (sink.spans_flushed, sink.spans_dropped,
                        [recv.recv(65536) for _ in range(sink.spans_flushed)])
        finally:
            recv.close()
    assert got["port"] == got["jax"]
    assert 0 < got["port"][0] < 40


class RawSpanServicer:
    """A falconer SpanSink servicer that keeps each SendSpan request's
    protobuf bytes as read off the wire."""

    def __init__(self):
        import grpc
        from concurrent import futures

        from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb

        self.lock = threading.Lock()
        self.messages = []

        def send_span(request: bytes, context):
            with self.lock:
                self.messages.append(request)
            return pb.SendResponse()

        handlers = grpc.method_handlers_generic_handler(
            tgrpsink.SERVICE_NAME, {"SendSpan": grpc.unary_unary_rpc_method_handler(
                send_span, request_deserializer=lambda b: b,
                response_serializer=pb.SendResponse.SerializeToString)})
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self.server.add_generic_rpc_handlers((handlers,))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def stop(self):
        self.server.stop(grace=1)


def test_grpc_span_sink_roundtrip():
    got = {}
    for pkg, p in SPAN_PKGS.items():
        servicer = RawSpanServicer()
        try:
            sink = p["grpsink"].FalconerSpanSink(f"127.0.0.1:{servicer.port}")
            sink.start()
            for i in range(3):
                sink.ingest(_span(pkg, name=f"grpc-op{i}", id=10 + i,
                                  tags={"i": str(i)}))
            _wait(lambda: len(servicer.messages) == 3)
            sink.stop()
            got[pkg] = (servicer.messages, sink.spans_flushed, sink.name())
        finally:
            servicer.stop()
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (3, "falconer")
    from veneur_tpu_torch.protocol import ssf_wire as tssf_wire
    from veneur_tpu_torch.gen import ssf_pb2

    back = tssf_wire.pb_to_span(ssf_pb2.SSFSpan.FromString(
        got["port"][0][0]))
    assert back.name == "grpc-op0"
    # the JAX package's own servicer decodes the port sink's messages
    received = []
    server, port = jgrpsink.make_span_server(received.append)
    try:
        sink = tgrpsink.GRPCSpanSink(f"127.0.0.1:{port}")
        sink.start()
        sink.ingest(_span("port", name="grpc-op"))
        _wait(lambda: received)
        assert received[0].name == "grpc-op" and sink.spans_flushed == 1
        sink.stop()
    finally:
        server.stop(grace=1)


def test_lightstep_client_pool():
    got = {}
    for pkg, p in SPAN_PKGS.items():
        reports = []
        random.seed(31)
        sink = p["lightstep"].LightStepSpanSink(
            "tok", num_clients=2,
            transport=lambda client, spans: reports.append(
                (client, [s.SerializeToString() for s in spans])))
        sink.ingest(_span(pkg, trace_id=2))
        sink.ingest(_span(pkg, trace_id=3))
        sink.flush()
        got[pkg] = (reports, sink._reporter_ids)
    assert got["port"] == got["jax"]
    assert sorted(r[0] for r in got["port"][0]) == [0, 1]


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def test_lightstep_span_wire_fixture():
    got = [SPAN_PKGS[pkg]["lightstep"].span_to_collector(
        SPAN_PKGS[pkg]["ssf"].SSFSpan(
            trace_id=7, id=8, parent_id=2, start_timestamp=1_500_000_123,
            end_timestamp=3_000_000_123, service="svc", name="op", tags={})
    ).SerializeToString() for pkg in SPAN_PKGS]
    ctx = b"\x08" + _varint(7) + b"\x10" + _varint(8)
    parent_ctx = b"\x08" + _varint(7) + b"\x10" + _varint(2)
    ref = b"\x12" + _varint(len(parent_ctx)) + parent_ctx
    ts = b"\x08" + _varint(1) + b"\x10" + _varint(500_000_123)
    comp = (b"\x0a" + _varint(9) + b"component"
            + b"\x12" + _varint(3) + b"svc")
    expected = (
        b"\x0a" + _varint(len(ctx)) + ctx
        + b"\x12" + _varint(2) + b"op"
        + b"\x1a" + _varint(len(ref)) + ref
        + b"\x22" + _varint(len(ts)) + ts
        + b"\x28" + _varint(1_500_000)
        + b"\x32" + _varint(len(comp)) + comp)
    assert got == [expected, expected]


def test_lightstep_http_report_carrier():
    got = {}
    for pkg, p in SPAN_PKGS.items():
        opener = DictOpener()
        random.seed(32)
        sink = p["lightstep"].LightStepSpanSink("sekrit-token", opener=opener)
        sink.ingest(_span(pkg, trace_id=11, id=12, tags={"k": "v"},
                          error=True))
        sink.flush()
        got[pkg] = (opener.requests, sink.spans_flushed)
    assert got["port"] == got["jax"]
    [req] = got["port"][0]
    assert req["url"].endswith("/api/v2/reports")
    assert req["headers"]["Lightstep-access-token"] == "sekrit-token"
    assert req["headers"]["Content-type"] == "application/octet-stream"
    rep = tlspb.ReportRequest.FromString(req["body"])
    assert rep.auth.access_token == "sekrit-token"
    assert rep.reporter.reporter_id > 0 and len(rep.spans) == 1
    tag_map = {t.key: t for t in rep.spans[0].tags}
    assert tag_map["k"].string_value == "v"
    assert tag_map["component"].string_value == "svc"
    assert tag_map["error"].bool_value is True


def test_lightstep_report_chunking():
    got = {}
    for pkg, p in SPAN_PKGS.items():
        reports = []
        sink = p["lightstep"].LightStepSpanSink(
            "tok", max_spans_per_report=2,
            transport=lambda client, spans: reports.append(len(spans)))
        for i in range(5):
            sink.ingest(_span(pkg, trace_id=0, id=i + 1))
        sink.flush()
        got[pkg] = (reports, sink.spans_flushed)
    assert got["port"] == got["jax"] == ([2, 2, 1], 5)


def test_signalfx_dynamic_key_refresh_pages_token_api():
    import urllib.parse

    pages = {0: [{"name": "team-a", "secret": "key-a"},
                 {"name": "team-b", "secret": "key-b"}],
             2: [{"name": "team-c", "secret": "key-c"}], 3: []}
    got = {}
    for pkg, p in SPAN_PKGS.items():
        seen = []

        def opener(req, timeout):
            q = urllib.parse.parse_qs(urllib.parse.urlsplit(
                req.full_url).query)
            seen.append((req.full_url, dict(req.headers)))
            return json.dumps({"results": pages[int(q["offset"][0])]}).encode()

        sink = p["signalfx"].SignalFxMetricSink(
            api_key="default-key", hostname="h",
            per_tag_api_keys={"team-a": "stale"}, vary_key_by="team",
            dynamic_per_tag_keys=True,
            api_endpoint="https://api.example.com", opener=opener)
        sink.refresh_keys_once()
        got[pkg] = (sink.per_tag_api_keys, sink.key_refreshes, seen)
    assert got["port"] == got["jax"]
    assert got["port"][0] == {"team-a": "key-a", "team-b": "key-b",
                              "team-c": "key-c"}
    assert got["port"][1] == 1
    assert got["port"][2][0][1].get("X-sf-token") == "default-key"


def test_signalfx_dynamic_key_refresh_failure_keeps_old_keys():
    got = {}
    for pkg, p in SPAN_PKGS.items():
        def opener(req, timeout):
            raise OSError("api down")

        sink = p["signalfx"].SignalFxMetricSink(
            api_key="k", hostname="h", per_tag_api_keys={"a": "old"},
            dynamic_per_tag_keys=True, opener=opener)
        sink.refresh_keys_once()
        got[pkg] = (sink.per_tag_api_keys, sink.key_refreshes)
    assert got["port"] == got["jax"] == ({"a": "old"}, 0)


# -- every new span sink in one server -----------------------------------------


def test_server_span_sinks_send_the_same_bytes(pinned_clock, monkeypatch):
    """A factory-built server of each package with the Kafka, Splunk HEC,
    X-Ray, LightStep and falconer span sinks (local fakes for each
    endpoint), fed the same SSF spans over two intervals: every endpoint
    gets the same bytes from both."""
    from test_torch_kafka import FakeBroker

    from veneur_tpu.sinks import kafka_wire as jkw
    from veneur_tpu_torch.sinks import kafka_wire as tkw

    for mod in (jsplunk, tsplunk, jkw, tkw):
        monkeypatch.setattr(mod, "time", _StillClock)
    got = {}
    for pkg, p in SPAN_PKGS.items():
        broker = FakeBroker()
        servicer = RawSpanServicer()
        xray, xport = _udp_receiver()
        opener = DictOpener()
        data = {"interval": "10s", "hostname": "span-host",
                "tpu_native_ingest": False, "num_workers": 1,
                "micro_fold": False, "ssf_span_uniqueness_rate": 1.0,
                "span_flush_drain_s": 0.0, "span_channel_capacity": 10000,
                "kafka_broker": f"127.0.0.1:{broker.port}",
                "kafka_span_topic": "spans",
                "splunk_hec_address": "http://hec.local:8088",
                "splunk_hec_token": "tok", "splunk_hec_batch_size": 1000,
                "xray_address": f"127.0.0.1:{xport}",
                "xray_annotation_tags": ["host"],
                "lightstep_access_token": "ls",
                "lightstep_collector_host": "http://ls.local",
                "falconer_address": f"127.0.0.1:{servicer.port}"}
        pinned_clock()
        random.seed(41)
        srv = p["build"](p["load"](data=data), opener=opener, **p["kw"])
        try:
            assert sorted(s.name() for s in srv.span_sinks) == [
                "falconer", "kafka", "lightstep", "splunk", "xray"]
            for s in srv.span_sinks:
                s.start()
            n = 0
            for k in range(2):
                for pkt in _span_packets(30 + k, 40):
                    srv.handle_trace_packet(pkt)
                drain_span_worker(srv)
                srv.flush(now=NOW + 10 * k)
                n += 40 + k
            [splunk] = [s for s in srv.span_sinks if s.name() == "splunk"]
            splunk.stop()
            _wait(lambda: len(servicer.messages) == n)
            xray_grams = [xray.recv(65536) for _ in range(n)]
            counts = sorted((s.name(), s.spans_flushed, s.spans_dropped)
                            for s in srv.span_sinks)
        finally:
            srv.shutdown()
            servicer.stop()
            broker.stop()
            xray.close()
        got[pkg] = dict(
            kafka=[f for f in broker.frames if f[:2] == b"\x00\x00"],
            falconer=servicer.messages, xray=xray_grams,
            http=[(r["url"], sorted(r["headers"].items()), r["body"])
                  for r in opener.requests], counts=counts)
    for key in ("kafka", "xray", "http", "counts"):
        assert got["port"][key] == got["jax"][key], key
    # falconer's RPCs come from the span worker's lane as spans arrive
    assert got["port"]["falconer"] == got["jax"]["falconer"]
    urls = sorted({u for u, _h, _b in got["port"]["http"]})
    assert urls == ["http://hec.local:8088/services/collector/event",
                    "http://ls.local/api/v2/reports"]
    assert all(c[1] == 81 and c[2] == 0 for c in got["port"]["counts"])
