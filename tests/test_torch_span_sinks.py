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
  with a span sink, and the span sinks of the next slice (Kafka, Splunk,
  X-Ray, LightStep, falconer) are refused by name.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from veneur_tpu import ssf as jssf
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.factory import build_server as jbuild
from veneur_tpu.protocol import ssf_wire as jwire
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import UnportedConfigError
from veneur_tpu_torch.core.factory import build_server as tbuild
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


@pytest.mark.parametrize("key,value", [
    ("kafka_broker", "127.0.0.1:9092"),
    ("splunk_hec_address", "http://127.0.0.1:9"),
    ("xray_address", "127.0.0.1:2000"),
    ("lightstep_access_token", "t"),
    ("trace_lightstep_access_token", "t"),
    ("falconer_address", "127.0.0.1:9"),
])
def test_next_slice_span_sinks_refused_by_name(key, value):
    with pytest.raises(UnportedConfigError, match=key):
        tbuild(tload(data={"interval": "10s", key: value}), device="cpu")
