"""The port's metric network sinks and factory against the JAX package's,
on the CPU.

* Each ported sink (Datadog, SignalFx, the Prometheus repeater and
  pushgateway, forward-statsd, New Relic), JAX and port, flushes the same
  columnar batch, through the native emit tier and through the Python
  formatter, its object path and its events: the requests an injected
  opener records (URL, headers, body) or the bytes a local listener
  receives are equal. ``Idempotency-Key`` headers carry a per-process
  random sender token, pinned here to one value in both packages; the
  key order across a sink's parallel POSTs is the threads', so requests
  compare as multisets and the keys as a set.
* The factory builds each sink from its key as the JAX factory does,
  the Kafka, Splunk, X-Ray, LightStep and falconer keys included;
  ``reader_shards``
  (the key, ``VENEUR_READER_SHARDS`` and the default -1) resolves as in
  the JAX package and the server runs that many reader shards.
* A JAX server and a port server, built by their factories with the
  same config, fed the same datagrams and flushed at one ``now``, send
  the same bytes to every sink.
"""

from __future__ import annotations

import logging
import socket
import threading
import time

import numpy as np
import pytest

from veneur_tpu.core import flusher as jflusher
from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.factory import build_server as jbuild
from veneur_tpu.core.metrics import HistogramAggregates as JAggs
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu_torch.core import flusher as tflusher
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import RUNS_WITHOUT_KEYS
from veneur_tpu_torch.core.factory import build_server as tbuild
from veneur_tpu_torch.core.metrics import HistogramAggregates as TAggs
from veneur_tpu_torch.protocol import dogstatsd as tdog

NOW = 1_700_000_000
PCTS = [0.5, 0.99]
AGGS = ["min", "max", "count", "sum", "avg"]


# -- capture ------------------------------------------------------------------


class Recorder:
    """An opener that records every request and answers 202."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = []

    def __call__(self, req, timeout):
        with self.lock:
            self.requests.append((req.full_url, req.get_method(),
                                  dict(req.header_items()), req.data))
        return b"{}"

    def normalized(self):
        """(multiset of requests without Idempotency-Key, set of keys)."""
        reqs, keys = [], set()
        for url, method, headers, body in self.requests:
            headers = dict(headers)
            key = headers.pop("Idempotency-key", None)
            if key is not None:
                keys.add(key)
            reqs.append((url, method, sorted(headers.items()), body))
        return sorted(reqs), keys


class Listener:
    """A local TCP or UDP listener that keeps every byte it receives."""

    def __init__(self, proto: str):
        self.proto = proto
        kind = socket.SOCK_STREAM if proto == "tcp" else socket.SOCK_DGRAM
        self.sock = socket.socket(socket.AF_INET, kind)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.chunks: list[bytes] = []
        self.readers: list[threading.Thread] = []
        self.lock = threading.Lock()
        self.stop = False
        if proto == "tcp":
            self.sock.listen(4)
        self.sock.settimeout(0.1)
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def _read(self, conn):
        conn.settimeout(0.1)
        while not self.stop:
            try:
                data = conn.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                return
            with self.lock:
                self.chunks.append(data)

    def _run(self):
        while not self.stop:
            try:
                if self.proto == "udp":
                    data = self.sock.recv(1 << 16)
                    with self.lock:
                        self.chunks.append(data)
                    continue
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            reader = threading.Thread(target=self._read, args=(conn,),
                                      daemon=True)
            reader.start()
            with self.lock:
                self.readers.append(reader)

    def received(self) -> list[bytes]:
        """What arrived: for TCP one joined stream, once the sender's
        connection was accepted and closed; for UDP the datagrams, once
        none has arrived for a second."""
        if self.proto == "tcp":
            deadline = time.monotonic() + 30
            while not self.readers and time.monotonic() < deadline:
                time.sleep(0.01)
            with self.lock:
                readers = list(self.readers)
            assert readers, "no sender connected"
            for reader in readers:
                reader.join(timeout=30)
                assert not reader.is_alive(), "a sender kept its socket"
        else:
            last, since = -1, time.monotonic()
            while time.monotonic() - since < 1.0:
                with self.lock:
                    n = len(self.chunks)
                if n != last:
                    last, since = n, time.monotonic()
                time.sleep(0.02)
        with self.lock:
            chunks = list(self.chunks)
        return chunks if self.proto == "udp" else [b"".join(chunks)]

    def close(self):
        self.stop = True
        self.thread.join(timeout=2)
        self.sock.close()


# -- one batch through both packages -----------------------------------------


def _lines(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(30):
        for v in rng.gamma(2.0, 30.0, 6):
            out.append(f"lat.{i}:{v:.4f}|ms|#ep:e{i % 4},host:h{i % 3}")
    for i in range(12):
        out.append(f"req.{i}:{1 + i % 3}|c|#code:{i % 2},device:d{i}")
        out.append(f"temp.{i}:{rng.normal(20.0, 3.0):.5f}|g|#über:ü{i}")
        out.append(f"users.{i % 3}:u{i}|s")
    out += ["big.c:1e308|c", "big.c:1e308|c", "huge:1e308|h",
            "routed:1|c|#veneursinkonly:datadog",
            "_sc|svc.up|0|#role:primary|m:all good"]
    return [ln.encode() for ln in out]


def _batches():
    qs = jflusher.device_quantiles(PCTS, JAggs.from_names(AGGS))
    jwk, twk = jw.DeviceWorker(), tw.DeviceWorker(device="cpu")
    for w, dog in ((jwk, jdog), (twk, tdog)):
        for ln in _lines(5):
            w.process_metric(dog.parse_service_check(ln)
                             if ln.startswith(b"_sc") else
                             dog.parse_metric(ln))
    js, ts = jwk.flush(qs), twk.flush(qs)
    return (jflusher.generate_columnar(js, True, PCTS,
                                       JAggs.from_names(AGGS), now=NOW),
            tflusher.generate_columnar(ts, True, PCTS,
                                       TAggs.from_names(AGGS), now=NOW))


def _samples(dog):
    return [dog.parse_event(b"_e{5,11}:title|hello world|d:1700000000|"
                            b"#evt:1,k"),
            dog.parse_event(b"_e{3,4}:abc|body|d:1700000001|h:host9|k:agg|"
                            b"p:low|s:src|t:error")]


HTTP_SINKS = {
    "datadog": ("veneur_tpu{}.sinks.datadog", "DatadogMetricSink", dict(
        interval=10.0, flush_max_per_body=7, hostname="agg-1",
        tags=["common:tag", "secret:x"], dd_hostname="http://dd.local",
        api_key="k1", metric_name_prefix_drops=["temp.1"],
        excluded_tags=["secret"])),
    "signalfx": ("veneur_tpu{}.sinks.signalfx", "SignalFxMetricSink", dict(
        api_key="sk", hostname="agg-1", endpoint_base="http://sfx.local",
        metric_tag_prefix_drops=["code:1"])),
    "exposition": ("veneur_tpu{}.sinks.prometheus",
                   "PrometheusExpositionSink",
                   dict(address="http://pgw.local/metrics/job/v")),
    "newrelic": ("veneur_tpu{}.sinks.newrelic", "NewRelicMetricSink", dict(
        account_id=42, insert_key="nk", common_tags=["team:obs"])),
}


def _make(spec, pkg, **extra):
    import importlib

    mod, cls, kw = spec
    sink = getattr(importlib.import_module(mod.format(pkg)), cls)(
        **kw, **extra)
    if getattr(sink, "delivery", None) is not None:
        sink.delivery._mint_sender = "fixed-sender"
    return sink


@pytest.mark.parametrize("path", ["native", "python", "objects"])
@pytest.mark.parametrize("name", sorted(HTTP_SINKS))
def test_http_sink_requests_equal_jax(name, path):
    jb, tb = _batches()
    recs = []
    for pkg, batch, dog in (("", jb, jdog), ("_torch", tb, tdog)):
        rec = Recorder()
        sink = _make(HTTP_SINKS[name], pkg, opener=rec)
        excl = {"ep"}
        if path == "native" and getattr(sink, "supports_native_emit",
                                        False):
            assert sink.flush_columnar_native(batch, excl)
        elif path == "objects":
            sink.flush(batch.materialize())
        else:
            sink.flush_columnar(batch, excl)
        sink.flush_other_samples(_samples(dog))
        recs.append(rec)
    j, t = recs[0].normalized(), recs[1].normalized()
    assert t == j
    assert t[0], "the sink sent nothing"


@pytest.mark.parametrize("proto,emit", [
    ("tcp", "native"), ("tcp", "python"), ("udp", "native")])
@pytest.mark.parametrize("name", ["forward", "repeater"])
def test_socket_sink_bytes_equal_jax(name, proto, emit):
    """Over UDP only the native tier's line-aligned 8 KiB datagrams:
    the Python formatter sends a datagram a line, which a loaded host
    drops on the loopback."""
    import importlib

    jb, tb = _batches()
    got = []
    for pkg, batch in (("", jb), ("_torch", tb)):
        lst = Listener(proto)
        if name == "forward":
            mod = importlib.import_module(
                f"veneur_tpu{pkg}.sinks.forward_statsd")
            sink = mod.ForwardStatsdSink(lst.address, proto)
        else:
            mod = importlib.import_module(f"veneur_tpu{pkg}.sinks.prometheus")
            sink = mod.PrometheusMetricSink(lst.address, proto)
        try:
            if emit == "native":
                assert sink.flush_columnar_native(batch, {"ep"})
            else:
                sink.flush_columnar(batch, {"ep"})
            if proto == "tcp":
                sink.flush(batch.materialize())
            sink._sock.close()
            got.append(lst.received())
        finally:
            lst.close()
    assert got[1] == got[0]
    assert b"\n".join(got[1]).count(b"\n") > 100


# -- the factory ----------------------------------------------------------------


SINK_KEYS = {
    "DatadogMetricSink": {"datadog_api_key": "k",
                          "datadog_api_hostname": "http://dd.local"},
    "SignalFxMetricSink": {"signalfx_api_key": "sk"},
    "PrometheusMetricSink": {"prometheus_repeater_address": "127.0.0.1:9"},
    "PrometheusExpositionSink": {
        "prometheus_pushgateway_address": "http://127.0.0.1:9/m"},
    "ForwardStatsdSink": {"forward_statsd_address": "127.0.0.1:9"},
    "NewRelicMetricSink": {"newrelic_insert_key": "nk",
                           "newrelic_account_id": 7},
}
# each flush is itself a span that derives an ssf.names_unique set at
# ssf_span_uniqueness_rate from the unseeded global random; 0 keeps the
# multi-flush comparisons deterministic (test_torch_spans.py seeds it)
BASE = {"interval": "10s", "hostname": "parity-host",
        "tpu_native_ingest": False, "tpu_native_readers": False,
        "micro_fold": False, "ssf_span_uniqueness_rate": 0.0}


def _policy(sink):
    man = getattr(sink, "delivery", None)
    return None if man is None else vars(man.policy)


@pytest.mark.parametrize("cls", sorted(SINK_KEYS))
def test_factory_builds_each_sink_as_jax(cls):
    data = {**BASE, "sink_retry_max": 3, "tags": ["a:b"],
            **SINK_KEYS[cls]}
    js = jbuild(jload(data=data))
    ts = tbuild(tload(data=data), device="cpu")
    try:
        jn = [type(s).__name__ for s in js.metric_sinks]
        tn = [type(s).__name__ for s in ts.metric_sinks]
        assert tn == jn == [cls]
        j, t = js.metric_sinks[0], ts.metric_sinks[0]
        assert t.name() == j.name() and _policy(t) == _policy(j)
        for attr in ("hostname", "tags", "api_key", "address", "url",
                     "network_type", "flush_timeout_s"):
            assert getattr(t, attr, None) == getattr(j, attr, None), attr
        assert ts.flush_emit_native == js.flush_emit_native is True
    finally:
        js.shutdown()
        ts.shutdown()


def test_factory_builds_every_sink_at_once():
    data = {**BASE, "debug_flushed_metrics": True}
    for keys in SINK_KEYS.values():
        data.update(keys)
    js = jbuild(jload(data=data))
    ts = tbuild(tload(data=data), device="cpu")
    try:
        assert [s.name() for s in ts.metric_sinks] == \
            [s.name() for s in js.metric_sinks]
        assert len(ts.metric_sinks) == 7
        assert set(ts.delivery_stats()) == {
            "datadog", "signalfx", "prometheus", "forward_statsd"}
    finally:
        js.shutdown()
        ts.shutdown()


# companions a key needs before the JAX factory builds its sinks
SINK_KEY_COMPANIONS = {
    "kafka_broker": {"kafka_metric_topic": "metrics",
                     "kafka_span_topic": "spans"},
    "splunk_hec_address": {"splunk_hec_token": "tok"},
}


@pytest.mark.parametrize("key,value", [
    ("kafka_broker", "127.0.0.1:9092"),
    ("splunk_hec_address", "http://127.0.0.1:9"),
    ("xray_address", "127.0.0.1:2000"),
    ("lightstep_access_token", "t"),
    ("trace_lightstep_access_token", "t"),
    ("falconer_address", "127.0.0.1:9"),
    ("spill_journal_dir", "/nonexistent"),
])
def test_unported_sink_keys_refused_by_name(key, value, tmp_path):
    data = {**BASE, key: value, "newrelic_insert_key": "nk",
            "newrelic_account_id": 7}
    if key == "spill_journal_dir":
        # the spill journal is ported: the server journals each network
        # sink's spill at start() (tests/test_torch_journal.py)
        data[key] = str(tmp_path / "wal")
        srv = tbuild(tload(data=data), device="cpu")
        try:
            srv._attach_journals()
            assert sorted(srv._journals) == sorted(srv.delivery_stats())
            assert "newrelic" not in srv.delivery_stats()
        finally:
            srv.shutdown()
        assert srv._journals == {}
        return
    # the remaining sinks are ported: each key builds the JAX factory's
    # sinks, with the same delivery policy (tests/test_torch_kafka.py and
    # tests/test_torch_span_sinks.py hold their bytes)
    data.update(SINK_KEY_COMPANIONS.get(key, {}))
    built = [jbuild(jload(data=data)), tbuild(tload(data=data), device="cpu")]
    try:
        kinds = [[[(type(s).__name__, s.name(), _policy(s)) for s in sinks]
                  for sinks in (srv.metric_sinks, srv.span_sinks)]
                 for srv in built]
        assert kinds[1] == kinds[0]
        assert len(kinds[1][1]) == 1
    finally:
        for srv in built:
            srv.shutdown()


def test_no_default_runs_without_the_port():
    assert RUNS_WITHOUT_KEYS == ()


def _native_readers(**kw):
    return {**BASE, "tpu_native_ingest": True, "tpu_native_readers": True,
            "num_workers": 1, **kw}


def test_default_reader_shards_resolve_to_num_readers(monkeypatch):
    """The default -1 runs num_readers shared-nothing reader shards with
    native ingest and readers on and one worker, as the JAX package does
    (veneur_tpu/core/server.py:425-438); one reader keeps the routed
    path."""
    monkeypatch.delenv("VENEUR_READER_SHARDS", raising=False)
    srv = tbuild(tload(data=_native_readers(num_readers=2)), device="cpu")
    try:
        assert srv.native_mode and srv._reader_shards == 2
        assert len(srv.workers[0]._reader_ctxs) == 2
        assert srv.ingress_stats()["reader_shards"]["shards"] == 2
    finally:
        srv.shutdown()
    srv = tbuild(tload(data=_native_readers(num_readers=1)), device="cpu")
    try:
        assert srv._reader_shards == 0 and not srv.workers[0]._reader_ctxs
        assert "reader_shards" not in srv.ingress_stats()
    finally:
        srv.shutdown()


def test_explicit_reader_shards_honoured(monkeypatch):
    monkeypatch.delenv("VENEUR_READER_SHARDS", raising=False)
    srv = tbuild(tload(data=_native_readers(num_readers=4,
                                            reader_shards=2)),
                 device="cpu")
    try:
        assert srv._reader_shards == 2
        assert len(srv.workers[0]._reader_ctxs) == 2
    finally:
        srv.shutdown()


def test_reader_shards_env_hatch(monkeypatch):
    """VENEUR_READER_SHARDS overrides the key: 0 pins the routed path,
    a count above 0 sets the shards."""
    monkeypatch.setenv("VENEUR_READER_SHARDS", "0")
    srv = tbuild(tload(data=_native_readers(num_readers=4)), device="cpu")
    try:
        assert srv._reader_shards == 0
    finally:
        srv.shutdown()
    monkeypatch.setenv("VENEUR_READER_SHARDS", "3")
    srv = tbuild(tload(data=_native_readers(num_readers=4)), device="cpu")
    try:
        assert srv._reader_shards == 3
        assert len(srv.workers[0]._reader_ctxs) == 3
    finally:
        srv.shutdown()


# -- servers -------------------------------------------------------------------


def _datagrams(seed: int) -> list[bytes]:
    lines = _lines(seed)
    grams = [b"\n".join(lines[i:i + 9]) for i in range(0, len(lines), 9)]
    # events carry their own date (else it is the time they were parsed)
    return grams + [b"_e{5,11}:title|hello world|d:1700000000|#evt:1"]


@pytest.mark.parametrize("emit", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("ingest", [False, True], ids=["py", "cpp"])
def test_servers_send_the_same_bytes(ingest, emit):
    listeners, recs, servers = [], [], []
    try:
        for pkg in ("jax", "port"):
            rep, fwd = Listener("tcp"), Listener("tcp")
            listeners.append((rep, fwd))
            rec = Recorder()
            recs.append(rec)
            data = {**BASE, "percentiles": PCTS, "aggregates": AGGS,
                    "tpu_native_ingest": ingest, "flush_emit_native": emit,
                    "datadog_api_key": "k",
                    "datadog_api_hostname": "http://dd.local",
                    "datadog_flush_max_per_body": 11,
                    "signalfx_api_key": "sk",
                    "signalfx_endpoint_base": "http://sfx.local",
                    "prometheus_pushgateway_address": "http://pgw.local/m",
                    "prometheus_repeater_address": rep.address,
                    "forward_statsd_address": fwd.address,
                    "forward_statsd_network": "tcp",
                    "tags_exclude": ["ep|prometheus"]}
            srv = (jbuild(jload(data=data), opener=rec) if pkg == "jax"
                   else tbuild(tload(data=data), device="cpu", opener=rec))
            for s in srv.metric_sinks:
                if getattr(s, "delivery", None) is not None:
                    s.delivery._mint_sender = "fixed-sender"
            servers.append(srv)
        for srv in servers:
            for seed in (1, 2):
                for d in _datagrams(seed):
                    srv.process_metric_packet(d)
                out = srv.flush(now=NOW + seed)
                assert not isinstance(out, list) and len(out) > 100
    finally:
        for srv in servers:
            srv.shutdown()
            for s in srv.metric_sinks:
                if getattr(s, "_sock", None) is not None:
                    s._sock.close()
    (jrep, jfwd), (trep, tfwd) = listeners
    try:
        assert trep.received() == jrep.received()
        assert tfwd.received() == jfwd.received()
        assert recs[1].normalized() == recs[0].normalized()
        urls = {u.split("?")[0] for u, *_ in recs[1].requests}
        assert urls == {"http://dd.local/api/v1/series",
                        "http://dd.local/api/v1/check_run",
                        "http://dd.local/intake",
                        "http://sfx.local/v2/datapoint",
                        "http://sfx.local/v2/event", "http://pgw.local/m"}
        tc = servers[1].sink_counters()
        assert set(tc) == {"datadog", "signalfx", "prometheus",
                           "forward_statsd"}
        assert all(c["metrics_flushed_total"] > 100
                   and c["flush_error_total"] == 0 for c in tc.values())
        ds = servers[1].delivery_stats()
        assert ds == {r: m.stats() for r, m in servers[0]._delivery_managers()}
        assert all(d["delivered_payloads"] > 0 and d["spilled_payloads"] == 0
                   for d in ds.values())
    finally:
        for pair in listeners:
            for lst in pair:
                lst.close()


def test_quiet_tick_drains_the_spill_as_jax():
    """A Datadog endpoint down for one flush: its bodies spill. The next
    tick has nothing to flush, but drains the spill ahead of it, in both
    servers, with the same delivery counters."""
    from veneur_tpu.utils.http import HTTPError as JHTTPError
    from veneur_tpu_torch.utils.http import HTTPError as THTTPError

    results = []
    for pkg, err in (("jax", JHTTPError), ("port", THTTPError)):
        rec = Recorder()
        down = [True]

        def opener(req, timeout, rec=rec, down=down, err=err):
            if down[0]:
                raise err(503, b"unavailable")
            return rec(req, timeout)

        data = {**BASE, "percentiles": PCTS, "aggregates": AGGS,
                "datadog_api_key": "k",
                "datadog_api_hostname": "http://dd.local",
                "sink_retry_max": 0, "sink_breaker_threshold": 0}
        srv = (jbuild(jload(data=data), opener=opener) if pkg == "jax"
               else tbuild(tload(data=data), device="cpu", opener=opener))
        srv.metric_sinks[0].delivery._mint_sender = "fixed-sender"
        man = srv.metric_sinks[0].delivery
        try:
            for d in _datagrams(3):
                srv.process_metric_packet(d)
            srv.flush(now=NOW)
            spilled = man.stats()["spilled_payloads"]
            down[0] = False
            out = srv.flush(now=NOW + 10)
            assert len(out) == 0
            results.append((spilled, man.stats(), rec.normalized()))
        finally:
            srv.shutdown()
    (js, jstats, jreq), (ts, tstats, treq) = results
    assert ts == js > 0
    assert tstats == jstats and tstats["spilled_payloads"] == 0
    assert tstats["delivered_payloads"] == ts
    assert treq == jreq and treq[0]
