"""The port's load generator (veneur_tpu_torch/loadgen, its native half
in veneur_tpu_torch.native) against the JAX package's, on the CPU.

* tests/test_loadgen.py's cases, each on the port: ring synthesis
  determinism, datagram packing, serialize/load and capture/replay bit
  exactness, the paced sender, spec and config validation, the parity of
  the generated lines through both parsers, the tenant dimension, and
  the server's lifetime ingress counters.
* The library: built from native/loadgen.cpp into build/native/, its
  compiled stamp the source's hash; rings equal to the JAX library's
  (hash, lines, bytes, datagrams) for the default, an abusive-tenant and
  the SSF spec, in one process.
* The slice as a whole: the default spec's ring through a JAX Server and
  a port Server, on the Python and the native path, flushes bitwise
  equal InterMetrics.
* The controller: ``classify_warmup`` equals the JAX function; a port
  ``LoadHarness`` on the CPU holds 20,000 lines/s over two 0.5 s
  intervals with every sent line accepted, and its records carry the
  JAX harness's keys.
* ``Server.ingress_stats()`` has the JAX server's key set on the Python,
  native and pipelined paths and with a delivery sink; its micro-fold
  counts equal the JAX server's after a micro-folded interval.
"""

from __future__ import annotations

import copy
import hashlib
import socket
import struct
import time
from pathlib import Path

import pytest

from veneur_tpu import native as jnative
from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.loadgen import controller as jcontroller
from veneur_tpu.loadgen.spec import WorkloadSpec as JSpec
from veneur_tpu_torch import native as native_mod
from veneur_tpu_torch.core.config import Config, validate_config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.loadgen import controller as tcontroller
from veneur_tpu_torch.loadgen.spec import WorkloadSpec
from veneur_tpu_torch.protocol import ssf_wire
from veneur_tpu_torch.protocol.dogstatsd import parse_metric

ROOT = Path(__file__).resolve().parent.parent
NOW = 1_700_000_000


def small_spec(**kw) -> WorkloadSpec:
    base = dict(seed=11, num_keys=200, zipf_s=1.1, num_tags=2,
                tag_cardinality=10, datagram_bytes=512, ring_lines=500)
    base.update(kw)
    return WorkloadSpec(**base)


def _canonical(metrics) -> list[tuple]:
    return sorted(
        (m.name, m.timestamp, struct.pack("<d", float(m.value)),
         tuple(m.tags), m.type.name, m.message, m.hostname,
         None if m.sinks is None else tuple(sorted(m.sinks)))
        for m in metrics)


# -- tests/test_loadgen.py's cases on the port --------------------------------


def test_synth_deterministic():
    a = small_spec().build_ring()
    b = small_spec().build_ring()
    assert a.content_hash == b.content_hash
    assert len(a) == len(b)
    assert a.total_lines == b.total_lines == 500
    assert small_spec(seed=12).build_ring().content_hash != a.content_hash


def test_synth_respects_datagram_target():
    ring = small_spec().build_ring()
    for d in ring.datagrams():
        assert 0 < len(d) <= 512
        assert not d.endswith(b"\n")


def test_serialize_load_bit_exact():
    ring = small_spec().build_ring()
    blob = ring.serialize()
    other = native_mod.LoadgenRing()
    assert other.load(blob) == len(ring)
    assert other.content_hash == ring.content_hash
    assert other.total_lines == ring.total_lines
    assert other.datagram(0) == ring.datagram(0)
    assert other.datagram(len(ring) - 1) == ring.datagram(len(ring) - 1)
    assert other.serialize() == blob


def test_ring_append():
    ring = native_mod.LoadgenRing()
    ring.append(b"x.a:1|c", lines=1)
    ring.append(b"x.a:1|c\nx.b:2|g", lines=2)
    assert len(ring) == 2
    assert ring.total_lines == 3
    assert ring.datagram(1) == b"x.a:1|c\nx.b:2|g"


def test_spec_validation():
    for bad in (dict(num_keys=0), dict(zipf_s=-1.0), dict(num_tags=17),
                dict(type_mix=[0.0] * 5), dict(type_mix=[1.0]),
                dict(datagram_bytes=10), dict(ring_lines=0),
                dict(prefix="")):
        with pytest.raises(ValueError):
            small_spec(**bad).build_ring()


def test_config_loadgen_validation():
    with pytest.raises(ValueError):
        validate_config(Config(loadgen_num_keys=0))
    with pytest.raises(ValueError):
        validate_config(Config(loadgen_type_mix=[1.0, 1.0]))
    with pytest.raises(ValueError):
        validate_config(Config(loadgen_prefix="9bad"))
    validate_config(Config())
    spec = WorkloadSpec.from_config(Config())
    spec.validate()
    assert spec.to_dict() == JSpec.from_config(JConfig()).to_dict()


def test_generated_lines_parse_both_parsers():
    """The Python parser, the C++ parser and the ring's own line tally
    agree on every generated datagram."""
    ring = small_spec().build_ring()
    ni = native_mod.NativeIngest()
    py_total = 0
    for dgram in ring.datagrams():
        for line in dgram.split(b"\n"):
            m = parse_metric(line)
            assert m.key.name.startswith("lg.")
            py_total += 1
        ni.ingest(dgram)
    assert py_total == ring.total_lines
    assert ni.processed == ring.total_lines
    assert ni.errors == 0


def test_ssf_ring_parses_both_paths():
    spec = small_spec()
    ring = spec.build_ssf_ring(n_spans=25)
    assert ring.total_lines == 25
    ni = native_mod.NativeIngest()
    for payload in ring.datagrams():
        span = ssf_wire.parse_ssf(payload)
        assert span.name.startswith("lg.")
        assert ni.ingest_ssf(payload, b"ind.t", b"obj.t") == 1


def test_capture_replay_bit_exact():
    """A capture of a full ring pass hashes identically to the ring."""
    ring = small_spec().build_ring()
    a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_DGRAM)
    try:
        cap = native_mod.LoadgenCapture(a.fileno(), max_len=2048,
                                        max_packets=len(ring))
        sender = native_mod.LoadgenSender(ring, b.fileno(),
                                          lines_per_s=2_000_000,
                                          max_lines=ring.total_lines)
        deadline = time.time() + 30
        while cap.packets < len(ring) and time.time() < deadline:
            time.sleep(0.01)
        sender.stop()
        assert cap.truncated == 0
        assert cap.packets == len(ring)
        cap.stop()
        replay = cap.detach_ring()
    finally:
        a.close()
        b.close()
    assert replay.content_hash == ring.content_hash
    assert replay.serialize() == ring.serialize()


def test_sender_paces_and_stops_at_max_lines():
    ring = small_spec().build_ring()
    recv = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    recv.bind(("127.0.0.1", 0))
    send = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    send.connect(recv.getsockname())
    try:
        sender = native_mod.LoadgenSender(ring, send.fileno(),
                                          lines_per_s=25_000,
                                          max_lines=5_000)
        deadline = time.time() + 10
        while not sender.done and time.time() < deadline:
            time.sleep(0.01)
        assert sender.done
        elapsed = sender.stop()
        assert sender.sent_lines == 5_000
        assert sender.send_errors == 0
        # 5k lines at 25k lines/s is about 0.2 s: bounds that catch an
        # instant blast or a 10x stall on a loaded host
        assert 0.1 < elapsed < 2.0
    finally:
        send.close()
        recv.close()


def test_server_ingress_stats_survive_flush():
    """samples_processed is a lifetime counter: the per-epoch count
    resets at the swap, the lifetime tally accumulates across flushes,
    and flush_count counts the flushes."""
    cfg = Config(interval="10s", num_workers=1, percentiles=[0.5])
    srv = Server(cfg, device="cpu")
    try:
        for i in range(60):
            srv.process_metric_packet(b"ig.c%d:1|c" % (i % 7))
        st = srv.ingress_stats()
        assert st["samples_processed"] == 60
        assert st["overload_dropped"] == 0
        assert st["flush_count"] == 0
        srv.flush()
        assert srv.ingress_stats()["samples_processed"] == 60
        for _ in range(15):
            srv.process_metric_packet(b"ig.more:2.5|ms")
        srv.flush()
        st = srv.ingress_stats()
        assert st["samples_processed"] == 75
        assert st["flush_count"] >= 2
        assert st["last_flush_unix"] > 0 and st["last_emit_unix"] > 0
    finally:
        srv.shutdown()


def test_tenant_synth_deterministic_and_tagged():
    spec = small_spec(tenant_count=4, tenant_abusive_frac=0.3,
                      tenant_zipf_s=1.0, tenant_churn_keys=50)
    a = spec.build_ring()
    b = spec.build_ring()
    assert a.content_hash == b.content_hash
    seen = set()
    for dgram in a.datagrams():
        for line in dgram.split(b"\n"):
            m = parse_metric(line)
            tenants = [t for t in m.tags if t.startswith("tenant:")]
            assert len(tenants) == 1
            assert m.tags[-1] == tenants[0]  # tenant tag appended last
            seen.add(tenants[0])
    assert seen <= {"tenant:t%d" % i for i in range(4)}
    assert len(seen) >= 2


def test_single_tenant_emits_no_tenant_tag():
    ring = small_spec(tenant_count=1).build_ring()
    for dgram in ring.datagrams():
        assert b"tenant:" not in dgram
    legacy = small_spec().build_ring()
    assert ring.content_hash == legacy.content_hash
    assert ring.serialize() == legacy.serialize()


def test_abusive_tenant_churns_keys_beyond_num_keys():
    spec = small_spec(num_keys=50, tenant_count=3,
                      tenant_abusive_frac=0.5, tenant_churn_keys=400,
                      ring_lines=2000)
    churned = set()
    abusive_lines = 0
    for dgram in spec.build_ring().datagrams():
        for line in dgram.split(b"\n"):
            m = parse_metric(line)
            key_id = int(m.key.name.split(".")[-1].lstrip(
                "abcdefghijklmnopqrstuvwxyz"))
            if "tenant:t2" in m.tags:  # the last tenant is the abuser
                abusive_lines += 1
                assert key_id >= 50
                churned.add(key_id)
            else:
                assert key_id < 50
    assert abusive_lines > 500
    assert len(churned) > 100


def test_spec_tenant_validation():
    for bad in (dict(tenant_count=0), dict(tenant_count=5000),
                dict(tenant_abusive_frac=-0.1),
                dict(tenant_abusive_frac=1.5),
                dict(tenant_zipf_s=-1.0), dict(tenant_churn_keys=-1)):
        with pytest.raises(ValueError):
            small_spec(**bad).build_ring()


def test_config_loadgen_tenant_keys_flow_to_spec():
    cfg = Config(loadgen_tenant_count=8, loadgen_tenant_abusive_frac=0.25,
                 loadgen_tenant_zipf_s=1.2, loadgen_tenant_churn_keys=99)
    validate_config(cfg)
    spec = WorkloadSpec.from_config(cfg)
    assert spec.tenant_count == 8
    assert spec.tenant_abusive_frac == 0.25
    assert spec.tenant_zipf_s == 1.2
    assert spec.tenant_churn_keys == 99
    assert spec.to_dict()["tenant_count"] == 8


# -- the library against the JAX package's ------------------------------------


def test_loadgen_library_built_from_source():
    """The port's library is g++'s build of native/loadgen.cpp under
    build/native/, stamped with the source's hash (the Makefile's
    LG_SRC_HASH); the JAX package's committed library is not loaded."""
    stamp = hashlib.sha256(
        (ROOT / "native" / "loadgen.cpp").read_bytes()).hexdigest()[:16]
    assert native_mod.loadgen_available()
    assert native_mod.loadgen_source_hash() == stamp
    assert native_mod.loadgen_source_stamp() == stamp
    path = native_mod.loadgen_library_path()
    assert path.parent == ROOT / "build" / "native" and path.exists()
    assert path.name.startswith("libveneur_loadgen-")
    assert native_mod.load_loadgen_library()._name == str(path)


def test_loadgen_build_failure_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's message: nothing
    falls back to another library."""
    monkeypatch.setattr(native_mod, "loadgen_library_path",
                        lambda: tmp_path / "libveneur_loadgen-x.so")
    monkeypatch.setattr(native_mod, "LOADGEN_SOURCE", "no_such_file.cpp")
    monkeypatch.setattr(native_mod, "loadgen_source_stamp", lambda: "0")
    with pytest.raises(RuntimeError, match="native build failed"):
        native_mod.build_loadgen()


def _ring_facts(ring) -> tuple:
    return (ring.content_hash, ring.total_lines, ring.total_bytes,
            len(ring), ring.datagrams())


SPECS = {
    "default": {"ring_lines": 20_000},
    "abusive_tenants": {"ring_lines": 20_000, "tenant_count": 4,
                        "tenant_abusive_frac": 0.3, "tenant_zipf_s": 1.0,
                        "tenant_churn_keys": 5_000},
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_ring_equals_jax_ring(name):
    """The same spec synthesizes the same ring in the port's library and
    in the JAX package's: hash, lines, bytes and every datagram."""
    t = WorkloadSpec(**SPECS[name]).build_ring()
    j = JSpec(**SPECS[name]).build_ring()
    assert _ring_facts(t) == _ring_facts(j)
    assert t.serialize() == j.serialize()


def test_ssf_ring_equals_jax_ring():
    t = WorkloadSpec().build_ssf_ring(300)
    j = JSpec().build_ssf_ring(300)
    assert t.serialize() == j.serialize()
    assert _ring_facts(t) == _ring_facts(j)


# -- the slice as a whole -----------------------------------------------------


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_default_ring_through_servers_equals_jax(native):
    """The default spec's ring (cut to 20,000 lines) through
    process_metric_packet (handle_metric_packet a line, or the native
    context) of a JAX server and of a port server on the CPU, then one
    flush: the InterMetrics are bitwise equal."""
    data = dict(num_workers=1, num_readers=1, interval="10s",
                percentiles=[0.5, 0.99], statsd_listen_addresses=[],
                tpu_native_ingest=native, tpu_native_readers=False,
                ssf_span_uniqueness_rate=0.0)
    from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    ring = WorkloadSpec(ring_lines=20_000).build_ring()
    js = JServer(JConfig(**data), metric_sinks=[JChannel()])
    ts = Server(Config(**data), device="cpu",
                metric_sinks=[ChannelMetricSink()])
    try:
        assert js.native_mode == ts.native_mode == native
        for d in ring.datagrams():
            js.process_metric_packet(d)
            ts.process_metric_packet(d)
        jm = _canonical(js.flush(now=NOW))
        tm = _canonical(ts.flush(now=NOW))
    finally:
        js.shutdown()
        ts.shutdown()
    assert len(tm) > 1000
    assert tm == jm
    assert ts.ingress_stats()["samples_processed"] == ring.total_lines


# -- the controller -----------------------------------------------------------


def _iv(ok: bool, tick: float = 100.0, stall: float = 50.0) -> dict:
    return {"cadence_ok": ok, "tick_block_ms": tick,
            "ingest_stall_ms": stall, "flush_ms": tick * 2,
            "drain_ms": 1.0}


WARMUP_CASES = {
    "first_interval_first_use": [_iv(False, tick=1105.8)]
    + [_iv(True) for _ in range(9)],
    "grace_is_one_interval": [_iv(False), _iv(False)]
    + [_iv(True) for _ in range(8)],
    "never_reclassifies_good": [_iv(True), _iv(False)]
    + [_iv(True) for _ in range(4)],
    "all_warmup": [_iv(False)],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(WARMUP_CASES))
def test_classify_warmup_equals_jax(case):
    """tests/test_microfold.py's interval records through both
    packages' classify_warmup: the same result and the same stamps."""
    t_ivs = copy.deepcopy(WARMUP_CASES[case])
    j_ivs = copy.deepcopy(WARMUP_CASES[case])
    assert tcontroller.classify_warmup(t_ivs) == \
        jcontroller.classify_warmup(j_ivs)
    assert t_ivs == j_ivs


def _harness_config(cfg_cls, **kw):
    return cfg_cls(statsd_listen_addresses=["udp://127.0.0.1:0"],
                   interval="0.5s", num_workers=1, num_readers=1,
                   percentiles=[0.5, 0.99],
                   read_buffer_size_bytes=8 * 1048576, **kw)


def test_harness_trial_loses_nothing(monkeypatch):
    """A port LoadHarness on the CPU at 20,000 lines/s over two 0.5 s
    intervals: the trial passes, and once the sender stops every line
    it sent is in the server's lifetime tally. The records carry the
    JAX harness's keys."""
    senders = []

    class Recorded(native_mod.LoadgenSender):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            senders.append(self)

    monkeypatch.setattr(native_mod, "LoadgenSender", Recorded)
    spec = WorkloadSpec(num_keys=500, ring_lines=5_000)
    # no sample derived from the server's own flush spans (each a 1 in
    # 100 ssf.names_unique set sample by default): the tally holds only
    # the lines sent
    h = tcontroller.LoadHarness(
        _harness_config(Config, ssf_span_uniqueness_rate=0.0), spec,
        device="cpu")
    try:
        before = h.server.ingress_stats()["samples_processed"]
        trial = tcontroller.run_trial(h, 20_000, 2)
        sent = sum(s.sent_lines for s in senders)
        deadline = time.time() + 20
        while (h.server.ingress_stats()["samples_processed"] - before
               < sent and time.time() < deadline):
            time.sleep(0.02)
        got = h.server.ingress_stats()["samples_processed"] - before
    finally:
        h.close()
    assert trial["passed"], {k: v for k, v in trial.items()
                             if k != "intervals"}
    assert trial["intervals_completed"] == 2
    assert sent > 0 and got == sent
    assert trial["total_shed"] == 0 and h.flushed_series > 0
    # the cadence fields come from keys the server reports (F5): a flush
    # happened in every window and the tick was timed
    assert all(iv["flushes"] >= 1 for iv in trial["intervals"])
    assert all(iv["tick_block_ms"] > 0 for iv in trial["intervals"])
    jh = jcontroller.LoadHarness(_harness_config(JConfig),
                                 JSpec(num_keys=500, ring_lines=5_000))
    try:
        jtrial = jh.run_intervals(5_000, 1)
    finally:
        jh.close()
    assert set(trial) - {"passed"} == set(jtrial)
    assert set(trial["intervals"][0]) == set(jtrial["intervals"][0])


def test_harness_over_unixgram(tmp_path):
    """The unixgram transport: the sender finds the path-based listener
    through the configuration (start() reports none), and the server's
    Python reader takes the lines a trial sends (cadence is not judged:
    the Python reader shares the interpreter with the flush)."""
    path = tmp_path / "lg.sock"
    cfg = _harness_config(Config)
    cfg.statsd_listen_addresses = [f"unixgram://{path}"]
    h = tcontroller.LoadHarness(cfg, WorkloadSpec(num_keys=500,
                                                  ring_lines=5_000),
                                transport="unixgram", device="cpu")
    try:
        trial = tcontroller.run_trial(h, 5_000, 2)
    finally:
        h.close()
    assert trial["intervals_completed"] == 2
    assert trial["total_accepted"] > 0 and trial["loss_frac"] <= 0.01, {
        k: v for k, v in trial.items() if k != "intervals"}


# -- ingress_stats: the JAX key set and the micro-fold counts -----------------


def _dd_sink(mod):
    return mod.DatadogMetricSink(
        interval=10.0, flush_max_per_body=25000, hostname="h", tags=[],
        dd_hostname="http://127.0.0.1:9", api_key="k",
        opener=lambda req, timeout: b"{}")


PATHS = {
    "python": dict(tpu_native_ingest=False),
    "native": dict(tpu_native_ingest=True, tpu_native_readers=False),
    "pipelined": dict(tpu_native_ingest=False, flush_pipeline=True),
    "delivery": dict(tpu_native_ingest=False),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_ingress_stats_keys_equal_jax(path):
    from veneur_tpu.sinks import datadog as jdd
    from veneur_tpu_torch.sinks import datadog as tdd

    data = dict(num_workers=1, interval="10s", percentiles=[0.5],
                statsd_listen_addresses=[], **PATHS[path])
    js = JServer(JConfig(**data), metric_sinks=(
        [_dd_sink(jdd)] if path == "delivery" else None))
    ts = Server(Config(**data), device="cpu", metric_sinks=(
        [_dd_sink(tdd)] if path == "delivery" else None))
    try:
        for srv in (js, ts):
            for i in range(40):
                srv.process_metric_packet(b"k.c%d:1|c\nk.t:%d|ms" % (i, i))
        jst, tst = js.ingress_stats(), ts.ingress_stats()
        assert set(tst) == set(jst)
        for k in ("samples_processed", "flush_count", "micro_folds_total",
                  "last_micro_folds", "packets_received"):
            assert tst[k] == jst[k], k
        if path == "delivery":
            assert set(tst["delivery"]) == set(jst["delivery"]) == {
                "datadog"}
            assert set(tst["delivery"]["datadog"]) == \
                set(jst["delivery"]["datadog"])
        if path == "pipelined":
            assert "pipeline" in tst
    finally:
        js.shutdown()
        ts.shutdown()


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_micro_fold_counts_equal_jax(native):
    """Two micro-folds during an interval, then a flush: each server
    reports the same lifetime and last-interval micro-fold counts, and
    the flush's drain phase is timed."""
    data = dict(num_workers=1, interval="10s", percentiles=[0.5],
                statsd_listen_addresses=[], micro_fold=True,
                micro_fold_rows=1, tpu_batch_size=8,
                tpu_native_ingest=native,
                tpu_native_readers=False)
    js = JServer(JConfig(**data))
    ts = Server(Config(**data), device="cpu")
    try:
        for srv in (js, ts):
            for part in range(2):
                for i in range(30):
                    srv.process_metric_packet(
                        b"mf.t%d:%d.5|ms" % (i % 5, part * 30 + i))
                with srv._worker_locks[0]:
                    srv.workers[0].micro_fold_once()
            srv.flush(now=NOW)
        jst, tst = js.ingress_stats(), ts.ingress_stats()
    finally:
        js.shutdown()
        ts.shutdown()
    assert tst["micro_folds_total"] == jst["micro_folds_total"] == 2
    assert tst["last_micro_folds"] == jst["last_micro_folds"] == 2
    # the phases the controller's interval records read
    for k in ("swap_s", "drain_s", "generate_s"):
        assert k in tst["last_flush_phases"] and k in jst["last_flush_phases"]
