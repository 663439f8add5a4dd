"""The port's Server against the JAX package's, on the CPU.

The same DogStatsD lines go into ``veneur_tpu.core.server.Server``
(configured with tpu_native_ingest, tpu_native_readers and
flush_emit_native off, so it takes the Python path the port mirrors) and
into the port's Server built by its factory with ``device="cpu"``, both
with channel sinks, both flushed at the same ``now``: the InterMetrics
the sinks receive are identical. The JAX server flushes columnar
(family-major order) and the port row by row, so the lists are compared
in one canonical order; tests/test_columnar.py pins that both orders
carry the same multiset. Also: one UDP round trip through the port's
listener, the refusal of unported config keys by name, and the same
YAML loading in both packages.
"""

from __future__ import annotations

import dataclasses
import socket
import struct
import time
from pathlib import Path

import numpy as np
import pytest

from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import UnportedConfigError, build_server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TChannel

NOW = 1_700_000_000

BASE = {
    # each flush is itself a span that derives an ssf.names_unique set
    # at this rate from the unseeded global random; 0 keeps multi-flush
    # comparisons deterministic (test_torch_spans.py seeds it)
    "ssf_span_uniqueness_rate": 0.0,
    "percentiles": [0.5, 0.9, 0.99],
    "aggregates": ["min", "max", "count", "sum", "avg", "median", "hmean"],
    "interval": "10s",
    "hostname": "parity-host",
    "tpu_native_ingest": False,
    "tpu_native_readers": False,
    "flush_emit_native": False,
    "micro_fold": False,
    "tpu_stage_depth": 8,
    "tpu_batch_size": 64,
    "tpu_initial_histo_rows": 16,
}


def _datagrams(seed: int, n: int = 60) -> list[bytes]:
    """Multi-line datagrams: counters, gauges, histograms, timers,
    sampled metrics, scoped and routed series, a service check, an
    event."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = i % 23
        lines = [
            f"req.count:{1 + k % 3}|c|#route:{k % 4}",
            f"req.sampled:{2 + k % 2}|c|@0.5",
            f"cpu.load:{rng.normal(1.0, 0.3):.5f}|g|#host:h{k % 3}",
            f"lat.ms:{rng.gamma(2.0, 15.0):.4f}|ms|#ep:e{k}",
            f"size.h:{rng.lognormal(3.0, 1.0):.4f}|h",
            f"slow.ms:{rng.exponential(80.0):.3f}|ms|@0.25|#ep:e{k % 5}",
            f"loc.h:{rng.normal(5.0, 1.0):.4f}|h|#veneurlocalonly",
            f"glob.c:1|c|#veneurglobalonly",
            f"routed.g:{k}|g|#veneursinkonly:channel",
            f"hot.h:{rng.normal(0.0, 1.0):.5f}|h",
        ]
        out.append("\n".join(lines).encode())
    out.append(b"_sc|db.up|0|#role:primary|m:all good")
    out.append(b"_e{5,11}:title|hello world|#evt:1")
    return out


def _canonical(metrics) -> list[tuple]:
    rows = []
    for m in metrics:
        rows.append((m.name, m.timestamp, struct.pack("<d", float(m.value)),
                     tuple(m.tags), m.type.name, m.message, m.hostname,
                     None if m.sinks is None else tuple(sorted(m.sinks))))
    return sorted(rows)


def _jax_server(extra=None):
    cfg = jload(data={**BASE, **(extra or {})})
    sink = JChannel()
    server = JServer(cfg, metric_sinks=[sink])
    return server, sink


def _torch_server(extra=None):
    cfg = tload(data={**BASE, **(extra or {})})
    sink = TChannel()
    return build_server(cfg, extra_metric_sinks=[sink], device="cpu"), sink


def _drain(q):
    out = []
    while not q.empty():
        out.extend(q.get_nowait())
    return out


@pytest.mark.parametrize("seed,workers", [(1, 1), (2, 1), (3, 2)])
def test_intermetrics_identical(seed, workers):
    js, jsink = _jax_server({"num_workers": workers})
    ts, tsink = _torch_server({"num_workers": workers})
    for rnd in range(2):  # two intervals: the second starts fresh pools
        for d in _datagrams(seed * 10 + rnd):
            js.process_metric_packet(d)
            ts.process_metric_packet(d)
        js.flush(now=NOW + rnd)
        ts.flush(now=NOW + rnd)
        jm, tm = _drain(jsink.queue), _drain(tsink.queue)
        assert len(jm) > 100
        assert _canonical(jm) == _canonical(tm), f"interval {rnd}"
        je, te = _drain(jsink.other_samples), _drain(tsink.other_samples)
        assert [e.name for e in je] == [e.name for e in te] == ["title"]


def test_udp_round_trip():
    ts, sink = _torch_server({"statsd_listen_addresses":
                              ["udp://127.0.0.1:0"], "interval": "1h"})
    ports = ts.start()
    try:
        port = ports["udp://127.0.0.1:0"]
        assert port > 0
        grams = _datagrams(5, n=20)
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for d in grams:
                s.sendto(d, ("127.0.0.1", port))
        deadline = time.time() + 20
        while ts.packets_received < len(grams) and time.time() < deadline:
            time.sleep(0.05)
        assert ts.packets_received == len(grams)
        got = ts.flush(now=NOW)
        # the same datagrams handed in directly give the same metrics
        ref, _ = _torch_server()
        for d in grams:
            ref.process_metric_packet(d)
        assert _canonical(got) == _canonical(ref.flush(now=NOW))
        assert _canonical(_drain(sink.queue)) == _canonical(got)
    finally:
        assert ts.shutdown()


@pytest.mark.parametrize("key,value", [
    ("stats_address", "127.0.0.1:8125"),
    ("flush_pipeline", True),
    ("series_shards", 2),
    ("forward_discovery_file", "/nonexistent"),
    ("tenant_default_budget", 100),
    ("query_listen_addrs", ["http://127.0.0.1:0"]),
    ("forward_address", "127.0.0.1:9,127.0.0.1:10"),
    ("archive_dir", "/nonexistent"),
])
def test_unported_key_refused_by_name(key, value, tmp_path):
    # a forwarding fleet validates only over gRPC (core/config.py)
    data = {**BASE, "forward_use_grpc": True, key: value}
    if key == "archive_dir":
        # the flush archive is ported: the port builds the JAX factory's
        # MetricArchiveSink (tests/test_torch_archive.py)
        from veneur_tpu.core.factory import build_server as jbuild

        built = []
        for pkg, build in (("jax", lambda d: jbuild(jload(data=d))),
                           ("port", lambda d: build_server(
                               tload(data=d), device="cpu"))):
            built.append(build({**data, key: str(tmp_path / pkg)}))
        try:
            assert [[type(s).__name__ for s in srv.metric_sinks]
                    for srv in built] == [["MetricArchiveSink"]] * 2
            assert [srv.metric_sinks[0].writer.max_segments
                    for srv in built] == [8, 8]
        finally:
            for srv in built:
                srv.shutdown()
        return
    if key in ("forward_discovery_file", "forward_address"):
        # the sharded proxy tier is ported: the factory builds the fleet's
        # SpreadForwarder as the JAX factory does (tests/test_torch_spread.py)
        from veneur_tpu.core.factory import build_server as jbuild

        built = [jbuild(jload(data=data)),
                 build_server(tload(data=data), device="cpu")]
        try:
            assert [type(s.forwarder).__name__ for s in built] == \
                ["SpreadForwarder"] * 2
        finally:
            for s in built:
                s.shutdown()
        return
    if key in ("tenant_default_budget", "query_listen_addrs"):
        # tenancy and the live query path are ported: the port builds the
        # ledger, and the query engine whose fronts bind at start(), as
        # the JAX server does (tests/test_torch_tenancy.py,
        # tests/test_torch_query.py)
        from veneur_tpu.core.factory import build_server as jbuild

        built = [jbuild(jload(data=data)),
                 build_server(tload(data=data), device="cpu")]
        try:
            if key == "tenant_default_budget":
                for s in built:
                    assert s.tenant_ledger.default_budget == value
                    assert all(w.tenancy is s.tenant_ledger
                               and w.tenant_sketch is not None
                               for w in s.workers)
            else:
                ports = [s._start_query_listeners() for s in built]
                assert [sorted(p) for p in ports] == [value] * 2
                assert all(p[value[0]] > 0 for p in ports)
                assert all(len(s._query_servers) == 1
                           and s.query_engine is not None for s in built)
        finally:
            for s in built:
                s.shutdown()
        return
    if key in ("stats_address", "flush_pipeline"):
        # self-telemetry and the flush pipeline are ported: the port sends
        # its counters over UDP and builds the stage-parallel flush as the
        # JAX server does (tests/test_torch_lifecycle.py,
        # tests/test_torch_pipeline.py)
        from veneur_tpu.core.factory import build_server as jbuild

        built = [jbuild(jload(data=data)),
                 build_server(tload(data=data), device="cpu")]
        try:
            if key == "stats_address":
                senders = [built[0].stats._sender,
                           built[1].stats._client._sender]
                assert [type(x).__name__ for x in senders] == \
                    ["UDPSender"] * 2
                assert senders[0]._addr == senders[1]._addr
            else:
                assert [s.flush_pipeline.max_backlog for s in built] == \
                    [1, 1]
        finally:
            for s in built:
                s.shutdown()
        return
    with pytest.raises(UnportedConfigError, match=key):
        build_server(tload(data=data), device="cpu")


def test_same_yaml_loads_in_both():
    """example.yaml, and a config with no keys, load into field-for-field
    equal configs: the micro-fold and the device guard are on by default
    in both."""
    example = str(Path(__file__).resolve().parent.parent / "example.yaml")
    jc, tc = jload(example), tload(example)
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert jd.keys() == td.keys()
    assert {k for k in jd if jd[k] != td[k]} == set()
    assert dataclasses.asdict(jload(data={})) == dataclasses.asdict(
        tload(data={}))
    assert tload(data={}).micro_fold is True
    assert tload(data={}).device_guard is True
