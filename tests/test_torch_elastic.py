"""Discovery and elastic membership of the PyTorch port against the JAX
package's, on the CPU. Every scenario runs through both packages and
what it observes must be equal.

* ``FileWatchDiscoverer``: the three file formats, re-parsing only on a
  signature change, missing and torn files, atomic write-back seen by
  another poller; the refresher keeps the last good membership.
* The Consul and Kubernetes parsers over the same scripted responses.
* ``HealthGate``: an unreachable candidate never enters the ring; a
  breaker-open member is quarantined through the handoff (ledgers
  conserved, every metric on the healthy member) and re-admitted only
  when its probe passes; the ``min_admitted`` floor; forgetting members
  that leave discovery.
* ``ElasticController`` scale decisions for scripted pressure sequences
  (hysteresis, graceful scale-in, deadband, floors, capacity, cooldown
  on an injected clock), and the pure policy functions.
"""

from __future__ import annotations

import importlib
import json
import random
import socket
import threading
import time

import pytest

ROOTS = {"jax": "veneur_tpu", "port": "veneur_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _both(scenario):
    outs = {pkg: scenario(pkg) for pkg in ROOTS}
    assert outs["port"] == outs["jax"]
    return outs["port"]


# -- FileWatchDiscoverer -------------------------------------------------------


def test_file_watch_formats_and_signature(tmp_path):
    def scenario(pkg):
        d = tmp_path / pkg
        d.mkdir()
        fw = mod(pkg, "distributed.discovery").FileWatchDiscoverer
        p = d / "members.json"
        out = []
        p.write_text(json.dumps({"members": ["a:1", "b:2"],
                                 "standby": ["c:3"]}))
        w = fw(str(p))
        out.append((w.get_destinations_for_service(), w.desired()))
        for _ in range(4):
            w.get_destinations_for_service()
        out.append(w.reads)
        p.write_text(json.dumps(["x:1", "y:2"]))
        out.append(fw(str(p)).desired())
        p.write_text("# global tier\na:1\n\nb:2\n")
        out.append(fw(str(p)).desired())
        # an atomic write-back bumps the signature for another poller
        p.write_text(json.dumps({"members": ["a:1"], "standby": ["b:2"]}))
        writer, other = fw(str(p)), fw(str(p))
        out.append(other.desired())
        writer.write_members(["a:1", "b:2"], [])
        out.append((other.desired(), writer.writes, other.reads))
        for bad, exc in ((d / "absent.json", OSError),
                         (d / "torn.json", ValueError)):
            if bad.name == "torn.json":
                bad.write_text('{"members": ["a:1"')
            with pytest.raises(exc):
                fw(str(bad)).get_destinations_for_service()
        return out

    out = _both(scenario)
    assert out[0] == (["a:1", "b:2"], (["a:1", "b:2"], ["c:3"]))
    assert out[1] == 1
    assert out[2] == (["x:1", "y:2"], [])
    assert out[3] == (["a:1", "b:2"], [])
    assert out[4] == (["a:1"], ["b:2"])
    assert out[5][0] == (["a:1", "b:2"], [])


def test_refresher_keeps_last_good_when_file_vanishes(tmp_path):
    def scenario(pkg):
        d = tmp_path / pkg
        d.mkdir()
        p = d / "members.json"
        p.write_text(json.dumps({"members": ["a:1", "b:2"]}))
        proxy_mod = mod(pkg, "distributed.proxy")
        proxy = proxy_mod.ProxyServer(["old:1"])
        try:
            r = proxy_mod.DestinationRefresher(
                proxy, mod(pkg, "distributed.discovery")
                .FileWatchDiscoverer(str(p)), "")
            r.refresh()
            first = proxy.ring.members()
            p.unlink()
            r.refresh()
            return (first, proxy.ring.members(), r.refresh_errors,
                    proxy.ring.version)
        finally:
            proxy.stop()

    assert _both(scenario) == (["a:1", "b:2"], ["a:1", "b:2"], 1, 2)


def test_refresher_jitter_under_one_seed():
    def scenario(pkg):
        proxy_mod = mod(pkg, "distributed.proxy")
        proxy = proxy_mod.ProxyServer(["a:1"])
        try:
            r = proxy_mod.DestinationRefresher(
                proxy, mod(pkg, "distributed.discovery")
                .FileWatchDiscoverer("unused"), "", interval_s=10.0,
                jitter=0.5, rng=random.Random(42))
            return [r._next_wait() for _ in range(200)]
        finally:
            proxy.stop()

    waits = _both(scenario)
    assert all(5.0 <= w <= 15.0 for w in waits)
    assert min(waits) < 6.0 and max(waits) > 14.0


# -- Consul and Kubernetes -----------------------------------------------------


CONSUL = [
    {"Node": {"Address": "10.0.0.1"},
     "Service": {"Address": "10.0.0.1", "Port": 8128}},
    {"Node": {"Address": "10.0.0.2"}, "Service": {"Address": "",
                                                  "Port": 8128}},
    {"Service": {"Address": "", "Port": 8128}, "Node": {}},
    {"Service": {"Address": "10.0.0.3"}},
    {"Node": {"Address": "10.0.0.4"}, "Service": {"Port": 9000}},
]


def _pod(ip, ports, phase="Running"):
    return {"status": {"phase": phase, "podIP": ip},
            "spec": {"containers": [{"ports": ports}]}}


K8S = {"items": [
    _pod("10.1.0.1", [{"name": "http", "containerPort": 80},
                      {"name": "grpc", "containerPort": 8128}]),
    _pod("10.1.0.2", [{"name": "http", "containerPort": 80},
                      {"name": "import", "containerPort": 8127}]),
    _pod("10.1.0.3", [{"name": "metrics", "containerPort": 9090},
                      {"name": "debug", "containerPort": 6060}]),
    _pod("10.1.0.4", []),
    _pod("10.1.0.5", [{"containerPort": 9999}], phase="Pending"),
]}


def test_consul_and_kubernetes_parsers_equal_jax():
    def scenario(pkg):
        disc = mod(pkg, "distributed.discovery")
        urls = []

        def consul_opener(url, **kw):
            urls.append(url)
            return json.dumps(CONSUL).encode()

        out = [disc.ConsulDiscoverer("http://consul:8500",
                                     opener=consul_opener)
               .get_destinations_for_service("veneur-global"), urls[0]]
        with pytest.raises(ValueError):
            disc.ConsulDiscoverer(opener=lambda url, **kw: b'{"not a list"'
                                  ).get_destinations_for_service("svc")
        out.append(disc.KubernetesDiscoverer(
            opener=lambda url, **kw: json.dumps(K8S).encode(), token="tok")
            .get_destinations_for_service("veneur-global"))
        return out

    consul, url, k8s = _both(scenario)
    assert consul == ["10.0.0.1:8128", "10.0.0.2:8128", "10.0.0.4:9000"]
    assert "v1/health/service/veneur-global?passing" in url
    assert k8s == ["10.1.0.1:8128", "10.1.0.2:8127", "10.1.0.3:9090"]


# -- HealthGate ----------------------------------------------------------------


class ScriptedClient:
    def __init__(self, pkg, dest):
        self._rpc = mod(pkg, "distributed.rpc")
        self.address = dest
        self.down = False
        self.sent = []
        self._lock = threading.Lock()

    def send_or_raise(self, batch, timeout_s=None):
        with self._lock:
            if self.down:
                raise self._rpc.ForwardError("unavailable", self.address,
                                             "scripted: down")
            self.sent.extend(m.name for m in batch.metrics)

    def stats(self):
        return {"address": self.address, "reconnects": 0, "errors": {}}

    def close(self):
        pass


class ScriptedProbe:
    def __init__(self, healthy):
        self.healthy = set(healthy)
        self.calls = []

    def __call__(self, dest, timeout_s):
        self.calls.append(dest)
        return dest in self.healthy


def _batch(pkg, names):
    pb = mod(pkg, "gen.veneur_tpu_pb2")
    batch = pb.MetricBatch()
    for name in names:
        m = batch.metrics.add()
        m.name = name
        m.kind = pb.KIND_COUNTER
        m.counter.value = 1
    return batch


def test_gate_refuses_unreachable_candidate_then_admits(tmp_path):
    def scenario(pkg):
        p = tmp_path / f"{pkg}.json"
        p.write_text(json.dumps({"members": ["a:1", "b:2"]}))
        proxy_mod = mod(pkg, "distributed.proxy")
        proxy = proxy_mod.ProxyServer([])
        try:
            probe = ScriptedProbe({"a:1"})
            gate = mod(pkg, "distributed.elastic").HealthGate(proxy,
                                                              probe=probe)
            r = proxy_mod.DestinationRefresher(
                proxy, mod(pkg, "distributed.discovery")
                .FileWatchDiscoverer(str(p)), "", gate=gate)
            r.refresh()
            out = [proxy.ring.members(), gate.probe_failures]
            probe.healthy.add("b:2")
            r.refresh()
            out += [proxy.ring.members(), proxy.last_ring_change["cause"],
                    probe.calls, gate.stats()]
            return out
        finally:
            proxy.stop()

    out = _both(scenario)
    assert out[0] == ["a:1"] and out[1] == 1
    assert out[2] == ["a:1", "b:2"] and "admit:b:2" in out[3]


def test_gate_quarantine_readmission_and_conservation(tmp_path):
    def scenario(pkg):
        p = tmp_path / f"{pkg}.json"
        p.write_text(json.dumps({"members": ["a:1", "b:2"]}))
        clients = {d: ScriptedClient(pkg, d) for d in ("a:1", "b:2")}
        policy = mod(pkg, "sinks.delivery").DeliveryPolicy(
            retry_max=0, breaker_threshold=2, timeout_s=0.2, deadline_s=5.0,
            backoff_base_s=0.001, backoff_max_s=0.005)
        proxy_mod = mod(pkg, "distributed.proxy")
        proxy = proxy_mod.ProxyServer(
            ["a:1", "b:2"], timeout_s=0.5, delivery=policy,
            handoff_window_s=60.0, dedup_sender="s",
            client_factory=lambda dest, t, i: clients[dest])
        try:
            probe = ScriptedProbe({"a:1", "b:2"})
            gate = mod(pkg, "distributed.elastic").HealthGate(
                proxy, probe=probe, quarantine_after=2)
            r = proxy_mod.DestinationRefresher(
                proxy, mod(pkg, "distributed.discovery")
                .FileWatchDiscoverer(str(p)), "", gate=gate)
            r.refresh()
            clients["b:2"].down = True
            names = [f"m{i}" for i in range(64)]
            for lo in range(0, 64, 16):
                proxy._route_batch(_batch(pkg, names[lo:lo + 16]))
            steps = [(proxy.breaker_states(), proxy.spilled_metrics)]
            for _ in range(2):
                r.refresh()
                steps.append((proxy.ring.members(),
                              gate.quarantined_total))
            passes = 0
            while proxy.spilled_metrics and passes < 20:
                proxy.drain_spill()
                passes += 1
            ledgers = {d: s["delivery"] for d, s in
                       proxy.forward_stats()["destinations"].items()
                       if "delivery" in s}
            steps.append((sorted(clients["a:1"].sent), proxy.drops,
                          proxy.conserved(), ledgers))
            clients["b:2"].down = False
            r.refresh()
            steps.append((proxy.ring.members(), gate.readmitted_total,
                          proxy.last_ring_change["cause"]))
            # quarantined again, then the probe fails: it stays out
            clients["b:2"].down = True
            for i in range(4):
                proxy._route_batch(_batch(pkg, [f"n{i}a", f"n{i}b"]))
            r.refresh()
            r.refresh()
            probe.healthy.discard("b:2")
            r.refresh()
            steps.append((proxy.ring.members(), gate.probe_failures))
            probe.healthy.add("b:2")
            r.refresh()
            steps.append((proxy.ring.members(), gate.readmitted_total,
                          gate.stats()))
            return steps
        finally:
            proxy.stop()

    steps = _both(scenario)
    assert steps[0][0]["b:2"] == "open" and steps[0][1] > 0
    assert steps[1] == (["a:1", "b:2"], 0)
    assert steps[2] == (["a:1"], 1)
    landed, drops, conserved, ledgers = steps[3]
    assert landed == sorted(f"m{i}" for i in range(64))
    assert drops == 0 and conserved
    for d in ledgers.values():
        assert d["accepted_payloads"] == (
            d["delivered_payloads"] + d["dropped_payloads"]
            + d["handed_off_payloads"] + d["spilled_payloads"])
    assert steps[4][:2] == (["a:1", "b:2"], 1)
    assert "readmit:b:2" in steps[4][2]
    assert steps[5][0] == ["a:1"] and steps[5][1] >= 1
    assert steps[6][:2] == (["a:1", "b:2"], 2)


def test_gate_floor_and_forgetting():
    class BreakerStorm:
        def __init__(self):
            self.states = {"a:1": "open", "b:2": "open"}

        def breaker_states(self):
            return dict(self.states)

    class Quiet:
        @staticmethod
        def breaker_states():
            return {}

    def scenario(pkg):
        HealthGate = mod(pkg, "distributed.elastic").HealthGate
        gate = HealthGate(BreakerStorm(), probe=lambda d, t: True,
                          quarantine_after=2, min_admitted=1)
        storm = [gate.admit(["a:1", "b:2"]) for _ in range(7)]
        storm.append((gate.quarantined_total, gate.quarantine_deferred))
        probe = ScriptedProbe({"a:1", "b:2"})
        g2 = HealthGate(Quiet(), probe=probe, quarantine_after=1)
        forget = [g2.admit(["a:1", "b:2"]), g2.admit(["a:1"]),
                  sorted(g2.stats()["admitted"])]
        probe.healthy.discard("b:2")
        forget.append(g2.admit(["a:1", "b:2"]))
        return storm, forget

    storm, forget = _both(scenario)
    assert storm[0] == ["a:1", "b:2"] and storm[1] == ["b:2"]
    assert all(len(s) >= 1 for s in storm[2:7])
    assert storm[7][0] >= 1 and storm[7][1] >= 1
    assert forget == [["a:1", "b:2"], ["a:1"], ["a:1"], ["a:1"]]


def test_tcp_probe_listening_vs_dead_port():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    try:
        assert [mod(pkg, "distributed.elastic").tcp_probe(
            f"127.0.0.1:{port}", timeout_s=1.0) for pkg in ROOTS] == \
            [True, True]
    finally:
        srv.close()
    assert [mod(pkg, "distributed.elastic").tcp_probe(
        f"127.0.0.1:{port}", timeout_s=0.5) for pkg in ROOTS] == \
        [False, False]


# -- ElasticController ---------------------------------------------------------


class FakeSource:
    def __init__(self, members, standby=()):
        self.members = list(members)
        self.standby = list(standby)
        self.writes = []

    def desired(self):
        return list(self.members), list(self.standby)

    def write_members(self, members, standby=None):
        self.members = list(members)
        if standby is not None:
            self.standby = list(standby)
        self.writes.append((list(self.members), list(self.standby)))


def _controller(pkg, source, pressured, **kw):
    kw.setdefault("hysteresis_k", 3)
    kw.setdefault("cooldown_s", 0.0)
    kw.setdefault("min_members", 1)
    return mod(pkg, "distributed.elastic").ElasticController(
        source, lambda: {"routing_shed_delta": 1} if pressured() else {},
        **kw)


# a scripted pressure sequence per tick: 1 pressured, 0 calm
SEQUENCE = [1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 1, 1, 1, 1,
            1, 1, 1, 0, 0, 0, 0, 0, 0]


def test_scale_decisions_for_a_scripted_signal_sequence():
    def scenario(pkg):
        src = FakeSource(["a:1"], ["b:2", "c:3", "d:4"])
        now = {"t": 100.0}
        tick = {"i": 0}
        drained = set()
        retired = []
        c = _controller(
            pkg, src, lambda: SEQUENCE[tick["i"]] == 1, cooldown_s=9.0,
            max_members=3, time_fn=lambda: now["t"],
            drained_fn=lambda d: d in drained, retire_fn=retired.append)
        out = []
        for i in range(len(SEQUENCE)):
            tick["i"] = i
            out.append((c.tick(), list(src.members), c.draining()))
            now["t"] += 2.0
            drained.update(c.draining() if i % 3 == 2 else ())
        return (out, src.writes, retired, c.scale_out_total,
                c.scale_in_total, c.retired_total, c.cooldown_skips)

    out, writes, retired, n_out, n_in, n_ret, skips = _both(scenario)
    assert n_out >= 2 and n_in >= 1 and skips >= 1
    assert max(len(m) for _, m, _ in out) <= 3
    assert min(len(m) for _, m, _ in out) >= 1
    assert n_ret == len(retired)


def test_controller_guards_equal_jax():
    def scenario(pkg):
        out = []
        src = FakeSource(["a:1"], ["b:2"])
        c = _controller(pkg, src, lambda: True)
        out.append([c.tick() for _ in range(2)] + [src.writes])
        flip = {"on": False}

        def osc():
            flip["on"] = not flip["on"]
            return flip["on"]

        src = FakeSource(["a:1", "b:2"], ["c:3"])
        c = _controller(pkg, src, osc)
        out.append(([c.tick() for _ in range(40)], src.writes))
        src = FakeSource(["a:1", "b:2"], [])
        c = _controller(pkg, src, lambda: False, min_members=2)
        out.append(([c.tick() for _ in range(20)], src.writes))
        src = FakeSource(["a:1"], [])
        c = _controller(pkg, src, lambda: True)
        out.append(([c.tick() for _ in range(3)],
                    c.scale_blocked_no_capacity))
        policy = mod(pkg, "health.policy")
        out.append([
            policy.elastic_pressure_reasons(s) for s in (
                {}, {"routing_shed_delta": 2}, {"routing_queue_depth": 2},
                {"routing_queue_depth": 1}, {"delivery_deferred_delta": 1},
                {"spilled_metrics": 5}, {"delivery_behind": True})])
        out.append([
            policy.elastic_scale_decision(*a, **k) for a, k in (
                ((3, 0, 2), {"k": 3}), ((2, 0, 2), {"k": 3}),
                ((3, 0, 4), {"k": 3, "max_members": 4}),
                ((0, 3, 2), {"k": 3}), ((0, 3, 1), {"k": 3,
                                                    "min_members": 1}),
                ((0, 99, 2), {"k": 3, "min_members": 2}))])
        out.append([policy.routing_should_shed(d, 4) for d in range(6)]
                   + [policy.delivery_should_signal_behind(n)
                      for n in range(4)])
        proxy = mod(pkg, "distributed.proxy").ProxyServer(["a:1"])
        try:
            out.append(mod(pkg, "distributed.elastic")
                       .ProxyPressureSource(proxy)())
        finally:
            proxy.stop()
        return out

    out = _both(scenario)
    assert out[0] == [None, None, []]
    assert out[1] == ([None] * 40, [])
    assert out[2] == ([None] * 20, [])
    assert out[3][1] == 1
    assert out[5] == ["out", None, None, "in", None, None]


def test_elastic_membership_file_drives_the_proxy_ring(tmp_path):
    """proxy_main's elastic path, scripted: the gated refresher admits the
    members a membership file lists, and a member removed from the file
    reshards away, in both packages alike."""
    def scenario(pkg):
        p = tmp_path / f"{pkg}.json"
        p.write_text(json.dumps({"members": ["a:1", "b:2", "c:3"]}))
        proxy_mod = mod(pkg, "distributed.proxy")
        proxy = proxy_mod.ProxyServer([])
        try:
            gate = mod(pkg, "distributed.elastic").HealthGate(
                proxy, probe=lambda d, t: True)
            disc = mod(pkg, "distributed.discovery").FileWatchDiscoverer(
                str(p))
            r = proxy_mod.DestinationRefresher(proxy, disc, "", gate=gate)
            r.refresh()
            out = [proxy.ring.members(), proxy.ring.version]
            time.sleep(0.01)
            disc.write_members(["a:1", "c:3"], ["b:2"])
            r.refresh()
            out += [proxy.ring.members(), proxy.ring.version,
                    proxy.last_ring_change["removed"]]
            return out
        finally:
            proxy.stop()

    assert _both(scenario) == [["a:1", "b:2", "c:3"], 1, ["a:1", "c:3"], 2,
                               ["b:2"]]
