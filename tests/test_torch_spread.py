"""The sharded proxy tier's sender side (``SpreadForwarder``) of the
PyTorch port against the JAX package's, on the CPU.

Each scripted scenario runs through both packages with the spread's
``random.Random`` seeded the same, and the whole ledger (picks, p2c and
round-robin decisions, respreads, drops, per-lane delivery counters) and
what each lane delivered must be equal:

* every live proxy is used; p2c steers away from a deep lane;
* a dead proxy's share respreads to the survivor exactly once (a safe
  cause) and an ambiguous cause is counted apart;
* a membership removal respreads and keeps the retired ledger; no
  survivors is a declared drop.

End to end: a factory-built local with ``forward_address: "p1,p2"``
forwards two intervals through two proxies to one global, in both
packages: both proxies used, the global's snapshots bitwise equal.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
import threading
import time

import numpy as np
import pytest

from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.factory import build_server as jbuild
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server as tbuild

ROOTS = {"jax": "veneur_tpu", "port": "veneur_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


class LaneClient:
    """Scripted stand-in for a lane's ForwardClient: ``down`` sends
    raise a classified ForwardError with a scriptable cause; up sends
    record the delivered metric names and count like the real client."""

    streaming = False

    def __init__(self, pkg, dest, timeout_s=1.0):
        self._rpc = mod(pkg, "distributed.rpc")
        self._pb = mod(pkg, "gen.veneur_tpu_pb2")
        self.address = dest
        self.timeout_s = timeout_s
        self.down = False
        self.cause = "unavailable"
        self.sent = []
        self.sent_metrics = 0
        self.send_calls = 0
        self.closed = False
        self._lock = threading.Lock()

    def send_raw_or_raise(self, blob, n_metrics, timeout_s=None):
        with self._lock:
            self.send_calls += 1
            if self.down:
                raise self._rpc.ForwardError(self.cause, self.address,
                                             f"scripted: {self.cause}")
            self.sent.extend(
                m.name for m in self._pb.MetricBatch.FromString(blob).metrics)
            self.sent_metrics += n_metrics

    def stats(self):
        return {"address": self.address, "sent_batches": 0,
                "sent_metrics": self.sent_metrics, "errors": {}}

    def close(self):
        self.closed = True


def _blob(pkg, names):
    pb = mod(pkg, "gen.veneur_tpu_pb2")
    b = pb.MetricBatch()
    for n in names:
        m = b.metrics.add()
        m.name = n
        m.kind = pb.KIND_COUNTER
        m.scope = pb.SCOPE_GLOBAL
        m.counter.value = 1
    return b.SerializeToString()


def _fwd(pkg, addrs, spread_policy="p2c", seed=5):
    clients = {}

    def factory(addr, timeout_s):
        clients[addr] = LaneClient(pkg, addr, timeout_s)
        return clients[addr]

    policy = mod(pkg, "sinks.delivery").DeliveryPolicy(
        retry_max=0, breaker_threshold=2, timeout_s=0.2, deadline_s=5.0,
        backoff_base_s=0.0, backoff_max_s=0.0, spill_max_bytes=1 << 20,
        spill_max_payloads=64)
    fwd = mod(pkg, "distributed.spread").SpreadForwarder(
        addrs, timeout_s=0.2, policy=policy, spread_policy=spread_policy,
        client_factory=factory, rng=random.Random(seed))
    return fwd, clients


def _ledger(fwd, clients) -> dict:
    st = fwd.forward_stats()
    for d in st["destinations"].values():
        d.pop("stream", None)
    return {"stats": st, "sent": {a: c.sent for a, c in clients.items()},
            "conserved": fwd.conserved(),
            "ingested": fwd.ingested_metrics(),
            "breakers": fwd.breaker_states()}


def _both(scenario):
    outs = {pkg: scenario(pkg) for pkg in ROOTS}
    assert outs["port"] == outs["jax"]
    return outs["port"]


def _every_live(pkg):
    fwd, clients = _fwd(pkg, ["p1:1", "p2:2", "p3:3"])
    outcomes = [fwd.send_wire(_blob(pkg, [f"m{i}"]), 1) for i in range(60)]
    return outcomes, _ledger(fwd, clients)


def test_spread_uses_every_live_proxy():
    outcomes, led = _both(_every_live)
    assert outcomes == ["delivered"] * 60
    assert all(len(s) > 0 for s in led["sent"].values())
    assert sum(len(s) for s in led["sent"].values()) == 60
    assert led["ingested"] == 60 and led["conserved"]
    assert led["stats"]["respread_total"] == 0


def _p2c(pkg):
    fwd, clients = _fwd(pkg, ["p1:1", "p2:2"])
    clients["p1:1"].down = True
    fwd.send_wire(_blob(pkg, ["park0"]), 1)
    while not any(len(ln.manager.spill) for ln in fwd._lanes.values()):
        fwd.send_wire(_blob(pkg, ["park1"]), 1)
    clients["p1:1"].down = False
    before = clients["p2:2"].send_calls
    for i in range(40):
        fwd.send_wire(_blob(pkg, [f"m{i}"]), 1)
    return clients["p2:2"].send_calls - before, _ledger(fwd, clients)


def test_p2c_steers_away_from_deep_lane():
    to_shallow, led = _both(_p2c)
    assert to_shallow == 40 and led["stats"]["picks_p2c"] > 0


@pytest.mark.parametrize("cause", ["unavailable", "deadline_exceeded"])
def test_dead_proxy_share_respreads_exactly_once(cause):
    def scenario(pkg):
        fwd, clients = _fwd(pkg, ["p1:1", "p2:2"],
                            spread_policy="round_robin")
        clients["p1:1"].down = True
        clients["p1:1"].cause = cause
        for i in range(30):
            fwd.send_wire(_blob(pkg, [f"m{i}"]), 1)
        fwd.begin_flush()
        return _ledger(fwd, clients)

    led = _both(scenario)
    delivered = led["sent"]["p1:1"] + led["sent"]["p2:2"]
    assert sorted(delivered) == sorted(f"m{i}" for i in range(30))
    st = led["stats"]
    assert st["respread_total"] > 0 and st["dropped_metrics"] == 0
    assert st["respread_ambiguous_total"] == (
        st["respread_total"] if cause == "deadline_exceeded" else 0)
    assert st["destinations"]["p1:1"]["respread_out"] > 0
    assert st["destinations"]["p2:2"]["respread_in"] > 0
    assert led["breakers"]["p1:1"] != "closed" and led["conserved"]


def _removal(pkg):
    fwd, clients = _fwd(pkg, ["p1:1", "p2:2"])
    clients["p1:1"].down = True
    for i in range(20):
        fwd.send_wire(_blob(pkg, [f"m{i}"]), 1)
    change = fwd.set_destinations(["p2:2"], cause="discovery")
    return change, clients["p1:1"].closed, _ledger(fwd, clients)


def test_membership_removal_respreads_and_retains_ledger():
    change, closed, led = _both(_removal)
    assert change["removed"] == ["p1:1"] and closed
    delivered = led["sent"]["p1:1"] + led["sent"]["p2:2"]
    assert sorted(delivered) == sorted(f"m{i}" for i in range(20))
    assert led["stats"]["destinations"]["p1:1"]["live"] is False
    assert led["ingested"] == 20 and led["conserved"]


def _no_survivors(pkg):
    fwd, clients = _fwd(pkg, ["p1:1"])
    clients["p1:1"].down = True
    for i in range(10):
        fwd.send_wire(_blob(pkg, [f"m{i}"]), 1)
    fwd.begin_flush()
    remaining = fwd.drain(deadline_s=0.1)
    fwd.close()
    empty, _ = _fwd(pkg, [])
    return (remaining, _ledger(fwd, clients),
            empty.send_wire(_blob(pkg, ["m0"]), 1), empty.dropped_metrics)


def test_no_survivors_is_a_declared_drop():
    remaining, led, empty_outcome, empty_drops = _both(_no_survivors)
    st = led["stats"]
    assert st["dropped_metrics"] + remaining + len(led["sent"]["p1:1"]) \
        >= 10
    assert st["dropped_metrics"] > 0 and led["conserved"]
    assert (empty_outcome, empty_drops) == ("dropped", 1)
    for pkg in ROOTS:
        with pytest.raises(ValueError):
            mod(pkg, "distributed.spread").SpreadForwarder(
                ["p1:1"], spread_policy="random")


# -- end to end through the factory --------------------------------------------


def _wait_until(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _build(pkg, data):
    if pkg == "jax":
        return jbuild(jload(data=data))
    return tbuild(tload(data=data), device="cpu")


BASE = {"interval": "1h", "percentiles": [0.5, 0.99], "num_workers": 1,
        "tpu_hll_precision": 10, "ssf_span_uniqueness_rate": 0.0,
        "tpu_native_ingest": False}


def _interval_lines(k: int):
    rng = np.random.default_rng(40 + k)
    out = []
    for i in range(60):
        out.append(f"sp.lat{i % 20}:{rng.gamma(2.0, 9.0):.4f}|ms".encode())
        out.append(f"sp.c{i % 6}:{1 + i % 4}|c|#veneurglobalonly".encode())
        out.append(f"sp.s{i % 5}:u{int(rng.integers(0, 300))}|s".encode())
    return out


def _spread_tier(pkg):
    g = _build(pkg, {**BASE, "grpc_address": "127.0.0.1:0"})
    gaddr = f"127.0.0.1:{g.import_server.port}"
    proxy_mod = mod(pkg, "distributed.proxy")
    proxies = [proxy_mod.ProxyServer([gaddr]) for _ in range(2)]
    paddrs = [f"127.0.0.1:{p.start_grpc()}" for p in proxies]
    local = _build(pkg, {**BASE, "forward_use_grpc": True,
                         "forward_address": ",".join(paddrs)})
    spread = local.forwarder
    done = threading.Event()

    def forward(snaps):
        spread(snaps)
        done.set()

    local.forwarder = forward   # the flush forwards on a thread of its own
    try:
        assert type(spread).__name__ == "SpreadForwarder"
        for k in range(2):
            for line in _interval_lines(k):
                local.process_metric_packet(line)
            done.clear()
            local.flush(now=1_700_000_000 + k)
            assert done.wait(30)
            expect = spread.ingested_metrics()
            # the global counts a fragment before its proxy does
            assert _wait_until(
                lambda: g.import_server.received_metrics == expect
                and sum(p.proxied_metrics for p in proxies) == expect)
        st = spread.forward_stats()
        picks = [st["destinations"][a]["picks"] for a in paddrs]
        proxied = [p.proxied_metrics for p in proxies]
        snaps = []
        for w, lock in zip(g.workers, g._worker_locks):
            with lock:
                snaps.append(w.flush(np.array([0.5, 0.99], np.float32),
                                     10.0))
        return picks, proxied, expect, snaps, spread.conserved()
    finally:
        local.forwarder = spread
        local.shutdown()
        for p in proxies:
            p.stop()
        g.shutdown()


def test_spread_local_through_two_proxies_equals_jax():
    res = {pkg: _spread_tier(pkg) for pkg in ROOTS}
    jpicks, jproxied, jn, jsnaps, _ = res["jax"]
    tpicks, tproxied, tn, tsnaps, conserved = res["port"]
    assert (tpicks, tproxied, tn) == (jpicks, jproxied, jn)
    assert tpicks == [1, 1] and all(tproxied) and conserved
    assert sum(tproxied) == tn > 0
    for a, b in zip(jsnaps, tsnaps):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                assert va.tobytes() == vb.tobytes(), f.name
        assert [r.key.key_string() for r in a.directory.histo.rows] == \
            [r.key.key_string() for r in b.directory.histo.rows]
        pa, pb = a.scalars.counters, b.scalars.counters
        assert pa.values[:pa.used].tobytes() == pb.values[:pb.used].tobytes()


def test_fresh_forwarders_all_pick_the_same_proxy_first():
    """Found in both packages: on equal depths p2c falls back to sticky
    round-robin from a cursor every new SpreadForwarder starts at 0, so
    a fleet of freshly started locals sends its first payloads all to
    one proxy (the second it lists); later payloads rotate."""
    def scenario(pkg):
        firsts = []
        for seed in range(8):
            fwd, clients = _fwd(pkg, ["p1:1", "p2:2", "p3:3"], seed=seed)
            fwd.send_wire(_blob(pkg, ["m"]), 1)
            firsts.append([a for a, c in clients.items() if c.sent])
        fwd, clients = _fwd(pkg, ["p1:1", "p2:2", "p3:3"])
        for i in range(6):
            fwd.send_wire(_blob(pkg, [f"m{i}"]), 1)
        return firsts, {a: len(c.sent) for a, c in clients.items()}

    firsts, rotation = _both(scenario)
    assert firsts == [["p2:2"]] * 8
    assert rotation == {"p1:1": 2, "p2:2": 2, "p3:3": 2}
