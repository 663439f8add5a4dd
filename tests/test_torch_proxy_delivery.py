"""The port proxy's delivery guarantees against the JAX proxy's, on the
CPU: every scenario runs through both packages under one scripted
schedule and their counters, ledgers and wire attempts must be equal.

* A destination dies mid-batch and the ring reshards it away: every
  metric lands exactly once on a surviving owner.
* Dedup keys: a retry reuses the minted key, a spill drain re-sends
  under it (counted), a deadline-clipped resend is attributed, a reshard
  re-mints for new owners and never reuses a departed owner's keys.
* The bounded handoff window parks fragments without a network attempt;
  the routing pool sheds with honest per-metric counts.
* A seeded ``FaultPlan`` (refusals, permanent send failures) through
  ``FaultyForwardClient`` over three destinations: the same decisions,
  delivery ledgers and outcomes in both packages.
"""

from __future__ import annotations

import importlib
import threading
import time

import pytest

ROOTS = {"jax": "veneur_tpu", "port": "veneur_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _wait_until(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


class ScriptedClient:
    """Forward-client stand-in with a scripted ``down`` switch and a
    queue of per-attempt failure causes; records every attempt (its
    dedup key, the metric names, whether it landed) the way a packet
    capture would."""

    def __init__(self, pkg: str, dest: str):
        self._rpc = mod(pkg, "distributed.rpc")
        self._codec = mod(pkg, "distributed.codec")
        self._pb = mod(pkg, "gen.veneur_tpu_pb2")
        self.address = dest
        self.down = False
        self.fail_causes: list = []
        self.attempts: list = []
        self.sent: list = []
        self.send_calls = 0
        self._lock = threading.Lock()

    def _attempt(self, key, names):
        with self._lock:
            self.send_calls += 1
            cause = self.fail_causes.pop(0) if self.fail_causes else (
                "unavailable" if self.down else None)
            self.attempts.append((key, names, cause is None))
            if cause is None:
                self.sent.extend(names)
                return
        raise self._rpc.ForwardError(cause, self.address,
                                     f"scripted: {cause}")

    def send_or_raise(self, batch, timeout_s=None):
        self._attempt(None, tuple(m.name for m in batch.metrics))

    def send_raw_or_raise(self, blob, n_metrics, timeout_s=None):
        key, body = self._codec.decode_dedup_envelope(blob)
        self._attempt(key, tuple(
            m.name for m in self._pb.MetricBatch.FromString(body).metrics))

    def stats(self):
        return {"address": self.address, "reconnects": 0, "errors": {}}

    def close(self):
        pass


def _policy(pkg: str, **overrides):
    kw = dict(retry_max=0, breaker_threshold=0, timeout_s=0.2,
              deadline_s=5.0, backoff_base_s=0.001, backoff_max_s=0.005)
    kw.update(overrides)
    return mod(pkg, "sinks.delivery").DeliveryPolicy(**kw)


def _make_proxy(pkg, dests, clients, policy=None, **kw):
    kw.setdefault("handoff_window_s", 60.0)  # the drain thread stays idle
    kw.setdefault("dedup_sender", "s")       # else a random token
    return mod(pkg, "distributed.proxy").ProxyServer(
        dests, timeout_s=0.5, delivery=policy or _policy(pkg),
        client_factory=lambda dest, timeout_s, idle_timeout_s: clients[dest],
        **kw)


def _batch(pkg: str, names):
    pb = mod(pkg, "gen.veneur_tpu_pb2")
    batch = pb.MetricBatch()
    for name in names:
        m = batch.metrics.add()
        m.name = name
        m.kind = pb.KIND_COUNTER
        m.counter.value = 1
    return batch


STAT_KEYS = ("proxied_metrics", "drops", "spilled_metrics", "shed_metrics",
             "reshards", "ring_version", "ring_members", "handoff", "dedup")


def _ledger(proxy) -> dict:
    st = proxy.forward_stats()
    out = {k: st[k] for k in STAT_KEYS}
    out["delivery"] = {
        d: {k: v for k, v in s["delivery"].items()}
        for d, s in st["destinations"].items() if "delivery" in s}
    out["conserved"] = proxy.conserved()
    return out


def _both(scenario):
    outs = {pkg: scenario(pkg) for pkg in ROOTS}
    assert outs["port"] == outs["jax"]
    return outs["port"]


def _reshard_mid_batch(pkg):
    dests = ["a:1", "b:1", "c:1"]
    clients = {d: ScriptedClient(pkg, d) for d in dests}
    proxy = _make_proxy(pkg, dests, clients, handoff_window_s=0.1)
    try:
        names = [f"reshard-{i}" for i in range(60)]
        clients["b:1"].down = True
        proxy._route_batch(_batch(pkg, names))
        parked = (proxy.drops, proxy.spilled_metrics, proxy.conserved())
        change = proxy.set_destinations(["a:1", "c:1"])
        assert _wait_until(lambda: proxy.spilled_metrics == 0)
        return {"parked": parked, "removed": change.removed,
                "sent": {d: sorted(c.sent) for d, c in clients.items()},
                "proxied": proxy.proxied_metrics, "drops": proxy.drops,
                "reshards": proxy.reshards,
                "version": proxy.forward_stats()["ring_version"],
                "conserved": proxy.conserved()}
    finally:
        proxy.stop()


def test_reshard_mid_batch_lands_every_metric_exactly_once():
    out = _both(_reshard_mid_batch)
    drops, spilled, conserved = out["parked"]
    assert drops == 0 and spilled > 0 and conserved
    assert out["removed"] == ["b:1"] and not out["sent"]["b:1"]
    landed = out["sent"]["a:1"] + out["sent"]["c:1"]
    assert sorted(landed) == sorted(f"reshard-{i}" for i in range(60))
    assert out["proxied"] == 60 and out["drops"] == 0
    assert out["reshards"] == 1 and out["version"] == 2 and out["conserved"]


def _dedup_retry(pkg):
    clients = {"a:1": ScriptedClient(pkg, "a:1")}
    proxy = _make_proxy(pkg, ["a:1"], clients,
                        policy=_policy(pkg, retry_max=1), dedup=True,
                        dedup_sender="sender-A")
    try:
        clients["a:1"].fail_causes = ["unavailable"]
        proxy._route_batch(_batch(pkg, ["retry-0", "retry-1"]))
        return clients["a:1"].attempts, _ledger(proxy)
    finally:
        proxy.stop()


def test_dedup_retry_reuses_the_minted_key():
    attempts, ledger = _both(_dedup_retry)
    (k1, _, ok1), (k2, _, ok2) = attempts
    assert not ok1 and ok2 and k1 == k2 == ("sender-A", 1, 2)
    assert ledger["dedup"]["minted"] == 1 and ledger["conserved"]


def _dedup_drain(pkg, cause):
    clients = {"a:1": ScriptedClient(pkg, "a:1")}
    proxy = _make_proxy(pkg, ["a:1"], clients, dedup=True, dedup_sender="s")
    try:
        clients["a:1"].fail_causes = [cause]
        proxy._route_batch(_batch(pkg, ["spill-0"]))
        spilled = proxy.spilled_metrics
        proxy.drain_spill()
        return spilled, clients["a:1"].attempts, _ledger(proxy)
    finally:
        proxy.stop()


@pytest.mark.parametrize("cause", ["unavailable", "deadline_exceeded"])
def test_dedup_spill_drain_reuses_key_and_attributes_resends(cause):
    spilled, attempts, ledger = _both(lambda pkg: _dedup_drain(pkg, cause))
    assert spilled == 1
    assert [ok for _, _, ok in attempts] == [False, True]
    assert attempts[0][0] == attempts[1][0]   # redelivery under one key
    assert ledger["handoff"] == {
        "resend_total": 1,
        "clipped_resend": int(cause == "deadline_exceeded")}
    assert ledger["spilled_metrics"] == 0 and ledger["conserved"]


def _remint(pkg):
    dests = ["a:1", "b:1", "c:1"]
    clients = {d: ScriptedClient(pkg, d) for d in dests}
    proxy = _make_proxy(pkg, dests, clients, handoff_window_s=0.1,
                        dedup=True, dedup_sender="s")
    try:
        names = [f"remint-{i}" for i in range(60)]
        clients["b:1"].down = True
        proxy._route_batch(_batch(pkg, names))
        proxy.set_destinations(["a:1", "c:1"])
        assert _wait_until(lambda: proxy.spilled_metrics == 0)
        ledger = _ledger(proxy)
        ledger["delivery"].pop("b:1", None)   # retired once drained
        return ({d: c.attempts for d, c in clients.items()}, ledger)
    finally:
        proxy.stop()


def test_reshard_remints_for_new_owners_never_reuses_departed_keys():
    attempts, ledger = _both(_remint)
    b_keys = {k for k, _, _ in attempts["b:1"]}
    survivor = {k for d in ("a:1", "c:1") for k, _, _ in attempts[d]}
    assert b_keys and not (b_keys & survivor)
    landed = [n for d in ("a:1", "c:1")
              for _, names, ok in attempts[d] if ok for n in names]
    assert sorted(landed) == sorted(f"remint-{i}" for i in range(60))
    assert ledger["dedup"]["remint_after_attempt"] >= 1
    assert ledger["drops"] == 0 and ledger["conserved"]


def _park(pkg):
    clients = {"a:1": ScriptedClient(pkg, "a:1")}
    proxy = _make_proxy(pkg, ["a:1"], clients)
    try:
        clients["a:1"].down = True
        proxy._route_batch(_batch(pkg, ["park-0"]))
        clients["a:1"].down = False
        calls = clients["a:1"].send_calls
        proxy.drain_spill(window_s=0.0)        # the window is spent
        parked = (clients["a:1"].send_calls - calls, proxy.spilled_metrics,
                  proxy.conserved())
        proxy.drain_spill()
        return parked, clients["a:1"].sent, _ledger(proxy)
    finally:
        proxy.stop()


def test_handoff_window_exhaustion_parks_instead_of_sending():
    parked, sent, ledger = _both(_park)
    assert parked == (0, 1, True)
    assert sent == ["park-0"]
    assert ledger["spilled_metrics"] == 0 and ledger["conserved"]


def _shed(pkg):
    release, in_send = threading.Event(), threading.Event()

    class Blocking(ScriptedClient):
        def _attempt(self, key, names):
            in_send.set()
            release.wait(30.0)
            super()._attempt(key, names)

    clients = {"a:1": Blocking(pkg, "a:1")}
    proxy = _make_proxy(pkg, ["a:1"], clients,
                        policy=_policy(pkg, deadline_s=30.0, timeout_s=30.0),
                        routing_workers=1, routing_queue_max=1)
    try:
        proxy.handle_batch(_batch(pkg, ["shed-0"]))
        assert in_send.wait(30.0)              # the one worker is busy
        proxy.handle_batch(_batch(pkg, ["shed-1", "shed-1b"]))   # queued
        proxy.handle_batch(_batch(pkg, ["shed-2", "shed-2b", "shed-2c"]))
        during = (proxy.forward_stats()["routing"]["shed_batches"],
                  proxy.shed_metrics, proxy.drops, proxy._pool.behind())
        release.set()
        assert _wait_until(
            lambda: proxy.forward_stats()["routing"]["routed"] == 2)
        routing = {k: v for k, v in proxy.forward_stats()["routing"].items()}
        return during, routing, sorted(clients["a:1"].sent), _ledger(proxy)
    finally:
        release.set()
        proxy.stop()


def test_routing_pool_sheds_with_honest_counters():
    during, routing, sent, ledger = _both(_shed)
    assert during == (1, 3, 3, False)
    assert routing["submitted"] == 2 and routing["shed_batches"] == 1
    assert sent == ["shed-0", "shed-1", "shed-1b"]
    assert ledger["proxied_metrics"] == 3 and ledger["conserved"]


def _scripted_schedule(pkg):
    """Three destinations behind seeded fault plans (refusals transient,
    permanent send failures), 40 batches routed one after another, then
    drain passes until every spill is empty."""
    faults = mod(pkg, "utils.faults")
    dests = ["a:1", "b:1", "c:1"]
    inner = {d: ScriptedClient(pkg, d) for d in dests}
    clients = {d: faults.FaultyForwardClient(
        faults.FaultPlan(seed=11 + i, p_refuse=0.25, p_reject=0.05),
        inner[d]) for i, d in enumerate(dests)}
    proxy = _make_proxy(pkg, dests, clients,
                        policy=_policy(pkg, retry_max=1, breaker_threshold=3),
                        dedup=True, dedup_sender="s")
    try:
        for b in range(40):
            proxy._route_batch(_batch(pkg, [f"b{b}-m{i}" for i in range(12)]))
        passes = 0
        while proxy.spilled_metrics and passes < 50:
            proxy.drain_spill()
            passes += 1
        return ({d: (c.injected, inner[d].attempts)
                 for d, c in clients.items()}, passes, _ledger(proxy))
    finally:
        proxy.stop()


def test_scripted_fault_schedule_counters_equal_jax():
    injected, passes, ledger = _both(_scripted_schedule)
    assert sum(v[0]["refused"] for v in injected.values()) > 0
    assert sum(v[0]["rejected"] for v in injected.values()) > 0
    assert ledger["spilled_metrics"] == 0 and ledger["conserved"]
    landed = [n for _, attempts in injected.values()
              for _, names, ok in attempts if ok for n in names]
    # exactly once for every metric not declared dropped
    assert len(landed) == len(set(landed))
    assert len(landed) + ledger["drops"] == 40 * 12
    assert ledger["proxied_metrics"] == len(landed)
