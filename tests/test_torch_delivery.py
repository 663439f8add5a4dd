"""The port's delivery layer against the JAX package's, on the CPU (after
tests/test_delivery.py).

The same seeded fault schedule drives ``veneur_tpu.sinks.delivery``'s
``DeliveryManager`` and the port's copy on the same fake clock and the
same seeded jitter: every send attempt draws its outcome (success, a
retryable 503 or connection refusal, a payload-rejecting 400, a timeout,
or a slow success that eats the flush deadline) from one numpy stream
per flush. Both managers give the same outcome per payload, the same
delivered-payload sequence, the same sleeps and the same counters at
every step: retries, breaker open/half-open/close, deadline clips,
spills and spill evictions, and quiet ticks that only drain the spill.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from veneur_tpu.sinks import delivery as jdel
from veneur_tpu.utils import http as jhttp
from veneur_tpu_torch.core.config import Config as TConfig
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.sinks import delivery as tdel
from veneur_tpu_torch.utils import http as thttp


class FakeClock:
    """monotonic + sleep pair where sleeping is advancing time."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def time(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


OUTCOMES = ("ok", "ok", "ok", "503", "refused", "400", "timeout", "slow")


class Harness:
    """One package's manager, clock and delivered log, driven by a
    per-flush schedule of attempt outcomes."""

    def __init__(self, delivery, http, policy_kw, seed):
        self.clock = FakeClock()
        self.http = http
        self.mgr = delivery.DeliveryManager(
            "sink", delivery.DeliveryPolicy(**policy_kw),
            time_fn=self.clock.time, sleep_fn=self.clock.sleep,
            rng=random.Random(seed))
        self.delivered: list[int] = []
        self.attempts: list[tuple[int, str]] = []
        self.schedule: list[str] = []

    def _send(self, pid: int, timeout: float) -> None:
        what = self.schedule.pop(0) if self.schedule else "ok"
        self.attempts.append((pid, what, round(timeout, 9)))
        if what == "503":
            raise self.http.HTTPError(503, b"busy")
        if what == "400":
            raise self.http.HTTPError(400, b"bad payload")
        if what == "refused":
            raise ConnectionRefusedError(111, "refused")
        if what == "timeout":
            self.clock.t += timeout
            raise TimeoutError("timed out")
        if what == "slow":
            self.clock.t += 4.0
        self.delivered.append(pid)

    def flush(self, pids, schedule):
        self.schedule = list(schedule)
        self.mgr.begin_flush()
        self.mgr.retry_spill()
        out = []
        for pid in pids:
            out.append(self.mgr.deliver(
                lambda t, pid=pid: self._send(pid, t), 100 + 37 * pid,
                payload=pid))
        return out


def _stats(mgr):
    s = mgr.stats()
    s["conserved"] = mgr.conserved()
    return s


POLICIES = {
    "default": dict(),
    "no-retry": dict(retry_max=0, breaker_threshold=2),
    "tight-spill": dict(spill_max_payloads=3, spill_max_bytes=600,
                        breaker_threshold=4),
    "short-deadline": dict(deadline_s=5.0, timeout_s=2.0, retry_max=3),
    "no-breaker": dict(breaker_threshold=0, retry_max=1),
}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_seeded_fault_schedule_same_in_both(policy, seed):
    kw = dict(backoff_base_s=0.1, backoff_max_s=1.0, **POLICIES[policy])
    j = Harness(jdel, jhttp, kw, seed)
    t = Harness(tdel, thttp, kw, seed)
    rng = np.random.default_rng(seed)
    pid = 0
    seen = set()
    for flush in range(14):
        # every fifth flush is a quiet tick: nothing fresh, the spill
        # drains ahead of it
        n = 0 if flush % 5 == 4 else int(rng.integers(1, 5))
        # an outage in flushes 3-6 opens the breaker
        weights = np.full(len(OUTCOMES), 1.0)
        if 3 <= flush <= 6:
            weights[3:5] = 8.0
        sched = list(rng.choice(OUTCOMES, 24, p=weights / weights.sum()))
        pids = list(range(pid, pid + n))
        pid += n
        assert j.flush(pids, sched) == t.flush(pids, sched), flush
        assert t.delivered == j.delivered, flush
        assert t.attempts == j.attempts, flush
        assert t.clock.sleeps == j.clock.sleeps, flush
        assert _stats(t.mgr) == _stats(j.mgr), flush
        seen.update(_stats(t.mgr)["breaker_transitions"])
    st = _stats(t.mgr)
    assert st["conserved"] and st["accepted_payloads"] == pid
    assert st["delivered_payloads"] and st["retries"] + \
        st["breaker_short_circuits"] + st["dropped_payloads"]


def test_breaker_cycle_and_deadline_clip_reached():
    """The schedule above reaches every mechanism: a breaker that opens,
    probes and closes, deadline clips, spill evictions and drops."""
    totals = {}
    for policy in POLICIES:
        for seed in (1, 2, 3):
            kw = dict(backoff_base_s=0.1, backoff_max_s=1.0,
                      **POLICIES[policy])
            h = Harness(tdel, thttp, kw, seed)
            rng = np.random.default_rng(seed)
            pid = 0
            for flush in range(14):
                n = 0 if flush % 5 == 4 else int(rng.integers(1, 5))
                weights = np.full(len(OUTCOMES), 1.0)
                if 3 <= flush <= 6:
                    weights[3:5] = 8.0
                sched = list(rng.choice(OUTCOMES, 24,
                                        p=weights / weights.sum()))
                h.flush(list(range(pid, pid + n)), sched)
                pid += n
            st = h.mgr.stats()
            for k in ("deadline_clipped", "breaker_opened_total",
                      "dropped_payloads", "deferred_payloads", "retries"):
                totals[k] = totals.get(k, 0) + st[k]
            totals.setdefault("closed_after_open", False)
            tr = st["breaker_transitions"]
            if "open" in tr and tr[-1] == "closed":
                totals["closed_after_open"] = True
    assert all(totals.values()), totals


def test_retryable_classification_same():
    cases = [lambda h: h.HTTPError(503, b""), lambda h: h.HTTPError(408, b""),
             lambda h: h.HTTPError(429, b""), lambda h: h.HTTPError(400, b""),
             lambda h: h.HTTPError(404, b""), lambda h: TimeoutError(),
             lambda h: ConnectionRefusedError(111, "refused"),
             lambda h: ConnectionResetError(104, "reset"),
             lambda h: OSError(101, "unreachable"),
             lambda h: ValueError("serializer bug")]
    got = [(jdel.retryable(c(jhttp)), tdel.retryable(c(thttp)))
           for c in cases]
    assert [a for a, _ in got] == [b for _, b in got]
    assert any(a for a, _ in got) and not all(a for a, _ in got)


@pytest.mark.parametrize("data", [
    {}, {"interval": "2s", "flush_timeout_s": 5.0, "sink_retry_max": 4},
    {"sink_breaker_threshold": 0, "sink_spill_max_bytes": 1024,
     "sink_spill_max_payloads": 3}])
def test_policy_from_config_same(data):
    from veneur_tpu.core.config import load_config as jload

    jc, tc = jload(data=data), tload(data=data)
    assert isinstance(tc, TConfig)
    jp = jdel.DeliveryPolicy.from_config(jc, jc.interval_seconds())
    tp = tdel.DeliveryPolicy.from_config(tc, tc.interval_seconds())
    assert vars(jp) == vars(tp)
