"""Elastic global tier: health-gated membership + load-driven autoscale.

Closes ROADMAP new-direction item 4. Three pieces, layered on machinery
that already exists rather than inventing new failure domains:

- `HealthGate` filters every discovered destination set before it
  reaches the ring (DestinationRefresher calls `admit` per refresh
  tick): a candidate must pass a readiness probe against its import
  endpoint before it first enters, and an admitted member whose
  per-destination circuit breaker stays open for >= quarantine_after
  consecutive refresh ticks is quarantined out — its arcs reshard away
  via the ordinary RingChange, its spill drains through the reshard
  handoff window, and it re-enters only on probe success.

- `ElasticController` closes the autoscale loop: it observes the
  pressure signals the tier already emits (routing sheds / queue depth,
  delivery deferrals, spill occupancy — assembled by
  `ProxyPressureSource`), applies hysteresis + cooldown
  (health/policy.elastic_scale_decision), and writes the desired member
  set back through the discovery source (FileWatchDiscoverer's
  members/standby file), so the decision propagates to every proxy
  polling that source, not just this one. Scale-in is graceful by
  construction: the member leaves the ring FIRST (write-back), the
  handoff drain re-homes its spill, and only when the proxy reports the
  destination idle (out of ring + no inflight + spill empty — the proxy's
  retirement guard, read via `ProxyServer.destination_idle`) does the
  controller invoke `retire_fn` and demote the member to standby.

- `tcp_probe` is the default readiness probe: can we complete a TCP
  handshake with the member's import endpoint. `ImportServer.ready()`
  pairs with it server-side.

The controller only ever flips membership through the discovery source;
it never touches the ring directly — the refresher/gate path stays the
single writer, so causality ("discovery", "quarantine", "scale_in") is
stamped on every RingChange and there is exactly one reshard pipeline
to get right.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Callable, Optional

from veneur_tpu_torch.health.policy import (
    ELASTIC_HYSTERESIS_INTERVALS,
    elastic_pressure_reasons,
    elastic_scale_decision,
)
from veneur_tpu_torch.utils.http import parse_host_port

log = logging.getLogger("veneur_tpu_torch.elastic")


def tcp_probe(address: str, timeout_s: float = 1.0) -> bool:
    """Readiness probe: complete a TCP handshake with the member's
    import endpoint. Cheap, dependency-free, and honest — a bound gRPC
    listener accepts the connection even mid-request, an absent/dead
    one refuses or times out."""
    host, port = parse_host_port(address, what="probe address")
    try:
        with socket.create_connection((host, port), timeout=timeout_s):
            return True
    except OSError:
        return False


class HealthGate:
    r"""Per-refresh-tick membership filter: readiness-probe admission for
    newcomers, breaker-streak quarantine for the sick, probe-gated
    re-admission.

    State machine per destination:

      candidate --probe ok--> admitted --breaker open x N--> quarantined
          ^  \--probe fail--> (stays out, probe_failures++)      |
          |                                                      |
          +------------------- probe ok <--- re-probed each tick-+

    Quarantine never drops the admitted set below `min_admitted`: a
    tier-wide breaker storm (every member timing out because the
    *network* died) must not empty the ring — an empty ring loses
    routing entirely, while a sick ring merely spills.
    """

    def __init__(self, proxy, probe: Callable[[str, float], bool] = tcp_probe,
                 probe_timeout_s: float = 1.0,
                 quarantine_after: int = 3,
                 min_admitted: int = 1) -> None:
        self.proxy = proxy
        self.probe = probe
        self.probe_timeout_s = probe_timeout_s
        self.quarantine_after = max(1, int(quarantine_after))
        self.min_admitted = max(1, int(min_admitted))
        self._admitted: set[str] = set()
        self._quarantined: set[str] = set()
        # consecutive refresh ticks each admitted member's breaker was
        # observed open ("closed" resets; half_open — a probe in flight
        # — holds the streak rather than counting or resetting)
        self._open_streak: dict[str, int] = {}
        self.quarantined_total = 0
        self.readmitted_total = 0
        self.probe_failures = 0
        self.quarantine_deferred = 0   # min_admitted floor blocked it
        self.last_events: list[str] = []

    def _probe_ok(self, dest: str) -> bool:
        try:
            ok = bool(self.probe(dest, self.probe_timeout_s))
        except Exception:  # noqa: BLE001 — a broken probe is a failed probe
            ok = False
        if not ok:
            self.probe_failures += 1
        return ok

    def admit(self, candidates: list[str]) -> list[str]:
        """Filter one discovered destination set. Order of operations:
        (1) re-probe quarantined members (recovered ones re-enter),
        (2) probe never-seen candidates (unreachable ones never enter),
        (3) quarantine admitted members with a sustained-open breaker.
        Members that left discovery are forgotten entirely — if they
        come back they re-probe as newcomers."""
        wanted = list(dict.fromkeys(candidates))   # de-dup, keep order
        events: list[str] = []
        wanted_set = set(wanted)

        # forget members discovery no longer offers
        for dest in list(self._admitted):
            if dest not in wanted_set:
                self._admitted.discard(dest)
                self._open_streak.pop(dest, None)
        for dest in list(self._quarantined):
            if dest not in wanted_set:
                self._quarantined.discard(dest)
                self._open_streak.pop(dest, None)

        # (1) quarantined members: probe for recovery
        for dest in wanted:
            if dest in self._quarantined and self._probe_ok(dest):
                self._quarantined.discard(dest)
                self._admitted.add(dest)
                self._open_streak[dest] = 0
                self.readmitted_total += 1
                events.append(f"readmit:{dest}")
                log.info("health gate re-admitted %s (probe ok)", dest)

        # (2) newcomers: probe before first admission
        for dest in wanted:
            if dest in self._admitted or dest in self._quarantined:
                continue
            if self._probe_ok(dest):
                self._admitted.add(dest)
                self._open_streak[dest] = 0
                events.append(f"admit:{dest}")
            else:
                log.warning("health gate refused unready candidate %s",
                            dest)

        # (3) sustained-open breakers: quarantine
        states = {}
        try:
            states = self.proxy.breaker_states()
        except Exception:  # noqa: BLE001 — stats must never break refresh
            log.exception("health gate could not read breaker states")
        for dest in wanted:
            if dest not in self._admitted:
                continue
            state = states.get(dest, "closed")
            if state == "open":
                self._open_streak[dest] = self._open_streak.get(dest, 0) + 1
            elif state == "closed":
                self._open_streak[dest] = 0
            # half_open: a recovery probe is in flight — hold the streak
            if self._open_streak.get(dest, 0) >= self.quarantine_after:
                if len(self._admitted) <= self.min_admitted:
                    self.quarantine_deferred += 1
                    continue
                self._admitted.discard(dest)
                self._quarantined.add(dest)
                self._open_streak.pop(dest, None)
                self.quarantined_total += 1
                events.append(f"quarantine:{dest}")
                log.warning("health gate quarantined %s (breaker open"
                            " %d consecutive refreshes)", dest,
                            self.quarantine_after)

        self.last_events = events
        return [d for d in wanted if d in self._admitted]

    def stats(self) -> dict:
        return {
            "admitted": sorted(self._admitted),
            "quarantined": sorted(self._quarantined),
            "quarantined_total": self.quarantined_total,
            "readmitted_total": self.readmitted_total,
            "probe_failures": self.probe_failures,
            "quarantine_deferred": self.quarantine_deferred,
        }


class ProxyPressureSource:
    """Assemble one observation interval's pressure signals from
    ProxyServer.forward_stats() as deltas against the previous call —
    the signal dict health/policy.elastic_pressure_reasons classifies."""

    def __init__(self, proxy) -> None:
        self.proxy = proxy
        self._last_shed = 0
        self._last_deferred = 0
        # per-member cumulative marks for the load attribution below
        self._member_marks: dict[str, float] = {}
        self._member_load: dict[str, float] = {}

    def __call__(self) -> dict:
        fs = self.proxy.forward_stats()
        shed = fs["routing"]["shed_batches"]
        deferred = 0
        member_load: dict[str, float] = {}
        marks: dict[str, float] = {}
        for dest, dest_stats in fs["destinations"].items():
            delivery = dest_stats.get("delivery")
            if delivery:
                deferred += delivery.get("deferred_payloads", 0)
            # per-member load attribution for coldest-member scale-in:
            # traffic delivered toward the member this interval (client
            # sent_metrics + delivered payloads, cumulative → delta,
            # clamped because a quarantine cycle recreates the client)
            # plus what is CURRENTLY parked or unacked toward it — a
            # member with pending work is not cold even if its interval
            # delta was.
            mark = float(dest_stats.get("sent_metrics", 0))
            if delivery:
                mark += float(delivery.get("delivered_payloads", 0))
            marks[dest] = mark
            load = max(0.0, mark - self._member_marks.get(dest, 0.0))
            if delivery:
                load += float(delivery.get("spilled_payloads", 0))
            stream = dest_stats.get("stream")
            if stream:
                load += float(stream.get("unacked_frames", 0))
            member_load[dest] = load
        self._member_marks = marks
        self._member_load = member_load
        signals = {
            "routing_shed_delta": shed - self._last_shed,
            "routing_queue_depth": fs["routing"]["queue_depth"],
            "delivery_deferred_delta": deferred - self._last_deferred,
            "spilled_metrics": fs["spilled_metrics"],
            "delivery_behind": bool(fs.get("behind")),
        }
        self._last_shed = shed
        self._last_deferred = deferred
        return signals

    def member_load(self) -> dict[str, float]:
        """Per-destination load attribution from the most recent
        observation (stream/delivery deltas + pending work), for the
        controller's coldest-member scale-in. A member with no entry
        never received routed traffic — genuinely cold (0.0)."""
        return dict(self._member_load)


class ProxyTierPressureSource:
    """Pressure signals for scaling the PROXY tier itself (both
    tiers are elastic). Where ProxyPressureSource watches one proxy's
    view of its global destinations, this watches the proxies: a
    `fleet_stats_fn` returns `{proxy_addr: forward_stats-shaped dict}`
    for every live fleet member (in the bench, the in-process
    ProxyServers; in a real deployment, the proxy's own forward_stats
    keyed under its advertised address — each proxy observes itself and
    one of them arms the controller).

    Fleet-wide deltas per observation interval:

    - admission_timeout_delta: senders timed out at an admission gate
      (routing.admission_timeouts) — fan-in saturated at the door
    - window_stall_delta: stream frames stalled on a full in-flight
      window (stream.window_stalls) — egress toward globals saturated
    - routing_shed_delta: batches shed by a routing pool
      (routing.shed_batches) — the lagging, data-losing signal
    - routing_queue_depth: Σ queue occupancy right now (gauge)

    Cumulative marks are kept per proxy address and deltas clamped >= 0
    so members joining/leaving (or restarting, counters reset) between
    observations never produce phantom pressure. member_load() is the
    per-proxy routed-batches delta — the controller's coldest-member
    scale-in evicts the proxy absorbing the least fan-in."""

    def __init__(self, fleet_stats_fn: Callable[[], dict]) -> None:
        self.fleet_stats_fn = fleet_stats_fn
        self._marks: dict[str, dict[str, float]] = {}
        self._member_load: dict[str, float] = {}

    @staticmethod
    def _observe(fs: dict) -> dict[str, float]:
        routing = fs.get("routing") or {}
        stream = fs.get("stream") or {}
        stalls = float(stream.get("window_stalls", 0))
        if not stream:
            # no aggregate stream block: sum the per-destination ones
            for dest_stats in (fs.get("destinations") or {}).values():
                dstream = dest_stats.get("stream")
                if dstream:
                    stalls += float(dstream.get("window_stalls", 0))
        return {
            "admission_timeouts": float(
                routing.get("admission_timeouts", 0)),
            "window_stalls": stalls,
            "shed_batches": float(routing.get("shed_batches", 0)),
            "queue_depth": float(routing.get("queue_depth", 0)),
            "routed": float(routing.get("routed", 0)),
        }

    def __call__(self) -> dict:
        fleet = self.fleet_stats_fn() or {}
        totals = {"admission_timeouts": 0.0, "window_stalls": 0.0,
                  "shed_batches": 0.0, "queue_depth": 0.0}
        marks: dict[str, dict[str, float]] = {}
        member_load: dict[str, float] = {}
        for addr, fs in fleet.items():
            try:
                now = self._observe(fs)
            except Exception:  # noqa: BLE001 — one sick stat never blinds the tier
                log.exception("proxy tier stats unreadable for %s", addr)
                continue
            prev = self._marks.get(addr, {})
            marks[addr] = now
            for key in ("admission_timeouts", "window_stalls",
                        "shed_batches"):
                totals[key] += max(0.0, now[key] - prev.get(key, 0.0))
            totals["queue_depth"] += now["queue_depth"]
            member_load[addr] = max(
                0.0, now["routed"] - prev.get("routed", 0.0))
        self._marks = marks
        self._member_load = member_load
        return {
            "admission_timeout_delta": totals["admission_timeouts"],
            "window_stall_delta": totals["window_stalls"],
            "routing_shed_delta": totals["shed_batches"],
            "routing_queue_depth": totals["queue_depth"],
        }

    def member_load(self) -> dict[str, float]:
        """Per-proxy routed-batches delta from the most recent
        observation — the fan-in share each member actually absorbed."""
        return dict(self._member_load)


class ElasticController:
    """Hysteresis + cooldown autoscale loop over a writable discovery
    source (FileWatchDiscoverer: `desired() -> (members, standby)` and
    `write_members(members, standby)`).

    Scale-out promotes the first standby member into the member list;
    scale-in removes the COLDEST member when per-member load
    attribution is wired (member_load_fn, fed by ProxyPressureSource.
    member_load's stream/delivery deltas) — evicting the member with
    the least pending+delivered work minimizes both the series that
    reshard and the unacked tail the handoff drain must re-home. With
    no attribution (or on ties) it falls back to the most-recently-
    added member (LIFO — the member whose series moved last moves
    again, everyone else's arcs stay put). Either way it writes the
    shrunk set back FIRST so the member leaves every consumer's ring,
    then tracks it as draining: each tick, a draining
    member that `drained_fn` reports idle (ProxyServer.destination_idle
    — out of ring, no inflight, spill empty) is retired via `retire_fn`
    and appended back to standby. Streaks reset on every action and on
    every opposite-signal interval, so deadband oscillation produces
    zero membership changes; `cooldown_s` separates consecutive
    actions so one decision's reshard settles before the next reading.
    """

    def __init__(self, source, pressure_fn: Callable[[], dict], *,
                 hysteresis_k: int = ELASTIC_HYSTERESIS_INTERVALS,
                 cooldown_s: float = 30.0,
                 min_members: int = 1,
                 max_members: int = 0,
                 drained_fn: Optional[Callable[[str], bool]] = None,
                 retire_fn: Optional[Callable[[str], None]] = None,
                 member_load_fn: Optional[
                     Callable[[], dict[str, float]]] = None,
                 time_fn: Callable[[], float] = time.monotonic) -> None:
        self.source = source
        self.pressure_fn = pressure_fn
        self.member_load_fn = member_load_fn
        self.hysteresis_k = max(1, int(hysteresis_k))
        self.cooldown_s = float(cooldown_s)
        self.min_members = max(1, int(min_members))
        self.max_members = int(max_members)
        self.drained_fn = drained_fn
        self.retire_fn = retire_fn
        self._time = time_fn
        self._pressured_streak = 0
        self._calm_streak = 0
        self._cooldown_until = 0.0
        self._draining: list[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0
        self.scale_out_total = 0
        self.scale_in_total = 0
        self.retired_total = 0
        self.cooldown_skips = 0
        self.scale_blocked_no_capacity = 0
        self.last_reasons: list[str] = []
        self.events: list[dict] = []

    def _record(self, kind: str, **detail) -> None:
        self.events.append({"tick": self.ticks, "event": kind, **detail})
        if len(self.events) > 256:
            del self.events[:128]

    def _advance_draining(self) -> None:
        still = []
        for dest in self._draining:
            drained = self.drained_fn(dest) if self.drained_fn else True
            if not drained:
                still.append(dest)
                continue
            if self.retire_fn is not None:
                try:
                    self.retire_fn(dest)
                except Exception:  # noqa: BLE001 — retire is best-effort
                    log.exception("retire_fn failed for %s", dest)
            members, standby = self.source.desired()
            if dest not in standby:
                self.source.write_members(members, standby + [dest])
            self.retired_total += 1
            self._record("retired", member=dest, drained=drained)
            log.info("elastic: retired %s (drained, demoted to standby)",
                     dest)
        self._draining = still

    def tick(self) -> Optional[str]:
        """One observation interval. Returns the action taken ("out",
        "in") or None. Safe to drive manually (the soak does) or from
        the start() thread."""
        self.ticks += 1
        self._advance_draining()

        signals = self.pressure_fn()
        reasons = elastic_pressure_reasons(signals)
        self.last_reasons = reasons
        if reasons:
            self._pressured_streak += 1
            self._calm_streak = 0
        else:
            self._calm_streak += 1
            self._pressured_streak = 0

        members, standby = self.source.desired()
        decision = elastic_scale_decision(
            self._pressured_streak, self._calm_streak, len(members),
            k=self.hysteresis_k, min_members=self.min_members,
            max_members=self.max_members)
        if decision is None:
            return None
        now = self._time()
        if now < self._cooldown_until:
            self.cooldown_skips += 1
            return None

        if decision == "out":
            if not standby:
                self.scale_blocked_no_capacity += 1
                self._record("scale_blocked", reason="no standby capacity")
                return None
            promoted = standby[0]
            self.source.write_members(members + [promoted], standby[1:])
            self.scale_out_total += 1
            self._record("scale_out", member=promoted,
                         reasons=list(reasons), members=len(members) + 1)
            log.info("elastic: scale-out promoted %s (%s); members=%d",
                     promoted, ",".join(reasons), len(members) + 1)
        else:
            victim, victim_load = self._pick_scale_in_victim(members)
            # leave the ring first; retirement waits for the drain
            self.source.write_members(
                [m for m in members if m != victim], standby)
            self._draining.append(victim)
            self.scale_in_total += 1
            self._record("scale_in", member=victim,
                         members=len(members) - 1, load=victim_load)
            log.info("elastic: scale-in removed %s (coldest, load=%s,"
                     " draining); members=%d", victim, victim_load,
                     len(members) - 1)

        self._cooldown_until = now + self.cooldown_s
        self._pressured_streak = 0
        self._calm_streak = 0
        return decision

    def _pick_scale_in_victim(
            self, members: list[str]) -> tuple[str, Optional[float]]:
        """Coldest member by per-destination load attribution
        (ProxyPressureSource.member_load: stream/delivery deltas plus
        pending work). Ties — including every load equal, and the
        no-data fallback when member_load_fn is unset or fails — break
        toward the most recently added member (the old LIFO behavior:
        the member whose series moved last moves again, everyone
        else's arcs stay put)."""
        if self.member_load_fn is None:
            return members[-1], None
        try:
            loads = self.member_load_fn() or {}
        except Exception:  # noqa: BLE001 — stats must never block scaling
            log.exception("member_load_fn failed; falling back to LIFO")
            return members[-1], None
        victim = min(
            reversed(members),
            key=lambda dest: loads.get(dest, 0.0))
        return victim, loads.get(victim, 0.0)

    def draining(self) -> list[str]:
        return list(self._draining)

    def stats(self) -> dict:
        return {
            "ticks": self.ticks,
            "scale_out_total": self.scale_out_total,
            "scale_in_total": self.scale_in_total,
            "retired_total": self.retired_total,
            "cooldown_skips": self.cooldown_skips,
            "scale_blocked_no_capacity": self.scale_blocked_no_capacity,
            "pressured_streak": self._pressured_streak,
            "calm_streak": self._calm_streak,
            "draining": list(self._draining),
            "last_reasons": list(self.last_reasons),
        }

    def start(self, interval_s: float = 10.0) -> None:
        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the loop must survive
                    log.exception("elastic controller tick failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="elastic-controller")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
