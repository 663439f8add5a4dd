"""Client-side proxy spreading: the local tier's multi-destination
forwarder over a discovered proxy fleet.

The single-proxy topology pinned in RING_SUSTAINED.json is the ring's
choke point: N globals behind ONE proxy means every local server's
forward traffic funnels through one routing path. The reference design
(proxysrv/server.go + proxy.go's discoverer) runs a fleet of stateless
proxies any client can hit; this module is the client half of that
fleet.

`SpreadForwarder` keeps one *lane* per live proxy — a streaming
`ForwardClient` plus a `DeliveryManager` (bounded retry, circuit
breaker, bounded spill), the exact machinery the proxies themselves run
per global destination — and spreads each flush's forward payloads
across lanes:

- **Spread policy**: power-of-two-choices on in-flight window depth
  (unacked stream frames + sends in flight + spilled payloads toward
  the lane). Two lanes are sampled per payload and the shallower wins;
  when the depth signal is uninformative (equal depths — e.g. an idle
  fleet, or unary mode between sends) the pick falls back STICKY to
  plain round-robin, so an idle fleet still gets an even rotation
  instead of a hot random favorite.

- **Failover, not stalls**: a payload whose lane attempt fails
  transiently spills toward that lane (the ordinary delivery-layer
  defer). When the lane is effectively dead — breaker open, or the
  proxy left membership — its spill is drained (`handed_off` in that
  lane's ledger, keeping per-lane conservation exact) and re-delivered
  across the surviving lanes. Every such cross-proxy re-send is counted
  in `respread_total`; the subset whose prior attempt was ambiguous
  (deadline_exceeded — the bytes MAY have landed) is additionally
  counted in `respread_ambiguous_total`, mirroring the proxy's own
  `dedup_remint_after_attempt` honesty counter.

- **Exactly-once stays pinned**: the local→proxy hop carries no dedup
  envelope — each PROXY mints idempotency keys under its own journal
  sender token for the proxy→global hop, so any proxy path is
  idempotent at the import window and a payload re-spread to a
  different proxy cannot double-apply *there*. The residual risk is
  precisely the ambiguous-respread case counted above (identical to
  the at-least-once residual the proxy tier already declares).

Membership is dynamic: `set_destinations` adds/removes lanes, and the
object is duck-compatible with `DestinationRefresher` (it exposes
`ring`-sized membership, `set_destinations(dests, cause=)`,
`breaker_states()` and a `refresher` attachment point), so the SAME
Discoverer/DestinationRefresher/HealthGate stack the proxies use for
globals drives the local tier's view of the proxy fleet —
`FileWatchDiscoverer` included.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, Optional

from veneur_tpu_torch.distributed import codec
from veneur_tpu_torch.distributed.rpc import (
    ForwardClient, ForwardError, stream_adaptive_enabled,
)
from veneur_tpu_torch.sinks.delivery import DeliveryManager, DeliveryPolicy

log = logging.getLogger("veneur_tpu_torch.spread")

SPREAD_POLICIES = ("p2c", "round_robin")

# causes after which a re-send through a DIFFERENT proxy is known-safe:
# the payload never reached the dead lane ("unavailable" = transport
# refused/reset before a response, "busy" = receiver explicitly refused
# the frame, "send" = serialization/permanent local failure). A
# deadline_exceeded attempt is ambiguous — the bytes may have landed —
# so its respread is counted separately, never silently.
RESPREAD_SAFE_CAUSES = frozenset({"unavailable", "busy", "send"})


class _SpreadPayload:
    """Opaque delivery context travelling with a payload into a lane's
    spill: the wire bytes, the metric count, and the last failure cause
    observed for it (classifies a later respread as safe/ambiguous)."""

    __slots__ = ("blob", "count", "last_cause", "respreads")

    def __init__(self, blob: bytes, count: int) -> None:
        self.blob = blob
        self.count = count
        self.last_cause: Optional[str] = None
        self.respreads = 0


class _Members:
    """Duck-typed stand-in for the proxy's ConsistentRing in refresher
    log lines and telemetry: sized membership plus a version stamp (the
    spread forwarder has no hash ring — ANY live proxy can take any
    payload, which is the whole point of a stateless proxy fleet)."""

    def __init__(self) -> None:
        self.members: list[str] = []
        self.version = 0

    def __len__(self) -> int:
        return len(self.members)

    def __contains__(self, addr: str) -> bool:
        return addr in self.members


class _Lane:
    """One proxy destination: its streaming client, delivery ledger,
    and spread bookkeeping."""

    __slots__ = ("addr", "client", "manager", "inflight", "picks",
                 "respread_out", "respread_in")

    def __init__(self, addr: str, client: ForwardClient,
                 manager: DeliveryManager) -> None:
        self.addr = addr
        self.client = client
        self.manager = manager
        self.inflight = 0          # sends currently inside deliver()
        self.picks = 0             # times the spread policy chose it
        self.respread_out = 0      # payloads re-routed away (metrics)
        self.respread_in = 0       # payloads absorbed from dead lanes

    def depth(self) -> int:
        """In-flight window depth, the p2c signal: unacked stream
        frames + sends mid-delivery + payloads parked toward it."""
        d = self.inflight + len(self.manager.spill)
        if getattr(self.client, "streaming", False):
            st = getattr(self.client, "_stream", None)
            if st is not None:
                d += len(st.pending)
        return d


class SpreadForwarder:
    """Flush-callable (`server.forwarder`) that spreads forward payloads
    across a dynamic fleet of proxies. See module docstring."""

    def __init__(self, destinations: list[str],
                 timeout_s: float = 10.0,
                 compression: float = 100.0, hll_precision: int = 14,
                 stats=None, streaming: bool = True,
                 stream_window: int = 32,
                 stream_adaptive: bool = True,
                 stream_window_min: int = 1,
                 stream_window_max: int = 128,
                 stream_frame_bytes: int = 262144,
                 policy: Optional[DeliveryPolicy] = None,
                 spread_policy: str = "p2c",
                 client_factory: Optional[Callable] = None,
                 rng: Optional[random.Random] = None) -> None:
        if spread_policy not in SPREAD_POLICIES:
            raise ValueError(
                f"spread_policy must be one of {SPREAD_POLICIES}")
        self.timeout_s = timeout_s
        self.compression = compression
        self.hll_precision = hll_precision
        self.stats = stats
        self.streaming = bool(streaming)
        self.stream_window = max(1, int(stream_window))
        self.stream_adaptive = bool(stream_adaptive)
        self.stream_window_min = max(1, int(stream_window_min))
        self.stream_window_max = max(
            self.stream_window_min, int(stream_window_max))
        self.stream_frame_bytes = max(1, int(stream_frame_bytes))
        self.spread_policy = spread_policy
        self._policy = policy or DeliveryPolicy(
            timeout_s=timeout_s, deadline_s=timeout_s)
        self._client_factory = client_factory
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._lanes: dict[str, _Lane] = {}
        self._retired: list[_Lane] = []   # ledgers of removed lanes
        self.ring = _Members()
        self.refresher = None             # attached by DestinationRefresher
        self._rr = 0                      # round-robin cursor
        self.respread_total = 0           # metrics re-sent cross-proxy
        self.respread_ambiguous_total = 0
        self.respread_payloads = 0
        self.dropped_metrics = 0          # declared losses (caps/deadline)
        self.picks_p2c = 0                # p2c decided by depth
        self.picks_rr = 0                 # sticky round-robin fallback
        self.last_membership_cause = ""
        if destinations:
            self.set_destinations(list(destinations), cause="static")

    # -- membership (DestinationRefresher drives this) -----------------------

    def _make_lane(self, addr: str) -> _Lane:
        if self._client_factory is not None:
            client = self._client_factory(addr, self.timeout_s)
        else:
            client = ForwardClient(
                addr, self.timeout_s,
                streaming=self.streaming,
                stream_window=self.stream_window,
                stream_adaptive=self.stream_adaptive,
                stream_window_min=self.stream_window_min,
                stream_window_max=self.stream_window_max)
        manager = DeliveryManager("forward:" + addr, self._policy)
        return _Lane(addr, client, manager)

    def set_destinations(self, destinations: list[str],
                         cause: str = "") -> Optional[dict]:
        """Reset the live proxy set. Removed lanes' spilled payloads are
        re-spread to the survivors immediately (their ledgers stay
        retained for stats/conservation); returns a change summary or
        None when membership is unchanged."""
        wanted = list(dict.fromkeys(a for a in destinations if a))
        with self._lock:
            if wanted == self.ring.members:
                return None
            current = set(self._lanes)
            added = [a for a in wanted if a not in current]
            removed = [a for a in current if a not in set(wanted)]
            for addr in added:
                self._lanes[addr] = self._make_lane(addr)
            dead = [self._lanes.pop(addr) for addr in removed]
            self.ring.members = wanted
            self.ring.version += 1
            self.last_membership_cause = cause
        change = {"version": self.ring.version, "added": added,
                  "removed": removed, "cause": cause}
        if added or removed:
            log.info("spread membership v%d: +%s -%s (%s)",
                     self.ring.version, added or "[]", removed or "[]",
                     cause or "?")
        for lane in dead:
            self._respread_lane(lane, reason="membership")
            lane.client.close()
            with self._lock:
                self._retired.append(lane)
        return change

    def breaker_states(self) -> dict[str, str]:
        """Per-proxy circuit state — HealthGate's quarantine signal,
        same shape the ProxyServer exposes for globals."""
        with self._lock:
            lanes = list(self._lanes.values())
        return {ln.addr: ln.manager.stats()["circuit_state"]
                for ln in lanes}

    def addresses(self) -> list[str]:
        with self._lock:
            return list(self.ring.members)

    # -- spread policy -------------------------------------------------------

    def _pick(self, exclude: frozenset = frozenset()) -> Optional[_Lane]:
        """Choose the lane for one payload. Power-of-two-choices on
        in-flight depth among breaker-admitting lanes; equal depths (or
        the round_robin policy) fall back sticky to rotation order."""
        with self._lock:
            live = [ln for ln in self._lanes.values()
                    if ln.addr not in exclude]
            if not live:
                return None
            # prefer lanes whose breaker admits traffic; a fully-open
            # fleet degrades to "try anyway" (the breaker's half-open
            # probe is how a lane proves recovery)
            admitting = [ln for ln in live
                         if ln.manager.breaker.can_attempt()]
            pool = admitting or live
            self._rr += 1
            if len(pool) == 1:
                lane = pool[0]
            elif self.spread_policy == "round_robin":
                lane = pool[self._rr % len(pool)]
                self.picks_rr += 1
            else:
                i = self._rr % len(pool)
                j = self._rng.randrange(len(pool) - 1)
                if j >= i:
                    j += 1
                a, b = pool[i], pool[j]
                da, db = a.depth(), b.depth()
                if da == db:
                    # depth signal uninformative: sticky round-robin
                    lane = a
                    self.picks_rr += 1
                else:
                    lane = a if da < db else b
                    self.picks_p2c += 1
            lane.picks += 1
            return lane

    # -- the payload path ----------------------------------------------------

    def _send_via(self, lane: _Lane, payload: _SpreadPayload) -> str:
        """One delivery attempt chain through a lane's manager."""

        def send(timeout_s: float) -> None:
            try:
                lane.client.send_raw_or_raise(
                    payload.blob, payload.count, timeout_s)
            except ForwardError as e:
                payload.last_cause = e.cause
                raise
            payload.last_cause = None

        with self._lock:
            lane.inflight += 1
        try:
            return lane.manager.deliver(send, len(payload.blob), payload)
        finally:
            with self._lock:
                lane.inflight -= 1

    def send_wire(self, blob: bytes, count: int) -> str:
        """Deliver one wire payload (serialized MetricBatch bytes) to
        SOME live proxy. Returns the terminal outcome for the primary
        lane ("delivered"/"deferred"/"dropped"); a deferred payload
        whose lane is dead re-spreads to survivors before returning."""
        payload = _SpreadPayload(blob, count)
        lane = self._pick()
        if lane is None:
            self.dropped_metrics += count
            return "dropped"
        outcome = self._send_via(lane, payload)
        if outcome == "dropped":
            self.dropped_metrics += count
        elif (outcome == "deferred"
              and lane.manager.stats()["circuit_state"] == "open"):
            # the lane is effectively dead and the payload just parked
            # toward it: re-route its whole spill NOW so this flush's
            # share lands on survivors instead of waiting out a retry
            # cycle against a corpse
            self._respread_lane(lane, reason="breaker_open")
        return outcome

    def _respread_lane(self, lane: _Lane, reason: str) -> int:
        """Drain a dead lane's spill and re-deliver each payload through
        the surviving lanes. The drain counts as handed_off in the dead
        lane's ledger and re-accepts in the survivor's, so every
        per-lane conservation identity stays exact. Returns metrics
        re-homed."""
        entries = lane.manager.drain_spill()
        if not entries:
            return 0
        moved = 0
        for entry in entries:
            payload = entry.payload
            if not isinstance(payload, _SpreadPayload):
                # foreign payloads (tests poking the manager directly)
                # cannot be re-routed — declare the loss
                with lane.manager._lock:
                    lane.manager.accepted_payloads += 1
                    lane.manager.dropped_payloads += 1
                continue
            ambiguous = (payload.last_cause is not None
                         and payload.last_cause not in
                         RESPREAD_SAFE_CAUSES)
            alt = self._pick(exclude=frozenset((lane.addr,)))
            if alt is None:
                # no survivors: the payload is a declared drop (its
                # metrics were never acked upstream)
                with self._lock:
                    self.dropped_metrics += payload.count
                with lane.manager._lock:
                    lane.manager.accepted_payloads += 1
                    lane.manager.dropped_payloads += 1
                continue
            payload.respreads += 1
            with self._lock:
                self.respread_total += payload.count
                self.respread_payloads += 1
                if ambiguous:
                    self.respread_ambiguous_total += payload.count
                lane.respread_out += payload.count
                alt.respread_in += payload.count
            outcome = self._send_via(alt, payload)
            if outcome == "dropped":
                with self._lock:
                    self.dropped_metrics += payload.count
            else:
                moved += payload.count
        if moved:
            log.info("respread %d metric(s) off %s (%s)", moved,
                     lane.addr, reason)
        return moved

    def respread_dead(self) -> int:
        """Sweep every breaker-open lane's spill onto survivors (the
        same move send_wire does inline); the flush path calls this once
        per flush so a lane that died BETWEEN flushes re-routes its
        parked share without waiting for fresh traffic to trip it."""
        with self._lock:
            lanes = list(self._lanes.values())
        moved = 0
        for lane in lanes:
            if (len(lane.manager.spill)
                    and lane.manager.stats()["circuit_state"] == "open"):
                moved += self._respread_lane(lane, reason="sweep")
        return moved

    def begin_flush(self, deadline_s: Optional[float] = None) -> None:
        """Arm every lane's delivery deadline/breaker interval and retry
        parked payloads ahead of fresh data (spilled-first ordering, the
        sink-funnel contract)."""
        with self._lock:
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.manager.begin_flush(deadline_s)
            lane.manager.retry_spill()
        self.respread_dead()

    def __call__(self, snapshots) -> None:
        """The flush entry point (`server.forwarder`): encode each
        worker snapshot to wire bytes and spread the payloads across
        the live fleet. With the adaptive streaming path on, consecutive
        snapshot blobs are regrouped to ~stream_frame_bytes payloads
        (safe on this hop: bare MetricBatch blobs concatenate into a
        merged batch — the local→proxy leg carries no dedup envelopes),
        so each spread unit costs one predictable stream-window slot."""
        started = time.time()
        self.begin_flush()
        parts: list[tuple[bytes, int]] = []
        total = 0
        for snap in snapshots:
            blob, n = codec.snapshot_to_wire(
                snap, self.compression, self.hll_precision)
            if not n:
                continue
            parts.append((blob, n))
            total += n
        if self.streaming and stream_adaptive_enabled(self.stream_adaptive):
            payloads = codec.frame_groups(parts, self.stream_frame_bytes)
        else:
            # adaptive off: the fixed-window shape — one payload per snapshot
            payloads = parts
        sent_bytes = 0
        worst_cause: Optional[str] = None
        for blob, n in payloads:
            sent_bytes += len(blob)
            outcome = self.send_wire(blob, n)
            if outcome == "dropped":
                worst_cause = "dropped"
            elif outcome == "deferred" and worst_cause is None:
                worst_cause = "deferred"
        if not total:
            return
        from veneur_tpu_torch.distributed.forward import _report_forward

        _report_forward(self.stats, total, started, worst_cause,
                        content_length=sent_bytes)

    # -- drain/teardown ------------------------------------------------------

    def drain(self, deadline_s: float = 5.0) -> int:
        """Settle every lane's spill before teardown: retry toward the
        owner, re-spread off dead lanes, repeat until empty or the
        deadline clips. Returns payloads still parked (journal-less —
        whatever remains is a declared, counted loss on close)."""
        deadline = time.monotonic() + max(0.0, deadline_s)
        while True:
            with self._lock:
                lanes = list(self._lanes.values())
            remaining = 0
            for lane in lanes:
                if len(lane.manager.spill):
                    lane.manager.begin_flush()
                    lane.manager.retry_spill()
            self.respread_dead()
            remaining = sum(len(ln.manager.spill) for ln in lanes)
            if not remaining or time.monotonic() >= deadline:
                return remaining
            time.sleep(0.05)

    def conserved(self) -> bool:
        """Every lane's ledger balances — live and retired both (a
        retired lane handed its spill off; the identity follows it)."""
        with self._lock:
            lanes = list(self._lanes.values()) + list(self._retired)
        return all(ln.manager.conserved() for ln in lanes)

    def ingested_metrics(self) -> int:
        """Metrics ACKED by some proxy (each client counts sent_metrics
        only on success; a respread payload therefore counts once)."""
        with self._lock:
            lanes = list(self._lanes.values()) + list(self._retired)
        return sum(ln.client.sent_metrics for ln in lanes)

    def forward_stats(self) -> dict:
        """Spread-level and per-proxy telemetry (named forward_stats to
        mirror ProxyServer.forward_stats; the plain `stats` attribute is
        the telemetry sink). The server's flush self-telemetry renders
        the per-proxy blocks as veneur.forward.* tagged proxy:<addr>."""
        with self._lock:
            lanes = list(self._lanes.values())
            retired = list(self._retired)
            out = {
                "proxies": len(lanes),
                "membership_version": self.ring.version,
                "membership_cause": self.last_membership_cause,
                "spread_policy": self.spread_policy,
                "respread_total": self.respread_total,
                "respread_ambiguous_total": self.respread_ambiguous_total,
                "respread_payloads": self.respread_payloads,
                "dropped_metrics": self.dropped_metrics,
                "picks_p2c": self.picks_p2c,
                "picks_rr": self.picks_rr,
            }
        per = {}
        for lane in lanes:
            cs = lane.client.stats()
            ds = lane.manager.stats()
            per[lane.addr] = {
                "live": True,
                "picks": lane.picks,
                "inflight": lane.inflight,
                "depth": lane.depth(),
                "sent_batches": cs["sent_batches"],
                "sent_metrics": cs["sent_metrics"],
                "errors": cs["errors"],
                "stream": cs.get("stream"),
                "delivery": ds,
                "respread_out": lane.respread_out,
                "respread_in": lane.respread_in,
            }
        for lane in retired:
            per.setdefault(lane.addr, {
                "live": False,
                "picks": lane.picks,
                "sent_metrics": lane.client.sent_metrics,
                "delivery": lane.manager.stats(),
                "respread_out": lane.respread_out,
                "respread_in": lane.respread_in,
            })
        out["destinations"] = per
        if self.refresher is not None:
            out["refresh"] = self.refresher.stats()
        return out

    def close(self) -> None:
        if self.refresher is not None:
            try:
                self.refresher.stop()
            except Exception:  # noqa: BLE001 — teardown must not raise
                log.exception("spread refresher stop failed")
        remaining = self.drain(deadline_s=1.0)
        if remaining:
            log.warning("spread forwarder closing with %d payload(s)"
                        " still parked (declared drops)", remaining)
        with self._lock:
            lanes = list(self._lanes.values())
            self._lanes.clear()
            self.ring.members = []
        for lane in lanes:
            lane.client.close()
            with self._lock:
                self._retired.append(lane)
