"""Shared sink delivery-reliability layer: retry, breaker, bounded spill.

PyTorch port: a copy of veneur_tpu/sinks/delivery.py with its imports
rebound. ``attach_journal`` is copied but never called: the factory
refuses ``spill_journal_dir``, and ``utils/journal.py``, which
``mint_key`` imports only with a journal attached, is not ported yet.

The reference treats backend flakiness as the normal case — its sinks
carry retry-with-backoff (sinks/splunk resend-once on a stale
keep-alive) and lifecycle-jittered reconnects; our HTTP sinks handled
every delivery failure with a single log-and-drop, so one hung endpoint
ate a third of the flush deadline and one transient 503 silently lost a
whole interval of a sink's series. This module centralises bounded
delivery for every network sink:

1. Bounded retry with exponential backoff + FULL jitter
   (delay ~ U[0, min(max, base*2^attempt)]), on retryable failures only:
   connect refused/reset, timeouts, and HTTP 408/429/5xx. Other 4xx are
   payload errors — a retry resends the same rejected bytes, so they
   drop immediately with honest counters.
2. The whole retry budget is clipped to the remaining flush-interval
   deadline (armed per flush by begin_flush): a sick sink can never
   stall the emit stage past its tick. A payload that runs out of
   deadline is SPILLED, not lost.
3. A per-sink circuit breaker: closed → open after N consecutive
   delivery failures → half-open with a single probe per flush interval
   → closed on probe success. A dead endpoint costs one cheap probe per
   interval instead of serial connect timeouts.
4. A bounded per-sink spill of failed *serialized* payloads (send
   closures over already-built wire bytes), capped by bytes AND payload
   count, oldest dropped first with `dropped_payloads`/`dropped_bytes`
   counters. Spilled payloads are retried AHEAD of fresh data on the
   next flush (retry_spill) — graceful degradation, never unbounded
   memory.

Accounting contract (the chaos soak's conservation invariant,
tools/soak_faults.py):

    accepted_payloads == delivered_payloads + dropped_payloads
                         + handed_off_payloads
                         + spilled_payloads (still queued)

holds exactly at any quiescent point: every payload handed to deliver()
is eventually delivered, declared dropped, handed off (drained out by
the proxy's ring-reshard re-routing, where it is re-accepted by the new
owner's manager), or sitting in the bounded spill. Nothing is silently
lost.

The clock, sleep, and jitter RNG are injectable so the breaker state
machine and deadline math are unit-testable deterministically
(tests/test_delivery.py) and the fault soak is seedable.
"""

from __future__ import annotations

import collections
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

log = logging.getLogger("veneur_tpu_torch.sinks.delivery")

# breaker states (circuit_state_code gauge: dashboards want a number)
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

# HTTP statuses worth retrying: timeout, throttle, and server-side
# errors. Every other 4xx means the payload itself was rejected.
RETRYABLE_STATUSES = frozenset({408, 429})


def retryable(exc: BaseException) -> bool:
    """Transient-vs-permanent failure classification.

    Retryable: connection-level failures (refused, reset, broken pipe,
    DNS/socket OSErrors), timeouts, and HTTP 408/429/5xx. NOT
    retryable: other HTTP 4xx (the payload is bad; resending the same
    bytes re-fails) and non-network exceptions (serializer bugs must
    surface, not loop).

    Exceptions carrying their own verdict (a bool `transient` attribute
    — distributed/rpc.py ForwardError maps the gRPC status taxonomy:
    deadline/unavailable are transport-shaped, other send failures are
    permanent) are classified by it directly."""
    from veneur_tpu_torch.utils.http import HTTPError

    transient = getattr(exc, "transient", None)
    if isinstance(transient, bool):
        return transient
    if isinstance(exc, HTTPError):
        return exc.status in RETRYABLE_STATUSES or exc.status >= 500
    if isinstance(exc, (TimeoutError, ConnectionError)):
        # socket.timeout is TimeoutError; ConnectionRefusedError /
        # ConnectionResetError / BrokenPipeError are ConnectionError
        return True
    if isinstance(exc, OSError):
        return True
    try:
        import urllib.error

        if isinstance(exc, urllib.error.URLError):
            return True
    except ImportError:  # pragma: no cover
        pass
    return False


@dataclass
class DeliveryPolicy:
    """Per-sink delivery knobs (config: sink_retry_max,
    sink_breaker_threshold, sink_spill_max_bytes/_payloads,
    flush_timeout_s; deadline_s defaults to the flush interval)."""

    retry_max: int = 2            # retries after the first attempt
    breaker_threshold: int = 3    # consecutive failures to open; 0 = off
    spill_max_bytes: int = 4 << 20
    spill_max_payloads: int = 256
    timeout_s: float = 10.0       # per-attempt network timeout
    deadline_s: float = 10.0      # per-flush delivery budget
    backoff_base_s: float = 0.25
    backoff_max_s: float = 5.0

    @classmethod
    def from_config(cls, cfg, interval_s: float) -> "DeliveryPolicy":
        # the per-attempt timeout can't usefully exceed the per-flush
        # budget; the budget is the flush interval (the emit stage joins
        # sink threads at exactly that horizon)
        return cls(
            retry_max=cfg.sink_retry_max,
            breaker_threshold=cfg.sink_breaker_threshold,
            spill_max_bytes=cfg.sink_spill_max_bytes,
            spill_max_payloads=cfg.sink_spill_max_payloads,
            timeout_s=min(cfg.flush_timeout_s, interval_s),
            deadline_s=interval_s,
        )


class CircuitBreaker:
    """closed → open after `threshold` consecutive failures → half-open
    single-probe per interval → closed on probe success.

    begin_interval() is the interval edge: an open breaker arms exactly
    one probe credit. allow() consumes the credit in half-open; every
    other caller short-circuits until the probe verdict. Transitions
    are recorded (bounded) so the chaos soak can assert a full
    open→half_open→closed cycle. Not thread-safe by itself — the
    owning DeliveryManager serialises access under its lock."""

    TRANSITION_LOG_MAX = 64

    def __init__(self, threshold: int) -> None:
        self.threshold = max(0, int(threshold))
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_total = 0
        self._probe_armed = False
        self.transitions: collections.deque[str] = collections.deque(
            maxlen=self.TRANSITION_LOG_MAX)

    def _to(self, state: str) -> None:
        if state != self.state:
            self.state = state
            self.transitions.append(state)
            if state == OPEN:
                self.opened_total += 1

    def begin_interval(self) -> None:
        if self.state == OPEN:
            self._probe_armed = True
            self._to(HALF_OPEN)

    def can_attempt(self) -> bool:
        """Non-consuming peek (retry_spill uses it to leave the spill
        untouched when nothing could be sent anyway)."""
        if self.threshold == 0 or self.state == CLOSED:
            return True
        return self.state == HALF_OPEN and self._probe_armed

    def allow(self) -> bool:
        if self.threshold == 0 or self.state == CLOSED:
            return True
        if self.state == HALF_OPEN and self._probe_armed:
            self._probe_armed = False  # the single probe
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.threshold and self.state != CLOSED:
            self._to(CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if not self.threshold:
            return
        if self.state == HALF_OPEN:
            self._to(OPEN)  # probe failed: re-open until next interval
        elif (self.state == CLOSED
              and self.consecutive_failures >= self.threshold):
            self._to(OPEN)


@dataclass
class _SpillEntry:
    send: Callable[[float], None]  # one attempt over serialized bytes
    nbytes: int
    # opaque caller context travelling with the spilled payload — the
    # proxy stores its routed fragment here so a ring reshard can drain
    # the spill and RE-route it under the new membership (drain_spill)
    payload: object = None
    # owning tenant when the caller knows it (per-tenant QoS): an
    # over-budget tenant's spilled payloads are evicted FIRST when the
    # caps bite, so an abusive tenant's flood can't push innocents'
    # deferred data out of the bounded spill
    tenant: str = ""
    # write-ahead journal record id once the entry has a durable shadow
    # (utils/journal.py). Set on first spill, preserved across re-spills
    # and drain/re-route handoffs; acked at the terminal outcome. None =
    # never journaled (journaling off, or the payload isn't encodable).
    jid: Optional[int] = None


class SpillBuffer:
    """Bounded FIFO of failed serialized payloads; oldest dropped first
    when either cap is exceeded. push() returns the evicted entries so
    the manager can count them as dropped — drops are declared, never
    silent."""

    def __init__(self, max_bytes: int, max_payloads: int) -> None:
        self.max_bytes = max(0, int(max_bytes))
        self.max_payloads = max(0, int(max_payloads))
        self._q: collections.deque[_SpillEntry] = collections.deque()
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._q)

    def push(self, entry: _SpillEntry,
             abusive: frozenset = frozenset()) -> list[_SpillEntry]:
        self._q.append(entry)
        self.bytes += entry.nbytes
        evicted: list[_SpillEntry] = []
        while abusive and (len(self._q) > self.max_payloads
                           or self.bytes > self.max_bytes):
            # tenant-aware eviction order (health/policy.py shed
            # ordering, applied to the spill): oldest payloads of
            # OVER-BUDGET tenants go first; only when none remain does
            # the blanket oldest-first rule below touch innocents
            victim = next((e for e in self._q if e.tenant in abusive),
                          None)
            if victim is None:
                break
            self._q.remove(victim)
            self.bytes -= victim.nbytes
            evicted.append(victim)
        while self._q and (len(self._q) > self.max_payloads
                           or self.bytes > self.max_bytes):
            old = self._q.popleft()
            self.bytes -= old.nbytes
            evicted.append(old)
        return evicted

    def pop_all(self) -> list[_SpillEntry]:
        out = list(self._q)
        self._q.clear()
        self.bytes = 0
        return out


class DeliveryManager:
    """One per network sink: owns the breaker, the spill, and the
    retry/deadline math. Thread-safe (sinks post payloads from parallel
    threads); network sends run outside the lock.

    deliver(send, nbytes) drives one payload to a terminal outcome for
    this flush: "delivered", "dropped" (permanent — payload error or
    spill eviction), or "deferred" (spilled for the next interval).
    Sinks fold their own success counters inside the send closure so a
    spilled payload delivered two intervals later still counts."""

    def __init__(self, name: str,
                 policy: Optional[DeliveryPolicy] = None,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None,
                 evict_cb: Optional[Callable[[object], None]] = None) -> None:
        self.sink_name = name
        self.policy = policy or DeliveryPolicy()
        self._time = time_fn
        self._sleep = sleep_fn
        self._rng = rng or random.Random()
        # called (with the evicted entry's payload context) when a spill
        # cap pushes out an OLDER entry — the owner keeps its own
        # metric-level drop accounting in sync with the payload-level
        # counters here. The entry being spilled right now reports its
        # own eviction through the "dropped" return instead.
        self._evict_cb = evict_cb
        # per-tenant QoS hook (installed by the server when a tenant
        # ledger exists): zero-arg callable returning the frozenset of
        # currently over-budget tenants, consulted at spill-eviction
        # time so abusive tenants' payloads are pushed out first
        self.abusive_tenants: Optional[Callable[[], frozenset]] = None
        # write-ahead spill journal (attach_journal); None = journaling
        # off, and every hook below is a no-op so behaviour is identical
        # to the in-RAM-only manager (pinned by tests/test_journal.py)
        self._journal = None
        self._journal_encode: Optional[Callable[[_SpillEntry],
                                                Optional[bytes]]] = None
        # send-once sinks (splunk HEC: retry_max=0, no spill) set this to
        # refuse journaling explicitly — a replayed payload would violate
        # their at-most-once semantics
        self.journal_exempt = False
        self._lock = threading.Lock()
        self.breaker = CircuitBreaker(self.policy.breaker_threshold)
        self.spill = SpillBuffer(self.policy.spill_max_bytes,
                                 self.policy.spill_max_payloads)
        self._deadline: Optional[float] = None
        # cumulative counters (server reports interval deltas)
        self.accepted_payloads = 0
        self.delivered_payloads = 0
        self.dropped_payloads = 0
        self.dropped_bytes = 0
        self.retries = 0
        self.deferred_payloads = 0   # deferral EVENTS (a payload may defer
        self.deadline_clipped = 0    # across several intervals)
        self.breaker_short_circuits = 0
        self.handed_off_payloads = 0  # drained out for re-routing
        self.journal_appended = 0     # spilled payloads given a durable shadow
        self.journal_append_failed = 0
        self.journal_recovered = 0    # payloads replayed from a prior
        self.journal_decode_failed = 0  # incarnation's journal
        # idempotency-key minting (mint_key): sender token + sequence
        self._mint_sender: Optional[str] = None
        self._mint_next = 0

    # -- durability hooks ---------------------------------------------------

    def attach_journal(self, journal,
                       encode: Callable[["_SpillEntry"], Optional[bytes]],
                       ) -> bool:
        """Back this manager's spill with a write-ahead journal
        (utils/journal.py). `encode(entry)` serializes a spill entry to
        journal bytes, or returns None for payloads that carry no
        durable context (those stay RAM-only, exactly as before).
        Refused (returns False) for journal_exempt managers — send-once
        sinks must never replay."""
        if self.journal_exempt:
            log.info("sink %s: journal attach refused (send-once "
                     "semantics, journal_exempt)", self.sink_name)
            return False
        with self._lock:
            self._journal = journal
            self._journal_encode = encode
        return True

    def recover(self, decode: Callable[[bytes], Optional["_SpillEntry"]],
                ) -> int:
        """Replay the attached journal's unacked payloads into the spill
        so they are retried AHEAD of fresh data (the existing
        retry_spill contract). Recovered entries keep their original
        record ids — no re-append — so a second restart before delivery
        replays the same records once more (idempotent). They count into
        accepted_payloads and journal_recovered, extending conservation
        across incarnations:

            accepted (incl. recovered) == delivered + dropped
                                          + handed_off + still-spilled

        Undecodable records (corrupt payload that passed the CRC, or a
        format from a newer build) are acked and counted — declared,
        not silently dropped on the floor of every future replay."""
        if self._journal is None:
            return 0
        recovered = 0
        for rid, blob in self._journal.replay_pending():
            try:
                entry = decode(blob)
            except Exception:  # noqa: BLE001 — decoder bugs must not
                entry = None   # wedge startup
            if entry is None:
                with self._lock:
                    self.journal_decode_failed += 1
                self._journal.ack(rid)
                continue
            entry.jid = rid
            with self._lock:
                self.accepted_payloads += 1
                self.journal_recovered += 1
                self._spill_locked(entry)
            recovered += 1
        if recovered:
            log.info("sink %s: recovered %d journaled payload(s) into "
                     "spill", self.sink_name, recovered)
        return recovered

    def mint_key(self) -> str:
        """Idempotency key for one outbound payload (``sender:id``).

        With a journal attached, ids come from the journal's durably
        reserved sequence (utils/journal.mint_id) and the sender token
        lives in the journal directory — so a payload journaled with its
        ``Idempotency-Key`` header and replayed after a crash re-POSTs
        under the SAME key, and a receiver that remembers keys can 2xx
        the replay without double-counting. Without a journal the sender
        token is process-unique (a restart is a new sender — RAM spill
        died with the process, so nothing can replay anyway)."""
        with self._lock:
            journal = self._journal
            if self._mint_sender is None:
                if journal is not None:
                    from veneur_tpu_torch.utils.journal import sender_token

                    self._mint_sender = sender_token(journal.directory)
                else:
                    import os

                    self._mint_sender = os.urandom(8).hex()
            if journal is not None:
                return f"{self._mint_sender}:{journal.mint_id()}"
            self._mint_next += 1
            return f"{self._mint_sender}:{self._mint_next}"

    def _journal_ack_locked(self, entry: "_SpillEntry") -> None:
        """Terminal outcome for a journaled entry (caller holds _lock)."""
        if self._journal is not None and entry.jid is not None:
            self._journal.ack(entry.jid)
            entry.jid = None

    # -- flush-edge hooks ---------------------------------------------------

    def begin_flush(self, deadline_s: Optional[float] = None) -> None:
        """Arm this flush's delivery deadline and advance the breaker
        interval (an open breaker gets its single half-open probe).
        Sinks call this once at the top of their flush funnel."""
        with self._lock:
            self._deadline = self._time() + (
                self.policy.deadline_s if deadline_s is None
                else float(deadline_s))
            self.breaker.begin_interval()
            if self._journal is not None:
                # the "interval" fsync-policy edge: whatever spilled
                # since the last flush becomes durable now
                self._journal.sync()

    def retry_spill(self) -> int:
        """Re-deliver spilled payloads AHEAD of fresh data; returns how
        many reached the wire. Skipped outright when the breaker can't
        admit anything — the spill stays put instead of churning."""
        with self._lock:
            if not len(self.spill) or not self.breaker.can_attempt():
                return 0
            entries = self.spill.pop_all()
        delivered = 0
        for e in entries:
            if self._deliver_entry(e) == "delivered":
                delivered += 1
        return delivered

    def drain_spill(self) -> list[_SpillEntry]:
        """Hand every spilled payload back to the caller for re-routing
        (the ring-reshard handoff: the proxy drains each destination's
        spill and re-places the fragments under the CURRENT ring).
        Popped entries count as handed_off — they leave this manager's
        conservation ledger and are re-accepted wherever the caller
        re-delivers them, so the tier-wide sum stays exact."""
        with self._lock:
            entries = self.spill.pop_all()
            self.handed_off_payloads += len(entries)
        return entries

    # -- the payload path ---------------------------------------------------

    def deliver(self, send: Callable[[float], None], nbytes: int,
                payload: object = None, tenant: str = "") -> str:
        """Drive one fresh serialized payload; see class docstring for
        the outcome contract. `send(timeout_s)` performs exactly one
        network attempt and raises on failure. `payload` is opaque
        caller context that travels with the entry into the spill (see
        _SpillEntry.payload); `tenant` names the owning tenant when the
        caller knows it (tenant-aware spill eviction)."""
        with self._lock:
            self.accepted_payloads += 1
        return self._deliver_entry(
            _SpillEntry(send, int(nbytes), payload, tenant))

    def defer(self, send: Callable[[float], None], nbytes: int,
              payload: object = None, tenant: str = "") -> str:
        """Accept a payload straight into the spill without a network
        attempt — the proxy's bounded-handoff path when the reshard
        window runs out before a drained fragment could be re-sent.
        Returns "deferred" or "dropped" (self-evicted by the caps)."""
        with self._lock:
            self.accepted_payloads += 1
            return self._spill_locked(
                _SpillEntry(send, int(nbytes), payload, tenant))

    def _deliver_entry(self, entry: _SpillEntry) -> str:
        with self._lock:
            if not self.breaker.allow():
                self.breaker_short_circuits += 1
                return self._spill_locked(entry)
            # the deadline armed by begin_flush, if still live; a
            # standalone delivery (events posted outside the flush
            # funnel) gets a fresh full budget without disturbing it
            now = self._time()
            deadline = self._deadline
            if deadline is None or deadline <= now:
                deadline = now + self.policy.deadline_s
        attempt = 0
        while True:
            now = self._time()
            remaining = deadline - now
            if remaining <= 0:
                with self._lock:
                    self.deadline_clipped += 1
                    return self._spill_locked(entry)
            try:
                entry.send(min(self.policy.timeout_s, remaining))
            except Exception as e:  # noqa: BLE001 — classified below
                transient = retryable(e)
                with self._lock:
                    self.breaker.record_failure()
                    if not transient:
                        self.dropped_payloads += 1
                        self.dropped_bytes += entry.nbytes
                        self._journal_ack_locked(entry)
                        log.warning(
                            "sink %s: permanent delivery failure, payload "
                            "dropped (%d bytes): %s", self.sink_name,
                            entry.nbytes, e)
                        return "dropped"
                    if (attempt >= self.policy.retry_max
                            or not self.breaker.can_attempt()):
                        return self._spill_locked(entry)
                # full jitter: U[0, min(max, base * 2^attempt)]
                delay = self._rng.uniform(0.0, min(
                    self.policy.backoff_max_s,
                    self.policy.backoff_base_s * (2 ** attempt)))
                if self._time() + delay >= deadline:
                    with self._lock:
                        self.deadline_clipped += 1
                        return self._spill_locked(entry)
                attempt += 1
                with self._lock:
                    self.retries += 1
                if delay > 0:
                    self._sleep(delay)
            else:
                with self._lock:
                    self.breaker.record_success()
                    self.delivered_payloads += 1
                    self._journal_ack_locked(entry)
                return "delivered"

    def _spill_locked(self, entry: _SpillEntry) -> str:
        """Queue a payload for the next interval (caller holds _lock);
        evictions — including the entry itself when the caps are 0 —
        are declared dropped."""
        self.deferred_payloads += 1
        dropped_self = False
        abusive: frozenset = frozenset()
        if self.abusive_tenants is not None:
            try:
                abusive = self.abusive_tenants()
            except Exception:  # noqa: BLE001
                log.exception("sink %s: abusive-tenant probe failed",
                              self.sink_name)
        for old in self.spill.push(entry, abusive):
            self.dropped_payloads += 1
            self.dropped_bytes += old.nbytes
            self._journal_ack_locked(old)  # eviction is terminal
            if old is entry:
                dropped_self = True
            elif self._evict_cb is not None:
                try:
                    self._evict_cb(old.payload)
                except Exception:  # noqa: BLE001
                    log.exception("sink %s: evict callback failed",
                                  self.sink_name)
        if dropped_self:
            # never made it into the spill: the deferral became a drop
            return "dropped"
        if (self._journal is not None and entry.jid is None
                and self._journal_encode is not None):
            # write-ahead shadow for the payload now parked in RAM; a
            # re-spilled or recovered entry already has its record
            blob = None
            try:
                blob = self._journal_encode(entry)
            except Exception:  # noqa: BLE001
                log.exception("sink %s: journal encode failed",
                              self.sink_name)
            if blob is not None:
                entry.jid = self._journal.append(blob)
                if entry.jid is not None:
                    self.journal_appended += 1
                else:
                    self.journal_append_failed += 1
        return "deferred"

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Cumulative counters + point-in-time breaker/spill state; the
        canonical delivery.* names (sinks/__init__.py
        DELIVERY_STAT_COUNTERS) every sink shares."""
        with self._lock:
            return {
                "accepted_payloads": self.accepted_payloads,
                "delivered_payloads": self.delivered_payloads,
                "dropped_payloads": self.dropped_payloads,
                "dropped_bytes": self.dropped_bytes,
                "retries": self.retries,
                "deferred_payloads": self.deferred_payloads,
                "deadline_clipped": self.deadline_clipped,
                "breaker_short_circuits": self.breaker_short_circuits,
                "handed_off_payloads": self.handed_off_payloads,
                "breaker_opened_total": self.breaker.opened_total,
                "circuit_state": self.breaker.state,
                "circuit_state_code": STATE_CODES[self.breaker.state],
                "breaker_transitions": list(self.breaker.transitions),
                "spilled_payloads": len(self.spill),
                "spilled_bytes": self.spill.bytes,
                "journal_appended": self.journal_appended,
                "journal_append_failed": self.journal_append_failed,
                "journal_recovered": self.journal_recovered,
                "journal_decode_failed": self.journal_decode_failed,
                "journal_pending": (self._journal.pending_records()
                                    if self._journal is not None else 0),
            }

    def conserved(self) -> bool:
        """The exact-conservation invariant (see module docstring).
        Handed-off payloads (drain_spill) left this ledger for another
        manager's — they are accounted as such, keeping the per-manager
        sum exact even across ring-reshard re-routing."""
        with self._lock:
            return (self.accepted_payloads
                    == self.delivered_payloads + self.dropped_payloads
                    + self.handed_off_payloads + len(self.spill))


def make_manager(name: str, delivery) -> DeliveryManager:
    """Sink-ctor helper: accept a DeliveryPolicy (factory path), a
    ready DeliveryManager (tests inject clocks/RNGs), or None."""
    if isinstance(delivery, DeliveryManager):
        return delivery
    return DeliveryManager(name, delivery)
