"""The watchdog-vs-shedding contract.

The reference's flush watchdog is absolute: no flush completion within
`flush_watchdog_missed_flushes x interval` kills the process
(server.go:948-990). Combined with bounded-degradation chunked
extraction that rule is self-defeating — a CPU host legitimately
grinding through a 40s chunked flush at high cardinality would be
killed mid-progress, and the restart would re-pay pool growth and XLA
compiles only to hit the same wall (OVERLOAD_SOAK.json measured a
22.1s max flush that the reference's watchdog at 2 intervals would
have tripped on).

The documented contract, implemented by `watchdog_should_defer`:

1. A flush that exceeds the watchdog budget WHILE CHUNKS ARE COMPLETING
   defers the panic. Completing chunks are proof the flush is draining
   at the rate the hardware allows; killing it would lose the interval
   AND the progress. Overload control is the shedding layer's job
   (Server._adapt_spill_caps halves the C++ spill caps when a flush
   overruns 90% of the interval) — the watchdog is for WEDGED flushes,
   not slow ones.
2. A STALLED chunk does not defer. If no progress beat lands within the
   stall window — max(interval, STALL_MULTIPLIER x chunk target) — the
   flush is presumed wedged (deadlocked readback, hung device) and the
   watchdog panics exactly as the reference would.
3. With no flush in flight, the deferral never applies: a silent flush
   loop (died ticker thread, scheduling wedge) panics on the reference
   schedule.

The stall window's floor is one interval so an UNCHUNKED deployment
(flush_chunk_target_ms: 0, the TPU default) keeps the reference
contract unchanged: its only beats are flush begin/end, so any flush
overdue past the watchdog budget with more than an interval of silence
panics just as before.
"""

from __future__ import annotations

# A chunk this many targets late is stalled, not slow: the governor
# sizes chunks to ~1 target and at most doubles, so a healthy chunk
# can't legitimately take 4x its prediction plus an interval's slack.
STALL_MULTIPLIER = 4

# Stage-parallel flush backpressure (core/pipeline.py): each stage
# queue holds at most this many intervals beyond the one the stage is
# working on. The bound is deliberately one, not a tunable depth — the
# pipeline's whole point is overlap, not buffering. A stage more than
# one interval behind means the host cannot keep cadence at this
# cardinality, and the correct response is the shedding layer
# (_adapt_spill_caps halving the C++ spill caps / the governor's chunk
# ladder), not a growing queue that converts overload into unbounded
# memory and staleness.
MAX_STAGE_BACKLOG = 1


# Delivery-behind gating (core/server.py delivery reporting): a sink
# whose circuit breaker is not closed, or that deferred payloads to its
# spill, for this many CONSECUTIVE flush intervals counts the backend
# as behind and feeds the pipeline's downstream-behind shed signal. One
# interval is deliberately not enough — a single transient 503 ends as
# a successful retry, and shedding ingest for it would trade data the
# backend will take for data it never sees (the same ≥2-consecutive
# gating the pipeline applies to deferred ticks).
DELIVERY_BEHIND_INTERVALS = 2


def delivery_should_signal_behind(
        consecutive_behind: int,
        threshold: int = DELIVERY_BEHIND_INTERVALS) -> bool:
    """True once a sink's delivery has been behind (open/half-open
    breaker or fresh spill deferrals) for `threshold` consecutive flush
    intervals — the gate between per-sink delivery stats and the
    pipeline's downstream-behind overload response."""
    return consecutive_behind >= max(1, int(threshold))


# Proxy routing-executor backpressure (distributed/proxy.py
# RoutingPool): unlike the flush pipeline's one-interval bound, the
# proxy queue holds whole forwarded batches from MANY upstream locals,
# so the bound is a count of batches, not intervals. Past it the proxy
# sheds the incoming batch with honest per-metric drop counters — the
# alternative (the earlier behaviour) was an unbounded daemon thread
# per batch, which converts a slow global tier into proxy memory growth
# and thread exhaustion instead of a visible, bounded drop signal.
ROUTING_QUEUE_MAX = 128


def routing_should_shed(queue_depth: int,
                        queue_max: int = ROUTING_QUEUE_MAX) -> bool:
    """The proxy routing executor's shed rule: refuse a batch once the
    bounded routing queue is full. Centralised beside the pipeline shed
    gate so both backpressure policies read as one contract."""
    return queue_depth >= max(1, int(queue_max))


def pipeline_should_shed(queue_depth: int,
                         max_backlog: int = MAX_STAGE_BACKLOG) -> bool:
    """The backpressure contract for the stage-parallel flush executor:
    shed (drop the oldest pending interval and signal overload) instead
    of enqueueing once a stage already has `max_backlog` intervals
    waiting. Centralised here so the watchdog-vs-shedding contract
    above and the pipeline's shed rule are documented as one policy."""
    return queue_depth >= max(1, int(max_backlog))


# Tenant-aware shed ordering (per-tenant QoS, core/tenancy.py): when the
# worker's swap-time spill shed must drop samples to hold the fold
# budget, samples belonging to an OVER-BUDGET tenant go first — the
# tenant already exceeding its series budget is, by construction, the
# one converting overload into everyone else's flush latency. Within a
# class (abusive / innocent) the newest samples are kept, matching the
# blanket shed's freshest-values-win rule, so a run with no over-budget
# tenant reduces bitwise to the old `a[-budget:]` slice.


def shed_spill_keep(is_abusive, budget: int):
    """Indices (ascending, length min(budget, n)) of the spill samples to
    KEEP: newest innocents first, then newest abusive samples only if
    innocents alone can't fill the budget. `is_abusive` is a bool array
    over the spill batch in arrival order. Pure numpy, deterministic."""
    import numpy as np

    flags = np.asarray(is_abusive, dtype=bool)
    n = len(flags)
    budget = max(0, int(budget))
    if n <= budget:
        return np.arange(n, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    innocents = idx[~flags]
    if len(innocents) >= budget:
        return innocents[len(innocents) - budget:]
    abusive = idx[flags]
    keep = np.concatenate(
        [innocents, abusive[len(abusive) - (budget - len(innocents)):]])
    keep.sort()
    return keep


def stall_window_s(interval_s: float, chunk_target_s: float) -> float:
    """Maximum progress-beat age that still counts as a live flush."""
    return max(float(interval_s), STALL_MULTIPLIER * float(chunk_target_s))


def watchdog_should_defer(now_unix: float, governor,
                          interval_s: float) -> tuple[bool, str]:
    """Decide whether an overdue flush defers the watchdog panic.

    Returns (defer, reason); the reason string is logged either way so
    the postmortem of a panic (or of a long deferral) is self-reading.
    """
    prog = governor.progress()
    # Device fault verdict (ops/device_guard taxonomy): when the guard
    # classified a device error this process lifetime, every watchdog
    # decision — deferral or panic — names it. A flush that wedges right
    # after an XLA OOM or a lost device is a DEVICE postmortem; a panic
    # log that only says "stalled" sends the operator to the scheduler.
    fault = prog.get("last_device_fault")
    verdict = f"; last device fault [{fault}]" if fault else ""
    if not prog["in_flight"]:
        return False, "no flush in flight" + verdict
    window = stall_window_s(interval_s, governor.chunk_target_s)
    age = now_unix - prog["last_beat_unix"]
    if age < window:
        return True, (
            f"flush in flight with progress {age:.1f}s ago "
            f"({prog['chunks_done']} chunks done; stall window "
            f"{window:.1f}s)" + verdict)
    return False, (
        f"flush in flight but stalled: last progress {age:.1f}s ago "
        f"(>= {window:.1f}s stall window, "
        f"{prog['chunks_done']} chunks done)" + verdict)


# -- elastic-tier autoscale policy -------------------------------------------

# consecutive pressured (resp. calm) observation intervals before the
# controller scales out (resp. in) — the hysteresis deadband
ELASTIC_HYSTERESIS_INTERVALS = 3

# a routing queue holding this many batches at observation time counts
# as pressure even when nothing shed yet (depth is the leading signal,
# sheds the lagging one)
ELASTIC_QUEUE_PRESSURE_DEPTH = 2


def elastic_pressure_reasons(signals: dict) -> list[str]:
    """Classify one observation interval of tier signals into pressure
    reasons ([] == calm). The signals are deltas/gauges the system
    already emits (ProxyPressureSource assembles them):

    - routing_shed_delta: batches shed by the routing pool this interval
    - routing_queue_depth: routing queue occupancy right now
    - delivery_deferred_delta: payloads newly deferred to spill/retry
    - spilled_metrics: metrics currently parked in spill (a non-empty
      spill also blocks scale-in: re-homing a spilled fragment whose
      prior attempt may have landed is the remint-duplicate risk, so
      "calm" must mean "nothing parked")
    - delivery_behind / tenant_pressure: optional upstream booleans
    - admission_timeout_delta / window_stall_delta: proxy-TIER signals
      (ProxyTierPressureSource sums them fleet-wide): senders timing out
      at a proxy's admission gate, and stream frames stalling on a full
      in-flight window — both mean the fan-in tier itself is saturated,
      independent of whether anything shed yet
    """
    reasons = []
    if signals.get("routing_shed_delta", 0) > 0:
        reasons.append("routing_shed")
    if signals.get("admission_timeout_delta", 0) > 0:
        reasons.append("admission_timeout")
    if signals.get("window_stall_delta", 0) > 0:
        reasons.append("window_stall")
    if signals.get("routing_queue_depth", 0) >= ELASTIC_QUEUE_PRESSURE_DEPTH:
        reasons.append("routing_queue")
    if signals.get("delivery_deferred_delta", 0) > 0:
        reasons.append("delivery_deferred")
    if signals.get("spilled_metrics", 0) > 0:
        reasons.append("spill_nonempty")
    if signals.get("delivery_behind"):
        reasons.append("delivery_behind")
    if signals.get("tenant_pressure"):
        reasons.append("tenant_pressure")
    return reasons


def elastic_scale_decision(pressured_streak: int, calm_streak: int,
                           members: int, *, k: int,
                           min_members: int = 1,
                           max_members: int = 0) -> Optional[str]:
    """Hysteresis decision: "out" after >= k consecutive pressured
    intervals (capped by max_members unless 0 == uncapped), "in" after
    >= k consecutive calm intervals (floored at min_members), else None.
    Oscillation inside the deadband resets both streaks upstream, so it
    can never reach k — zero membership changes by construction."""
    if pressured_streak >= k:
        if max_members and members >= max_members:
            return None
        return "out"
    if calm_streak >= k and members > min_members:
        return "in"
    return None
