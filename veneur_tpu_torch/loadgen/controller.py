"""Closed-loop sustained-rate controller for the full ingest pipeline.

Drives a live in-process Server of the port (on the card unless the
caller asks for the CPU) through its REAL sockets with the C++ paced
sender (zero Python per packet), measures accepted-sample
throughput and flush cadence per flush interval via Server.ingress_stats
(cumulative counters — loss over a window is a subtraction of two
snapshots), and searches for the maximum offered rate the pipeline holds
without loss or cadence collapse: multiplicative growth to bracket the
cliff, then bisection inside the bracket, then a long confirmation run
(≥10 flush intervals) at the found rate. The confirmation run's
*accepted* rate — not the offered rate — is what the result reports as
sustained_pipeline_lines_per_s: loss shows up as the gap between them,
never as an inflated headline.

Loss here is end-to-end: kernel rcvbuf drops (invisible to the server)
and overload sheds (counted) both surface as sent-vs-accepted gap.
"""

from __future__ import annotations

import logging
import socket
import time
from typing import Optional

from veneur_tpu_torch import native
from veneur_tpu_torch.loadgen.spec import WorkloadSpec

log = logging.getLogger("veneur_tpu_torch.loadgen")

# the north star: 50M samples/s per device; cores_needed is the
# reader-core budget to feed it at the measured sustained rate
NORTH_STAR_LINES_PER_S = 50e6

# At most this many leading cadence misses of a trial may be classed as
# warmup. One is the honest number: a trial's first interval is where a
# first-use cost lands (a kernel's or the native library's build, the
# caching allocator's first growth into a new rate tier's pow2 shapes),
# and a SECOND straggler is a pipeline problem, not a first use.
WARMUP_GRACE_INTERVALS = 1


def classify_warmup(intervals: list[dict],
                    grace: int = WARMUP_GRACE_INTERVALS) -> dict:
    """Split a trial's interval records into warmup vs steady state.

    A leading interval that missed cadence is warmup — the flush that
    closed it paid a first-use cost (a kernel build, the caching
    allocator's first growth), which is a property of the trial
    boundary, not of the pipeline. At
    most `grace` intervals qualify, they must be a prefix, and an
    interval that made cadence is never reclassified. Mutates each
    record with a "warmup" bool and returns the steady-state view:

        warmup_intervals    how many leading records were excluded
        cadence_frac_steady misses / steady count (1.0 when no steady
                            records exist — an all-warmup trial judges
                            nothing)
        <m>_steady          mean over steady records for each of
                            tick_block_ms, ingest_stall_ms, flush_ms,
                            drain_ms

    Pure beyond the "warmup" stamp: no controller state, no clocks —
    unit-testable against synthetic interval lists.
    """
    n_warm = 0
    for rec in intervals:
        if n_warm >= grace or rec.get("cadence_ok", False):
            break
        n_warm += 1
    for k, rec in enumerate(intervals):
        rec["warmup"] = k < n_warm
    steady = intervals[n_warm:]
    n = len(steady)
    out = {
        "warmup_intervals": n_warm,
        "cadence_frac_steady": round(
            sum(1 for i in steady if i["cadence_ok"]) / n, 4)
        if n else 1.0,
    }
    for m in ("tick_block_ms", "ingest_stall_ms", "flush_ms", "drain_ms"):
        out[m + "_steady"] = round(
            sum(i.get(m, 0.0) for i in steady) / n, 2) if n else 0.0
    return out


class LoadHarness:
    """A running Server plus a connected send socket and a prebuilt
    ring. Owns both ends; close() tears everything down."""

    def __init__(self, cfg, spec: Optional[WorkloadSpec] = None,
                 transport: str = "udp",
                 ring: Optional["native.LoadgenRing"] = None,
                 sink_mode: str = "channel",
                 ssf_frac: float = 0.0,
                 ssf_spans: int = 2000,
                 device=None) -> None:
        from veneur_tpu_torch.core.server import Server

        self.spec = spec or WorkloadSpec.from_config(cfg)
        self.transport = transport
        self.interval = cfg.interval_seconds()
        self.ring = ring if ring is not None else self.spec.build_ring()
        # mixed statsd+SSF workload: a second paced sender offers SSF
        # span datagrams at rate*ssf_frac against a real SSF listener;
        # egress goes through a serialize-only SpanBatchSink (full VSB1
        # encode + delivery manager, zero network variance)
        self.ssf_frac = ssf_frac
        self.ssf_ring = None
        self.span_sink = None
        self._ssf_sock: Optional[socket.socket] = None
        self._ssf_sender: Optional["native.LoadgenSender"] = None
        span_sinks: list = []
        if ssf_frac > 0:
            from veneur_tpu_torch.sinks.delivery import DeliveryPolicy
            from veneur_tpu_torch.spans import DiscardWriter, SpanBatchSink

            if not cfg.ssf_listen_addresses:
                cfg.ssf_listen_addresses = ["udp://127.0.0.1:0"]
            self._ssf_specs = list(cfg.ssf_listen_addresses)
            self.span_sink = SpanBatchSink(
                DiscardWriter(), name="loadgen_discard",
                delivery=DeliveryPolicy.from_config(cfg, self.interval),
                batch_rows=cfg.span_batch_rows,
                pending_cap=cfg.span_pending_cap)
            span_sinks = [self.span_sink]
            self.ssf_ring = self.spec.build_ssf_ring(ssf_spans)
        if sink_mode == "serialize":
            # a real serializing sink: the datadog formatter builds the
            # full chunked JSON series bodies (deflate included) against
            # a discarding opener, so the emit stage pays its production
            # serialization cost with zero network. The channel sink
            # never serializes, so it can't see the native emit tier.
            from veneur_tpu_torch.sinks.datadog import DatadogMetricSink

            self.sink = DatadogMetricSink(
                interval=self.interval, flush_max_per_body=25000,
                hostname="loadgen", tags=["veneur:loadgen"],
                dd_hostname="http://invalid.localdomain", api_key="x",
                opener=lambda req, timeout: b"")
        elif sink_mode == "channel":
            from veneur_tpu_torch.sinks.channel import ChannelMetricSink

            self.sink = ChannelMetricSink()
        else:
            raise ValueError("sink_mode must be channel or serialize")
        # flush archival rides the measured flush path when configured:
        # the real MetricArchiveSink (native VMB1 serialize + segmented
        # append behind the delivery manager) alongside the measurement
        # sink, so a run prices exactly what production would pay
        self.archive_sink = None
        metric_sinks = [self.sink]
        if cfg.archive_dir:
            from veneur_tpu_torch.archive import (MetricArchiveSink,
                                                  SegmentedArchiveWriter)
            from veneur_tpu_torch.sinks.delivery import DeliveryPolicy

            self.archive_sink = MetricArchiveSink(
                SegmentedArchiveWriter(
                    cfg.archive_dir,
                    max_segment_bytes=cfg.archive_max_bytes,
                    max_segments=cfg.archive_max_segments),
                hostname="loadgen",
                delivery=DeliveryPolicy.from_config(cfg, self.interval))
            metric_sinks.append(self.archive_sink)
        self.server = Server(cfg, metric_sinks=metric_sinks,
                             device=device, span_sinks=span_sinks)
        ports = self.server.start()
        self._sock = self._connect(ports)
        if ssf_frac > 0:
            self._ssf_sock = self._connect_ssf(ports)
        self.flushed_series = 0
        self._sender: Optional["native.LoadgenSender"] = None

    def _connect(self, ports: dict) -> socket.socket:
        if self.transport == "udp":
            spec_port = [(s, p) for s, p in ports.items()
                         if s.startswith("udp://")]
            if not spec_port:
                raise RuntimeError("no udp listener in %s" % ports)
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
            s.connect(("127.0.0.1", spec_port[0][1]))
            return s
        if self.transport == "tcp":
            spec_port = [(s, p) for s, p in ports.items()
                         if s.startswith("tcp://")]
            if not spec_port:
                raise RuntimeError("no tcp listener in %s" % ports)
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.connect(("127.0.0.1", spec_port[0][1]))
            return s
        if self.transport == "unixgram":
            # start() reports ports only: a path-based listener is named
            # by the configuration alone
            spec_port = [s for s in self.server.config.statsd_listen_addresses
                         if s.startswith("unixgram://")]
            if not spec_port:
                raise RuntimeError("no unixgram listener in %s" % ports)
            s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            s.connect(spec_port[0][len("unixgram://"):])
            return s
        raise ValueError("transport must be udp, tcp or unixgram")

    def _connect_ssf(self, ports: dict) -> socket.socket:
        # server.start() prefixes the SSF port with "ssf:" only when its
        # spec collides with a statsd listener's
        cand = [(s, p) for s, p in ports.items()
                if s.startswith("ssf:udp://")]
        if not cand:
            cand = [(s, p) for s, p in ports.items()
                    if s.startswith("udp://") and s in self._ssf_specs]
        if not cand:
            raise RuntimeError("no ssf udp listener in %s" % ports)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 1 << 22)
        s.connect(("127.0.0.1", cand[0][1]))
        return s

    def warmup(self, rate: float = 100_000.0,
               timeout: float = 300.0) -> bool:
        """Prime the pipeline before measuring. Two effects must
        settle, both of which show up as first-use costs (kernel and
        native builds, the caching allocator's growth) billed to
        whatever interval they land in: (1) directory growth — each new
        series re-buckets the pow2-padded pool shapes, so the FULL
        series set must exist up front (the ring is finite; sending it
        fully twice rides out any rcvbuf drop); (2) the load-path
        shapes — staged planes, spill-fold chunks — which only appear
        while traffic is flowing, so the stabilization wait runs UNDER
        continuous load at a representative rate, until three
        consecutive flushes land on cadence. The shape space is
        pow2-bucketed, so this converges."""
        sender = native.LoadgenSender(
            self.ring, self._sock.fileno(), rate,
            stream=(self.transport == "tcp"))
        deadline = time.time() + timeout
        sent_all = 2 * self.ring.total_lines
        good = 0
        last = self.server.flush_count
        t_last = time.time()
        try:
            while time.time() < deadline and good < 3:
                time.sleep(0.05)
                fc = self.server.flush_count
                if fc > last:
                    dt = time.time() - t_last
                    on_time = (dt <= self.interval * 1.5
                               and sender.sent_lines >= sent_all)
                    good = good + 1 if on_time else 0
                    last, t_last = fc, time.time()
                self._drain_sink()
        finally:
            sender.stop()
        self._drain_sink()
        return good >= 3

    # -- measurement ---------------------------------------------------------

    def snapshot(self) -> dict:
        snap = self.server.ingress_stats()
        snap["t"] = time.time()
        sender = self._sender
        snap["sent_lines"] = sender.sent_lines if sender else 0
        snap["sent_packets"] = sender.sent_packets if sender else 0
        snap["send_errors"] = sender.send_errors if sender else 0
        ssf_sender = self._ssf_sender
        snap["ssf_sent_spans"] = (ssf_sender.sent_lines
                                  if ssf_sender else 0)
        arch = self.archive_sink
        if arch is not None:
            snap["archive"] = {
                "frames": arch.frames_encoded,
                "bytes": arch.bytes_encoded,
                "samples": arch.metrics_flushed,
                "dropped": arch.metrics_dropped,
                "deferred": arch.metrics_deferred,
            }
        return snap

    def _drain_sink(self) -> None:
        # keep the channel sink bounded over long runs; tally series so
        # the artifact can show the flush path really emitted
        if not hasattr(self.sink, "queue"):
            # serializing sinks tally their own emitted series
            self.flushed_series = getattr(self.sink, "flushed_metrics", 0)
            return
        while not self.sink.queue.empty():
            self.flushed_series += len(self.sink.queue.get_nowait())
        while not self.sink.other_samples.empty():
            self.sink.other_samples.get_nowait()

    def run_intervals(self, rate: float, n_intervals: int,
                      settle: bool = True) -> dict:
        """Send at `rate` lines/s while `n_intervals` flushes complete;
        returns the trial record (per-interval stats + aggregates).

        The first flush boundary after the sender starts opens the
        measurement window, so a partial interval never dilutes the
        per-interval numbers. A hard deadline of 3x the nominal span
        bounds a wedged flush loop; hitting it fails the trial
        (cadence_ok False on the missing intervals)."""
        self._drain_sink()
        self._sender = native.LoadgenSender(
            self.ring, self._sock.fileno(), rate,
            stream=(self.transport == "tcp"))
        if self.ssf_frac > 0:
            self._ssf_sender = native.LoadgenSender(
                self.ssf_ring, self._ssf_sock.fileno(),
                max(1.0, rate * self.ssf_frac), stream=False)
        intervals = []
        try:
            if settle:
                self._await_flush(self.snapshot()["flush_count"])
            prev = self.snapshot()
            hard_deadline = (time.time()
                             + 3.0 * self.interval * n_intervals
                             + 5.0)
            for _ in range(n_intervals):
                ok = self._await_flush(prev["flush_count"],
                                       deadline=hard_deadline)
                snap = self.snapshot()
                dt = snap["t"] - prev["t"]
                sent = snap["sent_lines"] - prev["sent_lines"]
                acc = (snap["samples_processed"]
                       - prev["samples_processed"])
                shed = (snap["overload_dropped"]
                        - prev["overload_dropped"])
                # cadence decomposition: how long the tick held the
                # ticker thread (the whole serial flush; just the
                # swap+enqueue when pipelined), how long ingest was
                # stalled under the worker locks (the swap phase), and
                # the total flush work of the last COMPLETED flush —
                # on a 1-core rig the gap between tick_block_ms and
                # flush_ms is exactly what the stage pipeline buys
                flush_phases = snap.get("last_flush_phases") or {}
                intervals.append({
                    "duration_s": round(dt, 4),
                    "flushes": snap["flush_count"] - prev["flush_count"],
                    "sent_lines": sent,
                    "accepted_lines": acc,
                    "shed_lines": shed,
                    "accepted_lines_per_s": round(acc / dt, 1) if dt > 0
                    else 0.0,
                    "loss_frac": round(max(0.0, 1.0 - acc / sent), 5)
                    if sent > 0 else 0.0,
                    "cadence_ok": bool(ok and dt <= self.interval * 1.5),
                    "tick_block_ms": round(
                        snap.get("last_tick_s", 0.0) * 1e3, 2),
                    "ingest_stall_ms": round(
                        flush_phases.get("swap_s", 0.0) * 1e3, 2),
                    "flush_ms": round(
                        sum(flush_phases.values()) * 1e3, 2),
                    # always-hot flush: micro-folds that ran during this
                    # window (lifetime-counter delta, so folds landing
                    # near the flush boundary are never lost) and the
                    # swap-time residual drain + mirror handoff
                    "micro_folds": (snap.get("micro_folds_total", 0)
                                    - prev.get("micro_folds_total", 0)),
                    "drain_ms": round(
                        flush_phases.get("drain_s", 0.0) * 1e3, 2),
                    # the emit stage's two phases: columnar
                    # batch assembly and sink serialization+emission
                    "generate_ms": round(
                        flush_phases.get("generate_s", 0.0) * 1e3, 2),
                    "emit_ms": round(
                        flush_phases.get("sink_flush_s", 0.0) * 1e3, 2),
                })
                rs_now = snap.get("reader_shards")
                if rs_now:
                    # shared-nothing ingest: per-context committed/
                    # dropped deltas for this window (index 0 = home
                    # context, 1.. = reader shards) — the reader-balance
                    # evidence of a --readers run
                    rs_prev = (prev.get("reader_shards") or
                               {"committed": [], "dropped": []})

                    def _deltas(key):
                        now = rs_now.get(key) or []
                        before = rs_prev.get(key) or []
                        before = before + [0] * (len(now) - len(before))
                        return [int(a - b) for a, b in zip(now, before)]

                    intervals[-1]["per_reader"] = {
                        "committed": _deltas("committed"),
                        "dropped": _deltas("dropped"),
                    }
                if self.archive_sink is not None:
                    # per-interval archive egress deltas: the evidence
                    # that archival kept pace with the flush cadence,
                    # and at what byte cost
                    a_now = snap.get("archive") or {}
                    a_prev = prev.get("archive") or {}
                    intervals[-1].update({
                        "archive_frames": (a_now.get("frames", 0)
                                           - a_prev.get("frames", 0)),
                        "archive_bytes": (a_now.get("bytes", 0)
                                          - a_prev.get("bytes", 0)),
                        "archive_samples": (a_now.get("samples", 0)
                                            - a_prev.get("samples", 0)),
                    })
                if self.ssf_frac > 0:
                    sp_now = snap.get("spans") or {}
                    sp_prev = prev.get("spans") or {}
                    intervals[-1].update({
                        "spans_sent": (snap["ssf_sent_spans"]
                                       - prev["ssf_sent_spans"]),
                        "spans_received": (sp_now.get("received", 0)
                                           - sp_prev.get("received", 0)),
                        "spans_derived": (sp_now.get("derived", 0)
                                          - sp_prev.get("derived", 0)),
                        "spans_dropped": (sp_now.get("dropped", 0)
                                          - sp_prev.get("dropped", 0)),
                        "span_metric_rows": (
                            sp_now.get("derived_rows", 0)
                            - sp_prev.get("derived_rows", 0)),
                    })
                prev = snap
                self._drain_sink()
                if not ok:
                    break
        finally:
            self._sender.stop()
            self._sender = None
            if self._ssf_sender is not None:
                self._ssf_sender.stop()
                self._ssf_sender = None
        total_sent = sum(i["sent_lines"] for i in intervals)
        total_acc = sum(i["accepted_lines"] for i in intervals)
        total_dt = sum(i["duration_s"] for i in intervals)
        n_ok = sum(1 for i in intervals if i["cadence_ok"])
        n_iv = max(1, len(intervals))
        pipeline_stats = self.server.ingress_stats().get("pipeline")
        # warmup vs steady state: a first-interval cadence miss from a
        # first-use cost (a kernel build, the allocator's first growth)
        # is a trial-boundary artifact, not a pipeline failure. The
        # judged cadence_frac excludes warmup from BOTH numerator and
        # denominator (a trial of N intervals
        # with one warmup is judged on the other N-1, or on
        # n_intervals-1 when the run aborted early); the raw fraction
        # over all requested intervals stays in the record.
        steady = classify_warmup(intervals)
        n_warm = steady["warmup_intervals"]
        n_ok_steady = sum(1 for i in intervals
                          if i["cadence_ok"] and not i["warmup"])
        span_agg = {}
        if self.ssf_frac > 0:
            sp_sent = sum(i.get("spans_sent", 0) for i in intervals)
            sp_recv = sum(i.get("spans_received", 0) for i in intervals)
            span_agg = {
                "offered_spans_per_s": rate * self.ssf_frac,
                "total_spans_sent": sp_sent,
                "total_spans_received": sp_recv,
                "total_spans_derived": sum(
                    i.get("spans_derived", 0) for i in intervals),
                "total_spans_dropped": sum(
                    i.get("spans_dropped", 0) for i in intervals),
                "span_metric_rows": sum(
                    i.get("span_metric_rows", 0) for i in intervals),
                # sent-vs-received gap is UDP loss; received-vs-derived
                # is pipeline shed (counted) or pending carryover
                "span_loss_frac": round(
                    max(0.0, 1.0 - sp_recv / sp_sent), 5)
                if sp_sent > 0 else 0.0,
            }
        return {
            **span_agg,
            "tick_block_ms_mean": round(
                sum(i["tick_block_ms"] for i in intervals) / n_iv, 2),
            "ingest_stall_ms_mean": round(
                sum(i["ingest_stall_ms"] for i in intervals) / n_iv, 2),
            "flush_ms_mean": round(
                sum(i["flush_ms"] for i in intervals) / n_iv, 2),
            "generate_ms_mean": round(
                sum(i["generate_ms"] for i in intervals) / n_iv, 2),
            "emit_ms_mean": round(
                sum(i["emit_ms"] for i in intervals) / n_iv, 2),
            "drain_ms_mean": round(
                sum(i["drain_ms"] for i in intervals) / n_iv, 2),
            "micro_folds_total": sum(i["micro_folds"] for i in intervals),
            **({"archive_frames_total": sum(
                    i.get("archive_frames", 0) for i in intervals),
                "archive_bytes_total": sum(
                    i.get("archive_bytes", 0) for i in intervals),
                "archive_samples_total": sum(
                    i.get("archive_samples", 0) for i in intervals),
                "archive_bytes_per_interval_mean": round(sum(
                    i.get("archive_bytes", 0) for i in intervals) / n_iv)}
               if self.archive_sink is not None else {}),
            **steady,
            **({"pipeline": pipeline_stats} if pipeline_stats else {}),
            "offered_lines_per_s": rate,
            "intervals": intervals,
            "total_sent": total_sent,
            "total_accepted": total_acc,
            "total_shed": sum(i["shed_lines"] for i in intervals),
            "duration_s": round(total_dt, 3),
            "accepted_lines_per_s": round(total_acc / total_dt, 1)
            if total_dt > 0 else 0.0,
            "loss_frac": round(max(0.0, 1.0 - total_acc / total_sent), 5)
            if total_sent > 0 else 1.0,
            "cadence_frac": round(
                n_ok_steady / max(1, n_intervals - n_warm), 4),
            "cadence_frac_raw": round(n_ok / n_intervals, 4),
            "intervals_completed": len(intervals),
        }

    def _await_flush(self, since: int, deadline: float = 0.0) -> bool:
        """Block until flush_count exceeds `since` (poll at 20Hz).
        False when the deadline passes first — a collapsed cadence."""
        if deadline <= 0.0:
            deadline = time.time() + 3.0 * self.interval + 5.0
        while time.time() < deadline:
            if self.server.flush_count > since:
                return True
            time.sleep(0.05)
        return False

    def span_conservation(self) -> dict:
        """The server's span books, with the exactness bit: on the
        columnar path received == derived + dropped + pending holds at
        any quiescent instant (no sender running, flush not mid-tick)."""
        s = dict(self.server.ingress_stats().get("spans") or {})
        if s:
            s["balanced"] = (
                s["received"] == s["derived"] + s["dropped"] + s["pending"])
        return s

    def archive_stats(self) -> dict:
        """The archive sink's sample ledger plus its delivery manager's
        payload ledger — the run's conservation evidence."""
        a = self.archive_sink
        if a is None:
            return {}
        return {
            "frames_encoded": a.frames_encoded,
            "bytes_encoded": a.bytes_encoded,
            "metrics_flushed": a.metrics_flushed,
            "metrics_dropped": a.metrics_dropped,
            "metrics_deferred": a.metrics_deferred,
            "delivery": a.delivery.stats(),
            "conserved": a.delivery.conserved(),
        }

    def close(self) -> None:
        if self._sender is not None:
            self._sender.stop()
            self._sender = None
        if self._ssf_sender is not None:
            self._ssf_sender.stop()
            self._ssf_sender = None
        try:
            self.server.shutdown()
        finally:
            self._sock.close()
            if self._ssf_sock is not None:
                self._ssf_sock.close()


def trial_passes(trial: dict, n_intervals: int, max_loss: float,
                 min_cadence: float) -> bool:
    return (trial["intervals_completed"] == n_intervals
            and trial["loss_frac"] <= max_loss
            and trial["cadence_frac"] >= min_cadence)


def run_trial(harness: LoadHarness, rate: float, n_intervals: int,
              max_loss: float = 0.01,
              min_cadence: float = 0.75) -> dict:
    t = harness.run_intervals(rate, n_intervals)
    t["passed"] = trial_passes(t, n_intervals, max_loss, min_cadence)
    log.info("trial @ %.0f lines/s: accepted %.0f/s loss %.4f "
             "cadence %.2f -> %s", rate, t["accepted_lines_per_s"],
             t["loss_frac"], t["cadence_frac"],
             "pass" if t["passed"] else "FAIL")
    return t


def search_sustained(harness: LoadHarness, *,
                     start_rate: float = 50_000.0,
                     max_rate: float = 20e6,
                     growth: float = 1.6,
                     trial_intervals: int = 3,
                     confirm_intervals: int = 10,
                     bisect_steps: int = 4,
                     max_loss: float = 0.01,
                     min_cadence: float = 0.8,
                     trial_min_cadence: float = 0.6) -> dict:
    """Bracket-then-bisect rate search plus a long confirmation run.

    Growth phase multiplies the offered rate by `growth` until a short
    trial fails (or max_rate holds), bracketing the cliff; bisection
    narrows the bracket; the confirmation run re-validates the found
    rate across >= confirm_intervals flush intervals, backing off 10%
    per retry if the long run exposes what the short trials missed.
    Short bracketing trials use the laxer trial_min_cadence (one stray
    first-use stall must not end the growth phase); only the
    confirmation run applies min_cadence."""
    trials = []
    lo, hi = 0.0, 0.0
    rate = start_rate
    while rate <= max_rate:
        t = run_trial(harness, rate, trial_intervals, max_loss,
                      trial_min_cadence)
        trials.append(t)
        if t["passed"]:
            lo = rate
            rate *= growth
        else:
            hi = rate
            break
    if lo == 0.0:
        # even the floor rate failed: report the floor trial honestly
        hi = hi or start_rate
        lo = hi * 0.25
    if hi > 0.0:
        for _ in range(bisect_steps):
            mid = (lo + hi) / 2.0
            if mid <= lo * 1.05:  # bracket below resolution
                break
            t = run_trial(harness, mid, trial_intervals, max_loss,
                          trial_min_cadence)
            trials.append(t)
            if t["passed"]:
                lo = mid
            else:
                hi = mid
    # unrecorded warm pass at the found rate: this rate tier's
    # pow2-bucketed spill shapes may not have been allocated yet, and a
    # first-use growth inside the confirmation run would be reported as
    # a cadence failure of the pipeline
    run_trial(harness, lo, 2, max_loss, trial_min_cadence)
    # confirmation: the headline number comes from THIS run only
    confirm = None
    rate = lo
    for _ in range(3):
        confirm = run_trial(harness, rate, confirm_intervals, max_loss,
                            min_cadence)
        if confirm["passed"]:
            break
        rate *= 0.9
    return {
        "search_trials": trials,
        "confirm": confirm,
        "sustained_offered_lines_per_s": rate,
        "sustained_pipeline_lines_per_s":
            confirm["accepted_lines_per_s"] if confirm else 0.0,
        "confirmed": bool(confirm and confirm["passed"]),
    }


def result_artifact(spec: WorkloadSpec, harness: LoadHarness,
                    search: dict, platform: str) -> dict:
    """Assemble the sustained-pipeline result (schema
    sustained_pipeline_v1)."""
    measured = search["sustained_pipeline_lines_per_s"]
    confirm = search.get("confirm") or {}
    return {
        "schema": "sustained_pipeline_v1",
        "platform": platform,
        "transport": harness.transport,
        "flush_interval_s": harness.interval,
        "workload": spec.to_dict(),
        "ring_datagrams": len(harness.ring),
        "ring_lines": harness.ring.total_lines,
        "ring_bytes": harness.ring.total_bytes,
        "sustained_pipeline_lines_per_s": measured,
        "sustained_offered_lines_per_s":
            search["sustained_offered_lines_per_s"],
        "confirmed": search["confirmed"],
        "confirm_intervals": confirm.get("intervals", []),
        "loss_frac": confirm.get("loss_frac"),
        "shed_lines": confirm.get("total_shed"),
        "cadence_frac": confirm.get("cadence_frac"),
        "flushed_series": harness.flushed_series,
        # cadence decomposition of the confirmation run: how long the
        # tick held the ticker thread vs how long ingest stalled under
        # the worker locks vs the full flush work — on a 1-core rig
        # tick_block ≈ flush is the cadence-bound serial signature,
        # tick_block ≈ ingest_stall « flush is the pipelined one
        "tick_block_ms_mean": confirm.get("tick_block_ms_mean"),
        "ingest_stall_ms_mean": confirm.get("ingest_stall_ms_mean"),
        "flush_ms_mean": confirm.get("flush_ms_mean"),
        "generate_ms_mean": confirm.get("generate_ms_mean"),
        "emit_ms_mean": confirm.get("emit_ms_mean"),
        # steady-state decomposition (warmup excluded) plus the
        # always-hot flush accounting of the confirmation run
        "warmup_intervals": confirm.get("warmup_intervals"),
        "cadence_frac_raw": confirm.get("cadence_frac_raw"),
        "tick_block_ms_steady": confirm.get("tick_block_ms_steady"),
        "ingest_stall_ms_steady": confirm.get("ingest_stall_ms_steady"),
        "flush_ms_steady": confirm.get("flush_ms_steady"),
        "drain_ms_mean": confirm.get("drain_ms_mean"),
        "micro_folds_total": confirm.get("micro_folds_total"),
        **({"pipeline": confirm["pipeline"]}
           if confirm.get("pipeline") else {}),
        "search_trials": [
            {k: t.get(k) for k in ("offered_lines_per_s",
                                   "accepted_lines_per_s", "loss_frac",
                                   "cadence_frac", "cadence_frac_raw",
                                   "warmup_intervals", "passed",
                                   "tick_block_ms_mean",
                                   "ingest_stall_ms_mean", "flush_ms_mean",
                                   "tick_block_ms_steady",
                                   "ingest_stall_ms_steady",
                                   "generate_ms_mean", "emit_ms_mean",
                                   "drain_ms_mean", "micro_folds_total",
                                   "total_shed")}
            for t in search["search_trials"]],
        "north_star_lines_per_s": NORTH_STAR_LINES_PER_S,
        "cores_needed_for_north_star":
            round(NORTH_STAR_LINES_PER_S / measured, 2)
            if measured > 0 else None,
        # mixed statsd+SSF runs: the confirmation run's span-side
        # aggregates plus the final conservation check (exact on the
        # columnar path: received == derived + dropped + pending)
        **({"spans": {
            k: confirm.get(k)
            for k in ("offered_spans_per_s", "total_spans_sent",
                      "total_spans_received", "total_spans_derived",
                      "total_spans_dropped", "span_metric_rows",
                      "span_loss_frac")},
            "span_conservation": harness.span_conservation()}
           if harness.ssf_frac > 0 else {}),
        # archive-sink runs: the confirmation run's archival volume
        # (per-interval frames/bytes ride in confirm_intervals) plus
        # the sink's lifetime sample/payload ledgers
        **({"archive_confirm": {
            k: confirm.get(k)
            for k in ("archive_frames_total", "archive_bytes_total",
                      "archive_samples_total",
                      "archive_bytes_per_interval_mean")},
            "archive_ledger": harness.archive_stats()}
           if harness.archive_sink is not None else {}),
    }
