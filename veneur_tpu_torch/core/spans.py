"""Span ingestion: SpanWorker and the span→metric bridge.

Parity: reference SpanWorker (worker.go:611-695 — consumes the span
channel, applies common tags, fans each span out to every span sink with a
per-sink timeout) and the ssfmetrics extraction sink
(sinks/ssfmetrics/metrics.go:66-141 — pulls the samples attached to a span,
derives indicator/objective timers from indicator spans, counts span-name
uniqueness, and feeds it all back into the metric workers by digest).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable, Optional

from veneur_tpu_torch import ssf
from veneur_tpu_torch.core.metrics import UDPMetric
from veneur_tpu_torch.protocol.dogstatsd import parse_metric_ssf, ParseError

log = logging.getLogger("veneur_tpu_torch.spans")


def convert_metrics(span: ssf.SSFSpan) -> tuple[list[UDPMetric], int]:
    """Extract the SSF samples attached to a span as UDPMetrics; returns
    (metrics, invalid_count) (reference ConvertMetrics,
    samplers/parser.go:103-120)."""
    out = []
    invalid = 0
    for sample in span.metrics:
        try:
            m = parse_metric_ssf(sample)
        except ParseError:
            invalid += 1
            continue
        if not m.key.name or m.value is None:
            invalid += 1
            continue
        out.append(m)
    return out, invalid


def convert_indicator_metrics(
    span: ssf.SSFSpan, indicator_timer_name: str, objective_timer_name: str
) -> list[UDPMetric]:
    """Derive duration timers from an indicator span (reference
    ConvertIndicatorMetrics, samplers/parser.go:129-181): the "indicator"
    timer is tagged with service+error; the "objective" timer adds the
    span name (overridable via the ssf_objective tag) and is global-only.
    """
    if not span.indicator or not ssf.valid_trace_span(span):
        return []
    duration_ns = span.end_timestamp - span.start_timestamp
    out = []
    if indicator_timer_name:
        tags = {
            "service": span.service,
            "error": "true" if span.error else "false",
        }
        out.append(parse_metric_ssf(
            ssf.timing_ns(indicator_timer_name, duration_ns, tags)))
    if objective_timer_name:
        tags = {
            "service": span.service,
            "objective": span.tags.get("ssf_objective") or span.name,
            "error": "true" if span.error else "false",
            "veneurglobalonly": "true",
        }
        out.append(parse_metric_ssf(
            ssf.timing_ns(objective_timer_name, duration_ns, tags)))
    return out


def convert_span_uniqueness_metrics(span: ssf.SSFSpan, rate: float
                                    ) -> list[UDPMetric]:
    """Span-name uniqueness Set per service/indicator flag, sampled at
    ``rate`` (reference ConvertSpanUniquenessMetrics,
    samplers/parser.go:187-208)."""
    if not span.service:
        return []
    samples = ssf.randomly_sample(
        rate,
        ssf.set_sample(
            "ssf.names_unique", span.name,
            {
                "indicator": str(span.indicator).lower(),
                "service": span.service,
                "root_span": str(span.id == span.trace_id).lower(),
            },
        ),
    )
    return [parse_metric_ssf(s) for s in samples]


class MetricExtractionSink:
    """Span sink bridging spans back into the metric pipeline
    (reference sinks/ssfmetrics — registered like any other span sink)."""

    def __init__(
        self,
        route_metric: Callable[[UDPMetric], None],
        indicator_timer_name: str = "",
        objective_timer_name: str = "",
        uniqueness_rate: float = 0.0,
    ) -> None:
        self.route_metric = route_metric
        self.indicator_timer_name = indicator_timer_name
        self.objective_timer_name = objective_timer_name
        self.uniqueness_rate = uniqueness_rate
        self.invalid_samples = 0
        # lifetime tallies for span conservation (ingress_stats folds
        # these into received == derived + dropped + pending)
        self.spans_seen = 0
        self.derived_rows = 0
        # ingest runs concurrently under num_span_workers > 1
        self._stats_lock = threading.Lock()

    def name(self) -> str:
        return "metric_extraction"

    def start(self, trace_client=None) -> None:
        pass

    def ingest(self, span: ssf.SSFSpan) -> None:
        metrics, invalid = convert_metrics(span)
        if invalid:
            with self._stats_lock:
                self.invalid_samples += invalid
        try:
            metrics.extend(convert_indicator_metrics(
                span, self.indicator_timer_name, self.objective_timer_name))
        except ParseError:
            with self._stats_lock:
                self.invalid_samples += 1
        if self.uniqueness_rate > 0:
            metrics.extend(
                convert_span_uniqueness_metrics(span, self.uniqueness_rate))
        with self._stats_lock:
            self.spans_seen += 1
            self.derived_rows += len(metrics)
        for m in metrics:
            self.route_metric(m)

    def flush(self) -> None:
        pass


class _SinkLane:
    """One consumer thread + bounded queue per span sink.

    The isolation guarantee behind the reference's per-span 9s sink
    timeout (worker.go:612,650-688: ingest in a goroutine, stop waiting
    after the timeout): a wedged sink fills its own lane and loses spans
    (loss-over-stall) while every other sink keeps flowing — without a
    thread per (span, sink)."""

    def __init__(self, sink, capacity: int, consumers: int = 1) -> None:
        self.sink = sink
        self.q: "queue.Queue" = queue.Queue(capacity)
        self.consumers = max(1, consumers)
        # per-consumer monotonic start of its in-flight ingest (0 = idle):
        # the oldest nonzero slot tells whether ANY consumer is wedged,
        # even while the others keep finishing work
        self._busy = [0.0] * self.consumers
        self.errors = 0
        self._err_lock = threading.Lock()
        self._threads: list[threading.Thread] = []

    def oldest_busy(self) -> float:
        """Monotonic start time of the longest-running in-flight ingest,
        or 0.0 when all consumers are idle."""
        stuck = [b for b in self._busy if b]
        return min(stuck) if stuck else 0.0

    def start(self) -> None:
        for i in range(self.consumers):
            t = threading.Thread(
                target=self._run, args=(i,), daemon=True,
                name=f"span-sink-{self.sink.name()}-{i}")
            t.start()
            self._threads.append(t)

    def put(self, span) -> bool:
        try:
            self.q.put_nowait(span)
            return True
        except queue.Full:
            return False

    def drain(self, deadline: float) -> bool:
        """Wait briefly (until monotonic `deadline`) for the lane to go
        idle so spans accepted this interval make the flush they arrived
        in rather than the next one (reference ingests synchronously in
        Work, worker.go:611-695, so never observes this skew). Idleness is
        tracked with the queue's unfinished-task counter, which only drops
        after ingest completes — immune to the get()-returned-but-not-yet-
        busy window. Bounded: a wedged sink costs at most the deadline,
        never a stall."""
        while time.monotonic() < deadline:
            if self.q.unfinished_tasks == 0:
                return True
            time.sleep(0.001)
        return False

    def take_errors(self) -> int:
        with self._err_lock:
            n = self.errors
            self.errors = 0
        return n

    def _run(self, slot: int) -> None:
        while True:
            span = self.q.get()
            if span is None:
                self.q.task_done()
                return
            self._busy[slot] = time.monotonic()
            try:
                self.sink.ingest(span)
            except Exception as e:
                with self._err_lock:
                    self.errors += 1
                log.debug("span sink %s ingest failed: %s",
                          self.sink.name(), e)
            finally:
                self._busy[slot] = 0.0
                self.q.task_done()

    def stop(self) -> None:
        # sentinel delivery must not block on a full lane (the lane being
        # full of a wedged sink's spans is exactly the shutdown scenario
        # this design survives): make room by discarding queued spans —
        # per-flush span data is expendable at shutdown
        for _ in self._threads:
            while True:
                try:
                    self.q.put_nowait(None)
                    break
                except queue.Full:
                    try:
                        self.q.get_nowait()
                    except queue.Empty:
                        pass
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []


class SpanWorker:
    """Fans ingested spans out to every span sink through per-sink lanes
    (reference SpanWorker.Work, worker.go:611-695)."""

    def __init__(self, span_sinks: list, common_tags: Optional[dict] = None,
                 capacity: int = 100, sink_timeout_s: float = 9.0,
                 workers: int = 1, flush_drain_s: float = 0.5) -> None:
        self.span_sinks = span_sinks
        self.common_tags = common_tags or {}
        self.chan: "queue.Queue[Optional[ssf.SSFSpan]]" = queue.Queue(capacity)
        self.capacity = capacity
        self.sink_timeout_s = sink_timeout_s
        # shared lane-drain budget per flush pass (config
        # span_flush_drain_s; was a hardcoded 0.5s)
        self.flush_drain_s = max(0.0, flush_drain_s)
        self.spans_ingested = 0
        self.spans_dropped = 0
        self.sink_errors: dict[str, int] = {}
        # per-sink lane-full drops, split by whether the sink's consumer
        # had been stuck past sink_timeout_s (the reference's
        # worker.span.ingest_timeout_total vs a plain burst overflow)
        self.lane_drops: dict[str, int] = {}
        self.ingest_timeouts: dict[str, int] = {}
        # N consumers off one channel (reference num_span_workers,
        # server.go:842-850)
        self.workers = max(1, workers)
        self._threads: list[threading.Thread] = []
        self._stats_lock = threading.Lock()
        self._lanes: dict[int, _SinkLane] = {}

    def ingest(self, span: ssf.SSFSpan) -> None:
        """Non-blocking enqueue; drops when full (backpressure policy of
        the span pipeline: loss over stalling)."""
        try:
            self.chan.put_nowait(span)
        except queue.Full:
            # ingest is called from every listener thread; the tally must
            # take the same lock work() takes for spans_ingested or drops
            # under-count exactly when the channel is contended
            with self._stats_lock:
                self.spans_dropped += 1

    def _lane_for(self, sink) -> _SinkLane:
        lane = self._lanes.get(id(sink))
        if lane is None:
            with self._stats_lock:
                lane = self._lanes.get(id(sink))
                if lane is None:
                    # as many consumers as span workers, so a sink that
                    # scaled with num_span_workers before lanes existed
                    # still does (sinks must stay ingest-thread-safe)
                    lane = _SinkLane(sink, self.capacity,
                                     consumers=self.workers)
                    lane.start()
                    self._lanes[id(sink)] = lane
        return lane

    def start(self) -> None:
        for i in range(self.workers):
            t = threading.Thread(
                target=self.work, daemon=True, name=f"span-worker-{i}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        # Non-blocking sentinel insert, same discipline as _SinkLane.stop:
        # a server used programmatically (flush() driven, start() never
        # called) has no consumer on this channel, yet internal flush
        # spans still ingest into it — a blocking put(None) against the
        # full 100-slot queue deadlocks shutdown forever once ~100
        # intervals have run. Drop a queued span to make room instead.
        for _ in self._threads or [None]:
            while True:
                try:
                    self.chan.put_nowait(None)
                    break
                except queue.Full:
                    try:
                        self.chan.get_nowait()
                    except queue.Empty:
                        pass
        for t in self._threads:
            t.join(timeout=5)
        for lane in list(self._lanes.values()):
            lane.stop()

    def work(self) -> None:
        while True:
            span = self.chan.get()
            if span is None:
                return
            with self._stats_lock:
                self.spans_ingested += 1
            # common tags fill in missing span tags (worker.go:627-634)
            for k, v in self.common_tags.items():
                span.tags.setdefault(k, v)
            for sink in list(self.span_sinks):
                lane = self._lane_for(sink)
                if lane.put(span):
                    continue
                busy = lane.oldest_busy()
                name = sink.name()
                with self._stats_lock:
                    if (busy and time.monotonic() - busy
                            > self.sink_timeout_s):
                        self.ingest_timeouts[name] = (
                            self.ingest_timeouts.get(name, 0) + 1)
                    else:
                        self.lane_drops[name] = (
                            self.lane_drops.get(name, 0) + 1)

    def pending(self) -> int:
        """Spans accepted but not yet through every sink: channel backlog
        plus the deepest lane's unfinished work (a span fans out to all
        lanes, so the max — not the sum — is the count still in flight)."""
        lanes = list(self._lanes.values())
        deepest = max((lane.q.unfinished_tasks for lane in lanes),
                      default=0)
        return self.chan.qsize() + deepest

    def flush(self) -> None:
        # fold lane-level ingest errors into the per-sink error tally
        with self._stats_lock:
            for lane in list(self._lanes.values()):
                n = lane.take_errors()
                if n:
                    name = lane.sink.name()
                    self.sink_errors[name] = (
                        self.sink_errors.get(name, 0) + n)
        # give the lanes a moment to finish spans already accepted this
        # interval, so they ship in this flush instead of the next; one
        # shared deadline bounds the whole pass at flush_drain_s no
        # matter how many sinks are backed up
        drain_deadline = time.monotonic() + self.flush_drain_s
        for sink in self.span_sinks:
            lane = self._lanes.get(id(sink))
            if lane is not None:
                lane.drain(drain_deadline)
            try:
                sink.flush()
            except Exception:
                log.exception("span sink %s flush failed", sink.name())
