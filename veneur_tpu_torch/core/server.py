"""Server: one DogStatsD aggregation instance, PyTorch port.

A slim counterpart of veneur_tpu/core/server.py: DogStatsD lines arrive
on UDP listeners (``start_statsd_udp``) or through
``handle_metric_packet``; metrics route to the device workers by digest,
service checks to their host status state, events to the event worker.
Every interval the flush loop runs ``flush``: swap each worker's epoch,
fold and extract it on the device (the flush extract and HLL estimate
kernels on the card), generate InterMetrics and hand them to the metric
sinks. With ``count_unique_timeseries`` the workers' unique-timeseries
HLLs merge and are estimated on the device at each flush
(``last_unique_timeseries``).

With ``micro_fold`` a scheduler thread (``_micro_fold_loop``) streams
each worker's staging plane to its device mirror during the interval.
After each worker's extraction the flush runs its ``device_guard_tick``
under the worker's lock (quarantine, probe, re-admission); the guard's
counters, the quarantined workers and the flushes completed on the CPU
are ``guard_counters``, ``quarantined_workers`` and ``host_fallbacks``.

With ``tpu_native_ingest`` every worker attaches a C++ ingest context
(veneur_tpu_torch/native.py) and datagrams go through a ``NativeRouter``:
parsed in C++ and committed to the context of worker digest % N. With
``tpu_native_readers`` as well, C++ threads read the UDP sockets, and a
pump thread drains the contexts' batches past ``batch_size`` and hands
event and service-check lines back to the Python parser. A library that
does not build or load raises; the server never falls back to the
Python path behind the configuration's back.

With a metric sink the flush is columnar, as in the JAX package: each
worker's snapshot becomes a ``ColumnarMetrics`` batch
(``core/flusher.generate_columnar``), and one thread per sink emits it,
joined within the interval. A sink that supports the native emit tier
(``flush_emit_native``) serializes from the batch's arrays in C++ and
falls back to its Python formatter per group; other sinks receive the
batch's one shared materialization. A tick with nothing to flush drains
the network sinks' spilled payloads. Per-sink counts are
``sink_counters()``, the delivery layer's ``delivery_stats()``.

With one worker, native readers and ``num_readers > 1`` the readers run
as shared-nothing reader shards (``reader_shards``, resolved as in the
JAX package): each C++ reader thread commits into its own context, and
the flush merges the contexts' planes into one stacked fold
(core/worker.attach_reader_shards). ``ingress_stats()["reader_shards"]``
attributes the commits and sheds per context, with the contexts' mutex
records after ``set_lock_stats(True)``.

The global tier: a local with ``forward_address`` forwards each flush's
forwardable rows to one upstream after generation, on a thread of its
own (``forwarder``, distributed/forward.py; ``forward_stats()``); a
global with ``grpc_address`` or ``http_address`` imports them
(``import_server``, ``import_http``: distributed/import_server.py) and
merges them into its pools at the swap.

Spans: SSF arrives on UDP, unix stream and unixgram listeners
(``ssf_listen_addresses``) or through ``handle_trace_packet`` /
``handle_ssf``. Each span goes through the columnar span pipeline
(spans/, derived at the flush edge before the swap) or, with it off or a
per-span sink configured, the ``SpanWorker`` lanes; both derive its
metrics into the workers (core/spans.py) and hand it to the span sinks.
With native ingest, one worker and no span sink the C++ SSF path decodes
and derives in one pass (``handle_trace_packets_native``, the C++ SSF
reader); STATUS-bearing spans come back to the Python path. Every flush
is itself a span (``tracer``) that rejoins this server's span pipeline
and derives at the next flush, as in the JAX package. DogStatsD also
arrives over TCP (TLS, mutual TLS) and unixgram.

Per-tenant QoS (``tenant_default_budget``, ``tenant_budgets``): one
``TenantLedger`` shared by the workers admits each new series against its
tenant's budget, and each worker folds a ``TenantSketch`` (count-min pool
on the device, host top-k) at its flush; the flush counts
``tenant.samples_rejected_total`` and ``tenant.overload_dropped_total``
and sets the ``tenant.*`` gauges, and every delivery manager's spill
evicts over-budget tenants' payloads first. The live query path
(``query_listen_addrs``: ``http://`` and ``grpc://``): each worker's
extraction stages its epoch view in ``query_engine``, committed as one
epoch after every worker extracted; ``start()`` binds the fronts
(query/http.py, query/service.py).

Flush governance (health/): every flush is bracketed for the
``FlushDeadlineGovernor`` (``begin_flush``/``end_flush`` and progress
beats), which with ``flush_chunk_target_ms`` also slices each worker's
extraction into pow2 row chunks (one flush extract launch a chunk); each
worker's ``TransferLedger`` books the flush's uploads and readbacks
(``last_flush_transfers``). After every flush the spill-cap loop
(``_adapt_spill_caps``) halves every worker's spill cap when the flush
took more than 0.9 of the interval and grows it back below 0.3, and
gauges ``ingest.spill_cap``. The flush itself is four phases over a
``FlushJob`` (``_flush_begin``, ``_flush_extract``, ``_flush_generate``,
``_flush_emit``), run in turn by ``flush`` or, with ``flush_pipeline``,
on the stage threads of core/pipeline.py. ``start_watchdog`` runs
``flush_watchdog`` (``flush_watchdog_missed_flushes``), which exits the
process with code 2 when flushes stop, unless the governor shows the
flush making progress. With ``stats_address`` the self-telemetry goes out
over UDP (scopedstatsd.py, namespace ``veneur.``); ``stats`` keeps the
counters and the last value of each gauge either way. Every long-lived
thread runs under ``crash.guard`` (``sentry_dsn``).

The process lifecycle: ``synchronize_with_interval`` aligns the first
tick to the wall clock; ``prepare_handoff`` quiesces the listeners and
marks their fds inheritable for a re-exec (cli/veneur_main.py), and a
server built with ``inherited_fds`` adopts them; ``enable_profiling``
records a ``torch.profiler`` trace (CPU and CUDA) from ``start`` and
writes it as a Chrome trace into ``profile_dir`` at shutdown.

Flush plugins (``plugins``: local file, S3, the archive's blob upload)
run after the sinks on every flush that emitted, on the columnar batch
itself, in a thread joined at the interval (``plugin_flush_s``).

Series sharding (``series_shards``): each worker's pools split over D
devices (core/worker.py, ops/series_shard.py). The global tier's mesh
(``tpu_mesh_devices``, ``tpu_mesh_hosts``): the one worker's histogram
merge runs on a (hosts x series) device grid (distributed/mesh.py).
Both take their devices from ``shard_devices`` when the caller names
them (a list that may repeat a device: the series shards' devices, or
the mesh's row-major), else the first cards, or the CPU for a CPU
server.
"""

from __future__ import annotations

import gc
import logging
import math
import os
import socket
import ssl
import threading
import time
from typing import Optional

import numpy as np

from veneur_tpu_torch import __version__, scopedstatsd
from veneur_tpu_torch.core import crash
from veneur_tpu_torch.core.config import Config, resolve_reader_shards
from veneur_tpu_torch.core.flusher import (device_quantiles,
                                           generate_columnar,
                                           generate_inter_metrics)
from veneur_tpu_torch.core.metrics import HistogramAggregates
from veneur_tpu_torch.core.pipeline import FlushJob, FlushPipeline
from veneur_tpu_torch.core.spans import MetricExtractionSink, SpanWorker
from veneur_tpu_torch.core.worker import DeviceWorker, FlushSnapshot
from veneur_tpu_torch.device import resolve, serial_host_thread
from veneur_tpu_torch.health import FlushDeadlineGovernor
from veneur_tpu_torch.health.policy import (delivery_should_signal_behind,
                                            watchdog_should_defer)
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops.device_guard import (DeviceFaultError,
                                               DeviceGuard,
                                               guard_enabled_default)
from veneur_tpu_torch.protocol import dogstatsd, ssf_wire
from veneur_tpu_torch.sinks import (DELIVERY_STAT_COUNTERS, MetricSink,
                                    SpanSink, filter_routed,
                                    strip_excluded_tags)
from veneur_tpu_torch.spans import ColumnarSpanPipeline, columnar_enabled
from veneur_tpu_torch.ssf import SSFSample
from veneur_tpu_torch.trace.opentracing import Tracer
from veneur_tpu_torch.utils.proc import current_rss_bytes

log = logging.getLogger("veneur_tpu_torch.server")

# servers of this process between their start and their shutdown: the
# heap stays frozen (gc.freeze) while any of them lives
_heap_freezes = 0
_heap_freezes_lock = threading.Lock()


def _freeze_heap() -> None:
    """Move what the process holds into the collector's permanent
    generation, and count one more server that keeps it there."""
    global _heap_freezes
    with _heap_freezes_lock:
        _heap_freezes += 1
        gc.freeze()


def _thaw_heap() -> None:
    """One server fewer keeps the heap frozen; the last one unfreezes
    it."""
    global _heap_freezes
    with _heap_freezes_lock:
        _heap_freezes -= 1
        if _heap_freezes == 0:
            gc.unfreeze()

# ssf.error_total tag sets, verbatim from the reference
# (server.go:1052-1072, 1238-1246)
_SSF_ERR_ZEROLENGTH = ["ssf_format:packet", "packet_type:unknown",
                       "reason:zerolength"]
_SSF_ERR_UNMARSHAL = ["ssf_format:packet", "packet_type:ssf_metric",
                      "reason:unmarshal"]
_SSF_ERR_EMPTY_ID = ["ssf_format:packet", "packet_type:ssf_metric",
                     "reason:empty_id"]
_SSF_ERR_PROCESSING = ["ssf_format:framed", "packet_type:unknown",
                       "reason:processing"]
_SSF_ERR_FRAMING = ["ssf_format:framed", "packet_type:unknown",
                    "reason:framing"]


class EventWorker:
    """Accumulates DogStatsD events (as SSF samples) until flush
    (reference EventWorker, worker.go:527-572)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._samples: list[SSFSample] = []

    def ingest(self, sample: SSFSample) -> None:
        with self._lock:
            self._samples.append(sample)

    def flush(self) -> list[SSFSample]:
        with self._lock:
            out = self._samples
            self._samples = []
        return out


def calculate_tick_delay(interval_s: float, now: float) -> float:
    """Seconds until the next interval-aligned tick
    (reference CalculateTickDelay, server.go:1517)."""
    return interval_s - (now % interval_s)


class KeptCounts:
    """The server's self-telemetry client: the JAX package's
    ``stats.count``/``gauge``/``histogram``/``time_in_nanoseconds``.
    Every call goes to ``client`` (a scopedstatsd.ScopedClient: over UDP
    to ``stats_address``, or nowhere) as in the JAX package, and the
    counters and gauges are also kept in the process: ``totals()`` maps
    (name, tags) to a counter's lifetime sum, ``gauges()`` to a gauge's
    last value. Histograms and timings are only sent."""

    def __init__(self, client: Optional[scopedstatsd.ScopedClient] = None
                 ) -> None:
        self._client = client or scopedstatsd.ScopedClient()
        self._lock = threading.Lock()
        self._totals: dict[tuple[str, tuple[str, ...]], float] = {}
        self._gauges: dict[tuple[str, tuple[str, ...]], float] = {}

    def count(self, name: str, value, tags=None, rate: float = 1.0) -> None:
        k = (name, tuple(tags or ()))
        with self._lock:
            self._totals[k] = self._totals.get(k, 0) + value
        self._client.count(name, value, tags=tags, rate=rate)

    def gauge(self, name: str, value, tags=None, rate: float = 1.0) -> None:
        with self._lock:
            self._gauges[(name, tuple(tags or ()))] = value
        self._client.gauge(name, value, tags=tags, rate=rate)

    def histogram(self, name: str, value, tags=None, rate: float = 1.0) -> None:
        self._client.histogram(name, value, tags=tags, rate=rate)

    def time_in_nanoseconds(self, name: str, ns, tags=None, rate: float = 1.0) -> None:
        self._client.time_in_nanoseconds(name, ns, tags=tags,
                                         rate=rate)

    def totals(self) -> dict[tuple[str, tuple[str, ...]], float]:
        with self._lock:
            return dict(self._totals)

    def gauges(self) -> dict[tuple[str, tuple[str, ...]], float]:
        with self._lock:
            return dict(self._gauges)

    def close(self) -> None:
        self._client.close()


class _SpanPipelineClient:
    """Trace-client adapter: finished internal spans re-enter the owning
    server's span pipeline (sinks and span->metric derivation)."""

    def __init__(self, server: "Server") -> None:
        self._server = server

    def record(self, span) -> None:
        self._server.ingest_internal_span(span)


class Server:
    """One veneur_tpu_torch aggregation server."""

    def __init__(self, cfg: Config,
                 metric_sinks: Optional[list[MetricSink]] = None,
                 device=None,
                 span_sinks: Optional[list[SpanSink]] = None,
                 inherited_fds: Optional[dict[str, list[int]]] = None,
                 shard_devices=None) -> None:
        self.config = cfg
        self.device = resolve(device)
        # this server holds one of the process's heap freezes (start)
        self._heap_frozen = False
        self.interval = cfg.interval_seconds()
        self.percentiles = list(cfg.percentiles)
        self.aggregates = HistogramAggregates.from_names(cfg.aggregates)
        self.workers = [
            DeviceWorker(
                batch_size=cfg.tpu_batch_size,
                stage_depth=cfg.tpu_stage_depth,
                compression=cfg.tpu_compression,
                hll_precision=cfg.tpu_hll_precision,
                initial_histo_rows=cfg.tpu_initial_histo_rows,
                initial_set_rows=cfg.tpu_initial_set_rows,
                count_unique_timeseries=cfg.count_unique_timeseries,
                is_local=self.is_local,
                set_hash=cfg.set_hash,
                set_store=cfg.tpu_set_store,
                spill_cap=cfg.tpu_spill_cap,
                micro_fold=cfg.micro_fold,
                micro_fold_rows=cfg.micro_fold_rows,
                micro_fold_max_age_s=cfg.micro_fold_max_age_s,
                device_guard=cfg.device_guard,
                device_fault_streak=cfg.device_fault_streak,
                device_probe_interval_s=cfg.device_probe_interval_s,
                series_shards=cfg.series_shards,
                shard_devices=shard_devices,
                device=self.device,
            )
            for _ in range(cfg.num_workers)
        ]
        self.mesh = None
        if cfg.tpu_mesh_devices > 1:
            # the global tier's histogram merge on a device grid
            # (distributed/mesh.py); imported digests and raw samples
            # route to it instead of the worker's pool
            from veneur_tpu_torch.distributed.mesh import (MeshHistoPool,
                                                           make_mesh)

            devs = shard_devices
            if devs is None and self.device.type == "cpu":
                devs = [self.device] * cfg.tpu_mesh_devices
            self.mesh = make_mesh(cfg.tpu_mesh_devices,
                                  cfg.tpu_mesh_hosts or None, devices=devs)
            self.workers[0].attach_mesh_pool(MeshHistoPool(
                self.mesh, compression=cfg.tpu_compression,
                batch_size=cfg.tpu_batch_size))
            log.info("mesh aggregation enabled: %s", self.mesh.shape)
        # adaptive overload shedding starts at the configured ceiling and
        # tightens when flushes overrun the interval (_adapt_spill_caps)
        self._spill_cap_now = cfg.tpu_spill_cap
        # the flush governor (health/governor.py), shared by the workers:
        # chunked extraction with flush_chunk_target_ms, the progress beats
        # the watchdog's deferral rule reads, per-tenant shed attribution.
        # Each flush may inherit at most half an interval of spill-fold
        # work (swap sheds the excess, counted)
        self.flush_governor = FlushDeadlineGovernor(
            chunk_target_ms=cfg.flush_chunk_target_ms,
            interval_s=self.interval)
        for w in self.workers:
            w.fold_budget_s = 0.5 * self.interval
            w.governor = self.flush_governor
        self._worker_locks = [threading.Lock() for _ in self.workers]
        # the last guard fault surfaced to the governor per worker, and
        # the lifetime guard counters already reported (telemetry sends
        # deltas)
        self._guard_last_fault: dict = {}
        self._guard_counters_reported: dict = {}
        self._host_fallbacks_reported = 0
        # per-tenant QoS (core/tenancy.py): one series-budget ledger shared
        # by the workers (a tenant's budget is host-wide) and a sketch per
        # worker on its device. Dormant, and the flush bitwise as without
        # it, unless a budget is set
        self.tenant_ledger = None
        self._tenant_reported: dict = {}
        if cfg.tenant_default_budget > 0 or cfg.tenant_budgets:
            from veneur_tpu_torch.core.tenancy import (TenantLedger,
                                                       TenantSketch)

            self.tenant_ledger = TenantLedger(
                default_budget=cfg.tenant_default_budget,
                budgets=cfg.tenant_budgets,
                tag_key=cfg.tenant_tag_key)
            for w in self.workers:
                w.tenancy = self.tenant_ledger
                w.tenant_sketch = TenantSketch(
                    depth=cfg.tenant_sketch_depth,
                    width=cfg.tenant_sketch_width,
                    topk=cfg.tenant_topk, device=w.device)
        # the live query path (veneur_tpu_torch/query/): each worker's
        # extraction stages its epoch view; the flush commits all of them
        # as one epoch after the extract loop (no torn cross-worker read)
        self.query_engine = None
        self._query_servers: list = []
        self._query_reported = (0, 0)  # (served, failed) at last report
        if cfg.query_listen_addrs:
            import functools

            from veneur_tpu_torch.query import QueryEngine

            self.query_engine = QueryEngine(
                percentiles=self.percentiles,
                aggregates=self.aggregates,
                is_local=self.is_local,
                topk=cfg.tenant_topk)
            for i, w in enumerate(self.workers):
                w.query_publisher = functools.partial(
                    self.query_engine.stage, i)
        # the unique-timeseries tally's own guard: its faults count apart
        # from every worker's streak, and each flush tries the card again
        self._tally_guard = DeviceGuard(
            streak_limit=cfg.device_fault_streak,
            probe_interval_s=cfg.device_probe_interval_s,
            enabled=cfg.device_guard and guard_enabled_default())
        self.event_worker = EventWorker()
        # the name the plugins file each flush under
        self.hostname = cfg.hostname or (
            "" if cfg.omit_empty_hostname else socket.gethostname())
        self.metric_sinks: list[MetricSink] = list(metric_sinks or [])
        self.span_sinks: list[SpanSink] = list(span_sinks or [])
        self.sink_excluded_tags: dict[str, set[str]] = {}
        # self-telemetry (reference server.go:298-308: a statsd client with
        # namespace "veneur.", scoped per veneur_metrics_scopes, carrying
        # the common tags and veneur_metrics_additional_tags), sent to
        # stats_address when set; the counters and gauges are kept too
        sender = (scopedstatsd.UDPSender(cfg.stats_address)
                  if cfg.stats_address else scopedstatsd.NullSender())
        self.stats = KeptCounts(scopedstatsd.ScopedClient(
            sender,
            add_tags=list(cfg.tags) + list(cfg.veneur_metrics_additional_tags),
            scopes=cfg.veneur_metrics_scopes, namespace="veneur."))
        self._span_sink_reported: dict[tuple[str, str], int] = {}
        self._plugin_reported: dict[tuple[str, str], int] = {}
        # interval-delta bookkeeping of the lifetime counters sent
        self._errors_reported = 0
        self._delivery_reported: dict[tuple[str, str], int] = {}
        self._delivery_behind_consec = 0
        self._forward_reported: dict[tuple[str, str], int] = {}
        self._reader_reported: dict[tuple[str, int], int] = {}

        # the span->metric bridge is always wired in, like the reference's
        # ssfmetrics sink (server.go:407-415)
        self._extraction_sink = MetricExtractionSink(
            route_metric=self._route,
            indicator_timer_name=cfg.indicator_span_timer_name,
            objective_timer_name=cfg.objective_span_timer_name,
            uniqueness_rate=cfg.ssf_span_uniqueness_rate,
        )
        common_tags = dict(t.split(":", 1) for t in cfg.tags if ":" in t)
        self.span_worker = SpanWorker(
            [self._extraction_sink] + self.span_sinks,
            common_tags=common_tags,
            capacity=cfg.span_channel_capacity,
            workers=cfg.num_span_workers,
            flush_drain_s=cfg.span_flush_drain_s,
        )
        # the columnar span pipeline (spans/): on when configured and
        # every span sink takes sealed batches; one per-span-only sink
        # keeps the whole path on the SpanWorker lanes (a span must flow
        # through exactly one of the two or it derives twice)
        self.span_pipeline: Optional[ColumnarSpanPipeline] = None
        if columnar_enabled(cfg.span_columnar) and all(
                hasattr(s, "ingest_batch") for s in self.span_sinks):
            self.span_pipeline = ColumnarSpanPipeline(
                route_many=self._route_many,
                batch_sinks=self.span_sinks,
                common_tags=common_tags,
                indicator_timer_name=cfg.indicator_span_timer_name,
                objective_timer_name=cfg.objective_span_timer_name,
                uniqueness_rate=cfg.ssf_span_uniqueness_rate,
                batch_rows=cfg.span_batch_rows,
                pending_cap=cfg.span_pending_cap,
            )
        # handle_ssf's columnar path stands down once the span worker is
        # customized at runtime (a sink appended to span_worker.span_sinks,
        # or its ingest replaced); this length is what "uncustomized"
        # means
        self._span_worker_sink_count = len(self.span_worker.span_sinks)
        # per-service span counts (reference server.go:1088-1101), swapped
        # every flush into ``stats`` (ssf.spans.received_total), and
        # lifetime tallies for span conservation
        self.ssf_spans_received: dict[str, int] = {}
        self.ssf_spans_received_total = 0
        self._spans_native_total = 0
        self._ssf_stats_lock = threading.Lock()
        # native emit tier (native/emit.cpp): sinks serialize their wire
        # payloads GIL-free straight from the flush arrays; off = always
        # use the Python columnar formatters
        self.flush_emit_native = bool(
            getattr(cfg, "flush_emit_native", True))
        # per-sink counts (the JAX package sends them as
        # sink.metrics_flushed_total, flush.error_total and
        # sink.metric_flush_total_duration_ns), written by the sink
        # threads
        self._sink_counts: dict[str, dict[str, float]] = {}
        self._sink_counts_lock = threading.Lock()
        self._threads: list[threading.Thread] = []
        # threads that run device work: shutdown joins them (bounded)
        # before the process may exit
        self._compute_threads: list[threading.Thread] = []
        self.compute_threads_joined = True
        self._sockets: list[socket.socket] = []
        # flock fds of bound unix sockets, and open stream connections
        # (shut at shutdown so their reader threads end)
        self._socket_locks: list[int] = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._shutdown = threading.Event()
        # shutdown runs once; a caller that loses the race waits for the
        # winner's teardown and returns its verdict
        self._shutdown_once_lock = threading.Lock()
        self._shutdown_done = False
        self._shutdown_complete = threading.Event()
        self._shutdown_result = True
        # zero-downtime restart: listener fds inherited from the previous
        # process image, keyed by listener spec (datagrams queue in the
        # kernel's socket buffers across the re-exec); the fds this image
        # bound, for the next one; prepare_handoff quiesces the readers
        self._inherited: dict[str, list[int]] = dict(inherited_fds or {})
        self._listener_fds: dict[str, list[int]] = {}
        self._adopt: list[int] = []
        self._handoff = False
        self._quiesce = threading.Event()
        self._profiler = None
        self._profile_thread: Optional[threading.Thread] = None
        self._flush_lock = threading.Lock()
        self._counter_lock = threading.Lock()
        # Python-path tallies; the properties add the native readers' and
        # contexts' counts
        self._packets_py = 0
        self._parse_errors_py = 0
        self.last_flush_phases: dict[str, float] = {}
        # the flush clock the watchdog reads, the last emission's end,
        # the last flush's transfer totals and chunk report, and the wall
        # time the last tick held the ticker thread (the serial flush, or
        # the pipelined swap and enqueue)
        self.last_flush_unix = time.time()
        self.last_emit_unix = 0.0
        self.last_flush_transfers: dict[str, int] = {}
        self.last_flush_chunks: dict = {}
        self.flush_count = 0
        self.last_tick_s = 0.0
        # micro-folds of the epoch the last swap closed
        self.last_micro_folds = 0
        # the stage-parallel flush (core/pipeline.py); None: serial
        self.flush_pipeline = (
            FlushPipeline(self, max_backlog=cfg.flush_pipeline_backlog)
            if cfg.flush_pipeline else None)
        # the last flush's unique-timeseries estimate (with
        # count_unique_timeseries; sent as flush.unique_timeseries_total)
        self.last_unique_timeseries: Optional[int] = None
        # the native C++ ingest path: one parser context per worker,
        # lines committed to the context of worker digest % N
        self.native_mode = False
        self._native_router = None
        self._native_ingest_tick = 0
        # C++ reader-thread handles, and the packets of stopped ones
        self._native_readers: list = []
        self._native_ssf_readers: list = []
        self._native_stream_readers: list = []
        self._native_reader_packets_stopped = 0
        self._native_reader_lock = threading.Lock()
        self._native_pump_started = False
        # the global tier: the forwarder a local's flush calls (after
        # generation, on a thread of its own that shutdown joins) and a
        # global's import servers (core/factory.py)
        self.forwarder = None
        self._forward_thread: Optional[threading.Thread] = None
        self.import_server = None
        self.import_http = None
        # flush-time archival plugins (reference plugins/plugins.go),
        # run after the sinks
        self.plugins: list = []
        # write-ahead spill journals (utils/journal.py), one per
        # journalable delivery manager, attached in start() when
        # spill_journal_dir is set; shutdown_stats is filled by
        # graceful_drain (the SIGTERM path)
        self._journals: dict = {}
        self.shutdown_stats: dict = {}
        # shared-nothing reader shards (the worker's own contexts, one a
        # C++ reader thread); 0 keeps the digest-routed readers
        self._reader_shards = 0
        self._lock_stats_enabled = False
        if cfg.tpu_native_ingest:
            from veneur_tpu_torch.native import NativeRouter

            for w in self.workers:
                w.attach_native()
            self._native_router = NativeRouter(
                [w._native for w in self.workers])
            self.native_mode = True
            log.info("native C++ ingest enabled (%d contexts)",
                     len(self.workers))
            n_rs = resolve_reader_shards(cfg)
            if n_rs and self.workers[0].attach_reader_shards(n_rs):
                self._reader_shards = n_rs
                log.info("reader-sharded ingest enabled (%d shared-nothing "
                         "reader shards)", n_rs)
        # the native SSF span path: only when the extraction sink is the
        # sole span consumer (a span sink needs the Python span object),
        # and with one worker (the C++ extractor commits into one context;
        # with several, the Python path routes each derived metric to its
        # home worker)
        self._native_ssf = (self.native_mode and not self.span_sinks
                            and len(self.workers) == 1)
        # the tracer's finished spans rejoin this server's own span
        # pipeline (the reference's internal spans flow through SpanChan
        # the same way, server.go:310-317)
        self.tracer = Tracer(client=_SpanPipelineClient(self),
                             service="veneur-tpu")
        self._native_ssf_indicator = cfg.indicator_span_timer_name.encode()
        self._native_ssf_objective = cfg.objective_span_timer_name.encode()
        if self._native_ssf:
            log.info("native SSF span extraction enabled")

    @property
    def is_local(self) -> bool:
        return self.config.is_local()

    @property
    def packets_received(self) -> int:
        """Datagrams received: the Python readers' and the C++ readers'
        (live and stopped)."""
        n = self._packets_py + self._native_reader_packets_stopped
        with self._native_reader_lock:
            for h in self._native_readers:
                n += self._native_router.reader_packets(h)
        return n

    @property
    def parse_errors(self) -> int:
        """Parse and overlong errors: the Python path's, each worker's
        drained native count and the native delta not yet drained."""
        n = self._parse_errors_py
        for w in self.workers:
            n += w.parse_errors
            if w._native is not None:
                n += int(w._native.errors) - w._native_errs_seen
                for j, ctx in enumerate(w._reader_ctxs):
                    n += int(ctx.errors) - w._reader_errs_seen[j]
        return n

    @property
    def host_fallbacks(self) -> int:
        """Flushes, summed over the workers, that ran some of their
        device work on the CPU failover engine (degraded snapshots)."""
        return sum(w.host_fallback_flushes for w in self.workers)

    @property
    def quarantined_workers(self) -> int:
        """Workers whose device path is quarantined now."""
        return sum(1 for w in self.workers if w.guard.quarantined)

    def guard_counters(self) -> dict[str, int]:
        """The device-guard counters (device.fault.*, device.guard.*,
        device.valve.*) of the workers and the tally, summed."""
        out: dict[str, int] = {}
        for g in [w.guard for w in self.workers] + [self._tally_guard]:
            for k, v in g.counters().items():
                out[k] = out.get(k, 0) + v
        return out

    def _delivery_managers(self):
        """(report name, DeliveryManager) for every sink and plugin that
        carries one; span sinks report under <name>_spans."""
        out = []
        for sink in self.metric_sinks:
            man = getattr(sink, "delivery", None)
            if man is not None:
                out.append((sink.name(), man))
        for sink in self.span_sinks:
            man = getattr(sink, "delivery", None)
            if man is not None:
                out.append((sink.name() + "_spans", man))
        for plugin in self.plugins:
            man = getattr(plugin, "delivery", None)
            if man is not None:
                out.append((plugin.name(), man))
        return out

    def delivery_stats(self) -> dict[str, dict]:
        """Each network sink's delivery counters (sinks/delivery.py
        ``DeliveryManager.stats``), keyed by sink name."""
        return {rname: man.stats()
                for rname, man in self._delivery_managers()}

    def forward_stats(self) -> Optional[dict]:
        """The forwarder's per-destination counts (sent batches and
        metrics, errors, the stream window), or None on a global."""
        fwd = self.forwarder
        if fwd is None or not hasattr(fwd, "forward_stats"):
            return None
        return fwd.forward_stats()

    def set_lock_stats(self, enabled: bool) -> None:
        """Toggle commit-mutex timing in the native library (process-wide;
        it costs the commit path while on) and reset every context's
        record, so a window starts clean. Read through
        ``ingress_stats()["reader_shards"]["lock"]``."""
        self._lock_stats_enabled = bool(enabled)
        if self._native_router is None:
            return
        self._native_router.set_lock_stats(enabled)
        for w in self.workers:
            for ctx in w._all_ctxs():
                ctx.reset_lock_stats()

    def ingress_stats(self) -> dict:
        """Lifetime ingress counters (monotonic for the process): packets,
        parse errors, samples processed (swapped epochs' totals plus the
        live epoch's) and shed, the flush cadence (flush count, last flush
        and emission times, how long the last tick held the ticker thread,
        lifetime micro-folds and the last closed epoch's), each delivery
        manager's counters, and with reader shards the per-context
        attribution (index 0 the home context, then one per reader) with
        the mutex records while ``set_lock_stats`` is on. The loadgen
        controller reads it; loss over a window is a subtraction of two
        snapshots."""
        processed = dropped = 0
        for i, w in enumerate(self.workers):
            with self._worker_locks[i]:
                processed += w.processed_total + w.processed
                dropped += w.overload_dropped_total
                if w._native is not None:
                    dropped += (int(w._native.overload_dropped)
                                - w._native_drop_seen)
                    for j, ctx in enumerate(w._reader_ctxs):
                        dropped += (int(ctx.overload_dropped)
                                    - w._reader_drop_seen[j])
        out = {
            "packets_received": self.packets_received,
            "parse_errors": self.parse_errors,
            "samples_processed": processed,
            "overload_dropped": dropped,
            "flush_count": self.flush_count,
            "last_flush_unix": self.last_flush_unix,
            "last_emit_unix": self.last_emit_unix,
            "last_flush_phases": dict(self.last_flush_phases),
            "last_tick_s": self.last_tick_s,
            "micro_folds_total": sum(w.micro_folds_total
                                     for w in self.workers),
            "last_micro_folds": self.last_micro_folds,
        }
        if self._reader_shards:
            out["reader_shards"] = self.workers[0].reader_stats(
                lock_stats=self._lock_stats_enabled)
        out["spans"] = self._span_stats()
        if self.flush_pipeline is not None:
            out["pipeline"] = self.flush_pipeline.stats()
        delivery = self.delivery_stats()
        if delivery:
            out["delivery"] = delivery
        if self._journals:
            out["journal"] = {rname: j.stats()
                              for rname, j in self._journals.items()}
        if self.shutdown_stats:
            out["shutdown"] = dict(self.shutdown_stats)
        return out

    def _span_stats(self) -> dict:
        """Span conservation: received == derived + dropped + pending
        (received counts every handle_ssf plus the natively extracted
        spans; derived counts spans whose metrics reached the workers).
        Exact on the columnar path; on the SpanWorker lanes pending is a
        point-in-time queue depth, so there the balance is eventual."""
        with self._ssf_stats_lock:
            received = self.ssf_spans_received_total
        native = self._spans_native_total
        received += native
        ext = self._extraction_sink
        sw = self.span_worker
        with ext._stats_lock:
            lderived = ext.spans_seen
            lrows = ext.derived_rows
            linvalid = ext.invalid_samples
        with sw._stats_lock:
            ldropped = (sw.spans_dropped
                        + sw.lane_drops.get(ext.name(), 0)
                        + sw.ingest_timeouts.get(ext.name(), 0))
        if self.span_pipeline is not None:
            # the lanes' tallies are zero in pure columnar operation, but
            # a runtime customization (handle_ssf) reroutes the stream
            # through them: both books are summed
            ps = self.span_pipeline.stats()
            return {
                "received": received,
                "derived": ps["spans_derived"] + native + lderived,
                "derived_rows": ps["derived_rows"] + lrows,
                "dropped": ps["spans_dropped"] + ldropped,
                "pending": ps["pending"] + sw.pending(),
                "invalid_samples": ps["invalid_samples"] + linvalid,
                "columnar": True,
            }
        return {
            "received": received,
            "derived": lderived + native,
            "derived_rows": lrows,
            "dropped": ldropped,
            "pending": sw.pending(),
            "invalid_samples": linvalid,
            "columnar": False,
        }

    def sink_counters(self) -> dict[str, dict[str, float]]:
        """Per sink: metrics flushed and flush errors since start, and
        the last flush's seconds (``metrics_flushed_total``,
        ``flush_error_total``, ``flush_duration_s``)."""
        with self._sink_counts_lock:
            return {k: dict(v) for k, v in self._sink_counts.items()}

    def _count_sink(self, sink: MetricSink, flushed: int, error: bool,
                    seconds: float) -> None:
        with self._sink_counts_lock:
            c = self._sink_counts.setdefault(sink.name(), {
                "metrics_flushed_total": 0, "flush_error_total": 0,
                "flush_duration_s": 0.0})
            c["metrics_flushed_total"] += flushed
            c["flush_error_total"] += int(error)
            c["flush_duration_s"] = seconds

    @property
    def native_reader_threads(self) -> int:
        """C++ reader threads running now."""
        with self._native_reader_lock:
            return len(self._native_readers)

    # -- packet handling ----------------------------------------------------

    def handle_metric_packet(self, packet: bytes) -> None:
        """Dispatch one line: event / service check / metric
        (reference HandleMetricPacket, server.go:994-1046)."""
        if not packet:
            return
        try:
            if packet.startswith(b"_e{"):
                self.event_worker.ingest(dogstatsd.parse_event(packet))
            elif packet.startswith(b"_sc"):
                self._route(dogstatsd.parse_service_check(packet))
            else:
                self._route(dogstatsd.parse_metric(packet))
        except dogstatsd.ParseError as e:
            self._bump_errors()
            log.debug("bad metric packet %r: %s", packet[:128], e)

    def _bump_errors(self, n: int = 1) -> None:
        with self._counter_lock:
            self._parse_errors_py += n

    def _route(self, metric) -> None:
        i = metric.digest % len(self.workers)
        with self._worker_locks[i]:
            self.workers[i].process_metric(metric)

    def _route_many(self, metrics: list) -> None:
        """Route a burst of metrics taking each worker lock once per
        group. Grouping is a stable partition of one stream, so each
        worker sees what per-metric _route would give it, in order."""
        nw = len(self.workers)
        if nw == 1:
            with self._worker_locks[0]:
                process = self.workers[0].process_metric
                for m in metrics:
                    process(m)
            return
        groups: dict[int, list] = {}
        for m in metrics:
            groups.setdefault(m.digest % nw, []).append(m)
        for i, group in groups.items():
            with self._worker_locks[i]:
                process = self.workers[i].process_metric
                for m in group:
                    process(m)

    def process_metric_packet(self, datagram: bytes) -> None:
        """Split a datagram on newlines and handle each line
        (reference processMetricPacket, server.go:1136)."""
        with self._counter_lock:
            self._packets_py += 1
        if len(datagram) > self.config.metric_max_length:
            self._bump_errors()
            return
        if self.native_mode:
            # parsed in C++ without a Python lock; the contexts commit
            # under their own mutexes. The drain check is strided (each
            # is a C call per context); everything drains at flush
            self._native_router.ingest(datagram)
            self._native_ingest_tick += 1
            if self._native_ingest_tick % 64 == 0:
                self._drain_native_thresholds()
            # event and service-check lines come back for the Python
            # parser
            if b"_e{" in datagram or b"_sc" in datagram:
                self._drain_native_events()
            return
        for line in datagram.split(b"\n"):
            if line:
                self.handle_metric_packet(line)

    def _drain_native_thresholds(self) -> None:
        """Drain each worker whose native spill or set batch reached
        batch_size."""
        for w, lock in zip(self.workers, self._worker_locks):
            if any(ctx.pending_histo >= w.batch_size
                   or ctx.pending_set >= w.batch_size
                   for ctx in w._all_ctxs()):
                with lock:
                    w.drain_native()

    def _drain_native_events(self) -> None:
        """Parse the event and service-check lines the C++ contexts hand
        back on the Python path. Must not be called under a worker lock:
        the lines re-enter _route, which takes one."""
        for w in self.workers:
            for ctx in w._all_ctxs():
                for line in ctx.drain_other():
                    self.handle_metric_packet(line)

    def _drain_native_ssf_fallbacks(self) -> None:
        """The SSF payloads the C++ SSF reader handed back (STATUS spans
        need the Python pipeline). Must not be called under a worker
        lock, as _drain_native_events."""
        if not self._native_ssf_readers:
            return
        for pkt in self.workers[0]._native.drain_ssf_fallback():
            self.handle_trace_packet(pkt)

    # -- SSF ingest ---------------------------------------------------------

    def handle_trace_packet(self, packet: bytes) -> None:
        """One unframed SSF datagram into the span pipeline
        (reference HandleTracePacket, server.go:1046)."""
        if not packet:
            self._bump_errors()
            self.stats.count("ssf.error_total", 1,
                             tags=_SSF_ERR_ZEROLENGTH)
            return
        if self._native_ssf:
            # decode and span->metric extraction in one C++ pass; rc -1
            # is a span carrying STATUS samples, for the Python path below
            with self._worker_locks[0]:
                rc = self.workers[0].ingest_ssf_packet(
                    packet, self._native_ssf_indicator,
                    self._native_ssf_objective,
                    self.config.ssf_span_uniqueness_rate)
            if rc == 1:
                return
            if rc == 0:
                self._bump_errors()
                self.stats.count("ssf.error_total", 1,
                                 tags=_SSF_ERR_UNMARSHAL)
                return
        try:
            span = ssf_wire.parse_ssf(packet)
        except ssf_wire.FramingError as e:
            self._bump_errors()
            self.stats.count("ssf.error_total", 1,
                             tags=_SSF_ERR_UNMARSHAL)
            log.debug("bad SSF packet: %s", e)
            return
        if span.id == 0:
            # a client problem, counted, and the span is still handled
            # (reference server.go:1067-1072)
            self.stats.count("ssf.error_total", 1,
                             tags=_SSF_ERR_EMPTY_ID)
            log.debug("trace packet has zero span id")
        self.handle_ssf(span)

    def ingest_internal_span(self, span) -> None:
        """Self-tracing entry: a finished internal span enters the same
        pipeline external SSF spans do."""
        self.handle_ssf(span)

    def handle_trace_packets_native(self, packets: list[bytes]) -> None:
        """Batched handle_trace_packet for the native SSF path: one C call
        decodes and extracts the whole burst; STATUS-bearing spans come
        back for the Python pipeline."""
        worker = self.workers[0]
        with self._worker_locks[0]:
            ok, errs, fallbacks = worker._native.ingest_ssf_many(
                packets, self._native_ssf_indicator,
                self._native_ssf_objective,
                self.config.ssf_span_uniqueness_rate)
            worker._processed_py += ok
            if (worker._native.pending_histo >= worker.batch_size
                    or worker._native.pending_set >= worker.batch_size):
                worker.drain_native()
        if errs:
            self._bump_errors(errs)
            self.stats.count("ssf.error_total", errs,
                             tags=_SSF_ERR_UNMARSHAL)
        for pkt in fallbacks:
            try:
                span = ssf_wire.parse_ssf(pkt)
            except ssf_wire.FramingError as e:
                self._bump_errors()
                self.stats.count("ssf.error_total", 1,
                                 tags=_SSF_ERR_UNMARSHAL)
                log.debug("bad SSF packet: %s", e)
                continue
            if span.id == 0:
                self.stats.count("ssf.error_total", 1,
                                 tags=_SSF_ERR_EMPTY_ID)
            self.handle_ssf(span)

    def handle_ssf(self, span) -> None:
        """reference handleSSF (server.go:1077): per-service counts, then
        the columnar pipeline or the span worker."""
        service = span.service or "unknown"
        with self._ssf_stats_lock:
            self.ssf_spans_received[service] = (
                self.ssf_spans_received.get(service, 0) + 1)
            self.ssf_spans_received_total += 1
        sw = self.span_worker
        # columnar only while the worker is pristine: a runtime-appended
        # per-span sink or a replaced ingest must keep seeing every span,
        # so either routes the whole stream back through the lanes
        if (self.span_pipeline is not None
                and getattr(sw.ingest, "__func__", None) is SpanWorker.ingest
                and len(sw.span_sinks) == self._span_worker_sink_count):
            self.span_pipeline.ingest(span)
        else:
            sw.ingest(span)

    def start_ssf_udp(self, addr: str, port: int) -> int:
        """SSF datagrams over UDP: a C++ SSF reader on the native SSF
        path with native readers (it raises if it cannot start: no quiet
        fallback), else a Python reader. Returns the bound port."""
        sock = self._adopt_fd()
        if sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((addr, port))
        bound_port = sock.getsockname()[1]
        self._sockets.append(sock)
        # the per-datagram buffer is sized from trace_max_length_bytes,
        # the reference's tracePool (server.go:859-863); inet datagrams
        # stop at 65,507 bytes, so it is clamped there. A datagram larger
        # than the buffer is truncated by recv and fails the parse, a
        # parse error as in the reference
        max_len = min(self.config.trace_max_length_bytes, 65536)
        if self._native_ssf and self.config.tpu_native_readers:
            # datagram -> decode -> span->metric extraction with no Python
            # on the path; STATUS spans wait for the pump's fallback drain
            sock.setblocking(True)
            h = self.workers[0]._native.start_ssf_reader(
                sock.fileno(), max_len, self._native_ssf_indicator,
                self._native_ssf_objective,
                self.config.ssf_span_uniqueness_rate)
            with self._native_reader_lock:
                self._native_ssf_readers.append(h)
            self._start_native_pump()
            return bound_port

        def loop():
            # the timeout lets a handoff quiesce the reader without
            # closing the socket: datagrams then queue for the successor
            sock.settimeout(0.5)
            buf = bytearray(max_len)
            while not (self._shutdown.is_set() or self._quiesce.is_set()):
                try:
                    n = sock.recv_into(buf, max_len)
                    data = bytes(buf[:n])
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not self._native_ssf:
                    self.handle_trace_packet(data)
                    continue
                # native path: take whatever else is queued and decode the
                # burst in one C call
                batch = [data]
                sock.setblocking(False)
                try:
                    while len(batch) < 512:
                        batch.append(sock.recv(max_len))
                except (BlockingIOError, OSError):
                    pass
                finally:
                    sock.settimeout(0.5)
                self.handle_trace_packets_native(batch)

        self._spawn(loop, "ssf-udp")
        return bound_port

    def start_ssf_unix(self, path: str) -> None:
        """Framed SSF over a unix stream socket
        (reference startSSFUnix, networking.go:222-285)."""
        sock = self._bind_unix_socket(path, socket.SOCK_STREAM)
        sock.listen(64)

        def accept_loop():
            sock.settimeout(0.5)
            while not self._shutdown.is_set():
                try:
                    conn, _ = sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                conn.settimeout(None)
                self._spawn(lambda c=conn: self._read_ssf_stream(c),
                            "ssf-unix-conn")

        self._spawn(accept_loop, "ssf-unix-accept")

    def _read_ssf_stream(self, conn: socket.socket) -> None:
        """Framed read loop; a framing error poisons the stream
        (reference ReadSSFStreamSocket, server.go:1215)."""
        self._track_conn(conn, True)
        f = conn.makefile("rb")
        try:
            while not self._shutdown.is_set():
                try:
                    span = ssf_wire.read_ssf(
                        f, max_length=self.config.trace_max_length_bytes)
                except ssf_wire.SSFUnmarshalError as e:
                    # the frame was consumed whole, so the stream reads on
                    # (reference server.go:1243-1248)
                    self._bump_errors()
                    self.stats.count("ssf.error_total", 1,
                                     tags=_SSF_ERR_PROCESSING)
                    log.debug("bad SSF frame payload: %s", e)
                    continue
                if span is None:
                    # a clean hangup at a frame boundary
                    # (reference server.go:1229-1232)
                    self.stats.count("frames.disconnects", 1)
                    return
                self.handle_ssf(span)
        except ssf_wire.FramingError as e:
            # a framing violation poisons the stream: close it
            # (reference server.go:1234-1241)
            self._bump_errors()
            self.stats.count("ssf.error_total", 1, tags=_SSF_ERR_FRAMING)
            log.debug("SSF stream framing error, closing: %s", e)
        except (OSError, ValueError):
            pass
        finally:
            self._track_conn(conn, False)
            try:
                conn.close()
            except OSError:
                pass

    def start_ssf_unixgram(self, path: str) -> None:
        """Unframed SSF datagrams over a unix datagram socket (reference
        ReadSSFPacketSocket over unixgram, networking.go:222-285)."""
        sock = self._bind_unix_socket(path, socket.SOCK_DGRAM)

        def loop():
            # unix datagrams are not bound by the inet 64 KiB limit: the
            # buffer is the full trace_max_length_bytes
            max_len = self.config.trace_max_length_bytes
            buf = bytearray(max_len)
            sock.settimeout(0.5)
            while not self._shutdown.is_set():
                try:
                    n = sock.recv_into(buf, max_len)
                except socket.timeout:
                    continue
                except OSError:
                    return
                self.handle_trace_packet(bytes(buf[:n]))

        self._spawn(loop, "ssf-unixgram")

    def start_ssf_listeners(self) -> dict[str, int]:
        """Start every ``ssf_listen_addresses`` listener (udp://,
        unix:// or unixstream://, unixgram://); the UDP ports keyed by
        address."""
        ports = {}
        for spec in self.config.ssf_listen_addresses:
            proto, _, rest = spec.partition("://")
            if proto == "udp":
                # the fd manifest's key is namespaced: a statsd listener
                # with the same spec must not take this one's fds
                key = "ssf:" + spec
                self._adopt = list(self._inherited.pop(key, []))
                before = len(self._sockets)
                host, _, port = rest.rpartition(":")
                ports[spec] = self.start_ssf_udp(host or "127.0.0.1",
                                                 int(port))
                self._listener_fds[key] = [
                    s.fileno() for s in self._sockets[before:]]
                self._close_unused_adopted()
            elif proto in ("unix", "unixstream"):
                self.start_ssf_unix(rest)
            elif proto == "unixgram":
                self.start_ssf_unixgram(rest)
            else:
                raise ValueError(f"unsupported SSF listener {spec!r}")
        return ports

    # -- listeners ----------------------------------------------------------

    def _track_conn(self, conn: socket.socket, live: bool) -> None:
        with self._conns_lock:
            if live:
                self._conns.add(conn)
            else:
                self._conns.discard(conn)

    def _spawn(self, target, name: str,
               compute: bool = False) -> threading.Thread:
        """Start a long-lived server thread under panic capture
        (reference ConsumePanic around goroutines, sentry.go:22-60): an
        uncaught exception is logged critical, reported to sentry_dsn and
        exits the process with code 1, so supervision restarts it.
        Exceptions after shutdown began are routine (sockets closed under
        readers) and are only logged. ``compute`` marks a thread that
        runs device work; shutdown joins those. On a CPU device a compute
        thread runs its torch ops on one intra-op thread
        (device.serial_host_thread)."""
        if compute and self.device.type == "cpu":
            work = target

            def target():
                serial_host_thread(self.device)
                work()

        t = threading.Thread(
            target=crash.guard(target, self.config.sentry_dsn, name,
                               suppress=self._shutdown.is_set),
            name=name, daemon=True)
        t.start()
        self._threads.append(t)
        if compute:
            self._compute_threads.append(t)
        return t

    def _adopt_fd(self) -> Optional[socket.socket]:
        """Take one inherited listener fd, if the previous process image
        handed one off for the listener being started."""
        while self._adopt:
            fd = self._adopt.pop(0)
            try:
                return socket.socket(fileno=fd)
            except OSError:
                log.warning("inherited fd %d unusable; binding fresh", fd)
        return None

    def _close_unused_adopted(self) -> None:
        """Close inherited fds a listener did not take (the configuration
        shrank across the restart): they must not leak."""
        for fd in self._adopt:
            try:
                os.close(fd)
            except OSError:
                pass
        self._adopt = []

    def start_statsd_udp(self, addr: str, port: int) -> int:
        """num_readers reader threads sharing the port via SO_REUSEPORT
        (reference networking.go:41-91). Returns the bound port."""
        if self._adopt and len(self._adopt) != self.config.num_readers:
            # num_readers changed across the restart: a mix of adopted and
            # fresh sockets cannot share the port (SO_REUSEPORT is fixed
            # at bind), so every socket binds fresh, logged
            log.warning("num_readers changed across restart (%d inherited "
                        "fds, %d readers); re-binding fresh",
                        len(self._adopt), self.config.num_readers)
            self._close_unused_adopted()
        bound_port = port
        for i in range(self.config.num_readers):
            sock = self._adopt_fd()
            if sock is None:
                sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                if self.config.num_readers > 1:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT,
                                    1)
                if self.config.read_buffer_size_bytes:
                    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                    self.config.read_buffer_size_bytes)
                sock.bind((addr, bound_port))
            bound_port = sock.getsockname()[1]  # resolve port 0 once
            self._sockets.append(sock)
            if self.native_mode and self.config.tpu_native_readers:
                self._start_native_metric_reader(sock)
            else:
                self._spawn(lambda s=sock: self._read_metric_socket(s),
                            f"statsd-udp-{i}")
        return bound_port

    def _start_native_metric_reader(self, sock: socket.socket) -> None:
        """Hand the bound datagram socket's fd to a C++ reader thread:
        datagram to staged sample with no Python on the path. The socket
        object stays in self._sockets so the fd outlives the thread. The
        reader's index spreads the readers' event lines and parse errors
        over the contexts."""
        sock.setblocking(True)
        with self._native_reader_lock:
            i = len(self._native_readers)
        if self._reader_shards:
            # shared-nothing: reader i commits only into reader context
            # i % R (its events and errors stay there too)
            ctxs = self.workers[0]._reader_ctxs
            h = ctxs[i % len(ctxs)].start_owned_reader(
                sock.fileno(), self.config.metric_max_length)
        else:
            h = self._native_router.start_reader(
                sock.fileno(), self.config.metric_max_length,
                home=i % len(self.workers))
        with self._native_reader_lock:
            self._native_readers.append(h)
        self._start_native_pump()

    def _start_native_pump(self) -> None:
        """With C++ readers no Python code sees a datagram: this thread
        takes over process_metric_packet's strided duties, the threshold
        drains and the event hand-back (both also run at every flush)."""
        if self._native_pump_started:
            return

        def pump() -> None:
            while not (self._shutdown.wait(0.1) or self._quiesce.is_set()):
                self._drain_native_thresholds()
                self._drain_native_events()
                self._drain_native_ssf_fallbacks()
                self._reap_stream_readers()

        self._spawn(pump, "native-pump", compute=True)
        self._native_pump_started = True

    def _reap_stream_readers(self) -> None:
        """Join the C++ stream readers whose connection ended (an unjoined
        dead thread pins its stack for the life of the process)."""
        with self._native_reader_lock:
            live = []
            for h in self._native_stream_readers:
                if self._native_router.stream_reader_done(h):
                    self._native_router.stop_stream_reader(h)
                    self.stats.count("tcp.disconnects", 1)
                else:
                    live.append(h)
            self._native_stream_readers = live

    def _stop_native_readers(self) -> None:
        """Join the C++ reader threads: datagram and SSF readers, whose
        fds stay open (a handoff passes them to the next process image;
        shutdown closes their sockets after), and stream readers, which
        own and close their connections' fds (TCP connections do not
        ride a handoff). Idempotent."""
        with self._native_reader_lock:
            readers, self._native_readers = self._native_readers, []
            for h in readers:
                # the count after the join: the last recv window included
                self._native_reader_packets_stopped += (
                    self._native_router.stop_reader(h))
            ssf_readers, self._native_ssf_readers = (
                self._native_ssf_readers, [])
            for h in ssf_readers:
                # SSF datagrams are spans, counted by the span path
                self.workers[0]._native.stop_ssf_reader(h)
            streams, self._native_stream_readers = (
                self._native_stream_readers, [])
            if streams:
                self.stats.count("tcp.disconnects", len(streams))
            for h in streams:
                self._native_router.stop_stream_reader(h)

    def sync_native_series_once(self) -> None:
        """One locked sweep adopting the contexts' new series (the pending
        probe is a lock-free C call)."""
        for w, lock in zip(self.workers, self._worker_locks):
            if w.native_series_pending():
                with lock:
                    w.sync_native_series()

    def _series_sync_loop(self) -> None:
        """Adopt new series as they arrive, so swap (under the ingest
        lock) adopts only the tail."""
        cadence = max(0.1, min(1.0, self.interval / 8.0))
        while not (self._shutdown.wait(cadence) or self._quiesce.is_set()):
            self.sync_native_series_once()

    def _micro_fold_loop(self) -> None:
        """The micro-fold scheduler: poll each worker's staged backlog
        and stream it to the device mirror when the row or age threshold
        trips. The due check takes no lock; a drain takes the worker's
        ingest lock briefly."""
        cadence = max(0.01, min(1.0, self.config.micro_fold_max_age_s / 2.0,
                                self.interval / 20.0))
        while not self._shutdown.wait(cadence):
            for i, worker in enumerate(self.workers):
                try:
                    if worker.micro_fold_due():
                        with self._worker_locks[i]:
                            worker.micro_fold_once()
                except Exception:
                    if self._shutdown.is_set():
                        return
                    # the staging plane keeps every sample, so the flush
                    # still folds the epoch; the error must be seen
                    log.exception("micro-fold drain failed (worker %d)", i)

    def _read_metric_socket(self, sock: socket.socket,
                            handoff_capable: bool = True) -> None:
        """Tight recv loop (reference ReadMetricSocket, server.go:1123);
        reads max_length+1 so overlong datagrams are detectable. The
        timeout lets a handoff quiesce the reader without closing the
        socket, so datagrams queue in the kernel buffer for the next
        process image. A path-based unixgram socket re-binds instead of
        riding the handoff (``handoff_capable=False``): it reads on until
        shutdown, since its queue would die with it."""
        bufsize = self.config.metric_max_length + 1
        sock.settimeout(0.5)
        while not (self._shutdown.is_set()
                   or (handoff_capable and self._quiesce.is_set())):
            try:
                data = sock.recv(bufsize)
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed during shutdown
            self.process_metric_packet(data)

    def start_statsd_tcp(self, addr: str, port: int) -> int:
        """Line-delimited statsd over TCP, with TLS when ``tls_key`` and
        ``tls_certificate`` are set and mutual TLS with
        ``tls_authority_certificate`` (reference server.go:1254-1335, TLS
        setup :438-472). A plain connection goes to a C++ line-stream
        reader with native readers on; TLS stays on Python (ssl wraps the
        socket object). Returns the bound port."""
        sock = self._adopt_fd()  # an inherited fd is already listening
        if sock is None:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.bind((addr, port))
            sock.listen(128)
        bound_port = sock.getsockname()[1]
        self._sockets.append(sock)

        ssl_ctx = None
        if self.config.tls_key and self.config.tls_certificate:
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(self.config.tls_certificate,
                                    self.config.tls_key)
            if self.config.tls_authority_certificate:
                ssl_ctx.load_verify_locations(
                    self.config.tls_authority_certificate)
                ssl_ctx.verify_mode = ssl.CERT_REQUIRED

        def accept_loop():
            # quiesce-able: a handoff leaves connections in the backlog
            sock.settimeout(0.5)
            while not (self._shutdown.is_set() or self._quiesce.is_set()):
                try:
                    conn, peer = sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                conn.settimeout(None)
                if (ssl_ctx is None and self.native_mode
                        and self.config.tpu_native_readers):
                    # the C++ reader owns a dup of the fd and closes it;
                    # the pump reaps finished readers
                    fd = os.dup(conn.fileno())
                    try:
                        h = self._native_router.start_stream_reader(
                            fd, self.config.metric_max_length)
                    except RuntimeError:
                        os.close(fd)
                        conn.close()
                        raise
                    self.stats.count("tcp.connects", 1)
                    with self._native_reader_lock:
                        self._native_stream_readers.append(h)
                    conn.close()
                    self._start_native_pump()
                    continue
                self._spawn(
                    lambda c=conn, p=peer: self._handle_tcp_conn(c, p,
                                                                 ssl_ctx),
                    "statsd-tcp-conn")

        self._spawn(accept_loop, "statsd-tcp-accept")
        return bound_port

    def _handle_tcp_conn(self, conn: socket.socket, peer, ssl_ctx) -> None:
        """reference handleTCPGoroutine (server.go:1254-1335)."""
        self.stats.count("tcp.connects", 1)
        self._track_conn(conn, True)
        try:
            if ssl_ctx is not None:
                try:
                    conn = ssl_ctx.wrap_socket(conn, server_side=True)
                except (ssl.SSLError, OSError):
                    # a peer resetting mid-handshake raises a plain
                    # ConnectionResetError, not ssl.SSLError
                    self.stats.count("tcp.tls_handshake_failures", 1)
                    raise
            conn.settimeout(10.0 * self.interval)
            buf = b""
            while not self._shutdown.is_set():
                data = conn.recv(65536)
                if not data:
                    break
                buf += data
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if len(line) > self.config.metric_max_length:
                        self._bump_errors()
                        continue
                    if line:
                        self.handle_metric_packet(line)
            # a trailing partial line without a newline still counts
            if buf and len(buf) <= self.config.metric_max_length:
                self.handle_metric_packet(buf)
        except (OSError, ssl.SSLError) as e:
            log.debug("tcp statsd conn from %s error: %s", peer, e)
        finally:
            self.stats.count("tcp.disconnects", 1)
            self._track_conn(conn, False)
            try:
                conn.close()
            except OSError:
                pass

    def _bind_unix_socket(self, path: str, sock_type: int) -> socket.socket:
        """Bind a unix socket with flock exclusivity (reference
        acquireLockForSocket, networking.go:289-306): ``<path>.lock`` is
        flocked before a stale socket file is unlinked, so two servers
        never steal each other's socket. Abstract sockets (``@name``)
        need no lock."""
        if path.startswith("@"):
            addr: bytes | str = "\0" + path[1:]
        else:
            import fcntl

            lock_path = path + ".lock"
            fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                raise RuntimeError(
                    f"socket {path!r} is locked by another veneur instance "
                    f"(flock on {lock_path!r} held)")
            self._socket_locks.append(fd)
            if os.path.exists(path):
                os.unlink(path)
            addr = path
        sock = socket.socket(socket.AF_UNIX, sock_type)
        sock.bind(addr)
        self._sockets.append(sock)
        return sock

    def start_statsd_unixgram(self, path: str) -> None:
        """DogStatsD over a unix datagram socket (reference
        networking.go:144-196): a C++ reader with native readers on, as
        on UDP, else a Python reader."""
        sock = self._bind_unix_socket(path, socket.SOCK_DGRAM)
        if self.native_mode and self.config.tpu_native_readers:
            self._start_native_metric_reader(sock)
            return
        self._spawn(
            lambda: self._read_metric_socket(sock, handoff_capable=False),
            "statsd-unixgram")

    def start_listeners(self) -> dict[str, int]:
        """Start every configured statsd listener (udp://, tcp://,
        unixgram://); returns the resolved ports keyed by address."""
        ports = {}
        for spec in self.config.statsd_listen_addresses:
            proto, _, rest = spec.partition("://")
            self._adopt = list(self._inherited.pop(spec, []))
            before = len(self._sockets)
            if proto == "udp":
                host, _, port = rest.rpartition(":")
                ports[spec] = self.start_statsd_udp(host or "127.0.0.1",
                                                    int(port))
            elif proto == "tcp":
                host, _, port = rest.rpartition(":")
                ports[spec] = self.start_statsd_tcp(host or "127.0.0.1",
                                                    int(port))
            elif proto == "unixgram":
                self.start_statsd_unixgram(rest)
            else:
                raise ValueError(f"unsupported statsd listener {spec!r}")
            if proto in ("udp", "tcp"):
                self._listener_fds[spec] = [
                    s.fileno() for s in self._sockets[before:]]
            self._close_unused_adopted()
        return ports

    def prepare_handoff(self) -> dict[str, list[int]]:
        """Mark every network listener fd inheritable and return the
        spec -> fds manifest for the next process image (einhorn-style
        zero-downtime restart, reference server.go:1401-1429). The reader
        and accept loops stop first, the sockets stay open: datagrams
        queue in the kernel buffers and connections wait in the listen
        backlog for the successor. After this, shutdown() leaves those
        fds open."""
        self._handoff = True
        self._quiesce.set()
        self._stop_native_readers()  # joins; the fds stay open
        deadline = time.time() + 2.0
        for t in self._threads:
            if t.name.startswith(("statsd-udp", "ssf-udp",
                                  "statsd-tcp-accept")):
                t.join(timeout=max(0.0, deadline - time.time()))
        for fds in self._listener_fds.values():
            for fd in fds:
                try:
                    os.set_inheritable(fd, True)
                except OSError:
                    log.warning("fd %d not inheritable; it will re-bind", fd)
        return dict(self._listener_fds)

    def start(self) -> dict[str, int]:
        """Start sinks, the span worker, listeners and the flush ticker
        (reference Server.Start, server.go:826)."""
        if self.config.enable_profiling:
            self._start_profiler()
        # durable spill: attach + replay journals BEFORE sinks start, so
        # a prior incarnation's journaled payloads sit in the spill and
        # go out ahead of fresh data at the first flush (retry_spill)
        self._attach_journals()
        for sink in self.metric_sinks + self.span_sinks:
            sink.start()
        self.span_worker.start()
        ports = self.start_listeners()
        for spec, port in self.start_ssf_listeners().items():
            # the same spec on both lists: the SSF port does not shadow
            # the statsd one
            ports["ssf:" + spec if spec in ports else spec] = port
        # inherited fds whose listener left the configuration: closed, or
        # the old port stays bound with no reader and swallows traffic
        for spec, fds in self._inherited.items():
            log.warning("closing %d inherited fds of removed listener %s",
                        len(fds), spec)
            for fd in fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
        self._inherited.clear()
        ports.update(self._start_query_listeners())
        if self.flush_pipeline is not None:
            # the stage threads exist before the first tick enqueues
            self.flush_pipeline.start()
        # what the process holds now (the server's structures and all it
        # built before) stays out of the collector's passes until the
        # last server started in the process shuts down: a full pass over
        # a large heap took seconds, and one landing in a flush missed
        # the interval (F8)
        _freeze_heap()
        self._heap_frozen = True
        self._spawn(self._flush_loop, "flush-ticker", compute=True)
        if self.config.micro_fold:
            self._spawn(self._micro_fold_loop, "micro-fold", compute=True)
        if self.native_mode:
            self._spawn(self._series_sync_loop, "series-sync", compute=True)
        return ports

    def _start_profiler(self) -> None:
        """``enable_profiling``: a torch.profiler trace of host and CUDA
        activity from here to shutdown, written as a Chrome trace into
        ``profile_dir`` (the JAX package records an XLA profile here;
        the reference's profile.Start, server.go:1392-1399). The profile
        lives on a thread of its own, which starts and stops it: the
        profiler's session belongs to the thread that opened it, and
        shutdown may run on any thread (/quitquitquit's). A profiler that
        cannot start is logged; nothing else depends on it."""
        started = threading.Event()
        self._profile_stop = threading.Event()

        def run() -> None:
            try:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                kw = {}
                try:
                    # the host ops of every thread (the flush runs on the
                    # ticker's); CUDA kernels are traced process-wide
                    # either way. A torch without the option records the
                    # ops of this thread only
                    from torch._C._profiler import _ExperimentalConfig

                    kw["experimental_config"] = _ExperimentalConfig(
                        profile_all_threads=True)
                except (ImportError, TypeError):
                    pass
                prof = profile(activities=acts, **kw)
                prof.__enter__()
            except Exception:
                log.exception("could not start the torch profiler")
                started.set()
                return
            self._profiler = prof
            started.set()
            self._profile_stop.wait()
            try:
                prof.__exit__(None, None, None)
                os.makedirs(self._profile_dir(), exist_ok=True)
                # a re-exec keeps the pid: the clock tells the images apart
                path = os.path.join(
                    self._profile_dir(),
                    f"veneur-{os.getpid()}-{time.time_ns()}.trace.json")
                prof.export_chrome_trace(path)
                log.info("profile written to %s", path)
            except Exception:
                log.exception("could not write the torch profile")

        t = threading.Thread(target=run, name="profiler", daemon=True)
        t.start()
        started.wait()
        self._profile_thread = t
        if self._profiler is not None:
            log.info("profiling enabled -> %s", self._profile_dir())

    def _profile_dir(self) -> str:
        return self.config.profile_dir or "veneur-tpu-profile"

    def _stop_profiler(self) -> None:
        """Stop the profile and write its Chrome trace (on the profile's
        own thread); a no-op when none runs."""
        t, self._profile_thread = self._profile_thread, None
        if t is None:
            return
        self._profile_stop.set()
        t.join(timeout=120)
        self._profiler = None

    def _start_query_listeners(self) -> dict[str, int]:
        """Bind the live query fronts (``query_listen_addrs``): http://
        serves /metrics, /query and /healthz, grpc:// serves
        veneurtpu.Query/Query. A front that fails to bind is logged and
        skipped: ingest goes on. Returns {spec: bound port}."""
        ports: dict[str, int] = {}
        if self.query_engine is None:
            return ports
        for spec in self.config.query_listen_addrs:
            scheme, _, hostport = spec.partition("://")
            try:
                if scheme == "grpc":
                    from veneur_tpu_torch.query.service import (
                        make_query_server)

                    server, port = make_query_server(
                        self.query_engine, hostport)
                else:
                    from veneur_tpu_torch.query.http import make_http_server

                    server, port = make_http_server(
                        self.query_engine, hostport)
            except Exception:
                log.exception("query listener %s failed to start", spec)
                continue
            self._query_servers.append((scheme, server))
            ports[spec] = port
            log.info("query listener on %s (port %d)", spec, port)
        return ports

    def _attach_journals(self) -> None:
        """Back every journalable sink's delivery spill with a
        write-ahead journal under <spill_journal_dir>/sink-<name>/ and
        replay whatever a prior incarnation left unacked. Managers that
        refuse (journal_exempt — splunk's send-once semantics) stay
        RAM-only. No spill_journal_dir = no-op, byte-identical to the
        in-RAM behaviour."""
        jdir = self.config.spill_journal_dir
        if not jdir:
            return
        from veneur_tpu_torch.sinks.journal_codec import make_entry_codec
        from veneur_tpu_torch.utils.journal import SpillJournal

        encode, decode = make_entry_codec()
        for rname, man in self._delivery_managers():
            if getattr(man, "journal_exempt", False):
                log.info("sink %s: spill journal skipped (send-once "
                         "semantics)", rname)
                continue
            journal = SpillJournal(
                os.path.join(jdir, f"sink-{rname}"),
                fsync=self.config.spill_journal_fsync,
                max_bytes=self.config.spill_journal_max_bytes,
                max_segments=self.config.spill_journal_max_segments,
                log=log.warning)
            if not man.attach_journal(journal, encode):
                journal.close()
                continue
            self._journals[rname] = journal
            n = man.recover(decode)
            if n:
                log.info("sink %s: %d journaled payload(s) recovered, "
                         "will retry ahead of fresh data", rname, n)

    def graceful_drain(self, deadline_s: Optional[float] = None) -> dict:
        """SIGTERM contract: final-epoch flush, then bounded delivery/
        spill-settling passes, with honest shutdown.* counters for
        whatever the deadline clips. Returns (and stores on
        self.shutdown_stats) the drain ledger; call before shutdown().

        With the journal on, clipped payloads stay durable and the next
        incarnation recovers them — the deadline bounds shutdown
        LATENCY, never silently converts spill into loss."""
        if deadline_s is None:
            deadline_s = self.config.shutdown_drain_deadline_s
        t0 = time.monotonic()
        deadline = t0 + max(0.0, float(deadline_s))
        stats: dict = {"deadline_s": float(deadline_s),
                       "final_flush": False, "drained_payloads": 0,
                       "drain_passes": 0}
        # 1) final-epoch swap + flush of whatever the last interval
        #    accumulated
        if deadline_s > 0:
            try:
                self.flush()
                stats["final_flush"] = True
            except Exception:  # noqa: BLE001 — drain anyway
                log.exception("graceful drain: final flush failed")
        # 2) bounded spill-settling passes across every manager until
        #    the spill is empty or the deadline clips
        managers = self._delivery_managers()
        while time.monotonic() < deadline:
            remaining = deadline - time.monotonic()
            spilled = 0
            for _, man in managers:
                if len(man.spill):
                    man.begin_flush(remaining)
                    stats["drained_payloads"] += man.retry_spill()
                spilled += len(man.spill)
            stats["drain_passes"] += 1
            if not spilled:
                break
            time.sleep(min(0.05, max(0.0, deadline - time.monotonic())))
        # 3) the honest remainder: what the deadline clipped
        left_payloads = left_bytes = 0
        for _, man in managers:
            s = man.stats()
            left_payloads += s["spilled_payloads"]
            left_bytes += s["spilled_bytes"]
        for journal in self._journals.values():
            journal.sync()
        stats.update({
            "clipped_payloads": left_payloads,
            "clipped_bytes": left_bytes,
            "deadline_clipped": left_payloads > 0,
            "journal_pending_records": sum(
                j.pending_records() for j in self._journals.values()),
            "duration_s": round(time.monotonic() - t0, 3),
        })
        self.shutdown_stats = stats
        self.stats.count("shutdown.drained_payloads",
                         stats["drained_payloads"])
        self.stats.count("shutdown.clipped_payloads", left_payloads)
        self.stats.count("shutdown.clipped_bytes", left_bytes)
        if left_payloads:
            log.warning(
                "graceful drain clipped by deadline: %d payload(s) / %d "
                "bytes still spilled%s", left_payloads, left_bytes,
                " (journaled for the next incarnation)"
                if self._journals else "")
        else:
            log.info("graceful drain complete in %.3fs (%d payload(s) "
                     "re-delivered)", stats["duration_s"],
                     stats["drained_payloads"])
        return stats

    # -- flush --------------------------------------------------------------

    def _flush_loop(self) -> None:
        """The interval ticker, aligned to the wall clock with
        ``synchronize_with_interval`` (reference server.go:908-946). After
        every flush the spill-cap loop adapts the caps to how long it
        took; pipelined, a tick only swaps and enqueues, and the caps grow
        back only (the stages' backlog, not their duration, is the
        overload signal: the pipeline sheds through _pipeline_overrun)."""
        if self.config.synchronize_with_interval:
            if self._shutdown.wait(calculate_tick_delay(self.interval,
                                                        time.time())):
                return
        next_tick = time.time()
        while not self._shutdown.is_set():
            next_tick += self.interval
            delay = next_tick - time.time()
            if delay > 0 and self._shutdown.wait(delay):
                return
            try:
                t0 = time.perf_counter()
                if self.flush_pipeline is not None:
                    outcome = self.flush_pipeline.tick()
                    self.last_tick_s = time.perf_counter() - t0
                    if outcome == "ok":
                        self._adapt_spill_caps(
                            max(self.last_tick_s,
                                self.flush_pipeline.last_cycle_s),
                            allow_shrink=False)
                else:
                    self.flush()
                    self.last_tick_s = time.perf_counter() - t0
                    self._adapt_spill_caps(self.last_tick_s)
            except Exception:
                log.exception("flush failed")

    def _pipeline_overrun(self) -> None:
        """A flush-pipeline stage fell a full interval behind (a deferred
        tick or a shed interval): treated as a flush that took the whole
        interval, so the spill-cap loop halves the caps instead of letting
        the queues grow (health/policy.py MAX_STAGE_BACKLOG)."""
        self._adapt_spill_caps(self.interval)

    def _adapt_spill_caps(self, flush_dur: float,
                          allow_shrink: bool = True) -> None:
        """Closed-loop overload shedding: bound the backlog one flush can
        inherit so the flush fits the interval. A flush longer than 0.9 of
        the interval halves every worker's spill cap (native contexts and
        reader contexts included) down to a floor of 65,536, so overload
        sheds earlier at the parse boundary, counted, and the cadence
        holds; a flush shorter than 0.3 of the interval doubles it back
        toward ``tpu_spill_cap``. Each change gauges ``ingest.spill_cap``.
        The reference's counterparts are fixed-size worker channels
        (worker.go:31-48) and the watchdog (server.go:948-990)."""
        ceiling = self.config.tpu_spill_cap
        floor = min(1 << 16, ceiling)
        cur = self._spill_cap_now
        if allow_shrink and flush_dur > 0.9 * self.interval:
            new = max(floor, cur >> 1)
        elif flush_dur < 0.3 * self.interval:
            new = min(ceiling, cur << 1)
        else:
            return
        if new == cur:
            return
        self._spill_cap_now = new
        self.stats.gauge("ingest.spill_cap", new)
        for i, w in enumerate(self.workers):
            # under the worker's ingest lock: it orders the cap write
            # against a swap's drain and reset of the contexts
            with self._worker_locks[i]:
                w.spill_cap = new
                if w._native is not None:
                    w._native.set_spill_cap(new)
                    for ctx in w._reader_ctxs:
                        ctx.set_spill_cap(new)

    def flush(self, now: Optional[float] = None):
        """One flush pass (reference Server.Flush, flusher.go:28-134):
        swap every worker under its lock, extract the swapped epochs,
        generate the interval's metrics, emit to the sinks.

        Returns the ColumnarMetrics batch when a metric sink exists
        (len() works; call .materialize() for objects), else the
        list[InterMetric]. `now` pins the interval's timestamp.

        The governor brackets the whole flush (its in-flight mark and
        progress beats are what the watchdog's deferral rule reads, so
        end_flush runs even when a phase raises). Self-traced: every
        flush is a span (reference tracer.StartSpan("flush"),
        flusher.go:29) that finishes after the flush, rejoins this
        server's span pipeline and derives at the next flush."""
        with self._flush_lock:
            self.flush_governor.begin_flush()
            try:
                with self.tracer.start_span("flush"):
                    return self._flush_inner(now)
            finally:
                self.flush_governor.end_flush()

    def _flush_inner(self, now: Optional[float]):
        """The four flush phases in turn. The flush pipeline
        (core/pipeline.py) runs the same four on its stage threads, which
        is what keeps its output bitwise the serial flush's."""
        job = self._flush_begin(now)
        self._flush_extract(job)
        self._flush_generate(job)
        self._flush_emit(job)
        return job.batch if job.batch is not None else job.final

    def _flush_begin(self, now: Optional[float] = None) -> FlushJob:
        """The tick's phase: the epoch closes under each worker's ingest
        lock (the map-swap analog of worker.go:498-517), with no device
        readback. Freezes the interval's timestamp in the job, so a
        pipelined generation a whole interval later stamps the same."""
        flush_start = time.time() if now is None else float(now)
        self.last_flush_unix = flush_start
        self.flush_count += 1
        self.stats.gauge("flush.flush_timestamp_ns", flush_start * 1e9)
        phases: dict[str, float] = {}
        if self.native_mode:
            # event and service-check lines and SSF hand-backs still
            # buffered in C++; those landing after this are caught by swap
            # with the epoch close
            self._drain_native_events()
            self._drain_native_ssf_fallbacks()
        other_samples = self.event_worker.flush()
        if other_samples:
            self.stats.count("worker.other_samples_flushed_total",
                             len(other_samples))
        for sink in self.metric_sinks:
            try:
                sink.flush_other_samples(other_samples)
            except Exception:
                log.exception("sink %s FlushOtherSamples failed",
                              sink.name())
        _t = time.perf_counter()
        if self.span_pipeline is not None:
            # the interval's span batches derive into the workers before
            # the swap, so a span's metrics land in the epoch of the
            # statsd samples that arrived beside it
            self.span_pipeline.flush()
        self.span_worker.flush()
        phases["span_flush_s"] = time.perf_counter() - _t
        self.stats.time_in_nanoseconds("worker.span.flush_duration_ns",
                                       phases["span_flush_s"] * 1e9)
        # per-service span counts (reference handleSSF's counters,
        # reported at flush, server.go:1088-1101)
        with self._ssf_stats_lock:
            span_counts = self.ssf_spans_received
            self.ssf_spans_received = {}
        qs = device_quantiles(self.percentiles, self.aggregates)
        _t = time.perf_counter()
        swapped = []
        for i, (worker, lock) in enumerate(zip(self.workers,
                                               self._worker_locks)):
            with lock:
                if i == 0 and self._native_ssf:
                    # in the same lock hold as the swap, which resets the
                    # C++ context: a span landing between a separate drain
                    # and the reset would lose its service count. Native
                    # spans never pass handle_ssf, so they join the
                    # conservation tallies here
                    for svc, n in (
                            worker._native.drain_ssf_services().items()):
                        span_counts[svc] = span_counts.get(svc, 0) + n
                        self._spans_native_total += n
                # the reference's per-worker tallies, read before the
                # swap resets the epoch's counts
                self.stats.count("worker.metrics_processed_total",
                                 worker.processed, tags=[f"worker:{i}"])
                self.stats.count("worker.metrics_imported_total",
                                 worker.imported, tags=[f"worker:{i}"])
                if worker.overload_dropped:
                    # samples shed at the spill caps (drop-don't-block):
                    # sustained nonzero means the host cannot keep up
                    self.stats.count("ingest.overload_dropped_total",
                                     worker.overload_dropped,
                                     tags=[f"worker:{i}"])
                    worker.overload_dropped = 0
                swapped.append(worker.swap(qs))
                if worker._reader_ctxs:
                    self._count_reader_shards(worker)
                if self.tenant_ledger is not None:
                    self._count_tenant_tallies(i, worker)
        # lines and SSF payloads the contexts handed back at epoch close
        # belong to the new epoch; handled outside the worker locks (they
        # re-enter _route)
        for worker in self.workers:
            lines, worker.pending_other_lines = worker.pending_other_lines, []
            for line in lines:
                self.handle_metric_packet(line)
            pkts, worker.pending_ssf_fallback = (
                worker.pending_ssf_fallback, [])
            for pkt in pkts:
                self.handle_trace_packet(pkt)
        phases["swap_s"] = time.perf_counter() - _t
        # the micro-folds that streamed the closed epoch to the device
        # mirrors, and the swap's residual drain and mirror handoff
        micro_folds = sum(w.micro_folds_swapped for w in self.workers)
        phases["drain_s"] = sum(w.micro_drain_swapped_s
                                for w in self.workers)
        self.last_micro_folds = micro_folds
        if micro_folds:
            self.stats.count("worker.micro_folds_total", micro_folds)
        self.flush_governor.beat()  # swap complete: the flush is live
        return FlushJob(ts=int(flush_start), flush_start=flush_start, qs=qs,
                        swapped=swapped, span_counts=span_counts,
                        phases=phases)

    def _count_reader_shards(self, worker: DeviceWorker) -> None:
        """Per-reader commits and sheds as deltas of the contexts'
        lifetime attribution, read just after the swap's fence settled
        it. Caller holds the worker's lock."""
        rs = worker.reader_stats(lock_stats=self._lock_stats_enabled)
        for kind, stat in (("committed", "ingest.reader_committed_total"),
                           ("dropped", "ingest.reader_dropped_total")):
            for j, total in enumerate(rs[kind]):
                delta = total - self._reader_reported.get((kind, j), 0)
                if delta:
                    self.stats.count(stat, delta, tags=[f"reader:{j}"])
                self._reader_reported[(kind, j)] = total

    def _flush_extract(self, job: FlushJob) -> None:
        """The device phase: each worker's swapped epoch folded and read
        back, off the ingest locks (next-interval ingest goes on), then
        the guard's maintenance under the lock, then the query commit."""
        _t = time.perf_counter()
        for i, (worker, sw) in enumerate(zip(self.workers, job.swapped)):
            try:
                job.snaps.append(
                    worker.extract_snapshot(sw, job.qs, self.interval))
            except Exception:
                log.exception("flush extraction failed for worker %d", i)
            self.flush_governor.beat()  # one worker's extraction done
            # guard maintenance mutates the live epoch (quarantine to the
            # CPU, probe, re-admission): under the ingest lock
            with self._worker_locks[i]:
                worker.device_guard_tick()
            g = worker.guard
            if (g.last_fault is not None
                    and g.last_fault != self._guard_last_fault.get(i)):
                # each new classified fault reaches the governor once, so
                # a watchdog verdict right after names the device error
                self._guard_last_fault[i] = g.last_fault
                self.flush_governor.note_fault(
                    g.last_fault + (f" — {g.trip_reason}"
                                    if g.trip_reason else ""))
        if self.query_engine is not None:
            # after every worker extracted: the query surface flips to
            # the new epoch at once across workers
            self.query_engine.commit(job.ts)
        for snap in job.snaps:
            d = snap.directory
            for mtype, n in (("counter", len(snap.scalars.counter_meta)),
                             ("gauge", len(snap.scalars.gauge_meta)),
                             ("histogram", d.num_histo_rows),
                             ("set", d.num_set_rows)):
                if n:
                    self.stats.count("worker.metrics_flushed_total", n,
                                     tags=[f"metric_type:{mtype}"])
        job.phases["extract_s"] = time.perf_counter() - _t
        # the flush's transfer books (health/ledger.py) and chunk report
        h2d = sum(w.ledger.flush_h2d_bytes() for w in self.workers)
        d2h = sum(w.ledger.flush_d2h_bytes() for w in self.workers)
        self.last_flush_transfers = {"h2d_bytes": h2d, "d2h_bytes": d2h}
        if h2d or d2h:
            self.stats.count("flush.transfer_h2d_bytes", h2d)
            self.stats.count("flush.transfer_d2h_bytes", d2h)
        report = self.flush_governor.last_report
        self.last_flush_chunks = report
        if "chunks" in report:
            self.stats.gauge("flush.extract_chunks", report["chunks"])
            self.stats.time_in_nanoseconds("flush.extract_chunk_max_ns",
                                           report["chunk_max_s"] * 1e9)

    def _flush_generate(self, job: FlushJob) -> None:
        """Generation: columnar whenever a metric sink or a plugin exists
        (sinks that cannot consume columns, and TSV plugins, share the
        batch's one materialization), stamped with the job's tick time;
        then a local's forward starts on a thread of its own."""
        _t = time.perf_counter()
        batch = None
        if self.metric_sinks or self.plugins:
            for snap in job.snaps:
                b = generate_columnar(snap, self.is_local, self.percentiles,
                                      self.aggregates, now=job.ts,
                                      governor=self.flush_governor)
                if batch is None:
                    batch = b
                else:
                    batch.groups.extend(b.groups)
                    batch.extras.extend(b.extras)
            job.n_flushed = batch.count() if batch is not None else 0
        else:
            for snap in job.snaps:
                job.final.extend(generate_inter_metrics(
                    snap, self.is_local, self.percentiles, self.aggregates,
                    now=job.ts, governor=self.flush_governor))
            job.n_flushed = len(job.final)
        job.batch = batch
        job.phases["generate_s"] = time.perf_counter() - _t
        if self.is_local and self.forwarder is not None:
            # the latest forward's thread is kept so shutdown (or a
            # caller) can join it
            self._forward_thread = threading.Thread(
                target=self.forwarder, args=(job.snaps,), daemon=True,
                name="forward")
            self._forward_thread.start()

    def _flush_emit(self, job: FlushJob) -> None:
        """Emission, one thread per sink outside the worker locks (the
        object path runs only without metric sinks and plugins, so it
        emits nothing), then the plugin pass, then the flush's
        self-telemetry. Rebinds last_flush_phases last, so observers read
        the newest finished flush."""
        phases = job.phases
        batch = job.batch
        _t = time.perf_counter()
        threads = []
        plugin_input = None
        if batch is not None and job.n_flushed:
            for sink in self.metric_sinks:
                threads.append(self._spawn_sink(
                    self._flush_sink_columnar, f"flush-{sink.name()}",
                    sink, batch, self.sink_excluded_tags.get(sink.name())))
            plugin_input = batch
        elif job.final:
            plugin_input = job.final
        else:
            # quiet tick: the sinks' flushes do not run, but spilled
            # payloads must keep draining (and an open breaker must get
            # its half-open probe)
            for rname, man in self._delivery_managers():
                if not len(man.spill):
                    continue

                def _drain(m=man):
                    m.begin_flush()
                    m.retry_spill()

                threads.append(self._spawn_sink(
                    _drain, f"spill-drain-{rname}"))
        for th in threads:
            th.join(timeout=self.interval)
        if threads or (batch is not None and job.n_flushed):
            phases["sink_flush_s"] = time.perf_counter() - _t
        if self.plugins and plugin_input is not None:
            self._run_plugins_clipped(plugin_input, phases)
        if self.config.count_unique_timeseries:
            self.last_unique_timeseries = self._tally_timeseries(job.snaps)
            self.stats.count(
                "flush.unique_timeseries_total", self.last_unique_timeseries,
                tags=[f"global_veneur:{str(not self.is_local).lower()}"])
        self.stats.count("flush.post_metrics_total", job.n_flushed)
        self._count_span_telemetry(job.span_counts)
        self._count_plugin_telemetry()
        if self.query_engine is not None:
            served = self.query_engine.queries_served
            failed = self.query_engine.queries_failed
            if served - self._query_reported[0]:
                self.stats.count("query.served_total",
                                 served - self._query_reported[0])
            if failed - self._query_reported[1]:
                self.stats.count("query.errors_total",
                                 failed - self._query_reported[1])
            self._query_reported = (served, failed)
        for name, secs in phases.items():
            self.stats.time_in_nanoseconds(
                "flush.phase_duration_ns", secs * 1e9,
                tags=[f"phase:{name.removesuffix('_s')}"])
        self._count_device_telemetry()
        # statsd counters are per-interval increments: the delta, never
        # negative (a pump drain can race the property's reads)
        errors_now = max(self.parse_errors, self._errors_reported)
        self.stats.count("packet.error_total",
                         errors_now - self._errors_reported)
        self._errors_reported = errors_now
        self._count_delivery_telemetry()
        self._count_forward_telemetry()
        led = self.tenant_ledger
        if led is not None:
            # which tenant spends the cardinality budget: live and refused
            # series from the shared ledger, shed samples from the governor
            for t, n in led.live_counts().items():
                self.stats.gauge("tenant.series_live", float(n),
                                 tags=[f"tenant:{t}"])
            for t, n in led.series_rejected_counts().items():
                self.stats.gauge("tenant.series_rejected", float(n),
                                 tags=[f"tenant:{t}"])
            for t, n in self.flush_governor.tenant_shed_counts().items():
                self.stats.gauge("tenant.shed_samples", float(n),
                                 tags=[f"tenant:{t}"])
        # runtime gauges (the reference's Go runtime stats,
        # flusher.go:32-47): completed collections and the current RSS
        self.stats.gauge("gc.number", float(
            sum(s["collections"] for s in gc.get_stats())))
        rss = current_rss_bytes()
        if rss is not None:
            self.stats.gauge("mem.rss_bytes", float(rss))
        # from the tick's clock: under the pipeline this includes the
        # queue waits between stages, the interval's real latency
        self.stats.time_in_nanoseconds(
            "flush.total_duration_ns", (time.time() - job.flush_start) * 1e9)
        self.last_flush_phases = phases
        self.last_emit_unix = time.time()

    def _count_device_telemetry(self) -> None:
        """The device fault domain's counts: flushes completed on the CPU
        and every guard counter as interval deltas per worker, and the
        quarantined workers as a gauge."""
        fallbacks = self.host_fallbacks
        if fallbacks - self._host_fallbacks_reported:
            self.stats.count("flush.host_fallbacks",
                             fallbacks - self._host_fallbacks_reported)
        self._host_fallbacks_reported = fallbacks
        for i, w in enumerate(self.workers):
            for key, total in w.guard.counters().items():
                delta = total - self._guard_counters_reported.get((i, key), 0)
                if delta:
                    self._guard_counters_reported[(i, key)] = total
                    self.stats.count(key, delta, tags=[f"worker:{i}"])
        self.stats.gauge("device.guard.quarantined_workers",
                         self.quarantined_workers)

    def _count_delivery_telemetry(self) -> None:
        """Every delivery manager's lifetime counters as interval deltas,
        its breaker and spill as gauges. A sink behind (breaker not
        closed, or fresh deferrals) for DELIVERY_BEHIND_INTERVALS flushes
        in a row signals the pipeline to shed; a serial server's emission
        already holds the tick back, so it sheds nothing for a dead
        backend the other sinks still take. The tenant-aware spill
        eviction is wired here too, so sinks attached after construction
        get it."""
        behind = False
        for rname, man in self._delivery_managers():
            if (self.tenant_ledger is not None
                    and man.abusive_tenants is None):
                man.abusive_tenants = self.tenant_ledger.over_budget
            dstats = man.stats()
            tags = [f"sink:{rname}"]
            for key in DELIVERY_STAT_COUNTERS:
                total = dstats[key]
                delta = total - self._delivery_reported.get((rname, key), 0)
                self._delivery_reported[(rname, key)] = total
                if delta:
                    self.stats.count(f"delivery.{key}", delta, tags=tags)
                    if key == "deferred_payloads":
                        behind = True
            self.stats.gauge("delivery.circuit_state",
                             float(dstats["circuit_state_code"]), tags=tags)
            self.stats.gauge("delivery.spilled_payloads",
                             float(dstats["spilled_payloads"]), tags=tags)
            self.stats.gauge("delivery.spilled_bytes",
                             float(dstats["spilled_bytes"]), tags=tags)
            if dstats["circuit_state"] != "closed":
                behind = True
        self._delivery_behind_consec = (
            self._delivery_behind_consec + 1 if behind else 0)
        if (self.flush_pipeline is not None
                and delivery_should_signal_behind(
                    self._delivery_behind_consec)):
            self.stats.count("flush.delivery_behind_total", 1)
            self.flush_pipeline.note_downstream_behind()

    def _count_forward_telemetry(self) -> None:
        """A local forwarder's lifetime counters as interval deltas, per
        proxy destination (proxy:<addr>) and for the spread as a whole."""
        fwd = self.forwarder
        if fwd is None or not hasattr(fwd, "forward_stats"):
            return
        try:
            fstats = fwd.forward_stats()
        except Exception:  # telemetry must not fail the flush
            log.exception("forwarder stats failed")
            return
        if not fstats:
            return

        def delta(key, total) -> int:
            d = total - self._forward_reported.get(key, 0)
            self._forward_reported[key] = total
            return d

        for name in ("respread_total", "respread_ambiguous_total",
                     "dropped_metrics", "picks_p2c", "picks_rr"):
            total = fstats.get(name)
            if total is not None and (d := delta(("", name), total)):
                self.stats.count(f"forward.{name}", d)
        self.stats.gauge("forward.proxies", float(fstats.get("proxies", 0)))
        for addr, dest in fstats.get("destinations", {}).items():
            ptags = [f"proxy:{addr}"]
            for name in ("sent_metrics", "sent_batches", "respread_in",
                         "respread_out"):
                total = dest.get(name)
                if total is not None and (d := delta((addr, name), total)):
                    self.stats.count(f"forward.{name}", d, tags=ptags)
            for cause, total in (dest.get("errors") or {}).items():
                if d := delta((addr, f"errors.{cause}"), total):
                    self.stats.count("forward.errors_total", d,
                                     tags=ptags + [f"cause:{cause}"])
            live = bool(dest.get("live", True))
            self.stats.gauge("forward.lane_live", 1.0 if live else 0.0,
                             tags=ptags)
            if live and "depth" in dest:
                self.stats.gauge("forward.lane_depth", float(dest["depth"]),
                                 tags=ptags)

    def _count_tenant_tallies(self, i: int, worker: DeviceWorker) -> None:
        """Per-tenant refusals and sheds as deltas of worker i's lifetime
        tallies, read just after its swap (which folded the closing
        epoch, swap-time sheds included, into the totals). Caller holds
        the worker's lock."""
        life = worker.tenant_lifetime()
        for kind, stat in (("rejected", "tenant.samples_rejected_total"),
                           ("dropped", "tenant.overload_dropped_total")):
            for t, total in life[kind].items():
                k = (i, kind, t)
                delta = total - self._tenant_reported.get(k, 0)
                if delta:
                    self._tenant_reported[k] = total
                    self.stats.count(stat, delta, tags=[f"tenant:{t}"])

    def _count_span_telemetry(self, span_counts: dict[str, int]) -> None:
        """The span path's counters of this flush, as the JAX package
        sends them (lifetime tallies reported as interval deltas), into
        ``stats``."""
        for svc, n in span_counts.items():
            self.stats.count("ssf.spans.received_total", n,
                             tags=[f"service:{svc}"])
        sw = self.span_worker

        def delta(key, total) -> int:
            d = total - self._span_sink_reported.get(key, 0)
            self._span_sink_reported[key] = total
            return d

        # reference worker.go:688,716-717: ingest_timeout_total per sink,
        # hit_chan_cap for channel drops; lane_drop_total is a lane's
        # burst overflow
        for name, total in list(sw.ingest_timeouts.items()):
            d = delta(("__span_worker__", f"timeout:{name}"), total)
            if d:
                self.stats.count("worker.span.ingest_timeout_total", d,
                                 tags=[f"sink:{name}"])
        for name, total in list(sw.lane_drops.items()):
            d = delta(("__span_worker__", f"lane:{name}"), total)
            if d:
                self.stats.count("worker.span.lane_drop_total", d,
                                 tags=[f"sink:{name}"])
        d = delta(("__span_worker__", "chan_cap"), sw.spans_dropped)
        if d:
            self.stats.count("worker.span.hit_chan_cap", d)
        if self.span_pipeline is not None:
            pstats = self.span_pipeline.stats()
            pairs = (
                ("spans_ingested", "worker.span.columnar_ingested_total"),
                ("spans_derived", "worker.span.derived_total"),
                ("derived_rows", "worker.span.derived_metric_rows_total"),
                ("spans_dropped", "worker.span.pipeline_drop_total"),
                ("invalid_samples", "worker.span.invalid_samples_total"),
            )
            for attr, metric in pairs:
                d = delta(("__span_pipeline__", attr), pstats[attr])
                if d:
                    self.stats.count(metric, d)
        else:
            ext = self._extraction_sink
            with ext._stats_lock:
                ext_pairs = (
                    ("spans_seen", "worker.span.derived_total",
                     ext.spans_seen),
                    ("derived_rows", "worker.span.derived_metric_rows_total",
                     ext.derived_rows),
                    ("invalid_samples", "worker.span.invalid_samples_total",
                     ext.invalid_samples),
                )
            for attr, metric, total in ext_pairs:
                d = delta(("__extraction__", attr), total)
                if d:
                    self.stats.count(metric, d)
        # span sinks' cumulative counts (reference sinks/sinks.go:60-78)
        for sink in self.span_sinks:
            tags = [f"sink:{sink.name()}"]
            for attr, metric in (
                    ("spans_flushed", "sink.spans_flushed_total"),
                    ("spans_dropped", "sink.spans_dropped_total")):
                total = getattr(sink, attr, None)
                if total is None:
                    continue
                d = delta((sink.name(), attr), total)
                if d:
                    self.stats.count(metric, d, tags=tags)

    def _count_plugin_telemetry(self) -> None:
        """The plugins' own lifetime counters (flush errors, uploads,
        rotations) as interval deltas, tagged per plugin, so a silently
        failing archiver shows beside a failing sink."""
        for plugin in self.plugins:
            pname = plugin.name()
            tags = [f"plugin:{pname}"]
            for attr, metric in (
                    ("flush_errors", "plugins.flush_errors_total"),
                    ("uploads", "plugins.uploads_total"),
                    ("rotations", "plugins.rotations_total")):
                total = getattr(plugin, attr, None)
                if total is None:
                    continue
                delta = total - self._plugin_reported.get((pname, attr), 0)
                self._plugin_reported[(pname, attr)] = total
                if delta:
                    self.stats.count(metric, delta, tags=tags)

    def _run_plugins_clipped(self, metrics, phases: dict) -> None:
        """The plugin pass on a thread joined at the flush interval, the
        deadline the sinks get, so a hung plugin (a blocked PUT, a full
        disk) never holds the emit stage past its tick; an overrun is
        counted and finishes on its own (the thread is a daemon)."""
        t0 = time.perf_counter()
        th = self._spawn_sink(self._flush_plugins, "flush-plugins", metrics)
        th.join(timeout=self.interval)
        if th.is_alive():
            self.stats.count("plugins.flush_clipped_total", 1)
        phases["plugin_flush_s"] = time.perf_counter() - t0

    def _flush_plugins(self, metrics) -> None:
        """reference flusher.go:117-131: plugins run after the sinks, each
        on the columnar batch (iterable through its one materialization)
        or the object list. A plugin's exception is logged and counted
        as plugins.flush_errors_total."""
        for plugin in self.plugins:
            start = time.time()
            tags = [f"plugin:{plugin.name()}"]
            try:
                plugin.flush(metrics, self.hostname)
            except Exception:
                log.exception("plugin %s flush failed", plugin.name())
                self.stats.count("plugins.flush_errors_total", 1, tags=tags)
            finally:
                self.stats.time_in_nanoseconds(
                    "plugins.flush_total_duration_ns",
                    (time.time() - start) * 1e9, tags=tags)

    @staticmethod
    def _spawn_sink(target, name: str, *args) -> threading.Thread:
        th = threading.Thread(target=target, args=args, daemon=True,
                              name=name)
        th.start()
        return th

    def _flush_sink_columnar(self, sink: MetricSink, batch,
                             excluded_tags) -> None:
        start = time.time()
        error = False
        flushed = 0
        try:
            # per-sink capability negotiation: the native emit tier first
            # (native/emit.cpp, GIL released); False means the sink could
            # not take this batch natively and its Python columnar
            # formatter runs instead
            handled = (self.flush_emit_native
                       and getattr(sink, "supports_native_emit", False)
                       and sink.flush_columnar_native(batch, excluded_tags))
            fn = getattr(sink, "flush_columnar", None)
            if not handled and fn is not None:
                fn(batch, excluded_tags)
            elif not handled:
                # duck-typed sink (name()/flush() without the MetricSink
                # base): the shared materialization, routed and stripped
                metrics = filter_routed(batch.materialize(), sink.name())
                sink.flush(strip_excluded_tags(metrics, excluded_tags))
        except Exception:
            log.exception("sink %s columnar flush failed", sink.name())
            error = True
            self.stats.count("flush.error_total", 1,
                             tags=[f"sink:{sink.name()}"])
        else:
            flushed = batch.count_for(sink.name())
            self.stats.count("sink.metrics_flushed_total", flushed,
                             tags=[f"sink:{sink.name()}"])
        finally:
            seconds = time.time() - start
            self._count_sink(sink, flushed, error, seconds)
            # recorded on failure too: that is when it matters
            self.stats.time_in_nanoseconds(
                "sink.metric_flush_total_duration_ns", seconds * 1e9,
                tags=[f"sink:{sink.name()}"])

    def _tally_timeseries(self, snaps: list[FlushSnapshot]) -> int:
        """Merge per-worker unique-timeseries HLLs and estimate on the
        device (reference Server.tallyTimeseries, flusher.go:134-143),
        under the tally's own guard; after a fault, on the CPU, bitwise
        the same."""
        regs = [s.unique_timeseries_registers for s in snaps
                if s.unique_timeseries_registers is not None]
        if not regs:
            return 0
        merged = regs[0]
        for r in regs[1:]:
            merged = np.maximum(merged, r)
        precision = int(math.log2(merged.shape[-1]))

        def tally(device) -> int:
            est = hll_ops.estimate(
                hll_ops.pool_from_numpy(merged[None, :], device),
                precision=precision)
            return int(float(est.cpu()[0]))

        try:
            return self._tally_guard.call("extract", tally, self.device,
                                          retryable=True)
        except DeviceFaultError:
            return tally("cpu")

    # -- watchdog -----------------------------------------------------------

    def flush_watchdog(self) -> None:
        """Exit the process (code 2) when flushes stop, so supervision
        restarts it (reference FlushWatchdog, server.go:948-990), with
        the JAX package's progress-aware deferral (health/policy.py): an
        overdue flush whose chunks or phases keep beating defers the
        exit, counted in ``flush.watchdog_deferred_total``; a stalled
        flush, or a silent flush loop, exits as the reference does."""
        missed = self.config.flush_watchdog_missed_flushes
        if missed == 0:
            return
        while not self._shutdown.wait(self.interval):
            now = time.time()
            overdue = now - self.last_flush_unix
            if overdue <= missed * self.interval:
                continue
            defer, why = watchdog_should_defer(now, self.flush_governor,
                                               self.interval)
            if defer:
                log.warning("flush watchdog: flush %.1fs overdue but "
                            "deferring (%s)", overdue, why)
                self.stats.count("flush.watchdog_deferred_total", 1)
                continue
            log.critical("flush watchdog: no flush for %.1fs (> %d "
                         "intervals; %s); aborting", overdue, missed, why)
            os._exit(2)

    def start_watchdog(self) -> None:
        self._spawn(self.flush_watchdog, "flush-watchdog")

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> bool:
        """Stop the listeners and the ticker, drain the flush pipeline,
        then the sinks (reference Server.Shutdown, server.go:1473).
        Idempotent: /quitquitquit's thread and the CLI may both call it;
        a caller that loses the race waits for the winner's teardown and
        returns its verdict. True when every thread ended in its bounded
        join. After prepare_handoff the listener fds stay open for the
        next process image."""
        self._shutdown.set()
        with self._shutdown_once_lock:
            if self._shutdown_done:
                if not self._shutdown_complete.wait(timeout=30.0):
                    return False
                return self._shutdown_result
            self._shutdown_done = True
        try:
            self._shutdown_result = self._shutdown_teardown()
        finally:
            self._shutdown_complete.set()
        return self._shutdown_result

    def _shutdown_teardown(self) -> bool:
        """The winning shutdown() caller's teardown."""
        if self._native_router is not None:
            self._stop_native_readers()  # joins; the fds stay open
        handoff_fds = set()
        if self._handoff:
            for fds in self._listener_fds.values():
                handoff_fds.update(fds)
        for sock in self._sockets:
            try:
                if sock.fileno() in handoff_fds:
                    # the fd rides the re-exec; the kernel keeps queuing
                    # datagrams for the next process image
                    sock.detach()
                else:
                    sock.close()
            except OSError:
                pass
        # open stream connections: their reader threads end on the
        # shutdown of the socket
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for fd in self._socket_locks:
            try:
                os.close(fd)  # releases the flock
            except OSError:
                pass
        self._socket_locks.clear()
        if self.flush_pipeline is not None:
            # the admitted intervals reach the sinks before they stop;
            # bounded: a wedged sink forfeits the drain, not the shutdown
            if not self.flush_pipeline.stop(
                    drain=True, timeout=max(10.0, 2.0 * self.interval)):
                log.warning("flush pipeline did not drain within the "
                            "shutdown budget; in-flight flush data lost")
        me = threading.current_thread()
        deadline = time.time() + 10.0
        for t in self._compute_threads:
            if t is not me:
                t.join(timeout=max(0.1, deadline - time.time()))
        self.compute_threads_joined = all(
            t is me or not t.is_alive() for t in self._compute_threads)
        if self._heap_frozen:
            self._heap_frozen = False
            _thaw_heap()
        for t in self._threads:
            if t is not me:
                t.join(timeout=5.0)
        fwd_thread = self._forward_thread
        if fwd_thread is not None and fwd_thread is not me:
            fwd_thread.join(timeout=self.interval)
        self._stop_profiler()
        self.span_worker.stop()
        if self.forwarder is not None and hasattr(self.forwarder, "close"):
            try:
                self.forwarder.close()
            except Exception:
                log.exception("forwarder failed to close")
        for sink in self.metric_sinks + self.span_sinks:
            try:
                sink.stop()
            except Exception:
                log.exception("sink %s failed to stop", sink.name())
        if self.import_server is not None:
            self.import_server.stop()
        if self.import_http is not None:
            self.import_http.stop()
        for scheme, server in self._query_servers:
            try:
                if scheme == "grpc":
                    server.stop(grace=0.5)
                else:
                    server.shutdown()
                    server.server_close()
            except Exception:
                log.exception("query listener (%s) failed to stop", scheme)
        self._query_servers.clear()
        for journal in self._journals.values():
            # final durability point: whatever is still spilled survives
            # for the next incarnation's recovery
            try:
                journal.sync()
                journal.close()
            except Exception:  # noqa: BLE001 — teardown must not wedge
                log.exception("spill journal close failed")
        self._journals.clear()
        self.stats.close()
        return all(not t.is_alive() for t in self._threads if t is not me)

    @property
    def version(self) -> str:
        return __version__

    @property
    def build_date(self) -> str:
        """Analog of the reference's linker-injected BUILD_DATE (the
        import HTTP server's /builddate)."""
        return os.environ.get("VENEUR_TPU_BUILD_DATE", "dev")
