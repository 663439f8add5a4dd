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

Not in this slice (the factory refuses their config keys): SSF/TCP/TLS/
unixgram listeners, span sinks, reader shards, forwarding, imports,
proxies, query listeners, tenancy, the flush pipeline, plugins,
self-telemetry (so the unique-timeseries tally, the guard's counters and
the sinks' counts are kept, not sent).
"""

from __future__ import annotations

import logging
import math
import socket
import threading
import time
from typing import Optional

import numpy as np

from veneur_tpu_torch import __version__
from veneur_tpu_torch.core.config import Config
from veneur_tpu_torch.core.flusher import (device_quantiles,
                                           generate_columnar,
                                           generate_inter_metrics)
from veneur_tpu_torch.core.metrics import HistogramAggregates, InterMetric
from veneur_tpu_torch.core.worker import DeviceWorker, FlushSnapshot
from veneur_tpu_torch.device import resolve
from veneur_tpu_torch.ops import hll as hll_ops
from veneur_tpu_torch.ops.device_guard import (DeviceFaultError,
                                               DeviceGuard,
                                               guard_enabled_default)
from veneur_tpu_torch.protocol import dogstatsd
from veneur_tpu_torch.sinks import (MetricSink, filter_routed,
                                    strip_excluded_tags)
from veneur_tpu_torch.ssf import SSFSample

log = logging.getLogger("veneur_tpu_torch.server")


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


class Server:
    """One veneur_tpu_torch aggregation server."""

    def __init__(self, cfg: Config,
                 metric_sinks: Optional[list[MetricSink]] = None,
                 device=None) -> None:
        self.config = cfg
        self.device = resolve(device)
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
                device=self.device,
            )
            for _ in range(cfg.num_workers)
        ]
        # each flush may inherit at most half an interval of spill-fold
        # work (swap sheds the excess, counted)
        for w in self.workers:
            w.fold_budget_s = 0.5 * self.interval
        self._worker_locks = [threading.Lock() for _ in self.workers]
        # the unique-timeseries tally's own guard: its faults count apart
        # from every worker's streak, and each flush tries the card again
        self._tally_guard = DeviceGuard(
            streak_limit=cfg.device_fault_streak,
            probe_interval_s=cfg.device_probe_interval_s,
            enabled=cfg.device_guard and guard_enabled_default())
        self.event_worker = EventWorker()
        self.metric_sinks: list[MetricSink] = list(metric_sinks or [])
        self.sink_excluded_tags: dict[str, set[str]] = {}
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
        self._sockets: list[socket.socket] = []
        self._shutdown = threading.Event()
        self._flush_lock = threading.Lock()
        self._counter_lock = threading.Lock()
        # Python-path tallies; the properties add the native readers' and
        # contexts' counts
        self._packets_py = 0
        self._parse_errors_py = 0
        self.last_flush_phases: dict[str, float] = {}
        # the last flush's unique-timeseries estimate (with
        # count_unique_timeseries; the reference sends it as
        # flush.unique_timeseries_total)
        self.last_unique_timeseries: Optional[int] = None
        # the native C++ ingest path: one parser context per worker,
        # lines committed to the context of worker digest % N
        self.native_mode = False
        self._native_router = None
        self._native_ingest_tick = 0
        # C++ reader-thread handles, and the packets of stopped ones
        self._native_readers: list = []
        self._native_reader_packets_stopped = 0
        self._native_reader_lock = threading.Lock()
        self._native_pump_started = False
        if cfg.tpu_native_ingest:
            from veneur_tpu_torch.native import NativeRouter

            for w in self.workers:
                w.attach_native()
            self._native_router = NativeRouter(
                [w._native for w in self.workers])
            self.native_mode = True
            log.info("native C++ ingest enabled (%d contexts)",
                     len(self.workers))

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
        """(report name, DeliveryManager) for every sink that carries
        one."""
        out = []
        for sink in self.metric_sinks:
            man = getattr(sink, "delivery", None)
            if man is not None:
                out.append((sink.name(), man))
        return out

    def delivery_stats(self) -> dict[str, dict]:
        """Each network sink's delivery counters (sinks/delivery.py
        ``DeliveryManager.stats``), keyed by sink name."""
        return {rname: man.stats()
                for rname, man in self._delivery_managers()}

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
            with self._counter_lock:
                self._parse_errors_py += 1
            log.debug("bad metric packet %r: %s", packet[:128], e)

    def _route(self, metric) -> None:
        i = metric.digest % len(self.workers)
        with self._worker_locks[i]:
            self.workers[i].process_metric(metric)

    def process_metric_packet(self, datagram: bytes) -> None:
        """Split a datagram on newlines and handle each line
        (reference processMetricPacket, server.go:1136)."""
        with self._counter_lock:
            self._packets_py += 1
        if len(datagram) > self.config.metric_max_length:
            with self._counter_lock:
                self._parse_errors_py += 1
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
            ctx = w._native
            if (ctx.pending_histo >= w.batch_size
                    or ctx.pending_set >= w.batch_size):
                with lock:
                    w.drain_native()

    def _drain_native_events(self) -> None:
        """Parse the event and service-check lines the C++ contexts hand
        back on the Python path. Must not be called under a worker lock:
        the lines re-enter _route, which takes one."""
        for w in self.workers:
            for line in w._native.drain_other():
                self.handle_metric_packet(line)

    # -- listeners ----------------------------------------------------------

    def _spawn(self, target, name: str) -> threading.Thread:
        t = threading.Thread(target=target, name=name, daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def start_statsd_udp(self, addr: str, port: int) -> int:
        """num_readers reader threads sharing the port via SO_REUSEPORT
        (reference networking.go:41-91). Returns the bound port."""
        bound_port = port
        for i in range(self.config.num_readers):
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            if self.config.num_readers > 1:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            if self.config.read_buffer_size_bytes:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF,
                                self.config.read_buffer_size_bytes)
            sock.bind((addr, bound_port))
            bound_port = sock.getsockname()[1]  # resolve port 0 once
            self._sockets.append(sock)
            if self.native_mode and self.config.tpu_native_readers:
                self._start_native_metric_reader(sock, i)
            else:
                self._spawn(lambda s=sock: self._read_metric_socket(s),
                            f"statsd-udp-{i}")
        return bound_port

    def _start_native_metric_reader(self, sock: socket.socket,
                                    i: int) -> None:
        """Hand the bound socket's fd to a C++ reader thread: datagram to
        staged sample with no Python on the path. The socket object stays
        in self._sockets so the fd outlives the thread. ``i`` spreads the
        readers' event lines and parse errors over the contexts."""
        sock.setblocking(True)
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
            while not self._shutdown.wait(0.1):
                self._drain_native_thresholds()
                self._drain_native_events()

        self._spawn(pump, "native-pump")
        self._native_pump_started = True

    def _stop_native_readers(self) -> None:
        """Join the C++ reader threads (their fds stay open). Idempotent."""
        with self._native_reader_lock:
            readers, self._native_readers = self._native_readers, []
            for h in readers:
                # the count after the join: the last recv window included
                self._native_reader_packets_stopped += (
                    self._native_router.stop_reader(h))

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
        while not self._shutdown.wait(cadence):
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

    def _read_metric_socket(self, sock: socket.socket) -> None:
        """Tight recv loop (reference ReadMetricSocket, server.go:1123);
        reads max_length+1 so overlong datagrams are detectable."""
        bufsize = self.config.metric_max_length + 1
        sock.settimeout(0.5)
        while not self._shutdown.is_set():
            try:
                data = sock.recv(bufsize)
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed during shutdown
            self.process_metric_packet(data)

    def start_listeners(self) -> dict[str, int]:
        """Start every configured statsd listener; returns the resolved
        ports keyed by address. UDP only in this slice."""
        ports = {}
        for spec in self.config.statsd_listen_addresses:
            proto, _, rest = spec.partition("://")
            if proto != "udp":
                raise ValueError(f"statsd listener {spec!r}: only udp:// "
                                 "listeners are ported")
            host, _, port = rest.rpartition(":")
            ports[spec] = self.start_statsd_udp(host or "127.0.0.1",
                                                int(port))
        return ports

    def start(self) -> dict[str, int]:
        """Start sinks, listeners and the flush ticker
        (reference Server.Start, server.go:826)."""
        for sink in self.metric_sinks:
            sink.start()
        ports = self.start_listeners()
        self._spawn(self._flush_loop, "flush-ticker")
        if self.config.micro_fold:
            self._spawn(self._micro_fold_loop, "micro-fold")
        if self.native_mode:
            self._spawn(self._series_sync_loop, "series-sync")
        return ports

    # -- flush --------------------------------------------------------------

    def _flush_loop(self) -> None:
        next_tick = time.time()
        while not self._shutdown.is_set():
            next_tick += self.interval
            delay = next_tick - time.time()
            if delay > 0 and self._shutdown.wait(delay):
                return
            try:
                self.flush()
            except Exception:
                log.exception("flush failed")

    def flush(self, now: Optional[float] = None):
        """One flush pass (reference Server.Flush, flusher.go:28-134):
        swap every worker under its lock, extract the swapped epochs,
        generate the interval's metrics, emit to the sinks.

        Returns the ColumnarMetrics batch when a metric sink exists
        (len() works; call .materialize() for objects), else the
        list[InterMetric]. `now` pins the interval's timestamp."""
        with self._flush_lock:
            return self._flush(now)

    def _flush(self, now: Optional[float]):
        flush_start = time.time() if now is None else float(now)
        phases: dict[str, float] = {}
        if self.native_mode:
            # event and service-check lines still buffered in C++; those
            # landing after this are caught by swap with the epoch close
            self._drain_native_events()
        other_samples = self.event_worker.flush()
        for sink in self.metric_sinks:
            try:
                sink.flush_other_samples(other_samples)
            except Exception:
                log.exception("sink %s FlushOtherSamples failed",
                              sink.name())
        qs = device_quantiles(self.percentiles, self.aggregates)
        _t = time.perf_counter()
        swapped = []
        for worker, lock in zip(self.workers, self._worker_locks):
            with lock:
                swapped.append(worker.swap(qs))
        # lines the contexts handed back at epoch close belong to the new
        # epoch; parsed outside the worker locks (they re-enter _route)
        for worker in self.workers:
            lines, worker.pending_other_lines = worker.pending_other_lines, []
            for line in lines:
                self.handle_metric_packet(line)
        phases["swap_s"] = time.perf_counter() - _t
        _t = time.perf_counter()
        snaps: list[FlushSnapshot] = []
        for i, (worker, sw) in enumerate(zip(self.workers, swapped)):
            try:
                snaps.append(worker.extract_snapshot(sw, qs, self.interval))
            except Exception:
                log.exception("flush extraction failed for worker %d", i)
            # guard maintenance mutates the live epoch (quarantine to the
            # CPU, probe, re-admission): under the ingest lock
            with self._worker_locks[i]:
                worker.device_guard_tick()
        phases["extract_s"] = time.perf_counter() - _t

        # generation: columnar whenever a metric sink exists (sinks that
        # cannot consume columns share the batch's one materialization)
        _t = time.perf_counter()
        ts = int(flush_start)
        final: list[InterMetric] = []
        batch = None
        if self.metric_sinks:
            for snap in snaps:
                b = generate_columnar(snap, self.is_local, self.percentiles,
                                      self.aggregates, now=ts)
                if batch is None:
                    batch = b
                else:
                    batch.groups.extend(b.groups)
                    batch.extras.extend(b.extras)
            n_flushed = batch.count() if batch is not None else 0
        else:
            for snap in snaps:
                final.extend(generate_inter_metrics(
                    snap, self.is_local, self.percentiles, self.aggregates,
                    now=ts))
            n_flushed = len(final)
        phases["generate_s"] = time.perf_counter() - _t

        # emission: one thread per sink, outside the worker locks (the
        # object path runs only without metric sinks, so it emits
        # nothing)
        _t = time.perf_counter()
        threads = []
        if batch is not None and n_flushed:
            for sink in self.metric_sinks:
                threads.append(self._spawn_sink(
                    self._flush_sink_columnar, f"flush-{sink.name()}",
                    sink, batch, self.sink_excluded_tags.get(sink.name())))
        elif not final:
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
        if threads:
            phases["sink_flush_s"] = time.perf_counter() - _t
        if self.config.count_unique_timeseries:
            self.last_unique_timeseries = self._tally_timeseries(snaps)
        self.last_flush_phases = phases
        return batch if batch is not None else final

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
        else:
            flushed = batch.count_for(sink.name())
        finally:
            self._count_sink(sink, flushed, error, time.time() - start)

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

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> bool:
        """Stop the listeners and the ticker, then the sinks. Idempotent."""
        if self._shutdown.is_set():
            return True
        self._shutdown.set()
        if self._native_router is not None:
            self._stop_native_readers()  # joins; then the fds close
        for sock in self._sockets:
            try:
                sock.close()
            except OSError:
                pass
        me = threading.current_thread()
        for t in self._threads:
            if t is not me:
                t.join(timeout=5.0)
        for sink in self.metric_sinks:
            try:
                sink.stop()
            except Exception:
                log.exception("sink %s failed to stop", sink.name())
        return all(not t.is_alive() for t in self._threads if t is not me)

    @property
    def version(self) -> str:
        return __version__
