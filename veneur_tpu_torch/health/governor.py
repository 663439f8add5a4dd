"""Flush-deadline governor: bounded-chunk extraction scheduling.

Copied from veneur_tpu/health/governor.py. The PyTorch port wires only
the per-tenant shed attribution (``note_tenant_shed``,
``tenant_shed_counts``); chunked extraction and the watchdog's beats come
with the flush-side operations (ROADMAP §1 item 8).

The flush's dominant phase on an extraction-bound host is the one
device program over all pool rows (E2E_SCALING.json: 11.9s of a 12.1s
flush at 131k series on CPU, superlinear past the LLC cliff). Running
it as ONE program means the flush is unbounded exactly when the host is
slowest. The governor slices the row space into power-of-two chunks
sized so each chunk lands near `flush_chunk_target_ms`, which buys two
properties the single-shot extract cannot offer:

- bounded degradation: a deployment past its hardware's cardinality
  knee takes LONGER flushes, but in bounded steps — each chunk's
  readback is a progress point, consumed by the watchdog deferral rule
  (health/policy.py) and by operators via self-telemetry.
- per-chunk deadline checks: the measured chunk rate feeds an EWMA that
  re-sizes subsequent chunks, so a host that slows mid-flush (GC, CPU
  contention) converges back toward the target instead of stalling.

Chunk sizes are powers of two with a floor, for the same reason every
other shape in this codebase is pow2-bucketed (_next_pow2): each
distinct chunk shape is one XLA compile variant, and a compile costs
20-40s on TPU — re-tuning chunk sizes freely would spend more time
compiling than extracting. The schedule may at most double or halve
between chunks, and only doubles when the remaining row count stays
divisible by the new size, so a pow2 total is always covered exactly
by pow2 chunks.

Thread-safety: progress fields are read by the watchdog thread while
the flush thread writes them; both go through one lock. Scheduling
state (the rate EWMA) is only touched by the flush thread.
"""

from __future__ import annotations

import threading
import time

MIN_CHUNK_ROWS = 1024  # matches the pool's pow2 floor (_next_pow2 floor)


def _floor_pow2(n: int) -> int:
    """Largest power of two <= n (n >= 1)."""
    return 1 << (max(int(n), 1).bit_length() - 1)


class ChunkRun:
    """One flush extraction's chunk schedule over `total_rows` rows.

    Usage (worker.extract_snapshot):

        run = governor.begin_extract(total_rows)
        while (c := run.next_rows()):
            ... extract rows [run.start, run.start + c) ...
            run.note(c, elapsed_s)

    `next_rows` returns 0 when the row space is covered. A total that
    is not a power of two (custom initial pool sizes) or is at most the
    chunk floor degenerates to a single full-size chunk.
    """

    def __init__(self, governor: "FlushDeadlineGovernor",
                 total_rows: int, shards: int = 1) -> None:
        self._gov = governor
        self.total = int(total_rows)
        self.start = 0
        self.chunks = 0
        # series-sharded pools (ops/series_shard.py): every chunk is a
        # LOCKSTEP slice — a c-row chunk is c/shards rows on each shard,
        # so sizing each chunk sizes every shard's slice independently
        # of the others' row counts. The floor rises to the shard count
        # so chunk sizes stay divisible (both are pow2; shards <= 1024
        # == MIN_CHUNK_ROWS is enforced at config validation).
        self.shards = max(1, int(shards))
        self._floor = max(MIN_CHUNK_ROWS, self.shards)
        pow2 = self.total > 0 and (self.total & (self.total - 1)) == 0
        if not pow2 or self.total <= self._floor:
            self._next = self.total
        else:
            self._next = governor._initial_chunk(self.total)

    def next_rows(self) -> int:
        remaining = self.total - self.start
        if remaining <= 0:
            return 0
        return min(self._next, remaining)

    def note(self, rows: int, dt_s: float) -> None:
        """Record a completed chunk: advances the cursor, publishes a
        progress beat, and re-sizes the next chunk from the measured
        rate (the per-chunk deadline check)."""
        self.start += rows
        self.chunks += 1
        self._gov._note_chunk(rows, dt_s, self.shards)
        remaining = self.total - self.start
        if remaining <= 0:
            return
        want = self._gov._target_chunk(remaining)
        cur = self._next
        if want > cur:
            # at most double, and only while the remaining rows stay
            # divisible by the doubled size (keeps pow2 coverage exact)
            nxt = cur * 2
            if nxt <= remaining and remaining % nxt == 0:
                self._next = nxt
        elif want < cur:
            self._next = max(self._floor, cur // 2)
        if self._next > remaining:
            # remaining is a multiple of the previous size and smaller
            # than the doubled one, hence itself the previous pow2
            self._next = remaining


class FlushDeadlineGovernor:
    """Owns the chunk-size policy and the flush progress signal.

    One instance per server, shared by all workers: extraction runs
    per-worker sequentially inside one flush, so a shared rate EWMA and
    a shared progress clock describe the flush as a whole.
    """

    def __init__(self, chunk_target_ms: int = 0,
                 interval_s: float = 10.0) -> None:
        self.chunk_target_ms = int(chunk_target_ms)
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        # rows/s extraction rate, refined by every completed chunk;
        # None until the first chunk is measured (first flush probes
        # with the floor-size chunk)
        self._rate_ewma: float | None = None
        # progress signal, read by the watchdog thread. A COUNT, not a
        # bool: the stage-parallel flush pipeline (core/pipeline.py)
        # overlaps intervals, so several flushes are legitimately in
        # flight at once; the watchdog only cares whether ANY is.
        self._in_flight = 0
        self._last_beat_unix = 0.0
        self._chunks_done = 0
        # per-flush report (reset by begin_flush, read by telemetry)
        self._chunk_times: list[float] = []
        self._chunk_rows: list[int] = []
        # shard count of the most recent chunked extraction (1 on the
        # single-device path); surfaces per-shard chunk rows in the
        # report so operators can see each shard's slice size
        self._report_shards = 1
        # mid-interval micro-fold accounting (always-hot flush): each
        # drain beats the progress clock — micro-folds ARE flush-path
        # liveness — and tallies here for telemetry/benches
        self.micro_folds_total = 0
        self.micro_fold_samples_total = 0
        self._micro_folds_window = 0
        # per-tenant shed attribution (per-tenant QoS, core/tenancy.py):
        # lifetime overload-shed sample counts by tenant. The isolation
        # soak's contract reads from here — zero shed events may ever be
        # attributable to an innocent tenant while an abusive one floods
        self.tenant_shed_total: dict = {}
        # last classified device fault ("kind:op — detail", set by the
        # server from each worker's DeviceGuard after extraction). The
        # watchdog's panic verdict names it: a flush wedged right after
        # a device fault is a device postmortem, not a scheduling one.
        self._last_fault: str | None = None
        self.device_faults_total = 0

    @property
    def enabled(self) -> bool:
        return self.chunk_target_ms > 0

    @property
    def chunk_target_s(self) -> float:
        return self.chunk_target_ms / 1000.0

    # -- flush lifecycle (called by the server) ---------------------------

    def begin_flush(self) -> None:
        """Serial-flush entry: marks a flush in flight AND resets the
        per-flush chunk report (the serial path's contract — "the next
        flush resets the report", pinned by test_health_governor)."""
        with self._lock:
            self._in_flight += 1
            self._last_beat_unix = time.time()
            self._chunks_done = 0
            self._chunk_times = []
            self._chunk_rows = []

    def begin_stage_flush(self) -> None:
        """Pipelined-flush entry: marks a flush in flight WITHOUT
        touching the chunk report. Under stage overlap the tick that
        admits interval N must not clobber the report interval N-1's
        extract stage is still filling; the extract stage calls
        begin_report() itself when it actually starts chunking."""
        with self._lock:
            self._in_flight += 1
            self._last_beat_unix = time.time()

    def begin_report(self) -> None:
        """Reset the per-flush chunk report (pipelined extract stage)."""
        with self._lock:
            self._chunks_done = 0
            self._chunk_times = []
            self._chunk_rows = []

    def end_flush(self) -> None:
        with self._lock:
            self._in_flight = max(0, self._in_flight - 1)
            self._last_beat_unix = time.time()

    def beat(self) -> None:
        """A generic liveness beat from a non-chunked flush phase
        (swap, generate): progress the watchdog can trust without a
        chunk completing."""
        with self._lock:
            self._last_beat_unix = time.time()

    def note_micro_fold(self, samples: int) -> None:
        """One mid-interval micro-fold drained `samples` staged samples
        to the device mirror (worker.micro_fold_once). Counts as
        flush-path liveness for the watchdog — a host busy streaming
        micro-folds is making the deadline-time fold smaller, the
        opposite of stalled."""
        with self._lock:
            self._last_beat_unix = time.time()
            self.micro_folds_total += 1
            self.micro_fold_samples_total += int(samples)
            self._micro_folds_window += 1

    def note_tenant_shed(self, tenant: str, samples: int) -> None:
        """Attribute `samples` overload-shed samples to `tenant` (the
        worker's swap-time spill shed, health/policy.shed_spill_keep).
        Kept on the governor because shedding is a governor-adjacent
        overload signal and the soak reads one shared attribution
        point across all workers."""
        with self._lock:
            self._last_beat_unix = time.time()
            self.tenant_shed_total[tenant] = (
                self.tenant_shed_total.get(tenant, 0) + int(samples))

    def tenant_shed_counts(self) -> dict:
        with self._lock:
            return dict(self.tenant_shed_total)

    def note_fault(self, desc: str) -> None:
        """Record a classified device fault (ops/device_guard taxonomy,
        e.g. "oom:fold — 3 consecutive device faults..."). Read back by
        the watchdog verdict (health/policy.watchdog_verdict) so a panic
        log names the device error instead of a generic stall."""
        with self._lock:
            self._last_fault = str(desc)
            self.device_faults_total += 1

    def progress(self) -> dict:
        """Snapshot for the watchdog deferral decision."""
        with self._lock:
            return {
                "in_flight": self._in_flight > 0,
                "last_beat_unix": self._last_beat_unix,
                "chunks_done": self._chunks_done,
                "last_device_fault": self._last_fault,
            }

    @property
    def last_report(self) -> dict:
        """Per-flush chunk summary for self-telemetry and benches."""
        with self._lock:
            times = list(self._chunk_times)
            rows = list(self._chunk_rows)
            micro = self._micro_folds_window
            shards = self._report_shards
            self._micro_folds_window = 0
        if not times:
            return {"micro_folds": micro} if micro else {}
        report = {
            "chunks": len(times),
            "chunk_rows_max": max(rows),
            "chunk_max_s": max(times),
            "chunk_mean_s": sum(times) / len(times),
            "chunk_target_ms": self.chunk_target_ms,
            "micro_folds": micro,
        }
        if shards > 1:
            report["series_shards"] = shards
            report["chunk_rows_max_per_shard"] = max(rows) // shards
        return report

    # -- extraction scheduling (called by workers) ------------------------

    def begin_extract(self, total_rows: int, shards: int = 1) -> ChunkRun:
        return ChunkRun(self, total_rows, shards)

    def _initial_chunk(self, total_rows: int) -> int:
        """First chunk of a flush: the rate-derived target size, or the
        floor when no rate has been measured yet (the floor chunk then
        doubles as the probe that seeds the EWMA)."""
        if self._rate_ewma is None:
            return MIN_CHUNK_ROWS
        return self._target_chunk(total_rows)

    def _target_chunk(self, limit_rows: int) -> int:
        """Pow2 chunk size whose predicted latency is ~ the target."""
        if self._rate_ewma is None:
            return MIN_CHUNK_ROWS
        want = self._rate_ewma * self.chunk_target_s
        return max(MIN_CHUNK_ROWS,
                   min(_floor_pow2(max(want, 1.0)), _floor_pow2(limit_rows)))

    def _note_chunk(self, rows: int, dt_s: float, shards: int = 1) -> None:
        if dt_s > 1e-6:
            rate = rows / dt_s
            self._rate_ewma = (rate if self._rate_ewma is None
                               else 0.5 * self._rate_ewma + 0.5 * rate)
        with self._lock:
            self._last_beat_unix = time.time()
            self._chunks_done += 1
            self._chunk_times.append(dt_s)
            self._chunk_rows.append(rows)
            self._report_shards = max(1, int(shards))
