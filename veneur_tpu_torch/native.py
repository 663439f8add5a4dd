"""ctypes binding for the native C++ ingest pipeline (native/dogstatsd.cpp).

The port's own copy of the parts of veneur_tpu/native.py that DogStatsD
ingest needs: the library loader, ``NativeIngest`` (one epoch's parser,
series directory, raw-sample staging plane and drain buffers in C++),
``NativeRouter`` (lines committed to shard digest % N, and C++ reader
threads on bound UDP sockets), ``available`` and ``source_hash``, and the
staging plane's watermark drain the micro-fold reads
(``stage_pending``, ``drain_stage_delta``), and the emit tier the metric
sinks serialize through (``emit_available``, ``encode_datadog_series``,
``encode_signalfx_body``, ``encode_prometheus_lines``,
``encode_forward_lines``, ``encode_prometheus_exposition``, ``deflate``)
and the archive's VMB1 section encoder (``encode_archive_section``).
The reader shards' owned contexts (``ingest_owned``,
``start_owned_reader``) and commit-mutex records (``lock_stats``), and the
forward wire (``encode_histo_batch``, ``decode_metric_batch``,
``upsert_many``, the stream-frame, ack and dedup-header codecs and
``codec_available``) are bound too, and so are the SSF span fast path
(``ingest_ssf``, ``ingest_ssf_many``, ``ssf_spans``, ``ssf_invalid``,
``drain_ssf_services``, ``drain_ssf_fallback``, the C++ SSF reader) and
the C++ line-stream reader of plain TCP connections. The load
generator's half (native/loadgen.cpp, a library of its own) is bound at
the end: ``load_loadgen_library``, ``loadgen_available``,
``loadgen_source_hash``, ``LoadgenRing`` (ring synthesis from a workload
spec, appended payloads, serialize and load), ``LoadgenSender`` (the
paced C++ send thread) and ``LoadgenCapture`` (datagram capture for
bit-exact replay).

Both libraries are built from the sources in ``native/`` at first use,
by g++ with the flags of native/Makefile, into ``build/native/`` at the
repository root (a directory .gitignore lists), under a name hashed from
the sources, the flags and the host's CPU (the flags hold -march=native).
It never runs ``make`` in ``native/`` and never loads a library there:
those belong to the JAX package. A failed build raises with the
compiler's message: nothing here falls back to the Python parser.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("veneur_tpu_torch.native")

ROOT = Path(__file__).resolve().parents[1]
NATIVE_DIR = ROOT / "native"
BUILD_DIR = ROOT / "build" / "native"
# the library's sources, in native/Makefile's order (its source stamp is
# the sha256 of their concatenation)
SOURCES = ("dogstatsd.cpp", "emit.cpp", "forward_codec.cpp")
# native/Makefile's CXXFLAGS, the shared-object link and zlib
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
            "-march=native", "-pthread")

_lib = None
_lib_lock = threading.Lock()


def source_stamp() -> str:
    """The Makefile's SRC_HASH: the first 16 hex digits of the sha256 of
    the sources concatenated; the built library reports it back through
    ``source_hash``."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line
    except OSError:
        pass
    return platform.processor()


def library_path() -> Path:
    """Where the library built from this checkout's sources lives."""
    h = hashlib.sha256(source_stamp().encode())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_cpu_model().encode())
    return BUILD_DIR / f"libveneur_native-{h.hexdigest()[:12]}.so"


def _compile(out: Path, sources, define: str, libs=()) -> Path:
    """g++ ``sources`` (in native/) into the shared library ``out`` unless
    it exists; raises RuntimeError with the compiler's message."""
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, define, "-shared", "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in sources), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build: {cxx} could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build() -> Path:
    """Compile native/ with g++ unless this exact build exists; returns
    the library path. Raises RuntimeError with the compiler's message."""
    return _compile(library_path(), SOURCES,
                    f'-DVN_SOURCE_HASH="{source_stamp()}"', ("-lz",))


def load_library() -> ctypes.CDLL:
    """The ctypes handle of the built library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        c = ctypes
        vp, ci, ll = c.c_void_p, c.c_int, c.c_longlong
        lib.vn_source_hash.restype = c.c_char_p
        lib.vn_source_hash.argtypes = []
        lib.vn_ctx_new.restype = vp
        lib.vn_ctx_new.argtypes = [ci]
        lib.vn_ctx_free.argtypes = [vp]
        lib.vn_ctx_reset.argtypes = [vp]
        lib.vn_ctx_set_metro.argtypes = [vp, ci]
        lib.vn_lock.argtypes = [vp]
        lib.vn_unlock.argtypes = [vp]
        lib.vn_ingest.restype = ci
        lib.vn_ingest.argtypes = [vp, c.c_char_p, ci]
        lib.vn_ingest_routed.restype = ci
        lib.vn_ingest_routed.argtypes = [c.POINTER(vp), ci, c.c_char_p, ci]
        for name in ("vn_pending_histo", "vn_pending_set",
                     "vn_pending_counter", "vn_pending_gauge",
                     "vn_pending_new_series", "vn_num_histo_rows",
                     "vn_num_set_rows", "vn_num_counter_rows",
                     "vn_num_gauge_rows"):
            fn = getattr(lib, name)
            fn.restype = ci
            fn.argtypes = [vp]
        for name in ("vn_processed", "vn_errors", "vn_overload_dropped"):
            fn = getattr(lib, name)
            fn.restype = ll
            fn.argtypes = [vp]
        lib.vn_set_spill_cap.restype = None
        lib.vn_set_spill_cap.argtypes = [vp, ll]
        lib.vn_drain_histo.restype = ci
        lib.vn_drain_histo.argtypes = [vp, vp, vp, vp, ci]
        lib.vn_drain_set.restype = ci
        lib.vn_drain_set.argtypes = [vp, vp, vp, vp, ci]
        lib.vn_drain_counter.restype = ci
        lib.vn_drain_counter.argtypes = [vp, vp, vp, ci]
        lib.vn_drain_gauge.restype = ci
        lib.vn_drain_gauge.argtypes = [vp, vp, vp, ci]
        lib.vn_drain_new_series.restype = ci
        lib.vn_drain_new_series.argtypes = [
            vp, vp, vp, vp, vp, c.c_char_p, ci, c.POINTER(ci), ci]
        lib.vn_drain_other.restype = ci
        lib.vn_drain_other.argtypes = [vp, c.c_char_p, ci]
        lib.vn_upsert.restype = ci
        lib.vn_upsert.argtypes = [vp, c.c_char_p, ci, ci, c.c_char_p, ci, ci]
        lib.vn_set_stage_depth.argtypes = [vp, ci]
        lib.vn_stage_detach.restype = vp
        lib.vn_stage_detach.argtypes = [
            vp, c.POINTER(c.POINTER(c.c_float)),
            c.POINTER(c.POINTER(c.c_float)),
            c.POINTER(c.POINTER(c.c_int32)),
            c.POINTER(c.c_int32), c.POINTER(c.c_int32)]
        lib.vn_stage_free.argtypes = [vp]
        lib.vn_stage_pending.restype = ll
        lib.vn_stage_pending.argtypes = [vp]
        lib.vn_stage_total.restype = ll
        lib.vn_stage_total.argtypes = [vp]
        lib.vn_stage_drain_delta.restype = c.c_int64
        lib.vn_stage_drain_delta.argtypes = [vp, vp, vp, vp, vp, c.c_int64]
        lib.vn_stage_unit_wts.restype = ci
        lib.vn_stage_unit_wts.argtypes = [vp]
        lib.vn_reader_start2.restype = vp
        lib.vn_reader_start2.argtypes = [c.POINTER(vp), ci, ci, ci, ci]
        lib.vn_reader_packets.restype = ll
        lib.vn_reader_packets.argtypes = [vp]
        lib.vn_reader_stop.restype = ll
        lib.vn_reader_stop.argtypes = [vp]
        lib.vn_stream_reader_start2.restype = vp
        lib.vn_stream_reader_start2.argtypes = [
            c.POINTER(vp), ci, ci, ci, ci]
        lib.vn_stream_reader_stop.restype = ll
        lib.vn_stream_reader_stop.argtypes = [vp]
        lib.vn_stream_reader_done.restype = ci
        lib.vn_stream_reader_done.argtypes = [vp]
        # the SSF span fast path: decode and span->metric extraction in
        # one C++ pass, the SSF datagram reader and its hand-backs
        lib.vn_ingest_ssf.restype = ci
        lib.vn_ingest_ssf.argtypes = [
            vp, c.c_char_p, ci, c.c_char_p, ci, c.c_char_p, ci, c.c_double]
        lib.vn_ingest_ssf_many.restype = ci
        lib.vn_ingest_ssf_many.argtypes = [
            vp, c.c_char_p, ll, c.c_char_p, ci, c.c_char_p, ci, c.c_double,
            c.POINTER(ci), vp, vp, ci, c.POINTER(ci)]
        lib.vn_ssf_spans.restype = ll
        lib.vn_ssf_spans.argtypes = [vp]
        lib.vn_ssf_invalid.restype = ll
        lib.vn_ssf_invalid.argtypes = [vp]
        lib.vn_drain_ssf_services.restype = ci
        lib.vn_drain_ssf_services.argtypes = [vp, c.c_char_p, ci]
        lib.vn_drain_ssf_fallback.restype = ci
        lib.vn_drain_ssf_fallback.argtypes = [vp, c.c_char_p, ci]
        lib.vn_ssf_reader_start.restype = vp
        lib.vn_ssf_reader_start.argtypes = [
            vp, ci, ci, c.c_char_p, ci, c.c_char_p, ci, c.c_double]
        lib.vn_ssf_reader_stop.restype = ll
        lib.vn_ssf_reader_stop.argtypes = [vp]
        # the emit tier (native/emit.cpp): Datadog series bodies,
        # SignalFx bodies, statsd/forward lines, exposition text and the
        # GIL-free deflate passes
        lib.vn_encode_datadog_series.restype = ll
        lib.vn_encode_datadog_series.argtypes = [
            c.c_char_p, ll, ll,                           # meta
            c.c_char_p, ll,                               # suffixes
            vp, ci,                                       # types, nfam
            vp, vp,                                       # values, masks
            ll, c.c_double,                               # ts, interval
            c.c_char_p, ll,                               # hostname
            c.c_char_p, ll,                               # common tags
            c.c_char_p, ll,                               # excl keys
            c.c_char_p, ll,                               # excl prefixes
            c.c_char_p, ll,                               # drop prefixes
            ll,                                           # max_per_body
            c.POINTER(vp), c.POINTER(c.c_char_p),
            c.POINTER(ll), c.POINTER(ll)]
        lib.vn_encode_signalfx_body.restype = ll
        lib.vn_encode_signalfx_body.argtypes = [
            c.c_char_p, ll, ll, c.c_char_p, ll,
            vp, ci, vp, vp, ll,
            c.c_char_p, ll, c.c_char_p, ll,
            c.c_char_p, ll, c.c_char_p, ll,
            c.c_char_p, ll,
            c.POINTER(c.c_char_p), c.POINTER(ll)]
        for name in ("vn_encode_prometheus_lines", "vn_encode_forward_lines",
                     "vn_encode_prometheus_exposition"):
            fn = getattr(lib, name)
            fn.restype = ll
            fn.argtypes = [
                c.c_char_p, ll, ll, c.c_char_p, ll,
                vp, ci, vp, vp, c.c_char_p, ll,
                c.POINTER(c.c_char_p), c.POINTER(ll)]
        lib.vn_deflate.restype = ll
        lib.vn_deflate.argtypes = [
            c.c_char_p, ll, c.POINTER(c.c_char_p), c.POINTER(ll)]
        lib.vn_deflate_chunks.restype = ll
        lib.vn_deflate_chunks.argtypes = [
            c.c_char_p, vp, ll, c.POINTER(vp), c.POINTER(c.c_char_p),
            c.POINTER(ll)]
        # the archive tier (native/emit.cpp): VMB1 columnar sections
        lib.vn_encode_archive_section.restype = ll
        lib.vn_encode_archive_section.argtypes = [
            c.c_char_p, ll, ll, c.c_char_p, ll,
            vp, ci, vp, vp,
            c.POINTER(c.c_char_p), c.POINTER(ll)]
        # reader shards: home-aware ingest (an owned context commits
        # every line, event and error into itself) and the commit-mutex
        # contention record
        lib.vn_ingest_home.restype = ci
        lib.vn_ingest_home.argtypes = [c.POINTER(vp), ci, c.c_char_p, ci, ci]
        lib.vn_set_lock_stats.argtypes = [ci]
        lib.vn_lock_stats.restype = ci
        lib.vn_lock_stats.argtypes = [
            vp, c.POINTER(ll), c.POINTER(ll), c.POINTER(ll), ci]
        lib.vn_lock_stats_reset.argtypes = [vp]
        # the forward wire: histogram rows to MetricBatch bytes, the
        # import decoder, the batched directory upsert, and the VSF1
        # stream frames/acks and VDE1 dedup header
        # (native/forward_codec.cpp)
        P = c.POINTER
        lib.vn_encode_histo_batch.restype = ll
        lib.vn_encode_histo_batch.argtypes = [
            c.c_char_p, ll, vp, vp, vp, vp, vp, ci, ci, vp, vp, vp,
            c.c_double, P(c.c_char_p)]
        lib.vn_decode_metric_batch.restype = ll
        lib.vn_decode_metric_batch.argtypes = [
            c.c_char_p, ll,
            P(c.c_char_p), P(ll),                    # meta
            P(vp), P(vp),                            # kinds, scopes
            P(vp), P(vp),                            # value_kind, digests
            P(vp),                                   # scalars
            P(vp), P(vp), P(vp),                     # dmin, dmax, recip
            P(vp),                                   # compression
            P(vp), P(vp), P(vp),                     # centroids
            P(vp), P(c.c_char_p), P(vp),             # hll
            P(vp), P(vp),                            # record byte ranges
            P(vp)]                                   # ring hashes
        lib.vn_upsert_many.restype = ll
        lib.vn_upsert_many.argtypes = [vp, c.c_char_p, ll, vp, vp, vp, ll,
                                       vp]
        lib.vn_stream_frame_encode.restype = ll
        lib.vn_stream_frame_encode.argtypes = [
            c.c_ulonglong, c.c_char_p, ll, P(c.c_char_p), P(ll)]
        lib.vn_stream_frame_decode.restype = ll
        lib.vn_stream_frame_decode.argtypes = [c.c_char_p, ll,
                                               P(c.c_ulonglong)]
        lib.vn_stream_ack_encode.restype = ll
        lib.vn_stream_ack_encode.argtypes = [c.c_ulonglong, ci, c.c_char_p]
        lib.vn_stream_ack_decode.restype = ll
        lib.vn_stream_ack_decode.argtypes = [c.c_char_p, ll,
                                             P(c.c_ulonglong)]
        lib.vn_dedup_header_encode.restype = ll
        lib.vn_dedup_header_encode.argtypes = [
            c.c_char_p, ll, ll, ll, P(c.c_char_p), P(ll)]
        lib.vn_dedup_header_parse.restype = ll
        lib.vn_dedup_header_parse.argtypes = [
            c.c_char_p, ll, P(c.c_char_p), P(ll), P(ll), P(ll)]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


_gc_holds = 0
_gc_holds_lock = threading.Lock()
_gc_was_enabled = False


@contextlib.contextmanager
def collector_paused():
    """No automatic cyclic collection while any thread is inside: one
    that started inside a native context's lock hold would keep the lock,
    and the C++ reader waiting on it, for its whole pass; its datagrams
    pile up in the socket's buffer (F8). The collector runs again when
    the last thread leaves, as it was before the first came in: code
    that turns it off while a hold is open has it turned on again then
    (none of the port does)."""
    global _gc_holds, _gc_was_enabled
    with _gc_holds_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_holds_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


class NativeIngest:
    """One epoch-scoped native parser + directory context."""

    KIND_BY_TYPE = {"counter": 0, "gauge": 1, "histogram": 2, "timer": 3,
                    "set": 4}
    TYPE_BY_KIND = {v: k for k, v in KIND_BY_TYPE.items()}

    def __init__(self, hll_precision: int = 14,
                 set_hash: str = "fnv") -> None:
        lib = load_library()
        self._lib = lib
        self._ctx = lib.vn_ctx_new(hll_precision)
        if not self._ctx:
            raise RuntimeError("vn_ctx_new failed")
        if set_hash == "metro":
            lib.vn_ctx_set_metro(self._ctx, 1)
        # drain_new_series scratch, allocated once
        self._ns_pools = np.empty(4096, np.int32)
        self._ns_rows = np.empty(4096, np.int32)
        self._ns_kinds = np.empty(4096, np.int32)
        self._ns_scopes = np.empty(4096, np.int32)
        self._ns_strcap = 1 << 20
        self._ns_strbuf = ctypes.create_string_buffer(self._ns_strcap)
        self._drain_tl = threading.local()

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.vn_ctx_free(self._ctx)
            self._ctx = None

    def reset(self) -> None:
        self._lib.vn_ctx_reset(self._ctx)

    def lock(self) -> None:
        """Hold the context's (recursive) lock across a multi-call
        sequence, excluding routed commits from other threads."""
        self._lib.vn_lock(self._ctx)

    def unlock(self) -> None:
        self._lib.vn_unlock(self._ctx)

    @contextlib.contextmanager
    def hold(self):
        """``lock`` ... ``unlock`` around the block, with the collector
        paused (``collector_paused``)."""
        with collector_paused():
            self.lock()
            try:
                yield
            finally:
                self.unlock()

    def ingest(self, datagram: bytes) -> int:
        return self._lib.vn_ingest(self._ctx, datagram, len(datagram))

    # reader shards ----------------------------------------------------------

    def _self_arr(self):
        arr = getattr(self, "_self_arr_c", None)
        if arr is None:
            arr = self._self_arr_c = (ctypes.c_void_p * 1)(self._ctx)
        return arr

    def ingest_owned(self, datagram: bytes) -> int:
        """Shared-nothing ingest: parse lock-free and commit every line
        into THIS context under its own mutex (uncontended on the
        reader-shard path), the in-process twin of an owned reader
        thread. Events, service checks and parse errors stay here too."""
        return self._lib.vn_ingest_home(
            self._self_arr(), 1, datagram, len(datagram), 0)

    def start_owned_reader(self, fd: int, max_len: int):
        """Spawn a C++ reader thread committing only into this context
        (the stop contract of NativeRouter.start_reader)."""
        h = self._lib.vn_reader_start2(self._self_arr(), 1, fd, max_len, 0)
        if not h:
            raise RuntimeError("vn_reader_start2 failed")
        return h

    def lock_stats(self) -> dict:
        """This context's commit-mutex contention record: totals and the
        latest (up to 4,096) wait and hold samples in ns, recorded while
        ``vn_set_lock_stats`` is on."""
        return _lock_stats(self._lib, self._ctx)

    def reset_lock_stats(self) -> None:
        self._lib.vn_lock_stats_reset(self._ctx)

    # pending counts ---------------------------------------------------------

    @property
    def pending_histo(self) -> int:
        return self._lib.vn_pending_histo(self._ctx)

    @property
    def pending_set(self) -> int:
        return self._lib.vn_pending_set(self._ctx)

    @property
    def pending_counter(self) -> int:
        return self._lib.vn_pending_counter(self._ctx)

    @property
    def pending_gauge(self) -> int:
        return self._lib.vn_pending_gauge(self._ctx)

    @property
    def processed(self) -> int:
        return self._lib.vn_processed(self._ctx)

    @property
    def errors(self) -> int:
        return self._lib.vn_errors(self._ctx)

    @property
    def overload_dropped(self) -> int:
        """Samples shed at the pending-batch spill caps (overload)."""
        return int(self._lib.vn_overload_dropped(self._ctx))

    def set_spill_cap(self, cap: int) -> None:
        """Entries per pending SoA batch before samples shed."""
        self._lib.vn_set_spill_cap(self._ctx, int(cap))

    def num_rows(self) -> tuple[int, int, int, int]:
        """(histo, set, counter, gauge) row counts of this epoch's
        directory."""
        return (self._lib.vn_num_histo_rows(self._ctx),
                self._lib.vn_num_set_rows(self._ctx),
                self._lib.vn_num_counter_rows(self._ctx),
                self._lib.vn_num_gauge_rows(self._ctx))

    # staging plane ----------------------------------------------------------

    def set_stage_depth(self, depth: int) -> None:
        """Enable the C++ raw-sample staging plane with B slots per
        histogram row (0 disables); detach_stage() pulls it at flush."""
        self._lib.vn_set_stage_depth(self._ctx, depth)

    @property
    def stage_total(self) -> int:
        """Staged samples in the plane (telemetry, drain-threshold
        checks)."""
        return int(self._lib.vn_stage_total(self._ctx))

    @property
    def stage_pending(self) -> int:
        """Staged samples not yet copied out by drain_stage_delta (the
        micro-fold's due check)."""
        return int(self._lib.vn_stage_pending(self._ctx))

    def drain_stage_delta(self, cap: int):
        """Copy up to ``cap`` not yet drained staged samples out as COO
        (rows, slots, vals, wts) with ABSOLUTE slot positions, advancing
        the plane's per-row drained watermark. The plane's counts are
        untouched, so the depth cap and the spill are those of a run with
        no micro-folds."""
        rows = np.empty(cap, np.int32)
        slots = np.empty(cap, np.int32)
        vals = np.empty(cap, np.float32)
        wts = np.empty(cap, np.float32)
        n = self._lib.vn_stage_drain_delta(
            self._ctx, _ptr(rows), _ptr(slots), _ptr(vals), _ptr(wts), cap)
        return rows[:n], slots[:n], vals[:n], wts[:n]

    def detach_stage(self):
        """Detach the staged plane: (vals[rows, depth], wts[rows, depth],
        counts[rows], unit_wts, free), the arrays aliasing C++ memory
        owned by the detached plane (call free() once they are copied),
        or None when nothing is staged. unit_wts: every weight is 1.0, so
        the weights plane can be rebuilt from the counts. A fresh plane
        takes the following samples."""
        c = ctypes
        pv = c.POINTER(c.c_float)()
        pw = c.POINTER(c.c_float)()
        pc = c.POINTER(c.c_int32)()
        rows = c.c_int32()
        depth = c.c_int32()
        handle = self._lib.vn_stage_detach(
            self._ctx, c.byref(pv), c.byref(pw), c.byref(pc),
            c.byref(rows), c.byref(depth))
        if not handle:
            return None
        r, d = rows.value, depth.value
        vals = np.ctypeslib.as_array(pv, shape=(r, d))
        wts = np.ctypeslib.as_array(pw, shape=(r, d))
        counts = np.ctypeslib.as_array(pc, shape=(r,))
        unit = bool(self._lib.vn_stage_unit_wts(handle))
        lib = self._lib

        def free(_h=handle, _lib=lib):
            _lib.vn_stage_free(_h)

        return vals, wts, counts, unit, free

    # drains -----------------------------------------------------------------

    def drain_histo(self, cap: int):
        rows = np.empty(cap, np.int32)
        vals = np.empty(cap, np.float32)
        wts = np.empty(cap, np.float32)
        n = self._lib.vn_drain_histo(
            self._ctx, _ptr(rows), _ptr(vals), _ptr(wts), cap)
        return rows[:n], vals[:n], wts[:n]

    def drain_set(self, cap: int):
        rows = np.empty(cap, np.int32)
        idx = np.empty(cap, np.int32)
        rank = np.empty(cap, np.int8)
        n = self._lib.vn_drain_set(
            self._ctx, _ptr(rows), _ptr(idx), _ptr(rank), cap)
        return rows[:n], idx[:n], rank[:n]

    def drain_counter(self, cap: int):
        rows = np.empty(cap, np.int32)
        contribs = np.empty(cap, np.float64)
        n = self._lib.vn_drain_counter(
            self._ctx, _ptr(rows), _ptr(contribs), cap)
        return rows[:n], contribs[:n]

    def drain_gauge(self, cap: int):
        rows = np.empty(cap, np.int32)
        vals = np.empty(cap, np.float64)
        n = self._lib.vn_drain_gauge(self._ctx, _ptr(rows), _ptr(vals), cap)
        return rows[:n], vals[:n]

    @property
    def pending_new_series(self) -> int:
        """Count of undrained new-series records (a cheap C call)."""
        return self._lib.vn_pending_new_series(self._ctx)

    def drain_new_series(self, max_records: int = 4096):
        """[(pool, row, kind, scope_class, name, joined_tags)]; pool: 0
        histo, 1 set, 2 counter, 3 gauge; kind: KIND_BY_TYPE's int."""
        max_records = min(max_records, 4096)
        strlen = ctypes.c_int(0)
        out = []
        while True:
            n = self._lib.vn_drain_new_series(
                self._ctx, _ptr(self._ns_pools), _ptr(self._ns_rows),
                _ptr(self._ns_kinds), _ptr(self._ns_scopes),
                self._ns_strbuf, self._ns_strcap, ctypes.byref(strlen),
                max_records)
            if n == 0:
                stranded = self._lib.vn_pending_new_series(self._ctx)
                if stranded:
                    # one record larger than the 1 MiB scratch cannot
                    # make progress: drop the drain rather than spin
                    log.error("new-series record exceeds drain buffer; "
                              "%d records stranded until reset", stranded)
                break
            packed = ctypes.string_at(self._ns_strbuf, strlen.value)
            for i, rec in enumerate(packed.split(b"\x1e")[:n]):
                name, _, joined = rec.partition(b"\x1f")
                out.append((int(self._ns_pools[i]), int(self._ns_rows[i]),
                            int(self._ns_kinds[i]), int(self._ns_scopes[i]),
                            name.decode("utf-8", "replace"),
                            joined.decode("utf-8", "replace")))
            # n < max_records can mean the string buffer filled mid-batch:
            # keep draining until the queue reports empty
            if self._lib.vn_pending_new_series(self._ctx) == 0:
                break
        return out

    def upsert(self, name: str, mtype: str, joined_tags: str,
               scope_class: int) -> int:
        """Directory upsert for Python-side ingest (shares the row space
        with parsed traffic). The new-series drain frames records with the
        \\x1e/\\x1f separators, so those bytes are replaced by '_'."""
        if "\x1e" in name or "\x1f" in name:
            name = name.replace("\x1e", "_").replace("\x1f", "_")
        if "\x1e" in joined_tags or "\x1f" in joined_tags:
            joined_tags = joined_tags.replace(
                "\x1e", "_").replace("\x1f", "_")
        nb = name.encode("utf-8")
        tb = joined_tags.encode("utf-8")
        return self._lib.vn_upsert(
            self._ctx, nb, len(nb), self.KIND_BY_TYPE[mtype], tb, len(tb),
            scope_class)

    # the SSF span fast path -------------------------------------------------

    def ingest_ssf(self, packet: bytes, indicator_name: bytes = b"",
                   objective_name: bytes = b"",
                   uniqueness_rate: float = 0.0) -> int:
        """Decode one SSF span and extract its metrics into this
        context. 1 on success, 0 on a decode error, -1 when the span
        carries STATUS samples (the caller takes the Python path)."""
        return self._lib.vn_ingest_ssf(
            self._ctx, packet, len(packet),
            indicator_name, len(indicator_name),
            objective_name, len(objective_name),
            float(uniqueness_rate))

    def ingest_ssf_many(self, packets: list[bytes],
                        indicator_name: bytes = b"",
                        objective_name: bytes = b"",
                        uniqueness_rate: float = 0.0
                        ) -> tuple[int, int, list[bytes]]:
        """One C call for a burst of spans: (accepted, decode errors,
        the packets carrying STATUS samples, for the Python path)."""
        if not packets:
            return 0, 0, []
        buf = b"".join(
            len(pkt).to_bytes(4, "little") + pkt for pkt in packets)
        errors = ctypes.c_int(0)
        nfall = ctypes.c_int(0)
        cap = len(packets)
        fb_off = np.empty(cap, np.int32)
        fb_len = np.empty(cap, np.int32)
        ok = self._lib.vn_ingest_ssf_many(
            self._ctx, buf, len(buf),
            indicator_name, len(indicator_name),
            objective_name, len(objective_name),
            float(uniqueness_rate), ctypes.byref(errors),
            _ptr(fb_off), _ptr(fb_len), cap, ctypes.byref(nfall))
        fallbacks = [buf[fb_off[i]:fb_off[i] + fb_len[i]]
                     for i in range(int(nfall.value))]
        return int(ok), int(errors.value), fallbacks

    @property
    def ssf_spans(self) -> int:
        """Spans this context extracted natively (lifetime)."""
        return int(self._lib.vn_ssf_spans(self._ctx))

    @property
    def ssf_invalid(self) -> int:
        return int(self._lib.vn_ssf_invalid(self._ctx))

    def drain_ssf_services(self) -> dict[str, int]:
        """Per-service span counts since the last drain."""
        # the buffer must hold at least one whole "service\tcount\n"
        # line (<= 278 bytes), or counts stay buffered to the next drain
        cap = 1 << 18
        buf = ctypes.create_string_buffer(cap)
        out: dict[str, int] = {}
        while True:
            n = self._lib.vn_drain_ssf_services(self._ctx, buf, cap)
            if n <= 0:
                break
            for line in buf.raw[:n].split(b"\n"):
                if not line:
                    continue
                # the count follows the last tab (the C++ side strips
                # framing bytes out of service names)
                svc, sep, cnt = line.rpartition(b"\t")
                if not sep or not cnt.isdigit():
                    log.warning("malformed ssf service-count line %r", line)
                    continue
                svc_s = svc.decode("utf-8", "replace")
                out[svc_s] = out.get(svc_s, 0) + int(cnt)
        return out

    def drain_ssf_fallback(self) -> list[bytes]:
        """Whole SSF payloads the C++ SSF reader handed back for the
        Python path (STATUS samples aboard)."""
        buf = self._drain_buf()
        out = []
        while True:
            n = self._lib.vn_drain_ssf_fallback(self._ctx, buf, len(buf))
            if n == 0:
                break
            raw = buf.raw[:n]
            pos = 0
            while pos + 4 <= n:
                ln = int.from_bytes(raw[pos:pos + 4], "little")
                out.append(raw[pos + 4:pos + 4 + ln])
                pos += 4 + ln
        return out

    def start_ssf_reader(self, fd: int, max_len: int, indicator: bytes,
                         objective: bytes, uniq_rate: float):
        """Spawn a C++ SSF datagram reader committing into this context
        (stop it with ``stop_ssf_reader``; the fd stays the caller's)."""
        h = self._lib.vn_ssf_reader_start(
            self._ctx, fd, max_len, indicator, len(indicator),
            objective, len(objective), float(uniq_rate))
        if not h:
            raise RuntimeError("vn_ssf_reader_start failed")
        return h

    def stop_ssf_reader(self, handle) -> int:
        """Join an SSF reader; its final datagram count."""
        return int(self._lib.vn_ssf_reader_stop(handle))

    def _drain_buf(self) -> ctypes.Array:
        """Per-thread 1 MiB drain scratch (the C++ side serializes each
        cut on the context mutex)."""
        buf = getattr(self._drain_tl, "buf", None)
        if buf is None:
            buf = self._drain_tl.buf = ctypes.create_string_buffer(1 << 20)
        return buf

    def drain_other(self) -> list[bytes]:
        """Event and service-check lines the parser handed back for the
        Python path."""
        buf = self._drain_buf()
        out = []
        while True:
            # chunks are cut on line boundaries (n < cap does not mean
            # drained): loop until the buffer reports empty
            n = self._lib.vn_drain_other(self._ctx, buf, len(buf))
            if n == 0:
                break
            out.extend(ln for ln in buf.raw[:n].split(b"\n") if ln)
        return out


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        load_library()
    except (RuntimeError, OSError) as e:
        log.info("native library unavailable: %s", e)
        return False
    return True


def source_hash() -> str:
    """The source stamp compiled into the loaded library."""
    return load_library().vn_source_hash().decode()


class NativeRouter:
    """Ingest over several workers' native contexts: lines are parsed
    lock-free in C++ and committed to shard digest % N under that shard's
    own mutex. ctypes releases the GIL, so callers parse in parallel."""

    def __init__(self, contexts: list[NativeIngest]) -> None:
        if not contexts:
            raise ValueError("router needs at least one context")
        self._lib = contexts[0]._lib
        self._contexts = contexts  # keep alive
        self._arr = (ctypes.c_void_p * len(contexts))(
            *[c._ctx for c in contexts])
        self._n = len(contexts)

    def ingest(self, datagram: bytes) -> int:
        return self._lib.vn_ingest_routed(
            self._arr, self._n, datagram, len(datagram))

    def start_reader(self, fd: int, max_len: int, home: int = 0):
        """Spawn a C++ reader thread on an already-bound datagram fd (the
        caller keeps the socket object alive; stop_reader joins without
        closing it). ``home`` picks the shard that takes this reader's
        events, service checks and parse errors."""
        h = self._lib.vn_reader_start2(self._arr, self._n, fd, max_len,
                                       home % self._n)
        if not h:
            raise RuntimeError("vn_reader_start failed")
        return h

    def reader_packets(self, handle) -> int:
        return int(self._lib.vn_reader_packets(handle))

    def stop_reader(self, handle) -> int:
        """Join the reader; its final packet count."""
        return int(self._lib.vn_reader_stop(handle))

    def start_stream_reader(self, fd: int, max_len: int, home: int = 0):
        """Spawn a C++ line-stream reader on a plain TCP connection. The
        reader owns ``fd`` (pass a dup) and closes it on exit; reap it
        with ``stream_reader_done`` and ``stop_stream_reader``."""
        h = self._lib.vn_stream_reader_start2(self._arr, self._n, fd,
                                              max_len, home % self._n)
        if not h:
            raise RuntimeError("vn_stream_reader_start failed")
        return h

    def stream_reader_done(self, handle) -> bool:
        return bool(self._lib.vn_stream_reader_done(handle))

    def stop_stream_reader(self, handle) -> int:
        return int(self._lib.vn_stream_reader_stop(handle))

    def set_lock_stats(self, enabled: bool) -> None:
        """Toggle commit-path mutex wait/hold timing (process-wide; it
        costs the commit path while on: diagnostics)."""
        self._lib.vn_set_lock_stats(1 if enabled else 0)

    def lock_stats(self, shard: int) -> dict:
        """Contention record of one shard's mutex (NativeIngest's)."""
        return _lock_stats(self._lib, self._contexts[shard]._ctx)

    def reset_lock_stats(self) -> None:
        """Zero every shard's contention record."""
        for c in self._contexts:
            self._lib.vn_lock_stats_reset(c._ctx)


def _lock_stats(lib, ctx) -> dict:
    totals = (ctypes.c_longlong * 5)()
    wait = (ctypes.c_longlong * 4096)()
    hold = (ctypes.c_longlong * 4096)()
    n = lib.vn_lock_stats(ctx, totals, wait, hold, 4096)
    return {
        "acquisitions": int(totals[0]),
        "contended": int(totals[1]),
        "wait_ns_total": int(totals[2]),
        "hold_ns_total": int(totals[3]),
        "wait_ns_samples": [int(wait[i]) for i in range(n)],
        "hold_ns_samples": [int(hold[i]) for i in range(n)],
    }


# ---------------------------------------------------------------------------
# The emit tier (native/emit.cpp): zero-copy serializers over the columnar
# flush arrays, byte-identical to the sinks' Python formatters


def emit_available() -> bool:
    """True when the native emit tier (native/emit.cpp) is loadable and
    not masked out. VENEUR_EMIT_NATIVE=0 forces the Python formatters
    without touching the library on disk."""
    if os.environ.get("VENEUR_EMIT_NATIVE", "").lower() in (
            "0", "false", "off", "no"):
        return False
    return available()


def _blob_arg(blob) -> tuple:
    """(c_char_p-compatible arg, length) for a meta blob that may be a
    bytes object or a pool's live bytearray arena (zero-copy: the arena
    is frozen after the epoch swap, so a borrowed pointer is safe for
    the duration of the call)."""
    if isinstance(blob, bytearray):
        n = len(blob)
        if n == 0:
            return b"", 0
        arr = (ctypes.c_char * n).from_buffer(blob)
        return ctypes.cast(arr, ctypes.c_char_p), n
    return blob, len(blob)


def _copy_arr(ptr: "ctypes.c_void_p", count: int, dtype) -> np.ndarray:
    if count == 0 or not ptr.value:
        return np.zeros(0, dtype)
    ctype = np.ctypeslib.as_ctypes_type(dtype)
    view = np.ctypeslib.as_array(
        ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,))
    return view.copy()


def encode_datadog_series(meta_blob: bytes, nrows: int,
                          suffixes: list[str], family_types: np.ndarray,
                          values: np.ndarray, masks: np.ndarray,
                          ts: int, interval: float, hostname: str,
                          common_tags_json: bytes,
                          excluded_keys: list[str],
                          excluded_prefixes: list[str],
                          drop_prefixes: list[str],
                          max_per_body: int,
                          compress: bool = False
                          ) -> "Optional[tuple[list[bytes], int]]":
    """Chunked Datadog {"series": [...]} bodies straight from columnar
    arrays (native/emit.cpp vn_encode_datadog_series). Returns
    (bodies, emitted_count), or None when the encoder refuses the
    input. compress=True deflates every chunk natively before it is
    copied out (vn_deflate_chunks; byte-identical to zlib.compress),
    so only compressed bytes cross back into Python."""
    lib = load_library()
    c = ctypes
    values = np.ascontiguousarray(values, np.float64)
    masks = np.ascontiguousarray(masks, np.uint8)
    family_types = np.ascontiguousarray(family_types, np.int8)
    suffix_blob = "\x1f".join(suffixes).encode("utf-8")
    ek = "\x1f".join(excluded_keys).encode("utf-8")
    ep = "\x1f".join(excluded_prefixes).encode("utf-8")
    dp = "\x1f".join(drop_prefixes).encode("utf-8")
    host = hostname.encode("utf-8")
    meta_arg, meta_len = _blob_arg(meta_blob)
    chunk_off = c.c_void_p()
    out = c.c_char_p()
    out_len = c.c_longlong()
    entries = c.c_longlong()
    n_chunks = lib.vn_encode_datadog_series(
        meta_arg, meta_len, nrows, suffix_blob, len(suffix_blob),
        _ptr(family_types), len(suffixes), _ptr(values), _ptr(masks),
        ts, float(interval), host, len(host), common_tags_json,
        len(common_tags_json), ek, len(ek), ep, len(ep), dp, len(dp),
        max_per_body, c.byref(chunk_off), c.byref(out),
        c.byref(out_len), c.byref(entries))
    if n_chunks < 0:
        return None
    if compress and n_chunks:
        # chain the deflate pass on the still-live thread-local body
        # buffer (same thread; the deflate output lives in its own
        # buffers): one more GIL-free call, no Python-side copy of the
        # uncompressed bodies
        zoff = c.c_void_p()
        zout = c.c_char_p()
        zlen = c.c_longlong()
        zn = lib.vn_deflate_chunks(out, chunk_off, n_chunks,
                                   c.byref(zoff), c.byref(zout),
                                   c.byref(zlen))
        if zn < 0:
            return None
        chunk_off, out, out_len = zoff, zout, zlen
    offs = _copy_arr(chunk_off, n_chunks + 1, np.int64).tolist()
    whole = ctypes.string_at(out, out_len.value)
    return ([whole[offs[i]:offs[i + 1]] for i in range(n_chunks)],
            int(entries.value))


def encode_signalfx_body(meta_blob: bytes, nrows: int,
                         suffixes: list[str], family_types: np.ndarray,
                         values: np.ndarray, masks: np.ndarray,
                         ts_ms: int, hostname_tag: str, hostname: str,
                         name_drops: list[str], tag_drops: list[str],
                         excluded_keys: list[str]
                         ) -> "Optional[tuple[bytes, int]]":
    """One SignalFx {"counter":[...],"gauge":[...]} body from columnar
    arrays; (body, emitted_count), or None when the encoder refuses."""
    lib = load_library()
    c = ctypes
    values = np.ascontiguousarray(values, np.float64)
    masks = np.ascontiguousarray(masks, np.uint8)
    family_types = np.ascontiguousarray(family_types, np.int8)
    sb = "\x1f".join(suffixes).encode("utf-8")
    nd = "\x1f".join(name_drops).encode("utf-8")
    td_ = "\x1f".join(tag_drops).encode("utf-8")
    ek = "\x1f".join(excluded_keys).encode("utf-8")
    ht = hostname_tag.encode("utf-8")
    hv = hostname.encode("utf-8")
    meta_arg, meta_len = _blob_arg(meta_blob)
    out = c.c_char_p()
    out_len = c.c_longlong()
    n = lib.vn_encode_signalfx_body(
        meta_arg, meta_len, nrows, sb, len(sb),
        _ptr(family_types), len(suffixes), _ptr(values), _ptr(masks),
        ts_ms, ht, len(ht), hv, len(hv), nd, len(nd), td_, len(td_),
        ek, len(ek), c.byref(out), c.byref(out_len))
    if n < 0:
        return None
    return ctypes.string_at(out, out_len.value), int(n)


def _encode_lines(symbol: str, meta_blob, nrows: int,
                  suffixes: list[str], family_types: np.ndarray,
                  values: np.ndarray, masks: np.ndarray,
                  excluded_keys: list[str]
                  ) -> "Optional[tuple[bytes, int]]":
    """Shared wrapper for the line-oriented emitters (statsd lines,
    forward lines, exposition text): one newline-joined buffer plus the
    emitted count; None when the encoder refuses."""
    lib = load_library()
    c = ctypes
    values = np.ascontiguousarray(values, np.float64)
    masks = np.ascontiguousarray(masks, np.uint8)
    family_types = np.ascontiguousarray(family_types, np.int8)
    suffix_blob = "\x1f".join(suffixes).encode("utf-8")
    ek = "\x1f".join(excluded_keys).encode("utf-8")
    meta_arg, meta_len = _blob_arg(meta_blob)
    out = c.c_char_p()
    out_len = c.c_longlong()
    n = getattr(lib, symbol)(
        meta_arg, meta_len, nrows, suffix_blob, len(suffix_blob),
        _ptr(family_types), len(suffixes), _ptr(values), _ptr(masks),
        ek, len(ek), c.byref(out), c.byref(out_len))
    if n < 0:
        return None
    return ctypes.string_at(out, out_len.value), int(n)


def encode_prometheus_lines(meta_blob, nrows: int,
                            suffixes: list[str],
                            family_types: np.ndarray,
                            values: np.ndarray, masks: np.ndarray,
                            excluded_keys: list[str]
                            ) -> "Optional[tuple[bytes, int]]":
    """statsd repeater lines from columnar arrays (one newline-joined
    buffer + line count)."""
    return _encode_lines("vn_encode_prometheus_lines", meta_blob, nrows,
                         suffixes, family_types, values, masks,
                         excluded_keys)


def encode_forward_lines(meta_blob, nrows: int, suffixes: list[str],
                         family_types: np.ndarray, values: np.ndarray,
                         masks: np.ndarray, excluded_keys: list[str]
                         ) -> "Optional[tuple[bytes, int]]":
    """Verbatim DogStatsD forward lines (no sanitization) from columnar
    arrays; same contract as encode_prometheus_lines."""
    return _encode_lines("vn_encode_forward_lines", meta_blob, nrows,
                         suffixes, family_types, values, masks,
                         excluded_keys)


def encode_prometheus_exposition(meta_blob, nrows: int,
                                 suffixes: list[str],
                                 family_types: np.ndarray,
                                 values: np.ndarray, masks: np.ndarray,
                                 excluded_keys: list[str]
                                 ) -> "Optional[tuple[bytes, int]]":
    """Prometheus exposition text (`name{k="v"} value` samples, the
    pushgateway body) from columnar arrays; (text, sample_count)."""
    return _encode_lines("vn_encode_prometheus_exposition", meta_blob,
                         nrows, suffixes, family_types, values, masks,
                         excluded_keys)


def encode_archive_section(meta_blob, nrows: int,
                           suffixes: list[str],
                           family_types: np.ndarray,
                           values: np.ndarray, masks: np.ndarray
                           ) -> "Optional[bytes]":
    """One VMB1 columnar section body (archive/wire.py) straight from an
    EmitGroupPlan's buffers, GIL-free; byte-identical to the Python
    encoder. None when the encoder refuses the input."""
    lib = load_library()
    c = ctypes
    values = np.ascontiguousarray(values, np.float64)
    masks = np.ascontiguousarray(masks, np.uint8)
    family_types = np.ascontiguousarray(family_types, np.int8)
    suffix_blob = "\x1f".join(suffixes).encode("utf-8")
    meta_arg, meta_len = _blob_arg(meta_blob)
    out = c.c_char_p()
    out_len = c.c_longlong()
    n = lib.vn_encode_archive_section(
        meta_arg, meta_len, nrows, suffix_blob, len(suffix_blob),
        _ptr(family_types), len(suffixes), _ptr(values), _ptr(masks),
        c.byref(out), c.byref(out_len))
    if n < 0:
        return None
    return ctypes.string_at(out, out_len.value)


def deflate(data: bytes) -> Optional[bytes]:
    """zlib deflate with the GIL released (native/emit.cpp vn_deflate);
    byte-identical to zlib.compress(data): both drive the system zlib
    at the default level. None when the call fails."""
    lib = load_library()
    c = ctypes
    out = c.c_char_p()
    out_len = c.c_longlong()
    if lib.vn_deflate(data, len(data), c.byref(out),
                      c.byref(out_len)) < 0:
        return None
    return ctypes.string_at(out, out_len.value)


# ---------------------------------------------------------------------------
# The forward wire: the histogram encoder, the import decoder and batched
# upsert (native/dogstatsd.cpp), and the stream-frame, ack and dedup-header
# codecs (native/forward_codec.cpp), byte-identical to the Python
# references in distributed/codec.py


def codec_available() -> bool:
    """True when the native forward frame codec is loadable and not
    masked out. VENEUR_CODEC_NATIVE=0 forces the pinned Python codec
    without touching the library on disk."""
    if os.environ.get("VENEUR_CODEC_NATIVE", "").lower() in (
            "0", "false", "off", "no"):
        return False
    return available()


def encode_histo_batch(meta_blob: bytes, kinds: np.ndarray,
                       scopes: np.ndarray, emit: np.ndarray,
                       means: np.ndarray, weights: np.ndarray,
                       dmin: np.ndarray, dmax: np.ndarray,
                       drecip: np.ndarray,
                       compression: float) -> Optional[bytes]:
    """Histogram rows -> veneurtpu.MetricBatch wire bytes in C++
    (vn_encode_histo_batch). None when the encoder declines."""
    lib = load_library()
    rows, cap = means.shape
    means = np.ascontiguousarray(means, np.float32)
    weights = np.ascontiguousarray(weights, np.float32)
    kinds = np.ascontiguousarray(kinds, np.int8)
    scopes = np.ascontiguousarray(scopes, np.int8)
    emit = np.ascontiguousarray(emit, np.uint8)
    dmin = np.ascontiguousarray(dmin, np.float64)
    dmax = np.ascontiguousarray(dmax, np.float64)
    drecip = np.ascontiguousarray(drecip, np.float64)
    out_ptr = ctypes.c_char_p()
    n = lib.vn_encode_histo_batch(
        meta_blob, len(meta_blob), _ptr(kinds), _ptr(scopes), _ptr(emit),
        _ptr(means), _ptr(weights), rows, cap, _ptr(dmin), _ptr(dmax),
        _ptr(drecip), ctypes.c_double(compression),
        ctypes.byref(out_ptr))
    if n < 0:
        return None
    return ctypes.string_at(out_ptr, n)


class DecodedBatch:
    """SoA view of one decoded MetricBatch (copies out of the C++
    thread-local buffers, so the object outlives further decodes)."""

    __slots__ = ("n", "meta", "kinds", "scopes", "value_kind", "digests",
                 "scalars", "dmin", "dmax", "drecip", "compression",
                 "cent_off", "cent_means", "cent_weights", "hll_off",
                 "hll_bytes", "hll_precision", "rec_off", "rec_len",
                 "ring_hash")


def decode_metric_batch(blob: bytes) -> Optional[DecodedBatch]:
    """Parse serialized veneurtpu.MetricBatch wire bytes into SoA arrays
    (vn_decode_metric_batch). None when the input is malformed (the
    caller takes the Python protobuf path, which raises)."""
    lib = load_library()
    c = ctypes
    meta = c.c_char_p()
    meta_len = c.c_longlong()
    (kinds, scopes, value_kind, digests, scalars, dmin, dmax, drecip,
     compression, cent_off, cent_means, cent_weights,
     hll_off, hll_precision, rec_off, rec_len, ring_hash) = [
        c.c_void_p() for _ in range(17)]
    hll_bytes = c.c_char_p()
    n = lib.vn_decode_metric_batch(
        blob, len(blob), c.byref(meta), c.byref(meta_len),
        c.byref(kinds), c.byref(scopes), c.byref(value_kind),
        c.byref(digests), c.byref(scalars), c.byref(dmin), c.byref(dmax),
        c.byref(drecip), c.byref(compression), c.byref(cent_off),
        c.byref(cent_means), c.byref(cent_weights), c.byref(hll_off),
        c.byref(hll_bytes), c.byref(hll_precision), c.byref(rec_off),
        c.byref(rec_len), c.byref(ring_hash))
    if n < 0:
        return None
    d = DecodedBatch()
    d.n = n
    d.meta = ctypes.string_at(meta, meta_len.value) if meta_len.value \
        else b""
    d.kinds = _copy_arr(kinds, n, np.uint8)
    d.scopes = _copy_arr(scopes, n, np.uint8)
    d.value_kind = _copy_arr(value_kind, n, np.uint8)
    d.digests = _copy_arr(digests, n, np.uint32)
    d.scalars = _copy_arr(scalars, n, np.float64)
    d.dmin = _copy_arr(dmin, n, np.float64)
    d.dmax = _copy_arr(dmax, n, np.float64)
    d.drecip = _copy_arr(drecip, n, np.float64)
    d.compression = _copy_arr(compression, n, np.float64)
    d.cent_off = _copy_arr(cent_off, n + 1, np.int64)
    ncent = int(d.cent_off[-1]) if n else 0
    d.cent_means = _copy_arr(cent_means, ncent, np.float32)
    d.cent_weights = _copy_arr(cent_weights, ncent, np.float32)
    d.hll_off = _copy_arr(hll_off, n + 1, np.int64)
    nhll = int(d.hll_off[-1]) if n else 0
    d.hll_bytes = ctypes.string_at(hll_bytes, nhll) if nhll else b""
    d.hll_precision = _copy_arr(hll_precision, n, np.int32)
    d.rec_off = _copy_arr(rec_off, n, np.int64)
    d.rec_len = _copy_arr(rec_len, n, np.int64)
    d.ring_hash = _copy_arr(ring_hash, n, np.uint64)
    return d


def upsert_many(ctx: NativeIngest, meta: bytes, kinds: np.ndarray,
                scopes: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """Batch directory upsert under one native lock hold. Returns row
    ids (i32[n], -1 where unselected)."""
    lib = ctx._lib
    n = len(kinds)
    out = np.empty(n, np.int32)
    kinds = np.ascontiguousarray(kinds, np.uint8)
    scopes = np.ascontiguousarray(scopes, np.uint8)
    sel = np.ascontiguousarray(sel, np.uint8)
    lib.vn_upsert_many(ctx._ctx, meta, len(meta), _ptr(kinds),
                       _ptr(scopes), _ptr(sel), n, _ptr(out))
    return out


def stream_frame_encode(seq: int, body: bytes) -> Optional[bytes]:
    """VSF1 frame (magic + u64 LE seq + body) with the GIL released.
    None: the caller takes the Python reference (seq outside u64)."""
    if not 0 <= seq < 1 << 64:
        return None  # Python raises OverflowError; keep that path
    lib = load_library()
    c = ctypes
    out = c.c_char_p()
    out_len = c.c_longlong()
    if lib.vn_stream_frame_encode(seq, body, len(body), c.byref(out),
                                  c.byref(out_len)) != 0:
        return None
    return ctypes.string_at(out, out_len.value)


def stream_frame_decode(blob: bytes) -> "Optional[tuple[int, bytes]]":
    """(seq, body) for a VSF1 frame; None on a non-frame blob."""
    lib = load_library()
    c = ctypes
    seq = c.c_ulonglong()
    off = lib.vn_stream_frame_decode(blob, len(blob), c.byref(seq))
    if off < 0:
        return None
    return seq.value, blob[off:]


def stream_ack_encode(seq: int, status: int) -> Optional[bytes]:
    """9 ack bytes (u64 LE seq + u8 status); None -> Python fallback."""
    if not 0 <= seq < 1 << 64 or not 0 <= status <= 0xFF:
        return None  # Python raises Overflow/ValueError; keep that path
    lib = load_library()
    buf = ctypes.create_string_buffer(9)
    lib.vn_stream_ack_encode(seq, status, buf)
    return buf.raw[:9]


def stream_ack_decode(blob: bytes) -> "Optional[tuple[int, int]]":
    """(seq, status) for a 9-byte ack; None on a non-ack blob."""
    lib = load_library()
    c = ctypes
    seq = c.c_ulonglong()
    status = lib.vn_stream_ack_decode(blob, len(blob), c.byref(seq))
    if status < 0:
        return None
    return seq.value, status


def dedup_header_encode(sender: bytes, dedup_id: int,
                        count: int) -> Optional[bytes]:
    """VDE1 envelope prefix (magic + u16 LE len + canonical JSON header)
    for a UTF-8 sender; the caller appends the body. None -> Python
    fallback (ints outside i64, malformed UTF-8); ValueError for the
    pinned too-large header."""
    if not (-(1 << 63) <= dedup_id < 1 << 63
            and -(1 << 63) <= count < 1 << 63):
        return None
    lib = load_library()
    c = ctypes
    out = c.c_char_p()
    out_len = c.c_longlong()
    rc = lib.vn_dedup_header_encode(sender, len(sender), dedup_id,
                                    count, c.byref(out),
                                    c.byref(out_len))
    if rc == -2:
        raise ValueError("dedup header too large")
    if rc != 0:
        return None
    return ctypes.string_at(out, out_len.value)


def dedup_header_parse(hdr: bytes) -> "Optional[tuple[str, int, int]]":
    """(sender, id, count) for a canonical VDE1 JSON header; None when
    the header is not canonical (the caller falls back to json.loads)."""
    lib = load_library()
    c = ctypes
    sender = c.c_char_p()
    sender_len = c.c_longlong()
    id_out = c.c_longlong()
    count_out = c.c_longlong()
    rc = lib.vn_dedup_header_parse(hdr, len(hdr), c.byref(sender),
                                   c.byref(sender_len), c.byref(id_out),
                                   c.byref(count_out))
    if rc != 0:
        return None
    return (ctypes.string_at(sender, sender_len.value).decode("utf-8"),
            id_out.value, count_out.value)


# --------------------------------------------------------------------------
# the load generator: wire-rate traffic synthesis, paced sending, capture
# and replay (native/loadgen.cpp, a library of its own so the ingest
# library never carries it)

LOADGEN_SOURCE = "loadgen.cpp"

_lg_lib = None
_lg_lock = threading.Lock()


def loadgen_source_stamp() -> str:
    """The Makefile's LG_SRC_HASH: the first 16 hex digits of the sha256
    of native/loadgen.cpp; the built library reports it back through
    ``loadgen_source_hash``."""
    return hashlib.sha256(
        (NATIVE_DIR / LOADGEN_SOURCE).read_bytes()).hexdigest()[:16]


def loadgen_library_path() -> Path:
    """Where the loadgen library built from this checkout's source
    lives (hashed as ``library_path`` hashes the ingest library)."""
    h = hashlib.sha256(loadgen_source_stamp().encode())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_cpu_model().encode())
    return BUILD_DIR / f"libveneur_loadgen-{h.hexdigest()[:12]}.so"


def build_loadgen() -> Path:
    """Compile native/loadgen.cpp with g++ unless this exact build
    exists; returns the library path. Raises RuntimeError with the
    compiler's message."""
    return _compile(loadgen_library_path(), (LOADGEN_SOURCE,),
                    f'-DLG_SOURCE_HASH="{loadgen_source_stamp()}"')


def load_loadgen_library() -> ctypes.CDLL:
    """The ctypes handle of the loadgen library (built on first call)."""
    global _lg_lib
    with _lg_lock:
        if _lg_lib is not None:
            return _lg_lib
        lib = ctypes.CDLL(str(build_loadgen()))
        c = ctypes
        lib.vn_lg_source_hash.restype = c.c_char_p
        lib.vn_lg_ring_new.restype = c.c_void_p
        lib.vn_lg_ring_free.argtypes = [c.c_void_p]
        lib.vn_lg_ring_count.restype = c.c_longlong
        lib.vn_lg_ring_count.argtypes = [c.c_void_p]
        lib.vn_lg_ring_total_lines.restype = c.c_longlong
        lib.vn_lg_ring_total_lines.argtypes = [c.c_void_p]
        lib.vn_lg_ring_total_bytes.restype = c.c_longlong
        lib.vn_lg_ring_total_bytes.argtypes = [c.c_void_p]
        lib.vn_lg_ring_hash.restype = c.c_uint64
        lib.vn_lg_ring_hash.argtypes = [c.c_void_p]
        lib.vn_lg_ring_datagram.restype = c.c_longlong
        lib.vn_lg_ring_datagram.argtypes = [
            c.c_void_p, c.c_longlong, c.POINTER(c.c_char_p)]
        lib.vn_lg_ring_append.restype = c.c_longlong
        lib.vn_lg_ring_append.argtypes = [
            c.c_void_p, c.c_char_p, c.c_longlong, c.c_int]
        lib.vn_lg_ring_synth.restype = c.c_longlong
        lib.vn_lg_ring_synth.argtypes = [
            c.c_void_p, c.c_uint64, c.c_longlong, c.c_double,
            c.POINTER(c.c_double), c.c_int, c.c_longlong,
            c.c_char_p, c.c_int, c.c_int, c.c_longlong,
            c.c_longlong, c.c_double, c.c_double, c.c_longlong]
        lib.vn_lg_ring_serialize.restype = c.c_longlong
        lib.vn_lg_ring_serialize.argtypes = [
            c.c_void_p, c.POINTER(c.c_char_p)]
        lib.vn_lg_ring_load.restype = c.c_longlong
        lib.vn_lg_ring_load.argtypes = [c.c_void_p, c.c_char_p,
                                        c.c_longlong]
        lib.vn_lg_send_start.restype = c.c_void_p
        lib.vn_lg_send_start.argtypes = [
            c.c_void_p, c.c_int, c.c_double, c.c_longlong, c.c_int]
        for name in ("vn_lg_send_lines", "vn_lg_send_packets",
                     "vn_lg_send_errors", "vn_lg_send_resyncs",
                     "vn_lg_send_stop"):
            fn = getattr(lib, name)
            fn.restype = c.c_longlong
            fn.argtypes = [c.c_void_p]
        lib.vn_lg_send_done.restype = c.c_int
        lib.vn_lg_send_done.argtypes = [c.c_void_p]
        lib.vn_lg_send_free.restype = None
        lib.vn_lg_send_free.argtypes = [c.c_void_p]
        lib.vn_lg_capture_start.restype = c.c_void_p
        lib.vn_lg_capture_start.argtypes = [c.c_int, c.c_int, c.c_longlong]
        for name in ("vn_lg_capture_packets", "vn_lg_capture_truncated",
                     "vn_lg_capture_stop"):
            fn = getattr(lib, name)
            fn.restype = c.c_longlong
            fn.argtypes = [c.c_void_p]
        lib.vn_lg_capture_detach_ring.restype = c.c_void_p
        lib.vn_lg_capture_detach_ring.argtypes = [c.c_void_p]
        lib.vn_lg_capture_free.argtypes = [c.c_void_p]
        _lg_lib = lib
        return _lg_lib


def loadgen_available() -> bool:
    """True when the loadgen library builds and loads here."""
    try:
        load_loadgen_library()
    except (RuntimeError, OSError) as e:
        log.info("loadgen library unavailable: %s", e)
        return False
    return True


def loadgen_source_hash() -> str:
    """The source stamp compiled into the loaded loadgen library."""
    return load_loadgen_library().vn_lg_source_hash().decode()


# fixed metric-type order for the synth type-mix weights
LOADGEN_TYPES = ("c", "g", "ms", "h", "s")


class LoadgenRing:
    """Pre-built datagram sequence: synthesize from a workload spec,
    append externally-built payloads (SSF), or load a captured blob.
    Immutable once handed to a sender."""

    def __init__(self) -> None:
        self._lib = load_loadgen_library()
        self._ring = self._lib.vn_lg_ring_new()

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.vn_lg_ring_free(self._ring)
            self._ring = None

    def __len__(self) -> int:
        return int(self._lib.vn_lg_ring_count(self._ring))

    @property
    def total_lines(self) -> int:
        return int(self._lib.vn_lg_ring_total_lines(self._ring))

    @property
    def total_bytes(self) -> int:
        return int(self._lib.vn_lg_ring_total_bytes(self._ring))

    @property
    def content_hash(self) -> int:
        """fnv1a64 over (length, bytes) pairs — the bit-exactness
        witness for capture→replay round trips."""
        return int(self._lib.vn_lg_ring_hash(self._ring))

    def datagram(self, i: int) -> bytes:
        out = ctypes.c_char_p()
        n = self._lib.vn_lg_ring_datagram(self._ring, i,
                                          ctypes.byref(out))
        if n < 0:
            raise IndexError(i)
        return ctypes.string_at(out, n)

    def datagrams(self) -> list[bytes]:
        return [self.datagram(i) for i in range(len(self))]

    def append(self, payload: bytes, lines: int = 1) -> None:
        """Append one externally-built datagram (SSF spans are built in
        Python once at setup; only the send loop is per-packet)."""
        if self._lib.vn_lg_ring_append(self._ring, payload, len(payload),
                                       lines) < 0:
            raise ValueError("bad payload")

    def synth(self, seed: int, n_keys: int, zipf_s: float,
              type_mix: "list[float]", n_tags: int, tag_card: int,
              prefix: bytes, dgram_target: int, n_lines: int,
              tenant_count: int = 1, tenant_abusive_frac: float = 0.0,
              tenant_zipf_s: float = 0.0,
              tenant_churn_keys: int = 0) -> int:
        """Build ~n_lines of DogStatsD traffic. type_mix is 5 weights
        in LOADGEN_TYPES order. tenant_count > 1 stamps a trailing
        tenant:tN tag per line (the last tenant is the abusive one);
        1 is byte-identical single-tenant output. Returns the
        datagram count."""
        mix = (ctypes.c_double * len(LOADGEN_TYPES))(*type_mix)
        n = self._lib.vn_lg_ring_synth(
            self._ring, seed, n_keys, float(zipf_s), mix, n_tags,
            tag_card, prefix, len(prefix), dgram_target, n_lines,
            int(tenant_count), float(tenant_abusive_frac),
            float(tenant_zipf_s), int(tenant_churn_keys))
        if n < 0:
            raise ValueError("invalid workload spec for synth")
        return int(n)

    def serialize(self) -> bytes:
        out = ctypes.c_char_p()
        n = self._lib.vn_lg_ring_serialize(self._ring, ctypes.byref(out))
        return ctypes.string_at(out, n)

    def load(self, blob: bytes) -> int:
        n = self._lib.vn_lg_ring_load(self._ring, blob, len(blob))
        if n < 0:
            raise ValueError("malformed ring blob")
        return int(n)


class LoadgenSender:
    """Paced C++ send thread cycling a ring over a connected socket.
    The caller owns the socket and the ring; both must outlive the
    sender (stop() joins the thread)."""

    def __init__(self, ring: LoadgenRing, fd: int, lines_per_s: float,
                 max_lines: int = 0, stream: bool = False) -> None:
        self._lib = ring._lib
        self._ring = ring  # keep alive
        self._h = self._lib.vn_lg_send_start(
            ring._ring, fd, float(lines_per_s), int(max_lines),
            1 if stream else 0)
        if not self._h:
            raise RuntimeError("vn_lg_send_start failed (empty ring?)")

    @property
    def sent_lines(self) -> int:
        return int(self._lib.vn_lg_send_lines(self._h))

    @property
    def sent_packets(self) -> int:
        return int(self._lib.vn_lg_send_packets(self._h))

    @property
    def send_errors(self) -> int:
        return int(self._lib.vn_lg_send_errors(self._h))

    @property
    def resyncs(self) -> int:
        return int(self._lib.vn_lg_send_resyncs(self._h))

    @property
    def done(self) -> bool:
        return bool(self._lib.vn_lg_send_done(self._h))

    def stop(self) -> float:
        """Join the send thread (idempotent); the final counters stay
        readable afterwards. Returns the loop's elapsed seconds."""
        if not self._h:
            return 0.0
        return self._lib.vn_lg_send_stop(self._h) / 1e9

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._h = None
            self._lib.vn_lg_send_free(h)


class LoadgenCapture:
    """C++ capture thread recording datagrams off a bound socket for
    bit-exact replay. The caller owns the fd (kept blocking with a
    100ms receive timeout, like the ingest readers)."""

    def __init__(self, fd: int, max_len: int = 65536,
                 max_packets: int = 0) -> None:
        self._lib = load_loadgen_library()
        self._h = self._lib.vn_lg_capture_start(fd, max_len, max_packets)
        if not self._h:
            raise RuntimeError("vn_lg_capture_start failed")
        self._stopped = False

    @property
    def packets(self) -> int:
        return int(self._lib.vn_lg_capture_packets(self._h))

    @property
    def truncated(self) -> int:
        return int(self._lib.vn_lg_capture_truncated(self._h))

    def stop(self) -> int:
        if not self._stopped:
            self._lib.vn_lg_capture_stop(self._h)
            self._stopped = True
        return self.packets

    def detach_ring(self) -> LoadgenRing:
        """Move the captured datagrams into a fresh ring (stop first)."""
        self.stop()
        handle = self._lib.vn_lg_capture_detach_ring(self._h)
        if not handle:
            raise RuntimeError("capture detach failed")
        ring = LoadgenRing.__new__(LoadgenRing)
        ring._lib = self._lib
        ring._ring = handle
        return ring

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.vn_lg_capture_free(self._h)
            self._h = None
