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
``encode_forward_lines``, ``encode_prometheus_exposition``, ``deflate``).
The archive, codec, stream-frame, dedup, SSF, reader-shard and loadgen
entry points wait for their slices.

The library is built from the sources in ``native/`` at first use, by
g++ with the flags of native/Makefile, into ``build/native/`` at the
repository root (a directory .gitignore lists), under a name hashed from
the sources, the flags and the host's CPU (the flags hold -march=native).
It never runs ``make`` in ``native/``, whose library belongs to the JAX
package. A failed build raises with the compiler's message: nothing here
falls back to the Python parser.
"""

from __future__ import annotations

import ctypes
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


def build() -> Path:
    """Compile native/ with g++ unless this exact build exists; returns
    the library path. Raises RuntimeError with the compiler's message."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, f'-DVN_SOURCE_HASH="{source_stamp()}"', "-shared",
           "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES), "-lz"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native build: {cxx} could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


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
                     "vn_pending_new_series"):
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
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


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

    def ingest(self, datagram: bytes) -> int:
        return self._lib.vn_ingest(self._ctx, datagram, len(datagram))

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

    # staging plane ----------------------------------------------------------

    def set_stage_depth(self, depth: int) -> None:
        """Enable the C++ raw-sample staging plane with B slots per
        histogram row (0 disables); detach_stage() pulls it at flush."""
        self._lib.vn_set_stage_depth(self._ctx, depth)

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
