"""Global-side ingest: receive forwarded sketches into device workers.

Parity: reference importsrv (importsrv/server.go:38-148) — SendMetrics
hashes each metric's identity, batches per worker, and merges into worker
state; plus the HTTP `POST /import` path (handlers_global.go:60-196,
http.go:63-140) with deflate support.

A copy of veneur_tpu/distributed/import_server.py with its imports
rebound.
"""

from __future__ import annotations

import json
import logging
import time
import threading
import zlib
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import grpc

from veneur_tpu_torch.distributed import codec, rpc
from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb
from veneur_tpu_torch.utils.http import APIHandlerBase

log = logging.getLogger("veneur_tpu_torch.import")


def _import_scope(m: pb.Metric):
    """The scope class an imported metric's series will occupy — the same
    fixups ``codec.apply_to_worker`` / ``handle_wire`` apply (counters and
    gauges forced global, HLLs mixed) so the tenant ledger charges the
    exact (key, scope) identity the directory will row."""
    from veneur_tpu_torch.core.directory import ScopeClass
    from veneur_tpu_torch.distributed.codec import _SCOPE_FROM_PB

    which = m.WhichOneof("value")
    if which in ("counter", "gauge"):
        return ScopeClass.GLOBAL
    if which == "hll":
        return ScopeClass.MIXED
    return _SCOPE_FROM_PB.get(m.scope, ScopeClass.MIXED)


class DedupWindow:
    """Bounded memory of recently seen idempotency keys, per sender.

    Exactly-once enforcement on the import path: a forward payload whose
    ``(sender, id)`` was already accepted is a replay (retry after a
    deadline-clipped send, handoff re-send, crash-journal replay,
    duplicate injection) and must not re-merge. The window is an LRU
    capped by BOTH id count and modeled bytes; hitting a cap evicts
    oldest-first, which honestly degrades that sender's oldest ids back
    to at-least-once — counted in ``evictions``, never blocking ingest.
    """

    # modeled per-entry overhead beyond the sender string: dict node,
    # key tuple, boxed int (PERF_MODEL.md "Dedup window memory")
    ENTRY_OVERHEAD_BYTES = 100

    def __init__(self, max_ids: int = 65536,
                 max_bytes: int = 8 << 20) -> None:
        self.max_ids = max(1, int(max_ids))
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()
        self._seen: "OrderedDict[Tuple[str, int], int]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.inserts = 0
        self.evictions = 0

    @staticmethod
    def _entry_bytes(sender: str) -> int:
        return DedupWindow.ENTRY_OVERHEAD_BYTES + len(sender)

    def seen_or_insert(self, sender: str, dedup_id: int) -> bool:
        """True if (sender, id) was already seen (a replay); else insert
        it and return False. The check-and-insert is atomic so two
        concurrent replays racing through the handler pool can't both
        merge; the caller must ``forget`` on a failed merge."""
        key = (sender, dedup_id)
        with self._lock:
            if key in self._seen:
                self._seen.move_to_end(key)
                self.hits += 1
                return True
            nbytes = self._entry_bytes(sender)
            self._seen[key] = nbytes
            self._bytes += nbytes
            self.inserts += 1
            while self._seen and (len(self._seen) > self.max_ids
                                  or self._bytes > self.max_bytes):
                _, evicted = self._seen.popitem(last=False)
                self._bytes -= evicted
                self.evictions += 1
            return False

    def forget(self, sender: str, dedup_id: int) -> None:
        with self._lock:
            nbytes = self._seen.pop((sender, dedup_id), None)
            if nbytes is not None:
                self._bytes -= nbytes

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "inserts": self.inserts,
                "evictions": self.evictions,
                "window_ids": len(self._seen),
                "window_bytes": self._bytes,
                "max_ids": self.max_ids,
                "max_bytes": self.max_bytes,
            }


class StreamCoalescer:
    """Cross-sender server-side batching for streamed forward frames
    (reference importsrv: SendMetrics batches per worker across calls;
    here frames from every live StreamMetrics sender funnel into one
    pending batch before the merge path).

    submit() never blocks the stream reader on a merge: frames
    accumulate under a lock and flush either inline when the pending
    batch crosses the frame/byte thresholds (the arriving thread pays
    for the merge) or from the group-commit flusher, which merges the
    moment frames exist and lets whatever arrives during an in-flight
    merge form the next batch — trickle traffic acks at merge latency,
    loaded streams batch automatically, and no timer ever holds an ack
    hostage. Each frame is dedup-checked individually before
    its bare body joins the concatenated MetricBatch — serialized
    protobuf concatenation merges repeated fields, so N frames admit
    through ONE _apply_wire (one decode + one worker-lock sweep per
    shard). Acks are issued strictly AFTER the merge lands, so a
    sender's "delivered" is the same durable fact it was on the unary
    path; a replayed frame acks without re-merging."""

    def __init__(self, import_server, max_frames: int = 64,
                 max_bytes: int = 1 << 20,
                 auto_flush: bool = True) -> None:
        self._imp = import_server
        self.max_frames = max(1, int(max_frames))
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()
        self._pending: list = []  # (body, done) in arrival order
        self._pending_bytes = 0
        self._stop = threading.Event()
        self._kick = threading.Event()
        self.batches = 0
        self.frames = 0
        self.coalesced_frames = 0  # frames that shared a batch
        self.max_frames_per_batch = 0
        self.frame_failures = 0
        self.batch_fallbacks = 0
        self._thread = None
        if auto_flush:
            self._thread = threading.Thread(
                target=self._flush_loop, daemon=True, name="import-coalesce")
            self._thread.start()

    def submit(self, body: bytes, done) -> None:
        items = None
        with self._lock:
            self._pending.append((body, done))
            self._pending_bytes += len(body)
            if (len(self._pending) >= self.max_frames
                    or self._pending_bytes >= self.max_bytes):
                items = self._take_locked()
            else:
                self._kick.set()
        if items:
            self._flush(items)

    def _take_locked(self) -> list:
        items = self._pending
        self._pending = []
        self._pending_bytes = 0
        return items

    def _flush_loop(self) -> None:
        # group commit: merge as soon as frames exist. The batch size is
        # set by how many frames land while the previous merge runs, so
        # latency stays at merge cost under trickle and batching scales
        # with load — a timer here would tax every ack to help only the
        # idle case (an idle stream costs ~2 wakeups/s via the 0.5s wait)
        while not self._stop.is_set():
            self._kick.wait(0.5)
            self._kick.clear()
            while True:
                with self._lock:
                    items = self._take_locked() if self._pending else None
                if not items:
                    break
                self._flush(items)

    def close(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        with self._lock:
            items = self._take_locked()
        if items:
            self._flush(items)

    def _flush(self, items: list) -> None:
        imp = self._imp
        bodies: list[bytes] = []
        slots: list = []  # (done, dedup_key | None) parallel to bodies
        failures = 0
        for body, done in items:
            try:
                key, bare = codec.decode_dedup_envelope(body)
            except ValueError:
                failures += 1
                done(False)
                continue
            if key is not None and imp.dedup_enabled:
                sender, dedup_id, count = key
                if imp.dedup.seen_or_insert(sender, dedup_id):
                    imp.note_deduped(count)
                    done(True)
                    continue
                slots.append((done, (sender, dedup_id)))
            else:
                slots.append((done, None))
            bodies.append(bare)
        fallbacks = 0
        if bodies:
            try:
                imp._apply_wire(b"".join(bodies))
            except Exception:
                # the concatenated decode failed before any merge; apply
                # per frame so one bad frame doesn't poison its batch
                fallbacks = 1
                for (done, key), bare in zip(slots, bodies):
                    try:
                        imp._apply_wire(bare)
                    except Exception:
                        if key is not None:
                            imp.dedup.forget(*key)
                        failures += 1
                        done(False)
                    else:
                        done(True)
                slots = []
            for done, _key in slots:
                done(True)
        with self._lock:
            self.batches += 1
            self.frames += len(items)
            if len(items) > 1:
                self.coalesced_frames += len(items)
            if len(items) > self.max_frames_per_batch:
                self.max_frames_per_batch = len(items)
            self.frame_failures += failures
            self.batch_fallbacks += fallbacks

    def stats(self) -> dict:
        with self._lock:
            return {
                "batches": self.batches,
                "frames": self.frames,
                "coalesced_frames": self.coalesced_frames,
                "max_frames_per_batch": self.max_frames_per_batch,
                "frame_failures": self.frame_failures,
                "batch_fallbacks": self.batch_fallbacks,
                "pending_frames": len(self._pending),
            }


class ImportServer:
    """Receives MetricBatch RPCs and routes metrics into a server's
    workers by identity digest (one series → one worker shard,
    importsrv/server.go:107-125)."""

    def __init__(self, server) -> None:
        self.server = server
        self.grpc_server: Optional[grpc.Server] = None
        self.port: Optional[int] = None
        self.address: Optional[str] = None
        self.received_metrics = 0
        self.import_errors = 0
        self.tenant_rejected_metrics = 0
        self.metrics_deduped = 0
        self.last_import_unix = 0.0
        # exactly-once replay rejection, sized by the server config when
        # present; the window outlives gRPC stop/start cycles (it hangs
        # off THIS object), so a replay across a listener restart still
        # dedups
        cfg = getattr(server, "config", None)
        self.dedup_enabled = bool(getattr(cfg, "forward_dedup", True))
        self.dedup = DedupWindow(
            max_ids=getattr(cfg, "forward_dedup_window_ids", 65536),
            max_bytes=getattr(cfg, "forward_dedup_window_bytes", 8 << 20))
        # concurrent imports (one thread per HTTP request + gRPC handlers)
        # hold different worker locks; the tallies need their own
        self._stats_lock = threading.Lock()
        # stream receiver: created on first start_grpc, survives listener
        # stop/start cycles like the dedup window does (a replay across a
        # restart still batches and still dedups)
        self._coalescer: Optional[StreamCoalescer] = None

    def handle_batch(self, batch: pb.MetricBatch) -> None:
        started = time.time()
        workers = self.server.workers
        locks = self.server._worker_locks
        # pre-sort into per-worker chunks so each lock is taken once
        chunks: dict[int, list] = {}
        for m in batch.metrics:
            i = codec.routing_digest(m) % len(workers)
            chunks.setdefault(i, []).append(m)
        # per-tenant budget enforcement on the import path (ROADMAP open
        # item 4): the global tier is the cardinality chokepoint — every
        # local's forwarded mixed-scope series lands here — so an
        # unbudgeted /import would let one tenant blow past the exact cap
        # the ingest path enforces. Same ledger, same tallies (into the
        # receiving worker's per-epoch TenantTallies under its held
        # lock), so per-tenant conservation stays exact across tiers.
        ledger = getattr(self.server, "tenant_ledger", None)
        if ledger is not None:
            from veneur_tpu_torch.core.metrics import tenant_of
            from veneur_tpu_torch.core.worker import _series_budget_id
        received = errors = budget_rejected = 0
        for i, metrics in chunks.items():
            with locks[i]:
                w = workers[i]
                for m in metrics:
                    if ledger is not None:
                        tenant = tenant_of(list(m.tags), ledger.tag_key)
                        tt = w.tenant_tallies
                        tt.accepted[tenant] = (
                            tt.accepted.get(tenant, 0) + 1)
                        if not ledger.admit(
                                tenant, _series_budget_id(
                                    _import_scope(m), codec.metric_key(m))):
                            tt.rejected[tenant] = (
                                tt.rejected.get(tenant, 0) + 1)
                            budget_rejected += 1
                            continue
                        tt.kept[tenant] = tt.kept.get(tenant, 0) + 1
                    try:
                        codec.apply_to_worker(w, m)
                        received += 1
                    except ValueError as e:
                        errors += 1
                        log.debug("rejected import %s: %s", m.name, e)
        with self._stats_lock:
            self.received_metrics += received
            self.import_errors += errors
            self.tenant_rejected_metrics += budget_rejected
            self.last_import_unix = time.time()
        stats = getattr(self.server, "stats", None)
        if stats is not None:
            # canonical import telemetry (README.md:295: the merge part
            # of response_duration_ns; request decode is timed by the
            # HTTP handler)
            stats.time_in_nanoseconds(
                "import.response_duration_ns",
                (time.time() - started) * 1e9, tags=["part:merge"])

    def handle_wire(self, blob: bytes) -> int:
        """Apply a forward wire blob; returns the metric count seen
        (applied + rejected + deduped).

        A blob may arrive wrapped in the versioned idempotency envelope
        (codec.encode_dedup_envelope); a replayed (sender, id) is
        acknowledged WITHOUT re-merging — the original delivery already
        counted — at the envelope's metric count, so the sender's
        ledger and the HTTP 200 path see a normal acceptance.
        Headerless blobs (dedup-unaware senders) keep the exact
        at-least-once semantics they always had."""
        key, blob = codec.decode_dedup_envelope(blob)
        if key is None or not self.dedup_enabled:
            return self._apply_wire(blob)
        sender, dedup_id, count = key
        if self.dedup.seen_or_insert(sender, dedup_id):
            self.note_deduped(count)
            return count
        try:
            return self._apply_wire(blob)
        except Exception:
            # the merge did NOT land: a retry of this id is a fresh
            # attempt, not a replay
            self.dedup.forget(sender, dedup_id)
            raise

    def _apply_wire(self, blob: bytes) -> int:
        """Apply a bare serialized MetricBatch. Fast path: the C++ wire
        decoder + batched native directory upsert (one lock hold per
        worker chunk) — no per-metric Python protobuf objects. Falls
        back to the Python path (which raises DecodeError on malformed
        bytes) when the native library is unavailable, any worker lacks
        a native context, or the blob needs the lenient per-metric
        handling."""
        import numpy as np

        from veneur_tpu_torch.core.directory import ScopeClass
        from veneur_tpu_torch import native as native_mod

        workers = self.server.workers
        d = None
        if (getattr(self.server, "native_mode", False)
                and getattr(self.server, "tenant_ledger", None) is None):
            # tenancy admission needs each metric's tags, which the
            # native decode keeps as an opaque meta blob — with budgets
            # configured the Python batch path (which enforces them)
            # wins over the fast path: budgets are an incident defense,
            # and an unbudgeted fast lane is exactly the bypass an
            # abusive tenant would ride
            d = native_mod.decode_metric_batch(blob)
        if d is None:
            batch = pb.MetricBatch.FromString(blob)
            self.handle_batch(batch)
            return len(batch.metrics)
        if d.n == 0:
            return 0
        started = time.time()
        locks = self.server._worker_locks
        vk = d.value_kind
        # scope fixups, exactly as codec.apply_to_worker: counters and
        # gauges are forced global, HLLs mixed; local digests rejected
        # (reference ImportMetricGRPC, worker.go:438-495)
        scopes = d.scopes.copy()
        scopes[(vk == 1) | (vk == 2)] = int(ScopeClass.GLOBAL)
        scopes[vk == 4] = int(ScopeClass.MIXED)
        # the batched upsert pools rows by KIND while values apply by
        # VALUE type, so a metric whose kind disagrees with its value
        # would alias a row in the wrong pool — reject the mismatch
        # (our forwarders never produce one; wire input is untrusted)
        kinds = d.kinds
        kind_ok = (((vk == 1) & (kinds == 0))
                   | ((vk == 2) & (kinds == 1))
                   | ((vk == 3) & ((kinds == 2) | (kinds == 3)))
                   | ((vk == 4) & (kinds == 4)))
        bad = (vk == 0) | ~kind_ok | (
            (vk == 3) & (scopes == int(ScopeClass.LOCAL)))
        errors = int(bad.sum())
        ok = ~bad
        shard = d.digests % np.uint32(len(workers))
        received = 0
        cent_off = d.cent_off
        for i, w in enumerate(workers):
            sel = ok & (shard == i)
            nsel = int(sel.sum())
            if not nsel:
                continue
            with locks[i]:
                rows = native_mod.upsert_many(
                    w._native, d.meta, d.kinds, scopes, sel)
                # adopt new series now: the batched drain keeps the
                # Python directory mirror in lockstep
                w._sync_native_series()
                # reader-shard mode: upsert_many rows are home-context-
                # LOCAL; the import appliers below address canonical
                # pool rows (identity on the legacy path)
                rows = w.native_rows_canonical(rows, d.kinds, sel)
                hmask = sel & (vk == 3)
                if hmask.any():
                    idx = np.nonzero(hmask)[0]
                    w.import_digests_soa(
                        rows[idx], cent_off[idx], cent_off[idx + 1],
                        d.cent_means, d.cent_weights, d.dmin[idx],
                        d.dmax[idx], d.drecip[idx])
                cmask = sel & (vk == 1)
                if cmask.any():
                    w.import_counter_rows(rows[cmask], d.scalars[cmask])
                gmask = sel & (vk == 2)
                if gmask.any():
                    w.import_gauge_rows(rows[gmask], d.scalars[gmask])
                smask = sel & (vk == 4)
                if smask.any():
                    hll_off = d.hll_off
                    for j in np.nonzero(smask)[0].tolist():
                        regs = np.frombuffer(
                            d.hll_bytes[hll_off[j]:hll_off[j + 1]],
                            np.int8)
                        try:
                            w.import_hll_row(int(rows[j]), regs)
                        except ValueError as e:
                            errors += 1
                            nsel -= 1
                            log.debug("rejected import: %s", e)
            received += nsel
        with self._stats_lock:
            self.received_metrics += received
            self.import_errors += errors
            self.last_import_unix = time.time()
        stats = getattr(self.server, "stats", None)
        if stats is not None:
            stats.time_in_nanoseconds(
                "import.response_duration_ns",
                (time.time() - started) * 1e9, tags=["part:merge"])
        return int(d.n)

    def note_deduped(self, count: int) -> None:
        """Record a replay absorbed by the dedup window (unary handler
        and stream coalescer both report through here)."""
        with self._stats_lock:
            self.metrics_deduped += count
            self.last_import_unix = time.time()

    def start_grpc(self, address: str = "127.0.0.1:0") -> int:
        """Start (or RESTART after stop — the churn soak's kill/restart
        cycle rebinds the same port) the gRPC listener."""
        if self._coalescer is None:
            # group-commit byte budget tracks the senders' frame target
            # (a few sender frames per merged batch); max_frames stays
            # the safety cap against pathological tiny-frame floods
            cfg = getattr(self.server, "config", None)
            frame_bytes = int(
                getattr(cfg, "forward_stream_frame_bytes", 262144)
                or 262144)
            self._coalescer = StreamCoalescer(
                self, max_bytes=max(1 << 20, 4 * frame_bytes))
        self.grpc_server, self.port = rpc.make_server(
            self.handle_batch, address, raw_handler=self.handle_wire,
            stream_sink=self._coalescer)
        self.address = f"{address.rsplit(':', 1)[0]}:{self.port}"
        return self.port

    def stop(self, grace: float = 1.0) -> None:
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=grace).wait()
            self.grpc_server = None

    def ready(self) -> bool:
        """Readiness for the elastic tier's admission probe: the
        listener is up (elastic.tcp_probe checks the same thing from
        the proxy's side of the network)."""
        return self.grpc_server is not None

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "address": self.address,
                "received_metrics": self.received_metrics,
                "import_errors": self.import_errors,
                "tenant_rejected_metrics": self.tenant_rejected_metrics,
                "metrics_deduped": self.metrics_deduped,
                "last_import_unix": self.last_import_unix,
                "serving": self.grpc_server is not None,
                "dedup": self.dedup.stats(),
                "stream": (self._coalescer.stats()
                           if self._coalescer is not None else None),
            }


def decode_http_import_body(body: bytes, content_encoding: str
                            ) -> pb.MetricBatch:
    """Decode an HTTP /import request body.

    Accepts the protobuf MetricBatch directly, or a JSON array of
    {name, type, tags, scope, value} where value is the base64 protobuf
    Metric (the curl-able analog of the reference's JSONMetric+gob format,
    handlers_global.go:117-196). deflate (zlib) bodies are accepted either
    way (reference http.go import encodings).
    """
    if content_encoding == "deflate":
        body = zlib.decompress(body)
    elif content_encoding:
        # reference returns 400 for any other encoding (gzip included,
        # TestServerImportGzip)
        raise ValueError(f"unsupported Content-Encoding {content_encoding!r}")
    if not body:
        raise ValueError("empty import body")
    if body[:1] in (b"[", b"{"):
        import base64

        items = json.loads(body.decode("utf-8"))
        if not isinstance(items, list) or not items:
            # an empty list is usually the sign of a client bug
            # (TestServerImportEmptyListError)
            raise ValueError("import body must be a non-empty metric list")
        batch = pb.MetricBatch()
        for item in items:
            if "tagstring" in item:
                # a stock Go veneur local's JSONMetric body
                # (samplers.go:102-108; gob/LE/HLL value encodings).
                # One bad entry skips, it does not fail the batch — the
                # reference logs and continues per metric
                # (worker.go:430-432 unknown type, per-Combine errors)
                from veneur_tpu_torch.distributed.interop import (
                    go_jsonmetric_to_internal,
                )

                try:
                    m = go_jsonmetric_to_internal(item)
                except (ValueError, KeyError) as e:
                    log.debug("skipping bad JSONMetric entry %r: %s",
                              item.get("name"), e)
                    continue
                if m is not None:
                    batch.metrics.append(m)
                continue
            # native JSON entries (not Go JSONMetric) still fail the whole
            # batch on a missing value: there is no reference per-metric
            # skip contract for our own format, and a 400 surfaces the
            # client bug immediately
            if "value" not in item:
                raise ValueError("metric entry lacks a value field")
            m = pb.Metric.FromString(base64.b64decode(item["value"]))
            batch.metrics.append(m)
        return batch
    batch = pb.MetricBatch.FromString(body)
    if not batch.metrics:
        raise ValueError("import batch contains no metrics")
    return batch


class ImportHTTPServer:
    """HTTP server exposing the reference Server.Handler surface
    (http.go:22-60): /healthcheck, /healthcheck/tracing, /version,
    /builddate, POST /import, optional POST /quitquitquit (http_quit),
    and a /debug/pprof analog (live Python thread stack dump)."""

    def __init__(self, import_server: ImportServer) -> None:
        self.import_server = import_server
        self.httpd: Optional[ThreadingHTTPServer] = None
        self.port: Optional[int] = None

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        imp = self.import_server
        srv = imp.server
        version = srv.version if srv else "unknown"
        build_date = getattr(srv, "build_date", "dev") if srv else "dev"
        http_quit = bool(srv and srv.config.http_quit)

        class Handler(APIHandlerBase, BaseHTTPRequestHandler):
            version_string_body = version

            def do_GET(self):
                if self.handle_common_get():
                    return
                if self.path == "/builddate":
                    self._respond(200, str(build_date).encode())
                else:
                    self._respond(404, b"not found")

            def do_POST(self):
                if self.path == "/quitquitquit" and http_quit:
                    # graceful shutdown endpoint (reference http.go:37-44)
                    self._respond(200, b"Beginning graceful shutdown....\n")
                    threading.Thread(
                        target=srv.shutdown, daemon=True, name="http-quit"
                    ).start()
                    return
                if self.path != "/import":
                    self._respond(404, b"not found")
                    return
                # cross-hop trace propagation: continue the forwarder's
                # trace when headers carry one (reference handleImport via
                # ExtractRequestChild, handlers_global.go:60-72,81)
                from veneur_tpu_torch.trace.opentracing import traced_server_hop

                with traced_server_hop(
                        dict(self.headers), "veneur.import",
                        resource="/import",
                        tracer=srv.tracer if srv else None) as span:
                    req_start = time.time()
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length)
                    stats = getattr(srv, "stats", None) if srv else None
                    try:
                        enc = self.headers.get("Content-Encoding", "")
                        if enc == "deflate":
                            body = zlib.decompress(body)
                            enc = ""
                        if body and body[:1] not in (b"[", b"{"):
                            # binary protobuf body: the native wire path
                            # decodes and applies it; malformed bytes
                            # raise (DecodeError from the fallback) and
                            # an empty batch is the client bug the
                            # reference 400s
                            if imp.handle_wire(body) == 0:
                                raise ValueError(
                                    "import batch contains no metrics")
                        else:
                            # JSON bodies keep the lenient per-metric
                            # decode path
                            imp.handle_batch(decode_http_import_body(
                                body, enc))
                    except Exception as e:
                        if stats is not None:
                            stats.count("import.request_error_total", 1,
                                        tags=["cause:decode"])
                        if span is not None:
                            span.set_error()
                        self._respond(400,
                                      f"bad import body: {e}".encode())
                        return
                    if stats is not None:
                        stats.time_in_nanoseconds(
                            "import.response_duration_ns",
                            (time.time() - req_start) * 1e9,
                            tags=["part:request"])
                    self._respond(200, b"accepted")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                             name="import-http")
        t.start()
        return self.port

    def stop(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
