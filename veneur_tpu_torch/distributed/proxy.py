"""Proxy tier: ring-route forwarded metrics across global instances.

Parity: reference proxysrv (proxysrv/server.go:44-384 — gRPC proxy with a
connection map pruned on membership change, fire-and-forget forwarding) and
the veneur-proxy HTTP tier (proxy.go:40-687 — ring routing, periodic
service-discovery refresh keeping last-good destinations on error).

Live-membership robustness (the layer over that skeleton):

- Every forward send runs through a per-destination DeliveryManager
  (sinks/delivery.py — the same retry/breaker/bounded-spill machinery
  the sinks use): transient failures retry with backoff+jitter
  clipped to the handoff window, a dead global costs one breaker probe
  per drain interval, and failed fragments spill bounded instead of
  dropping on first error. The conservation contract extends across the
  tier: every metric accepted by the proxy is delivered, declared
  dropped, or sitting in a bounded spill — exactly.
- Ring reshard handoff: set_destinations reshards the ring (versioned;
  distributed/ring.py) and wakes the drain thread, which re-routes every
  spilled fragment under the NEW ring within a bounded handoff window —
  a join/leave loses no interval. Fragments carry their per-record
  placement hashes/keys so re-routing never re-decodes payloads.
- Bounded routing executor: handle_batch/handle_wire enqueue onto a
  fixed worker pool over a bounded queue (health/policy.py
  routing_should_shed) instead of spawning a daemon thread per batch;
  a full queue sheds the batch with honest per-metric drop counters and
  feeds the downstream-behind signal.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import random
import socket
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import grpc

from veneur_tpu_torch.distributed import codec, rpc
from veneur_tpu_torch.distributed.ring import ConsistentRing
from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb
from veneur_tpu_torch.health.policy import (
    ROUTING_QUEUE_MAX,
    delivery_should_signal_behind,
    routing_should_shed,
)
from veneur_tpu_torch.sinks.delivery import DeliveryManager, DeliveryPolicy
from veneur_tpu_torch.utils.http import parse_host_port
from veneur_tpu_torch.protocol import ssf_wire

log = logging.getLogger("veneur_tpu_torch.proxy")


class _Fragment:
    """One ring-routed slice of a forwarded batch, carrying enough
    context to be RE-routed under a newer ring after a spill: the raw
    record byte-slices plus each record's placement hash (wire path),
    or the pb.Metric objects plus each metric's key string (protobuf
    path). `meta[i]` always places `parts[i]`.

    Exactly-once context (dedup mode): `dedup_id` is the wire-level
    idempotency key, minted at delivery checkout for `minted_for` and
    journaled with the fragment so crash replay re-sends the SAME key;
    `attempts`/`last_cause` record whether a prior send may have landed
    (a deadline-clipped attempt is ambiguous — the receiver may hold the
    data), which governs whether a reshard may split the fragment."""

    __slots__ = ("wire", "parts", "meta", "count", "nbytes",
                 "dedup_id", "minted_for", "attempts", "last_cause")

    def __init__(self, wire: bool, parts: list, meta: list) -> None:
        self.wire = wire
        self.parts = parts
        self.meta = meta
        self.count = len(parts)
        self.nbytes = (sum(len(p) for p in parts) if wire
                       else sum(m.ByteSize() for m in parts))
        self.dedup_id: Optional[int] = None
        self.minted_for: Optional[str] = None
        self.attempts = 0
        self.last_cause: Optional[str] = None


def _fragment_encode(frag: _Fragment) -> bytes:
    """Serialize a fragment for the write-ahead spill journal
    (utils/journal.py): a JSON header (wire flag, placement meta, part
    lengths) + the concatenated part bytes. Both routing paths are
    journalable — wire parts ARE bytes; batch parts serialize via
    pb.Metric. The journal checksums the whole record."""
    if frag.wire:
        parts = frag.parts
    else:
        parts = [m.SerializeToString() for m in frag.parts]
    meta: dict = {"w": 1 if frag.wire else 0, "meta": list(frag.meta),
                  "lens": [len(p) for p in parts]}
    if frag.dedup_id is not None:
        # the idempotency key must survive the crash WITH the payload:
        # replay re-sends under the original id so the receiver's window
        # rejects what the dead incarnation already delivered
        meta["did"] = frag.dedup_id
        meta["dfor"] = frag.minted_for
        meta["att"] = frag.attempts
        if frag.last_cause:
            meta["lc"] = frag.last_cause
    hdr = json.dumps(meta, separators=(",", ":")).encode()
    return hdr + b"\n" + b"".join(parts)


def _fragment_decode(blob: bytes) -> Optional[_Fragment]:
    """Inverse of _fragment_encode; None on any malformation (the
    caller acks-and-counts, never crashes on a stale or foreign
    record)."""
    nl = blob.find(b"\n")
    if nl < 0:
        return None
    try:
        hdr = json.loads(blob[:nl])
        wire = bool(hdr["w"])
        meta = list(hdr["meta"])
        lens = [int(n) for n in hdr["lens"]]
    except (ValueError, KeyError, TypeError):
        return None
    if len(meta) != len(lens) or sum(lens) != len(blob) - nl - 1:
        return None
    parts: list = []
    off = nl + 1
    for n in lens:
        parts.append(blob[off:off + n])
        off += n
    if not wire:
        try:
            parts = [pb.Metric.FromString(p) for p in parts]
        except Exception:  # noqa: BLE001 — foreign/corrupt protobuf
            return None
    frag = _Fragment(wire, parts, meta)
    if hdr.get("did") is not None:
        try:
            frag.dedup_id = int(hdr["did"])
            frag.minted_for = hdr.get("dfor")
            frag.attempts = int(hdr.get("att", 0))
            frag.last_cause = hdr.get("lc")
        except (ValueError, TypeError):
            frag.dedup_id = None
    return frag


def _entry_encode(entry) -> Optional[bytes]:
    """DeliveryManager journal-encode hook: only routed fragments carry
    durable context; foreign deliver() callers stay RAM-only."""
    frag = entry.payload
    if not isinstance(frag, _Fragment):
        return None
    return _fragment_encode(frag)


class RoutingPool:
    """Bounded routing executor: a fixed worker pool drains a bounded
    queue of forwarded batches. Replaces the unbounded per-batch daemon
    thread spawn — a slow global tier now surfaces as a full queue and
    honest shed counters (routing_should_shed) instead of unbounded
    proxy threads and memory. consecutive_sheds feeds the same
    ≥2-consecutive gate the sink delivery layer uses for its
    downstream-behind signal."""

    def __init__(self, route_fn: Callable[[str, object], None],
                 workers: int = 4,
                 queue_max: int = ROUTING_QUEUE_MAX) -> None:
        self._route = route_fn
        self.workers = max(1, int(workers))
        self.queue_max = max(1, int(queue_max))
        self._q: queue.Queue = queue.Queue(self.queue_max)
        self._stopping = False
        self._lock = threading.Lock()
        self.submitted = 0
        self.routed = 0
        self.shed_batches = 0
        self.consecutive_sheds = 0
        self.admission_timeouts = 0  # stream frames busy-acked back
        self._threads = []
        for i in range(self.workers):
            t = threading.Thread(target=self._work, daemon=True,
                                 name=f"proxy-route-{i}")
            t.start()
            self._threads.append(t)

    def submit(self, kind: str, item: object) -> bool:
        """Enqueue one batch for routing; False means SHED (queue full —
        the caller owns the per-metric drop accounting)."""
        if self._stopping:
            with self._lock:
                self.shed_batches += 1
                self.consecutive_sheds += 1
            return False
        if not routing_should_shed(self._q.qsize(), self.queue_max):
            try:
                self._q.put_nowait((kind, item))
            except queue.Full:
                pass  # raced to full between the check and the put
            else:
                with self._lock:
                    self.submitted += 1
                    self.consecutive_sheds = 0
                return True
        with self._lock:
            self.shed_batches += 1
            self.consecutive_sheds += 1
        return False

    def submit_wait(self, kind: str, item: object,
                    timeout_s: float) -> bool:
        """Blocking admission for streamed ingest: wait for queue space
        instead of shedding. False means NOT ADMITTED — the caller
        still owns the payload (nothing was dropped here), and reports
        that upstream so the sender's delivery layer retries it."""
        if self._stopping:
            # busy-ack during shutdown: the sender re-routes the frame
            # to a live proxy instead of us acking work we won't do
            return False
        try:
            self._q.put((kind, item), timeout=timeout_s)
        except queue.Full:
            with self._lock:
                self.admission_timeouts += 1
            return False
        with self._lock:
            self.submitted += 1
            self.consecutive_sheds = 0
        return True

    def behind(self) -> bool:
        """The downstream-behind signal: sustained shedding, gated the
        same way sink delivery gates its behind signal."""
        with self._lock:
            return delivery_should_signal_behind(self.consecutive_sheds)

    def _work(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            kind, payload = item
            try:
                self._route(kind, payload)
            except Exception:  # noqa: BLE001 — workers must survive
                log.exception("proxy routing worker failed")
            finally:
                with self._lock:
                    self.routed += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "workers": self.workers,
                "queue_max": self.queue_max,
                "queue_depth": self._q.qsize(),
                "submitted": self.submitted,
                "routed": self.routed,
                "shed_batches": self.shed_batches,
                "consecutive_sheds": self.consecutive_sheds,
                "admission_timeouts": self.admission_timeouts,
            }

    def stop(self, drain_s: float = 5.0) -> None:
        # admitted == acked upstream: a queued batch will never be
        # re-sent by its sender, so a stopping pool lets the workers
        # drain the backlog before the sentinels go in — abandoning it
        # would silently lose acked data with no drop counted (and a
        # full queue would also time the sentinel put out). The wait is
        # bounded: the queue holds at most queue_max batches and ingest
        # has already stopped when this runs (ProxyServer.stop stops
        # gRPC first).
        self._stopping = True  # new admissions refused from here on
        deadline = time.monotonic() + max(0.0, drain_s)
        while self._q.qsize() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        for _ in self._threads:
            try:
                self._q.put(None, timeout=1.0)
            except queue.Full:  # wedged worker; daemon threads die anyway
                break
        for t in self._threads:
            t.join(timeout=2.0)
        # an admission blocked in submit_wait when _stopping flipped can
        # still land its item behind the sentinels — already acked, so
        # route it inline rather than abandon it
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            kind, payload = item
            try:
                self._route(kind, payload)
            except Exception:  # noqa: BLE001 — drain must finish
                log.exception("proxy routing stop-drain failed")
            finally:
                with self._lock:
                    self.routed += 1


class _StreamAdmissionSink:
    """Streamed-ingest admission: a frame is acked only once its payload
    is ADMITTED to the routing queue. A full queue delays the ack — the
    sender's in-flight window absorbs the wait, which is the
    backpressure a paced unary caller gets for free by blocking on its
    RPC — and an admission timeout busy-acks the frame back (the sender
    retries it under the same dedup key). Streamed overload therefore
    degrades into sender-side throttling, never into a server-side shed
    of payloads the sender already counts as in flight."""

    ADMIT_TIMEOUT_S = 1.0

    def __init__(self, proxy: "ProxyServer") -> None:
        self._proxy = proxy

    def submit(self, body: bytes, done) -> None:
        from veneur_tpu_torch.distributed import codec as _codec

        self._proxy._register_cpu_thread()
        if self._proxy._pool.submit_wait(
                "wire", body, self.ADMIT_TIMEOUT_S):
            done(True)
        else:
            done(_codec.STREAM_ACK_BUSY)


def thread_cpu_ns(tid: int) -> Optional[int]:
    """A thread of this process's on-CPU nanoseconds: /proc/self/task/
    <tid>/schedstat's first field, or, on a kernel that keeps no
    schedstats (the file missing, or reading 0 for a thread that ran),
    the user and system clock ticks of its ``stat``; None once the
    thread is gone."""
    base = f"/proc/self/task/{tid}"
    try:
        with open(base + "/schedstat") as f:
            ns = int(f.read().split()[0])
        if ns > 0:
            return ns
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open(base + "/stat") as f:
            # fields after the parenthesised name: utime and stime are
            # the 14th and 15th of the line, the 12th and 13th here
            rest = f.read().rsplit(")", 1)[1].split()
        ticks = int(rest[11]) + int(rest[12])
    except (OSError, ValueError, IndexError):
        return None
    return ticks * 1_000_000_000 // os.sysconf("SC_CLK_TCK")


class ProxyServer:
    """Receives MetricBatch RPCs and re-sends each metric to the global
    instance owning its key on the consistent ring, with per-destination
    delivery guarantees and reshard handoff (module docstring)."""

    def __init__(self, destinations: Optional[list[str]] = None,
                 timeout_s: float = 10.0,
                 idle_timeout_s: float = 0.0,
                 max_idle_conns: int = 0,
                 delivery: Optional[DeliveryPolicy] = None,
                 routing_workers: int = 4,
                 routing_queue_max: int = ROUTING_QUEUE_MAX,
                 handoff_window_s: float = 5.0,
                 client_factory: Optional[Callable] = None,
                 journal=None,
                 dedup: bool = False,
                 dedup_sender: Optional[str] = None,
                 streaming: bool = False,
                 stream_window: int = 32,
                 stream_adaptive: bool = True,
                 stream_window_min: int = 1,
                 stream_window_max: int = 128) -> None:
        self.ring = ConsistentRing(destinations or [])
        # long-lived StreamMetrics channel per destination instead of a
        # unary call per fragment. Default OFF at this layer (like
        # dedup) so the config wires it deliberately; a frame is
        # delivered only on its ack, so the delivery-manager contract
        # is identical either way.
        self.streaming = bool(streaming)
        self.stream_window = max(1, int(stream_window))
        # AIMD ack-window bounds threaded to each destination client;
        # resolution of the env hatch happens inside ForwardClient
        self.stream_adaptive = bool(stream_adaptive)
        self.stream_window_min = max(1, int(stream_window_min))
        self.stream_window_max = max(
            self.stream_window_min, int(stream_window_max))
        # exactly-once forwards: when on, every fragment carries a
        # wire-level idempotency key (versioned envelope, codec.py) the
        # import tier dedups on. Default OFF at this layer so the config
        # wires it deliberately — off, the wire bytes are byte-identical
        # to the at-least-once tier.
        self.dedup = bool(dedup)
        if dedup_sender is not None:
            self._dedup_sender = str(dedup_sender)
        elif journal is not None:
            from veneur_tpu_torch.utils.journal import sender_token

            self._dedup_sender = sender_token(journal.directory)
        else:
            import os as _os

            # no journal: ids are only process-unique, so the sender
            # token must be process-unique too — a restart is a new
            # sender and can never collide with the dead one's window
            self._dedup_sender = _os.urandom(8).hex()
        self._mint_lock = threading.Lock()
        self._mint_next = 1  # journal-less fallback id sequence
        # one SHARED write-ahead journal (utils/journal.py) across every
        # per-destination manager: a fragment spilled toward A, drained
        # by a reshard, and re-spilled toward B keeps one durable record
        # until it reaches a terminal outcome. None = journaling off.
        self._journal = journal
        self.journal_recovered_payloads = 0
        self.journal_recovered_metrics = 0
        self.journal_decode_failed = 0
        self.timeout_s = timeout_s
        self.idle_timeout_s = idle_timeout_s
        # LRU bound on kept-alive downstream conns (reference
        # config_proxy.go:16 MaxIdleConns on the shared http.Transport);
        # 0 = unlimited
        self.max_idle_conns = max_idle_conns
        self.handoff_window_s = max(0.05, float(handoff_window_s))
        # per-attempt forward timeout can't usefully exceed the handoff
        # window that bounds the whole delivery budget
        self._policy = delivery or DeliveryPolicy(
            timeout_s=min(timeout_s, self.handoff_window_s),
            deadline_s=self.handoff_window_s)
        # tests and the churn soak inject scripted/faulty clients here;
        # None = real gRPC ForwardClient
        self._client_factory = client_factory
        self._conns: "OrderedDict[str, rpc.ForwardClient]" = OrderedDict()
        self._managers: dict[str, DeliveryManager] = {}
        # deliveries/deferrals in flight per destination, so manager
        # retirement can prove nothing can repopulate a drained spill
        self._inflight: dict[str, int] = {}
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.grpc_server: Optional[grpc.Server] = None
        self.port: Optional[int] = None
        self.proxied_metrics = 0
        self.drops = 0
        self.spilled_metrics = 0   # metrics currently parked in spills
        self.shed_metrics = 0      # subset of drops: routing-queue sheds
        self.reshards = 0
        self.handoffs = 0
        self.dedup_minted = 0
        # re-sends of fragments whose prior attempt may have landed —
        # the duplicate source a soak could otherwise only infer from diffs
        self.handoff_resend_total = 0
        self.handoff_clipped_resend = 0  # prior attempt deadline-clipped
        # reshard forced a split/re-mint after an ambiguous attempt:
        # residual at-least-once risk, counted never silent
        self.dedup_remint_after_attempt = 0
        self.last_ring_change: Optional[dict] = None
        self._ring_changed_unix = time.time()
        self.refresher = None      # attached by DestinationRefresher
        # CPU service-demand accounting: native thread ids of every
        # thread that does this proxy's work (gRPC ingest handlers,
        # routing workers, the handoff drain). cpu_seconds() sums their
        # /proc/self/task/<tid>/schedstat runtime so a multi-proxy
        # bench in ONE process can attribute CPU per proxy — the number
        # the fan-in capacity model divides throughput by.
        self._cpu_tids: set[int] = set()
        self._cpu_last_ns: dict[int, int] = {}
        self._cpu_lock = threading.Lock()
        self._pool = RoutingPool(self._route_one, routing_workers,
                                 routing_queue_max)
        self._drain_event = threading.Event()
        self._stop_event = threading.Event()
        self._drain_thread = threading.Thread(
            target=self._drain_loop, daemon=True, name="proxy-handoff")
        self._drain_thread.start()

    # -- membership (reference SetDestinations, proxysrv/server.go:148-176)

    def set_destinations(self, destinations: list[str], cause: str = ""):
        """Reshard the ring; returns the RingChange (None if membership
        is unchanged). A change wakes the handoff drain so spilled
        fragments re-route under the NEW ring within the bounded
        window. `cause` stamps WHY membership moved ("discovery",
        "quarantine", "scale_in", ...) into the change and telemetry."""
        with self._lock:
            change = self.ring.set_members(destinations, cause=cause)
            if not change:
                return None
            live = set(destinations)
            for dest in list(self._conns):
                # a departed destination's client must outlive the
                # reshard while a send toward it is in flight — closing
                # the channel mid-call aborts the attempt as a permanent
                # "send" failure even though the member is healthy (the
                # graceful scale-in drop). Busy clients are closed by
                # _retire_departed once the last send lands.
                if dest not in live and not self._inflight.get(dest, 0):
                    self._conns.pop(dest).close()
        with self._stats_lock:
            self.reshards += 1
            self._ring_changed_unix = time.time()
            self.last_ring_change = {
                "version": change.version,
                "added": list(change.added),
                "removed": list(change.removed),
                "moved_ranges": len(change.moved_ranges),
                "moved_fraction": round(change.moved_fraction(), 6),
                "cause": change.cause,
            }
        self._drain_event.set()
        return change

    def breaker_states(self) -> dict[str, str]:
        """Per-destination circuit-breaker state ("closed"/"open"/
        "half_open") for every destination with a delivery manager — the
        health gate's quarantine signal."""
        with self._lock:
            managers = dict(self._managers)
        return {dest: man.stats()["circuit_state"]
                for dest, man in managers.items()}

    def destination_idle(self, dest: str) -> bool:
        """Whether a departed destination has fully drained: out of the
        ring, nothing in flight toward it, and its spill empty (or its
        manager already retired). This is the elastic controller's
        "safe to retire" signal — the same condition _retire_departed
        enforces, read without mutating."""
        with self._lock:
            if dest in self.ring.view().members:
                return False
            if self._inflight.get(dest, 0):
                return False
            man = self._managers.get(dest)
            return man is None or not len(man.spill)

    def _conn(self, dest: str) -> rpc.ForwardClient:
        with self._lock:
            client = self._conns.get(dest)
            if client is None:
                if self._client_factory is not None:
                    client = self._client_factory(
                        dest, self.timeout_s, self.idle_timeout_s)
                else:
                    client = rpc.ForwardClient(
                        dest, self.timeout_s,
                        idle_timeout_s=self.idle_timeout_s,
                        streaming=self.streaming,
                        stream_window=self.stream_window,
                        stream_adaptive=self.stream_adaptive,
                        stream_window_min=self.stream_window_min,
                        stream_window_max=self.stream_window_max)
                self._conns[dest] = client
                while (self.max_idle_conns > 0
                       and len(self._conns) > self.max_idle_conns):
                    _, evicted = self._conns.popitem(last=False)
                    evicted.close()
            else:
                self._conns.move_to_end(dest)
            return client

    # -- per-destination delivery (the sinks' machinery over the forward path)

    def _on_spill_evict(self, frag) -> None:
        # a spill cap pushed out an older fragment: its metrics leave
        # the spill gauge and become declared drops
        if frag is None:
            return
        with self._stats_lock:
            self.spilled_metrics -= frag.count
            self.drops += frag.count

    def _checkout_manager(self, dest: str) -> DeliveryManager:
        """Resolve (or create) dest's manager and mark a delivery in
        flight; pair with _checkin_manager."""
        with self._lock:
            man = self._managers.get(dest)
            if man is None:
                man = DeliveryManager("forward:" + dest, self._policy,
                                      evict_cb=self._on_spill_evict)
                if self._journal is not None:
                    man.attach_journal(self._journal, _entry_encode)
                self._managers[dest] = man
            self._inflight[dest] = self._inflight.get(dest, 0) + 1
            return man

    def _checkin_manager(self, dest: str) -> None:
        with self._lock:
            self._inflight[dest] -= 1

    # -- exactly-once dedup keys -------------------------------------------

    def _mint_id(self) -> int:
        """Cross-incarnation-unique id: the journal's durably reserved
        sequence when journaling is on (utils/journal.mint_id), else a
        process-local counter (the sender token is then process-unique,
        so (sender, id) stays globally unique either way)."""
        if self._journal is not None:
            return self._journal.mint_id()
        with self._mint_lock:
            rid = self._mint_next
            self._mint_next = rid + 1
            return rid

    def _mint_dedup(self, dest: str, frag: _Fragment) -> None:
        """Give a fragment its idempotency key at delivery checkout.

        A fragment keeps its key across retries, spills, and handoff
        re-sends to the SAME destination — only then can the receiver's
        window recognise a replay. A fragment headed somewhere its key
        was never seen (split or moved by a reshard before any send
        landed) re-mints: the old key means nothing to the new owner."""
        if frag.dedup_id is None or frag.minted_for != dest:
            frag.dedup_id = self._mint_id()
            frag.minted_for = dest
            frag.attempts = 0
            frag.last_cause = None
            with self._stats_lock:
                self.dedup_minted += 1

    def _make_send(self, dest: str, frag: _Fragment):
        """One-attempt send closure over a routed fragment (the shape
        DeliveryManager drives). Clients exposing the *_or_raise API get
        classified ForwardErrors; bool-returning stand-ins (bench/test
        fakes) degrade to a permanent "send" failure on False — the old
        drop semantics."""

        def send(timeout_s: float) -> None:
            client = self._conn(dest)
            if frag.attempts > 0:
                # a prior attempt errored but may have LANDED — this
                # re-send is exactly what the dedup window exists for
                with self._stats_lock:
                    self.handoff_resend_total += 1
                    if frag.last_cause == "deadline_exceeded":
                        self.handoff_clipped_resend += 1
            frag.attempts += 1
            dedup = self.dedup and frag.dedup_id is not None
            try:
                if frag.wire:
                    blob = b"".join(frag.parts)
                    if dedup:
                        blob = codec.encode_dedup_envelope(
                            self._dedup_sender, frag.dedup_id,
                            frag.count, blob)
                    fn = getattr(client, "send_raw_or_raise", None)
                    if fn is not None:
                        fn(blob, frag.count, timeout_s)
                    elif not client.send_raw(blob, frag.count):
                        raise rpc.ForwardError("send", dest,
                                               "send_raw returned False")
                else:
                    sub = pb.MetricBatch()
                    sub.metrics.extend(frag.parts)
                    fnr = getattr(client, "send_raw_or_raise", None)
                    if dedup and fnr is not None:
                        # the envelope only rides the raw path; serialize
                        # the sub-batch and wrap it
                        fnr(codec.encode_dedup_envelope(
                            self._dedup_sender, frag.dedup_id,
                            frag.count, sub.SerializeToString()),
                            frag.count, timeout_s)
                        return
                    fn = getattr(client, "send_or_raise", None)
                    if fn is not None:
                        fn(sub, timeout_s)
                    elif not client.send(sub):
                        raise rpc.ForwardError("send", dest,
                                               "send returned False")
            except rpc.ForwardError as e:
                frag.last_cause = e.cause
                raise

        return send

    def _deliver_fragment(self, dest: str, frag: _Fragment) -> str:
        if self.dedup:
            self._mint_dedup(dest, frag)
        man = self._checkout_manager(dest)
        try:
            outcome = man.deliver(self._make_send(dest, frag),
                                  frag.nbytes, payload=frag)
        finally:
            self._checkin_manager(dest)
        with self._stats_lock:
            if outcome == "delivered":
                self.proxied_metrics += frag.count
            elif outcome == "deferred":
                self.spilled_metrics += frag.count
            else:
                self.drops += frag.count
        return outcome

    def _defer_fragment(self, dest: str, frag: _Fragment) -> str:
        """Park a fragment in dest's spill without a network attempt —
        the bounded-handoff path when the reshard window runs out."""
        if self.dedup:
            self._mint_dedup(dest, frag)
        man = self._checkout_manager(dest)
        try:
            outcome = man.defer(self._make_send(dest, frag),
                                frag.nbytes, payload=frag)
        finally:
            self._checkin_manager(dest)
        with self._stats_lock:
            if outcome == "deferred":
                self.spilled_metrics += frag.count
            else:
                self.drops += frag.count
        return outcome

    # -- forwarding (reference SendMetrics :180 / sendMetrics :190)

    def handle_batch(self, batch: pb.MetricBatch) -> None:
        # return to the caller immediately; the bounded pool routes it
        # (reference returns before forwarding completes)
        if not self._pool.submit("batch", batch):
            self._shed(len(batch.metrics))

    def handle_wire(self, blob: bytes) -> None:
        self._register_cpu_thread()
        if not self._pool.submit("wire", blob):
            self._shed(self._wire_count(blob))

    def _register_cpu_thread(self) -> None:
        """Record the calling thread in the CPU-attribution set (cheap:
        a set lookup after the first call from each thread)."""
        tid = threading.get_native_id()
        if tid in self._cpu_tids:
            return
        with self._cpu_lock:
            self._cpu_tids.add(tid)

    def cpu_seconds(self) -> float:
        """Cumulative CPU runtime of this proxy's worker threads
        (``thread_cpu_ns``). A thread that exited keeps its last
        observed reading, so deltas across a measurement window never go
        backwards. Returns 0.0 where /proc is unavailable (non-Linux) —
        callers treat that as 'no attribution', not as free work."""
        with self._cpu_lock:
            tids = list(self._cpu_tids)
        total_ns = 0
        for tid in tids:
            ns = thread_cpu_ns(tid)
            if ns is None:
                ns = self._cpu_last_ns.get(tid, 0)
            else:
                self._cpu_last_ns[tid] = ns
            total_ns += ns
        return total_ns / 1e9

    def _shed(self, n: int) -> None:
        with self._stats_lock:
            self.drops += n
            self.shed_metrics += n

    def _wire_count(self, blob: bytes) -> int:
        """Metric count of a wire blob for honest shed accounting (the
        shed path is off the hot path by definition, so the decode cost
        lands only on batches that were refused anyway)."""
        from veneur_tpu_torch import native as native_mod

        d = native_mod.decode_metric_batch(blob)
        if d is not None:
            return int(d.n)
        try:
            return len(pb.MetricBatch.FromString(blob).metrics)
        except Exception:
            return 1  # undecodable: same unit the decode-failure path drops

    def _route_one(self, kind: str, item) -> None:
        self._register_cpu_thread()
        if kind == "wire":
            self._route_wire(item)
        else:
            self._route_batch(item)

    def _route_wire(self, blob: bytes) -> None:
        """Ring-split a serialized batch by BYTE SLICING: the native
        decoder reports each metric's record range in the source bytes,
        and protobuf repeated records concatenate — so the per-dest
        payloads are joins of slices of the original buffer, nothing
        re-encoded (the reference re-marshals per destination,
        proxysrv/server.go:286-305)."""
        from veneur_tpu_torch import native as native_mod

        d = native_mod.decode_metric_batch(blob)
        if d is None:
            # native decoder rejected (malformed per protobuf spec since
            # the decoder strictness fixes, or stale .so): the Python
            # parser gets a say, but ITS rejection must surface in the
            # proxy's own telemetry, not as a bare worker traceback with
            # the drop uncounted
            try:
                batch = pb.MetricBatch.FromString(blob)
            except Exception as e:
                with self._stats_lock:
                    self.drops += 1
                log.warning("undecodable forward body dropped: %s", e)
                return
            self._route_batch(batch)
            return
        if not d.n:
            return
        off = d.rec_off.tolist()
        ln = d.rec_len.tolist()
        hashes = d.ring_hash.tolist()
        try:
            # placement hashes came out of the decoder; one vectorized
            # searchsorted places the whole batch on the ring
            dests = self.ring.owners_for_hashes(d.ring_hash)
        except LookupError:
            with self._stats_lock:
                self.drops += d.n
            log.warning("no destinations; dropping batch")
            return
        groups: dict[str, tuple[list, list]] = {}
        for i, dest in enumerate(dests):
            parts, meta = groups.setdefault(dest, ([], []))
            parts.append(blob[off[i]:off[i] + ln[i]])
            meta.append(hashes[i])
        for dest, (parts, meta) in groups.items():
            self._deliver_fragment(dest, _Fragment(True, parts, meta))

    def _route_batch(self, batch: pb.MetricBatch) -> None:
        groups: dict[str, tuple[list, list]] = {}
        metrics = list(batch.metrics)
        for i, m in enumerate(metrics):
            key = codec.metric_key(m).key_string()
            try:
                dest = self.ring.get(key)
            except LookupError:
                # ring emptied mid-route: only the UN-routed remainder
                # is lost — metrics already grouped still forward below
                remainder = len(metrics) - i
                with self._stats_lock:
                    self.drops += remainder
                log.warning(
                    "ring emptied mid-route; dropping %d un-routed "
                    "metrics (%d already grouped still forward)",
                    remainder, i)
                break
            parts, meta = groups.setdefault(dest, ([], []))
            parts.append(m)
            meta.append(key)
        for dest, (parts, meta) in groups.items():
            self._deliver_fragment(dest, _Fragment(False, parts, meta))

    # -- reshard handoff ----------------------------------------------------

    def _reroute_fragment(self, frag: _Fragment,
                          deadline_mono: float) -> None:
        """Split a drained fragment under the CURRENT ring and re-
        deliver each piece; past the handoff deadline, pieces park on
        their new owner's spill without a network attempt (bounded
        handoff). An empty ring declares the drop.

        Dedup mode: a fragment whose prior attempt may have LANDED
        (attempts > 0 — e.g. a deadline-clipped send the receiver
        actually merged) must NOT be split or moved: only its original
        destination's window knows the key, so the whole fragment goes
        back to `minted_for` while it remains a member. If the reshard
        removed `minted_for`, splitting re-mints and we degrade to
        at-least-once for that fragment — counted, never silent."""
        if (self.dedup and frag.dedup_id is not None
                and frag.attempts > 0):
            if frag.minted_for in self.ring.view().members:
                if time.monotonic() >= deadline_mono:
                    self._defer_fragment(frag.minted_for, frag)
                else:
                    self._deliver_fragment(frag.minted_for, frag)
                return
            with self._stats_lock:
                self.dedup_remint_after_attempt += 1
        try:
            if frag.wire:
                owners = self.ring.owners_for_hashes(frag.meta)
            else:
                view = self.ring.view()
                owners = [view.get_hashed(ConsistentRing._hash(k))
                          for k in frag.meta]
        except LookupError:
            with self._stats_lock:
                self.drops += frag.count
            log.warning("ring empty during handoff; dropping %d spilled "
                        "metrics", frag.count)
            return
        groups: dict[str, tuple[list, list]] = {}
        for part, meta, dest in zip(frag.parts, frag.meta, owners):
            parts, metas = groups.setdefault(dest, ([], []))
            parts.append(part)
            metas.append(meta)
        for dest, (parts, metas) in groups.items():
            nf = _Fragment(frag.wire, parts, metas)
            if (frag.dedup_id is not None and len(groups) == 1
                    and dest == frag.minted_for):
                # unsplit, unmoved: a pure retry keeps its key (and its
                # attempt history) so the receiver recognises the replay
                nf.dedup_id = frag.dedup_id
                nf.minted_for = frag.minted_for
                nf.attempts = frag.attempts
                nf.last_cause = frag.last_cause
            if time.monotonic() >= deadline_mono:
                self._defer_fragment(dest, nf)
            else:
                self._deliver_fragment(dest, nf)

    def drain_spill(self, window_s: Optional[float] = None) -> dict:
        """One handoff/drain pass, bounded by the handoff window: every
        destination manager with pass work gets its interval edge (an
        open breaker arms its half-open probe), then all spilled
        fragments are popped and re-routed under the CURRENT ring. Runs
        periodically from the drain thread and immediately on reshard;
        also the soak's lever for deterministic final settling."""
        window = self.handoff_window_s if window_s is None \
            else float(window_s)
        deadline = time.monotonic() + window
        with self._lock:
            managers = dict(self._managers)
        drained_payloads = drained_metrics = 0
        for dest, man in managers.items():
            # arm the pass edge only when this manager has pass work:
            # spill to re-send, or a tripped breaker awaiting its
            # half-open probe. Arming unconditionally would couple
            # every LIVE forward's delivery budget to the drain
            # cadence — a fragment routed late in the armed window
            # inherits the window's TAIL as its whole budget and clips
            # spuriously on a healthy, keeping-up destination.
            if len(man.spill) or man.breaker.state != "closed":
                man.begin_flush(window)
            entries = man.drain_spill()
            if not entries:
                continue
            popped = sum(e.payload.count for e in entries
                         if e.payload is not None)
            with self._stats_lock:
                self.spilled_metrics -= popped
            for e in entries:
                drained_payloads += 1
                if e.payload is None:
                    # not a routed fragment (foreign deliver() caller):
                    # park it back untouched
                    man.defer(e.send, e.nbytes)
                    continue
                drained_metrics += e.payload.count
                self._reroute_fragment(e.payload, deadline)
                # the re-route gave every surviving piece its own journal
                # record (deferred pieces re-append on their new owner's
                # spill) — only now is the ORIGINAL record's story over.
                # Crash between the two: duplicates on replay, never loss.
                if self._journal is not None and e.jid is not None:
                    self._journal.ack(e.jid)
                    e.jid = None
        self._retire_departed()
        with self._stats_lock:
            self.handoffs += 1
        return {"drained_payloads": drained_payloads,
                "drained_metrics": drained_metrics}

    def recover_journal(self, window_s: Optional[float] = None) -> dict:
        """Replay the shared journal's unacked fragments from a prior
        incarnation and re-route them under the CURRENT ring — the old
        destination may be long gone; placement meta travels in the
        record precisely so recovery is a re-route, not a blind resend.
        Pieces that can't go out inside the window park (with fresh
        journal records) on their new owners' spills; only then is the
        replayed record acked, so a crash mid-recovery re-replays
        instead of losing. Call once at startup, before traffic."""
        if self._journal is None:
            return {"recovered_payloads": 0, "recovered_metrics": 0}
        window = self.handoff_window_s if window_s is None \
            else float(window_s)
        deadline = time.monotonic() + window
        recovered_payloads = recovered_metrics = 0
        for rid, blob in self._journal.replay_pending():
            frag = _fragment_decode(blob)
            if frag is None:
                with self._stats_lock:
                    self.journal_decode_failed += 1
                self._journal.ack(rid)
                continue
            self._reroute_fragment(frag, deadline)
            self._journal.ack(rid)
            recovered_payloads += 1
            recovered_metrics += frag.count
        with self._stats_lock:
            self.journal_recovered_payloads += recovered_payloads
            self.journal_recovered_metrics += recovered_metrics
        if recovered_payloads:
            log.info("proxy journal recovery: %d payload(s), %d metric(s)"
                     " re-routed under ring v%d", recovered_payloads,
                     recovered_metrics, self.ring.version)
        return {"recovered_payloads": recovered_payloads,
                "recovered_metrics": recovered_metrics}

    def _retire_departed(self) -> None:
        """Drop managers of destinations no longer in the ring, once
        their spill is empty and nothing is in flight toward them (the
        in-flight guard makes "empty" stable under _lock: a new
        delivery/deferral must check the manager out under _lock
        first)."""
        with self._lock:
            members = self.ring.view().members
            for dest in list(self._managers):
                if (dest not in members
                        and not self._inflight.get(dest, 0)
                        and not len(self._managers[dest].spill)):
                    del self._managers[dest]
                    self._inflight.pop(dest, None)
                    # now truly idle: close the client set_destinations
                    # left open for the in-flight tail
                    conn = self._conns.pop(dest, None)
                    if conn is not None:
                        conn.close()

    def _drain_loop(self) -> None:
        self._register_cpu_thread()
        while not self._stop_event.is_set():
            self._drain_event.wait(self.handoff_window_s)
            if self._stop_event.is_set():
                return
            self._drain_event.clear()
            try:
                self.drain_spill()
            except Exception:  # noqa: BLE001 — the drain must survive
                log.exception("proxy handoff drain failed")

    # -- introspection ------------------------------------------------------

    def forward_stats(self) -> dict:
        """Tier health snapshot: per-destination forward-path stats
        (ForwardClient.stats) and delivery ledgers (DeliveryManager.
        stats), ring version/age, routing-executor backpressure, and
        discovery-refresh staleness — what the churn soak asserts
        conservation and breaker cycles against."""
        with self._lock:
            conn_stats = {dest: c.stats()
                          for dest, c in self._conns.items()}
            managers = dict(self._managers)
        per_dest: dict[str, dict] = dict(conn_stats)
        for dest, man in managers.items():
            per_dest.setdefault(dest, {"address": dest})["delivery"] = \
                man.stats()
        with self._stats_lock:
            out = {
                "proxied_metrics": self.proxied_metrics,
                "drops": self.drops,
                "spilled_metrics": self.spilled_metrics,
                "shed_metrics": self.shed_metrics,
                "reshards": self.reshards,
                "handoffs": self.handoffs,
                "last_ring_change": self.last_ring_change,
                "ring_age_s": round(
                    time.time() - self._ring_changed_unix, 3),
                "handoff": {
                    "resend_total": self.handoff_resend_total,
                    "clipped_resend": self.handoff_clipped_resend,
                },
                "dedup": {
                    "enabled": self.dedup,
                    "sender": self._dedup_sender,
                    "minted": self.dedup_minted,
                    "remint_after_attempt":
                        self.dedup_remint_after_attempt,
                },
            }
        # stream-level telemetry aggregated across destinations (each
        # client's block also rides under destinations.<addr>.stream)
        stream_tot = {"opened": 0, "reconnects": 0, "acked_total": 0,
                      "window_stalls": 0, "unacked_frames": 0,
                      "downgraded": 0, "shrink_events": 0,
                      "window_current": 0, "window_min_seen": 0,
                      "window_max_seen": 0}
        saw_stream = False
        for d in per_dest.values():
            s = d.get("stream")
            if not s:
                continue
            for k in ("opened", "reconnects", "acked_total",
                      "window_stalls", "unacked_frames", "shrink_events"):
                stream_tot[k] += s.get(k, 0)
            if s.get("downgraded"):
                stream_tot["downgraded"] += 1
            # window gauges: worst-destination view — max operating
            # point / deepest collapse observed across the fleet
            cur = s.get("window_current", 0)
            stream_tot["window_current"] = max(
                stream_tot["window_current"], cur)
            lo = s.get("window_min_seen", cur)
            stream_tot["window_min_seen"] = (
                lo if not saw_stream
                else min(stream_tot["window_min_seen"], lo))
            stream_tot["window_max_seen"] = max(
                stream_tot["window_max_seen"],
                s.get("window_max_seen", cur))
            saw_stream = True
        stream_tot["enabled"] = self.streaming
        stream_tot["adaptive"] = rpc.stream_adaptive_enabled(
            self.stream_adaptive)
        stream_tot["window"] = self.stream_window
        out.update({
            "ring_version": self.ring.version,
            "ring_members": len(self.ring),
            "destinations": per_dest,
            "stream": stream_tot,
            "reconnects_total": sum(
                d.get("reconnects", 0) for d in per_dest.values()),
            "errors_total": {
                cause: sum(d.get("errors", {}).get(cause, 0)
                           for d in per_dest.values())
                for cause in ("deadline_exceeded", "unavailable", "send")},
            "routing": self._pool.stats(),
            "behind": self._pool.behind(),
            "cpu_seconds": round(self.cpu_seconds(), 6),
        })
        with self._stats_lock:
            out["journal_recovered_payloads"] = self.journal_recovered_payloads
            out["journal_recovered_metrics"] = self.journal_recovered_metrics
            out["journal_decode_failed"] = self.journal_decode_failed
        if self._journal is not None:
            out["journal"] = self._journal.stats()
        if self.refresher is not None:
            out["refresh"] = self.refresher.stats()
            out["refresh_errors"] = self.refresher.refresh_errors
        return out

    def conserved(self) -> bool:
        """The tier-wide exact-conservation check at a quiescent point:
        every per-destination delivery ledger balances (see
        DeliveryManager.conserved)."""
        with self._lock:
            managers = list(self._managers.values())
        return all(m.conserved() for m in managers)

    def start_grpc(self, address: str = "127.0.0.1:0") -> int:
        self.grpc_server, self.port = rpc.make_server(
            self.handle_batch, address, raw_handler=self.handle_wire,
            stream_sink=_StreamAdmissionSink(self))
        return self.port

    def stop(self) -> None:
        self._stop_event.set()
        self._drain_event.set()
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=1.0)
        self._pool.stop()
        self._drain_thread.join(timeout=2.0)
        with self._lock:
            for client in self._conns.values():
                client.close()
            self._conns.clear()
        if self._journal is not None:
            # whatever is still spilled stays durable for the next
            # incarnation's recover_journal
            self._journal.sync()
            self._journal.close()


class TraceProxy:
    """Ring-route trace spans to the destination owning their TraceID
    (reference ProxyTraces, proxy.go:543-586: spans are sharded across
    downstream collectors by consistent hash of the trace ID, so every
    span of one trace lands on the same host).

    Two span formats ride the same ring: framed SSF leaves over UDP
    datagrams — the ingest path every destination server already listens
    on — and Datadog-format JSON arrays (datadog_trace_span.go:1) POST
    to each destination's /spans like the reference proxy does."""

    def __init__(self, destinations: Optional[list[str]] = None) -> None:
        self.ring = ConsistentRing(destinations or [])
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._lock = threading.Lock()  # ring mutation vs handler threads
        self.proxied_spans = 0
        self.drops = 0

    def set_destinations(self, destinations: list[str]) -> None:
        with self._lock:
            self.ring.set_members(destinations)

    def handle_spans(self, spans) -> None:
        for span in spans:
            try:
                with self._lock:
                    dest = self.ring.get(str(span.trace_id))
            except LookupError:
                self.drops += 1
                continue
            try:
                host, port = parse_host_port(dest, what="trace destination")
                self._sock.sendto(ssf_wire.encode_datagram(span),
                                  (host, port))
                self.proxied_spans += 1
            except (OSError, ValueError) as e:
                self.drops += 1
                log.debug("span forward to %s failed: %s", dest, e)

    def handle_datadog_spans(self, traces: list) -> None:
        """Ring-route Datadog-format JSON trace spans by trace_id and POST
        each destination its batch as a JSON array (reference ProxyTraces,
        proxy.go:543-586; span schema datadog_trace_span.go:1): a stock
        Datadog tracer can point straight at this proxy. The downstream
        endpoint takes an undocumented array and no deflate
        (proxy.go:566-568), so bodies go out plain."""
        import json
        import urllib.request

        by_dest: dict[str, list] = {}
        for t in traces:
            try:
                trace_id = int(t.get("trace_id", 0))
            except (TypeError, ValueError, AttributeError):
                self.drops += 1
                continue
            try:
                with self._lock:
                    dest = self.ring.get(str(trace_id))
            except LookupError:
                self.drops += 1
                continue
            by_dest.setdefault(dest, []).append(t)
        for dest, batch in by_dest.items():
            url = dest if "://" in dest else f"http://{dest}"
            req = urllib.request.Request(
                url.rstrip("/") + "/spans",
                data=json.dumps(batch).encode("utf-8"),
                headers={"Content-Type": "application/json"},
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=10.0) as resp:
                    resp.read()
                self.proxied_spans += len(batch)
            except (OSError, ValueError) as e:
                self.drops += len(batch)
                log.debug("datadog span batch to %s failed: %s", dest, e)

    def stop(self) -> None:
        self._sock.close()


class _TraceProxySpanClient:
    """Finished proxy spans ring-route to the downstream collector owning
    their trace id, like every other span the proxy handles."""

    def __init__(self, trace_proxy: "TraceProxy") -> None:
        self._tp = trace_proxy

    def record(self, span) -> None:
        self._tp.handle_spans([span])


def _proxy_tracer(trace_proxy: "TraceProxy"):
    from veneur_tpu_torch.trace.opentracing import Tracer

    return Tracer(client=_TraceProxySpanClient(trace_proxy),
                  service="veneur-tpu-proxy")


class ProxyHTTPServer:
    """HTTP face of the proxy tier (reference veneur-proxy, proxy.go:40-74:
    POST /import ring-splits metrics, POST /spans ring-routes traces,
    plus /healthcheck /version /debug/pprof).

    /import takes the same bodies as the global import endpoint (protobuf
    MetricBatch, JSON+base64, optionally deflate). /spans takes either a
    Datadog-format JSON span array (the reference proxy's span body,
    handlers_global.go:74-110) or a framed SSF stream (any number of
    frames back-to-back)."""

    def __init__(self, proxy: ProxyServer,
                 trace_proxy: Optional[TraceProxy] = None) -> None:
        self.proxy = proxy
        self.trace_proxy = trace_proxy
        self.httpd = None
        self.port: Optional[int] = None

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        import io
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from veneur_tpu_torch import __version__
        from veneur_tpu_torch.distributed.import_server import (
            decode_http_import_body,
        )
        from veneur_tpu_torch.utils.http import APIHandlerBase

        proxy = self.proxy
        trace_proxy = self.trace_proxy
        # one long-lived tracer per server, not per request; spans it
        # finishes ring-route downstream via the trace proxy
        tracer = (_proxy_tracer(trace_proxy)
                  if trace_proxy is not None else None)

        class Handler(APIHandlerBase, BaseHTTPRequestHandler):
            version_string_body = __version__

            def do_GET(self):
                if not self.handle_common_get():
                    self._respond(404, b"not found")

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                if self.path == "/import":
                    # continue the forwarder's trace through the proxy hop
                    # (reference handleProxy → ExtractRequestChild,
                    # handlers_global.go:28-58); the proxy's own spans
                    # ring-route downstream with the trace proxy
                    from veneur_tpu_torch.trace.opentracing import (
                        traced_server_hop,
                    )

                    with traced_server_hop(
                            dict(self.headers), "veneur.proxy",
                            resource="/import", tracer=tracer) as span:
                        try:
                            batch = decode_http_import_body(
                                body,
                                self.headers.get("Content-Encoding", ""))
                        except Exception as e:
                            if span is not None:
                                span.set_error()
                            self._respond(
                                400, f"bad import body: {e}".encode())
                            return
                        proxy.handle_batch(batch)
                        self._respond(200, b"accepted")
                elif self.path == "/spans" and trace_proxy is not None:
                    # Datadog-format JSON array (the reference proxy's only
                    # span body, handlers_global.go:74-110) or a framed SSF
                    # stream (the veneur-tpu native format) — sniffed by
                    # content type / leading byte
                    ctype = self.headers.get("Content-Type", "")
                    if "json" in ctype or body.lstrip()[:1] == b"[":
                        import json as _json

                        try:
                            traces = _json.loads(body)
                            if not isinstance(traces, list):
                                raise ValueError("expected a JSON array")
                        except ValueError as e:
                            self._respond(
                                400, f"bad /spans body: {e}".encode())
                            return
                        if not traces:
                            # reference handleTraceRequest rejects empties
                            self._respond(
                                400, b"Received empty /spans request")
                            return
                        self._respond(202, b"accepted")
                        trace_proxy.handle_datadog_spans(traces)
                        return
                    spans = []
                    stream = io.BytesIO(body)
                    try:
                        while True:
                            span = ssf_wire.read_ssf(stream)
                            if span is None:
                                break
                            spans.append(span)
                    except ssf_wire.FramingError as e:
                        self._respond(400, f"bad span frame: {e}".encode())
                        return
                    trace_proxy.handle_spans(spans)
                    self._respond(200, b"accepted")
                else:
                    self._respond(404, b"not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port
        threading.Thread(target=self.httpd.serve_forever, daemon=True,
                         name="proxy-http").start()
        return self.port

    def stop(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()


class DestinationRefresher:
    """Periodically re-poll service discovery and reset the ring, keeping
    the last good destination set on error
    (reference proxy.go:328-354, 505-515).

    Each loop wait is full-jittered to interval_s * [1-jitter, 1+jitter]
    so a fleet of proxies restarted together doesn't hit the discovery
    backend on the same beat forever. An optional health `gate`
    (elastic.HealthGate) filters every discovered set before it reaches
    the ring: unreachable candidates never enter, breaker-open members
    are quarantined out."""

    def __init__(self, proxy: ProxyServer, discoverer, service: str,
                 interval_s: float = 30.0, gate=None,
                 jitter: float = 0.5,
                 rng: Optional[random.Random] = None) -> None:
        self.proxy = proxy
        self.discoverer = discoverer
        self.service = service
        self.interval_s = interval_s
        self.gate = gate
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self._rng = rng or random.Random()
        self._stop = threading.Event()
        self.refresh_errors = 0
        self.refresh_empty = 0
        self.refresh_gated_empty = 0
        self.last_refresh: float = 0.0
        # let forward_stats() surface refresh staleness alongside the
        # ring version/age it gates
        try:
            proxy.refresher = self
        except AttributeError:  # pragma: no cover - exotic proxy stand-in
            pass

    def _next_wait(self) -> float:
        """Full jitter: uniform in interval_s * [1-jitter, 1+jitter]."""
        if self.jitter <= 0.0:
            return self.interval_s
        lo = 1.0 - self.jitter
        return self.interval_s * (lo + 2.0 * self.jitter
                                  * self._rng.random())

    def refresh(self) -> None:
        try:
            destinations = self.discoverer.get_destinations_for_service(
                self.service)
        except Exception as e:
            self.refresh_errors += 1
            log.warning("discovery refresh failed (keeping %d last-good"
                        " destinations): %s", len(self.proxy.ring), e)
            return
        if not destinations:
            # an empty answer is indistinguishable from a discovery
            # outage (reference proxy.go:505-515 keeps last-good):
            # keep the ring AND keep last_refresh stale — advancing it
            # here (the old behaviour) made staleness telemetry report
            # a healthy feed while the ring aged unrefreshed
            self.refresh_empty += 1
            log.warning("discovery returned no destinations (keeping %d"
                        " last-good)", len(self.proxy.ring))
            return
        cause = "discovery"
        if self.gate is not None:
            admitted = self.gate.admit(destinations)
            if not admitted:
                # the gate refusing everyone is a health outage, not a
                # membership decision: keep last-good like an empty
                # discovery answer
                self.refresh_gated_empty += 1
                log.warning("health gate admitted no destinations"
                            " (keeping %d last-good)", len(self.proxy.ring))
                return
            if self.gate.last_events:
                cause = "discovery+" + ",".join(self.gate.last_events)
            destinations = admitted
        self.proxy.set_destinations(destinations, cause=cause)
        self.last_refresh = time.time()

    def stats(self) -> dict:
        now = time.time()
        out = {
            "refresh_errors": self.refresh_errors,
            "refresh_empty": self.refresh_empty,
            "refresh_gated_empty": self.refresh_gated_empty,
            "last_refresh_unix": self.last_refresh,
            "last_refresh_age_s": (round(now - self.last_refresh, 3)
                                   if self.last_refresh else None),
        }
        if self.gate is not None:
            out["gate"] = self.gate.stats()
        return out

    def start(self) -> None:
        self.refresh()

        def loop():
            while not self._stop.wait(self._next_wait()):
                self.refresh()

        threading.Thread(target=loop, daemon=True,
                         name="discovery-refresh").start()

    def stop(self) -> None:
        self._stop.set()


class ProxyRuntimeReporter:
    """Periodic proxy self-telemetry to stats_address
    (reference proxy.go:210-216 RuntimeMetricsInterval + the veneur_proxy.*
    statsd namespace set in proxy.go:224-228): routed/dropped counters as
    deltas, ring size, and process RSS every interval."""

    def __init__(self, proxy: ProxyServer, stats,
                 interval_s: float = 10.0,
                 trace_proxy: Optional["TraceProxy"] = None) -> None:
        self.proxy = proxy
        self.stats = stats
        self.trace_proxy = trace_proxy
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._last = {"proxied": 0, "drops": 0, "spans": 0,
                      "acked": 0, "reconnects": 0, "stalls": 0,
                      "shrinks": 0}

    def report_once(self) -> None:
        from veneur_tpu_torch.utils.proc import current_rss_bytes

        proxied, drops = self.proxy.proxied_metrics, self.proxy.drops
        self.stats.count("metrics_by_destination",
                         proxied - self._last["proxied"],
                         tags=["protocol:grpc"])
        self.stats.count("dropped_metrics",
                         drops - self._last["drops"])
        self._last["proxied"], self._last["drops"] = proxied, drops
        self.stats.gauge("destinations_total", float(len(self.proxy.ring)))
        self.stats.gauge("ring.version", float(self.proxy.ring.version))
        self.stats.gauge("spilled_metrics",
                         float(self.proxy.spilled_metrics))
        stream = self.proxy.forward_stats()["stream"]
        if stream["enabled"]:
            # deltas clamp at 0: reshards retire clients, so the
            # aggregate can step down between reports
            self.stats.count(
                "stream.acked",
                max(0, stream["acked_total"] - self._last["acked"]))
            self.stats.count(
                "stream.reconnects",
                max(0, stream["reconnects"] - self._last["reconnects"]))
            self.stats.count(
                "stream.window_stalls",
                max(0, stream["window_stalls"] - self._last["stalls"]))
            self.stats.count(
                "stream.shrink_events",
                max(0, stream.get("shrink_events", 0)
                    - self._last["shrinks"]))
            self._last["acked"] = stream["acked_total"]
            self._last["reconnects"] = stream["reconnects"]
            self._last["stalls"] = stream["window_stalls"]
            self._last["shrinks"] = stream.get("shrink_events", 0)
            self.stats.gauge("stream.unacked_frames",
                             float(stream["unacked_frames"]))
            self.stats.gauge("stream.open_streams", float(stream["opened"]))
            self.stats.gauge("stream.window_current",
                             float(stream.get("window_current", 0)))
            self.stats.gauge("stream.window_min_seen",
                             float(stream.get("window_min_seen", 0)))
            self.stats.gauge("stream.window_max_seen",
                             float(stream.get("window_max_seen", 0)))
        if self.trace_proxy is not None:
            spans = self.trace_proxy.proxied_spans
            self.stats.count("spans_proxied",
                             spans - self._last["spans"])
            self._last["spans"] = spans
        rss = current_rss_bytes()
        if rss is not None:
            self.stats.gauge("mem.rss_bytes", float(rss))

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.report_once()
                except Exception:  # pragma: no cover - telemetry best-effort
                    log.exception("proxy runtime metrics report failed")

        threading.Thread(target=loop, daemon=True,
                         name="proxy-runtime-metrics").start()

    def stop(self) -> None:
        self._stop.set()
