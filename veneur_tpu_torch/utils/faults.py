"""Deterministic seeded fault injection, copied from
veneur_tpu/utils/faults.py with its imports rebound.

The network part: ``FaultPlan`` scripts delivery faults (refusal, 5xx,
slow, reset, rejection, duplicates, flap and congestion windows) from one
seeded ``random.Random``. ``FaultyOpener`` wraps the ``opener`` every
HTTP sink takes, ``FaultySocket`` stands in for the repeater sinks'
socket, ``FaultyForwardClient`` wraps a proxy's or spread forwarder's
forward client and ``FaultyStreamSink`` an import server's stream sink,
so one scripted schedule drives both packages alike: the same seed gives
the same sequence of outcomes.

The device part: ``DeviceFaultPlan`` scripts faults per guarded
dispatch, ``InjectedDeviceFault`` is what an injected fault raises, and
``DeviceFaultInjector`` patches veneur_tpu_torch/ops/device_guard.dispatch
so every guarded call of the port consults the plan.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from veneur_tpu_torch.utils.http import HTTPError

FAULT_KINDS = ("refused", "http_5xx", "slow", "reset", "rejected",
               "duplicated", "busy", "ack_delay", "passed")


@dataclass
class FaultPlan:
    """Probabilities are evaluated in the order refuse → 5xx → slow →
    reset → reject (cumulative thresholds over one uniform draw);
    down_ranges override everything for their call-index window."""

    seed: int = 0
    p_refuse: float = 0.0
    p_5xx: float = 0.0
    p_slow: float = 0.0
    p_reset: float = 0.0
    p_reject: float = 0.0
    # duplicate-injection: after a SUCCESSFUL send, re-send
    # the same payload — the network artifact exactly-once dedup exists
    # to absorb. Drawn separately from the failure kinds (a duplicate
    # is not a failure), and only when > 0, so plans without it keep
    # their exact historical decision sequences.
    p_duplicate: float = 0.0
    slow_s: float = 0.2
    reset_after_s: float = 0.01   # partial body went out, then RST
    status_5xx: int = 503
    # [(start, end)) call-index windows that hard-refuse: a deterministic
    # outage → recovery edge that cycles the breaker
    down_ranges: list[tuple[int, int]] = field(default_factory=list)
    # [(start, end)) call-index windows of explicit receiver
    # backpressure: the forward client surfaces ForwardError("busy")
    # (FaultyForwardClient) — the AIMD window's multiplicative-decrease
    # trigger, scripted so collapse/recovery edges are reproducible
    busy_ranges: list[tuple[int, int]] = field(default_factory=list)
    # [(start, end)) call-index windows whose ack is delayed by
    # ack_delay_s before the send/frame proceeds: past the caller's
    # ack budget this manifests as an ack-timeout (the sender's OTHER
    # shrink signal), inside it as harmless latency
    ack_delay_ranges: list[tuple[int, int]] = field(default_factory=list)
    ack_delay_s: float = 0.2

    def total_p(self) -> float:
        return (self.p_refuse + self.p_5xx + self.p_slow + self.p_reset
                + self.p_reject)


class _FaultBase:
    def __init__(self, plan: FaultPlan,
                 sleep_fn: Callable[[float], None] = time.sleep) -> None:
        self.plan = plan
        self._sleep = sleep_fn
        self._lock = threading.Lock()
        import random

        self._rng = random.Random(plan.seed)
        self.calls = 0
        self.injected = {k: 0 for k in FAULT_KINDS}

    def _decide(self) -> str:
        with self._lock:
            idx = self.calls
            self.calls += 1
            for start, end in self.plan.down_ranges:
                if start <= idx < end:
                    self.injected["refused"] += 1
                    return "refused"
            r = self._rng.random()
            p = self.plan
            edge = p.p_refuse
            kind = "passed"
            if r < edge:
                kind = "refused"
            elif r < (edge := edge + p.p_5xx):
                kind = "http_5xx"
            elif r < (edge := edge + p.p_slow):
                kind = "slow"
            elif r < (edge := edge + p.p_reset):
                kind = "reset"
            elif r < edge + p.p_reject:
                kind = "rejected"
            self.injected[kind] += 1
            return kind

    def _dup_decide(self) -> bool:
        """Separate post-success draw: should the payload that just
        landed be sent again? Guarded on p_duplicate > 0 so plans
        without duplication consume no extra RNG draws (their decision
        sequences stay bit-identical to pre-dedup runs)."""
        with self._lock:
            if self.plan.p_duplicate <= 0.0:
                return False
            if self._rng.random() >= self.plan.p_duplicate:
                return False
            self.injected["duplicated"] += 1
            return True

    def _raise_for(self, kind: str, timeout: float) -> None:
        """Apply one non-pass decision (caller handles 'passed' /
        'slow'-then-success itself)."""
        if kind == "refused":
            raise ConnectionRefusedError(111, "injected: connection refused")
        if kind == "http_5xx":
            raise HTTPError(self.plan.status_5xx, b"injected 5xx")
        if kind == "reset":
            self._sleep(min(self.plan.reset_after_s, timeout))
            raise ConnectionResetError(104, "injected: mid-body reset")
        if kind == "rejected":
            raise HTTPError(400, b"injected payload rejection")
        raise AssertionError(kind)


class FaultyOpener(_FaultBase):
    """Drop-in for utils.http openers: (request, timeout) -> body.
    `inner` is the real opener to delegate clean calls to; None
    swallows them (a discarding backend)."""

    def __init__(self, plan: FaultPlan, inner: Optional[Callable] = None,
                 sleep_fn: Callable[[float], None] = time.sleep) -> None:
        super().__init__(plan, sleep_fn)
        self.inner = inner

    def __call__(self, req, timeout: float) -> bytes:
        kind = self._decide()
        if kind == "slow":
            if self.plan.slow_s >= timeout:
                # slower than the caller's budget: a real socket would
                # time out after exactly `timeout`
                self._sleep(timeout)
                raise TimeoutError("injected: response slower than timeout")
            self._sleep(self.plan.slow_s)
        elif kind != "passed":
            self._raise_for(kind, timeout)
        if self.inner is not None:
            out = self.inner(req, timeout)
        else:
            out = b"{}"
        if self._dup_decide():
            # the request landed, then the network replayed it (retried
            # POST whose first response was lost); best-effort — a real
            # ghost retry failing changes nothing for the original
            try:
                if self.inner is not None:
                    self.inner(req, timeout)
            except Exception:
                pass
        return out


class FaultyForwardClient(_FaultBase):
    """Wraps a distributed/rpc.ForwardClient for the proxy's forward
    path: every send consults the plan, plus a harness-scripted
    `partitioned` toggle (the churn soak's link-partition windows).
    Injected faults surface as classified ForwardErrors — the shape the
    proxy's DeliveryManager retry/spill path consumes — with the same
    taxonomy mapping the sinks' fault wrappers use: refusals/resets are
    transport-shaped ("unavailable", transient), over-budget slowness is
    a deadline, and HTTP-ish 5xx/rejection degrade to a permanent "send"
    on a gRPC link."""

    def __init__(self, plan: FaultPlan, inner,
                 sleep_fn: Callable[[float], None] = time.sleep) -> None:
        super().__init__(plan, sleep_fn)
        self.inner = inner
        self.address = getattr(inner, "address", "?")
        self._partitioned = False
        # last successfully delivered payload, for p_duplicate re-sends
        # and harness-scripted replay_last() across a receiver restart
        self._last_sent: Optional[tuple] = None

    def set_partitioned(self, on: bool) -> None:
        with self._lock:
            self._partitioned = bool(on)

    def _gate(self, timeout_s: Optional[float]) -> None:
        # deferred import: utils.faults stays importable without grpc
        from veneur_tpu_torch.distributed.rpc import ForwardError

        with self._lock:
            partitioned = self._partitioned
        if partitioned:
            with self._lock:
                self.calls += 1
                self.injected["refused"] += 1
            raise ForwardError("unavailable", self.address,
                               "injected: partitioned link")
        # scripted stream-congestion windows consume the call index
        # BEFORE the probabilistic draw so plans without them keep
        # their exact historical decision sequences
        timeout = timeout_s or getattr(self.inner, "timeout_s", 10.0)
        with self._lock:
            idx = self.calls
            busy = any(s <= idx < e for s, e in self.plan.busy_ranges)
            delayed = (not busy and any(
                s <= idx < e for s, e in self.plan.ack_delay_ranges))
            if busy or delayed:
                self.calls += 1
                self.injected["busy" if busy else "ack_delay"] += 1
        if busy:
            raise ForwardError("busy", self.address,
                               "injected: receiver busy-ack")
        if delayed:
            if self.plan.ack_delay_s >= timeout:
                self._sleep(timeout)
                raise ForwardError("deadline_exceeded", self.address,
                                   "injected: ack delayed past budget")
            self._sleep(self.plan.ack_delay_s)
            return
        kind = self._decide()
        if kind == "passed":
            return
        if kind == "slow":
            if self.plan.slow_s >= timeout:
                self._sleep(timeout)
                raise ForwardError("deadline_exceeded", self.address,
                                   "injected: slower than deadline")
            self._sleep(self.plan.slow_s)
            return
        if kind in ("refused", "reset"):
            raise ForwardError("unavailable", self.address,
                               f"injected: {kind}")
        raise ForwardError("send", self.address, f"injected: {kind}")

    def send_or_raise(self, batch, timeout_s=None) -> None:
        self._gate(timeout_s)
        self.inner.send_or_raise(batch, timeout_s)
        with self._lock:
            self._last_sent = ("batch", batch, None)
        if self._dup_decide():
            try:
                self.inner.send_or_raise(batch, timeout_s)
            except Exception:
                pass  # ghost retry; the original already landed

    def send_raw_or_raise(self, blob: bytes, n_metrics: int,
                          timeout_s=None) -> None:
        self._gate(timeout_s)
        self.inner.send_raw_or_raise(blob, n_metrics, timeout_s)
        with self._lock:
            self._last_sent = ("raw", blob, n_metrics)
        if self._dup_decide():
            try:
                self.inner.send_raw_or_raise(blob, n_metrics, timeout_s)
            except Exception:
                pass  # ghost retry; the original already landed

    def replay_last(self, timeout_s=None) -> bool:
        """Harness hook: re-deliver the last successfully sent payload
        verbatim — the scripted 'network replays an old frame across a
        receiver restart' fault the churn soak drives. Returns False if
        nothing has been delivered yet. Counted under 'duplicated'."""
        with self._lock:
            last = self._last_sent
        if last is None:
            return False
        with self._lock:
            self.injected["duplicated"] += 1
        kind, payload, n_metrics = last
        try:
            if kind == "raw":
                self.inner.send_raw_or_raise(payload, n_metrics, timeout_s)
            else:
                self.inner.send_or_raise(payload, timeout_s)
        except Exception:
            pass  # replayed frame bounced; still counts as injected
        return True

    def send(self, batch, timeout_s=None) -> bool:
        try:
            self.send_or_raise(batch, timeout_s)
        except Exception:
            return False
        return True

    def send_raw(self, blob: bytes, n_metrics: int, timeout_s=None) -> bool:
        try:
            self.send_raw_or_raise(blob, n_metrics, timeout_s)
        except Exception:
            return False
        return True

    def stats(self) -> dict:
        st = self.inner.stats()
        with self._lock:
            st["injected_faults"] = dict(self.injected)
            st["partitioned"] = self._partitioned
        return st

    def close(self) -> None:
        self.inner.close()


class FaultyStreamSink:
    """Receiver-side scripted congestion for the StreamMetrics path:
    wraps an import-tier stream sink (an object with
    submit(body, done)) and consults the plan's busy_ranges /
    ack_delay_ranges by FRAME index. A busy-windowed frame is
    busy-acked without touching the inner sink (the receiver
    explicitly refusing admission — the real AIMD shrink driver); a
    delay-windowed frame holds its ack for ack_delay_s before the
    inner sink sees it (an ack-timeout driver when the delay exceeds
    the sender's ack budget). Everything else passes through, so
    exactly-once dedup and coalescing behave normally around the
    scripted storm."""

    def __init__(self, plan: FaultPlan, inner,
                 sleep_fn: Callable[[float], None] = time.sleep) -> None:
        self.plan = plan
        self.inner = inner
        self._sleep = sleep_fn
        self._lock = threading.Lock()
        self.frames = 0
        self.injected = {"busy": 0, "ack_delay": 0, "passed": 0}

    def submit(self, body: bytes, done) -> None:
        from veneur_tpu_torch.distributed import codec

        with self._lock:
            idx = self.frames
            self.frames += 1
            busy = any(s <= idx < e for s, e in self.plan.busy_ranges)
            delayed = (not busy and any(
                s <= idx < e for s, e in self.plan.ack_delay_ranges))
            self.injected[
                "busy" if busy else
                "ack_delay" if delayed else "passed"] += 1
        if busy:
            done(codec.STREAM_ACK_BUSY)
            return
        if delayed:
            # hold the whole frame, not just the ack: the sender sees
            # dead air exactly as it would from a stalled receiver
            self._sleep(self.plan.ack_delay_s)
        self.inner.submit(body, done)

    def stats(self) -> dict:
        st = self.inner.stats() if hasattr(self.inner, "stats") else {}
        with self._lock:
            st["injected_faults"] = dict(self.injected)
        return st

    def close(self) -> None:
        if hasattr(self.inner, "close"):
            self.inner.close()


class FaultySocket(_FaultBase):
    """Stands in for the repeater sinks' socket (sink._sock): send and
    sendall consult the plan; clean traffic is forwarded to `inner` or
    discarded. Socket-level faults surface as OSErrors, like the real
    thing."""

    def __init__(self, plan: FaultPlan, inner=None,
                 sleep_fn: Callable[[float], None] = time.sleep) -> None:
        super().__init__(plan, sleep_fn)
        self.inner = inner
        self._timeout = 10.0

    def settimeout(self, timeout) -> None:
        if timeout is not None:
            self._timeout = float(timeout)
        if self.inner is not None:
            self.inner.settimeout(timeout)

    def _maybe_fail(self) -> None:
        kind = self._decide()
        if kind == "passed":
            return
        if kind == "slow":
            if self.plan.slow_s >= self._timeout:
                self._sleep(self._timeout)
                raise TimeoutError("injected: send slower than timeout")
            self._sleep(self.plan.slow_s)
            return
        if kind in ("http_5xx", "rejected"):
            # no HTTP semantics on a raw socket: both degrade to a
            # connection reset (still counted under their own kind)
            raise ConnectionResetError(104, f"injected: {kind}")
        self._raise_for(kind, self._timeout)

    def send(self, data: bytes) -> int:
        self._maybe_fail()
        if self.inner is not None:
            return self.inner.send(data)
        return len(data)

    def sendall(self, data: bytes) -> None:
        self._maybe_fail()
        if self.inner is not None:
            self.inner.sendall(data)

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()


@dataclass
class DeviceFaultPlan:
    """Seeded fault script for the device dispatch seam
    (ops/device_guard.dispatch), in two layers:

    * probabilistic: one uniform draw per guarded dispatch, cumulative
      thresholds in the order oom → compile → lost → other;
    * scripted windows: (start, end, kind) half-open DISPATCH-INDEX
      ranges that fault deterministically. ``windows`` counts every
      guarded dispatch, ``op_windows[op]`` only the dispatches of that op
      (e.g. fault micro-fold scatters 3..6 while folds stay clean). Op
      windows are checked first, then global windows, then the draw.

    ``ops``, when set, restricts the probabilistic layer to those op
    names (windows are always explicit about what they hit)."""

    seed: int = 0
    p_oom: float = 0.0
    p_compile: float = 0.0
    p_lost: float = 0.0
    p_other: float = 0.0
    windows: list[tuple[int, int, str]] = field(default_factory=list)
    op_windows: dict[str, list[tuple[int, int, str]]] = field(
        default_factory=dict)
    ops: Optional[tuple] = None


class InjectedDeviceFault(RuntimeError):
    """An injected device fault. device_guard.classify reads
    ``device_fault_kind`` before anything else, so the taxonomy runs
    without a real CUDA error; the message names the CUDA error the kind
    stands for."""

    _PREFIX = {"oom": "injected: CUDA out of memory",
               "compile": "injected: no kernel image is available for "
                          "execution on the device",
               "lost": "injected: an illegal memory access was "
                       "encountered",
               "other": "injected: unspecified device error"}

    def __init__(self, kind: str, op: str):
        super().__init__(f"{self._PREFIX[kind]} (op={op})")
        self.device_fault_kind = kind
        self.op = op


class DeviceFaultInjector:
    """Patches ops/device_guard.dispatch with a seeded gate.

    A context manager, or install()/uninstall(). Counts injections per
    kind and per op and dispatch indices per op, so a test can pin which
    window fired."""

    def __init__(self, plan: DeviceFaultPlan) -> None:
        self.plan = plan
        self._lock = threading.Lock()
        self._rng = random.Random(plan.seed)
        self.calls = 0
        self.op_calls: dict[str, int] = {}
        self.op_injected: dict[str, int] = {}
        self.injected = {"oom": 0, "compile": 0, "lost": 0, "other": 0,
                         "passed": 0}
        self._orig = None

    def _decide(self, op: str) -> Optional[str]:
        with self._lock:
            idx = self.calls
            self.calls += 1
            op_idx = self.op_calls.get(op, 0)
            self.op_calls[op] = op_idx + 1
            kind = None
            for start, end, k in self.plan.op_windows.get(op, ()):
                if start <= op_idx < end:
                    kind = k
                    break
            if kind is None:
                for start, end, k in self.plan.windows:
                    if start <= idx < end:
                        kind = k
                        break
            if kind is None and (self.plan.ops is None
                                 or op in self.plan.ops):
                p = self.plan
                if p.p_oom + p.p_compile + p.p_lost + p.p_other > 0:
                    r = self._rng.random()
                    edge = p.p_oom
                    if r < edge:
                        kind = "oom"
                    elif r < (edge := edge + p.p_compile):
                        kind = "compile"
                    elif r < (edge := edge + p.p_lost):
                        kind = "lost"
                    elif r < edge + p.p_other:
                        kind = "other"
            self.injected[kind or "passed"] += 1
            if kind is not None:
                self.op_injected[op] = self.op_injected.get(op, 0) + 1
            return kind

    def _dispatch(self, op: str, fn, *args, **kwargs):
        kind = self._decide(op)
        if kind is not None:
            raise InjectedDeviceFault(kind, op)
        return self._orig(op, fn, *args, **kwargs)

    def install(self) -> "DeviceFaultInjector":
        from veneur_tpu_torch.ops import device_guard

        if self._orig is not None:
            raise RuntimeError("injector already installed")
        self._orig = device_guard.dispatch
        device_guard.dispatch = self._dispatch
        return self

    def uninstall(self) -> None:
        from veneur_tpu_torch.ops import device_guard

        if self._orig is not None:
            device_guard.dispatch = self._orig
            self._orig = None

    def __enter__(self) -> "DeviceFaultInjector":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
