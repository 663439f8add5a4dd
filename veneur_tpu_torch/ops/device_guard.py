"""Device fault domain: guarded execution, breaker and the dispatch seam,
PyTorch port of veneur_tpu/ops/device_guard.py.

Every device entry point of the worker (spill folds, micro-fold
scatters, staged-plane folds, the flush extract and its readbacks, set
inserts and estimates, pool growth, the probe) goes through
``DeviceGuard.call``, which

1. routes the invocation through the module-level ``dispatch`` seam,
   the one place seeded fault injection patches (utils/faults.py);
2. classifies an exception into the ``device.fault.*`` taxonomy (oom /
   compile / lost / other; a real CUDA error is oom or lost, see
   ``classify``) and counts it;
3. retries once where the call site declared itself retry-safe (its
   inputs are intact after a fault: the extract, the set inserts, the
   pre-flight allocation);
4. trips a per-worker breaker after ``streak_limit`` consecutive faults,
   after which the worker quarantines its device path and runs the same
   torch programs on the CPU (core/worker.DeviceWorker._quarantine_live);
5. while quarantined, gates re-admission behind a probe (a fold and an
   extract of a tiny pool) run once per ``probe_interval_s``.

A CUDA fault surfaces at the next synchronisation, not at the launch, so
the worker's guarded closures hold the syncs and readbacks of the work
they launch.

``classify`` names two kinds of real fault: an out-of-memory error, and
a sticky or uncorrectable-ECC CUDA error (the device or its context is
lost). It returns None for everything else, which re-raises untouched
and never fails over: Python errors, argument checks (ValueError,
TypeError), a failed nvcc build (a RuntimeError of ops/nvcc.py), and a
kernel that will not load or launch (no image for the card, invalid
PTX, an invalid launch configuration: any other CUDA error code). Those
are a broken kernel or a code bug, not a device fault, and the guard is
no way around them. The kinds ``compile`` and ``other`` stay in the
taxonomy for injected faults (utils/faults.py).

Escape hatch: ``VENEUR_DEVICE_GUARD=0`` (or config ``device_guard:
false``) builds the guard disabled: ``call`` invokes the function
directly, with no seam, classification or breaker.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

import torch

from veneur_tpu_torch.ops.nvcc import CudaError

log = logging.getLogger("veneur_tpu_torch.ops.device_guard")

FAULT_KINDS = ("oom", "compile", "lost", "other")

#: default consecutive-failure streak that trips the breaker
DEFAULT_STREAK_LIMIT = 3
#: default seconds between re-admission probes while quarantined
DEFAULT_PROBE_INTERVAL_S = 30.0

# the cudaError_t codes that are device faults. oom: memory allocation.
# lost: illegal address, device-side assert, hardware stack error,
# illegal instruction, misaligned address, invalid PC, launch failure
# (the sticky codes, which leave the context unusable for the process)
# and an uncorrectable ECC error. Every other code is not a device fault.
_CODE_KINDS = {2: "oom",
               700: "lost", 710: "lost", 714: "lost", 715: "lost",
               716: "lost", 717: "lost", 718: "lost", 719: "lost",
               214: "lost"}


def guard_enabled_default() -> bool:
    """Process-wide escape hatch (checked at worker construction)."""
    return os.environ.get("VENEUR_DEVICE_GUARD", "1") not in ("0", "false")


class DeviceFaultError(RuntimeError):
    """A classified device failure, raised by DeviceGuard.call after
    counting (and after the retry, where one was allowed). Carries the
    taxonomy kind and the original exception."""

    def __init__(self, kind: str, op: str, original: BaseException):
        super().__init__(f"device fault [{kind}] in {op}: {original}")
        self.kind = kind
        self.op = op
        self.original = original


def classify(exc: BaseException) -> Optional[str]:
    """Map an exception to a fault kind, or None for "not a device
    error: re-raise untouched"."""
    if isinstance(exc, DeviceFaultError):
        return exc.kind
    # injected faults (utils/faults.DeviceFaultPlan) carry their kind
    kind = getattr(exc, "device_fault_kind", None)
    if kind is not None:
        return kind if kind in FAULT_KINDS else "other"
    if isinstance(exc, torch.OutOfMemoryError):
        return "oom"
    if isinstance(exc, CudaError):
        return _CODE_KINDS.get(exc.code)
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return _CODE_KINDS.get(getattr(exc, "error_code", None))
    return None


def host_copy(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` on the CPU. Where the readback itself fails (a sticky CUDA
    error took the context with it) a zero tensor of its shape and type,
    logged: that state restarts empty, as the reference's does."""
    try:
        return t.cpu()
    except Exception:
        log.exception("%s readback failed during failover; restarting it "
                      "empty on the CPU", what)
        return torch.zeros(t.shape, dtype=t.dtype)


def dispatch(op: str, fn: Callable, *args, **kwargs):
    """The device dispatch seam: every guarded call funnels through this
    function so seeded fault injection has one surface to patch
    (utils/faults.DeviceFaultInjector). ``op`` names the call site
    (fold/spill/staged/micro/extract/sets/grow/probe)."""
    return fn(*args, **kwargs)


class DeviceGuard:
    """Per-worker breaker over the guarded device path."""

    def __init__(self, streak_limit: int = DEFAULT_STREAK_LIMIT,
                 probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
                 enabled: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self.enabled = enabled
        self.streak_limit = max(1, int(streak_limit))
        self.probe_interval_s = float(probe_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._streak = 0
        self._quarantined = False
        self._trip_reason: Optional[str] = None
        self._last_probe_t: Optional[float] = None
        self._counters: dict[str, int] = {}
        # the last classified fault, "kind:op"
        self.last_fault: Optional[str] = None

    # -- state reads ------------------------------------------------------

    @property
    def quarantined(self) -> bool:
        return self._quarantined

    @property
    def trip_reason(self) -> Optional[str]:
        return self._trip_reason

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def bump(self, key: str, n: int = 1) -> None:
        """Counter hook for guard-adjacent events outside call(), such as
        the HBM valve's grow-OOM degradation."""
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    # -- the guarded call -------------------------------------------------

    def call(self, op: str, fn: Callable, *args, retryable: bool = False,
             **kwargs):
        """Run one device operation under the guard.

        retryable=True only where the inputs are intact after a fault
        (extract, set inserts, allocation pre-flights): a transient fault
        there retries once. Folds update the pool in place, so their
        faults surface at once and the worker replays the retained host
        inputs on the CPU instead."""
        if not self.enabled:
            return fn(*args, **kwargs)
        try:
            out = dispatch(op, fn, *args, **kwargs)
        except Exception as exc:
            kind = classify(exc)
            if kind is None:
                raise
            self._note_fault(op, kind)
            if retryable and not self._quarantined:
                self.bump("device.fault.retries")
                try:
                    out = dispatch(op, fn, *args, **kwargs)
                except Exception as exc2:
                    kind2 = classify(exc2)
                    if kind2 is None:
                        raise
                    self._note_fault(op, kind2)
                    raise DeviceFaultError(kind2, op, exc2) from exc2
                self.bump("device.fault.retry_success")
                self._note_success()
                return out
            raise DeviceFaultError(kind, op, exc) from exc
        self._note_success()
        return out

    def _note_fault(self, op: str, kind: str) -> None:
        with self._lock:
            self._counters[f"device.fault.{kind}"] = (
                self._counters.get(f"device.fault.{kind}", 0) + 1)
            self.last_fault = f"{kind}:{op}"
            self._streak += 1
            tripped = (not self._quarantined
                       and self._streak >= self.streak_limit)
            if tripped:
                self._quarantined = True
                self._trip_reason = (
                    f"{self._streak} consecutive device faults,"
                    f" last [{kind}] in {op}")
                self._counters["device.guard.trips"] = (
                    self._counters.get("device.guard.trips", 0) + 1)
                # the first probe waits a full interval: the device just
                # proved itself unhealthy
                self._last_probe_t = self._clock()
        log.error("device fault [%s] in %s", kind, op)
        if tripped:
            log.error("device breaker OPEN: %s; failing over to the CPU",
                      self._trip_reason)

    def _note_success(self) -> None:
        # lock-free on the healthy path: _streak only matters as "nonzero
        # after a fault", and faults serialize through _note_fault's lock
        if self._streak:
            with self._lock:
                self._streak = 0

    # -- explicit breaker control ----------------------------------------

    def trip(self, reason: str) -> None:
        """Force the breaker open, where one fault already shows the
        device path cannot go on (an OOM on pool growth after its
        pre-flight)."""
        with self._lock:
            if self._quarantined:
                return
            self._quarantined = True
            self._trip_reason = reason
            self._counters["device.guard.trips"] = (
                self._counters.get("device.guard.trips", 0) + 1)
            self._last_probe_t = self._clock()
        log.error("device breaker OPEN: %s; failing over to the CPU",
                  reason)

    def probe_due(self, now: Optional[float] = None) -> bool:
        """Half-open check: quarantined and a probe interval has passed
        since the trip or the last failed probe."""
        with self._lock:
            if not self._quarantined:
                return False
            now = self._clock() if now is None else now
            return (self._last_probe_t is None
                    or now - self._last_probe_t >= self.probe_interval_s)

    def note_probe(self, ok: bool) -> None:
        with self._lock:
            self._counters["device.guard.probes"] = (
                self._counters.get("device.guard.probes", 0) + 1)
            if not ok:
                self._counters["device.guard.probe_failures"] = (
                    self._counters.get("device.guard.probe_failures", 0) + 1)
                self._last_probe_t = self._clock()

    def readmit(self) -> None:
        with self._lock:
            if not self._quarantined:
                return
            self._quarantined = False
            self._trip_reason = None
            self._streak = 0
            self._last_probe_t = None
            self._counters["device.guard.readmissions"] = (
                self._counters.get("device.guard.readmissions", 0) + 1)
        log.warning("device breaker CLOSED: probe succeeded, device path"
                    " re-admitted")
