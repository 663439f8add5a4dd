"""Deterministic seeded fault injection at the device dispatch seam.

The device part of veneur_tpu/utils/faults.py, copied: ``DeviceFaultPlan``
scripts faults per guarded dispatch, ``InjectedDeviceFault`` is what an
injected fault raises, and ``DeviceFaultInjector`` patches
veneur_tpu_torch/ops/device_guard.dispatch so every guarded call of the
port consults the plan. The network fault classes wait for the global
tier.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Optional


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
