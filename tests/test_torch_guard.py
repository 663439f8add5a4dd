"""The port's device fault domain against the JAX package's, on the CPU.

The JAX package's contract (tests/test_device_guard.py): a device fault
anywhere on the guarded path never loses an epoch. The worker finishes
the flush on its failover engine, bit-identical to the device path, so a
faulted flush is byte for byte the snapshot a healthy device gives (only
``degraded`` differs); a streak of faults trips the breaker and
quarantines the device path; a probe re-admits it. The port's failover
engine is its own torch programs on the CPU, so here the port worker
(``device="cpu"``) runs under seeded faults (veneur_tpu_torch/utils/
faults.py) and every snapshot is held to the JAX package's HEALTHY
worker fed the same numpy-seeded interval.

Also: the taxonomy of torch and CUDA errors (typed ``CudaError`` codes,
``torch.OutOfMemoryError``, ``torch.AcceleratorError``), the argument
checks and build failures it leaves alone, and the breaker's streak,
retry, probe schedule and escape hatch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.flusher import device_quantiles
from veneur_tpu.core.metrics import HistogramAggregates
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server
from veneur_tpu_torch.ops import device_guard as dg
from veneur_tpu_torch.ops import extract_kernel as ek
from veneur_tpu_torch.ops import hll_kernel, nvcc
from veneur_tpu_torch.protocol import dogstatsd as tdog
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TChannel
from veneur_tpu_torch.utils import faults as fl

AGGS = HistogramAggregates.from_names(["min", "max", "sum", "count"])
PCTS = [0.5, 0.9, 0.99]
QS = device_quantiles(PCTS, AGGS)

# one always-open window per flush-path op (dispatch indices [0, 1e6))
ALWAYS = [(0, 10**6, "oom")]
FLUSH_OPS = ("fold", "spill", "staged", "micro", "extract", "sets", "grow")


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    assert a.tobytes() == b.tobytes(), what


def _assert_snapshots_identical(js, ts, what):
    """The port's snapshot bitwise the JAX package's, ``degraded``
    excluded (it is the one field a failover is meant to change): every
    array, the directories' keys and the counter and gauge values."""
    for f in dataclasses.fields(js):
        if f.name in ("degraded", "directory", "scalars"):
            continue
        va, vb = getattr(js, f.name), getattr(ts, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, (what, f.name)
            _same(va, vb, (what, f.name))
        else:
            assert va == vb, (what, f.name, va, vb)
    for pool in ("histo", "sets"):
        keys = [[r.key for r in getattr(s.directory, pool).rows]
                for s in (js, ts)]
        assert [(k.name, k.type, k.joined_tags) for k in keys[0]] == \
            [(k.name, k.type, k.joined_tags) for k in keys[1]], (what, pool)
    for pool in ("counters", "gauges"):
        pa, pb = getattr(js.scalars, pool), getattr(ts.scalars, pool)
        _same(pa.values[:pa.used], pb.values[:pb.used], (what, pool))


def _kw(**kw):
    kw.setdefault("compression", 100)
    kw.setdefault("stage_depth", 32)
    kw.setdefault("batch_size", 8)
    kw.setdefault("initial_histo_rows", 8)
    kw.setdefault("initial_set_rows", 8)
    kw.setdefault("micro_fold_rows", 1)
    kw.setdefault("micro_fold_max_age_s", 1e9)
    return kw


def _jax_worker(micro=False, native=False, **kw):
    w = jw.DeviceWorker(micro_fold=micro, **_kw(**kw))
    if native:
        assert w.attach_native()
    return w


def _port_worker(micro=False, native=False, **kw):
    w = tw.DeviceWorker(micro_fold=micro, device="cpu", **_kw(**kw))
    if native:
        assert w.attach_native()
    return w


def _interval(seed):
    """The reference test's mixed interval (tests/test_device_guard.py
    _feed_interval), as 8 batches of lines: t-digest timers past the
    initial pool, sets, counters, gauges."""
    rng = np.random.default_rng(seed)
    batches = []
    for batch in range(8):
        lines = []
        for i in range(10):
            k = (batch * 10 + i) % 17
            lines.append(f"h{k}:{rng.normal():.6f}|ms|#a:{k % 3}".encode())
            lines.append(f"c{k}:{1 + k % 4}|c".encode())
            lines.append(f"g{k}:{rng.normal():.6f}|g".encode())
            lines.append(f"s{k}:v{rng.integers(200)}|s".encode())
        batches.append(lines)
    return batches


def _feed(w, batches, parse, micro=False, native=False):
    """One interval through a worker: line by line (Python path) or one
    datagram a batch (native path); micro-folds at every other batch, so
    a fault can land mid-stream."""
    for b, lines in enumerate(batches):
        if native:
            w.ingest_datagram(b"\n".join(lines))
        else:
            for ln in lines:
                w.process_metric(parse(ln))
        if micro and b % 2 == 0 and w.micro_fold_due():
            w.micro_fold_once()


def _jax_snaps(seeds, micro=False, native=False, **kw):
    w = _jax_worker(micro, native, **kw)
    out = []
    for s in seeds:
        _feed(w, _interval(s), jdog.parse_metric, micro, native)
        out.append(w.flush(QS))
    return out


# -- taxonomy -----------------------------------------------------------------


def _accel(code):
    e = torch.AcceleratorError(f"CUDA error {code}")
    e.error_code = code
    return e


@pytest.mark.parametrize("codes,kind", [
    ((2,), "oom"),
    ((700, 710, 714, 715, 716, 717, 718, 719, 214), "lost"),
    # no kernel image, invalid PTX, unsupported PTX version, invalid
    # device function: a kernel that will not load is a broken kernel
    ((209, 218, 222, 98), None),
    # invalid value (a bad launch configuration) and any other code
    ((1, 4, 201, 999), None),
], ids=["oom", "lost", "image", "launch"])
def test_classify_cuda_error_codes(codes, kind):
    """Only OOM and the sticky or ECC codes are device faults; a kernel
    that will not load or launch raises untouched and never fails over."""
    for code in codes:
        with pytest.raises(nvcc.CudaError) as ei:
            nvcc.check(code, "a launcher")
        assert ei.value.code == code
        assert dg.classify(ei.value) == kind, code
        assert dg.classify(_accel(code)) == kind, code
    nvcc.check(0, "a launcher")  # cudaSuccess raises nothing
    if kind is None:
        g = dg.DeviceGuard(streak_limit=1)
        for code in codes:
            with pytest.raises(nvcc.CudaError):
                g.call("extract", nvcc.check, code, "a launcher",
                       retryable=True)
        assert g.counters() == {} and not g.quarantined


def test_classify_torch_errors_and_injected_faults():
    assert dg.classify(torch.OutOfMemoryError("CUDA out of memory")) == "oom"
    # an AcceleratorError without a code is not a known device fault
    assert dg.classify(torch.AcceleratorError("CUDA error")) is None
    for kind in dg.FAULT_KINDS:
        assert dg.classify(fl.InjectedDeviceFault(kind, "fold")) == kind
    err = dg.DeviceFaultError("oom", "fold", RuntimeError("x"))
    assert dg.classify(err) == "oom"
    # Python errors are not device faults
    for exc in (ValueError("bad arg"), TypeError("nope"),
                RuntimeError("CUDA error 700 in the message only"),
                KeyError("k")):
        assert dg.classify(exc) is None


def test_argument_checks_and_build_failures_stay_unclassified(
        monkeypatch, tmp_path):
    """The kernel wrappers' argument checks raise ValueError/TypeError,
    and a failed nvcc build a RuntimeError: none is a device fault, so
    the guard re-raises it and nothing fails over."""
    cpu = torch.zeros((4, 16), dtype=torch.int8)
    recs = torch.zeros((1, 2), dtype=torch.int32)
    f32 = [torch.zeros((2, 128)), torch.zeros((2, 128))] + \
        [torch.zeros(2) for _ in range(12)]
    bad_dtype = [f.double() for f in f32]
    cases = [
        lambda: hll_kernel.insert(cpu, recs),
        lambda: hll_kernel.estimate(cpu, 4),
        lambda: hll_kernel.insert(cpu.float(), recs),
        lambda: ek.flush_extract(*bad_dtype, torch.zeros(3)),
        lambda: ek._launch(8, tuple(f32), torch.zeros(3)),
    ]
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(nvcc, "nvcc", lambda: "false")
    cases.append(lambda: nvcc.build(nvcc.CSRC / "hll.cu", nvcc.FLAGS))
    g = dg.DeviceGuard(streak_limit=1)
    for fn in cases:
        with pytest.raises((ValueError, TypeError, RuntimeError)) as ei:
            g.call("extract", fn, retryable=True)
        assert not isinstance(ei.value, dg.DeviceFaultError)
        assert dg.classify(ei.value) is None, ei.value
    assert g.counters() == {} and not g.quarantined


def test_host_copy_restarts_empty_when_the_readback_fails():
    class Lost:
        shape, dtype = (3, 4), torch.int8

        def cpu(self):
            raise _accel(700)

    out = dg.host_copy(Lost(), "a pool")
    assert out.dtype == torch.int8 and out.shape == (3, 4)
    assert not out.any()
    t = torch.arange(4)
    assert dg.host_copy(t, "x") is t


# -- breaker ------------------------------------------------------------------


def _fake_clock(t0=0.0):
    state = {"t": t0}
    return (lambda: state["t"]), state


def _boom(kind="oom", op="fold"):
    def fn():
        raise fl.InjectedDeviceFault(kind, op)
    return fn


def test_streak_trips_breaker():
    g = dg.DeviceGuard(streak_limit=3, clock=_fake_clock()[0])
    for i in range(2):
        with pytest.raises(dg.DeviceFaultError):
            g.call("fold", _boom())
        assert not g.quarantined, i
    # a success between faults resets the streak
    assert g.call("fold", lambda: 42) == 42
    for _ in range(2):
        with pytest.raises(dg.DeviceFaultError):
            g.call("fold", _boom())
        assert not g.quarantined
    with pytest.raises(dg.DeviceFaultError):
        g.call("fold", _boom())
    assert g.quarantined
    assert "oom" in g.trip_reason and "fold" in g.trip_reason
    c = g.counters()
    assert c["device.fault.oom"] == 5 and c["device.guard.trips"] == 1
    assert g.last_fault == "oom:fold"


def test_retryable_retries_once():
    g = dg.DeviceGuard(streak_limit=3)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise _accel(700)
        return "ok"

    assert g.call("extract", flaky, retryable=True) == "ok"
    c = g.counters()
    assert c["device.fault.retries"] == 1
    assert c["device.fault.retry_success"] == 1
    assert c["device.fault.lost"] == 1
    assert not g.quarantined
    # not retryable: the first fault surfaces at once
    calls["n"] = 0
    with pytest.raises(dg.DeviceFaultError) as ei:
        g.call("fold", flaky)
    assert calls["n"] == 1 and ei.value.kind == "lost"
    assert isinstance(ei.value.original, torch.AcceleratorError)


def test_python_errors_reraise_unclassified():
    g = dg.DeviceGuard()

    def bug():
        raise ValueError("host-side bug")

    with pytest.raises(ValueError):
        g.call("fold", bug)
    assert g.counters() == {} and not g.quarantined


def test_probe_schedule_half_open():
    clock, state = _fake_clock()
    g = dg.DeviceGuard(streak_limit=1, probe_interval_s=30.0, clock=clock)
    with pytest.raises(dg.DeviceFaultError):
        g.call("fold", _boom())
    assert g.quarantined
    # the first probe waits a full interval from the trip
    assert not g.probe_due()
    state["t"] = 29.0
    assert not g.probe_due()
    state["t"] = 30.0
    assert g.probe_due()
    # a failed probe re-arms the timer
    g.note_probe(False)
    assert not g.probe_due()
    state["t"] = 60.0
    assert g.probe_due()
    g.note_probe(True)
    g.readmit()
    assert not g.quarantined and g.trip_reason is None
    c = g.counters()
    assert c["device.guard.probes"] == 2
    assert c["device.guard.probe_failures"] == 1
    assert c["device.guard.readmissions"] == 1


def test_disabled_guard_is_passthrough():
    g = dg.DeviceGuard(enabled=False)
    # no seam, no classification, no counters: the raw exception
    with pytest.raises(fl.InjectedDeviceFault):
        g.call("fold", _boom())
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            op_windows={"fold": ALWAYS})) as inj:
        assert g.call("fold", lambda: 7) == 7
    assert inj.injected["oom"] == 0
    assert g.counters() == {} and not g.quarantined


# -- the failover matrix ------------------------------------------------------


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
@pytest.mark.parametrize("micro", [False, True], ids=["batch", "micro"])
def test_fault_failover_bitwise(micro, native):
    """Every flush under persistent faults in every op, the quarantined
    one that runs on the CPU from start to finish included, is byte for
    byte the JAX package's healthy snapshot, for all three metric
    classes, micro-folds on and off, on both ingest paths."""
    clean = _jax_snaps((1, 2, 3), micro, native)
    w = _port_worker(micro, native, device_fault_streak=2)
    plan = fl.DeviceFaultPlan(seed=9,
                              op_windows={op: ALWAYS for op in FLUSH_OPS})
    got = []
    with fl.DeviceFaultInjector(plan) as inj:
        for seed in (1, 2):
            _feed(w, _interval(seed), tdog.parse_metric, micro, native)
            got.append(w.flush(QS))
    assert sum(inj.injected[k] for k in dg.FAULT_KINDS) > 0, \
        "no fault injected: the matrix would compare healthy to healthy"
    assert w.guard.quarantined
    # third interval: the card is healthy again but still quarantined,
    # so the live epoch runs on the CPU from start to finish
    _feed(w, _interval(3), tdog.parse_metric, micro, native)
    got.append(w.flush(QS))
    for n, (a, b) in enumerate(zip(clean, got)):
        _assert_snapshots_identical(a, b, f"interval={n}")
        assert b.degraded, f"interval={n} should be flagged degraded"
        assert not a.degraded
    assert w.host_fallback_flushes == 3


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_probe_readmits_and_restores_device_path(native):
    """quarantine → probe → re-admission: the flush after it runs on the
    device path (not degraded) and is bitwise the healthy one."""
    w = _port_worker(native=native, device_fault_streak=1)
    plan = fl.DeviceFaultPlan(
        seed=3, op_windows={op: [(0, 10**6, "lost")]
                            for op in ("staged", "extract", "spill")})
    with fl.DeviceFaultInjector(plan):
        _feed(w, _interval(5), tdog.parse_metric, native=native)
        s_fault = w.flush(QS)
    assert s_fault.degraded and w.guard.quarantined
    w.guard.probe_interval_s = 0.0
    w.device_guard_tick()
    assert not w.guard.quarantined and not w._host_live
    c = w.guard.counters()
    assert c["device.guard.probes"] == 1
    assert c["device.guard.readmissions"] == 1
    assert c["device.guard.quarantines"] == 1
    _feed(w, _interval(6), tdog.parse_metric, native=native)
    s_after = w.flush(QS)
    assert not s_after.degraded
    b_first, b_after = _jax_snaps((5, 6), native=native)
    _assert_snapshots_identical(b_first, s_fault, "faulted interval")
    _assert_snapshots_identical(b_after, s_after, "after re-admission")


def test_quarantine_mid_epoch_moves_the_live_pools_and_back():
    """A trip mid-epoch: the tick moves the live pools to the CPU (the
    epoch goes on there), the probe moves them back, and the interval is
    the healthy one."""
    w = _port_worker(set_store="dense", device_fault_streak=1)
    batches = _interval(7)
    _feed(w, batches[:4], tdog.parse_metric)
    w.guard.trip("test: trip mid-epoch")
    w.device_guard_tick()
    assert w._host_live and w._sets_on_host()
    _feed(w, batches[4:6], tdog.parse_metric)
    w.guard.probe_interval_s = 0.0
    w.device_guard_tick()
    assert not w._host_live and not w._sets_on_host()
    _feed(w, batches[6:], tdog.parse_metric)
    snap = w.flush(QS)
    assert not snap.degraded
    ref = _jax_snaps((7,), set_store="dense")[0]
    _assert_snapshots_identical(ref, snap, "trip mid-epoch")


def test_failed_probe_stays_quarantined():
    w = _port_worker(device_fault_streak=1)
    plan = fl.DeviceFaultPlan(
        seed=4, op_windows={"staged": [(0, 10**6, "lost")],
                            "extract": [(0, 10**6, "lost")]})
    with fl.DeviceFaultInjector(plan):
        _feed(w, _interval(5), tdog.parse_metric)
        w.flush(QS)
    assert w.guard.quarantined
    w.guard.probe_interval_s = 0.0
    # the probe itself faults: still quarantined, timer re-armed
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=5, op_windows={"probe": [(0, 10**6, "lost")]})):
        w.device_guard_tick()
    assert w.guard.quarantined and w._host_live
    assert w.guard.counters()["device.guard.probe_failures"] == 1
    # the next interval still flushes, on the CPU, equal to a healthy one
    _feed(w, _interval(6), tdog.parse_metric)
    snap = w.flush(QS)
    assert snap.degraded
    _assert_snapshots_identical(_jax_snaps((6,))[0], snap, "quarantined")


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_transient_fault_window_conserves(native):
    """A burst of faults that heals: some device ops succeed before it,
    the CPU completes the rest, still bitwise; the next interval is a
    healthy device flush."""
    clean = _jax_snaps((11, 12), native=native)
    w = _port_worker(native=native, device_fault_streak=10)
    plan = fl.DeviceFaultPlan(seed=6, op_windows={
        "staged": [(0, 2, "oom")], "spill": [(0, 2, "oom")]})
    with fl.DeviceFaultInjector(plan) as inj:
        _feed(w, _interval(11), tdog.parse_metric, native=native)
        got = w.flush(QS)
    assert inj.injected["oom"] > 0
    assert not w.guard.quarantined, "a burst must not trip a streak of 10"
    _assert_snapshots_identical(clean[0], got, "transient burst")
    assert got.degraded
    _feed(w, _interval(12), tdog.parse_metric, native=native)
    after = w.flush(QS)
    assert not after.degraded
    _assert_snapshots_identical(clean[1], after, "after the burst")


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_fold_fault_keeps_the_batch_cuts(native):
    """A spill fold that faults without tripping keeps its batch whole and
    folds it before the next one, so the interval is bitwise the healthy
    one and runs on the device throughout. (The reference joins the
    faulted batch to the next pending one, which changes its digests'
    bits; ROADMAP.md section 3.)"""
    kw = dict(stage_depth=2)
    clean = _jax_snaps((41,), native=native, **kw)[0]
    w = _port_worker(native=native, device_fault_streak=10, **kw)
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=13, op_windows={"fold": [(0, 1, "lost")]})) as inj:
        _feed(w, _interval(41), tdog.parse_metric, native=native)
        got = w.flush(QS)
    assert inj.injected["lost"] == 1 and inj.op_calls["fold"] >= 3
    assert not got.degraded and not w.guard.quarantined
    _assert_snapshots_identical(clean, got, "fold fault")


@pytest.mark.parametrize("native,when", [
    (False, "repeat"), (False, "trip"), (True, "repeat"), (True, "trip"),
    (True, "flush")], ids=["python-repeat", "python-trip", "native-repeat",
                           "native-trip", "native-flush"])
def test_fault_among_the_spill_writes_lands_once(monkeypatch, native, when):
    """A real OOM raised inside the spill fold after its first writes (not
    at the dispatch seam): the pool is partly written. The held update's
    writes are finished, never the batch folded again, so no sample
    counts twice and the interval is bitwise the JAX package's healthy
    snapshot. repeat: the live fold's writes fault twice and land on the
    device at the third try; trip: a streak of 1 trips the breaker and
    they land on the CPU; flush: the native path's deferred spill faults
    in the extraction, which lands them on the CPU and finishes there."""
    kw = dict(stage_depth=2)
    if when == "flush":
        # no drain before the swap: all the spill folds at the flush
        kw["batch_size"] = 1 << 20
    clean = _jax_snaps((41,), native=native, **kw)[0]
    w = _port_worker(native=native, device_fault_streak=1 if when == "trip"
                     else 10, **kw)
    faults = 2 if when == "repeat" else 1
    left = {"n": 0 if when == "flush" else faults}
    real = torch.Tensor.scatter_reduce_

    def flaky(self, dim, index, src, reduce, **k):
        # lmin's scatter, the seventh of the fold's 14 writes
        if reduce == "amin" and left["n"]:
            left["n"] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return real(self, dim, index, src, reduce, **k)

    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", flaky)
    _feed(w, _interval(41), tdog.parse_metric, native=native)
    if when == "flush":
        left["n"] = faults
    got = w.flush(QS)
    monkeypatch.undo()
    assert left["n"] == 0, "the writes never faulted"
    assert w.guard.counters()["device.fault.oom"] == faults
    assert w.guard.quarantined == (when == "trip")
    _assert_snapshots_identical(clean, got, "fault among the writes")
    assert got.degraded == (when != "repeat")


def test_escape_hatch_disables_guard(monkeypatch):
    """VENEUR_DEVICE_GUARD=0: no dispatch seam, so no injection fires and
    the flushes are the healthy ones."""
    monkeypatch.setenv("VENEUR_DEVICE_GUARD", "0")
    w = _port_worker()
    assert not w.guard.enabled
    plan = fl.DeviceFaultPlan(seed=7,
                              op_windows={op: ALWAYS for op in FLUSH_OPS})
    with fl.DeviceFaultInjector(plan) as inj:
        _feed(w, _interval(13), tdog.parse_metric)
        snap = w.flush(QS)
    assert sum(inj.injected.values()) == 0, \
        "guarded dispatch ran despite the escape hatch"
    assert not snap.degraded and w.guard.counters() == {}
    monkeypatch.delenv("VENEUR_DEVICE_GUARD")
    assert _port_worker().guard.enabled
    _assert_snapshots_identical(_jax_snaps((13,))[0], snap, "hatch")


def test_grow_oom_valve_degrades_not_faults():
    """OOM on pool growth: the valve takes the fault, trips the breaker,
    and the epoch grows and flushes, exact, on the CPU."""
    clean = _jax_snaps((21,), initial_histo_rows=4)[0]
    w = _port_worker(initial_histo_rows=4)
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=8, op_windows={"grow": ALWAYS})) as inj:
        _feed(w, _interval(21), tdog.parse_metric)
        got = w.flush(QS)
    assert inj.injected["oom"] > 0, "growth never ran"
    assert w.guard.quarantined
    assert w.guard.counters().get("device.valve.grow_oom", 0) >= 1
    _assert_snapshots_identical(clean, got, "grow valve")
    assert got.degraded


def test_grow_preflight_runs_past_its_threshold(monkeypatch):
    """A growth past _GROW_PREFLIGHT_MIN_BYTES pre-flights its allocation
    as a guarded "grow"; an OOM there trips the breaker with the old pool
    untouched, and the epoch grows on the CPU."""
    monkeypatch.setattr(tw, "_GROW_PREFLIGHT_MIN_BYTES", 1)
    clean = _jax_snaps((22,), initial_histo_rows=4)[0]
    w = _port_worker(initial_histo_rows=4)
    seen = []

    def preflight(new_rows):
        seen.append(new_rows)
        raise torch.OutOfMemoryError("CUDA out of memory (test)")

    monkeypatch.setattr(w, "_grow_preflight", preflight)
    _feed(w, _interval(22), tdog.parse_metric)
    got = w.flush(QS)
    assert seen == [8, 8]  # the pre-flight is retried once
    c = w.guard.counters()
    assert c["device.fault.oom"] == 2  # the pre-flight and its retry
    assert c["device.valve.grow_oom"] == 1 and w.guard.quarantined
    _assert_snapshots_identical(clean, got, "pre-flight OOM")
    assert got.degraded


def _set_interval(seed, p):
    """Set series lines, then bulk (row, register, rank) updates past the
    staged store's compaction (65,536 pending), so rows promote to its
    dense tier (past 2^p / 8 registers) and the dense pool fills."""
    from veneur_tpu_torch.ops.hll import split_hashes

    rng = np.random.default_rng(seed)
    lines = [f"set{k}:m{k}|s".encode() for k in range(11)]
    lines += [f"t{k}:{rng.normal():.5f}|ms".encode() for k in range(11)]
    rows = np.concatenate([np.repeat(np.arange(3), 20_000),
                           np.repeat(np.arange(3, 11), 1_500)])
    rows = rng.permutation(rows).astype(np.int32)
    h = rng.integers(0, 2**63, len(rows), dtype=np.int64).astype(np.uint64)
    idx, rank = split_hashes(h * np.uint64(2) + np.uint64(1), p)
    return lines, rows, idx, rank


def _feed_sets(w, plan, parse, batch=16_384):
    lines, rows, idx, rank = plan
    for ln in lines:
        w.process_metric(parse(ln))
    w._flush_pending_sets()
    for i in range(0, len(rows), batch):
        w._device_set_step(rows[i:i + batch], idx[i:i + batch],
                           rank[i:i + batch])


@pytest.mark.parametrize("store", ["staged", "dense"])
def test_set_faults_fail_over_the_set_pool(store):
    """A transient fault in the set ops (inserts, promotion, estimates)
    moves the set pool to the CPU without tripping the breaker; the
    max-merge is applied again there and the flush equals a healthy
    one. The staged store's dense tier records the move and flags the
    flush degraded; a CPU worker's dense pool already lives on the CPU,
    so it has nothing to move or flag (tests/test_torch_cuda.py holds
    the dense pool's move on the card)."""
    p = 10
    kw = dict(hll_precision=p, set_store=store)
    jworker = _jax_worker(**kw)
    w = _port_worker(device_fault_streak=50, **kw)
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=12, op_windows={"sets": [(1, 3, "lost")]})) as inj:
        for seed in (31, 32):
            plan = _set_interval(seed, p)
            _feed_sets(jworker, plan, jdog.parse_metric)
            _feed_sets(w, plan, tdog.parse_metric)
            if seed == 31:
                assert inj.injected["lost"] == 2
            js, ts = jworker.flush(QS), w.flush(QS)
            _assert_snapshots_identical(js, ts, f"{store} interval {seed}")
            assert ts.degraded == (seed == 31 and store == "staged"), seed
            assert ts.set_estimates.size == 11
    if store == "staged":
        assert w.guard.counters()["device.fault.lost"] == 2
    assert not w.guard.quarantined


# -- the server ---------------------------------------------------------------


def _server_lines(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = i % 9
        out.append("\n".join([
            f"srv.lat:{rng.gamma(2.0, 10.0):.4f}|ms|#ep:{k % 3}",
            f"srv.req:{1 + k % 2}|c",
            f"srv.q:{rng.normal(5.0, 1.0):.4f}|g",
            f"srv.users:u{rng.integers(300)}|s"]).encode())
    return out


def test_server_flushes_through_faults_and_counts_them():
    """A port server (guard and micro-folds on by default) under extract
    faults: every flush's InterMetrics equal a healthy JAX server's, the
    guard's counters and the host fallbacks are on the Server object,
    and the flush's guard tick quarantines the tripped worker."""
    # ssf_span_uniqueness_rate 0: the flush spans' unseeded 1% draw would
    # make the three-flush comparison nondeterministic
    base = {"percentiles": PCTS, "aggregates": ["min", "max", "count"],
            "hostname": "h", "tpu_native_ingest": False,
            "ssf_span_uniqueness_rate": 0.0,
            "tpu_native_readers": False, "flush_emit_native": False,
            "device_fault_streak": 2}
    jsink, tsink = JChannel(), TChannel()
    js = JServer(jload(data=base), metric_sinks=[jsink])
    ts = build_server(tload(data=base), extra_metric_sinks=[tsink],
                      device="cpu")
    assert ts.workers[0].guard.enabled and ts.workers[0].micro_fold
    canon = lambda ms: sorted((m.name, m.value, tuple(m.tags))  # noqa: E731
                              for m in ms)
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=2, op_windows={"extract": ALWAYS})):
        for rnd in range(3):
            for d in _server_lines(rnd):
                js.process_metric_packet(d)
                ts.process_metric_packet(d)
            assert canon(js.flush(now=100 + rnd)) == \
                canon(ts.flush(now=100 + rnd)), rnd
    assert ts.host_fallbacks == 3
    assert ts.quarantined_workers == 1
    c = ts.guard_counters()
    # the first extract and its retry trip the streak of 2
    assert c["device.fault.oom"] == 2 and c["device.guard.trips"] == 1
    assert c["device.guard.quarantines"] == 1
    assert ts.workers[0]._host_live
