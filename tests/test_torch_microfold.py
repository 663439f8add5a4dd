"""The port's micro-fold against the JAX package's, on the CPU.

The contract (tests/test_microfold.py): a flush gives byte for byte the
same snapshot whether the staged epoch was folded once at the flush or
streamed to the device mirror in any number of micro-folds, because the
mirror holds exactly the dense plane the batch path uploads. Here the
port worker (``device="cpu"``) micro-folds the same numpy-seeded
intervals the JAX package's worker batch-folds and micro-folds, on the
Python and the native staging plane, and:

- a swap between (or racing) micro-folds loses and doubles nothing;
- the mirror's upload bytes are ceil(samples / MICRO_CHUNK) x
  MICRO_CHUNK x 16 however many drains ran and whatever the depth;
- a fault in a micro-fold drops the mirror (the plane folds, healthy),
  a fault in the mirror's fold replays the plane on the CPU (degraded),
  both bitwise;
- the worker is inert with micro_fold off;
- a server with the scheduler thread flushes what a JAX server with it
  flushes.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.flusher import device_quantiles
from veneur_tpu.core.metrics import HistogramAggregates, MetricType
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.flusher import generate_inter_metrics
from veneur_tpu_torch.core.server import Server as TServer
from veneur_tpu_torch.ops import microfold as mf
from veneur_tpu_torch.protocol import dogstatsd as tdog
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TChannel
from veneur_tpu_torch.utils import faults as fl

AGGS = HistogramAggregates.from_names(["min", "max", "count"])
PCTS = [0.5, 0.9, 0.99]
QS = device_quantiles(PCTS, AGGS)

INTERVALS = 3
MIN_FOLDS_PER_INTERVAL = 4


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.shape,
                                                       b.shape)
    assert a.tobytes() == b.tobytes(), what


def _assert_snapshots_identical(a, b, what, degraded=False):
    """Every array field bitwise (raw bytes: NaN payloads and signed
    zeros count), the directories' keys, the counters and gauges, and
    ``degraded`` as asked."""
    for f in dataclasses.fields(a):
        if f.name in ("directory", "scalars", "degraded"):
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, (what, f.name)
            _same(va, vb, (what, f.name))
        else:
            assert va == vb, (what, f.name, va, vb)
    assert b.degraded is degraded, what
    for pool in ("histo", "sets"):
        ka = [(r.key.name, r.key.joined_tags)
              for r in getattr(a.directory, pool).rows]
        kb = [(r.key.name, r.key.joined_tags)
              for r in getattr(b.directory, pool).rows]
        assert ka == kb, (what, pool)
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        _same(pa.values[:pa.used], pb.values[:pb.used], (what, pool))


def _lines(rng):
    out = []
    for i in range(6):
        out.append(f"h{i}:{rng.normal():.6f}|ms|#a:b")
        out.append(f"c{i}:1.5|c")
        out.append(f"g{i}:{rng.normal():.6f}|g")
        out.append(f"s{i}:{rng.integers(100)}|s")
    return out


def _drive(worker, parse, micro, native, fold_every=2,
           intervals=INTERVALS):
    """The reference test's workload (tests/test_microfold.py
    _drive_worker): t-digest timers, sets, counters, gauges for
    ``intervals`` intervals of 8 batches, micro-folding every
    ``fold_every`` batches; batch_size is small so the Python plane fills
    mid-interval, and no row passes the stage depth (no spill). Returns
    (snapshots, micro-folds per interval)."""
    rng = np.random.default_rng(7)
    snaps, folds = [], []
    for _ in range(intervals):
        for batch in range(8):
            lines = _lines(rng)
            if native:
                worker.ingest_datagram("\n".join(lines).encode())
            else:
                for ln in lines:
                    worker.process_metric(parse(ln.encode()))
            if micro and batch % fold_every == 0 and worker.micro_fold_due():
                worker.micro_fold_once()
        folds.append(worker.micro_folds_epoch)
        snaps.append(worker.flush(QS))
    return snaps, folds


def _kw(**kw):
    kw.setdefault("compression", 100)
    kw.setdefault("stage_depth", 64)
    kw.setdefault("batch_size", 6)
    # a small pool keeps each CPU op under torch's parallel grain, so the
    # test does not contend for cores with the suite's other workers
    kw.setdefault("initial_histo_rows", 8)
    kw.setdefault("micro_fold_rows", 1)
    kw.setdefault("micro_fold_max_age_s", 1e9)
    return kw


def _jax_worker(micro, native, **kw):
    w = jw.DeviceWorker(micro_fold=micro, **_kw(**kw))
    if native:
        assert w.attach_native()
    return w


def _port_worker(micro, native, **kw):
    w = tw.DeviceWorker(micro_fold=micro, device="cpu", **_kw(**kw))
    if native:
        assert w.attach_native()
    return w


@pytest.mark.parametrize("native", [False, True],
                         ids=["python-plane", "native-plane"])
def test_micro_fold_bit_identical_to_batch_fold(native):
    """The port micro-folded == the JAX package batch-folded == the JAX
    package micro-folded, interval by interval."""
    base, _ = _drive(_jax_worker(False, native), jdog.parse_metric, False,
                     native)
    jmicro, jfolds = _drive(_jax_worker(True, native), jdog.parse_metric,
                            True, native)
    w = _port_worker(True, native)
    micro, folds = _drive(w, tdog.parse_metric, True, native)
    assert folds == jfolds
    assert all(f >= MIN_FOLDS_PER_INTERVAL for f in folds), folds
    assert w.micro_folds_total == sum(folds)
    assert w.last_micro_chunks == 1
    for n, (a, b, c) in enumerate(zip(base, jmicro, micro)):
        _assert_snapshots_identical(a, c, f"batch interval {n}")
        _assert_snapshots_identical(b, c, f"micro interval {n}")


@pytest.mark.parametrize("fold_every", [1, 3, 7])
@pytest.mark.parametrize("native", [False, True],
                         ids=["python-plane", "native-plane"])
def test_swap_mid_micro_fold_no_loss_no_double(native, fold_every):
    """The swap fence: folds land at different batch offsets (one right
    before the swap with staged rows outstanding), so every swap hands
    over a partly mirrored plane. Identity holds for every partition."""
    base, _ = _drive(_jax_worker(False, native), jdog.parse_metric, False,
                     native)
    micro, folds = _drive(_port_worker(True, native), tdog.parse_metric,
                          True, native, fold_every=fold_every)
    assert all(f >= 1 for f in folds), folds
    for n, (a, b) in enumerate(zip(base, micro)):
        _assert_snapshots_identical(a, b, f"every {fold_every}, interval {n}")


def test_swap_racing_micro_folds_conserves_samples():
    """A scheduler thread micro-folds while the main thread flushes
    mid-stream: lost rows would show as a short count, double-folded
    rows as a long one."""
    w = tw.DeviceWorker(compression=100, stage_depth=256, batch_size=4,
                        micro_fold=True, micro_fold_rows=1,
                        micro_fold_max_age_s=1e9, initial_histo_rows=8,
                        device="cpu")
    lock = threading.Lock()
    stop = threading.Event()

    def scheduler():
        while not stop.is_set():
            with lock:
                if w.micro_fold_due():
                    w.micro_fold_once()
            time.sleep(0.001)

    t = threading.Thread(target=scheduler, daemon=True)
    t.start()
    total = 0
    snaps = []
    try:
        for _burst in range(6):
            for i in range(200):
                with lock:
                    w.process_metric(tdog.parse_metric(b"race.t:%d|ms" % i))
                    w.process_metric(tdog.parse_metric(b"race.c:1|c"))
                total += 1
            with lock:
                swapped = w.swap(QS)
            snaps.append(w.extract_snapshot(swapped, QS))
    finally:
        stop.set()
        t.join(timeout=5.0)
    assert not t.is_alive()
    assert w.micro_folds_total > 0
    got_histo = got_counter = 0.0
    for snap in snaps:
        by_key = {(m.name, m.type): m.value
                  for m in generate_inter_metrics(snap, True, PCTS, AGGS,
                                                  now=1000)}
        got_histo += by_key.get(("race.t.count", MetricType.COUNTER), 0.0)
        got_counter += by_key.get(("race.c", MetricType.COUNTER), 0.0)
    assert got_histo == float(total)
    assert got_counter == float(total)


# -- upload bytes -------------------------------------------------------------


def _micro_bytes(native, fold_every, depth):
    w = _port_worker(True, native, stage_depth=depth)
    rng = np.random.default_rng(3)
    for batch in range(12):
        lines = [f"h{i}:{rng.normal():.6f}|ms" for i in range(6)]
        if native:
            w.ingest_datagram("\n".join(lines).encode())
        else:
            for ln in lines:
                w.process_metric(tdog.parse_metric(ln.encode()))
        if batch % fold_every == 0 and w.micro_fold_due():
            w.micro_fold_once()
    w.flush(QS)
    return w.last_micro_bytes, w.last_micro_chunks


@pytest.mark.parametrize("native", [False, True],
                         ids=["python-plane", "native-plane"])
def test_micro_fold_bytes_partition_invariant(native):
    """N micro-folds of one staged stream upload exactly the bytes of one
    drain at the swap: fixed padded chunks, the remainder carried on the
    host across drains."""
    ref = _micro_bytes(native, 12, 64)  # one drain, at the swap
    assert ref == (16 * mf.MICRO_CHUNK, 1)
    for fold_every in (1, 3):
        assert _micro_bytes(native, fold_every, 64) == ref, fold_every
    # O(samples), not O(folds x depth): 72 samples, one padded chunk
    for depth in (16, 128):
        assert _micro_bytes(native, 1, depth) == ref, depth


def test_mirror_bytes_follow_the_sample_count():
    """ceil(samples / chunk) x chunk x 16, whatever the drains."""
    rng = np.random.default_rng(5)
    for samples, drains in ((1, 1), (8, 3), (9, 2), (24, 5), (25, 25)):
        m = mf.MicroFoldMirror(4, "cpu", initial_rows=2, chunk=8)
        rows = rng.integers(0, 40, samples).astype(np.int32)
        slots = np.arange(samples, dtype=np.int32) % 4
        vals = rng.normal(size=samples).astype(np.float32)
        cuts = np.linspace(0, samples, drains + 1).astype(int)
        for a, b in zip(cuts[:-1], cuts[1:]):
            m.feed(rows[a:b], slots[a:b], vals[a:b], vals[a:b])
        st = m.finish()
        chunks = -(-samples // 8)
        assert (st.chunks, st.nbytes) == (chunks, chunks * 8 * 16)
        assert st.samples == samples


def test_mirror_holds_the_dense_plane():
    """The finished mirror is the dense plane of its COO entries (zeros
    elsewhere), through growth and the padded final chunk; the padding
    lands on the spare row and never in a view; mirror_dense slices and
    zero-pads."""
    rng = np.random.default_rng(9)
    depth, n = 8, 100
    rows = rng.permutation(np.repeat(np.arange(50), 2))[:n].astype(np.int32)
    slots = np.zeros(n, np.int32)
    seen: dict = {}
    for i, r in enumerate(rows):
        slots[i] = seen.get(r, 0)
        seen[r] = slots[i] + 1
    vals = rng.normal(size=n).astype(np.float32)
    wts = rng.uniform(0.5, 2.0, n).astype(np.float32)
    dense_v = np.zeros((64, depth), np.float32)
    dense_w = np.zeros((64, depth), np.float32)
    dense_v[rows, slots] = vals
    dense_w[rows, slots] = wts
    m = mf.MicroFoldMirror(depth, "cpu", initial_rows=4, chunk=16)
    for a in range(0, n, 7):
        m.feed(rows[a:a + 7], slots[a:a + 7], vals[a:a + 7], wts[a:a + 7])
    st = m.finish()
    assert st.vals.shape == (64, depth) and st.rows_hi == int(rows.max()) + 1
    _same(st.vals.numpy(), dense_v, "values")
    _same(st.wts.numpy(), dense_w, "weights")
    _same(mf.mirror_dense(st.vals, 32).numpy(), dense_v[:32], "slice")
    padded = mf.mirror_dense(st.wts, 128).numpy()
    _same(padded[:64], dense_w, "pad head")
    assert not padded[64:].any()
    assert m.finish() is None  # reset: nothing staged


def test_worker_micro_fold_inert_when_disabled():
    w = tw.DeviceWorker(stage_depth=64, micro_fold=False, device="cpu")
    w.process_metric(tdog.parse_metric(b"off.t:1|ms"))
    assert not w.micro_fold_due()
    assert w.micro_fold_pending() == 0
    assert w.micro_fold_once() == 0
    assert w.micro_folds_total == 0 and w._micro is None
    snap = w.flush(QS)
    assert w.last_micro_chunks == 0 and not snap.degraded


# -- faults -------------------------------------------------------------------


@pytest.mark.parametrize("native", [False, True],
                         ids=["python-plane", "native-plane"])
def test_micro_fold_fault_drops_the_mirror(native):
    """A fault in a micro-fold's scatter drops the mirror for the epoch:
    the staging plane kept every sample, so the flush folds it on the
    device path, healthy and bitwise; the next epoch micro-folds again."""
    base, _ = _drive(_jax_worker(False, native), jdog.parse_metric, False,
                     native, intervals=2)
    # one chunk of 6 entries a drain: the first interval's 2nd scatter
    w = _port_worker(True, native)
    w._new_mirror = lambda: mf.MicroFoldMirror(  # small chunks
        w.stage_depth, w.device, initial_rows=8, chunk=6, guard=w.guard)
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=1, op_windows={"micro": [(1, 2, "lost")]})) as inj:
        snaps, folds = _drive(w, tdog.parse_metric, True, native,
                              intervals=2)
    assert inj.injected["lost"] == 1
    assert folds[0] >= 1 and folds[1] >= MIN_FOLDS_PER_INTERVAL
    for n, (a, b) in enumerate(zip(base, snaps)):
        _assert_snapshots_identical(a, b, f"interval {n}")
    assert w.last_micro_chunks > 0  # the second epoch used a mirror
    assert not w.guard.quarantined


@pytest.mark.parametrize("op", ["staged", "micro"])
@pytest.mark.parametrize("native", [False, True],
                         ids=["python-plane", "native-plane"])
def test_mirror_fold_fault_replays_the_plane(native, op):
    """A fault at the flush, in the residual feed ("micro") or in the
    mirror's fold ("staged"): the mirror is lost with the device state,
    the plane swap kept folds on the CPU, bitwise, flagged degraded."""
    base, _ = _drive(_jax_worker(False, native), jdog.parse_metric, False,
                     native, intervals=1)
    w = _port_worker(True, native, device_fault_streak=10)
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=2, op_windows={op: [(0, 1, "lost")]})) as inj:
        snaps, folds = _drive(w, tdog.parse_metric, True, native,
                              intervals=1)
    assert inj.injected["lost"] == 1 and folds[0] >= 1
    _assert_snapshots_identical(base[0], snaps[0], op, degraded=True)
    assert w.host_fallback_flushes == 1


# -- the server ---------------------------------------------------------------


def test_server_flush_parity_with_scheduler():
    """Both servers run their micro-fold scheduler threads (the default
    config, micro_fold on); identical ingest into each flushes equal
    metrics, whenever the schedulers happened to drain."""
    base = dict(statsd_listen_addresses=["udp://127.0.0.1:0"],
                num_workers=1, num_readers=1, interval="10s",
                percentiles=PCTS, micro_fold_rows=1,
                micro_fold_max_age_s=0.02, flush_emit_native=False)
    jsink, tsink = JChannel(), TChannel()
    js = JServer(jload(data=dict(base)), metric_sinks=[jsink])
    ts = TServer(tload(data=dict(base)), metric_sinks=[tsink], device="cpu")
    servers = (js, ts)
    for srv in servers:
        srv.start()
        # small pending batches so the Python plane fills and micro-folds
        # engage at test-sized sample counts
        for w in srv.workers:
            w.batch_size = 8
    try:
        assert ts.config.micro_fold and ts.workers[0].micro_fold
        rng = np.random.default_rng(11)
        lines = []
        for i in range(40):
            lines.append(f"sv.h{i % 5}:{rng.normal():.6f}|ms")
            lines.append(f"sv.c{i % 5}:2|c")
            lines.append(f"sv.s{i % 5}:{rng.integers(50)}|s")
        for srv, parse in ((js, jdog.parse_metric), (ts, tdog.parse_metric)):
            w = srv.workers[0]
            for ln in lines:
                with srv._worker_locks[0]:
                    if w._native is not None:
                        w.ingest_datagram(ln.encode())
                    else:
                        w.process_metric(parse(ln.encode()))
        for srv in servers:
            deadline = time.time() + 10.0
            while (time.time() < deadline
                   and srv.workers[0].micro_folds_epoch == 0):
                time.sleep(0.01)
            assert srv.workers[0].micro_folds_epoch > 0
        got = []
        for srv in servers:
            got.append({(m.name, m.type.name, tuple(m.tags)): m.value
                        for m in srv.flush(now=1000)
                        if m.type is not MetricType.STATUS
                        and m.type.name != "STATUS"})
        assert got[0] == got[1]
        assert ts.host_fallbacks == 0 and ts.guard_counters() == {}
    finally:
        for srv in servers:
            srv.shutdown()
