"""The port's DeviceWorker against the JAX package's, on the CPU.

Three intervals of the same DogStatsD lines (histograms, timers, sampled
timers, counters, gauges, service checks; series past the initial pool so
growth runs; hot rows past ``stage_depth`` so the spill fold runs) go
through ``veneur_tpu.core.worker.DeviceWorker`` and
``veneur_tpu_torch.core.worker.DeviceWorker(device="cpu")``: every
FlushSnapshot array bitwise equal (NaN positions equal), and the host
scalar state and row metadata equal. The device steps are also checked
one by one, and a JAX-built pool state is continued in both packages.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core import worker as jw
from veneur_tpu.core.flusher import device_quantiles
from veneur_tpu.core.metrics import HistogramAggregates
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.protocol import dogstatsd as tdog

AGGS = HistogramAggregates.from_names(["min", "max", "sum", "count"])
QS = device_quantiles([0.5, 0.9, 0.99], AGGS)


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    if a.dtype.kind == "f":
        assert np.array_equal(np.isnan(a), np.isnan(b)), what
        ok = ~np.isnan(a)
        a, b = a[ok], b[ok]
    assert a.tobytes() == b.tobytes(), what


def _lines(seed):
    """One interval of mixed traffic: 40 histogram/timer series (past the
    8-row initial pool), two hot series past stage depth, sampled timers,
    counters, gauges and a service check."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(400):
        k = i % 40
        v = rng.normal(50.0, 20.0)
        kind = "ms" if k % 2 else "h"
        out.append(f"lat{k}:{v:.4f}|{kind}|#svc:{k % 3}")
        if i % 3 == 0:
            out.append(f"samp{k % 5}:{rng.gamma(2.0, 3.0):.4f}|ms|@0.5")
        if i % 2 == 0:
            out.append(f"hot{i % 2}:{rng.exponential(9.0):.5f}|h")
            out.append(f"hot1:{rng.exponential(3.0):.5f}|ms|#a:b")
        out.append(f"c{k % 7}:{1 + k % 4}|c|@0.25" if k % 5 == 0
                   else f"c{k % 7}:{1 + k % 4}|c")
        out.append(f"g{k % 9}:{rng.normal():.6f}|g")
    out.append(f"_sc|check.{seed}|1|#x:y|m:interval {seed}")
    return [line.encode() for line in out]


def _feed(worker, parse, parse_sc, lines):
    for line in lines:
        m = parse_sc(line) if line.startswith(b"_sc") else parse(line)
        worker.process_metric(m)


def _kw():
    return dict(compression=100, stage_depth=8, batch_size=16,
                initial_histo_rows=8)


def _row(key, tags, scope_class):
    """Row metadata as plain values (the two packages' classes differ)."""
    return (key.name, key.type, key.joined_tags, list(tags),
            int(scope_class))


def _assert_snapshots_identical(a, b, path):
    for f in dataclasses.fields(a):
        if f.name in ("directory", "scalars"):
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, (path, f.name)
            _bitwise(va, vb, (path, f.name))
        else:
            assert va == vb, (path, f.name, va, vb)
    hj, ht = a.directory.histo.rows, b.directory.histo.rows
    assert [_row(m.key, m.tags, m.scope_class) for m in hj] == \
        [_row(m.key, m.tags, m.scope_class) for m in ht], path
    sa, sb = a.scalars, b.scalars
    for pool in ("counters", "gauges"):
        pa, pb = getattr(sa, pool), getattr(sb, pool)
        assert [_row(*m[:3]) for m in pa.meta] == \
            [_row(*m[:3]) for m in pb.meta], path
        _bitwise(pa.values[:pa.used], pb.values[:pb.used], (path, pool))
    assert sa.status_values == sb.status_values, path
    assert [_row(*m[:3]) for m in sa.status_meta] == \
        [_row(*m[:3]) for m in sb.status_meta], path


def test_three_intervals_bitwise():
    jworker = jw.DeviceWorker(**_kw())
    tworker = tw.DeviceWorker(**_kw(), device="cpu")
    for seed in (1, 2, 3):
        lines = _lines(seed)
        _feed(jworker, jdog.parse_metric, jdog.parse_service_check, lines)
        _feed(tworker, tdog.parse_metric, tdog.parse_service_check, lines)
        js, ts = jworker.flush(QS), tworker.flush(QS)
        assert js.directory.num_histo_rows == 47
        assert js.quantile_values.shape == (47, len(QS))
        _assert_snapshots_identical(js, ts, f"interval {seed}")
    assert jworker.processed_total == tworker.processed_total


def test_pools_grow_like_the_reference():
    jworker = jw.DeviceWorker(**_kw())
    tworker = tw.DeviceWorker(**_kw(), device="cpu")
    sizes = []
    for n in (1, 7, 8, 15, 16, 100):
        for w, parse in ((jworker, jdog.parse_metric),
                         (tworker, tdog.parse_metric)):
            w.process_metric(parse(f"grow{n}:1|h".encode()))
        for i in range(n):
            for w, parse in ((jworker, jdog.parse_metric),
                             (tworker, tdog.parse_metric)):
                w.process_metric(parse(f"s{i}:{i}|ms".encode()))
        sizes.append((jworker._histo.num_rows, tworker._histo.num_rows))
    assert all(a == b for a, b in sizes), sizes


def test_worker_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tw.DeviceWorker()


# -- device steps, one by one ------------------------------------------------


def _state(rows, seed):
    """A 14-field pool state after one staged fold in the JAX package."""
    rng = np.random.default_rng(seed)
    st = jw.HistoDeviceState.create(rows, 128)
    b = 16
    sv = rng.normal(10.0, 4.0, (rows, b)).astype(np.float32)
    sw = (rng.random((rows, b)) < 0.7).astype(np.float32)
    sw[sw > 0] = rng.choice([1.0, 2.0], int(sw.sum())).astype(np.float32)
    out = jw._histo_fold_staged(*st.fields(), jnp.asarray(sv),
                                jnp.asarray(sw))
    return [np.array(a) for a in out]


def _spill_args(rows, seed):
    rng = np.random.default_rng(seed)
    n = 300
    r = rng.integers(0, rows - 1, n).astype(np.int32)
    v = rng.normal(5.0, 2.0, n).astype(np.float32)
    w = rng.choice([1.0, 2.0, 4.0], n).astype(np.float32)
    return tw.DeviceWorker._pad_spill_batch(r, v, w, rows - 1)


def test_ingest_step_bitwise():
    rows = 32
    fields = _state(rows, 4)
    active, lids, v, w = _spill_args(rows, 5)
    jout = jw._histo_ingest_step(
        *(jnp.asarray(a) for a in fields), jnp.asarray(active, jnp.int32),
        jnp.asarray(lids, jnp.int32), jnp.asarray(v), jnp.asarray(w))
    tst = tw.HistoDeviceState.from_numpy(fields, "cpu")
    tout = tw._histo_ingest_step(
        *tst.fields(), torch.from_numpy(active), torch.from_numpy(lids),
        torch.from_numpy(v), torch.from_numpy(w))
    for i, (a, b) in enumerate(zip(jout, tout)):
        _bitwise(np.asarray(a), b.numpy(), f"field {i}")
    # in place: the port's step updated the state's own tensors
    assert tout[0] is tst.means


def test_fold_staged_and_extract_bitwise():
    rows = 64
    fields = _state(rows, 6)
    rng = np.random.default_rng(7)
    sv = rng.gamma(2.0, 5.0, (rows, 8)).astype(np.float32)
    sw = (rng.random((rows, 8)) < 0.5).astype(np.float32)
    jout = jw._histo_fold_staged(*(jnp.asarray(a) for a in fields),
                                 jnp.asarray(sv), jnp.asarray(sw))
    tout = tw._histo_fold_staged(
        *tw.HistoDeviceState.from_numpy(fields, "cpu").fields(),
        torch.from_numpy(sv), torch.from_numpy(sw))
    for i, (a, b) in enumerate(zip(jout, tout)):
        _bitwise(np.asarray(a), b.numpy(), f"fold field {i}")
    q = np.asarray(QS, np.float32)
    jp = jw._pack_extract_columns(*jw._histo_flush_extract(
        *jout, jnp.asarray(q)))
    tp = tw._pack_extract_columns(*tw._histo_flush_extract(
        *tout, torch.from_numpy(q)))
    _bitwise(np.asarray(jp), tp.numpy(), "packed extract")
    worker = tw.DeviceWorker(**_kw(), device="cpu")
    _bitwise(np.asarray(jp),
             worker._extract(tout, torch.from_numpy(q)).numpy(),
             "kernel wrapper (plain on the CPU)")


@pytest.mark.parametrize("unit", [False, True])
def test_expand_flat_planes_bitwise(unit):
    rng = np.random.default_rng(8)
    counts = rng.integers(0, 9, 40).astype(np.int32)
    total = int(counts.sum())
    fv = rng.normal(size=total + 5).astype(np.float32)
    fw = rng.choice([0.5, 1.0], total + 5).astype(np.float32)
    jv, jwt = jw._expand_flat_planes(jnp.asarray(fv), jnp.asarray(fw),
                                     jnp.asarray(counts), 8, unit)
    tv, twt = tw._expand_flat_planes(torch.from_numpy(fv),
                                     torch.from_numpy(fw),
                                     torch.from_numpy(counts), 8, unit)
    _bitwise(np.asarray(jv), tv.numpy(), "vals")
    _bitwise(np.asarray(jwt), twt.numpy(), "wts")


def test_grow_matches():
    fields = _state(16, 9)
    jst = jw.HistoDeviceState(*(jnp.asarray(a) for a in fields)).grow(64)
    tst = tw.HistoDeviceState.from_numpy(fields, "cpu").grow(64)
    for i, (a, b) in enumerate(zip(jst.fields(), tst.fields())):
        _bitwise(np.asarray(a), b.numpy(), f"grown field {i}")
