"""f32 denormals in the fold scalars: the port against the JAX package.

XLA on the CPU runs with denormals-are-zero and flush-to-zero: an
arithmetic op, a comparison, a min or a max reads a denormal as the zero
of its sign and writes a denormal result as that zero, while a copy, a
gather or a select passes the bits. The port's plain folds do the same
through ``exactnum.flush_denormals`` (and csrc/tdigest.cu is built with
``-ftz=true``). Held here bitwise, over all 14 pool fields:

* the staged fold (``_histo_fold_staged``) at staging depths 1, 8, 33 and
  64, on rows of denormal samples, of denormal weights (not live: XLA
  reads ``w > 0`` as false), of samples whose ``w / v`` or ``v * w`` is
  denormal, of samples whose sums cancel to a denormal, and of those
  mixed with normal samples, into pool scalars that are denormal too;
* the spill fold (``_histo_ingest_step``): the sampler-local min and max
  scattered from the raw batch values, on denormal samples;
* a server interval with ``h:1e-40|h`` and ``h:-1e-40|h`` over the Python
  and the native ingest: the snapshot's fields and the InterMetrics equal
  the JAX server's.
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.sinks.channel import ChannelMetricSink as JChannel
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TChannel

C = 128
DEPTHS = [1, 8, 33, 64]
TINY = np.finfo(np.float32).tiny
NOW = 1_700_000_000
FIELDS = ("means", "weights", "dmin", "dmax", "drecip", "drecip_c", "lmin",
          "lmax", "lsum", "lsum_c", "lweight", "lweight_c", "lrecip",
          "lrecip_c")


def _bits(a) -> np.ndarray:
    """f32 bits, a NaN as the quiet NaN of its sign."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32)
    return np.where(np.isnan(a), (u & np.uint32(0x80000000))
                    | np.uint32(0x7FC00000), u)


def _same(a, b, what=""):
    ba, bb = _bits(a), _bits(b)
    assert ba.shape == bb.shape, (what, ba.shape, bb.shape)
    bad = np.argwhere(ba != bb)
    assert not len(bad), (what, bad[:5].tolist(),
                          hex(int(ba[tuple(bad[0])])),
                          hex(int(bb[tuple(bad[0])])))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _denormals(rng, n: int) -> np.ndarray:
    """n f32 denormals of both signs."""
    mag = rng.integers(1, 2 ** 23, n).astype(np.float32) * np.float32(1e-45)
    return (mag * rng.choice(np.array([-1.0, 1.0], np.float32), n)).astype(
        np.float32)


def staged_plane(rng, s: int, b: int):
    """[s, b] staged values and weights, a kind of row a row (i % 8):
    0 denormal samples; 1 denormal weights; 2 samples of 1e38 (w / v
    denormal); 3 products v * w denormal; 4 a mix of denormal and normal
    samples; 5 normal samples; 6 samples that cancel (their sum and
    compensations meet denormals); 7 denormal weights beside normal ones.
    A fifth of the slots empty (weight 0)."""
    v = rng.normal(0.0, 10.0, (s, b)).astype(np.float32)
    w = rng.choice(np.array([1.0, 2.0, 0.5], np.float32), (s, b))
    kind = np.arange(s) % 8
    v[kind == 0] = _denormals(rng, int((kind == 0).sum()) * b).reshape(-1, b)
    w[kind == 1] = np.abs(_denormals(rng, int((kind == 1).sum()) * b)
                          ).reshape(-1, b)
    v[kind == 2] = rng.choice(np.array([1e38, -1e38, 3e38], np.float32),
                              (int((kind == 2).sum()), b))
    v[kind == 3] = rng.choice(np.array([1e-20, -3e-20], np.float32),
                              (int((kind == 3).sum()), b))
    w[kind == 3] = np.float32(1e-19)
    mix = kind == 4
    half = rng.random((int(mix.sum()), b)) < 0.5
    v[mix] = np.where(half, _denormals(rng, int(mix.sum()) * b).reshape(
        -1, b), v[mix])
    cancel = kind == 6
    v[cancel] = np.where(np.arange(b) % 2 == 0, np.float32(1.5e-38),
                         np.float32(-1.4e-38))
    w7 = kind == 7
    w[w7] = np.where(np.arange(b) % 3 == 0, np.abs(_denormals(
        rng, int(w7.sum()) * b).reshape(-1, b)), w[w7])
    w[rng.random((s, b)) < 0.2] = 0.0
    return v.astype(np.float32), w.astype(np.float32)


def pool_fields(rng, s: int) -> list:
    """The worker's 14 pool fields over s rows: a few centroids a row,
    the sums and compensations a third of them denormal. The digest and
    sampler-local min and max are never denormal in a pool (every fold
    writes them flushed); XLA passes such a one through a row with no
    live sample at depth 1 alone, so they are +-0.0 there instead."""
    means = np.full((s, C), np.inf, np.float32)
    w = np.zeros((s, C), np.float32)
    means[:, :3] = np.sort(rng.normal(0.0, 1.0, (s, 3)), axis=1)
    w[:, :3] = 1.0

    def scalar(base, denormal=True):
        x = np.full(s, base, np.float32)
        den = rng.random(s) < 1 / 3
        x[den] = _denormals(rng, int(den.sum()))
        if not denormal:
            x[den] = np.where(x[den] < 0, np.float32(-0.0), np.float32(0.0))
        return x

    # dmin, dmax, drecip(_c), lmin, lmax, lsum(_c), lweight(_c), lrecip(_c)
    return [means, w, scalar(-1.0, False), scalar(1.0, False),
            scalar(1e-38), scalar(-1.2e-38), scalar(np.inf, False),
            scalar(-np.inf, False), scalar(1.3e-38), scalar(0.0),
            scalar(1.0), scalar(0.0), scalar(-1.3e-38), scalar(1e-39)]


@pytest.mark.parametrize("b", DEPTHS)
def test_staged_fold_denormals_bitwise_reference(b):
    rng = np.random.default_rng(700 + b)
    s = 64
    fields = pool_fields(rng, s)
    svals, swts = staged_plane(rng, s, b)
    jo = jw._histo_fold_staged(*(jnp.asarray(a) for a in fields),
                               jnp.asarray(svals), jnp.asarray(swts))
    to = tw._histo_fold_staged(*(_t(a) for a in fields), _t(svals),
                               _t(swts))
    for name, a, got in zip(FIELDS, jo, to):
        _same(a, got, f"depth {b} {name}")


def test_staged_fold_denormal_weight_is_not_live():
    """A row whose only live-looking weight is denormal folds nothing:
    its digest min, max and sampler-local weight stay as they were."""
    s, b = 2, 8
    fields = [np.full((s, C), np.inf, np.float32),
              np.zeros((s, C), np.float32),
              np.full(s, np.inf, np.float32), np.full(s, -np.inf, np.float32)
              ] + [np.zeros(s, np.float32)] * 2 + [
        np.full(s, np.inf, np.float32), np.full(s, -np.inf, np.float32)
    ] + [np.zeros(s, np.float32)] * 6
    svals = np.full((s, b), 5.0, np.float32)
    swts = np.zeros((s, b), np.float32)
    swts[:, 0] = np.float32(4e-39)
    to = tw._histo_fold_staged(*(_t(a) for a in fields), _t(svals),
                               _t(swts))
    jo = jw._histo_fold_staged(*(jnp.asarray(a) for a in fields),
                               jnp.asarray(svals), jnp.asarray(swts))
    for name, a, got in zip(FIELDS, jo, to):
        _same(a, got, name)
    assert np.all(to[2].numpy() == np.inf) and np.all(to[10].numpy() == 0)


@pytest.mark.parametrize("w", [1, 9, 33, 64])
def test_spill_fold_denormals_bitwise_reference(w):
    """The spill fold's sampler-local min and max are scattered from the
    batch's raw values: a denormal one reads as zero in XLA's scatter;
    and its compensated sums meet denormal pool scalars."""
    rng = np.random.default_rng(800 + w)
    s = w + 1
    fields = pool_fields(rng, s)
    active = np.concatenate([np.arange(w), [w, w]]).astype(np.int32)
    n = 4 * w
    lids = rng.integers(0, w, n).astype(np.int32)
    vals = _denormals(rng, n)
    vals[rng.random(n) < 0.25] = np.float32(2.5)
    wts = np.ones(n, np.float32)
    wts[rng.random(n) < 0.2] = 0.0
    jo = jw._histo_ingest_step(*(jnp.asarray(a) for a in fields),
                               jnp.asarray(active), jnp.asarray(lids),
                               jnp.asarray(vals), jnp.asarray(wts))
    tf = [_t(a) for a in fields]
    tw._histo_ingest_step(*tf, _t(active).long(), _t(lids), _t(vals),
                          _t(wts))
    for name, a, got in zip(FIELDS, jo, tf):
        _same(a, got, f"width {w} {name}")


# ---------------------------------------------------------------------------
# a server interval

BASE = {
    "ssf_span_uniqueness_rate": 0.0,
    "percentiles": [0.0, 0.5, 1.0],
    "aggregates": ["min", "max", "count", "sum", "avg", "hmean"],
    "interval": "10s",
    "hostname": "denormal-host",
    "tpu_native_readers": False,
    "flush_emit_native": False,
    "micro_fold": False,
    "tpu_stage_depth": 8,
    "tpu_batch_size": 16,
    "tpu_initial_histo_rows": 16,
}
SNAP_FIELDS = ("quantile_values", "dmin", "dmax", "dsum", "dcount", "drecip",
               "lmin", "lmax", "lsum", "lweight", "lrecip", "digest_means",
               "digest_weights")


def _denormal_datagrams() -> list[bytes]:
    """h: +-1e-40 staged; t: a timer of denormals past the staging depth
    (spill folds); m: denormals beside normal samples; r: a sampled
    timer whose weight meets 1e-40."""
    out = [b"h:1e-40|h\nh:-1e-40|h", b"h2:-1e-40|h\nh2:1e-40|h"]
    for i in range(24):
        out.append(f"t:{'-' if i % 3 == 0 else ''}2e-40|ms".encode())
    out.append(b"m:1e-40|ms\nm:1.5|ms\nm:-3e-41|ms\nm:-2|ms")
    out.append(b"r:1e-40|ms|@0.5\nr:7|ms|@0.5")
    return out


def _canonical(metrics) -> list[tuple]:
    return sorted((m.name, m.timestamp, struct.pack("<d", float(m.value)),
                   tuple(m.tags), m.type.name) for m in metrics)


def _drain(q):
    out = []
    while not q.empty():
        out.extend(q.get_nowait())
    return out


def _capture_snapshots(monkeypatch, cls) -> list:
    snaps = []
    real = cls.extract_snapshot

    def spy(self, *args, **kwargs):
        snap = real(self, *args, **kwargs)
        snaps.append(snap)
        return snap

    monkeypatch.setattr(cls, "extract_snapshot", spy)
    return snaps


def _histo_rows(snap) -> dict:
    """name -> histogram row of the snapshot."""
    return {key.name: row
            for (key, _), row in snap.directory.histo.index.items()}


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_server_interval_denormals_equal_jax_server(monkeypatch, native):
    extra = {"tpu_native_ingest": native}
    jsnaps = _capture_snapshots(monkeypatch, jw.DeviceWorker)
    tsnaps = _capture_snapshots(monkeypatch, tw.DeviceWorker)
    jsink, tsink = JChannel(), TChannel()
    js = JServer(jload(data={**BASE, **extra}), metric_sinks=[jsink])
    ts = build_server(tload(data={**BASE, **extra}),
                      extra_metric_sinks=[tsink], device="cpu")
    try:
        for d in _denormal_datagrams():
            js.process_metric_packet(d)
            ts.process_metric_packet(d)
        js.flush(now=NOW)
        ts.flush(now=NOW)
        jm, tm = _drain(jsink.queue), _drain(tsink.queue)
        assert _canonical(jm) == _canonical(tm)
        got = {m.name: m.value for m in tm}
        assert got["h.min"] == 0.0 and np.signbit(got["h.min"])
        assert got["h.max"] == 0.0 and not np.signbit(got["h.max"])
        assert len(jsnaps) == len(tsnaps) == 1
        js_, ts_ = jsnaps[0], tsnaps[0]
        jrows, trows = _histo_rows(js_), _histo_rows(ts_)
        assert sorted(jrows) == sorted(trows)
        held = [f for f in SNAP_FIELDS if getattr(js_, f) is not None]
        assert held == [f for f in SNAP_FIELDS
                        if getattr(ts_, f) is not None]
        assert {"dmin", "dmax", "lmin", "lmax", "lsum"} <= set(held)
        for name in sorted(jrows):
            for f in held:
                _same(np.asarray(getattr(js_, f))[jrows[name]],
                      np.asarray(getattr(ts_, f))[trows[name]],
                      f"{name} {f}")
    finally:
        js.shutdown()
        ts.shutdown()
