"""The PyTorch port on the card: the flush extract kernel (the variant
flush_extract launches, and every built variant) against its plain
version, bitwise, at row counts around the kernel's chunk and block
round, up to 1,000,003 rows, P = 1, 3 and 16, a row-offset view and the
edge rows of tools/port_probe_extract.edge_pool (denormal rows
included); the HLL kernels against their plain versions, bytewise and in
f32 bits, at p = 4, 8, 14 and 18 (tools/port_probe_hll cases: duplicate
slots, padding, dropped rows, every estimator regime, int8 values outside
the rank range, row counts around each block round; for the insert
negative rows, duplicate words within a warp, odd negative registers, n
not a multiple of 32, n = 1,048,576 and the host inserter's pinned
uploads); the CUDA worker, with and without sets, against its CPU twin;
the native ingest path on the card against the CPU; the micro-fold
mirror on the card, and micro-folded intervals against batch-folded ones
on the card and the CPU; and the device guard under real faults
(tools/port_guard_faults.py): an allocator OOM through the HBM valve,
a device-side assert in a child process, an OOM among a spill fold's
writes, and a set fault that moves the dense set pool alone.

Every test here is marked ``cuda`` and skips without a card. On a card
machine (no JAX needed) run them with

    VENEUR_TPU_TEST_REAL=1 python -m pytest tests/test_torch_cuda.py -m cuda

(VENEUR_TPU_TEST_REAL keeps tests/conftest.py from importing JAX).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.ops import extract_kernel as ek
from veneur_tpu_torch.ops import hll, hll_kernel
from veneur_tpu_torch.protocol.dogstatsd import parse_metric

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import port_guard_faults as guard_faults  # noqa: E402
import port_probe_extract as probe  # noqa: E402
import port_probe_hll as probe_hll  # noqa: E402

pytestmark = pytest.mark.cuda

C = 128


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the flush extract kernel is "
                    "CUDA C++ and has no CPU mode")
    return torch.device("cuda")


def _bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.shape != b.shape or not torch.equal(torch.isnan(a), torch.isnan(b)):
        return False
    ok = ~torch.isnan(a)
    return torch.equal(a[ok].view(torch.int32), b[ok].view(torch.int32))


def _pool(s: int, seed: int) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, C + 1, s)
    occ[:3] = [0, 1, C][:s]
    means = np.cumsum(rng.random((s, C), dtype=np.float32), axis=1,
                      dtype=np.float32) + np.float32(10.0)
    weights = rng.integers(1, 9, (s, C)).astype(np.float32)
    empty = np.arange(C)[None, :] >= occ[:, None]
    means[empty], weights[empty] = np.inf, 0.0
    has = occ > 0
    dmin = np.where(has, means[:, 0], np.inf).astype(np.float32)
    dmax = np.where(has, means[np.arange(s), np.maximum(occ - 1, 0)],
                    -np.inf).astype(np.float32)
    extra = [rng.normal(size=s).astype(np.float32) for _ in range(10)]
    return [torch.from_numpy(a) for a in [means, weights, dmin, dmax] + extra]


BIG = 1_000_003
_QS = {1: [1.0], 3: [0.5, 0.9, 0.99], 16: list(np.linspace(0.0, 1.0, 16))}


def _qs(p: int, dev) -> torch.Tensor:
    return torch.tensor(_QS[p], dtype=torch.float32, device=dev)


@pytest.fixture(scope="module")
def big(card):
    """A BIG-row pool on the card, and the plain version's output on its
    leading rows, cached by (rows, P)."""
    return [f.to(card) for f in _pool(BIG, 5)], {}


def _plain(big, s: int, p: int) -> torch.Tensor:
    fields, cache = big
    if (s, p) not in cache:
        cache[(s, p)] = ek.flush_extract_plain(
            *(f[:s] for f in fields), _qs(p, fields[0].device))
    return cache[(s, p)]


def _edges(r: int) -> list[int]:
    """Row counts around variant r's chunk (r rows) and block round."""
    return sorted({n for t in (r, 4 * r) for n in (t - 1, t, t + 1)
                   if n > 0} | {1})


@pytest.mark.parametrize("s", _edges(ek.ROWS_PER_WARP)
                         + [4099, 65536, 131_072, BIG])
@pytest.mark.parametrize("p", [1, 3, 16])
def test_kernel_bitwise_equals_plain(big, s, p):
    fields = [f[:s] for f in big[0]]
    before = ek.flush_extract.launches
    got = ek.flush_extract(*fields, _qs(p, fields[0].device))
    torch.cuda.synchronize()
    assert ek.flush_extract.launches == before + 1
    assert _bitwise(got, _plain(big, s, p))


@pytest.mark.parametrize("r", ek.VARIANTS)
@pytest.mark.parametrize("p", [1, 3, 16])
def test_every_variant_bitwise_equals_plain(big, r, p):
    for s in _edges(r) + [4099, BIG]:
        fields = [f[:s] for f in big[0]]
        got = ek._flush_extract_variant(r, *fields,
                                        _qs(p, fields[0].device))
        torch.cuda.synchronize()
        assert _bitwise(got, _plain(big, s, p)), (r, s, p)


@pytest.mark.parametrize("r", ek.VARIANTS)
def test_row_offset_view(card, r):
    fields = [f.to(card) for f in _pool(4099, 17)]
    view = [f[1:] for f in fields]
    assert view[2].data_ptr() % 16  # the scalars start off the 16 B grid
    qs = _qs(3, card)
    got = ek._flush_extract_variant(r, *view, qs)
    torch.cuda.synchronize()
    assert _bitwise(got, ek.flush_extract_plain(*view, qs))
    assert _bitwise(got, ek.flush_extract_plain(*fields, qs)[1:])


@pytest.mark.parametrize("r", ek.VARIANTS)
@pytest.mark.parametrize("p", [1, 3, 16])
def test_edge_rows(card, r, p):
    """Occupancy 0, 1, 127 and 128, equal means, denormal and huge
    weights, scans that are not monotone (tools/port_probe_extract)."""
    fields = [torch.from_numpy(a).to(card)
              for a in probe.edge_pool(4099, seed=13)]
    qs = _qs(p, card)
    for sub in (fields, [f[1:] for f in fields]):
        got = ek._flush_extract_variant(r, *sub, qs)
        torch.cuda.synchronize()
        assert _bitwise(got, ek.flush_extract_plain(*sub, qs)), (r, p)


def test_kernel_refuses_what_it_cannot_take(card):
    fields = [f.to(card) for f in _pool(8, 1)]
    with pytest.raises(ValueError):
        ek.flush_extract(*fields, torch.zeros(17, device=card))
    wide = [torch.zeros((8, 256), device=card)] * 2 + fields[2:]
    with pytest.raises(ValueError):
        ek.flush_extract(*wide, torch.tensor([0.5], device=card))


def _lines(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3000):
        k = i % 300
        out.append(f"t{k}:{rng.gamma(2.0, 9.0):.4f}|ms|#k:{k % 7}".encode())
        if i % 4 == 0:
            out.append(f"hot:{rng.normal(3.0, 1.0):.5f}|h|@0.5".encode())
        out.append(f"c{k % 11}:{k % 4 + 1}|c".encode())
        out.append(f"g{k % 13}:{rng.normal():.5f}|g".encode())
    return out


def test_worker_cuda_equals_cpu(card):
    kw = dict(stage_depth=16, batch_size=512, initial_histo_rows=64)
    gpu = tw.DeviceWorker(**kw, device=card)
    cpu = tw.DeviceWorker(**kw, device="cpu")
    qs = np.array([0.5, 0.9, 0.99])
    for w in (gpu, cpu):
        for line in _lines(3):
            w.process_metric(parse_metric(line))
    before = ek.flush_extract.launches
    a, b = gpu.flush(qs), cpu.flush(qs)
    assert ek.flush_extract.launches == before + 1
    for name in ("quantile_values", "dmin", "dmax", "dsum", "dcount",
                 "drecip", "lmin", "lmax", "lsum", "lweight", "lrecip",
                 "digest_means", "digest_weights"):
        assert _bitwise(torch.from_numpy(np.ascontiguousarray(
            getattr(a, name))), torch.from_numpy(np.ascontiguousarray(
                getattr(b, name)))), name


# -- the HLL kernels -----------------------------------------------------------


@pytest.mark.parametrize("p", [4, 8, 14, 18])
@pytest.mark.parametrize("n", [1, 31, 16_384, 16_385, 200_000, 1_048_576])
def test_hll_insert_bytewise_equals_plain(card, p, n):
    """Duplicate words within a warp (a quarter of the updates on 64 rows
    and 8 registers), rank-0 padding, negative rows (wrapped once or
    dropped), rows past the pool, n not a multiple of 32, and n past the
    threads the card holds at once (blocks queued behind others)."""
    s = 1_024 if p == 14 else 257
    start = probe_hll.regime_pool(s, p, p, card)
    rows, idx, rank = probe_hll.updates(s, p, n, p + n, card)
    a, b = start.clone(), start.clone()
    before = hll.insert_batch.launches
    assert hll.insert_batch(a, rows, idx, rank) is a
    torch.cuda.synchronize()
    assert hll.insert_batch.launches == before + 1
    hll.insert_batch_plain(b, rows, idx, rank)
    assert torch.equal(a, b)


def test_hll_insert_negative_rows(card):
    """Flat slots in [-S·m, -1] wrap once to slot + S·m (the reference's
    jnp indexing); below -S·m they drop."""
    s, p = 6, 8
    m = 1 << p
    pool = torch.zeros((s, m), dtype=torch.int8, device=card)
    rows = torch.tensor([-1, -s, -s - 1, -3, 2], dtype=torch.int32,
                        device=card)
    idx = torch.tensor([5, 3, 9, m - 1, 7], dtype=torch.int32, device=card)
    rank = torch.tensor([9, 4, 7, 11, 3], dtype=torch.int8, device=card)
    a = hll.insert_batch(pool.clone(), rows, idx, rank)
    b = hll.insert_batch_plain(pool.clone(), rows, idx, rank)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert int(a[s - 1, 5]) == 9 and int(a[0, 3]) == 4
    assert int(a[s - 3, m - 1]) == 11 and int(a.sum()) == 9 + 4 + 11 + 3


def test_hll_insert_duplicate_words_in_a_warp(card):
    """Every lane of every warp on the same few words, with ranks in any
    order and negative ones, and words whose four bytes are all updated:
    the aggregated byte max equals the plain version's."""
    g = torch.Generator(device=card).manual_seed(5)
    s, p, n = 4, 4, 32 * 1000
    rows = torch.randint(0, s, (n,), generator=g, device=card)
    idx = torch.randint(0, 8, (n,), generator=g, device=card)
    rank = torch.randint(-128, 128, (n,), generator=g, device=card)
    pool = torch.full((s, 1 << p), -128, dtype=torch.int8, device=card)
    args = (rows.to(torch.int32), idx.to(torch.int32), rank.to(torch.int8))
    a = hll.insert_batch(pool.clone(), *args)
    b = hll.insert_batch_plain(pool.clone(), *args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("p", [4, 14])
def test_hll_insert_odd_negative_registers(card, p):
    """Registers an import may leave negative: any update lifts them
    (signed max, identity -128), rank 0 included."""
    s = 300
    start = probe_hll.odd_registers(probe_hll.regime_pool(s, p, 3, card), 4)
    assert bool((start < 0).any())
    rows, idx, rank = probe_hll.updates(s, p, 50_000, 6, card)
    a, b = start.clone(), start.clone()
    hll.insert_batch(a, rows, idx, rank)
    hll.insert_batch_plain(b, rows, idx, rank)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_hll_host_inserter_on_the_card(card):
    """The worker's path: host batches through the pinned buffers, one
    copy and one launch each, back to back so the two buffers alternate;
    equal to the plain version on the CPU."""
    s, p = 1_024, 14
    start = probe_hll.regime_pool(s, p, 8, card)
    a, b = start.clone(), start.clone().cpu()
    ins = hll.HostInserter()
    before = hll.insert_batch.launches
    for k in range(6):
        rows, idx, rank = (t.cpu().numpy() for t in probe_hll.updates(
            s, p, 16_384 + 7 * k, 40 + k, card))
        ins.insert(a, rows, idx, rank)
        hll.insert_batch_plain(b, torch.from_numpy(rows),
                               torch.from_numpy(idx), torch.from_numpy(rank))
    torch.cuda.synchronize()
    assert hll.insert_batch.launches == before + 6
    assert torch.equal(a.cpu(), b)


def _block_rows(p: int) -> int:
    return 256 // min(256, (1 << p) // 16)


@pytest.mark.parametrize("p", [4, 8, 10, 14, 18])
def test_hll_estimate_bits_equal_plain(card, p):
    r = _block_rows(p)
    for s in sorted({1, r - 1, r, r + 1, 2 * r + 1, 607} - {0}):
        regs = probe_hll.regime_pool(s, p, s + p, card)
        before = hll.estimate.launches
        got = hll.estimate(regs, p)
        torch.cuda.synchronize()
        assert hll.estimate.launches == before + 1
        assert _bitwise(got, hll.estimate_plain(regs, p)), (p, s)


@pytest.mark.parametrize("p", [4, 14])
def test_hll_estimate_odd_register_values(card, p):
    """int8 values outside [0, 64]: the kernel's byte table wraps and
    clamps them as the reference's gather does, like the plain version."""
    g = torch.Generator(device=card).manual_seed(p)
    regs = torch.randint(-128, 128, (40, 1 << p), generator=g,
                         device=card).to(torch.int8)
    assert _bitwise(hll.estimate(regs, p), hll.estimate_plain(regs, p))


def test_hll_kernels_refuse_what_they_cannot_take(card):
    pool = hll.init_pool(8, 8, device=card)
    recs = torch.zeros((3, 2), dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        hll_kernel.insert(pool, recs.to(torch.int64))
    with pytest.raises(ValueError):
        hll_kernel.insert(pool, recs.t())
    with pytest.raises(ValueError):
        hll_kernel.insert(pool, recs.cpu())
    with pytest.raises(TypeError):
        hll_kernel.estimate(pool.to(torch.int16), 8)
    with pytest.raises(ValueError):
        hll_kernel.estimate(pool, 9)
    with pytest.raises(ValueError):
        hll_kernel.estimate(torch.zeros((8, 24), dtype=torch.int8,
                                        device=card), 8)
    with pytest.raises(ValueError):
        hll_kernel.estimate(pool.t(), 8)


def _set_lines(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        for _ in range(3000 if i < 2 else int(rng.integers(1, 40))):
            out.append(f"u{i}:m{int(rng.integers(0, 1 << 30))}|s"
                       f"{'|#veneurlocalonly' if i % 3 == 0 else ''}"
                       .encode())
    out += [f"lat:{rng.normal(5, 1):.4f}|ms".encode() for _ in range(50)]
    return out


@pytest.mark.parametrize("store", ["staged", "dense"])
def test_worker_sets_cuda_equals_cpu(card, store):
    kw = dict(batch_size=1024, set_store=store, count_unique_timeseries=True,
              initial_set_rows=16)
    gpu = tw.DeviceWorker(**kw, device=card)
    cpu = tw.DeviceWorker(**kw, device="cpu")
    if store == "staged":
        for w in (gpu, cpu):  # promote during the interval
            w._staged_sets.compact_every = 2048
    k0, e0 = hll.insert_batch.launches, hll.estimate.launches
    for w in (gpu, cpu):
        for line in _set_lines(4):
            w.process_metric(parse_metric(line))
    a, b = gpu.flush(np.array([0.5])), cpu.flush(np.array([0.5]))
    assert hll.insert_batch.launches > k0
    assert hll.estimate.launches == e0 + 1
    for name in ("set_estimates", "set_registers",
                 "unique_timeseries_registers", "quantile_values"):
        va, vb = getattr(a, name), getattr(b, name)
        assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes(), name


@pytest.mark.parametrize("store", ["staged", "dense"])
def test_native_worker_cuda_equals_cpu(card, store):
    """The native C++ ingest path on the card: datagrams through workers
    with attach_native() (hot rows spilling past a staging depth of 16 and
    drained mid-interval; the flush uploads the compacted plane and
    rebuilds it with _expand_flat_planes), every snapshot array equal to
    the CPU worker's, over two intervals."""
    kw = dict(stage_depth=16, batch_size=512, initial_histo_rows=64,
              set_store=store, count_unique_timeseries=True,
              initial_set_rows=16)
    gpu = tw.DeviceWorker(**kw, device=card)
    cpu = tw.DeviceWorker(**kw, device="cpu")
    for w in (gpu, cpu):
        w.attach_native()
    lines = _lines(5) + _set_lines(6)
    grams = [b"\n".join(lines[i:i + 40]) for i in range(0, len(lines), 40)]
    qs = np.array([0.5, 0.9, 0.99])
    for _ in range(2):
        k1, k4, k5 = (ek.flush_extract.launches, hll.insert_batch.launches,
                      hll.estimate.launches)
        for w in (gpu, cpu):
            if store == "staged":  # each epoch's store promotes early
                w._staged_sets.compact_every = 2048
            for d in grams:
                w.ingest_datagram(d)
        a, b = gpu.flush(qs), cpu.flush(qs)
        assert ek.flush_extract.launches == k1 + 1
        assert hll.insert_batch.launches > k4
        assert hll.estimate.launches == k5 + 1
        assert gpu.last_plane_upload_bytes == cpu.last_plane_upload_bytes > 0
        for name in ("quantile_values", "dmin", "dmax", "dsum", "dcount",
                     "drecip", "lmin", "lmax", "lsum", "lweight", "lrecip",
                     "digest_means", "digest_weights", "set_estimates",
                     "set_registers", "unique_timeseries_registers"):
            va, vb = getattr(a, name), getattr(b, name)
            assert va.dtype == vb.dtype and va.shape == vb.shape, name
            if va.dtype == np.float32:
                assert _bitwise(torch.from_numpy(np.ascontiguousarray(va)),
                                torch.from_numpy(np.ascontiguousarray(vb))), \
                    name
            else:
                assert va.tobytes() == vb.tobytes(), name
        for pool in ("counters", "gauges"):
            pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
            assert pa.values[:pa.used].tobytes() == \
                pb.values[:pb.used].tobytes(), pool


# -- micro-folds and the device guard ------------------------------------------


def test_mirror_on_the_card(card):
    """The mirror on the card is the dense plane of its COO entries,
    through growth, many chunk dispatches (both pinned record blocks in
    turns) and the padded last chunk."""
    from veneur_tpu_torch.ops import microfold as mf

    rng = np.random.default_rng(17)
    depth, rows_n = 32, 3000
    counts = rng.integers(0, depth + 1, rows_n)
    rows = np.repeat(np.arange(rows_n), counts).astype(np.int32)
    slots = np.concatenate([np.arange(c) for c in counts]).astype(np.int32)
    order = rng.permutation(len(rows))
    rows, slots = rows[order], slots[order]
    vals = rng.normal(size=len(rows)).astype(np.float32)
    wts = rng.uniform(0.5, 2.0, len(rows)).astype(np.float32)
    m = mf.MicroFoldMirror(depth, card, initial_rows=64, chunk=1000)
    for a in range(0, len(rows), 777):
        m.feed(rows[a:a + 777], slots[a:a + 777], vals[a:a + 777],
               wts[a:a + 777])
    st = m.finish()
    dense_v = np.zeros((st.vals.shape[0], depth), np.float32)
    dense_w = np.zeros_like(dense_v)
    dense_v[rows, slots] = vals
    dense_w[rows, slots] = wts
    assert st.chunks == -(-len(rows) // 1000)
    assert st.vals.device.type == "cuda"
    assert st.vals.cpu().numpy().tobytes() == dense_v.tobytes()
    assert st.wts.cpu().numpy().tobytes() == dense_w.tobytes()


def _micro_lines(seed: int) -> list[bytes]:
    """300 timer series of 8 samples (under the staging depth: the
    native drains cut no spill), counters, gauges and sets."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(2400):
        k = i % 300
        out.append(f"t{k}:{rng.gamma(2.0, 9.0):.4f}|ms|#k:{k % 7}".encode())
        out.append(f"c{k % 11}:{k % 4 + 1}|c".encode())
        out.append(f"u{k % 9}:m{int(rng.integers(0, 1 << 20))}|s".encode())
    return out


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_micro_fold_on_the_card(card, native):
    """Micro-folded on the card == batch-folded on the card == batch-
    folded on the CPU, bitwise, over two intervals; no guard fault."""
    kw = dict(stage_depth=16, batch_size=512, initial_histo_rows=64,
              micro_fold_rows=1, micro_fold_max_age_s=1e9)
    workers = [tw.DeviceWorker(**kw, micro_fold=True, device=card),
               tw.DeviceWorker(**kw, device=card),
               tw.DeviceWorker(**kw, device="cpu")]
    qs = np.array([0.5, 0.9, 0.99])
    for rnd in range(2):
        lines = _micro_lines(40 + rnd)
        grams = [b"\n".join(lines[i:i + 60])
                 for i in range(0, len(lines), 60)]
        snaps = []
        for w in workers:
            if native and rnd == 0:
                w.attach_native()
            for j, d in enumerate(grams):
                if native:
                    w.ingest_datagram(d)
                else:
                    for line in d.split(b"\n"):
                        w.process_metric(parse_metric(line))
                if j % 10 == 9 and w.micro_fold_due():
                    w.micro_fold_once()
            snaps.append(w.flush(qs))
        assert workers[0].micro_folds_swapped >= 3
        assert workers[0].last_micro_chunks >= 1
        for other in snaps[1:]:
            assert guard_faults.same_snapshots(snaps[0], other) == []
        assert not any(s.degraded for s in snaps)
    assert all(w.guard.counters() == {} for w in workers)


def test_real_oom_through_the_grow_valve(card):
    res = guard_faults.run_grow_oom()
    assert res["counters"]["device.guard.readmissions"] == 1
    assert res["degraded_then"] and not res["degraded_after"]


def test_real_sticky_fault_in_a_child_process(card):
    res = guard_faults.run_sticky_fault()
    assert res["kind"] == "lost" and res["error_code"] == 710
    assert res["differs"] == [] and res["degraded"]


def test_fault_among_the_spill_writes_on_the_card(card, monkeypatch):
    """An OutOfMemoryError raised among a card spill fold's writes (the
    pool partly written), twice: the held update's writes are repeated on
    the card until they land, and the interval equals a CPU worker's
    that saw no fault, bitwise and not degraded."""
    kw = dict(guard_faults.KW, device_fault_streak=10)
    gpu = tw.DeviceWorker(**kw, device=card)
    cpu = tw.DeviceWorker(**kw, device="cpu")
    left = {"n": 2}
    real = torch.Tensor.scatter_reduce_

    def flaky(self, dim, index, src, reduce, **k):
        if reduce == "amin" and self.is_cuda and left["n"]:
            left["n"] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory (test)")
        return real(self, dim, index, src, reduce, **k)

    monkeypatch.setattr(torch.Tensor, "scatter_reduce_", flaky)
    batch = guard_faults.lines(23)
    for w in (gpu, cpu):
        guard_faults.feed(w, batch)
    qs = np.array(guard_faults.QS)
    a, b = gpu.flush(qs), cpu.flush(qs)
    monkeypatch.undo()
    assert left["n"] == 0
    assert gpu.guard.counters()["device.fault.oom"] == 2
    assert not gpu.guard.quarantined and not a.degraded
    assert guard_faults.same_snapshots(a, b) == []


def test_dense_set_pool_fails_over_alone_on_the_card(card):
    """A set fault that does not trip the breaker moves the dense set
    pool alone to the CPU (the digest pool stays on the card): the flush
    is degraded and equal to a CPU worker's; the next epoch's set pool
    is on the card again."""
    from veneur_tpu_torch.utils import faults as fl

    kw = dict(batch_size=1024, set_store="dense", initial_set_rows=16,
              device_fault_streak=50)
    gpu = tw.DeviceWorker(**kw, device=card)
    cpu = tw.DeviceWorker(**kw, device="cpu")
    qs = np.array([0.5])
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=12, op_windows={"sets": [(1, 3, "lost")]})) as inj:
        for line in _set_lines(4):
            gpu.process_metric(parse_metric(line))
        assert gpu._sets.device.type == "cpu"
        assert gpu._histo.means.device.type == "cuda"
        a = gpu.flush(qs)
    for line in _set_lines(4):
        cpu.process_metric(parse_metric(line))
    b = cpu.flush(qs)
    assert inj.injected["lost"] == 2 and not gpu.guard.quarantined
    assert a.degraded and not b.degraded
    assert guard_faults.same_snapshots(a, b) == []
    for w in (gpu, cpu):
        for line in _set_lines(5):
            w.process_metric(parse_metric(line))
    assert gpu._sets.device.type == "cuda"
    a2, b2 = gpu.flush(qs), cpu.flush(qs)
    assert not a2.degraded
    assert guard_faults.same_snapshots(a2, b2) == []


def test_egress_of_a_card_snapshot(card):
    """A small card snapshot through generate_columnar and the line,
    exposition and Datadog sinks: the native tier's bytes equal the
    Python formatter's (line blobs and exposition text byte for byte,
    Datadog series by value), and the card batch's equal the CPU
    batch's."""
    import json
    import zlib

    from veneur_tpu_torch.core.flusher import (device_quantiles,
                                               generate_columnar)
    from veneur_tpu_torch.core.metrics import HistogramAggregates
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
    from veneur_tpu_torch.sinks.forward_statsd import ForwardStatsdSink
    from veneur_tpu_torch.sinks.prometheus import (PrometheusExpositionSink,
                                                   PrometheusMetricSink)

    aggs = HistogramAggregates.from_names(
        ["min", "max", "count", "sum", "avg", "median", "hmean"])
    qs = device_quantiles([0.5, 0.99], aggs)
    rng = np.random.default_rng(8)
    lines = [f"lat.{i % 97}:{v:.4f}|ms|#ep:e{i % 3}".encode()
             for i, v in enumerate(rng.gamma(2.0, 20.0, 4000))]
    lines += [f"c.{i}:{i % 4}|c".encode() for i in range(50)]
    lines += [f"g.{i}:{rng.normal():.5f}|g|#host:h{i}".encode()
              for i in range(50)]
    lines += _set_lines(2)[:400]
    batches = []
    for device in (card, "cpu"):
        w = tw.DeviceWorker(batch_size=1024, device=device)
        for line in lines:
            w.process_metric(parse_metric(line))
        batches.append(generate_columnar(w.flush(qs), False, [0.5, 0.99],
                                         aggs, now=1_700_000_000))

    def emit(batch, native):
        out = []
        for cls in (ForwardStatsdSink, PrometheusMetricSink):
            sink = cls("127.0.0.1:9")
            sent = []
            sink._send = sent.append
            if native:
                assert sink.flush_columnar_native(batch)
            else:
                sink.flush_columnar(batch)
            out.append(b"\n".join(sent[0]))
        expo = PrometheusExpositionSink("http://127.0.0.1:9/m")
        posted = []
        expo._post = lambda body, count: posted.append(body)
        (expo.flush_columnar_native if native else expo.flush_columnar)(
            batch)
        out.append(posted[0])
        dd = DatadogMetricSink(interval=10.0, flush_max_per_body=500,
                               hostname="h", tags=["t:1"],
                               dd_hostname="http://127.0.0.1:9",
                               api_key="k")
        got = []
        dd._post_all = lambda m, c, raw=None, n=0, precompressed=False: \
            got.append((m, raw or []))
        (dd.flush_columnar_native if native else dd.flush_columnar)(batch)
        series, raw = got[0]
        entries = list(series)
        for body in raw:
            entries += json.loads(zlib.decompress(body))["series"]
        out.append(sorted(json.dumps(e, sort_keys=True) for e in
                          ({**e, "points": [[t, None if v is None
                                             else float(v)]
                                            for t, v in e["points"]]}
                           for e in entries)))
        out.append(raw)
        return out

    card_native, card_python = emit(batches[0], True), emit(batches[0], False)
    assert emit(batches[1], True) == card_native
    assert card_native[:4] == card_python[:4]
    assert card_native[4] and not card_python[4]
    assert card_native[0].count(b"\n") > 500
