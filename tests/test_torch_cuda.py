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
and the native ingest path on the card against the CPU.

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
