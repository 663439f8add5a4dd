"""The PyTorch port on the card: the flush extract kernel (the variant
flush_extract launches, and every built variant) against its plain
version, bitwise, at row counts around the kernel's chunk and block
round, up to 1,000,003 rows, P = 1, 3 and 16 (the narrow kernel) and
17, 32 and 64 (the wide one, quantile blocks of 16), a row-offset view and the
edge rows of tools/port_probe_extract.edge_pool (denormal rows
included); the HLL kernels against their plain versions, bytewise and in
f32 bits, at p = 4, 8, 14 and 18 (tools/port_probe_hll cases: duplicate
slots, padding, dropped rows, every estimator regime, int8 values outside
the rank range, row counts around each block round; for the insert
negative rows, duplicate words within a warp, odd negative registers, n
not a multiple of 32, n = 1,048,576 and the host inserter's pinned
uploads); the CUDA worker, with and without sets, against its CPU twin;
the native ingest path on the card against the CPU; the native SSF span
path (C++ span decoding and extraction into a worker's context) and
port servers deriving spans (native and columnar) on the card against
the CPU; the micro-fold
mirror on the card, and micro-folded intervals against batch-folded ones
on the card and the CPU; and the device guard under real faults
(tools/port_guard_faults.py): an allocator OOM through the HBM valve,
a device-side assert in a child process, an OOM among a spill fold's
writes, and a set fault that moves the dense set pool alone; the live
query path (the evaluator at the flush quantiles bitwise the flush's
readback, every response the CPU worker's) and the tenant sketch (the
count-min programs on the card bitwise the CPU's, a fenced pool
unchanged after a later fold); the governed extraction's launch pattern
(the extract kernel over pow2 row chunks of a 1,048,576-row pool,
concatenated, bitwise the one-shot launch at P = 3 and 32; a misaligned
base raises before any launch; a governed worker bitwise a CPU worker,
one launch per chunk, the transfer ledgers equal); and the flush archive
(a card flush's VMB1 frame, native and Python, equal to the CPU's, every
plan-capable section through the native encoder) and a server with the
archive, the plugins and the remaining span sinks on the card, its
archive replayed into a card global bitwise, merged once under dedup;
and the t-digest folds (K2a compress_rows, K2b add_batch) against their
plain versions on the same card inputs, edge rows and batches, ragged S,
K and N, a batch all in one row and the global scratch slab of wide rows
included, K2b with torch.sort patched to raise (the sort is the
kernels'), and a card worker's interval with the plain folds patched to
raise (no fallback); and digest min and max in XLA's order (-0.0 below
+0.0, a NaN winning) on the card bitwise the CPU, the functions and the
worker's fold steps, on rows that mix +0.0, -0.0 and NaN; and K3, the
staged fold (core/worker.fold_staged), against the CPU's plain chain:
dense and flat planes, unit and weighted, a short mirror, ragged S,
depths 64, 40 and 1, the edge rows of probe_td.fold_inputs, rows of
denormals (F7), the wide form past 256 candidates (K2a's block kernel
and its slab), a 4-shard split, with torch's ops patched to raise, and
the rank path's edge rows (probe_td.rank_case) with the card's tally of
each row's path; and the ported tools: td.cdf on digest rows at values
around every row's bounds, the t-digest analysis's seven distributions
(estimates bitwise the CPU's) and every fuzz target on the card (query's
F9 divergence the CPU's, bit for bit).

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
from veneur_tpu_torch import ssf
from veneur_tpu_torch.core.config import Config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.protocol import ssf_wire
from veneur_tpu_torch.protocol.dogstatsd import parse_metric

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import port_guard_faults as guard_faults  # noqa: E402
import port_probe_extract as probe  # noqa: E402
import port_probe_hll as probe_hll  # noqa: E402
import port_probe_tdigest as probe_td  # noqa: E402
import port_fuzz_differential as fuzz_tool  # noqa: E402
import port_tdigest_analysis as analysis_tool  # noqa: E402

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
_QS = {1: [1.0], 3: [0.5, 0.9, 0.99], 16: list(np.linspace(0.0, 1.0, 16)),
       17: list(np.linspace(0.0, 1.0, 17)),
       32: list(np.linspace(0.0, 1.0, 32)),
       64: list(np.random.default_rng(3).random(64))}
PS = [1, 3, 16, 17, 32, 64]


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
@pytest.mark.parametrize("p", PS)
def test_kernel_bitwise_equals_plain(big, s, p):
    fields = [f[:s] for f in big[0]]
    before = ek.flush_extract.launches
    got = ek.flush_extract(*fields, _qs(p, fields[0].device))
    torch.cuda.synchronize()
    assert ek.flush_extract.launches == before + 1
    assert _bitwise(got, _plain(big, s, p))


@pytest.mark.parametrize("r", ek.VARIANTS)
@pytest.mark.parametrize("p", PS)
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
@pytest.mark.parametrize("p", PS)
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
    # the kernel takes P >= 1 (flush_extract runs P = 0 at P = 1, F10)
    with pytest.raises(ValueError):
        ek._flush_extract_variant(ek.ROWS_PER_WARP, *fields,
                                  torch.zeros(0, device=card))
    wide = [torch.zeros((8, 256), device=card)] * 2 + fields[2:]
    with pytest.raises(ValueError):
        ek.flush_extract(*wide, torch.tensor([0.5], device=card))


def test_quantile_columns_do_not_depend_on_p(big):
    """A quantile's column is the same bits whatever else is asked: the
    wide kernel's blocks (P = 17, 32, 64) against the narrow kernel
    (P <= 16) on the same rows, one launch each."""
    fields = [f[:131_072] for f in big[0]]
    dev = fields[0].device
    q64 = torch.tensor(_QS[64], dtype=torch.float32, device=dev)
    before = ek.flush_extract.launches
    wide = ek.flush_extract(*fields, q64)
    for j0 in range(0, 64, 16):
        narrow = ek.flush_extract(*fields, q64[j0:j0 + 16])
        assert _bitwise(wide[:, j0:j0 + 16], narrow[:, :16]), j0
        assert _bitwise(wide[:, 64:], narrow[:, 16:])
    torch.cuda.synchronize()
    assert ek.flush_extract.launches == before + 5


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


# -- the global tier and reader shards (card against CPU) ------------------


def _import_inputs(s: int, k: int, seed: int):
    """A pool's six fields and K imported rows [K, 2C], the padding rows
    pointing at the scratch row with an empty import, as _merge_imports
    builds them; denormal scalars and centroids among them."""
    rng = np.random.default_rng(seed)
    pool = [t.numpy() for t in _pool(s, seed)[:6]]
    n = k - 5
    rows = np.full(k, s - 1, np.int64)
    rows[:n] = np.sort(rng.choice(np.arange(s - 1), n, replace=False))
    w = 2 * C
    means = np.full((k, w), np.inf, np.float32)
    wts = np.zeros((k, w), np.float32)
    for i in range(n):
        m = int(rng.integers(0, w))
        means[i, :m] = rng.normal(30.0, 9.0, m)
        wts[i, :m] = rng.choice([1.0, 2.0], m)
    means[1, :3] = np.float32(3e-44)
    imin = np.where(wts[:, 0] > 0, means.min(axis=1), np.inf).astype(
        np.float32)
    imax = np.where(wts[:, 0] > 0, np.where(wts > 0, means, -np.inf)
                    .max(axis=1), -np.inf).astype(np.float32)
    irec = rng.normal(0.2, 0.1, k).astype(np.float32)
    irec[n:] = 0.0  # the padding imports nothing
    irec[2] = np.float32(4e-41)
    return pool, (rows, means, wts, imin, imax, irec)


@pytest.mark.parametrize("k", [16, 4096])
def test_import_step_on_the_card(card, k):
    pool, imp = _import_inputs(8192, k, k)
    outs = []
    for dev in (card, torch.device("cpu")):
        fields = [torch.from_numpy(a.copy()).to(dev) for a in pool]
        tw._histo_import_step(*fields,
                              *(torch.from_numpy(a).to(dev) for a in imp))
        outs.append(fields)
    for a, b in zip(*outs):
        assert _bitwise(a, b)


def test_hll_row_max_on_the_card(card):
    rng = np.random.default_rng(4)
    pool = rng.integers(0, 20, (1024, 1 << 14)).astype(np.int8)
    rows = np.sort(rng.choice(1023, 300, replace=False)).astype(np.int64)
    regs = rng.integers(0, 30, (300, 1 << 14)).astype(np.int8)
    g = torch.from_numpy(pool.copy()).to(card)
    c = torch.from_numpy(pool.copy())
    tw.DeviceWorker._import_hll_rows(g, rows, regs)
    tw.DeviceWorker._import_hll_rows(c, rows, regs)
    assert torch.equal(g.cpu(), c)
    ref = pool.copy()
    np.maximum.at(ref, rows, regs)
    assert np.array_equal(c.numpy(), ref)


@pytest.mark.parametrize("h,s", [(2, 1000), (8, 65_536)])
def test_merge_many_on_the_card(card, h, s):
    from veneur_tpu_torch.ops import tdigest as td

    stacked = [np.stack(f) for f in zip(*(
        [t.numpy() for t in _pool(s, 10 + i)[:5]] for i in range(h)))]
    got = td.merge_many(td.TDigestPool(
        *(torch.from_numpy(a).to(card) for a in stacked)))
    ref = td.merge_many(td.TDigestPool(
        *(torch.from_numpy(a) for a in stacked)))
    for a, b in zip(got, ref):
        assert _bitwise(a, b)


def test_reader_shards_on_the_card(card):
    """Two owned contexts: the card's interval bitwise the CPU's."""
    snaps = []
    for dev in (card, "cpu"):
        w = tw.DeviceWorker(compression=100, stage_depth=8, batch_size=64,
                            initial_histo_rows=8, device=dev)
        w.attach_native()
        assert w.attach_reader_shards(2)
        for seed in range(2):
            for j, line in enumerate(_lines(seed)):
                w._reader_ctxs[j % 2].ingest_owned(line)
        snaps.append(w.flush(np.asarray([0.5, 0.99], np.float32)))
        assert w.reader_committed[1] > 0 and w.reader_committed[2] > 0
    a, b = snaps
    for f in ("quantile_values", "dmin", "dmax", "dsum", "dcount",
              "lsum", "lweight"):
        assert np.asarray(getattr(a, f)).tobytes() == \
            np.asarray(getattr(b, f)).tobytes(), f


# -- the SSF span path --------------------------------------------------------


def _span_packets(seed: int, n: int) -> list[bytes]:
    """SSF datagrams: indicator spans over 16 services carrying timers,
    histograms, counters, gauges and set members; every 9th span carries
    a status check (the Python fall-back)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        samples = [
            ssf.SSFSample(metric=ssf.SSFMetricType.HISTOGRAM,
                          name=f"cs.lat{i % 40}",
                          value=float(rng.gamma(2.0, 9.0)), timestamp=1),
            ssf.SSFSample(metric=ssf.SSFMetricType.COUNTER,
                          name=f"cs.hits{i % 7}", value=1.0, timestamp=1),
            ssf.SSFSample(metric=ssf.SSFMetricType.GAUGE,
                          name=f"cs.load{i % 5}", value=float(i),
                          timestamp=1),
            ssf.SSFSample(metric=ssf.SSFMetricType.SET,
                          name=f"cs.users{i % 3}",
                          message=f"u{int(rng.integers(0, 6000))}",
                          timestamp=1)]
        if i % 9 == 0:
            samples.append(ssf.SSFSample(
                metric=ssf.SSFMetricType.STATUS, name="cs.chk",
                status=ssf.SSFStatus.WARNING, timestamp=1))
        start = 1_000_000_000 + i
        out.append(ssf_wire.encode_datagram(ssf.SSFSpan(
            trace_id=100 + i, id=200 + i, start_timestamp=start,
            end_timestamp=start + int(rng.gamma(2.0, 5e6)),
            service=f"svc{i % 16}", indicator=True, name="op",
            metrics=samples)))
    return out


def test_native_ssf_worker_cuda_equals_cpu(card):
    """Spans decoded and extracted in C++ into a worker's context on the
    card (the dense set store, so set members go through the insert
    kernel): every snapshot array equal to the CPU worker's, two
    intervals."""
    kw = dict(stage_depth=16, batch_size=4096, initial_histo_rows=64,
              set_store="dense", initial_set_rows=16, hll_precision=14,
              micro_fold=False)
    gpu = tw.DeviceWorker(**kw, device=card)
    cpu = tw.DeviceWorker(**kw, device="cpu")
    for w in (gpu, cpu):
        w.attach_native()
    qs = np.array([0.5, 0.9, 0.99])
    for k in range(2):
        packets = _span_packets(k, 6000)
        k1, k4 = ek.flush_extract.launches, hll.insert_batch.launches
        res = [w._native.ingest_ssf_many(packets, b"cs.ind", b"cs.obj", 1.0)
               for w in (gpu, cpu)]
        assert res[0] == res[1] and res[0][0] == 6000 - 667
        a, b = gpu.flush(qs), cpu.flush(qs)
        assert ek.flush_extract.launches == k1 + 1
        assert hll.insert_batch.launches > k4
        for name in ("quantile_values", "dmin", "dmax", "dsum", "dcount",
                     "lsum", "lweight", "digest_means", "digest_weights",
                     "set_estimates", "set_registers"):
            va, vb = getattr(a, name), getattr(b, name)
            assert va.dtype == vb.dtype and va.shape == vb.shape, name
            assert va.tobytes() == vb.tobytes(), name


@pytest.mark.parametrize("native", [True, False], ids=["native", "columnar"])
def test_span_server_cuda_equals_cpu(card, native):
    """A port server deriving spans on the card (native SSF path or the
    columnar pipeline) flushes the CPU server's InterMetrics, three
    intervals, each flush's own span included."""
    outs = []
    for dev in (card, "cpu"):
        srv = Server(Config(
            interval="10s", num_workers=1, tpu_native_ingest=native,
            micro_fold=False, percentiles=[0.5, 0.99],
            indicator_span_timer_name="cs.ind",
            objective_span_timer_name="cs.obj",
            ssf_span_uniqueness_rate=1.0), device=dev)
        try:
            assert srv._native_ssf is native
            got = []
            for k in range(3):
                packets = _span_packets(10 + k, 3000)
                if native:
                    srv.handle_trace_packets_native(packets)
                else:
                    for pkt in packets:
                        srv.handle_trace_packet(pkt)
                got.append(sorted((m.name, m.value, tuple(m.tags))
                                  for m in srv.flush(now=1_700_000_000 + k)))
            outs.append(got)
        finally:
            srv.shutdown()
    assert outs[0] == outs[1]


class _CaptureSock:
    """Stands in for a forward-statsd sink's TCP socket."""

    def __init__(self):
        self.data = bytearray()

    def settimeout(self, t):
        pass

    def sendall(self, b):
        self.data += b

    def close(self):
        pass


def _proxy_tier(device, local_snaps, qs):
    """Three locals forward in turn through a port proxy to two port
    globals on ``device``; every metric of a local is delivered before
    the next forwards. Returns each global's snapshots and sink bytes."""
    import time

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.distributed import codec, rpc
    from veneur_tpu_torch.distributed.forward import GRPCForwarder
    from veneur_tpu_torch.distributed.proxy import ProxyServer

    globals_ = []
    for _ in range(2):
        g = build_server(load_config(data={
            "interval": "1h", "percentiles": [0.5, 0.9, 0.99],
            "aggregates": ["min", "max", "count", "sum"], "num_workers": 2,
            "tpu_hll_precision": 10, "hostname": "g",
            "ssf_span_uniqueness_rate": 0.0, "grpc_address": "127.0.0.1:0",
            "forward_statsd_address": "127.0.0.1:9",
            "forward_statsd_network": "tcp"}), device=device)
        sock = _CaptureSock()
        g.metric_sinks[0]._sock = sock
        globals_.append((g, sock))
    names = ["global-0:1", "global-1:1"]
    real = {n: f"127.0.0.1:{g.import_server.port}"
            for n, (g, _) in zip(names, globals_)}
    proxy = ProxyServer(
        names, handoff_window_s=30.0,
        client_factory=lambda d, t, i: rpc.ForwardClient(real[d], t))
    fwd = GRPCForwarder(f"127.0.0.1:{proxy.start_grpc()}", 10.0, 100.0, 10,
                        streaming=True)
    try:
        expect = 0
        for snap in local_snaps:
            expect += codec.snapshot_to_wire(snap, 100.0, 10)[1]
            fwd([snap])
            deadline = time.time() + 60
            while time.time() < deadline and (
                    proxy.proxied_metrics < expect or sum(
                        g.import_server.received_metrics
                        for g, _ in globals_) < expect):
                time.sleep(0.01)
            assert proxy.proxied_metrics == expect
        assert proxy.conserved() and proxy.drops == 0
        outs = []
        for g, sock in globals_:
            snaps = []
            for w in g.workers:
                def wrapped(*a, _orig=w.extract_snapshot, **k):
                    snaps.append(_orig(*a, **k))
                    return snaps[-1]
                w.extract_snapshot = wrapped
            g.flush(now=1_700_000_000)
            outs.append((snaps, bytes(sock.data)))
        return outs, proxy.ring
    finally:
        fwd.close()
        proxy.stop()
        for g, _ in globals_:
            g.shutdown()


def test_proxy_tier_card_globals_equal_cpu(card):
    """Three locals -> a port proxy -> two port globals: the globals on
    the card against the same on the CPU, every snapshot array and the
    forward-statsd bytes bitwise; every series on its ring owner."""
    import dataclasses

    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates

    qs = device_quantiles([0.5, 0.9, 0.99], HistogramAggregates.from_names(
        ["min", "max", "count", "sum"]))
    local_snaps = []
    for host in range(3):
        rng = np.random.default_rng(300 + host)
        w = tw.DeviceWorker(compression=100, stage_depth=16, batch_size=64,
                            initial_histo_rows=8, initial_set_rows=8,
                            is_local=True, hll_precision=10, device="cpu")
        for i in range(120):
            k = i % 48
            for line in (
                    f"px.lat{k}:{rng.gamma(2.0, 15.0):.4f}|"
                    f"{'ms' if k % 2 else 'h'}|#a:{k % 3}",
                    f"px.c{k % 7}:{1 + k % 3}|c|#veneurglobalonly",
                    f"px.g{k % 5}:{rng.normal():.5f}|g|#veneurglobalonly",
                    f"px.s{k % 9}:u{int(rng.integers(0, 400))}|s"):
                w.process_metric(parse_metric(line.encode()))
        local_snaps.append(w.flush(qs))
    got, ring = _proxy_tier(card, local_snaps, qs)
    ref, _ = _proxy_tier("cpu", local_snaps, qs)
    for gi, ((gs, gb), (rs, rb)) in enumerate(zip(got, ref)):
        assert gb == rb and gb, gi
        for a, b in zip(gs, rs):
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                if isinstance(va, np.ndarray):
                    assert va.tobytes() == vb.tobytes(), (gi, f.name)
            for r in a.directory.histo.rows:
                assert ring.get(r.key.key_string()) == f"global-{gi}:1"


# -- the live query path and the tenant sketch --------------------------------


def _query_worker(device, engine, budgets=None):
    import functools

    from veneur_tpu_torch.core.tenancy import TenantLedger, TenantSketch

    w = tw.DeviceWorker(compression=100, stage_depth=16, batch_size=512,
                        initial_histo_rows=64, initial_set_rows=16,
                        device=device)
    w.tenancy = TenantLedger(budgets=budgets or {"t2": 40})
    w.tenant_sketch = TenantSketch(depth=4, width=2048, topk=8,
                                   device=device)
    w.query_publisher = functools.partial(engine.stage, 0)
    return w


def _query_lines(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4000):
        k = i % 300
        out.append(f"qt{k}:{rng.gamma(2.0, 9.0):.4f}|ms|#tenant:t{k % 3}"
                   .encode())
        if i % 3 == 0:
            out.append(f"qs{k % 50}:u{int(rng.integers(0, 900))}|s|"
                       f"#tenant:t{k % 3}".encode())
    return out


def test_query_evaluator_is_the_flush_readback(card):
    """A device query at the flush quantiles is bitwise what the flush
    read back (K1 again over the retained fields); a 32-quantile request
    launches K1 once and every response is the CPU worker's, byte for
    byte."""
    import json

    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates
    from veneur_tpu_torch.query import QueryEngine

    aggs = HistogramAggregates.from_names(["min", "max", "count", "sum"])
    qs = device_quantiles([0.5, 0.9, 0.99], aggs)
    engines, snaps = [], []
    for dev in (card, "cpu"):
        eng = QueryEngine([0.5, 0.9, 0.99], aggs, topk=8)
        w = _query_worker(dev, eng)
        for line in _query_lines(21):
            w.process_metric(parse_metric(line))
        snaps.append(w.flush(qs))
        eng.commit(1_700_000_000)
        engines.append(eng)
    r = engines[0].query_quantiles(force_device=True, limit=10 ** 6)
    got = torch.tensor([x["values"] for x in r["results"]],
                       dtype=torch.float32)
    assert _bitwise(got, torch.from_numpy(snaps[0].quantile_values))
    q32 = [float(q) for q in np.linspace(0.0, 1.0, 32)]
    before = ek.flush_extract.launches
    reqs = [{"op": "quantiles", "qs": q32, "force_device": True,
             "limit": 10 ** 6}, {"op": "quantiles", "qs": [0.3]},
            {"op": "scalars"}, {"op": "cardinality"},
            {"op": "topk", "tenant": "t1"}, {"op": "tenant_totals"},
            {"op": "cms", "keys": [m.key.key_string() for m in
                                   snaps[0].directory.histo.rows[:50]],
             "tenant": "t0"}]
    outs = [[json.dumps(e.dispatch(dict(q))) for q in reqs]
            for e in engines]
    assert ek.flush_extract.launches == before + 2  # P = 32 and P = 4
    assert outs[0] == outs[1]


def test_count_min_on_the_card_equals_the_cpu(card):
    from veneur_tpu_torch.ops import heavyhitter as hh

    rng = np.random.default_rng(5)
    keys = [f"k{rng.integers(5000)}" for _ in range(20_000)]
    rows = rng.integers(0, 16, len(keys)).astype(np.int32)
    counts = rng.integers(1, 1 << 20, len(keys)).astype(np.int32)
    cols = hh.split_hashes(hh.hash_keys(keys))
    pools = [hh.insert_chunked(hh.init_pool(16, device=dev), rows, cols,
                               counts, 4096) for dev in (card, "cpu")]
    assert pools[0].device.type == "cuda"
    assert torch.equal(pools[0].cpu(), pools[1])
    assert torch.equal(hh.merge(pools[0], pools[0]).cpu(),
                       hh.merge(pools[1], pools[1]))
    assert torch.equal(hh.tenant_totals(pools[0]).cpu(),
                       hh.tenant_totals(pools[1]))
    for row in (0, 7):
        assert np.array_equal(hh.read_query(pools[0], row, keys[:500]),
                              hh.read_query(pools[1], row, keys[:500]))
    assert np.array_equal(hh.read_totals(pools[0]),
                          hh.read_totals(pools[1]))


def test_fenced_pool_unchanged_after_a_later_fold(card):
    from veneur_tpu_torch.core.tenancy import TenantSketch

    sk = TenantSketch(depth=4, width=2048, topk=8, device=card)
    keys = [f"series-{i}" for i in range(3000)]
    counts = np.arange(1, 3001, dtype=np.int64)
    sk.fold(["t0"] * 3000, keys, counts, chunk=1024)
    view = sk.snapshot()
    before = view.pool.clone()
    sk.fold(["t0"] * 3000, keys, counts, chunk=1024)
    torch.cuda.synchronize()
    assert sk.pool is not view.pool
    assert torch.equal(view.pool, before)
    assert view.totals()["t0"] == int(counts.sum())
    assert sk.totals()["t0"] == 2 * int(counts.sum())


@pytest.mark.parametrize("p", [3, 32])
def test_chunked_extract_bitwise_one_shot(big, p):
    """The governed extraction's launch pattern: one launch per pow2 row
    chunk of a 1,048,576-row pool (a contiguous slice with a shifted
    base), concatenated, is bitwise the one-shot launch and the plain
    version."""
    s = 1_048_576
    fields = [f[:s] for f in big[0]]
    qs = _qs(p, fields[0].device)
    one = ek.flush_extract(*fields, qs)
    before = ek.flush_extract.launches
    # chunks doubling from the 1,024-row floor, halving back, then floor
    # chunks to the end (the governor's pow2 schedule)
    sizes = [1024 << k for k in range(9)] + [1024 << k
                                            for k in range(8, -1, -1)]
    parts, lo = [], 0
    while lo < s:
        c = sizes[len(parts)] if len(parts) < len(sizes) else 1024
        parts.append(ek.flush_extract(*(f[lo:lo + c] for f in fields), qs))
        lo += c
    assert lo == s
    torch.cuda.synchronize()
    assert ek.flush_extract.launches == before + len(parts)
    chunked = torch.cat(parts)
    assert _bitwise(chunked, one)
    assert _bitwise(chunked, _plain(big, s, p))


def test_misaligned_slice_raises_on_the_card(card):
    s = 4096
    flat = torch.zeros(s * C + 1, device=card)
    fields = [flat[1:].view(s, C), torch.zeros(s, C, device=card)] + [
        torch.zeros(s, device=card) for _ in range(12)]
    before = ek.flush_extract.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ek.flush_extract(*fields, _qs(3, card))
    assert ek.flush_extract.launches == before


def test_governed_worker_on_the_card_equals_cpu(card):
    """A worker with a 1 ms chunk target extracts in many chunks on the
    card: its snapshot is bitwise a CPU worker's one-shot snapshot, K1
    ran once per chunk, and the ledger's books equal the CPU's."""
    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates
    from veneur_tpu_torch.health import FlushDeadlineGovernor

    qs = device_quantiles([0.5, 0.9, 0.99],
                          HistogramAggregates.from_names(["min", "max",
                                                          "count"]))
    rng = np.random.default_rng(23)
    lines = [b"g.t%d:%.4f|ms" % (i % 20_000, v)
             for i, v in enumerate(rng.gamma(2.0, 9.0, 60_000))]
    snaps, workers = [], []
    gov = FlushDeadlineGovernor(chunk_target_ms=1, interval_s=10.0)
    for dev, g in ((card, gov), ("cpu", None)):
        w = tw.DeviceWorker(device=dev, stage_depth=8, batch_size=4096)
        w.governor = g
        for ln in lines:
            w.process_metric(parse_metric(ln))
        if g is not None:
            g.begin_flush()
            before = ek.flush_extract.launches
        snaps.append(w.flush(qs))
        if g is not None:
            launched = ek.flush_extract.launches - before
        workers.append(w)
    assert gov.last_report["chunks"] > 1
    assert launched == gov.last_report["chunks"]
    for f in ("quantile_values", "dmin", "dmax", "dsum", "dcount", "drecip",
              "lmin", "lmax", "lsum", "lweight", "lrecip"):
        a, b = getattr(snaps[0], f), getattr(snaps[1], f)
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), f
    assert workers[0].ledger.flush_h2d() == workers[1].ledger.flush_h2d()
    assert workers[0].ledger.flush_d2h() == workers[1].ledger.flush_d2h()


# -- the flush archive and the plugins (card against CPU) ---------------------


def test_archive_frame_of_a_card_flush_equals_cpu(card):
    """A card worker's flush and its CPU twin's, archived as VMB1: the
    native and the Python frames are byte for byte one frame, and every
    plan-capable group took the native section encoder."""
    from veneur_tpu_torch.archive import wire
    from veneur_tpu_torch.core.flusher import (device_quantiles,
                                               generate_columnar)
    from veneur_tpu_torch.core.metrics import HistogramAggregates

    aggs = HistogramAggregates.from_names(["min", "max", "count", "sum"])
    qs = device_quantiles([0.5, 0.99], aggs)
    rng = np.random.default_rng(12)
    lines = [f"arch.{i % 211}:{v:.4f}|ms|#ep:e{i % 5}".encode()
             for i, v in enumerate(rng.gamma(2.0, 20.0, 20_000))]
    lines += [f"arch.c{i}:{i % 7}|c|#k:{i}".encode() for i in range(300)]
    lines += [f"arch.g{i}:{rng.normal():.6f}|g".encode() for i in range(300)]
    lines += _set_lines(3)[:500]
    lines.append(b"arch.routed:1|c|#veneursinkonly:datadog")
    frames = []
    wire.reset_section_counts()
    before = ek.flush_extract.launches
    for device in (card, "cpu"):
        w = tw.DeviceWorker(batch_size=4096, device=device)
        for line in lines:
            w.process_metric(parse_metric(line))
        batch = generate_columnar(w.flush(qs), False, [0.5, 0.99], aggs,
                                  now=1_700_000_000)
        frames += [wire.encode_flush(batch, "card", use_native=True),
                   wire.encode_flush(batch, "card", use_native=False)]
    assert ek.flush_extract.launches > before
    assert all(f == frames[0] for f in frames[1:])
    planned = sum(plan is not None and g.nrows > 0 and bool(g.families)
                  for g, plan in zip(batch.groups, batch.emit_plan()))
    assert planned > 0
    # two native encodes (card, CPU) took every planned group
    assert wire.SECTION_COUNTS["native"] == 2 * planned
    decoded = wire.decode_flush(frames[0][0])
    assert len(decoded["samples"]) == frames[0][1] == len(
        batch.materialize())


def test_archive_server_on_the_card_replays_bitwise(card, tmp_path):
    """A factory-built server on the card with archive_dir, flush_file
    and the blob plugin: its flush launches K1, the plugin pass runs,
    its archive replays into a card global whose counters and gauges are
    the flushed ones bitwise, and a dedup replay run twice merges once;
    the local file and the archive equal a CPU server's."""
    import struct
    from collections import Counter

    from veneur_tpu_torch.archive import read_archive, wire
    from veneur_tpu_torch.archive.replay import replay_frames
    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.distributed.import_server import ImportServer

    def canon(ms):
        return Counter((m.name, tuple(sorted(m.tags)), int(m.type),
                        struct.pack("<d", float(m.value)))
                       for m in ms if int(m.type) in (0, 1))

    rng = np.random.default_rng(4)
    lines = [f"rp.t{i % 50}:{v:.3f}|ms".encode()
             for i, v in enumerate(rng.gamma(2.0, 9.0, 3000))]
    lines += [f"rp.c{i}:{i * 3 + 1}|c|#k:{i % 4}".encode()
              for i in range(200)]
    lines += [f"rp.g{i}:{rng.normal():.9f}|g".encode() for i in range(200)]
    puts = []
    got = {}
    wire.reset_section_counts()
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        data = {"interval": "10s", "hostname": "arch", "percentiles": [0.5],
                "aggregates": ["min", "max", "count"],
                "tpu_native_ingest": False, "micro_fold": False,
                "archive_dir": str(d / "arch"),
                "flush_file": str(d / "flush.tsv"),
                "archive_blob_bucket": "bkt",
                "archive_blob_access_key": "AK",
                "archive_blob_secret_key": "SK"}
        srv = build_server(load_config(data=data), device=dev,
                           opener=lambda req, timeout: puts.append(req.data))
        before = ek.flush_extract.launches
        try:
            for line in lines:
                srv.process_metric_packet(line)
            out = srv.flush(now=1_700_000_000)
            phases = dict(srv.last_flush_phases)
        finally:
            srv.shutdown()
        if dev == "cuda":
            assert ek.flush_extract.launches > before
        assert "plugin_flush_s" in phases
        got[dev] = (read_archive(str(d / "arch")),
                    (d / "flush.tsv").read_bytes(), canon(out.materialize()))
    assert got["cuda"] == got["cpu"]
    assert len(puts) == 2 and puts[0] == puts[1]
    assert puts[0] == got["cuda"][0][0]
    assert wire.SECTION_COUNTS["native"] > 0
    frames, _tsv, expected = got["cuda"]
    glob = Server(Config(interval="10s"), device="cuda")
    try:
        imp = ImportServer(glob)
        replay_frames(frames, apply_batch=imp.handle_batch)
        assert canon(glob.flush(now=1_700_000_010)) == expected
    finally:
        glob.shutdown()
    glob = Server(Config(interval="10s"), device="cuda")
    try:
        imp = ImportServer(glob)
        s1 = replay_frames(frames, apply_wire=imp.handle_wire, dedup=True)
        s2 = replay_frames(frames, apply_wire=imp.handle_wire, dedup=True)
        assert imp.metrics_deduped == s2["imported"] == s1["imported"] > 0
        assert canon(glob.flush(now=1_700_000_010)) == expected
    finally:
        glob.shutdown()


# -- series sharding and the mesh (card against CPU) --------------------------


def _snaps_equal(a, b, what) -> None:
    import dataclasses

    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, (what, f.name)
            assert va.dtype == vb.dtype and va.shape == vb.shape, \
                (what, f.name)
            assert va.tobytes() == vb.tobytes(), (what, f.name)
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        assert pa.values[:pa.used].tobytes() == pb.values[:pb.used].tobytes()


def _shard_intervals(device, shards, shard_devices=None, micro=False,
                     stage_depth=64, set_store="staged", native=False):
    """Three mixed intervals (timers past the initial pool, sets,
    counters, gauges; micro-folds every other batch) through a worker
    with ``shards`` series shards on ``shard_devices``."""
    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates

    qs = device_quantiles([0.5, 0.9, 0.99], HistogramAggregates.from_names(
        ["min", "max", "count"]))
    w = tw.DeviceWorker(compression=100, stage_depth=stage_depth,
                        batch_size=64, initial_histo_rows=8,
                        initial_set_rows=8, micro_fold=micro,
                        micro_fold_rows=1, micro_fold_max_age_s=1e9,
                        set_store=set_store, series_shards=shards,
                        shard_devices=shard_devices, device=device)
    if native:
        w.attach_native()
    rng = np.random.default_rng(31)
    snaps = []
    for _ in range(3):
        for b in range(12):
            lines = []
            for i in range(300):
                k = (b * 300 + i) % 2311
                lines += [b"h%d:%.6f|ms|#a:%d" % (k, rng.normal(), k % 3),
                          b"c%d:%d|c" % (k % 97, 1 + k % 4),
                          b"g%d:%.6f|g" % (k % 89, rng.normal()),
                          b"s%d:v%d|s" % (k % 61, rng.integers(5000))]
            if native:
                for i in range(0, len(lines), 100):
                    w.ingest_datagram(b"\n".join(lines[i:i + 100]))
            else:
                for ln in lines:
                    w.process_metric(parse_metric(ln))
            if micro and b % 2 == 0 and w.micro_fold_due():
                w.micro_fold_once()
        snaps.append(w.flush(qs))
    return w, snaps


@pytest.mark.parametrize("micro", [False, True], ids=["batch", "micro"])
@pytest.mark.parametrize("stage_depth,store", [(64, "staged"), (4, "dense")],
                         ids=["staged", "spill-dense"])
def test_series_shards_on_one_card_equal_cpu(card, micro, stage_depth,
                                             store):
    """Four series shards on the one card (shard_devices repeats it): every
    flush is bitwise the CPU's sharded and unsharded flush, and the
    extract kernel launched once per shard."""
    before = ek.flush_extract.launches
    w, got = _shard_intervals(card, 4, [card] * 4, micro, stage_depth,
                              store)
    assert w._shard is not None and w.series_shards == 4
    assert ek.flush_extract.launches - before >= 3 * 4
    _, ref = _shard_intervals("cpu", 4, None, micro, stage_depth, store)
    _, base = _shard_intervals("cpu", 0, None, micro, stage_depth, store)
    for n, (a, b, c) in enumerate(zip(ref, got, base)):
        _snaps_equal(a, b, ("card against CPU", n))
        _snaps_equal(c, b, ("card against unsharded CPU", n))


def test_series_shards_native_on_the_card_equal_cpu(card):
    """The native ingest path into four shards on the card."""
    w, got = _shard_intervals(card, 4, [card] * 4, micro=True, native=True)
    assert w._shard is not None
    _, ref = _shard_intervals("cpu", 0, None, micro=True, native=True)
    for n, (a, b) in enumerate(zip(ref, got)):
        _snaps_equal(a, b, ("native", n))


def test_series_shards_on_two_cards_equal_cpu(card):
    """Shards on cuda:0 and cuda:1: every kernel wrapper enters its
    tensor's device and stream, so the second card's shards run there;
    the flushes are the CPU's bitwise."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    for store, depth in (("staged", 64), ("dense", 4)):
        w, got = _shard_intervals(devs[0], 2, devs, True, depth, store)
        assert w._shard.devices == tuple(devs)
        _, ref = _shard_intervals("cpu", 0, None, True, depth, store)
        for n, (a, b) in enumerate(zip(ref, got)):
            _snaps_equal(a, b, ("two cards", store, n))


def test_mesh_pool_on_the_card_equals_cpu(card):
    """The mesh global's pool on a (2 x 4) grid of the one card: raw
    samples and imported centroids merged across hosts, bitwise the CPU
    grid's, the extract kernel once per series shard."""
    from veneur_tpu_torch.distributed import mesh as tmesh

    rng = np.random.default_rng(9)
    rows = rng.integers(0, 5000, 200_000)
    vals = rng.gamma(2.0, 40.0, rows.size).astype(np.float32)
    outs, launched = [], []
    for grid in ([card] * 8, ["cpu"] * 8):
        pool = tmesh.MeshHistoPool(tmesh.make_mesh(8, 2, devices=grid),
                                   batch_size=65536)
        pool.add_samples_bulk(rows, vals, np.ones(rows.size, np.float32))
        for r in range(0, 5000, 7):
            pool.add_centroids(r, vals[r:r + 50], np.ones(50, np.float32),
                               1.5)
        before = ek.flush_extract.launches
        outs.append(pool.extract(np.array([0.5, 0.9, 0.99]), 5000))
        launched.append(ek.flush_extract.launches - before)
    assert launched == [4, 0]
    for k in outs[0]:
        assert outs[0][k].tobytes() == outs[1][k].tobytes(), k


def test_load_harness_holds_50k_on_the_card(card):
    """The loadgen drives a port server on the card through its UDP
    socket: 50,000 lines/s over two 1 s intervals held (loss at most 1%,
    cadence at least 0.75), the flush extract and HLL estimate kernels
    launched (the dense set store takes the workload's sets)."""
    from veneur_tpu_torch.loadgen import LoadHarness, WorkloadSpec, run_trial

    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 interval="1s", num_workers=1, num_readers=1,
                 percentiles=[0.5, 0.99], read_buffer_size_bytes=8 << 20,
                 tpu_set_store="dense")
    h = LoadHarness(cfg, WorkloadSpec(ring_lines=50_000), device="cuda")
    try:
        assert h.warmup(rate=50_000)
        k1, k5 = ek.flush_extract.launches, hll.estimate.launches
        trial = run_trial(h, 50_000, 2)
        k1, k5 = ek.flush_extract.launches - k1, hll.estimate.launches - k5
    finally:
        h.close()
    assert trial["passed"], {k: v for k, v in trial.items()
                             if k != "intervals"}
    assert k1 >= 1 and k5 >= 1


# -- the t-digest folds (K2a, K2b) ----------------------------------------------


@pytest.mark.parametrize("s,m", [(4_099, 192), (131_071, 256),
                                 (131_072, 192), (1_024, 1_152),
                                 (257, 4_000), (64, 8_192)])
def test_tdigest_compress_bitwise_equals_plain(card, s, m):
    """K2a against its plain version on the same card inputs, 16 edge rows
    in front (probe_td.edge_rows); [64, 8,192] rows exceed a block's
    shared memory and take the global scratch slab."""
    from veneur_tpu_torch.ops import tdigest as td

    means, w = probe_td.candidates(s, m, s + m, card)
    before = td.compress_rows.launches
    km, kw = td.compress_rows(means, w, 100.0, C)
    assert td.compress_rows.launches == before + 1
    pm, pw = td._compress_rows_plain(means, w, 100.0, C)
    assert _bitwise(km, pm) and _bitwise(kw, pw)


@pytest.mark.parametrize("k,n,edge", [(64, 256, False),
                                      (1_024, 65_536, False),
                                      (4_099, 300, False),
                                      (16, 4_096, True),
                                      (16_384, 262_144, False)])
def test_tdigest_add_batch_bitwise_equals_plain(card, k, n, edge):
    """K2b against its plain version, a fresh pool and then the rows it
    made (ragged K and N, the edge batch of probe_td.sample_batch)."""
    from veneur_tpu_torch.ops import tdigest as td

    batch = probe_td.sample_batch(k, n, k + n, card, edge)
    pool = probe_td.empty_pool(k, card)
    for _ in range(2):
        before = td.add_batch.launches
        got = td.add_batch(*pool, *batch)
        assert td.add_batch.launches == before + 1
        ref = td.add_batch_plain(*pool, *batch)
        for a, b in zip(list(got[:5]) + list(got[5]),
                        list(ref[:5]) + list(ref[5])):
            assert _bitwise(a, b)
        pool = tuple(ref[:5])


def test_tdigest_kernels_refuse_what_they_cannot_take(card):
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.ops import tdigest_kernel as tk

    m = torch.zeros((4, 2 * C), device=card)
    with pytest.raises(ValueError):
        td.compress_rows(m[:, :C - 1].contiguous(), m[:, :C - 1].contiguous(),
                         100.0, C)
    with pytest.raises(ValueError):
        td.compress_rows(m.t(), m.t(), 100.0, C)
    with pytest.raises(ValueError):
        tk.compress(m, m.cpu(), C, torch.zeros(100, device=card))
    pool = probe_td.empty_pool(4, card)
    one = torch.ones(8, device=card)
    with pytest.raises(ValueError):
        td.add_batch(*pool, torch.zeros(8, dtype=torch.int32, device=card),
                     one, one.cpu())


def test_worker_interval_never_reaches_the_plain_folds(card, monkeypatch):
    """No fallback: with the plain folds patched to raise, a card worker's
    interval (spill folds past the staging depth, the staged fold, an
    import merge) still runs, through K2b, K3 and K2a; its snapshot is
    the CPU twin's, computed after the patches are undone."""
    from veneur_tpu_torch.ops import tdigest as td

    def refuse(*_a, **_k):
        raise AssertionError("a t-digest fold reached its plain version "
                             "on the card")

    monkeypatch.setattr(td, "_compress_rows_plain", refuse)
    monkeypatch.setattr(td, "add_batch_plain", refuse)
    for name in ("_fold_staged_plain", "_histo_fold_staged",
                 "_expand_flat_planes"):
        monkeypatch.setattr(tw, name, refuse)
    kw = dict(stage_depth=16, batch_size=512, initial_histo_rows=64)
    qs = np.array([0.5, 0.9, 0.99])
    a0, b0 = td.compress_rows.launches, td.add_batch.launches
    f0 = tw.fold_staged.launches
    gpu = tw.DeviceWorker(**kw, device=card)
    for line in _lines(5):
        gpu.process_metric(parse_metric(line))
    snap_g = gpu.flush(qs)
    assert tw.fold_staged.launches > f0 and td.add_batch.launches > b0
    pool, imp = _import_inputs(8192, 16, 16)
    fields_g = [torch.from_numpy(a.copy()).to(card) for a in pool]
    tw._histo_import_step(*fields_g,
                          *(torch.from_numpy(a).to(card) for a in imp))
    assert td.compress_rows.launches > a0
    monkeypatch.undo()
    cpu = tw.DeviceWorker(**kw, device="cpu")
    for line in _lines(5):
        cpu.process_metric(parse_metric(line))
    snap_c = cpu.flush(qs)
    for name in ("quantile_values", "dmin", "dmax", "dsum", "dcount",
                 "drecip", "digest_means", "digest_weights"):
        assert _bitwise(torch.from_numpy(np.ascontiguousarray(
            getattr(snap_g, name))), torch.from_numpy(np.ascontiguousarray(
                getattr(snap_c, name)))), name
    fields_c = [torch.from_numpy(a.copy()) for a in pool]
    tw._histo_import_step(*fields_c, *(torch.from_numpy(a) for a in imp))
    for a, b in zip(fields_g, fields_c):
        assert _bitwise(a, b)


@pytest.mark.parametrize("s,m", [(4_099, 192), (1_024, 256),
                                 (257, 1_152), (64, 4 * 128)])
def test_tdigest_compress_digest_rows_bitwise_equals_plain(card, s, m):
    """K2a on candidates as the main path builds them (compressed digest
    rows side by side, then raw samples: probe_td.digest_candidates),
    where its sorted-run shortcuts run: bitwise its plain version."""
    from veneur_tpu_torch.ops import tdigest as td

    means, w = probe_td.digest_candidates(s, m, s + m, card)
    km, kw = td.compress_rows(means, w, 100.0, C)
    pm, pw = td._compress_rows_plain(means, w, 100.0, C)
    assert _bitwise(km, pm) and _bitwise(kw, pw)


def test_tdigest_add_batch_one_row(card):
    """Every sample of a 70,000-sample batch in one row (int64 rows): the
    sort's merge passes over the whole batch."""
    from veneur_tpu_torch.ops import tdigest as td

    rows, vals, wts = probe_td.sample_batch(4, 70_000, 9, card)
    rows = torch.full_like(rows, 2).long()
    pool = probe_td.empty_pool(4, card)
    for _ in range(2):
        got = td.add_batch(*pool, rows, vals, wts)
        ref = td.add_batch_plain(*pool, rows, vals, wts)
        for a, b in zip(list(got[:5]) + list(got[5]),
                        list(ref[:5]) + list(ref[5])):
            assert _bitwise(a, b)
        pool = tuple(ref[:5])


def test_tdigest_add_batch_runs_no_torch_sort(card, monkeypatch):
    """K2b sorts in its own kernels: with torch.sort and argsort patched
    to raise, a CUDA add_batch still returns the plain version's outputs
    bitwise (computed after the patches are undone)."""
    from veneur_tpu_torch.ops import tdigest as td

    def refuse(*_a, **_k):
        raise AssertionError("add_batch called a torch sort on the card")

    batch = probe_td.sample_batch(1_024, 65_536, 3, card)
    pool = probe_td.empty_pool(1_024, card)
    for name in ("sort", "argsort"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = td.add_batch(*pool, *batch)
    monkeypatch.undo()
    ref = td.add_batch_plain(*pool, *batch)
    for a, b in zip(list(got[:5]) + list(got[5]),
                    list(ref[:5]) + list(ref[5])):
        assert _bitwise(a, b)


def test_signed_zero_min_max_card_equals_cpu(card):
    """ops/exactnum's min and max, and K2b's, on the card bitwise the
    CPU, every NaN's sign included (probe_td.check_signed_zeros)."""
    from veneur_tpu_torch.ops import tdigest as td

    assert probe_td.check_signed_zeros(td)["bitwise"]


@pytest.mark.parametrize("w", [1, 9, 33, 64])
def test_signed_zero_fold_steps_card_equals_cpu(card, w):
    """The staged fold, a spill fold's scatter of lmin and lmax and the
    import step over rows that mix +0.0, -0.0 and NaN: the card's pool
    fields equal the CPU's, signs of zeros and NaNs included."""
    g = probe_td._gen(w, card)
    s = w + 1
    mixed = probe_td.mixed

    def fields(dev):
        f = [torch.full((s, C), float("inf")), torch.zeros((s, C))]
        f[0][:, 0], f[1][:, 0] = 1.0, 1.0
        f += [t.cpu() for t in mixed(g, (4, s), card)]
        z = torch.zeros(s)
        f = f[:4] + [z, z] + f[4:] + [z] * 6
        return [t.clone().to(dev) for t in f]

    base = fields("cpu")
    svals = mixed(g, (s, w), card).cpu()
    swts = torch.ones((s, w))
    vals = mixed(g, (1, 4 * w), card, nan=False)[0].cpu()
    lids = torch.randint(0, w, (4 * w,), generator=g, device=card).cpu()
    active = torch.cat([torch.arange(w), torch.tensor([w, w])])
    imp_min, imp_max = (t.cpu() for t in mixed(g, (2, w), card))
    imp_m = torch.full((w, 16), float("inf"))
    imp_w = torch.zeros((w, 16))
    imp_m[:, 0], imp_w[:, 0] = 0.5, 1.0
    out = {}
    for dev in ("cpu", card):
        f = [t.to(dev) for t in base]
        staged = tw._histo_fold_staged(*[t.clone() for t in f],
                                       svals.to(dev), swts.to(dev))
        fi = [t.clone() for t in f]
        tw._histo_ingest_step(*fi, active.to(dev), lids.to(dev),
                              vals.to(dev), torch.ones(4 * w, device=dev))
        fm = [t.clone() for t in f[:6]]
        tw._histo_import_step(*fm, torch.arange(w, device=dev),
                              imp_m.to(dev), imp_w.to(dev), imp_min.to(dev),
                              imp_max.to(dev), torch.zeros(w, device=dev))
        out[str(dev)] = [staged[i] for i in (2, 3, 6, 7)] + \
            [fi[i] for i in (2, 3, 6, 7)] + [fm[2], fm[3]]
    for a, b in zip(out["cpu"], out[str(card)]):
        b = b.cpu()
        assert _bitwise(a, b) and torch.equal(torch.signbit(a),
                                              torch.signbit(b))


# -- K3, the staged fold ---------------------------------------------------------


def _fold_cpu(fields, stage):
    """The plain chain over CPU copies of the card's inputs."""
    f = [t.cpu() for t in fields]
    if isinstance(stage, tw.FlatStage):
        st = tw.FlatStage(stage.vals.cpu(), None if stage.wts is None
                          else stage.wts.cpu(), stage.counts, stage.depth)
    else:
        st = tw.DenseStage(stage.vals.cpu(), stage.wts.cpu())
    return tw.fold_staged(f, st)


@pytest.mark.parametrize("form", ["dense", "flat_unit", "flat_weighted",
                                  "dense_short"])
@pytest.mark.parametrize("s,b", [(131_072, 64), (131_071, 64), (4_099, 64),
                                 (4_099, 40), (1_000, 1)])
def test_fold_staged_card_equals_cpu(card, form, s, b):
    """K3 on the card against the plain chain on the CPU over the same
    inputs (probe_td.fold_inputs: 16 edge rows of +-0.0, denormal, +-inf
    and NaN samples, denormal weights, empty, full and one-sample rows,
    scalars drawn from normal values, +-0.0, +-inf, NaN and denormals):
    dense and flat planes, unit and weighted, a mirror a third shorter
    than the pool; one launch a fold, all 14 fields bitwise."""
    fields, v, w, counts = probe_td.fold_inputs(s, b, s + b, card)
    stage = probe_td.stage_of(tw, "dense" if form == "dense_short" else form,
                              v, w, counts,
                              rows=s - s // 3 if form == "dense_short"
                              else None)
    before = tw.fold_staged.launches
    got = tw.fold_staged(fields, stage)
    assert tw.fold_staged.launches == before + 1
    ref = _fold_cpu(fields, stage)
    for a, r in zip(got, ref):
        assert _bitwise(a, r)


@pytest.mark.parametrize("form", ["dense", "flat_weighted"])
@pytest.mark.parametrize("b", [200, 4_000])
def test_fold_staged_wide_card_equals_cpu(card, form, b):
    """C + B past a warp's row: td_stage_rows, then K2a's block kernel
    (B = 200) or its global slab (B = 4,000), against the CPU."""
    fields, v, w, counts = probe_td.fold_inputs(257, b, b, card)
    stage = probe_td.stage_of(tw, form, v, w, counts)
    got = tw.fold_staged(fields, stage)
    ref = _fold_cpu(fields, stage)
    for a, r in zip(got, ref):
        assert _bitwise(a, r)


def test_fold_staged_four_shards_card_equals_cpu(card):
    """A sharded worker's staged fold (4 shards on the one card, each its
    own flat segment and counts block) against an unsharded CPU fold of
    the same rows: core/worker.DeviceWorker._fold_one_plane's split."""
    s, b = 8_192, 64
    fields, v, w, counts = probe_td.fold_inputs(s, b, 3, card)
    cut = s // 4
    parts = []
    for d in range(4):
        sl = slice(d * cut, (d + 1) * cut)
        st = probe_td.stage_of(tw, "flat_unit", v[sl], w[sl],
                               counts[sl].copy())
        parts.append(tw.fold_staged([f[sl].contiguous() for f in fields],
                                    st))
    ref = _fold_cpu(fields, probe_td.stage_of(tw, "flat_unit", v, w, counts))
    for i, r in enumerate(ref):
        assert _bitwise(torch.cat([p[i] for p in parts]), r)


def test_fold_staged_runs_no_torch_op(card, monkeypatch):
    """Between the staged samples' upload and the 14 fields no torch op
    runs: with torch's elementwise, cat, sort and index ops patched to
    raise, a card fold still returns the CPU's fields."""
    fields, v, w, counts = probe_td.fold_inputs(4_099, 64, 8, card)
    stage = probe_td.stage_of(tw, "flat_weighted", v, w, counts)

    def refuse(*_a, **_k):
        raise AssertionError("the staged fold ran a torch op on the card")

    for name in ("where", "cat", "sort", "cumsum", "clamp", "gather",
                 "searchsorted", "amin", "amax"):
        monkeypatch.setattr(torch, name, refuse)
    got = tw.fold_staged(fields, stage)
    monkeypatch.undo()
    ref = _fold_cpu(fields, stage)
    for a, r in zip(got, ref):
        assert _bitwise(a, r)


@pytest.mark.parametrize("b", probe_td.RANK_DEPTHS)
@pytest.mark.parametrize("kind", probe_td.RANK_KINDS)
def test_fold_staged_rank_path_card_equals_cpu(card, kind, b):
    """K3's rank path on the card against the CPU's plain chain, on
    probe_td.rank_case's edge rows (samples equal in order key to a
    centroid, +0.0 against -0.0, runs of equal samples, NaN and +-inf
    samples beside zero-weight slots, denormal samples and weights,
    empty, one-centroid and full rows, and rows whose pool part is
    unsorted: the network), dense, flat unit and flat weighted; all 14
    fields bitwise, and the card's tally of its rows' paths
    (tdigest_kernel.counting_paths) equal to probe_td.row_paths'."""
    from veneur_tpu_torch.ops import tdigest_kernel as tk

    fields_np, v, w, counts = probe_td.rank_case(kind, b)
    fields = [torch.from_numpy(a).to(card) for a in fields_np]
    for form in ("dense", "flat_unit", "flat_weighted"):
        wd = w
        if form == "flat_unit":
            wd = (np.arange(b)[None, :] < counts[:, None]).astype(np.float32)
        stage = probe_td.stage_of(tw, form, torch.from_numpy(v).to(card),
                                  torch.from_numpy(wd).to(card), counts)
        with tk.counting_paths(card) as paths:
            got = tw.fold_staged(fields, stage)
        want = np.bincount(probe_td.row_paths(fields_np[0], fields_np[1],
                                              v, wd), minlength=len(tk.PATHS))
        assert paths.cpu().tolist() == want.tolist(), (form, kind, b)
        ref = _fold_cpu(fields, stage)
        for a, r in zip(got, ref):
            assert _bitwise(a, r), (form, kind, b)


def test_fold_staged_denormal_rows_card_equals_cpu(card):
    """F7 on the card: rows of denormal samples and weights, and samples
    whose w / v or v * w is denormal, folded by K3 into pool scalars
    that are denormal too; the CPU's plain chain bitwise."""
    g = probe_td._gen(41, card)
    s, b = 512, 64
    fields, v, w, counts = probe_td.fold_inputs(s, b, 41, card, edges=False)
    den = (torch.randint(-2 ** 20, 2 ** 20, (s, b), generator=g,
                         device=card).float() * 1e-45)
    kind = torch.arange(s, device=card) % 4
    v = torch.where((kind == 0)[:, None], den, v)
    w = torch.where((kind == 1)[:, None], den.abs(), w)
    v = torch.where((kind == 2)[:, None], torch.full_like(v, 1e38), v)
    v = torch.where((kind == 3)[:, None], torch.full_like(v, 1e-20), v)
    w = torch.where((kind == 3)[:, None], torch.full_like(w, 1e-19), w)
    valid = torch.arange(b, device=card)[None, :] < torch.from_numpy(
        counts).to(card)[:, None]
    v = torch.where(valid, v, 0.0).contiguous()
    w = torch.where(valid, w, 0.0).contiguous()
    for form in ("dense", "flat_weighted"):
        stage = probe_td.stage_of(tw, form, v, w, counts)
        got = tw.fold_staged(fields, stage)
        ref = _fold_cpu(fields, stage)
        for a, r in zip(got, ref):
            assert _bitwise(a, r)


def test_flush_extract_without_quantiles_card_equals_cpu(card):
    """F10: a configuration without percentiles or the median extracts at
    P = 0; the card launches K1 at P = 1 and drops that column, bitwise
    the CPU's plain [S, 10]; a server on the card with the default
    configuration flushes its timers as a CPU server does."""
    fields = _pool(4_099, 13)
    q0 = torch.zeros(0)
    before = ek.flush_extract.launches
    got = ek.flush_extract(*(f.to(card) for f in fields), q0.to(card))
    assert ek.flush_extract.launches == before + 1
    assert got.shape == (4_099, 10) and _bitwise(
        got, ek.flush_extract(*fields, q0))

    def serve(dev):
        srv = Server(Config(interval="10s"), device=dev)
        try:
            for i in range(50):
                srv.process_metric_packet(f"t{i % 7}:{i}.25|ms".encode())
            return sorted((m.name, tuple(m.tags), m.type.name,
                           float(m.value)) for m in srv.flush(now=1))
        finally:
            srv.shutdown()

    got, ref = serve(card), serve("cpu")
    assert got == ref and len(got) == 21


# -- the ported tools (tools/port_tdigest_analysis.py,
# tools/port_fuzz_differential.py) and td.cdf --------------------------------


def test_cdf_card_equals_cpu(card):
    """td.cdf on digest rows (K2a's compress of main-path candidates, 16
    edge rows in front) at values on, next to, inside and past every
    row's min and max: bitwise the CPU's."""
    from veneur_tpu_torch.ops import exactnum as exn
    from veneur_tpu_torch.ops import tdigest as ttd

    s, m = 4_099, 192
    cm, cw = probe_td.digest_candidates(s, m, 11, card)
    cm[:16], cw[:16] = probe_td.edge_rows(m, card)
    means, w = ttd.compress_rows(cm, cw, probe_td.COMPRESSION, C)
    live = w > 0
    inf = float("inf")
    dmin = exn.amin(torch.where(live, means, inf), 1)
    dmax = exn.amax(torch.where(live, means, -inf), 1)
    u = torch.rand((s,), generator=probe_td._gen(5, card), device=card)
    cpu = [t.cpu() for t in (means, w, dmin, dmax)]
    for v in (dmin, dmax, torch.nextafter(dmin, dmin - 1),
              torch.nextafter(dmax, dmax + 1), dmin + u * (dmax - dmin),
              torch.where(u < 0.5, dmin - 1, dmax + 1)):
        assert _bitwise(ttd.cdf(means, w, dmin, dmax, v),
                        ttd.cdf(*cpu, v.cpu()))


def test_analysis_card_equals_cpu(card, tmp_path):
    for name, draw in sorted(analysis_tool.DISTRIBUTIONS.items()):
        got = analysis_tool.analyze(name, draw, 20_000, 100.0,
                                    str(tmp_path / "card"), device=card)
        ref = analysis_tool.analyze(name, draw, 20_000, 100.0,
                                    str(tmp_path / "cpu"), device="cpu")
        assert np.array_equal(got["estimated"].view(np.uint32),
                              ref["estimated"].view(np.uint32)), name
        assert got["max_q_err"] < analysis_tool.MAX_Q_ERR


@pytest.fixture(scope="module")
def fuzz_card(card):
    """The card, with the native libraries built before any target's
    clock starts."""
    from veneur_tpu_torch import native

    native.load_library()
    native.load_loadgen_library()
    return card


@pytest.mark.parametrize("name", [t for t in fuzz_tool.TARGETS
                                  if t != "query"])
def test_fuzz_target_on_card(fuzz_card, name):
    res = fuzz_tool.run_round([name], 1.0, 12, fuzz_card)
    assert not res["divergences"] and res["per_target"][name] > 0
    if name == "device_fallback":
        assert sum(res["stats"][name]["injected"].values()) > 0


def test_fuzz_query_on_card_diverges_as_on_the_cpu(fuzz_card):
    """The query target's quantile check diverges (F9, in both packages)
    on the same case on the card as on the CPU, the card's result bitwise
    the CPU's; its HLL (K5), CMS and top-k checks pass before it."""
    got = fuzz_tool.run_round(["query"], 60.0, 104, fuzz_card)
    ref = fuzz_tool.run_round(["query"], 60.0, 104, "cpu")
    gc, rc = got["stats"]["query"]["case"], ref["stats"]["query"]["case"]
    assert got["divergences"] and ref["divergences"]
    assert gc["index"] == rc["index"] > 0
    assert fuzz_tool.quantile_case_past_last_live(gc)
    assert _bitwise(torch.from_numpy(gc["got"]), torch.from_numpy(rc["got"]))
