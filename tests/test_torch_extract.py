"""The port's flush extract against the JAX package.

* ``flush_extract_plain`` against ``_histo_flush_extract`` +
  ``_pack_extract_columns``: bitwise (NaN positions equal).
* against ``pallas_kernels.flush_extract(interpret=True)`` at the JAX
  test's own rtol 1e-5 / atol 1e-3: the Pallas kernel takes its cumsum
  as a triangular matmul and has no bit contract with the XLA path.
* on the edge rows of tools/port_probe_extract.edge_pool (occupancy 0,
  1, 127, 128, equal means, weights near the f32 maximum, real-valued
  and widely spread weights whose Hillis-Steele prefixes are not
  monotone; denormal weights, means, dmin, dmax and row scalars): bitwise,
  q = 0 and q = 1 included. XLA on the CPU reads f32 denormals as zero
  and flushes denormal results; the port's plain version (and the
  kernel) flush the same reads and writes.
* the wrapper's routing and checks: a CPU tensor takes the plain version
  and launches nothing; bad inputs raise; the variant entry takes CUDA
  tensors only. ptxas's build report parses per variant.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.core import worker as jworker
from veneur_tpu.ops import pallas_kernels as pk
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch.ops import exactnum as texn
from veneur_tpu_torch.ops import extract_kernel as ek
from veneur_tpu_torch.ops import tdigest as ttd

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
import port_probe_extract as probe  # noqa: E402

C = 128


def _assert_bitwise(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape,
                                                       b.shape)
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    ok = ~np.isnan(a)
    assert np.array_equal(a[ok].view(np.uint32), b[ok].view(np.uint32)), what


def _fields(s, seed):
    """A 14-field pool state: ingested digests (rows 0 and 3 left empty)
    plus random compensated accumulators."""
    rng = np.random.default_rng(seed)
    n = 60 * s
    rows = rng.integers(0, s, n).astype(np.int32)
    rows[(rows == 0) | (rows == 3)] = 1
    vals = rng.normal(100.0, 25.0, n).astype(np.float32)
    wts = rng.choice([1.0, 2.0, 0.5], n).astype(np.float32)
    pool = jtd.init_pool(s, C)
    out = jtd.add_batch(*pool, jnp.asarray(rows), jnp.asarray(vals),
                        jnp.asarray(wts))
    means, weights, dmin, dmax, drecip = (np.array(a) for a in out[:5])
    extra = [rng.normal(0, 1, s).astype(np.float32) for _ in range(9)]
    return [means, weights, dmin, dmax, drecip, *extra]


def _jax_packed(fields, qs):
    out = jworker._histo_flush_extract(*(jnp.asarray(f) for f in fields),
                                       jnp.asarray(qs))
    return np.asarray(jworker._pack_extract_columns(*out))


def _torch_packed(fields, qs):
    return ek.flush_extract(*(torch.from_numpy(f) for f in fields),
                            torch.from_numpy(qs)).numpy()


@pytest.mark.parametrize("s,qs", [
    (8, [0.5]),
    (64, [0.5, 0.9, 0.99]),
    (200, [0.01, 0.25, 0.5, 0.75, 0.99]),
    (512, list(np.linspace(0.05, 0.95, 16))),
])
def test_plain_matches_xla_path_bitwise(s, qs):
    fields = _fields(s, s)
    q = np.asarray(qs, np.float32)
    before = ek.flush_extract.launches
    _assert_bitwise(_jax_packed(fields, q), _torch_packed(fields, q),
                    f"S={s}")
    assert ek.flush_extract.launches == before  # the CPU path launches none


@pytest.mark.parametrize("p", [1, 3, 8])
def test_plain_tracks_pallas_interpret(p):
    fields = _fields(32, 100 + p)
    q = np.linspace(0.05, 0.95, p).astype(np.float32)
    quant_p, dsum_p, dcount_p = pk.flush_extract(
        *(jnp.asarray(f) for f in fields[:4]), jnp.asarray(q),
        block_rows=16, interpret=True)
    packed = _torch_packed(fields, q)
    np.testing.assert_allclose(packed[:, :p], np.asarray(quant_p),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(packed[:, p + 2], np.asarray(dsum_p),
                               rtol=1e-5)
    np.testing.assert_allclose(packed[:, p + 3], np.asarray(dcount_p),
                               rtol=1e-6)


def _occupancy_rows():
    """tests/test_pallas.py's rows: empty, one centroid, two, full,
    skewed; padded slots hold +inf like a real pool."""
    s = 8
    means = np.full((s, C), np.inf, np.float32)
    weights = np.zeros((s, C), np.float32)
    means[1, 0], weights[1, 0] = 42.0, 5.0
    means[2, :2], weights[2, :2] = [10.0, 20.0], [1.0, 3.0]
    means[3], weights[3] = np.linspace(0, 127, C), 1.0
    means[4, :3], weights[4, :3] = [1.0, 2.0, 3.0], [1.0, 1e6, 1.0]
    nz = weights.sum(1) > 0
    dmin = np.where(nz, np.min(np.where(weights > 0, means, np.inf), 1),
                    np.inf).astype(np.float32)
    dmax = np.where(nz, np.max(np.where(weights > 0, means, -np.inf), 1),
                    -np.inf).astype(np.float32)
    zeros = [np.zeros(s, np.float32) for _ in range(10)]
    return [means, weights, dmin, dmax] + zeros


def test_mixed_occupancy_rows():
    fields = _occupancy_rows()
    q = np.array([0.01, 0.5, 0.99], np.float32)
    got = _torch_packed(fields, q)
    _assert_bitwise(_jax_packed(fields, q), got, "xla")
    quant_p, _, _ = pk.flush_extract(
        *(jnp.asarray(f) for f in fields[:4]), jnp.asarray(q),
        block_rows=8, interpret=True)
    np.testing.assert_allclose(got[:, :3], np.asarray(quant_p), rtol=1e-5,
                               atol=1e-3)
    assert np.isnan(got[0, :3]).all() and np.isfinite(got[1:5, :3]).all()
    assert (np.abs(got[1, :3] - 42.0) <= 1e-3).all()


def test_empty_pool_rows_nan():
    pool = ttd.init_pool(32, C, device="cpu")
    zeros = [torch.zeros(32) for _ in range(10)]
    out = ek.flush_extract(pool.means, pool.weights, pool.min, pool.max,
                           *zeros, torch.tensor([0.5]))
    assert out.shape == (32, 11)
    assert torch.isnan(out[:, 0]).all()
    assert (out[:, 1 + 3] == 0).all()  # dcount


def test_wrapper_refuses_bad_inputs():
    fields = [torch.from_numpy(f) for f in _fields(8, 1)]
    qs = torch.tensor([0.5])
    with pytest.raises(TypeError):
        ek.flush_extract(*fields[:-1], fields[-1].double(), qs)
    with pytest.raises(ValueError):
        ek.flush_extract(*fields[:-1], fields[-1][:4], qs)
    with pytest.raises(ValueError):
        ek.flush_extract(fields[0].t(), *fields[1:], qs)
    with pytest.raises(ValueError):
        ek.flush_extract(*fields, qs[None, :])
    with pytest.raises(ValueError):
        ek.flush_extract(*fields[:-1], fields[-1].to("meta"), qs)


def _edge_fields(s=400):
    return probe.edge_pool(s, seed=13)


@pytest.mark.parametrize("qs", [[1.0], [0.0, 0.5, 0.99],
                                list(np.linspace(0.0, 1.0, 16))])
def test_plain_matches_xla_on_edge_rows(qs):
    fields = _edge_fields()
    # the real-valued rows do give scans that are not monotone
    w_cum = texn.cumsum(torch.from_numpy(fields[1])).numpy()
    finite = np.isfinite(w_cum).all(axis=1)
    assert (np.diff(w_cum[finite], axis=1) < 0).any()
    q = np.asarray(qs, np.float32)
    _assert_bitwise(_jax_packed(fields, q), _torch_packed(fields, q),
                    f"edge rows, qs={qs}")


def test_denormal_weights_read_as_zero_by_xla_on_cpu():
    fields = _edge_fields(22)
    row = probe.EDGE_KINDS.index("denormal")
    q = np.array([0.5], np.float32)
    jax_row = _jax_packed(fields, q)[row]
    torch_row = _torch_packed(fields, q)[row]
    assert 0 < fields[1][row].max() < np.finfo(np.float32).tiny
    assert np.isnan(jax_row[0]) and jax_row[1 + 3] == 0  # no weight left
    _assert_bitwise(jax_row, torch_row, "denormal weights")


def test_denormal_scalars_flushed_where_xla_flushes_them():
    """Denormal means, dmin, dmax and row scalars: arithmetic reads them
    as zero, the dmin/dmax/lmin/lmax columns copy their bits, and a
    denormal sum of two normal scalars (lsum + lsum_c) is flushed."""
    fields = _edge_fields(22)
    row = probe.EDGE_KINDS.index("denormal_scalars")
    p = 3
    q = np.array([0.0, 0.5, 1.0], np.float32)
    jax_row = _jax_packed(fields, q)[row]
    torch_row = _torch_packed(fields, q)[row]
    _assert_bitwise(jax_row, torch_row, "denormal scalars")
    tiny = np.finfo(np.float32).tiny
    assert 0 < abs(fields[2][row]) < tiny and 0 < abs(fields[3][row]) < tiny
    assert torch_row[p + 0] == fields[2][row] != 0  # dmin copied as is
    assert (torch_row[:p] == 0).all()  # every midpoint read as zero
    assert torch_row[p + 7] == 0  # 1.5e-38 + -1.2e-38 flushed


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flush_extract_kernelILi8EEEvNS_6FieldsEii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flush_extract_kernelILi8EEEvNS_6FieldsEii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 102 registers, used 0 barriers
ptxas info    : Compile time = 177.108 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flush_extract_kernelILi1EEEvNS_6FieldsEii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flush_extract_kernelILi1EEEvNS_6FieldsEii
    24 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, 16 bytes smem, 400 bytes cmem[0]
"""


def test_ptxas_report_parses_per_variant():
    rep = ek.parse_ptxas(_PTXAS)
    assert rep == {
        8: {"registers": 102, "spill_stores": 0, "spill_loads": 0,
            "local_bytes": 0, "static_smem_bytes": 0},
        1: {"registers": 40, "spill_stores": 8, "spill_loads": 4,
            "local_bytes": 24, "static_smem_bytes": 16}}


def test_variant_entry_takes_cuda_tensors_only():
    fields = [torch.from_numpy(f) for f in _fields(8, 1)]
    qs = torch.tensor([0.5])
    before = dict(ek.variant_launches)
    with pytest.raises(ValueError, match="cuda"):
        ek._flush_extract_variant(ek.ROWS_PER_WARP, *fields, qs)
    with pytest.raises(ValueError, match="rows per warp"):
        ek._flush_extract_variant(3, *fields, qs)
    assert ek.variant_launches == before
    assert ek.ROWS_PER_WARP in ek.VARIANTS
