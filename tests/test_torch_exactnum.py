"""Order-pinned scans of the PyTorch port against the JAX package.

Same numpy-seeded inputs through veneur_tpu/ops (exactnum, segments) and
veneur_tpu_torch/ops; every result must be bitwise equal, including at
widths that are not powers of two (the tree pads, the scan does not).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import exactnum as jexn
from veneur_tpu.ops import segments as jseg
from veneur_tpu_torch.ops import exactnum as texn
from veneur_tpu_torch.ops import segments as tseg

WIDTHS = [1, 2, 3, 7, 64, 100, 128, 130, 257]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint8)


def _assert_bitwise(jax_out, torch_out):
    j = np.asarray(jax_out)
    t = torch_out.numpy()
    assert j.shape == t.shape and j.dtype == t.dtype, (j.dtype, t.dtype)
    assert np.array_equal(np.isnan(j), np.isnan(t))
    ok = ~np.isnan(j)
    assert np.array_equal(j[ok].view(np.uint32), t[ok].view(np.uint32))


def _data(shape, seed):
    """f32 with ties, zeros and a wide dynamic range."""
    rng = np.random.default_rng(seed)
    x = rng.lognormal(0.0, 3.0, shape).astype(np.float32)
    x[rng.random(shape) < 0.2] = 0.0
    x[rng.random(shape) < 0.2] = 1.0
    return x


@pytest.mark.parametrize("n", WIDTHS)
def test_cumsum_bitwise(n):
    x = _data((5, n), n)
    _assert_bitwise(jexn.cumsum(jnp.asarray(x)),
                    texn.cumsum(torch.from_numpy(x)))


@pytest.mark.parametrize("n", WIDTHS)
def test_tsum_bitwise(n):
    x = _data((5, n), 100 + n)
    _assert_bitwise(jexn.tsum(jnp.asarray(x)),
                    texn.tsum(torch.from_numpy(x)))


def test_block_maps_nan_to_zero_only():
    x = np.array([1.5, np.nan, -0.0, np.inf, -np.inf, 3e-39], np.float32)
    _assert_bitwise(jexn.block(jnp.asarray(x)),
                    texn.block(torch.from_numpy(x)))


@pytest.mark.parametrize("compression", [100.0, 50.5, 20.0])
def test_kscale_bucket_bitwise(compression):
    rng = np.random.default_rng(int(compression))
    table = texn.kscale_boundaries(compression)
    assert np.array_equal(table, jexn.kscale_boundaries(compression))
    # the boundaries themselves, their neighbours, the ends and noise
    q = np.concatenate([
        table, np.nextafter(table, np.float32(0)),
        np.nextafter(table, np.float32(1)),
        np.array([0.0, 1.0], np.float32),
        rng.random(500).astype(np.float32)])
    q = q[: len(q) // 2 * 2].reshape(2, -1)
    j = np.asarray(jexn.kscale_bucket(jnp.asarray(q), compression))
    t = texn.kscale_bucket(torch.from_numpy(q), compression).numpy()
    assert np.array_equal(j, t)


def test_table_builders_match():
    assert texn.next_pow2(5) == jexn.next_pow2(5) == 8
    assert texn.next_pow2(1) == jexn.next_pow2(1)
    assert np.array_equal(texn.exp2_neg_table(), jexn.exp2_neg_table())


@pytest.mark.parametrize("shape", [(4, 1), (3, 7), (6, 128), (2, 200)])
@pytest.mark.parametrize("p_mark", [0.0, 0.1, 0.6])
def test_last_marked_carry_bitwise(shape, p_mark):
    rng = np.random.default_rng(len(shape) * 1000 + shape[-1])
    mask = rng.random(shape) < p_mark
    a = _data(shape, 1)
    b = _data(shape, 2)
    ja, jb = jseg.last_marked_carry(jnp.asarray(mask), jnp.asarray(a),
                                    jnp.asarray(b))
    ta, tb = tseg.last_marked_carry(torch.from_numpy(mask),
                                    torch.from_numpy(a), torch.from_numpy(b))
    _assert_bitwise(ja, ta)
    _assert_bitwise(jb, tb)


@pytest.mark.parametrize("n", [1, 127, 128, 129, 300, 1000])
def test_segmented_cumsum_bitwise(n):
    rng = np.random.default_rng(n)
    v = _data((n,), n + 7)
    starts = rng.random(n) < 0.05
    _assert_bitwise(
        jseg.segmented_cumsum(jnp.asarray(v), jnp.asarray(starts)),
        tseg.segmented_cumsum(torch.from_numpy(v), torch.from_numpy(starts)))
