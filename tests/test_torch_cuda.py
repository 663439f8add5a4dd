"""The PyTorch port on the card: the flush extract kernel against its
plain version, and the CUDA worker and server against their CPU twins.

Every test here is marked ``cuda`` and skips without a card. On a card
machine (no JAX needed) run them with

    VENEUR_TPU_TEST_REAL=1 python -m pytest tests/test_torch_cuda.py -m cuda

(VENEUR_TPU_TEST_REAL keeps tests/conftest.py from importing JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.ops import extract_kernel as ek
from veneur_tpu_torch.protocol.dogstatsd import parse_metric

pytestmark = pytest.mark.cuda

C = 128


@pytest.fixture
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


@pytest.mark.parametrize("s", [1, 7, 4099, 65536])
@pytest.mark.parametrize("p", [1, 3, 16])
def test_kernel_bitwise_equals_plain(card, s, p):
    fields = _pool(s, s * 31 + p)
    qs = torch.from_numpy(np.linspace(0.01, 0.99, p).astype(np.float32))
    plain = ek.flush_extract_plain(*fields, qs)
    before = ek.flush_extract.launches
    got = ek.flush_extract(*(f.to(card) for f in fields), qs.to(card))
    torch.cuda.synchronize()
    assert ek.flush_extract.launches == before + 1
    assert _bitwise(got, plain)


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
