"""Batched HyperLogLog, PyTorch twin of veneur_tpu/ops/hll.py.

A pool of S sketches is one dense ``int8[S, 2^p]`` register tensor;
values are hashed on the host and split there into (register index,
rank) (``split_hashes``, NumPy, copied from the reference). The device
work is two functions, each a hand-written CUDA kernel on the card
(ops/hll_kernel.py, csrc/hll.cu) with its plain PyTorch version beside
it:

* ``insert_batch`` — scatter-max of (row, register, rank) updates, out
  of range entries dropped (the reference's ``mode="drop"``). The port
  updates the pool IN PLACE and returns it (the reference returns a new
  array).
* ``estimate`` — harmonic mean with linear counting below 2.5m, the sum
  of 2^-register in the reference's halving-tree association, the
  transcendentals read from the reference's f32 tables (ops/exactnum.py).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. ``insert_batch.launches`` and ``estimate.launches`` count
kernel launches, nothing else. Both functions are bitwise the
reference's: integer max does not depend on the order of the updates,
and the estimate's association is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from veneur_tpu_torch.device import resolve
from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import hll_kernel

DEFAULT_PRECISION = 14  # matches reference (axiomhq) precision
# rows per step of the plain estimate: its f32 [rows, m] intermediates
# stay near 64 MiB whatever the pool's size
_PLAIN_ESTIMATE_ELEMS = 1 << 24


def num_registers(precision: int = DEFAULT_PRECISION) -> int:
    return 1 << precision


def init_pool(num_rows: int, precision: int = DEFAULT_PRECISION,
              device=None) -> torch.Tensor:
    """An empty int8 pool on ``device`` (none asked for: the card)."""
    return torch.zeros((num_rows, num_registers(precision)),
                       dtype=torch.int8, device=resolve(device))


def pool_from_numpy(regs: np.ndarray, device) -> torch.Tensor:
    """A register pool built by the JAX package (int8[S, m]) as a tensor
    on ``device``: the set path's state carried across."""
    return torch.from_numpy(np.array(regs, np.int8, copy=True)).to(device)


def split_hashes(
    hashes: np.ndarray, precision: int = DEFAULT_PRECISION
) -> tuple[np.ndarray, np.ndarray]:
    """Split 64-bit hashes into (register index, rank) host-side.

    index = top p bits; rank = #leading zeros of the remaining 64-p bits,
    plus one (capped at 64-p+1 when those bits are all zero).
    """
    h = hashes.astype(np.uint64)
    idx = (h >> np.uint64(64 - precision)).astype(np.int32)
    w = (h << np.uint64(precision)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    # clz via float64 exponent: highest set bit of w is frexp-exponent - 1.
    # w == 0 → rank = 64-p+1. Values within 2^-52 of a power of two can
    # round the exponent up by one; that's a 1-in-2^40 rank-off-by-one on a
    # random hash — far below HLL's intrinsic error.
    nonzero = w != 0
    _, exp = np.frexp(w.astype(np.float64))
    clz = 64 - exp
    rank = np.where(nonzero, clz + 1, 64 - precision + 1).astype(np.int8)
    rank = np.minimum(rank, np.int8(64 - precision + 1))
    return idx, rank


def insert_batch_plain(registers: torch.Tensor, rows: torch.Tensor,
                       reg_idx: torch.Tensor, rank: torch.Tensor
                       ) -> torch.Tensor:
    """Scatter-max the updates into ``registers`` in place; entries whose
    flat slot row·m + idx falls outside [0, S·m) are dropped."""
    s, m = registers.shape
    flat = rows.to(torch.int64) * m + reg_idx.to(torch.int64)
    ok = (flat >= 0) & (flat < s * m)
    registers.view(-1).scatter_reduce_(0, flat[ok],
                                       rank.to(torch.int8)[ok], "amax")
    return registers


def insert_batch(registers: torch.Tensor, rows: torch.Tensor,
                 reg_idx: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Batch-max (row, register, rank) updates into the pool, in place;
    returns the pool. rows, reg_idx: int32[N]; rank: int8[N] (padding:
    rank 0, a no-op since registers are >= 0)."""
    if registers.device.type == "cpu":
        return insert_batch_plain(registers, rows, reg_idx, rank)
    out = hll_kernel.insert(registers, rows, reg_idx, rank)
    insert_batch.launches += 1
    return out


insert_batch.launches = 0


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Register-wise max — the associative cross-host reduce
    (reference Set.Combine, samplers/samplers.go:423-435)."""
    return torch.maximum(a, b)


def _rank_index(registers: torch.Tensor) -> torch.Tensor:
    """The reference's gather index for ept[ranks]: a negative rank wraps
    once (r + 65) and the result clamps into [0, 64] (jnp indexing)."""
    r = registers.to(torch.int64)
    return torch.clamp(torch.where(r < 0, r + 65, r), 0, 64)


def estimate_plain(registers: torch.Tensor,
                   precision: int = DEFAULT_PRECISION) -> torch.Tensor:
    """Cardinality estimate per row, int8[S, m] → f32[S], as plain tensor
    ops, a block of rows at a time."""
    dev = registers.device
    m = num_registers(precision)
    if registers.shape[-1] != m:
        raise ValueError(f"precision {precision} needs {m} registers per "
                         f"row, the pool has {registers.shape[-1]}")
    ept = torch.from_numpy(exn.exp2_neg_table()).to(dev)
    lin = torch.from_numpy(exn.hll_linear_table(precision)).to(dev)
    alpha = torch.tensor(exn.hll_alpha_m2(precision), device=dev)
    thresh = torch.tensor(np.float32(2.5 * m), device=dev)
    s = registers.shape[0]
    out = torch.empty((s,), dtype=torch.float32, device=dev)
    step = max(1, _PLAIN_ESTIMATE_ELEMS // m)
    for a in range(0, s, step):
        regs = registers[a:a + step]
        inv_sum = exn.tsum(ept[_rank_index(regs)])  # Σ 2^-reg, pinned
        zeros = (regs == 0).sum(dim=-1, dtype=torch.int32)
        raw = torch.div(alpha, inv_sum)
        linear = lin[zeros.to(torch.int64)]
        use_linear = (raw <= thresh) & (zeros > 0)
        out[a:a + step] = torch.where(use_linear, linear, raw)
    return out


def estimate(registers: torch.Tensor, precision: int = DEFAULT_PRECISION
             ) -> torch.Tensor:
    """Cardinality estimate per row: int8[S, m] → f32[S] (harmonic mean,
    linear counting below 2.5m)."""
    if registers.device.type == "cpu":
        return estimate_plain(registers, precision)
    out = hll_kernel.estimate(registers, precision)
    estimate.launches += 1
    return out


estimate.launches = 0


# ---------------------------------------------------------------------------
# Host-side helpers (codec / single-sketch use)


def registers_to_bytes(row: np.ndarray) -> bytes:
    """Dense register row → wire bytes (see distributed/codec.py)."""
    return np.asarray(row, dtype=np.int8).tobytes()


def registers_from_bytes(data: bytes, precision: int = DEFAULT_PRECISION
                         ) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.int8)
    if arr.shape[0] != num_registers(precision):
        raise ValueError(
            f"HLL payload has {arr.shape[0]} registers, expected"
            f" {num_registers(precision)}"
        )
    return arr
