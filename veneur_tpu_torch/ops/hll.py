"""Batched HyperLogLog, PyTorch twin of veneur_tpu/ops/hll.py.

A pool of S sketches is one dense ``int8[S, 2^p]`` register tensor;
values are hashed on the host and split there into (register index,
rank) (``split_hashes``, NumPy, copied from the reference). The device
work is two functions, each a hand-written CUDA kernel on the card
(ops/hll_kernel.py, csrc/hll.cu) with its plain PyTorch version beside
it:

* ``insert_batch`` — scatter-max of (row, register, rank) updates,
  indexed as the reference's device program indexes: a flat slot in
  [-S·m, -1] wraps once, every other slot outside [0, S·m) is dropped
  (its ``mode="drop"``). The port updates the pool IN PLACE and returns
  it (the reference returns a new array). The kernel takes one packed
  8-byte record per update, packed on the host (``pack_updates``);
  ``HostInserter`` feeds it host batches through reused pinned buffers,
  one copy each.
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

from typing import Optional

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


# the register index takes the low 24 bits of a record's second word
# (p <= 18 needs 18), the rank the high 8
_IDX_BITS = 24


def insert_batch_plain(registers: torch.Tensor, rows: torch.Tensor,
                       reg_idx: torch.Tensor, rank: torch.Tensor
                       ) -> torch.Tensor:
    """Scatter-max the updates into ``registers`` in place. The flat slot
    row·m + idx is formed in 64 bits; the reference forms row·m in int32,
    which is the same value for every row in [-S, S] while S·m < 2^31 (no
    pool the worker builds reaches 2^31 bytes). A slot in [-S·m, -1]
    wraps once to slot + S·m (jnp indexing); every other slot outside
    [0, S·m) is dropped."""
    s, m = registers.shape
    total = s * m
    flat = rows.to(torch.int64) * m + reg_idx.to(torch.int64)
    flat = torch.where(flat < 0, flat + total, flat)
    ok = (flat >= 0) & (flat < total)
    registers.view(-1).scatter_reduce_(0, flat[ok],
                                       rank.to(torch.int8)[ok], "amax")
    return registers


def pack_updates(rows: np.ndarray, reg_idx: np.ndarray, rank: np.ndarray,
                 out: np.ndarray) -> int:
    """The kernel's records, packed on the host into the int32[>= N, 2]
    ``out`` (say a pinned buffer's view): the row, and register |
    (uint8) rank << 24. Registers must lie in [0, 2^24). Returns N."""
    n = len(rows)
    idx = np.ascontiguousarray(reg_idx, np.int32).view(np.uint32)
    # one pass for both bounds: a negative index reads as >= 2^31
    if n and int(idx.max()) >> _IDX_BITS:
        raise ValueError("register indices must lie in [0, 2^24)")
    # built contiguous, then written into the strided column
    hi = np.left_shift(np.ascontiguousarray(rank, np.int8).view(np.uint8),
                       _IDX_BITS, dtype=np.uint32)
    hi |= idx
    out[:n, 0] = rows
    out[:n, 1] = hi.view(np.int32)
    return n


def records(rows: torch.Tensor, reg_idx: torch.Tensor, rank: torch.Tensor,
            device) -> torch.Tensor:
    """The updates as the kernel's int32[N, 2] records on ``device``,
    packed on the host (``pack_updates``) and uploaded in one copy."""
    host = [t.cpu().numpy() for t in (rows, reg_idx, rank)]
    out = np.empty((len(host[0]), 2), np.int32)
    pack_updates(*host, out)
    return torch.from_numpy(out).to(device)


def _insert_records(registers: torch.Tensor, recs: torch.Tensor
                    ) -> torch.Tensor:
    """The one place hll_insert launches (and is counted)."""
    out = hll_kernel.insert(registers, recs)
    insert_batch.launches += 1
    return out


def insert_batch(registers: torch.Tensor, rows: torch.Tensor,
                 reg_idx: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Batch-max (row, register, rank) updates into the pool, in place;
    returns the pool. rows, reg_idx: int32[N]; rank: int8[N], on the
    pool's device."""
    if registers.device.type == "cpu":
        return insert_batch_plain(registers, rows, reg_idx, rank)
    return _insert_records(registers, records(rows, reg_idx, rank,
                                              registers.device))


insert_batch.launches = 0


class HostInserter:
    """Inserts batches of host (numpy) updates into a register pool.

    A CPU pool takes the plain version. For a pool on the card each batch
    is packed into one of two reused pinned buffers, copied in one
    non-blocking copy into a reused device buffer and inserted by one
    kernel launch, with no padding: the kernel takes N. A pinned buffer is
    written again only after the event of its last copy, two batches
    back, has passed; the device buffer is safe to reuse because its copy
    and the launches that read it run in order on one stream."""

    def __init__(self) -> None:
        self._host: list = [None, None]  # (pinned tensor, numpy view)
        self._events: list = [None, None]
        self._recs: Optional[torch.Tensor] = None
        self._turn = 0

    def insert(self, registers: torch.Tensor, rows: np.ndarray,
               reg_idx: np.ndarray, rank: np.ndarray) -> torch.Tensor:
        if registers.device.type == "cpu":
            return insert_batch_plain(
                registers, torch.from_numpy(np.asarray(rows, np.int32)),
                torch.from_numpy(np.asarray(reg_idx, np.int32)),
                torch.from_numpy(np.asarray(rank, np.int8)))
        n = len(rows)
        if n == 0:
            return registers
        i = self._turn
        self._turn ^= 1
        dev = registers.device
        if self._events[i] is not None:
            self._events[i].synchronize()
        cap = exn.next_pow2(n, 1024)
        if self._host[i] is None or self._host[i][1].shape[0] < n:
            buf = torch.empty((cap, 2), dtype=torch.int32, pin_memory=True)
            self._host[i] = (buf, buf.numpy())
        buf, view = self._host[i]
        pack_updates(rows, reg_idx, rank, view)
        recs = self._recs
        if recs is None or recs.device != dev or recs.shape[0] < n:
            recs = self._recs = torch.empty((cap, 2), dtype=torch.int32,
                                            device=dev)
        recs = recs[:n]
        recs.copy_(buf[:n], non_blocking=True)
        if self._events[i] is None:
            self._events[i] = torch.cuda.Event()
        self._events[i].record(torch.cuda.current_stream(dev))
        return _insert_records(registers, recs)


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
