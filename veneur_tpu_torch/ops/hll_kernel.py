"""The HyperLogLog kernels for Hopper: build, load and launch.

``csrc/hll.cu`` holds two hand-written CUDA C++ kernels for sm_90a (see
the source for their design and bounds):

* ``hll_insert`` — the batched scatter-max of packed (row, register,
  rank) update records (``ops/hll.pack_updates``) into an int8[S, m]
  register pool, in place. It replaces ``insert_batch`` of
  veneur_tpu/ops/hll.py. ``noop`` launches an empty kernel at the
  insert's block size: the launch floor the insert is measured against.
* ``hll_estimate`` — the per-row cardinality estimate, int8[S, m] →
  f32[S], in the reference's association. It replaces ``estimate`` of
  veneur_tpu/ops/hll.py.

The library is built with nvcc at first use (ops/nvcc.py, with the
flush extract's flags) and loaded with ctypes. The launchers here
take CUDA tensors only and check what the kernels take; ops/hll.py's
``insert_batch`` and ``estimate`` are the wrappers the port calls, with
their plain versions beside them and their launch counts.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import nvcc

_SRC = nvcc.CSRC / "hll.cu"

_lib = None
_lib_lock = threading.Lock()
# device-resident tables, by (what, precision, device)
_tables: dict = {}


def build():
    """Compile csrc/hll.cu unless this exact build exists; the path."""
    return nvcc.build(_SRC, nvcc.FLAGS)


def parse_ptxas(text: str) -> dict[str, dict[str, int]]:
    """Per kernel, ``hll_insert`` and ``hll_estimate`` (the worst of its
    instances, one per precision), what ptxas reported (registers,
    spills, local and static shared memory; ops/nvcc.parse_ptxas)."""
    return nvcc.parse_ptxas(text, r"(hll_insert|hll_estimate)_kernel")


def build_report() -> dict[str, dict[str, int]]:
    """ptxas's report of the current build, per kernel."""
    return parse_ptxas(nvcc.ptxas_report(_SRC, nvcc.FLAGS))


def load():
    """The ctypes handle of the built library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.hll_insert_launch.argtypes = [vp, vp, ll, ll, ci, vp]
            lib.hll_insert_launch.restype = ci
            lib.hll_noop_launch.argtypes = [ci, vp]
            lib.hll_noop_launch.restype = ci
            lib.hll_insert_threads_per_block.restype = ci
            lib.hll_estimate_launch.argtypes = [vp, vp, vp, vp, ci, ci,
                                                ctypes.c_float,
                                                ctypes.c_float, vp]
            lib.hll_estimate_launch.restype = ci
            lib.hll_threads_per_block.restype = ci
            _lib = lib
        return _lib


def _table(what: str, precision: int, device: torch.device) -> torch.Tensor:
    key = (what, precision, str(device))
    t = _tables.get(key)
    if t is None:
        a = (exn.exp2_neg_table() if what == "ept"
             else exn.hll_linear_table(precision))
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        _tables[key] = t
    return t


def _check_pool(registers: torch.Tensor) -> int:
    if registers.device.type != "cuda":
        raise ValueError(f"the HLL kernels run on cuda, not "
                         f"{registers.device.type}")
    if registers.dtype != torch.int8 or registers.dim() != 2:
        raise TypeError("the register pool must be int8[S, m]")
    if not registers.is_contiguous():
        raise ValueError("the register pool must be contiguous")
    m = registers.shape[1]
    if m < 16 or m > 1 << 18 or m & (m - 1):
        raise ValueError(f"m = {m} registers per row: the kernels take "
                         f"2^p, 4 <= p <= 18")
    if registers.data_ptr() % 16:
        raise ValueError("the register pool must be 16-byte aligned")
    return m


def insert(registers: torch.Tensor, recs: torch.Tensor) -> torch.Tensor:
    """Launch hll_insert: scatter-max the int32[N, 2] records (row,
    register | rank << 24) into ``registers`` in place, both on one
    card, one update a thread."""
    m = _check_pool(registers)
    if recs.device != registers.device or recs.dtype != torch.int32 \
            or recs.dim() != 2 or recs.shape[1] != 2 \
            or not recs.is_contiguous() or recs.data_ptr() % 8:
        raise ValueError(f"the records must be a contiguous, 8-byte aligned "
                         f"int32[N, 2] on {registers.device}")
    n = recs.shape[0]
    if n == 0:
        return registers
    lib = load()
    with torch.cuda.device(registers.device):
        stream = torch.cuda.current_stream(registers.device).cuda_stream
        rc = lib.hll_insert_launch(registers.data_ptr(), recs.data_ptr(), n,
                                   registers.numel(), m, stream)
    nvcc.check(rc, "hll_insert launch failed")
    return registers


def noop(grid: int, device: torch.device) -> None:
    """Launch the empty kernel at ``grid`` blocks of the insert's size."""
    lib = load()
    with torch.cuda.device(device):
        rc = lib.hll_noop_launch(
            grid, torch.cuda.current_stream(device).cuda_stream)
    nvcc.check(rc, "hll_noop launch failed")


def estimate(registers: torch.Tensor, precision: int) -> torch.Tensor:
    """Launch hll_estimate: f32[S] estimates of the pool's rows."""
    m = _check_pool(registers)
    if m != 1 << precision:
        raise ValueError(f"precision {precision} needs {1 << precision} "
                         f"registers per row, the pool has {m}")
    s = registers.shape[0]
    out = torch.empty((s,), dtype=torch.float32, device=registers.device)
    if s == 0:
        return out
    if s >= 1 << 31:
        raise ValueError("the estimate kernel takes fewer than 2^31 rows")
    ept = _table("ept", precision, registers.device)
    lin = _table("linear", precision, registers.device)
    lib = load()
    with torch.cuda.device(registers.device):
        stream = torch.cuda.current_stream(registers.device).cuda_stream
        rc = lib.hll_estimate_launch(
            registers.data_ptr(), ept.data_ptr(), lin.data_ptr(),
            out.data_ptr(), s, precision,
            float(exn.hll_alpha_m2(precision)),
            float(np.float32(2.5 * m)), stream)
    nvcc.check(rc, "hll_estimate launch failed")
    return out
