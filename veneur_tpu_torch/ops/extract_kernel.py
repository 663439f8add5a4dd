"""The flush extract: the hand-written Hopper kernel and its plain version.

``flush_extract`` computes, for every digest row of a pool, the quantiles
at ``qs`` plus the ten aggregate columns the flusher reads, packed into
one f32[S, P+10] array (the JAX package's ``_histo_flush_extract``
followed by ``_pack_extract_columns``, core/worker.py). It replaces the
TPU kernel ``_extract_kernel`` of veneur_tpu/ops/pallas_kernels.py.

* On a CUDA tensor it launches ``csrc/flush_extract.cu`` (one warp per
  row, see the source for the design and its memory bound) or raises.
  The library is built with nvcc for sm_90a at first use, into
  ``build/kernels/`` at the repository root, and loaded with ctypes.
* On a CPU tensor it runs ``flush_extract_plain``: the same function as
  PyTorch ops (ops/tdigest.quantile, row_sum, row_count and the pack).

Both follow the XLA path's bit contract, so the kernel's output is
bitwise the plain version's on the same inputs (NaN where a row is empty).
``flush_extract.launches`` counts kernel launches, nothing else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from veneur_tpu_torch.ops import tdigest as td

CAPACITY = 128  # centroids per row the kernel takes
MAX_QUANTILES = 16  # quantiles per call the kernel takes
AGG_COLUMNS = 10

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "flush_extract.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the flush extract kernel is "
                           "built from csrc/flush_extract.cu at first use")
    return path


def library_path() -> Path:
    """Where the built library lives: named by the source's and flags'
    hash, so an edited source never loads a stale build."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libflush_extract-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile csrc/flush_extract.cu with nvcc unless this exact build
    exists; returns the library path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load():
    """The ctypes handle of the built library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.flush_extract_launch.argtypes = [vp] * 16 + [ci, ci, ci, vp]
            lib.flush_extract_launch.restype = ci
            lib.flush_extract_threads_per_block.restype = ci
            _lib = lib
        return _lib


def histo_flush_extract(means, weights, dmin, dmax, drecip, drecip_c,
                        lmin, lmax, lsum, lsum_c, lweight, lweight_c,
                        lrecip, lrecip_c, qs):
    """Everything the flusher needs from all rows, as plain tensor ops
    (the reference's XLA extract, ``_histo_flush_extract``): quantiles
    (gather form), tree-summed dsum/dcount, compensated accumulators
    resolved (s + c)."""
    quantiles = td.quantile(means, weights, dmin, dmax, qs)
    dsum = td.row_sum(means, weights)
    dcount = td.row_count(weights)
    return (quantiles, dmin, dmax, dsum, dcount, drecip + drecip_c,
            lmin, lmax, lsum + lsum_c, lweight + lweight_c,
            lrecip + lrecip_c)


def pack_extract_columns(qv, *cols):
    """[S,P] quantiles + ten [S] aggregates → one [S,P+10] f32 tensor,
    so the extract pays a single device→host transfer."""
    return torch.cat([qv] + [c[:, None].to(torch.float32) for c in cols],
                     dim=1)


def flush_extract_plain(*fields_and_qs) -> torch.Tensor:
    """The kernel's function in PyTorch ops: the packed f32[S, P+10]."""
    return pack_extract_columns(*histo_flush_extract(*fields_and_qs))


def _check(fields, qs) -> tuple[int, int]:
    means, weights = fields[0], fields[1]
    dev = means.device
    if means.dim() != 2 or weights.shape != means.shape:
        raise ValueError("means/weights must both be [S, C]")
    s, c = means.shape
    for t in fields + (qs,):
        if t.device != dev:
            raise ValueError("all flush_extract inputs must share a device")
        if t.dtype != torch.float32:
            raise TypeError(f"flush_extract takes f32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flush_extract inputs must be contiguous")
    for t in fields[2:]:
        if t.shape != (s,):
            raise ValueError(f"row scalars must be [{s}], got "
                             f"{tuple(t.shape)}")
    if qs.dim() != 1:
        raise ValueError("qs must be 1-D")
    return s, c


def flush_extract(means, weights, dmin, dmax, drecip, drecip_c,
                  lmin, lmax, lsum, lsum_c, lweight, lweight_c,
                  lrecip, lrecip_c, qs) -> torch.Tensor:
    """Packed flush extract f32[S, P+10] (column layout in the CUDA
    source). CPU tensors take the plain version; CUDA tensors launch the
    kernel, which takes C = 128 and 1 <= P <= 16, or raise."""
    fields = (means, weights, dmin, dmax, drecip, drecip_c, lmin, lmax,
              lsum, lsum_c, lweight, lweight_c, lrecip, lrecip_c)
    s, c = _check(fields, qs)
    p = qs.shape[0]
    if means.device.type == "cpu":
        return flush_extract_plain(*fields, qs)
    if means.device.type != "cuda":
        raise ValueError(f"flush_extract runs on cpu or cuda, not "
                         f"{means.device.type}")
    if c != CAPACITY:
        raise ValueError(f"the kernel takes {CAPACITY} centroids per row,"
                         f" got {c}")
    if not 1 <= p <= MAX_QUANTILES:
        raise ValueError(f"the kernel takes 1..{MAX_QUANTILES} quantiles,"
                         f" got {p}")
    if means.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("means/weights must be 16-byte aligned")
    out = torch.empty((s, p + AGG_COLUMNS), dtype=torch.float32,
                      device=means.device)
    if s == 0:
        return out
    lib = load()
    with torch.cuda.device(means.device):
        sms = torch.cuda.get_device_properties(
            means.device).multi_processor_count
        warps = lib.flush_extract_threads_per_block() // 32
        grid = max(1, min(-(-s // warps), sms * 8))
        stream = torch.cuda.current_stream(means.device).cuda_stream
        rc = lib.flush_extract_launch(
            *(t.data_ptr() for t in fields), qs.data_ptr(), out.data_ptr(),
            s, p, grid, stream)
    if rc != 0:
        raise RuntimeError(f"flush_extract launch failed: CUDA error {rc}")
    flush_extract.launches += 1
    return out


flush_extract.launches = 0
