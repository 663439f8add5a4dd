"""The t-digest fold kernels for Hopper (K2): build, load and launch.

``csrc/tdigest.cu`` holds two hand-written CUDA C++ kernels for sm_90a
(see the source for their design, bounds and the places where the bits
would differ unless they do as the plain version does):

* K2a ``compress`` — the per-row compression of candidate centroid rows
  f32[S, M] → [S, C], one block a row. It replaces ``_compress_rows`` of
  veneur_tpu/ops/tdigest.py (a jitted XLA program).
* K2b ``add_batch`` — the spill fold of a raw-sample batch, already
  sorted by (row, value), into digest rows [K, C]: the prefix scans, the
  per-row stats, the run table and the batch digest, then K2a's routine
  over [K, 2C]. It replaces ``add_batch`` of veneur_tpu/ops/tdigest.py
  after its sort.

The library is built with nvcc at first use (ops/nvcc.py, with the flush
extract's flags: ``-ftz=true``, no FMA contraction) and loaded with
ctypes. The launchers here take CUDA tensors only and check what the
kernels take; ops/tdigest.py's ``compress_rows`` and ``add_batch`` are the
wrappers the port calls, with their plain versions and launch counts.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from veneur_tpu_torch.ops import nvcc

_SRC = nvcc.CSRC / "tdigest.cu"
# the widest digest row K2b takes (its [2C] candidates in shared memory)
MAX_ADD_CAPACITY = 2048
_CHUNK = 128

_lib = None
_lib_lock = threading.Lock()


def build():
    """Compile csrc/tdigest.cu unless this exact build exists; the path."""
    return nvcc.build(_SRC, nvcc.EXTRACT_FLAGS)


def parse_ptxas(text: str) -> dict[str, dict[str, int]]:
    """Per kernel (``td_compress``, ``td_scan_tile``, ``td_scan_step``,
    ``td_add_rows``), what ptxas reported (ops/nvcc.parse_ptxas)."""
    return nvcc.parse_ptxas(
        text, r"(td_compress|td_scan_tile|td_scan_step|td_add_rows)")


def build_report() -> dict[str, dict[str, int]]:
    """ptxas's report of the current build, per kernel."""
    return parse_ptxas(nvcc.ptxas_report(_SRC, nvcc.EXTRACT_FLAGS))


def bind(lib):
    """Set the C signatures of the library's launchers on ``lib``."""
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.td_compress_row_bytes.argtypes = [ci]
    lib.td_compress_row_bytes.restype = ll
    lib.td_compress_smem_limit.argtypes = []
    lib.td_compress_smem_limit.restype = ci
    lib.td_compress_launch.argtypes = [vp, vp, ll, ci, ci, vp, ci, vp, vp,
                                       vp, vp]
    lib.td_compress_launch.restype = ci
    lib.td_add_batch_launch.argtypes = (
        [vp] * 5 + [ci, ci] + [vp] * 4 + [ci] + [vp, ci] + [vp] * 2
        + [vp] * 10 + [vp])
    lib.td_add_batch_launch.restype = ci
    return lib


def load():
    """The ctypes handle of the built library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


def _check_cuda(*tensors: torch.Tensor) -> torch.device:
    """The card every tensor lies on; contiguous float32 (but for the
    sorted rows, int64) or ValueError."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the t-digest kernels run on cuda, not {dev.type}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous() \
                or t.dtype not in (torch.float32, torch.int64):
            raise ValueError("the t-digest kernels take contiguous float32 "
                             "tensors on one card")
    return dev


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def run_compress(lib, means: torch.Tensor, weights: torch.Tensor,
                 capacity: int, table: torch.Tensor, stream
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K2a through ``lib``'s launcher on ``stream``, outputs on the
    inputs' device (``compress`` checks them)."""
    dev = means.device
    s, m = means.shape
    out_m = torch.empty((s, capacity), dtype=torch.float32, device=dev)
    out_w = torch.empty((s, capacity), dtype=torch.float32, device=dev)
    if s == 0:
        return out_m, out_w
    if s >= 1 << 31:
        raise ValueError("the compress kernel takes fewer than 2^31 rows")
    row_bytes = lib.td_compress_row_bytes(m)
    scratch = None
    if row_bytes > lib.td_compress_smem_limit():
        # rows past a block's shared memory work in a global slab each
        scratch = torch.empty((s * row_bytes,), dtype=torch.uint8,
                              device=dev)
    rc = lib.td_compress_launch(
        means.data_ptr(), weights.data_ptr(), s, m, capacity,
        table.data_ptr(), table.numel(),
        None if scratch is None else scratch.data_ptr(), out_m.data_ptr(),
        out_w.data_ptr(), stream)
    nvcc.check(rc, "td_compress launch failed")
    return out_m, out_w


def compress(means: torch.Tensor, weights: torch.Tensor, capacity: int,
             table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K2a: f32[S, M] candidate rows → (means, weights) f32[S, C]
    (ops/tdigest.compress_rows checks the shapes). ``table`` is the k1
    boundary table (exactnum.kscale_boundaries) on the card."""
    dev = _check_cuda(means, weights, table)
    if means.dtype != torch.float32 or means.dim() != 2 \
            or means.shape != weights.shape \
            or not 1 <= capacity <= means.shape[1]:
        raise ValueError("K2a takes two float32 [S, M] tensors, M >= C")
    lib = load()
    with torch.cuda.device(dev):
        return run_compress(lib, means, weights, capacity, table,
                            _stream(dev))


def add_batch(means, weights, dmin, dmax, drecip, srows, svals, sw,
              raw_svals, table) -> tuple[torch.Tensor, ...]:
    """Launch K2b over a batch sorted by (row, value) (ops/tdigest.
    _sort_batch: int64 rows, flushed values and weights, raw values; the
    shapes checked by ops/tdigest.add_batch). Returns the new means and
    weights [K, C], min, max and recip [K], and the five BatchStats
    fields [K], all new tensors."""
    dev = _check_cuda(means, weights, dmin, dmax, drecip, srows, svals, sw,
                      raw_svals, table)
    lib = load()
    with torch.cuda.device(dev):
        return run_add_batch(lib, means, weights, dmin, dmax, drecip, srows,
                             svals, sw, raw_svals, table, _stream(dev))


def run_add_batch(lib, means, weights, dmin, dmax, drecip, srows, svals, sw,
                  raw_svals, table, stream) -> tuple[torch.Tensor, ...]:
    """K2b through ``lib``'s launcher on ``stream``, outputs and scratch
    on the inputs' device (``add_batch`` checks them)."""
    if srows.dtype != torch.int64:
        raise ValueError("the sorted rows must be int64")
    dev = means.device
    k, c = means.shape
    n = srows.shape[0]
    g = -(-n // _CHUNK)
    f32 = torch.float32
    fscratch = torch.empty((6 * n + 2 * g * _CHUNK + 4 * g,), dtype=f32,
                           device=dev)
    iscratch = torch.empty((6 * g,), dtype=torch.int32, device=dev)
    out_m = torch.empty((k, c), dtype=f32, device=dev)
    out_w = torch.empty((k, c), dtype=f32, device=dev)
    scal = torch.empty((8, k), dtype=f32, device=dev)
    rc = lib.td_add_batch_launch(
        means.data_ptr(), weights.data_ptr(), dmin.data_ptr(),
        dmax.data_ptr(), drecip.data_ptr(), k, c, srows.data_ptr(),
        svals.data_ptr(), sw.data_ptr(), raw_svals.data_ptr(), n,
        table.data_ptr(), table.numel(), fscratch.data_ptr(),
        iscratch.data_ptr(), out_m.data_ptr(), out_w.data_ptr(),
        *(scal[i].data_ptr() for i in range(8)), stream)
    nvcc.check(rc, "td_add_batch launch failed")
    return (out_m, out_w, *scal.unbind(0))
