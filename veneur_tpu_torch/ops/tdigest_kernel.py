"""The t-digest fold kernels for Hopper (K2): build, load and launch.

``csrc/tdigest.cu`` holds the hand-written CUDA C++ kernels for sm_90a
(see the source for their design, bounds and the places where the bits
would differ unless they do as the plain version does):

* K2a ``compress`` — the per-row compression of candidate centroid rows
  f32[S, M] → [S, C]: a warp a row for M <= 256 (rows sorted and scanned
  in registers), a block a row up to 4,096 candidates, a global slab a
  row past that. It replaces ``_compress_rows`` of
  veneur_tpu/ops/tdigest.py (a jitted XLA program).
* K3 ``fold_staged`` — the staged fold: each row's pool centroids and
  staged samples (a compacted flat plane, or a dense [rows, B] one) loaded
  beside each other, the row's sample stats and its 12 new scalars, then
  K2a's row routine over the [C + B] candidates, in one warp a row for
  C + B <= 256 (``td_fold_warps``: a row whose pool part is sorted places
  its staged samples by rank, on 32-bit keys); wider rows take
  ``td_stage_rows`` (the candidates and the scalars) and then K2a. It
  replaces
  ``_expand_flat_planes`` and ``_histo_fold_staged`` of
  veneur_tpu/core/worker.py (jitted XLA programs).
* K2b ``add_batch`` — the spill fold of a raw-sample batch into digest
  rows [K, C], from the unsorted batch: the sort by (row, value) (tiles
  in a block, then merge passes), the prefix scans, the per-row stats,
  the run table and the batch digest, then K2a's row routine over
  [K, 2C]. It replaces ``add_batch`` of veneur_tpu/ops/tdigest.py.

The library is built with nvcc at first use (ops/nvcc.py, with the flush
extract's flags: ``-ftz=true``, no FMA contraction) and loaded with
ctypes. The launchers here take CUDA tensors only and check what the
kernels take; ops/tdigest.py's ``compress_rows`` and ``add_batch`` and
core/worker.py's ``fold_staged`` are the wrappers the port calls, with
their plain versions and launch counts.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from veneur_tpu_torch.ops import nvcc

_SRC = nvcc.CSRC / "tdigest.cu"
# the widest digest row K2b takes (its [2C] candidates in shared memory)
MAX_ADD_CAPACITY = 2048
_KERNELS = (r"(td_(?:compress_warps|compress_wide|compress_scratch|sort_tile|"
            r"sort_merge|scan_tile|scan_step|add_rows|fold_warps|stage_rows)"
            r"(?:ILb[01]E)?)")

_lib = None
_lib_lock = threading.Lock()
# td_fold_warps' rows by the path the row routine's first sort took: the
# sorted runs' merges, the rank path, a wider tail sorted alone, the whole
# network (kPath* in the source); tallied on the card while
# ``counting_paths`` holds a tensor
PATHS = ("runs", "rank", "tail", "network")
_paths = None


def build():
    """Compile csrc/tdigest.cu unless this exact build exists; the path."""
    return nvcc.build(_SRC, nvcc.EXTRACT_FLAGS)


def _kernel_name(mangled: str) -> str:
    """``td_add_rows<true>``'s mangled stem as ``td_add_rows_block``,
    ``<false>`` as ``td_add_rows_warp``."""
    return mangled.replace("ILb1E", "_block").replace("ILb0E", "_warp")


def parse_ptxas(text: str) -> dict[str, dict[str, int]]:
    """Per kernel (``td_compress_warps``, ``_wide``, ``_scratch``,
    ``td_sort_tile``, ``td_sort_merge``, ``td_scan_tile``,
    ``td_scan_step``, ``td_add_rows_warp``/``_block``), what ptxas
    reported (ops/nvcc.parse_ptxas)."""
    return nvcc.parse_ptxas(text, _KERNELS, key=_kernel_name)


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
    lib.td_add_batch_scratch_bytes.argtypes = [ci]
    lib.td_add_batch_scratch_bytes.restype = ll
    lib.td_add_batch_launches.argtypes = [ci]
    lib.td_add_batch_launches.restype = ci
    lib.td_add_batch_launch.argtypes = (
        [vp] * 5 + [ci, ci] + [vp, ci] + [vp, vp] + [ci] + [vp, ci] + [vp]
        + [vp] * 10 + [vp])
    lib.td_add_batch_launch.restype = ci
    lib.td_fold_span.argtypes = []
    lib.td_fold_span.restype = ci
    lib.td_fold_staged_launch.argtypes = (
        [vp, vp, vp, ll, ci, ci, vp, vp, vp, ll, vp, ci] + [vp] * 6 + [vp])
    lib.td_fold_staged_launch.restype = ci
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
    batch's rows, int32 or int64) or ValueError."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the t-digest kernels run on cuda, not {dev.type}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous() \
                or t.dtype not in (torch.float32, torch.int32, torch.int64):
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


def add_batch(means, weights, dmin, dmax, drecip, rows, values,
              sample_weights, table) -> tuple[torch.Tensor, ...]:
    """Launch K2b over an unsorted batch (int32 or int64 rows in [0, K),
    float32 values and weights, padding samples weighted <= 0; the shapes
    checked by ops/tdigest.add_batch). Returns the new means and weights
    [K, C], min, max and recip [K], and the five BatchStats fields [K],
    all new tensors."""
    dev = _check_cuda(means, weights, dmin, dmax, drecip, rows, values,
                      sample_weights, table)
    lib = load()
    with torch.cuda.device(dev):
        return run_add_batch(lib, means, weights, dmin, dmax, drecip, rows,
                             values, sample_weights, table, _stream(dev))


def run_add_batch(lib, means, weights, dmin, dmax, drecip, rows, values,
                  sample_weights, table, stream) -> tuple[torch.Tensor, ...]:
    """K2b through ``lib``'s launcher on ``stream``, outputs and scratch
    on the inputs' device (``add_batch`` checks them)."""
    if rows.dtype not in (torch.int32, torch.int64):
        raise ValueError("the batch's rows must be int32 or int64")
    dev = means.device
    k, c = means.shape
    n = rows.shape[0]
    f32 = torch.float32
    scratch = torch.empty((lib.td_add_batch_scratch_bytes(n),),
                          dtype=torch.uint8, device=dev)
    out_m = torch.empty((k, c), dtype=f32, device=dev)
    out_w = torch.empty((k, c), dtype=f32, device=dev)
    scal = torch.empty((8, k), dtype=f32, device=dev)
    rc = lib.td_add_batch_launch(
        means.data_ptr(), weights.data_ptr(), dmin.data_ptr(),
        dmax.data_ptr(), drecip.data_ptr(), k, c, rows.data_ptr(),
        int(rows.dtype == torch.int64), values.data_ptr(),
        sample_weights.data_ptr(), n, table.data_ptr(), table.numel(),
        scratch.data_ptr(), out_m.data_ptr(), out_w.data_ptr(),
        *(scal[i].data_ptr() for i in range(8)), stream)
    nvcc.check(rc, "td_add_batch launch failed")
    return (out_m, out_w, *scal.unbind(0))


def fold_staged(fields, values, weights, offsets, total: int, depth: int,
                table) -> tuple[torch.Tensor, ...]:
    """Launch K3 over the 14 pool fields (means and weights [S, C], 12
    scalars [S]) and the staged samples: flat (``offsets`` int32 [S],
    each row's first sample; ``total`` the samples; ``weights`` None when
    every weight is 1.0) or dense (``offsets`` None; values and weights
    [total, depth], rows past ``total`` empty). Returns the 14 new
    fields (core/worker.fold_staged checks the shapes)."""
    dev = _check_cuda(*fields, values, table,
                      *(t for t in (weights, offsets) if t is not None))
    lib = load()
    paths = _paths if _paths is not None and _paths.device == dev else None
    with torch.cuda.device(dev):
        return run_fold_staged(lib, fields, values, weights, offsets, total,
                               depth, table, _stream(dev), paths)


@contextlib.contextmanager
def counting_paths(device):
    """Inside it, every K3 launch on ``device`` adds its one-warp rows
    into the yielded int32 [4] tensor by path (``PATHS``); one atomic add
    a row, off while no tally is held."""
    global _paths
    tally = torch.zeros(len(PATHS), dtype=torch.int32, device=device)
    prev, _paths = _paths, tally
    try:
        yield tally
    finally:
        _paths = prev


def run_fold_staged(lib, fields, values, weights, offsets, total: int,
                    depth: int, table, stream, paths=None
                    ) -> tuple[torch.Tensor, ...]:
    """K3 through ``lib``'s launcher on ``stream``, outputs (and, past
    one warp's row, the [S, C + B] candidates K2a compresses) on the
    fields' device; ``paths`` (int32 [4] there, or None) tallies the
    one-warp rows by path."""
    means, w = fields[0], fields[1]
    dev = means.device
    s, c = means.shape
    f32 = torch.float32
    out_m = torch.empty((s, c), dtype=f32, device=dev)
    out_w = torch.empty((s, c), dtype=f32, device=dev)
    scal = torch.empty((12, s), dtype=f32, device=dev)
    if s == 0:
        return (out_m, out_w, *scal.unbind(0))
    if s >= 1 << 31:
        raise ValueError("the staged fold takes fewer than 2^31 rows")
    m = c + depth
    cand = ()
    if m > lib.td_fold_span():
        cand = (torch.empty((s, m), dtype=f32, device=dev),
                torch.empty((s, m), dtype=f32, device=dev))
    ins = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in fields[2:]))
    rc = lib.td_fold_staged_launch(
        means.data_ptr(), w.data_ptr(), ins, s, c, depth, values.data_ptr(),
        None if weights is None else weights.data_ptr(),
        None if offsets is None else offsets.data_ptr(), total,
        table.data_ptr(), table.numel(), out_m.data_ptr(), out_w.data_ptr(),
        scal.data_ptr(), *([t.data_ptr() for t in cand] or [None, None]),
        None if paths is None else paths.data_ptr(), stream)
    nvcc.check(rc, "td_fold_staged launch failed")
    if cand:
        out_m, out_w = run_compress(lib, cand[0], cand[1], c, table, stream)
    return (out_m, out_w, *scal.unbind(0))


def chain_launches(n: int) -> int:
    """The kernel launches of one K2b call over n samples (the sort's
    tile and merge passes, the scan tile and steps, the rows)."""
    return load().td_add_batch_launches(n)
