"""The flush extract: the hand-written Hopper kernel and its plain version.

``flush_extract`` computes, for every digest row of a pool, the quantiles
at ``qs`` plus the ten aggregate columns the flusher reads, packed into
one f32[S, P+10] array (the JAX package's ``_histo_flush_extract``
followed by ``_pack_extract_columns``, core/worker.py). It replaces the
TPU kernel ``_extract_kernel`` of veneur_tpu/ops/pallas_kernels.py.

* On a CUDA tensor it launches ``csrc/flush_extract.cu`` (R rows per
  warp fed by a ring of bulk copies; see the source for the design and
  its memory bound) or raises. The library is built with nvcc for sm_90a
  at first use (with ``-ftz=true``, ops/nvcc.py), into
  ``build/kernels/`` at the repository root, and loaded with ctypes;
  ptxas's report of the build is kept beside it.
* On a CPU tensor it runs ``flush_extract_plain``: the same function as
  PyTorch ops (ops/tdigest.quantile, row_sum, row_count and the pack).

Both follow the XLA path's bit contract, f32 denormals included (read and
written as XLA on the CPU does, see ``histo_flush_extract``), so the
kernel's output is bitwise the plain version's on the same inputs (NaN
where a row is empty).
``flush_extract.launches`` counts kernel launches, nothing else. A
governed flush launches it once per pow2 row chunk of the pool
(core/worker.py ``_extract_chunked``): a contiguous view whose base moves
by whole rows. ``means`` and ``weights`` must start on a 16-byte boundary
(the bulk copies' rule); a base that does not raises, on both devices,
rather than being copied aside.

The library holds two kernels per R in ``VARIANTS``: the narrow one for
P <= ``QUANTILE_BLOCK`` (16) quantiles, and the wide one for any P, which
walks the quantiles in blocks of 16 over one read of each row. Both give
every quantile column by the same arithmetic, so a column's bits do not
depend on P. ``flush_extract`` launches ``ROWS_PER_WARP``, the fastest variant
that builds without spills and is bitwise equal to the plain version on
the card (tools/port_probe_extract.py measures them; PERF.md has the
numbers). ``_flush_extract_variant`` reaches the others for that probe.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import nvcc
from veneur_tpu_torch.ops import tdigest as td

CAPACITY = 128  # centroids per row the kernel takes
QUANTILE_BLOCK = 16  # the narrow kernel's P at most; the wide one's block
AGG_COLUMNS = 10
VARIANTS = (1, 2, 4, 8)  # rows per warp, one kernel each in the library
ROWS_PER_WARP = 8  # the variant flush_extract launches

_SRC = nvcc.CSRC / "flush_extract.cu"

_lib = None
_lib_lock = threading.Lock()
_blocks_per_sm: dict[tuple[int, bool, int], int] = {}
# launches of each variant's kernels (narrow and wide), whoever asked
variant_launches = {r: 0 for r in VARIANTS}


def library_path() -> Path:
    """Where the built library lives (named by the source's and flags'
    hash, ops/nvcc.py)."""
    return nvcc.library_path(_SRC, nvcc.EXTRACT_FLAGS)


def build() -> Path:
    """Compile csrc/flush_extract.cu with nvcc unless this exact build
    exists; returns the library path. ptxas's report (``-Xptxas -v``)
    goes to the same name with ``.ptxas.txt``."""
    return nvcc.build(_SRC, nvcc.EXTRACT_FLAGS)


def parse_ptxas(text: str, wide: bool = False) -> dict[int, dict[str, int]]:
    """Per variant R, what ptxas reported for its narrow kernel (or, with
    ``wide``, its wide one): registers, spills, local and static shared
    memory (ops/nvcc.parse_ptxas)."""
    name = "flush_extract_wide_kernel" if wide else "flush_extract_kernel"
    return nvcc.parse_ptxas(text, name + r"ILi(\d+)E", int)


def build_report(wide: bool = False) -> dict[int, dict[str, int]]:
    """ptxas's report of the current build, per variant R (the wide
    kernels' with ``wide``)."""
    return parse_ptxas(nvcc.ptxas_report(_SRC, nvcc.EXTRACT_FLAGS), wide)


def load():
    """The ctypes handle of the built library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for r in VARIANTS:
                for kind in ("", "wide_"):
                    fn = getattr(lib, f"flush_extract_launch_{kind}r{r}")
                    fn.argtypes = [ctypes.POINTER(vp), vp, vp, ci, ci, ci,
                                   vp]
                    fn.restype = ci
                    getattr(lib, f"flush_extract_occupancy_{kind}r{r}"
                            ).restype = ci
                getattr(lib, f"flush_extract_smem_bytes_r{r}").restype = ci
            lib.flush_extract_threads_per_block.restype = ci
            _lib = lib
        return _lib


def _kind(wide: bool) -> str:
    return "wide_" if wide else ""


def blocks_per_sm(r: int, device: torch.device, wide: bool = False) -> int:
    """Resident blocks of variant r's narrow (or wide) kernel on one SM of
    ``device``, as the occupancy calculator reports it (cached per
    device)."""
    key = (r, wide, device.index if device.index is not None
           else torch.cuda.current_device())
    if key not in _blocks_per_sm:
        lib = load()
        with torch.cuda.device(device):
            n = getattr(lib, f"flush_extract_occupancy_{_kind(wide)}r{r}")()
        if n < 1:
            raise RuntimeError(f"flush_extract {_kind(wide)}r{r}: the "
                               f"occupancy query gave {n} (below 0: a "
                               f"CUDA error)")
        _blocks_per_sm[key] = n
    return _blocks_per_sm[key]


def histo_flush_extract(means, weights, dmin, dmax, drecip, drecip_c,
                        lmin, lmax, lsum, lsum_c, lweight, lweight_c,
                        lrecip, lrecip_c, qs):
    """Everything the flusher needs from all rows, as plain tensor ops
    (the reference's XLA extract, ``_histo_flush_extract``): quantiles
    (gather form), tree-summed dsum/dcount, compensated accumulators
    resolved (s + c).

    Denormals as XLA on the CPU treats them: read as ±0 where arithmetic
    or a comparison reads an input, and flushed to ±0 wherever arithmetic
    writes one, inside the quantile arithmetic (products, prefixes,
    midpoints, differences) as in the output columns (ops/tdigest.py);
    dmin, dmax, lmin and lmax are copied out bit for bit."""
    z = exn.flush_denormals
    quantiles = td.quantile(means, weights, dmin, dmax, qs)
    dsum = td.row_sum(means, weights)
    dcount = td.row_count(weights)

    def resolved(s, c):
        return z(z(s) + z(c))

    return (quantiles, dmin, dmax, dsum, dcount, resolved(drecip, drecip_c),
            lmin, lmax, resolved(lsum, lsum_c), resolved(lweight, lweight_c),
            resolved(lrecip, lrecip_c))


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
    # the kernel's bulk copies read each row's centroids from 16-byte
    # aligned addresses: a misaligned base (a row slice that does not
    # start on a 16-byte boundary) raises, here as on the card, rather
    # than being copied to an aligned buffer behind the caller's back
    if means.data_ptr() % 16 or weights.data_ptr() % 16:
        raise ValueError("means/weights must be 16-byte aligned")
    return s, c


def _launch(r: int, fields, qs) -> torch.Tensor:
    """Check what the kernel takes and launch variant r on CUDA tensors."""
    means, weights = fields[0], fields[1]
    s, c = _check(fields, qs)
    p = qs.shape[0]
    if means.device.type != "cuda":
        raise ValueError(f"the flush extract kernel runs on cuda, not "
                         f"{means.device.type}")
    if c != CAPACITY:
        raise ValueError(f"the kernel takes {CAPACITY} centroids per row,"
                         f" got {c}")
    if p < 1:
        raise ValueError("the kernel takes at least one quantile")
    out = torch.empty((s, p + AGG_COLUMNS), dtype=torch.float32,
                      device=means.device)
    if s == 0:
        return out
    lib = load()
    wide = p > QUANTILE_BLOCK
    with torch.cuda.device(means.device):
        sms = torch.cuda.get_device_properties(
            means.device).multi_processor_count
        warps = lib.flush_extract_threads_per_block() // 32
        chunks = -(-s // r)
        grid = max(1, min(-(-chunks // warps),
                          sms * blocks_per_sm(r, means.device, wide)))
        stream = torch.cuda.current_stream(means.device).cuda_stream
        ptrs = (ctypes.c_void_p * len(fields))(
            *(t.data_ptr() for t in fields))
        rc = getattr(lib, f"flush_extract_launch_{_kind(wide)}r{r}")(
            ptrs, qs.data_ptr(), out.data_ptr(), s, p, grid, stream)
    nvcc.check(rc, f"flush_extract {_kind(wide)}r{r} launch failed")
    variant_launches[r] += 1
    return out


def flush_extract(means, weights, dmin, dmax, drecip, drecip_c,
                  lmin, lmax, lsum, lsum_c, lweight, lweight_c,
                  lrecip, lrecip_c, qs) -> torch.Tensor:
    """Packed flush extract f32[S, P+10] (column layout in the CUDA
    source). CPU tensors take the plain version; CUDA tensors launch the
    kernel (one launch: the narrow kernel at P <= 16, the wide one past
    it), which takes C = 128 and any P >= 1, or raise. With no quantile
    (a configuration without percentiles or the median) the kernel runs
    at P = 1 and its quantile column is dropped: the aggregate columns do
    not read the quantiles."""
    fields = (means, weights, dmin, dmax, drecip, drecip_c, lmin, lmax,
              lsum, lsum_c, lweight, lweight_c, lrecip, lrecip_c)
    if means.device.type == "cpu":
        _check(fields, qs)
        return flush_extract_plain(*fields, qs)
    if qs.ndim == 1 and qs.shape[0] == 0:
        out = _launch(ROWS_PER_WARP, fields, qs.new_zeros((1,)))[:, 1:]
        out = out.contiguous()
    else:
        out = _launch(ROWS_PER_WARP, fields, qs)
    flush_extract.launches += 1
    return out


flush_extract.launches = 0


def _flush_extract_variant(r: int, *fields_and_qs) -> torch.Tensor:
    """``flush_extract`` through variant r of the kernel (CUDA tensors
    only): for the variant probe, not for the flush path."""
    if r not in VARIANTS:
        raise ValueError(f"no variant with {r} rows per warp; built: "
                         f"{VARIANTS}")
    if len(fields_and_qs) != 15:
        raise TypeError("expected the 14 pool fields and qs")
    return _launch(r, tuple(fields_and_qs[:14]), fields_and_qs[14])
