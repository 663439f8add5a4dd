"""Building the port's CUDA C++ sources into ctypes-loadable libraries.

Each source under ``veneur_tpu_torch/csrc/`` is compiled by nvcc for
sm_90a at first use into ``build/kernels/`` at the repository root (a
directory .gitignore lists), under a name hashed from the source and the
flags, so an edited source never loads a stale build. ptxas's report
(``-Xptxas -v`` in the flags) is kept beside the library as
``.ptxas.txt``. Nothing is built on import.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# every library's flags: sm_90a, no FMA contraction (the reference's bit
# contract), no fast math, ptxas's report, a shared object for ctypes
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# the flush extract's: f32 add, mul, div, setp, min and max with .ftz,
# which is what XLA on the CPU does (denormal inputs read as zero,
# denormal results flushed; moves and selects pass the bits)
EXTRACT_FLAGS = FLAGS + ("-ftz=true",)


class CudaError(RuntimeError):
    """A CUDA runtime call of a kernel launcher returned ``code`` (a
    ``cudaError_t``); ops/device_guard.classify maps it to a fault kind.
    Argument checks raise ValueError or TypeError, never this."""

    def __init__(self, code: int, what: str):
        super().__init__(f"{what}: CUDA error {code}")
        self.code = int(code)


def check(rc: int, what: str) -> None:
    """Raise CudaError unless the launcher returned cudaSuccess."""
    if rc != 0:
        raise CudaError(rc, what)


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's kernels are built "
                           "from veneur_tpu_torch/csrc at first use")
    return path


def library_path(src: Path, flags: tuple[str, ...]) -> Path:
    """Where the library built from ``src`` with ``flags`` lives."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build(src: Path, flags: tuple[str, ...]) -> Path:
    """Compile ``src`` with nvcc unless this exact build exists; returns
    the library path."""
    out = library_path(src, flags)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src.name} failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    out.with_suffix(".ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_report(src: Path, flags: tuple[str, ...]) -> str:
    """ptxas's report of the build of ``src`` (built if need be)."""
    return build(src, flags).with_suffix(".ptxas.txt").read_text()


def parse_ptxas(text: str, kernel: str, key=str) -> dict:
    """What ptxas reported for each kernel whose mangled name matches the
    regex ``kernel`` (its first group, through ``key``, names the entry;
    instances under one name keep the worst of each figure): registers
    per thread, spill store and load bytes, local memory (stack frame or
    lmem) bytes and static shared memory bytes."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(kernel, line)
        if m and ("Compiling entry function" in line
                  or "Function properties for" in line):
            cur = out.setdefault(key(m.group(1)), {
                "registers": 0, "spill_stores": 0, "spill_loads": 0,
                "local_bytes": 0, "static_smem_bytes": 0})
            continue
        if cur is None:
            continue
        for field, pat in (("registers", r"Used (\d+) registers"),
                           ("spill_stores", r"(\d+) bytes spill stores"),
                           ("spill_loads", r"(\d+) bytes spill loads"),
                           ("local_bytes", r"(\d+) bytes stack frame"),
                           ("local_bytes", r"(\d+) bytes lmem"),
                           ("static_smem_bytes", r"(\d+) bytes smem")):
            g = re.search(pat, line)
            if g:
                cur[field] = max(cur[field], int(g.group(1)))
    return out
