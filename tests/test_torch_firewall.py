"""The PyTorch port stands apart from JAX and from the JAX package.

* Every veneur_tpu_torch module imports in a fresh interpreter whose
  import system refuses ``jax``/``jaxlib`` and ``veneur_tpu``/
  ``veneur_tpu.*`` (``veneur_tpu_torch`` is allowed).
* Imports inside functions never run at import time, so each module's
  source (and chip_smoke.py's, and the port's tools, tools/port_*.py) is
  also walked as an AST for any import naming those packages.
* ``device.resolve()`` asks for CUDA and raises where there is none, and
  so do the constructors that take a device and are given none.
"""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "veneur_tpu_torch"


def _modules() -> list[str]:
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "veneur_tpu")


_BLOCKER = r"""
import importlib.abc, json, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "veneur_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
mods = json.loads(sys.argv[1])
for m in mods:
    __import__(m)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "veneur_tpu"))
print(json.dumps({"imported": len(mods), "bad": bad}))
"""


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "veneur_tpu_torch.ops.extract_kernel" in mods
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKER, json.dumps(mods)], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"imported": len(mods), "bad": []}


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "tools").glob("port_*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_anywhere_in_source(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_resolve_raises_without_cuda():
    from veneur_tpu_torch import device

    assert device.resolve("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert device.resolve().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve()
    with pytest.raises(RuntimeError):
        device.resolve("cuda:0")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_no_device_means_the_card():
    from veneur_tpu_torch.core.worker import HistoDeviceState
    from veneur_tpu_torch.ops import tdigest as ttd

    if torch.cuda.is_available():
        assert ttd.init_pool(4).means.device.type == "cuda"
        assert HistoDeviceState.create(4, 128).means.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        ttd.init_pool(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        HistoDeviceState.create(4, 128)
    assert ttd.init_pool(4, device="cpu").means.device.type == "cpu"
