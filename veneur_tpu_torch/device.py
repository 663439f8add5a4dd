"""Device selection for the port.

Every entry point takes an explicit ``device``. Asking for none means the
card: ``resolve()`` returns ``cuda`` and raises when CUDA is absent, so a
run meant for the GPU never lands on the CPU by accident. Tests and the
CPU oracle pass ``device="cpu"``.

The reference's bit contract (ops/exactnum.py) needs full f32 products,
so TF32 is switched off for matmuls and convolutions on import.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device=None) -> torch.device:
    """The torch.device to run on: ``cuda`` unless another is asked for.
    Raises RuntimeError when CUDA is wanted and not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
