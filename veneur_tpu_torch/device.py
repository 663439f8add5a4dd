"""Device selection for the port.

Every entry point takes an explicit ``device``. Asking for none means the
card: ``resolve()`` returns ``cuda`` and raises when CUDA is absent, so a
run meant for the GPU never lands on the CPU by accident. Tests and the
CPU oracle pass ``device="cpu"``.

The reference's bit contract (ops/exactnum.py) needs full f32 products,
so TF32 is switched off for matmuls and convolutions on import.

A server's threads that run a CPU device's work take one intra-op thread
each (``serial_host_thread``).
"""

from __future__ import annotations

import threading

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


_intra_op_lock = threading.Lock()


def serial_host_thread(device) -> None:
    """Run this thread's torch ops on one intra-op thread when ``device``
    is the CPU.

    A server's compute threads (the flush ticker, the micro-fold and
    series-sync loops, the flush pipeline's stages) run the port's plain
    versions on a CPU device: hundreds of small ops a flush, each of
    which torch would split over an OpenMP team as wide as the host.
    Every parallel region waits for all of its team, so on a host whose
    cores other processes hold, a region waits for team threads the
    scheduler has parked, and a flush of 0.1-0.2 s of CPU stretched past
    a 0.5 s interval (F8). The count is the calling thread's own
    (OpenMP's per-thread setting). ``torch.set_num_threads`` also writes
    ATen's default for threads that have not run a parallel op yet; a
    short-lived thread puts that default back, so no other thread's
    count changes. On an idle host one thread is the slower choice for a
    large fold (PERF.md, F8)."""
    if torch.device(device).type != "cpu":
        return
    with _intra_op_lock:
        default = torch.get_num_threads()  # this thread's count exists first
        torch.set_num_threads(1)
        t = threading.Thread(target=torch.set_num_threads, args=(default,),
                             name="intra-op-default")
        t.start()
        t.join()
