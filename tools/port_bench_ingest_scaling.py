#!/usr/bin/env python3
"""Reader scaling of the port's native ingest: parse and commit lines/s.

The port of tools/bench_ingest_scaling.py: lines through
``NativeRouter.ingest`` (``vn_ingest_routed``) from 1, 2 and 4
concurrent reader threads into 1 or 4 shards, beside the round-1
baseline shape (every reader serialized on one context). Each lane
asserts that the contexts committed every line sent.

Same JSON keys as the JAX tool (``cpu_count``, ``results``...).
Departures:
- ``--device`` (default ``cuda``; exits 2 without CUDA, ``--device cpu``
  on the CPU) only checks the device: the lanes do no device work.
- Added keys: ``device`` (the card's name and power limit) and
  ``cores`` (``os.sched_getaffinity``); ``see_also`` names the port's
  contention tool.
- INGEST_SCALING.json goes under chiprun_out/ (or VENEUR_ARTIFACT_DIR),
  never the root.

Usage: python3 tools/port_bench_ingest_scaling.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from port_soak_common import (  # noqa: E402
    device_arg, device_line, host_cores, require_device, write_artifact)

N_DATAGRAMS = 20_000
LINES_PER_DGRAM = 8


def make_batches(n_threads: int, n_datagrams: int = N_DATAGRAMS) -> list:
    batches = []
    for t in range(n_threads):
        dgrams = []
        for i in range(n_datagrams // n_threads):
            lines = [
                f"scale.m{(t * 131 + i * 7 + j) % 4096}:{j}.5|ms|#env:prod,az:{j % 3}"
                for j in range(LINES_PER_DGRAM)
            ]
            dgrams.append("\n".join(lines).encode())
        batches.append(dgrams)
    return batches


def run(n_threads: int, n_shards: int, serialized: bool = False,
        n_datagrams: int = N_DATAGRAMS) -> float:
    """One lane's lines/s; raises unless every line sent was committed."""
    from veneur_tpu_torch.native import NativeIngest, NativeRouter

    ctxs = [NativeIngest() for _ in range(n_shards)]
    router = NativeRouter(ctxs)
    batches = make_batches(n_threads, n_datagrams)
    lock = threading.Lock()  # only used in serialized mode
    barrier = threading.Barrier(n_threads + 1)

    def work(dgrams):
        barrier.wait()
        if serialized:
            for d in dgrams:
                with lock:
                    ctxs[0].ingest(d)
        else:
            for d in dgrams:
                router.ingest(d)

    threads = [threading.Thread(target=work, args=(b,)) for b in batches]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    total_lines = sum(len(b) for b in batches) * LINES_PER_DGRAM
    committed = sum(c.processed for c in ctxs)
    if committed != total_lines:
        raise AssertionError(f"{n_threads} readers, {n_shards} shards: "
                             f"{committed} lines committed of {total_lines}")
    return total_lines / dt


def measure(n_datagrams: int = N_DATAGRAMS) -> dict:
    results = {}
    run(1, 1, n_datagrams=n_datagrams)  # warm allocators, thread scratch
    results["serialized_1reader"] = round(
        run(1, 1, serialized=True, n_datagrams=n_datagrams), 1)
    results["serialized_4readers_1lock"] = round(
        run(4, 1, serialized=True, n_datagrams=n_datagrams), 1)
    for readers in (1, 2, 4):
        for shards in (1, 4):
            key = f"routed_{readers}readers_{shards}shards"
            results[key] = round(run(readers, shards,
                                     n_datagrams=n_datagrams), 1)
    base = results["routed_1readers_4shards"]
    results["scaling_4readers_vs_1"] = round(
        results["routed_4readers_4shards"] / base, 2)
    cores = host_cores()
    out = {
        "unit": "lines/s",
        "lines_per_datagram": LINES_PER_DGRAM,
        "cpu_count": os.cpu_count(),
        "note": ("scaling_4readers_vs_1 is bounded above by the cores: "
                 "with one core, threads interleave and ~1.0 means the "
                 "sharded router adds no contention over a single reader "
                 "(parse runs lock-free; commits take only the target "
                 "shard's mutex). With cores for every reader the same "
                 "code path scales with readers."),
        "results": results,
        "cores": cores,
    }
    if cores < 4:
        out["see_also"] = (
            "wall-clock scaling cannot be shown on this host; the direct "
            "contention evidence (per-shard mutex hold/wait percentiles "
            "under concurrent readers) is INGEST_CONTENTION.json, from "
            "tools/port_bench_lock_contention.py")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    from veneur_tpu_torch import native

    native.build()
    out = {**measure(), "device": device_line(device)}
    path = write_artifact("INGEST_SCALING.json", out)
    print(json.dumps({**out, "wrote": path}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
