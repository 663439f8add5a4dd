#!/usr/bin/env python3
"""The port's loadgen trial on the CPU, recorded for a diagnosis of its
cadence and its books (F8).

    python3 tools/port_trial_diag.py [--trials N] [--out PATH]
    python3 tools/port_trial_diag.py --fold-threads

Runs ``tests/test_torch_loadgen.py::test_harness_trial_loses_nothing``'s
trial N times (a port ``LoadHarness`` on the CPU: 1 worker, 1 native
reader, a 0.5 s interval, an 8 MiB receive buffer, no sample derived
from the server's own flush spans, 20,000 lines/s for two intervals) and writes one JSON line a trial to PATH: passed, loss,
cadence, each interval's duration and flush phases, each flush's wall
and its thread's CPU seconds with its phases, the lines sent against
the lines the server processed once the sender stopped, the socket's
``drops`` column of ``/proc/net/udp``, the native context's lock record
(the reader's waits and holds, ``NativeIngest.lock_stats``), the
collector's passes over 10 ms, and the host's load average. Run it beside
the test suite (say as a second process while the tier-1 command runs)
to see the trial under that load.

``--fold-threads`` times the CPU staged fold of the trial's shape (a
1,024-row pool of C = 128 and a [1,024, 64] dense plane,
``tools/port_probe_tdigest.fold_inputs``) on torch's default intra-op
thread count and on one, medians of 5, on the host as it is loaded.
Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def udp_drops(port: int):
    """The ``drops`` column of the local UDP socket on ``port``."""
    for line in open("/proc/net/udp").read().splitlines()[1:]:
        f = line.split()
        if int(f[1].split(":")[1], 16) == port:
            return int(f[-1])
    return None


def one_trial() -> dict:
    from veneur_tpu_torch import native
    from veneur_tpu_torch.core.config import Config
    from veneur_tpu_torch.loadgen import controller
    from veneur_tpu_torch.loadgen.spec import WorkloadSpec

    senders = []
    base = native.LoadgenSender

    class Recorded(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            senders.append(self)

    native.LoadgenSender = Recorded
    cfg = Config(statsd_listen_addresses=["udp://127.0.0.1:0"],
                 interval="0.5s", num_workers=1, num_readers=1,
                 percentiles=[0.5, 0.99],
                 read_buffer_size_bytes=8 * 1048576,
                 ssf_span_uniqueness_rate=0.0)
    h = controller.LoadHarness(cfg, WorkloadSpec(num_keys=500,
                                                 ring_lines=5_000),
                               device="cpu")
    port = h._sock.getpeername()[1]
    flushes, passes, began = [], [], [0.0]
    flush = h.server.flush

    def timed_flush(*a, **kw):
        t, c = time.perf_counter(), time.thread_time()
        out = flush(*a, **kw)
        flushes.append((time.perf_counter() - t, time.thread_time() - c,
                        dict(h.server.last_flush_phases)))
        return out

    def on_gc(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        elif time.perf_counter() - began[0] > 0.01:
            passes.append((info["generation"],
                           time.perf_counter() - began[0]))

    h.server.flush = timed_flush
    gc.callbacks.append(on_gc)
    ctx = h.server.workers[0]._native
    h.server.set_lock_stats(True)
    try:
        before = h.server.ingress_stats()["samples_processed"]
        trial = controller.run_trial(h, 20_000, 2)
        sent = sum(s.sent_lines for s in senders)
        deadline = time.time() + 20
        while (h.server.ingress_stats()["samples_processed"] - before
               < sent and time.time() < deadline):
            time.sleep(0.02)
        got = h.server.ingress_stats()["samples_processed"] - before
        drops = udp_drops(port)
        locks = ctx.lock_stats()
    finally:
        gc.callbacks.remove(on_gc)
        h.server.set_lock_stats(False)
        native.LoadgenSender = base
        h.close()
    keys = ("duration_s", "flushes", "sent_lines", "accepted_lines",
            "cadence_ok", "tick_block_ms", "flush_ms", "ingest_stall_ms",
            "warmup")
    return {"passed": trial["passed"], "loss": trial["loss_frac"],
            "cadence": trial["cadence_frac"], "load": os.getloadavg()[0],
            "intervals": [{k: iv[k] for k in keys}
                          for iv in trial["intervals"]],
            "sent": sent, "processed": got, "shed": trial["total_shed"],
            "udp_drops": drops,
            "lock": {k: locks[k] for k in ("acquisitions", "contended",
                                           "wait_ns_total", "hold_ns_total")},
            "lock_wait_max_ms": max(locks["wait_ns_samples"] or [0]) / 1e6,
            "lock_hold_max_ms": max(locks["hold_ns_samples"] or [0]) / 1e6,
            "flushes": flushes, "gc_passes_over_10ms": passes}


def fold_threads() -> dict:
    import torch

    import port_probe_tdigest as ptd
    from veneur_tpu_torch.core import worker

    fields, v, w, _ = ptd.fold_inputs(1_024, 64, 3, "cpu", edges=False)
    stage = worker.DenseStage(v, w)
    out = {}
    for n in (torch.get_num_threads(), 1):
        torch.set_num_threads(n)
        worker.fold_staged(fields, stage)
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            worker.fold_staged(fields, stage)
            ts.append(time.perf_counter() - t)
        out[f"threads_{n}_ms"] = sorted(ts)[2] * 1e3
    out["load"] = os.getloadavg()[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--out", default="chiprun_out/trial_diag.jsonl")
    ap.add_argument("--fold-threads", action="store_true",
                    help="time the CPU staged fold on 8 and 1 threads")
    args = ap.parse_args()
    if args.fold_threads:
        print(json.dumps(fold_threads()), flush=True)
        return 0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    for i in range(args.trials):
        rec = {"trial": i, **one_trial()}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in ("trial", "passed", "loss",
                                              "cadence", "sent",
                                              "processed")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
