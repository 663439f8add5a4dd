#!/usr/bin/env python3
"""Profile one worker interval of the PyTorch port on the card.

    python3 tools/port_profile_interval.py [--json PATH]

Runs the 100k-series interval of chip_smoke.py (its ``interval_plan``
and ``run_interval``, sets and count_unique_timeseries included) on a
CUDA DeviceWorker once to warm up, then once under ``torch.profiler``
with a range around each step (process_metric, staging with its spill
folds, sets: the bulk set inserts, flush). Prints the card's name and power
limit, each step's wall seconds and device busy share (the union of
kernel intervals inside the step's range over its length), device time
by kernel name (top 15), and the peak device memory. Exits 2 without
CUDA. Timings under the profiler carry its overhead; chip_smoke.py's
untraced step times are the reference for wall time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile, record_function
    from veneur_tpu_torch.core import worker as tw
    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates
    from veneur_tpu_torch.protocol.dogstatsd import parse_metric

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    print(card, flush=True)
    qs = device_quantiles(cs.QS, HistogramAggregates.from_names(
        ["min", "max", "count"]))
    plan = cs.interval_plan(seed=5)
    kw = dict(compression=100.0, stage_depth=64, batch_size=16384,
              initial_histo_rows=4096, count_unique_timeseries=True)
    # warm-up interval: first-use kernel loads and allocator growth
    cs.run_interval(tw.DeviceWorker(**kw, device="cuda"), plan,
                    parse_metric, qs)
    torch.cuda.reset_peak_memory_stats()
    worker = tw.DeviceWorker(**kw, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _snap, traced = cs.run_interval(worker, plan, parse_metric, qs,
                                        step=record_function)
        wall = time.perf_counter() - t0
    events = prof.events()
    steps = ("process_metric", "staging", "sets", "flush")
    # device-side events: kernels and copies; the step ranges also show
    # on the device timeline as annotations, which are not work
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.name not in steps]
    ranges = {e.name: e.time_range for e in events
              if e.name in steps
              and e.device_type == torch.autograd.DeviceType.CPU}
    out = {"card": card, "wall_s": wall, "traced_step_s": traced,
           "steps": {}}
    for name, tr in ranges.items():
        inside = [(max(k.time_range.start, tr.start),
                   min(k.time_range.end, tr.end)) for k in kernels
                  if k.time_range.end > tr.start
                  and k.time_range.start < tr.end]
        length = tr.end - tr.start
        busy = _union_us(inside)
        out["steps"][name] = {"wall_s": length / 1e6,
                              "device_busy_s": busy / 1e6,
                              "busy_share": busy / length if length else 0,
                              "kernels": len(inside)}
        print(f"[profile] {name}: {length / 1e6:.4f} s, device busy "
              f"{busy / 1e6:.4f} s ({100 * busy / max(length, 1):.2f}%), "
              f"{len(inside)} kernels", flush=True)
    by_name: dict[str, list] = {}
    for k in kernels:
        acc = by_name.setdefault(k.name, [0.0, 0])
        acc[0] += k.time_range.end - k.time_range.start
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    out["kernels_by_device_time"] = [
        {"name": n[:120], "device_s": t / 1e6, "launches": c}
        for n, (t, c) in top]
    for row in out["kernels_by_device_time"]:
        print(f"[profile] {row['device_s']:.5f} s  x{row['launches']:<6} "
              f"{row['name']}", flush=True)
    out["device_s_total"] = sum(t for t, _ in by_name.values()) / 1e6
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    print(f"[profile] interval wall {wall:.3f} s under the profiler; "
          f"device time {out['device_s_total']:.4f} s in {len(kernels)} "
          f"kernels and copies; peak "
          f"device memory {out['peak_device_bytes'] / 2**30:.3f} GiB",
          flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
