#!/usr/bin/env python3
"""Where the port's Python threads lose time on a host: the measuring
tools' Python-thread lanes, each at the interpreter's default GIL switch
interval (5 ms) and at 0.5 ms.

- the reader tool's Python lane (tools/port_bench_reader.py ``run``):
  its server as configured, with the micro-fold loop off, and with its
  pools on the CPU, so a device's share and the micro-fold's can be told
  from the thread handoffs';
- the routed ingest lanes (tools/port_bench_ingest_scaling.py ``run``)
  from one and from four Python threads into four shards;
- one ring trial (tools/port_bench_ring_sustained.py ``RingHarness``,
  the tool's default shape) at ``--ring-rate``, with its attainment and
  conservation.

A variant whose rate rises with the shorter interval is held up by GIL
handoffs. Writes THREAD_DIAG.json under chiprun_out/ (or
VENEUR_ARTIFACT_DIR) and prints it; exits 2 without CUDA unless
``--device cpu``.

Usage: python3 tools/port_thread_diag.py [--device cuda|cpu]
       [--ring-rate 2e4] [--trials 2]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import port_bench_ingest_scaling as scaling  # noqa: E402
import port_bench_reader as reader  # noqa: E402
import port_bench_ring_sustained as ring  # noqa: E402
from port_soak_common import (  # noqa: E402
    device_arg, device_line, host_cores, require_device, warm_device,
    write_artifact)

SWITCH_INTERVALS = (0.005, 0.0005)


def ring_trial(rate: float, device: str) -> dict:
    """One 3-interval trial of the ring tool's default topology."""
    h = ring.RingHarness(3, 4, 100, 2000, True, 32, device=device)
    try:
        t = h.run_trial(rate, 3)
    finally:
        h.close()
    return {k: t[k] for k in ("ring_metrics_per_s", "attain_frac",
                              "loss_frac", "duplicates_observed",
                              "conservation_exact", "passed")}


def run(device: str, trials: int, ring_rate: float) -> dict:
    out = {"device": device_line(device), "cores": host_cores(),
           "runs": []}
    default = sys.getswitchinterval()
    try:
        for sw in SWITCH_INTERVALS:
            sys.setswitchinterval(sw)
            lanes = {"python_reader": reader.run(False, device, trials)}
            if sw == SWITCH_INTERVALS[0]:
                lanes["python_reader_micro_fold_off"] = reader.run(
                    False, device, trials, micro_fold=False)
                lanes["python_reader_cpu_pools"] = reader.run(
                    False, "cpu", trials)
            for name in list(lanes):
                rec = lanes[name]
                lanes[name] = {k: rec[k] for k in (
                    "best_lines_per_s", "best_send_drain_lines_per_s",
                    "drained_dgrams", "lines_sent", "lines_committed")}
            lanes["routed_1reader_4shards_lines_per_s"] = round(
                scaling.run(1, 4))
            lanes["routed_4readers_4shards_lines_per_s"] = round(
                scaling.run(4, 4))
            lanes["ring_trial"] = ring_trial(ring_rate, device)
            out["runs"].append({"switch_interval_s": sw, **lanes})
            print(json.dumps(out["runs"][-1]), flush=True)
    finally:
        sys.setswitchinterval(default)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    ap.add_argument("--trials", type=int, default=2,
                    help="reader trials a variant (best kept)")
    ap.add_argument("--ring-rate", type=float, default=2e4,
                    help="offered metrics/s of the ring trial")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    warm_device(device)
    out = run(device, args.trials, args.ring_rate)
    path = write_artifact("THREAD_DIAG.json", out)
    print(json.dumps({"wrote": path, "cores": out["cores"],
                      "device": out["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
