#!/usr/bin/env python3
"""Sustained-pipeline rate of the port's server, driven at wire rate.

Drives a live ``veneur_tpu_torch`` Server's real sockets with the C++
paced sender (native/loadgen.cpp, no Python per packet) and either
searches for the highest offered rate the pipeline holds without loss or
a missed flush (default), or, with --smoke, checks that it holds one
fixed rate across a few flush intervals (exit 1 on failure). The server
runs on the card unless --device cpu.

Usage:
    python3 tools/port_bench_sustained.py                      # search
    python3 tools/port_bench_sustained.py --smoke --rate 1e5   # one rate
    python3 tools/port_bench_sustained.py --save-ring ring.vlg # the ring
    python3 tools/port_bench_sustained.py --replay ring.vlg    # replay it
    python3 tools/port_bench_sustained.py --workload ssf       # + SSF

Prints the card's name and power limit, the kernel-side receive-buffer
cap (/proc/sys/net/core/rmem_max: a capped buffer shows up as loss), the
kernels' launches during the run, and one JSON summary as its last line;
the whole result goes to --json (default chiprun_out/
port_bench_sustained.json). It writes nothing at the repository root.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def rmem_max() -> int:
    """The kernel's cap on a socket's receive buffer, or -1 unread."""
    try:
        return int(Path("/proc/sys/net/core/rmem_max").read_text())
    except (OSError, ValueError):
        return -1


def bench_config(transport: str = "udp", interval: str = "2s",
                 readers: int = 1, flush_pipeline: bool = False,
                 emit_native: bool = True, set_store: str = "staged",
                 ring_lines: int = 0, keys: int = 0, ssf: bool = False):
    """tools/bench_sustained.py's server configuration, on the port
    (chip_smoke.py's phase 17 takes it too)."""
    from veneur_tpu_torch.core.config import Config

    listen = {"udp": "udp://127.0.0.1:0",
              "tcp": "tcp://127.0.0.1:0",
              "unixgram": "unixgram://" + os.path.join(
                  tempfile.gettempdir(),
                  "veneur_port_lg_%d.sock" % os.getpid())}[transport]
    return Config(
        statsd_listen_addresses=[listen],
        interval=interval,
        num_workers=1, num_readers=max(1, readers),
        percentiles=[0.5, 0.99],
        # a serious rcvbuf: kernel drops are measured as loss, not
        # hidden by a tiny default buffer
        read_buffer_size_bytes=8 * 1048576,
        flush_pipeline=flush_pipeline,
        flush_emit_native=emit_native,
        tpu_set_store=set_store,
        **({"loadgen_ring_lines": ring_lines} if ring_lines else {}),
        **({"loadgen_num_keys": keys} if keys else {}),
        **({"ssf_listen_addresses": ["udp://127.0.0.1:0"]} if ssf else {}),
    )


def settled_conservation(harness) -> dict:
    """The span books at a quiescent instant: the flush ticker keeps
    ingesting its own trace spans, so retry briefly instead of racing
    one snapshot against it."""
    s = {}
    for _ in range(40):
        s = harness.span_conservation()
        if s.get("balanced"):
            return s
        time.sleep(0.05)
    return s


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the server's device (cuda or cpu)")
    ap.add_argument("--json", default=str(
        ROOT / "chiprun_out" / "port_bench_sustained.json"),
        help="write the whole result to this file")
    ap.add_argument("--smoke", action="store_true",
                    help="single fixed-rate pass/fail run")
    ap.add_argument("--rate", type=float, default=5e5,
                    help="offered lines/s for --smoke / --replay")
    ap.add_argument("--intervals", type=int, default=0,
                    help="flush intervals per run (default: 3 smoke, "
                         "10 confirm)")
    ap.add_argument("--interval", default="2s",
                    help="server flush interval")
    ap.add_argument("--transport", default="udp",
                    choices=["udp", "tcp", "unixgram"])
    ap.add_argument("--max-loss", type=float, default=0.01)
    ap.add_argument("--min-cadence", type=float, default=0.75,
                    help="fraction of intervals whose flushes must land "
                         "on time (--smoke/--replay)")
    ap.add_argument("--start-rate", type=float, default=100e3)
    ap.add_argument("--max-rate", type=float, default=20e6)
    ap.add_argument("--bisect-steps", type=int, default=4,
                    help="search: bisection steps inside the bracket")
    ap.add_argument("--ring-lines", type=int, default=0,
                    help="override loadgen_ring_lines")
    ap.add_argument("--keys", type=int, default=0,
                    help="override loadgen_num_keys")
    ap.add_argument("--save-ring", metavar="PATH",
                    help="serialize the synth ring to PATH and exit")
    ap.add_argument("--replay", metavar="PATH",
                    help="drive a previously saved ring blob bit-exactly"
                         " instead of synthesizing")
    ap.add_argument("--flush-pipeline", action="store_true",
                    help="run the server with the stage-parallel flush "
                         "executor (core/pipeline.py)")
    ap.add_argument("--readers", type=int, default=1,
                    help="C++ reader threads sharing the listen port "
                         "(SO_REUSEPORT); with one worker and more than "
                         "one reader the server engages reader-sharded "
                         "ingest, and interval records carry per-reader "
                         "committed/dropped deltas")
    ap.add_argument("--pin-cpus", type=int, default=0, metavar="N",
                    help="pin this process (readers included) to the "
                         "first N online CPUs; 0 = no pinning")
    ap.add_argument("--emit-native", default="on", choices=["on", "off"],
                    help="native emit tier (native/emit.cpp)")
    ap.add_argument("--sink", default="channel",
                    choices=["channel", "serialize"],
                    help="channel: no serialization (packet-path "
                         "measurement); serialize: the datadog formatter "
                         "against a discarding opener")
    ap.add_argument("--set-store", default="staged",
                    choices=["staged", "dense"],
                    help="tpu_set_store: the workload's sets hold at most "
                         "tag_cardinality members, under the staged "
                         "store's promotion, so only the dense store "
                         "runs the set kernels")
    ap.add_argument("--workload", default="statsd",
                    choices=["statsd", "ssf"],
                    help="statsd-only, or mixed statsd+SSF: a second "
                         "paced sender offers span datagrams at "
                         "rate*--ssf-frac; the run asserts exact span "
                         "conservation")
    ap.add_argument("--ssf-frac", type=float, default=0.1,
                    help="SSF span rate as a fraction of the offered "
                         "rate (--workload ssf)")
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from veneur_tpu_torch.loadgen import WorkloadSpec

    cfg = bench_config(args.transport, args.interval, args.readers,
                       args.flush_pipeline, args.emit_native == "on",
                       args.set_store, args.ring_lines, args.keys,
                       args.workload == "ssf")
    spec = WorkloadSpec.from_config(cfg)
    if args.save_ring:
        ring = spec.build_ring()
        Path(args.save_ring).write_bytes(ring.serialize())
        print(json.dumps({"saved": args.save_ring,
                          "datagrams": len(ring),
                          "lines": ring.total_lines,
                          "content_hash": "%016x" % ring.content_hash}))
        return 0

    import torch

    if args.device != "cpu" and not torch.cuda.is_available():
        print("CUDA is not available: use --device cpu", file=sys.stderr)
        return 2
    import port_probe_extract as probe
    from veneur_tpu_torch import native
    from veneur_tpu_torch.loadgen import LoadHarness, run_trial
    from veneur_tpu_torch.loadgen.controller import (result_artifact,
                                                     search_sustained)
    from veneur_tpu_torch.ops import extract_kernel as ek
    from veneur_tpu_torch.ops import hll, hll_kernel

    card = probe.card_line() if args.device != "cpu" else "cpu"
    print(f"[bench] card: {card}", flush=True)
    print(f"[bench] rmem_max: {rmem_max()}", flush=True)
    t0 = time.perf_counter()
    builds = [native.build, native.build_loadgen]
    if args.device != "cpu":
        builds += [ek.build, hll_kernel.build]
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
    print(f"[bench] built in {time.perf_counter() - t0:.2f} s", flush=True)

    ring = None
    if args.replay:
        ring = native.LoadgenRing()
        ring.load(Path(args.replay).read_bytes())
        print(json.dumps({"replay": args.replay, "datagrams": len(ring),
                          "content_hash": "%016x" % ring.content_hash}),
              file=sys.stderr)
    if args.pin_cpus:
        try:
            os.sched_setaffinity(0, set(range(args.pin_cpus)))
        except (AttributeError, OSError) as e:
            print(f"cpu pinning unavailable: {e}", file=sys.stderr)
    ssf_frac = args.ssf_frac if args.workload == "ssf" else 0.0
    platform = (torch.cuda.get_device_name(0) if args.device != "cpu"
                else "cpu")
    t0 = time.perf_counter()
    harness = LoadHarness(cfg, spec, transport=args.transport, ring=ring,
                          sink_mode=args.sink, ssf_frac=ssf_frac,
                          device=args.device)
    ek.flush_extract.launches = 0
    hll.insert_batch.launches = hll.estimate.launches = 0
    out: dict = {"card": card, "rmem_max": rmem_max(),
                 "device": args.device}
    try:
        tw = time.perf_counter()
        if not harness.warmup():
            print("warmup: flush path never came up", file=sys.stderr)
            return 1
        out["warmup_s"] = time.perf_counter() - tw
        if args.smoke or args.replay:
            n = args.intervals or 3
            trial = run_trial(harness, args.rate, n,
                              max_loss=args.max_loss,
                              min_cadence=args.min_cadence)
            out.update({"trial": trial, "passed": trial["passed"]})
            summary = {
                "metric": "sustained_smoke_lines_per_s",
                "value": trial["accepted_lines_per_s"],
                "offered": args.rate, "loss_frac": trial["loss_frac"],
                "cadence_frac": trial["cadence_frac"],
                "passed": trial["passed"], "platform": platform}
            if ssf_frac > 0:
                cons = settled_conservation(harness)
                out["span_conservation"] = cons
                summary["passed"] = out["passed"] = bool(
                    trial["passed"] and cons.get("balanced")
                    and trial.get("total_spans_received", 0) > 0)
        else:
            search = search_sustained(
                harness, start_rate=args.start_rate,
                max_rate=args.max_rate,
                confirm_intervals=args.intervals or 10,
                bisect_steps=args.bisect_steps, max_loss=args.max_loss)
            out.update(result_artifact(spec, harness, search, platform))
            out["sink_mode"] = args.sink
            out["workload_kind"] = args.workload
            out["readers"] = args.readers
            out["passed"] = out["confirmed"]
            if ssf_frac > 0:
                out["schema"] = "span_sustained_v1"
                out["ssf_frac"] = ssf_frac
                out["span_conservation"] = settled_conservation(harness)
                out["passed"] = bool(
                    out["passed"]
                    and out["span_conservation"].get("balanced"))
            summary = {
                "metric": "sustained_pipeline_lines_per_s",
                "value": out["sustained_pipeline_lines_per_s"],
                "offered": out["sustained_offered_lines_per_s"],
                "confirmed": out["confirmed"],
                "trials": len(search["search_trials"]),
                "platform": platform}
    finally:
        harness.close()
    out["launches"] = {"flush_extract": ek.flush_extract.launches,
                       "hll_insert": hll.insert_batch.launches,
                       "hll_estimate": hll.estimate.launches}
    out["wall_s"] = time.perf_counter() - t0
    summary.update(launches=out["launches"], wall_s=out["wall_s"])
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(summary), flush=True)
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
