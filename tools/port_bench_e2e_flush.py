#!/usr/bin/env python3
"""End-to-end ``Server.flush()`` latency of the port, with its phases.

The port of tools/bench_e2e_flush.py: a real port ``Server`` with native
C++ ingest, S unique timer series driven through the DogStatsD packet
path (parse -> directory -> staging plane), then one full
``Server.flush()`` (swap, the staged fold K3, the extract K1, generation,
a blackhole sink) against the reference's 10 s interval budget. A cold
round (pool growth, first launches) then one steady-state round, as in
the JAX tool; ``--chunked`` runs under the deadline governor
(``flush_chunk_target_ms``, K1 once a chunk) with one more warmup round;
``--shards N`` runs N series shards; ``--scaling`` a curve of sizes (and
with ``--shards`` the sharded capacity curve).

Same flags, environment and JSON keys as the JAX tool: VENEUR_E2E_SERIES
(default 2^20 on the card, 2^16 on the CPU), VENEUR_E2E_SAMPLES_PER_SERIES
(4), VENEUR_E2E_SCALING_SIZES, VENEUR_E2E_CHUNK_TARGET_MS (500). Four
samples a series stay under the staging depth of 64, so a flush's fold
is one K3 launch (a shard), then K1.

Departures from the JAX tool:
- ``--device`` (default ``cuda``; exits 2 without CUDA, ``--device cpu``
  runs on the CPU); ``platform`` is the torch device type.
- XLA's forced host devices become ``shard_devices``, the tool's device
  repeated N times (N shards on one card, as chip_smoke 16a puts them).
- Added keys: ``device`` (the card's name and power limit), ``cores``
  (``os.sched_getaffinity``), ``launches`` (by kernel, the steady
  round's ingest and flush) and ``device_memory_mb`` (the caching
  allocator after the steady flush, and its peak).
- The native library, the card's context and the kernel libraries are
  built before any clock starts; a flush ends in its readback.
- Every artifact (E2E_FLUSH.json, the cold partial, E2E_SCALING.json)
  goes under chiprun_out/ (or VENEUR_ARTIFACT_DIR), never the root.

Usage:
    python3 tools/port_bench_e2e_flush.py                 # 2^20 on the card
    python3 tools/port_bench_e2e_flush.py --scaling [--chunked] [--shards 4]
    python3 tools/port_bench_e2e_flush.py --device cpu    # 2^16 on the CPU
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from port_soak_common import (  # noqa: E402
    device_arg, device_line, device_memory_mb, host_cores, kernel_launches,
    launches_since, require_device, sync, warm_device, write_artifact)


def build_datagrams(series: int, samples_per_series: int,
                    max_len: int) -> list[bytes]:
    """Multi-line DogStatsD datagrams covering `series` unique timer
    series (name + one tag varied), each series hit
    `samples_per_series` times (the JAX tool's bytes)."""
    datagrams = []
    lines = []
    size = 0
    for rep in range(samples_per_series):
        for i in range(series):
            line = b"e2e.m%d:%d|ms|#shard:%d" % (i, (i * 7 + rep) % 1000,
                                                 i % 64)
            if size + len(line) + 1 > max_len:
                datagrams.append(b"\n".join(lines))
                lines, size = [], 0
            lines.append(line)
            size += len(line) + 1
    if lines:
        datagrams.append(b"\n".join(lines))
    return datagrams


def memory_mb(device: str):
    """``device_memory_mb`` with the allocator's peak; None on the CPU."""
    mem = device_memory_mb(device)
    if mem is not None:
        import torch

        mem["peak_allocated"] = round(
            torch.cuda.max_memory_allocated() / 1048576.0, 1)
    return mem


def run_one(series: int, per: int, device: str, persist_partial: bool = False,
            chunk_target_ms: int = 0, shards: int = 0) -> dict:
    """Cold pass (pool growth, first launches) then one steady-state
    ingest+flush round: every interval sees the same series again
    (metrics expire at flush, so each round re-registers all series in a
    fresh epoch). Returns the steady-state measurements."""
    import torch

    from veneur_tpu_torch.core.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.sinks.blackhole import BlackholeMetricSink

    cfg = Config(interval="10s", percentiles=[0.5, 0.9, 0.99],
                 aggregates=["min", "max", "count"],
                 tpu_native_ingest=True, num_workers=1, num_readers=1,
                 flush_chunk_target_ms=chunk_target_ms,
                 series_shards=shards)
    shard_devices = ([torch.device(device)] * shards if shards > 1
                     else None)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    srv = Server(cfg, metric_sinks=[BlackholeMetricSink()], device=device,
                 shard_devices=shard_devices)
    if not srv.native_mode:
        print("warning: native ingest unavailable; using Python parser",
              file=sys.stderr)
    if shards > 1 and srv.workers[0].series_shards != shards:
        print(f"warning: series_shards={shards} did not engage "
              f"(have {srv.workers[0].series_shards}); measuring the "
              "single-device path", file=sys.stderr)

    t0 = time.perf_counter()
    datagrams = build_datagrams(series, per, cfg.metric_max_length)
    gen_s = time.perf_counter() - t0

    rounds = []
    # the series-sync thread's cadence, swept by hand inside the ingest
    # loop (its cost lands in ingest_s, off the swap's ingest lock)
    sync_every = max(1, len(datagrams) // 8)
    # the governor's rate EWMA re-sizes chunks after the cold flush
    n_rounds = 3 if chunk_target_ms else 2
    launches = None
    for rnd in range(n_rounds):
        before = kernel_launches()
        t0 = time.perf_counter()
        for i, d in enumerate(datagrams):
            srv.process_metric_packet(d)
            if i % sync_every == sync_every - 1:
                srv.sync_native_series_once()
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        final = srv.flush()
        sync(device)
        flush_s = time.perf_counter() - t0
        launches = launches_since(before)
        rounds.append((ingest_s, flush_s, dict(srv.last_flush_phases),
                       len(final), dict(srv.last_flush_chunks),
                       dict(srv.last_flush_transfers)))
        if rnd == 0 and persist_partial:
            # the cold round, kept in case the steady round is lost
            write_artifact("E2E_FLUSH.json", {
                "platform": torch.device(device).type, "series": series,
                "PARTIAL": "cold round only; steady-state round was "
                           "still running when this was written",
                "cold_ingest_s": round(rounds[0][0], 3),
                "cold_flush_s": round(rounds[0][1], 3),
                "cold_flush_phases": {k: round(v, 3)
                                      for k, v in rounds[0][2].items()},
            })
    mem = memory_mb(device)
    srv.shutdown()
    cold_ingest_s, cold_flush_s, _, _, _, _ = rounds[0]
    ingest_s, flush_s, phases, n_final, chunks, transfers = rounds[-1]

    n_samples = series * per
    bounded = {}
    if chunk_target_ms and chunks:
        # the degraded-mode contract: the flush may exceed the interval,
        # but every chunk must land near the sub-interval target
        bounded = {
            "chunk_target_ms": chunks["chunk_target_ms"],
            "chunks": chunks["chunks"],
            "chunk_rows_max": chunks["chunk_rows_max"],
            "chunk_max_s": round(chunks["chunk_max_s"], 3),
            "chunk_mean_s": round(chunks["chunk_mean_s"], 3),
            "chunk_under_target": (chunks["chunk_max_s"]
                                   < 2 * chunks["chunk_target_ms"] / 1000.0),
        }
    return {
        "series": series,
        **({"series_shards": shards} if shards > 1 else {}),
        "samples": n_samples,
        "datagram_gen_s": round(gen_s, 3),
        "cold_ingest_s": round(cold_ingest_s, 3),
        "cold_flush_s": round(cold_flush_s, 3),
        "ingest_s": round(ingest_s, 3),
        "ingest_samples_per_s": round(n_samples / ingest_s, 1),
        "flush_total_s": round(flush_s, 3),
        "flush_phases": {k: round(v, 3) for k, v in phases.items()},
        "inter_metrics": n_final,
        "inter_metrics_per_series": round(n_final / series, 2),
        "budget_s": 10.0,
        "fits_interval": flush_s < 10.0,
        "vs_baseline": round(10.0 / flush_s, 2),
        **({"bounded_degradation": bounded} if bounded else {}),
        **({"transfer_bytes": transfers} if transfers else {}),
        "launches": launches,
        "device_memory_mb": mem,
    }


def run_scaling(sizes, per: int, device: str, chunk_ms: int,
                shards: int) -> dict:
    """The --scaling artifact: one row a size, and with ``shards`` > 1 the
    capacity curve (series grow with the shard count from the smallest
    size)."""
    import torch

    rows = []
    for s in sizes:
        row = run_one(s, per, device, chunk_target_ms=chunk_ms)
        rows.append(row)
        print(json.dumps({"series": s,
                          "flush_total_s": row["flush_total_s"],
                          "fits_interval": row["fits_interval"],
                          "launches": row["launches"],
                          **({"bounded_degradation":
                              row["bounded_degradation"]}
                             if "bounded_degradation" in row else {})}),
              flush=True)
    row_keys = ("series", "series_shards", "ingest_samples_per_s",
                "flush_total_s", "flush_phases", "fits_interval",
                "bounded_degradation", "transfer_bytes", "launches",
                "device_memory_mb")
    out = {
        "platform": torch.device(device).type,
        "note": ("end-to-end Server.flush latency vs series count; "
                 "the flush programs are O(series)"),
        "samples_per_series": per,
        "budget_s": 10.0,
        **({"flush_chunk_target_ms": chunk_ms} if chunk_ms else {}),
        "rows": [{k: r[k] for k in row_keys if k in r} for r in rows],
        "scaling_largest_vs_smallest": round(
            rows[-1]["flush_total_s"] / max(rows[0]["flush_total_s"],
                                            1e-9), 2),
    }
    if shards > 1:
        srows = []
        d = 1
        while d <= shards:
            r = run_one(sizes[0] * d, per, device, chunk_target_ms=chunk_ms,
                        shards=d)
            srows.append({k: r[k] for k in row_keys if k in r})
            print(json.dumps({"series": sizes[0] * d, "series_shards": d,
                              "extract_s":
                                  r["flush_phases"].get("extract_s"),
                              "flush_total_s": r["flush_total_s"]}),
                  flush=True)
            d *= 2
        ex = [r["flush_phases"].get("extract_s", 0.0) for r in srows]
        out["sharded_rows"] = srows
        # per shard: rows, readback bytes and device chunk time are
        # constant by construction; the shards here share one device
        # (the chunk times exist with --chunked only; the JAX tool
        # raised without it)
        out["sharded_per_shard"] = []
        for r in srows:
            d = max(int(r.get("series_shards", 1)), 1)
            row = {"series_shards": d, "d2h_bytes_per_shard":
                   r["transfer_bytes"]["d2h_bytes"] // d}
            if "bounded_degradation" in r:
                row["device_chunk_s_per_shard"] = round(
                    r["bounded_degradation"]["chunk_max_s"] / d, 4)
            out["sharded_per_shard"].append(row)
        out["sharded_note"] = (
            "series scale proportionally with series_shards from the "
            "base size; per-shard rows and d2h readback bytes are "
            "constant by construction (see sharded_per_shard). Here the "
            "shards share one device, so wall-clock extract_s still "
            "grows with total series (sharded_extract_max_over_min); "
            "flat wall clock requires a device a shard.")
        out["sharded_extract_max_over_min"] = round(
            max(ex) / max(min(ex), 1e-9), 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    ap.add_argument("--scaling", action="store_true",
                    help="a curve of sizes -> E2E_SCALING.json")
    ap.add_argument("--chunked", action="store_true",
                    help="flush under the deadline governor")
    ap.add_argument("--shards", type=int, default=0,
                    help="series shards (on the tool's device repeated)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    on_card = device != "cpu"
    per = int(os.environ.get("VENEUR_E2E_SAMPLES_PER_SERIES", 4))
    chunk_ms = (int(os.environ.get("VENEUR_E2E_CHUNK_TARGET_MS", 500))
                if args.chunked else 0)
    warm = warm_device(device)
    added = {"device": device_line(device), "cores": host_cores()}
    print(json.dumps({"device": added["device"], "cores": added["cores"],
                      "warm_s": warm}), flush=True)

    if args.scaling:
        env_sizes = os.environ.get("VENEUR_E2E_SCALING_SIZES")
        if env_sizes:
            sizes = tuple(int(s) for s in env_sizes.split(","))
        else:
            sizes = ((1 << 16, 1 << 18, 1 << 20) if on_card
                     else (1 << 14, 1 << 16, 1 << 17))
        out = {**run_scaling(sizes, per, device, chunk_ms, args.shards),
               **added}
        path = write_artifact("E2E_SCALING.json", out)
        print(json.dumps({"wrote": path,
                          "scaling_largest_vs_smallest":
                              out["scaling_largest_vs_smallest"]}))
        return 0

    series = int(os.environ.get("VENEUR_E2E_SERIES",
                                1 << 20 if on_card else 1 << 16))
    import torch

    out = {"platform": torch.device(device).type,
           **run_one(series, per, device, persist_partial=True,
                     chunk_target_ms=chunk_ms, shards=args.shards),
           **added}
    path = write_artifact("E2E_FLUSH.json", out)
    print(json.dumps({"metric": "e2e_flush_latency_s",
                      "value": out["flush_total_s"], "unit": "s",
                      "vs_baseline": out["vs_baseline"],
                      "platform": out["platform"],
                      "flush_phases": out["flush_phases"],
                      "launches": out["launches"],
                      "device_memory_mb": out["device_memory_mb"],
                      "wrote": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
