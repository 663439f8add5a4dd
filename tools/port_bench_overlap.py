#!/usr/bin/env python3
"""Flush/ingest overlap of the port at high series cardinality.

The port of tools/bench_overlap.py. The server's flush is two-phase:
``worker.swap()`` under the worker's ingest lock, ``extract_snapshot()``
outside it. This harness reproduces that locking (an ingest thread
taking the lock a batch, a flusher doing swap then extract) and measures
how long ingest is locked out during a full-pool extraction, in both
designs: ``locked_extract`` (the extraction under the lock) and
``overlapped`` (swap under the lock, extraction outside).

Same environment and JSON keys as the JAX tool: VENEUR_OVERLAP_SERIES
(default 2^20 on the card, 2^16 on the CPU), VENEUR_OVERLAP_BATCH
(default min(4 x series, 2^22) samples: 4M at 2^20), VENEUR_OVERLAP_
SECONDS (6). A batch adds four samples a row, so rows pass their staging
depth of 64 after 16 batches and the spill folds (K2b) start mid-phase;
the extraction runs the staged fold (K3) and the extract (K1).

Departures:
- ``--device`` (default ``cuda``; exits 2 without CUDA, ``--device cpu``
  on the CPU); ``platform`` is the torch device type and ``device`` the
  card's name and power limit (the JAX tool's ``device`` was its first
  JAX device).
- The ingester's batch time is its lock wait and its dispatch, as in the
  JAX tool: it does not wait for the device work the batch queued (a
  spill fold). The extraction's time ends in its readback.
- Added keys: ``cores`` and ``launches`` (by kernel, each phase).
- OVERLAP.json goes under chiprun_out/ (or VENEUR_ARTIFACT_DIR), never
  the root. A wedged ingester still ends the process with 3.

Usage: python3 tools/port_bench_overlap.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from port_soak_common import (  # noqa: E402
    device_arg, device_line, host_cores, kernel_launches, launches_since,
    require_device, warm_device, write_artifact)


def register_series(w, series: int) -> float:
    """Fill the (fresh) epoch's directory with `series` histogram rows and
    size the pool so extraction touches all of it. Returns the host-side
    directory build time."""
    from veneur_tpu_torch.core.directory import ScopeClass
    from veneur_tpu_torch.core.metrics import MetricKey

    t0 = time.perf_counter()
    for i in range(series):
        w.directory.upsert_histo(
            MetricKey(name=f"s{i}", type="histogram", joined_tags=""),
            ScopeClass.MIXED, [])
    directory_s = time.perf_counter() - t0
    w._ensure_histo(series)
    return directory_s


def build_worker(series: int, device: str):
    from veneur_tpu_torch.core.worker import DeviceWorker

    w = DeviceWorker(initial_histo_rows=series, device=device)
    directory_s = register_series(w, series)
    rng = np.random.default_rng(7)
    batch = int(os.environ.get("VENEUR_OVERLAP_BATCH",
                               min(series * 4, 1 << 22)))
    rows = ((np.arange(batch, dtype=np.int64) * 2654435761) % series).astype(
        np.int32)
    vals = rng.gamma(2.0, 50.0, batch).astype(np.float32)
    wts = np.ones(batch, np.float32)
    w._device_histo_step(rows, vals, wts)
    return w, directory_s, (rows, vals, wts)


def run_phase(w, lock, batch_arrays, qs, seconds: float, overlapped: bool,
              series: int):
    """One flush against a continuously ingesting thread. Returns ingest
    batch wall-times (lock wait + dispatch) partitioned into before/during
    the extraction window, plus swap/extract durations."""
    rows, vals, wts = batch_arrays
    stop = threading.Event()
    spans: list[tuple[float, float, float]] = []

    def ingester():
        i = 0
        while not stop.is_set():
            t0 = time.perf_counter()
            with lock:
                t_acq = time.perf_counter()
                # the swap resets the pool; real ingest recreates it on
                # first use (_upsert_histo -> _ensure_histo)
                w._ensure_histo(series)
                w._device_histo_step(rows, vals + np.float32(i * 1e-6), wts)
            spans.append((t0, t_acq, time.perf_counter()))
            i += 1
            # paced like real traffic (a batch every ~20 ms)
            stop.wait(0.02)

    t = threading.Thread(target=ingester, daemon=True)
    t.start()
    time.sleep(seconds / 2)  # baseline window

    if overlapped:
        t0 = time.perf_counter()
        with lock:
            sw = w.swap(qs)
        swap_s = time.perf_counter() - t0
        flush_start = time.perf_counter()
        snap = w.extract_snapshot(sw, qs)
        flush_end = time.perf_counter()
    else:
        flush_start = time.perf_counter()
        with lock:
            t1 = time.perf_counter()
            sw = w.swap(qs)
            snap = w.extract_snapshot(sw, qs)
        flush_end = time.perf_counter()
        swap_s = flush_end - t1
    extract_s = flush_end - flush_start
    assert snap.quantile_values is not None
    time.sleep(max(0.0, seconds / 2 - extract_s))
    stop.set()
    t.join(300)
    if t.is_alive():
        # a thread inside a device op at interpreter exit: report, then
        # skip finalization
        print(json.dumps({"error": "ingester thread wedged (>300s device"
                                   " op); phase unreliable"}),
              flush=True)
        os._exit(3)
    # a batch counts against the flush when its wall-time interval
    # overlaps the flush window; the lock wait is the design property
    before = [(a - s, e - s) for s, a, e in spans if e <= flush_start]
    during = [(a - s, e - s) for s, a, e in spans
              if e > flush_start and s < flush_end]
    return before, during, swap_s, extract_s


def pctile(xs: list[float], q: float):
    """Percentile rounded for the report, or None (JSON null) when no
    batch landed in the window."""
    if not xs:
        return None
    return round(float(np.percentile(np.asarray(xs), q)), 4)


def run(series: int, seconds: float, device: str) -> dict:
    import torch

    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates

    on_cpu = device == "cpu"
    qs = device_quantiles(
        [0.5, 0.9, 0.99], HistogramAggregates.from_names(["min", "max"]))
    lock = threading.Lock()
    out = {"series": series, "unit": "seconds",
           "platform": torch.device(device).type,
           "device": device_line(device), "cores": host_cores(),
           "launches": {}}
    if on_cpu:
        out["note"] = ("CPU run: the ingest thread shares the host's "
                       "cores with the extraction compute, so "
                       "during-extract batch times reflect CPU "
                       "contention, not the lock design; the card run is "
                       "the meaningful artifact")
    for name, overlapped in (("locked_extract", False), ("overlapped", True)):
        w, directory_s, batch_arrays = build_worker(series, device)
        out.setdefault("directory_build_s", round(directory_s, 3))
        # warm the extraction so the measured pass is steady-state, then
        # rebuild the epoch the warmup swap cleared
        w.extract_snapshot(w.swap(qs), qs)
        register_series(w, series)
        w._device_histo_step(*batch_arrays)

        before_l = kernel_launches()
        before, during, swap_s, extract_s = run_phase(
            w, lock, batch_arrays, qs, seconds, overlapped, series)
        out["launches"][name] = launches_since(before_l)
        waits_b = [x[0] for x in before]
        totals_b = [x[1] for x in before]
        waits_d = [x[0] for x in during]
        totals_d = [x[1] for x in during]
        out[name] = {
            "swap_s": round(swap_s, 4),
            "extract_s": round(extract_s, 4),
            "ingest_batches_during_extract": len(during),
            "lock_wait_p99_baseline_s": pctile(waits_b, 99),
            "lock_wait_p50_during_extract_s": pctile(waits_d, 50),
            "lock_wait_max_during_extract_s": pctile(waits_d, 100),
            "ingest_batch_p50_baseline_s": pctile(totals_b, 50),
            "ingest_batch_p99_baseline_s": pctile(totals_b, 99),
            "ingest_batch_p50_during_extract_s": pctile(totals_d, 50),
            "ingest_batch_max_during_extract_s": pctile(totals_d, 100),
        }
        del w

    ov, lk = out["overlapped"], out["locked_extract"]
    out["verdict"] = {
        # with the two-phase flush, ingest's worst lock wait during the
        # extraction should be far below the extraction itself
        "max_ingest_lock_wait_overlapped_s":
            ov["lock_wait_max_during_extract_s"],
        "max_ingest_lock_wait_locked_s":
            lk["lock_wait_max_during_extract_s"],
        "extract_s": ov["extract_s"],
        "ingest_proceeds_during_extract":
            ov["ingest_batches_during_extract"] > 0,
    }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    series = int(os.environ.get(
        "VENEUR_OVERLAP_SERIES", 1 << 16 if device == "cpu" else 1 << 20))
    seconds = float(os.environ.get("VENEUR_OVERLAP_SECONDS", 6.0))
    warm_device(device)
    out = run(series, seconds, device)
    path = write_artifact("OVERLAP.json", out)
    print(json.dumps({**out["verdict"], "launches": out["launches"],
                      "wrote": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
