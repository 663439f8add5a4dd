#!/usr/bin/env python3
"""The global tier's import throughput on the port: forward encode, wire
decode and the merge at the global's flush, end to end in one process.

The port of tools/bench_import.py. A local ``DeviceWorker`` on the tool's
device holds S timer series of four samples (the staged fold, K3, at its
flush); its snapshot encodes to a forwarded MetricBatch
(``codec.snapshot_to_wire``, the native encoder), and a global port
``Server`` applies it through ``handle_wire`` (C++ decode, batched
upsert, buffered digests) and through the Python protobuf path
(``handle_batch``). The global's first flush merges the buffered digests
on the device (K2a) and extracts them (K1). Then the proxy tier's route
of the same batch over three destinations: the byte-slicing wire path
against the per-metric Python path.

Same environment and JSON keys as the JAX tool: VENEUR_IMPORT_SERIES
(default 50,000), VENEUR_IMPORT_ROUNDS (2). Departures:
- ``--device`` (default ``cuda``; exits 2 without CUDA, ``--device cpu``
  on the CPU); ``platform`` is the torch device type.
- Added keys: ``device`` (the card's name and power limit), ``cores``,
  ``launches`` (by kernel: the local's flush, and each global's import,
  merge and steady rounds).
- Builds happen before any clock; the merge's time ends in its readback.
- IMPORT_SCALING.json goes under chiprun_out/ (or VENEUR_ARTIFACT_DIR),
  never the root.

Usage: python3 tools/port_bench_import.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from port_soak_common import (  # noqa: E402
    device_arg, device_line, host_cores, kernel_launches, launches_since,
    require_device, sync, warm_device, write_artifact)


def flush_qs():
    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates

    return device_quantiles([0.5], HistogramAggregates.from_names(["count"]))


def local_snapshot(series: int, device: str):
    """The local's flushed snapshot: S timer series ``m<i>`` tagged
    ``env:prod``, four gamma(2, 50) samples each (seed 0), as the JAX
    tool builds it."""
    from veneur_tpu_torch.core.directory import ScopeClass
    from veneur_tpu_torch.core.metrics import MetricKey
    from veneur_tpu_torch.core.worker import DeviceWorker

    w = DeviceWorker(initial_histo_rows=series, device=device)
    for i in range(series):
        w.directory.upsert_histo(
            MetricKey(name=f"m{i}", type="timer", joined_tags="env:prod"),
            ScopeClass.MIXED, ["env:prod"])
    w._ensure_histo(series)
    rng = np.random.default_rng(0)
    rows = ((np.arange(series * 4, dtype=np.int64)) % series
            ).astype(np.int32)
    w._device_histo_step(rows, rng.gamma(2.0, 50.0, series * 4
                                         ).astype(np.float32),
                         np.ones(series * 4, np.float32))
    return w.flush(flush_qs(), interval_s=10.0)


def run_global(name: str, blob: bytes, n: int, series: int, rounds: int,
               device: str):
    """One global applying ``blob`` through ``name`` (wire_native or
    python_pb): the cold apply, the flush that merges it, then the
    best of ``rounds`` steady applies. Returns (record, the merge's
    snapshot, merge_s, launches): the launches by kernel of the cold
    apply and its merge (``merge``) and of the whole run (``all``)."""
    from veneur_tpu_torch.core.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.distributed.import_server import ImportServer
    from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb

    fn = {"wire_native": lambda imp: imp.handle_wire(blob),
          "python_pb": lambda imp: imp.handle_batch(
              pb.MetricBatch.FromString(blob))}[name]
    qs = flush_qs()
    before = kernel_launches()
    g = Server(Config(interval="10s", percentiles=[0.5]), device=device)
    imp = ImportServer(g)
    try:
        # round 1: cold, every series is new to the process
        t0 = time.perf_counter()
        fn(imp)
        cold = time.perf_counter() - t0
        assert imp.received_metrics == n, (name, imp.received_metrics, n)
        # the flush closes the epoch and merges the buffered digests on
        # the device (K2a), then extracts them (K1)
        t0 = time.perf_counter()
        gsnap = g.workers[0].flush(qs, 10.0)
        sync(device)
        merge_s = time.perf_counter() - t0
        assert gsnap.directory.num_histo_rows == series
        merge_launches = launches_since(before)
        # steady state: the same series arrive again next interval
        best = None
        for _ in range(rounds):
            t0 = time.perf_counter()
            fn(imp)
            dt = time.perf_counter() - t0
            g.workers[0].flush(qs, 10.0)
            best = dt if best is None else min(best, dt)
        assert imp.received_metrics == n * (rounds + 1)
    finally:
        g.shutdown()
    return ({"cold_apply_s": round(cold, 3), "apply_s": round(best, 3),
             "metrics_per_s": round(n / best, 1)}, gsnap, merge_s,
            {"merge": merge_launches, "all": launches_since(before)})


def route_proxy(blob: bytes, n: int) -> dict:
    """The proxy tier's ring split of the batch over three destinations,
    the byte-slicing wire path against the per-metric Python path."""
    from veneur_tpu_torch.distributed.proxy import ProxyServer
    from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb

    class _Sink:
        def send_raw(self, payload, count):
            return True

        def send(self, sub):
            return True

    out = {}
    for pname, route_attr, arg in (
            ("proxy_wire", "_route_wire", blob),
            ("proxy_python", "_route_batch",
             pb.MetricBatch.FromString(blob))):
        proxy = ProxyServer(["a:1", "b:2", "c:3"])
        proxy._conn = lambda dest: _Sink()
        getattr(proxy, route_attr)(arg)  # warm
        t0 = time.perf_counter()
        getattr(proxy, route_attr)(arg)
        dt = time.perf_counter() - t0
        out[pname] = {"route_s": round(dt, 3),
                      "metrics_per_s": round(n / dt, 1)}
    return out


def run(series: int, rounds: int, device: str) -> dict:
    import torch

    from veneur_tpu_torch.distributed import codec

    before = kernel_launches()
    snap = local_snapshot(series, device)
    local_launches = launches_since(before)
    t0 = time.perf_counter()
    blob, n = codec.snapshot_to_wire(snap)
    encode_s = time.perf_counter() - t0

    results = {}
    launches = {"local_flush": local_launches}
    for name in ("wire_native", "python_pb"):
        results[name], _, merge_s, launches[name] = run_global(
            name, blob, n, series, rounds, device)
    results["device_merge_flush_s"] = round(merge_s, 3)
    results.update(route_proxy(blob, n))
    return {
        "platform": torch.device(device).type,
        "series": series,
        "batch_bytes": len(blob),
        "forward_encode_s": round(encode_s, 3),
        "results": results,
        "speedup_native_vs_python": round(
            results["python_pb"]["apply_s"]
            / results["wire_native"]["apply_s"], 2),
        "device": device_line(device),
        "cores": host_cores(),
        "launches": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    series = int(os.environ.get("VENEUR_IMPORT_SERIES", 50_000))
    rounds = int(os.environ.get("VENEUR_IMPORT_ROUNDS", 2))
    warm_device(device)
    out = run(series, rounds, device)
    path = write_artifact("IMPORT_SCALING.json", out)
    print(json.dumps({
        "metric": "import_apply_metrics_per_s",
        "value": out["results"]["wire_native"]["metrics_per_s"],
        "unit": "metrics/s",
        "vs_baseline": out["speedup_native_vs_python"],
        "platform": out["platform"],
        "device_merge_flush_s": out["results"]["device_merge_flush_s"],
        "launches": out["launches"], "wrote": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
