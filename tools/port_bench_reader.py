#!/usr/bin/env python3
"""Native (C++) against Python UDP reader drain rate on the port.

The port of tools/bench_reader.py. A live sender starves a reader on a
small host (the socket buffer overflows within a burst), so the quantity
measured is the drain rate: pre-fill the kernel buffer with a burst of
6,000 datagrams of 25 timer lines, then time how fast a port ``Server``'s
reader empties it (``packets_received``), best of three trials. The
native reader (native/dogstatsd.cpp) runs datagram -> parse -> staged
sample in a C++ thread with no GIL.

Same JSON keys as the JAX tool. Departures:
- ``--device`` (default ``cuda``; exits 2 without CUDA, ``--device cpu``
  on the CPU): the server's pools live there. The reader path does no
  device work (the staging depth absorbs every sample and the interval
  never ends), and ``launches`` records it.
- Added keys: ``device`` (the card's name and power limit), ``cores``
  (``os.sched_getaffinity``; the JAX tool's ``host_cores`` is
  ``os.cpu_count()``), ``launches``; each reader's record adds
  ``rcvbuf_asked`` and ``rcvbuf_reported``, the receive buffer the
  configuration asks for and the one ``getsockopt(SO_RCVBUF)`` reports
  (``rmem_max``, ``/proc/sys/net/core/rmem_max``, beside them), and
  ``lines_sent`` against ``lines_committed`` (the server's processed
  samples over the reader's trials), and ``best_send_drain_lines_per_s``
  (from the burst's first send to the last datagram counted: where the
  reader has a core of its own it drains while the burst is sent, so the
  drain alone can take no time).
- NATIVE_READER.json goes under chiprun_out/ (or VENEUR_ARTIFACT_DIR),
  never the root.

Usage: python3 tools/port_bench_reader.py [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from port_soak_common import (  # noqa: E402
    device_arg, device_line, host_cores, kernel_launches, launches_since,
    require_device, warm_device, write_artifact)

RCVBUF = 1 << 24
N_BURST = 6000  # fits the kernel rcvbuf cap of the JAX tool's host


def rmem_max() -> int:
    """The kernel's cap on a socket's receive buffer, or -1 unread."""
    try:
        with open("/proc/sys/net/core/rmem_max") as f:
            return int(f.read())
    except (OSError, ValueError):
        return -1


def run(native_readers: bool, device: str, trials: int = 3,
        n_burst: int = N_BURST, **overrides) -> dict:
    """One reader's lane; ``overrides`` are Config keys (a diagnosis's
    variants, say ``micro_fold=False``)."""
    from veneur_tpu_torch.core.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.sinks.blackhole import BlackholeMetricSink

    cfg = Config(interval="600s", num_workers=1, num_readers=1,
                 statsd_listen_addresses=["udp://127.0.0.1:0"],
                 tpu_stage_depth=4096,  # absorb all: measure the reader,
                 read_buffer_size_bytes=RCVBUF,  # not the device fold
                 tpu_native_readers=native_readers, **overrides)
    srv = Server(cfg, metric_sinks=[BlackholeMetricSink()], device=device)
    ports = srv.start()
    port = next(iter(ports.values()))
    reported = srv._sockets[0].getsockopt(socket.SOL_SOCKET,
                                          socket.SO_RCVBUF)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    dgrams = []
    for d in range(64):
        lines = [b"bench.t%d:%d|ms|#h:x" % (d * 25 + i, i % 997)
                 for i in range(25)]
        dgrams.append(b"\n".join(lines))
    best, best_sent, drained = 0.0, 0.0, 0
    lines0 = srv.ingress_counts()[0]
    try:
        for _ in range(trials):
            base = srv.packets_received
            t_send = time.perf_counter()
            for i in range(n_burst):
                s.sendto(dgrams[i % 64], ("127.0.0.1", port))
            t0 = time.perf_counter()
            deadline = t0 + 20
            got = 0
            while time.perf_counter() < deadline:
                got = srv.packets_received - base
                if got >= n_burst:
                    break
            t_end = time.perf_counter()
            drain_s = t_end - t0
            best = max(best, got * 25 / (drain_s + 1e-9))
            best_sent = max(best_sent, got * 25 / (t_end - t_send))
            drained = got
            time.sleep(0.3)
        committed = srv.ingress_counts()[0] - lines0
    finally:
        srv.shutdown()
        s.close()
    return {"native_readers": native_readers, "drained_dgrams": drained,
            "burst_dgrams": n_burst, "best_lines_per_s": round(best, 1),
            "rcvbuf_asked": RCVBUF, "rcvbuf_reported": reported,
            "lines_sent": trials * n_burst * 25,
            "lines_committed": committed,
            "best_send_drain_lines_per_s": round(best_sent, 1)}


def measure(device: str, trials: int = 3, n_burst: int = N_BURST) -> dict:
    before = kernel_launches()
    py = run(False, device, trials, n_burst)
    nat = run(True, device, trials, n_burst)
    cores = host_cores()
    return {
        "host_cores": os.cpu_count(),
        "python_reader": py,
        "native_reader": nat,
        "speedup_native_vs_python": round(
            nat["best_lines_per_s"] / max(py["best_lines_per_s"], 1e-9), 2),
        "note": ("drain-rate of a pre-filled kernel buffer; %d core(s) "
                 "for this process. Ratio is the signal." % cores),
        "device": device_line(device),
        "cores": cores,
        "rmem_max": rmem_max(),
        "launches": launches_since(before),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    warm_device(device)
    out = measure(device)
    path = write_artifact("NATIVE_READER.json", out)
    print(json.dumps({"metric": "native_reader_speedup",
                      "value": out["speedup_native_vs_python"],
                      "unit": "x",
                      "lines_per_s": out["native_reader"]["best_lines_per_s"],
                      "python_lines_per_s":
                          out["python_reader"]["best_lines_per_s"],
                      "rcvbuf_reported":
                          out["native_reader"]["rcvbuf_reported"],
                      "rmem_max": out["rmem_max"], "cores": out["cores"],
                      "launches": out["launches"], "wrote": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
