"""What the port's soaks and measuring tools share (tools/port_soak_*.py,
tools/port_bench_*.py): the blaster workload, RSS sampling and its split,
tail draining, the device check, the card's line and the host's cores,
warming the device before a clock starts, device memory and launches,
the fleet soaks' line batching and exact global accounting, and atomic
artifact writes. The port's copy of tools/_soak_common.py, with two
departures: an artifact lands under chiprun_out/ (or VENEUR_ARTIFACT_DIR),
never beside the JAX system's root *_SOAK.json files, and ``device_arg``
refuses to run on the CPU unless asked to. Imports the standard library
and tools/port_probe_extract.py's ``card_line``; the soaks import torch
and the port.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time

from port_probe_extract import card_line  # noqa: F401 (the soaks' import)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT_DIR = os.path.join(REPO, "chiprun_out")


def rss_mb() -> int:
    """CURRENT resident set (not ru_maxrss — that's a monotonic peak
    that hides both recoveries and slow leaks under its high-water
    mark)."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") // (1 << 20)


def rss_split() -> dict:
    """The resident set's parts (MB): ``statm_shared`` (``/proc/self/
    statm``'s third field, the resident pages backed by a file or shared
    memory: mapped libraries and files, shared between processes that
    map them) and ``statm_own`` (the rest, the process's own), then
    ``/proc/self/status``'s RssAnon, RssFile and RssShmem and
    ``/proc/self/smaps_rollup``'s Anonymous and Shared/Private
    Clean/Dirty where the kernel gives them; ``maps_file``, the address
    space mapped from files (``/proc/self/maps``, resident or not), for
    a kernel that reports no shared pages; and ``smaps_by_file``, the
    resident set by mapped file where ``/proc/self/smaps`` gives a
    ``Rss:`` line a mapping."""
    page = os.sysconf("SC_PAGE_SIZE")
    with open("/proc/self/statm") as f:
        _size, resident, shared = (int(v) for v in f.read().split()[:3])
    out = {"statm_shared": shared * page >> 20,
           "statm_own": (resident - shared) * page >> 20}
    mapped = 0
    with open("/proc/self/maps") as f:
        for line in f:
            fields = line.split(maxsplit=5)
            if len(fields) == 6 and fields[5].startswith("/"):
                lo, hi = fields[0].split("-")
                mapped += int(hi, 16) - int(lo, 16)
    out["maps_file"] = mapped >> 20
    for path, keys in (("/proc/self/status",
                        ("RssAnon", "RssFile", "RssShmem")),
                       ("/proc/self/smaps_rollup",
                        ("Anonymous", "Shared_Clean", "Shared_Dirty",
                         "Private_Clean", "Private_Dirty"))):
        try:
            with open(path) as f:
                for line in f:
                    key, _, val = line.partition(":")
                    if key in keys:
                        out[key] = int(val.split()[0]) // 1024
        except OSError:
            pass
    try:
        with open("/proc/self/smaps") as f:
            by_file = smaps_by_file(f)
    except OSError:
        by_file = None
    if by_file is not None:
        out["smaps_by_file"] = by_file
    return out


def smaps_by_file(lines, top: int = 12):
    """The resident set by mapped file from ``/proc/<pid>/smaps`` lines,
    largest first: ``[[name, MB], ...]`` for the ``top`` largest (an
    anonymous mapping counts under ``[anon]``, a named special one such
    as ``[heap]`` under its name), then ``[others, MB]`` for the rest.
    None where no mapping has a ``Rss:`` line."""
    kb: dict = {}
    name = None
    for line in lines:
        first = line.split(maxsplit=1)[0] if line.strip() else ""
        if "-" in first and not first.endswith(":"):
            # a mapping's header: range perms offset dev inode [path]
            fields = line.split(maxsplit=5)
            name = (fields[5].strip() if len(fields) == 6 else "") \
                or "[anon]"
        elif first == "Rss:" and name is not None:
            kb[name] = kb.get(name, 0) + int(line.split()[1])
    if not kb:
        return None
    ranked = sorted(kb.items(), key=lambda kv: (-kv[1], kv[0]))
    out = [[n, round(v / 1024.0, 1)] for n, v in ranked[:top]]
    rest = sum(v for _, v in ranked[top:])
    if rest:
        out.append(["others", round(rest / 1024.0, 1)])
    return out


def make_blaster(port: int, tid: int, stop: threading.Event, sent: dict,
                 lock: threading.Lock, pps: float | None = None):
    """The canonical soak workload: 9-line datagrams of timers (800
    series/thread) + counters + HLL sets, one garbage line per 400
    packets. pps=None means unthrottled (overload mode); otherwise the
    loop paces to the target without bursting after a stall."""

    def blast() -> None:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        i = p = l = g = 0
        next_t = time.perf_counter()
        while not stop.is_set():
            lines = []
            for j in range(3):
                k = (i * 3 + j) % 800
                lines.append(f"soak.t{tid}.timer{k}:{k % 97}|ms")
                lines.append(f"soak.t{tid}.count:{1}|c")
                lines.append(f"soak.set:{i % 5000}|s")
            if i % 400 == 0:
                lines.append("garbage###not-a-metric")
                g += 1
            s.sendto("\n".join(lines).encode(), ("127.0.0.1", port))
            p += 1
            l += len(lines)
            i += 1
            if pps is not None:
                next_t += 1.0 / pps
                delay = next_t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                elif delay < -0.05:
                    # fell behind (scheduler stall): resync instead of
                    # bursting the backlog — even a sub-second burst can
                    # overflow the UDP socket buffer and drop datagrams
                    next_t = time.perf_counter()
            elif i % 200 == 0:
                time.sleep(0.002)  # overload mode: ~100k packets/s offered
        s.close()
        with lock:
            sent["packets"] += p
            sent["lines"] += l
            sent["garbage"] += g

    return threading.Thread(target=blast, daemon=True)


def drain_tail(srv) -> None:
    """Roll the native pipelines' tail (trailing samples + error
    counters) into the workers, under the worker locks — the flush tick
    may not have run since the last packets landed."""
    for i, w in enumerate(srv.workers):
        if w._native is not None:
            with srv._worker_locks[i]:
                w.drain_native()


def udp_drops(port: int) -> int:
    """Kernel-level receive-buffer drops for the UDP socket bound on
    `port` (/proc/net/udp `drops` column)."""
    want = f":{port:04X}"
    total = 0
    try:
        with open("/proc/net/udp") as f:
            next(f)
            for line in f:
                parts = line.split()
                if parts[1].endswith(want):
                    total += int(parts[-1])
    except OSError:
        pass
    return total


def device_arg(ap) -> None:
    """The soaks' ``--device``: the card unless ``cpu`` is asked for."""
    ap.add_argument("--device", default="cuda",
                    help="torch device of the server's pools (default: "
                         "the card; the CPU only when asked for)")


def require_device(device: str) -> str:
    """``device`` if it can run here; without CUDA a card device exits
    2 (the soak never carries on on the CPU unasked)."""
    import torch

    if device != "cpu" and not torch.cuda.is_available():
        print(f"CUDA is not available for --device {device}; pass "
              "--device cpu to run on the CPU", file=sys.stderr)
        sys.exit(2)
    return device


def host_cores() -> int:
    """The cores this process may run on (``os.sched_getaffinity``)."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    ``cpu``: the measuring tools' ``device`` key."""
    return "cpu" if device == "cpu" else card_line()


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    timed region ends after the device work it started."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def warm_device(device: str, mark=None) -> dict:
    """Build the native library, make the device's context and load the
    port's kernel libraries (building each from its sources on first
    use) before a soak's clock starts, so that the first use's ``g++``
    and ``nvcc`` builds do not fall inside the first intervals, their
    forward deadlines and the breakers. ``mark(stage)`` (optional) is
    called after each device step: ``device_context``, then
    ``kernels_loaded``. Returns each step's seconds; on the CPU only the
    native library's."""
    from veneur_tpu_torch import native

    t = time.perf_counter()
    native.build()
    native_s = round(time.perf_counter() - t, 3)
    if device == "cpu":
        return {"native_s": native_s}
    import torch

    from veneur_tpu_torch.ops import extract_kernel as ek
    from veneur_tpu_torch.ops import hll_kernel
    from veneur_tpu_torch.ops import tdigest_kernel as tk

    t0 = time.perf_counter()
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if mark is not None:
        mark("device_context")
    ek.load()
    hll_kernel.load()
    tk.load()
    t2 = time.perf_counter()
    if mark is not None:
        mark("kernels_loaded")
    return {"native_s": native_s, "context_s": round(t1 - t0, 3),
            "kernels_s": round(t2 - t1, 3)}


def device_memory_mb(device: str):
    """``{"allocated": MB, "reserved": MB}`` of the caching allocator on
    the card (``torch.cuda.memory_allocated`` and ``memory_reserved``);
    None on the CPU."""
    if device == "cpu":
        return None
    import torch

    return {"allocated": round(torch.cuda.memory_allocated() / 1048576.0, 1),
            "reserved": round(torch.cuda.memory_reserved() / 1048576.0, 1)}


def kernel_launches() -> dict:
    """Each main-path kernel's launch count now, by the kernels line's
    names (K2a the compress, K2b the spill fold's chain, K3 the staged
    fold); only a card tensor launches, the CPU's plain versions count
    nothing."""
    from veneur_tpu_torch.core import worker as tw
    from veneur_tpu_torch.ops import extract_kernel as ek
    from veneur_tpu_torch.ops import hll
    from veneur_tpu_torch.ops import tdigest as td

    return {"K1": ek.flush_extract.launches,
            "K2a": td.compress_rows.launches, "K2b": td.add_batch.launches,
            "K3": tw.fold_staged.launches, "K4": hll.insert_batch.launches,
            "K5": hll.estimate.launches}


def launches_since(before: dict) -> dict:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


def stream_deltas(prev: dict, cur: dict) -> dict:
    """The proxy's stream telemetry between two ``forward_stats()
    ["stream"]`` reads: deltas clamp at 0, since a reshard retires
    clients and the aggregate (a sum over the current clients) can step
    down with them."""
    def delta(key):
        return max(0, cur.get(key, 0) - prev.get(key, 0))

    return {"acked_delta": delta("acked_total"),
            "reconnects_delta": delta("reconnects"),
            "window_stalls_delta": delta("window_stalls"),
            "unacked_frames": cur["unacked_frames"],
            "window_current": cur.get("window_current", 0),
            "shrink_delta": delta("shrink_events")}


def send_lines(server, lines: list, max_len: int) -> None:
    """Hand ``lines`` to ``server.process_metric_packet`` as datagrams of
    at most ``max_len`` bytes (the fleet soaks' packet path)."""
    batch, size = [], 0
    for line in lines:
        if size + len(line) + 1 > max_len and batch:
            server.process_metric_packet(b"\n".join(batch))
            batch, size = [], 0
        batch.append(line)
        size += len(line) + 1
    if batch:
        server.process_metric_packet(b"\n".join(batch))


def fleet_lines(it: int, s_histo: int, s_counter: int) -> list:
    """One interval of the fleet soaks' traffic: a timer sample for each
    of ``s_histo`` series and a 2-increment for each of ``s_counter``
    counters, all ``veneurglobalonly`` so the globals emit every
    exactly-summable total."""
    lines = [b"soak.h%d:%d|ms|#shard:%d,veneurglobalonly"
             % (i, (i * 31 + it) % 997, i % 16) for i in range(s_histo)]
    lines += [b"soak.c%d:2|c|#veneurglobalonly" % i
              for i in range(s_counter)]
    return lines


def global_totals(servers, pcts: list, aggs: list) -> tuple:
    """Flush every worker of every global in ``servers`` and sum the soak
    counters' values and the soak timers' ``.count`` aggregates: the
    fleet soaks' exact conservation totals."""
    from veneur_tpu_torch.core.flusher import (device_quantiles,
                                               generate_inter_metrics)
    from veneur_tpu_torch.core.metrics import (HistogramAggregates,
                                               MetricType)

    ha = HistogramAggregates.from_names(aggs)
    qs = device_quantiles(pcts, ha)
    counter_total = histo_count_total = 0.0
    for srv in servers:
        metrics = []
        for w, lock in zip(srv.workers, srv._worker_locks):
            with lock:
                snap = w.flush(qs, 10.0)
            metrics.extend(generate_inter_metrics(snap, False, pcts, ha))
        for m in metrics:
            if m.type == MetricType.COUNTER and m.name.startswith("soak.c"):
                counter_total += m.value
            if m.name.endswith(".count") and m.name.startswith("soak.h"):
                histo_count_total += m.value
    return counter_total, histo_count_total


def artifact_path(name: str) -> str:
    return os.path.join(os.environ.get("VENEUR_ARTIFACT_DIR", ARTIFACT_DIR),
                        name)


def write_artifact(name: str, payload: dict) -> str:
    # VENEUR_ARTIFACT_DIR redirects the artifact; the default is
    # chiprun_out/, so no run writes over the JAX system's root copies
    path = artifact_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(path + ".tmp", path)
    return path
