#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (veneur_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Phases, each printed on its own lines; any mismatch raises and the
script exits non-zero:

1. setup: card name and power limit (nvidia-smi), nvcc build of every
   kernel of the path from the sources in this checkout (the flush
   extract, the HLL library and the t-digest folds, one nvcc each) and
   g++ build of the native C++ ingest library and the load generator from
   native/'s sources into build/native/, all started together; ptxas's
   report of each kernel.
2. kernel vs plain on the card: the flush extract kernel against its
   plain PyTorch version at S = 1,048,576 and S = 1,000,003 rows and at
   the main path's shapes (131,072 and 1,024 rows), C = 128,
   qs = [0.5, 0.9, 0.99], a seeded numpy pool with empty, single-centroid
   and full rows. Then every built variant R (rows per warp) over S
   around each chunk and block round, 4,099, 131,072 and 1,000,003 rows,
   P = 1, 3 and 16 (qs [1.0], the above, 16 from 0 to 1), a 4,099-row
   pool of edge rows (tools/port_probe_extract.edge_pool) and row-offset
   views [1:] of every field. All P+10 columns bitwise equal (NaN
   positions equal); median times of kernel and plain at S = 1,048,576,
   and of the kernel at the main path's shapes.
3. the variant probe (tools/port_probe_extract.py): per variant its
   ptxas report, bitwise equality at S = 1,000,003 and its time at
   S = 1,048,576; a torch.sum read-rate yardstick.
3b. the HLL kernels (tools/port_probe_hll.py): hll_insert bytewise and
   hll_estimate in f32 bits equal to their plain versions over pools of
   1 to 32,768 rows at p = 4, 8, 14 and 18 in every estimator regime;
   their times at the main path's shapes, the plain versions', the
   bounds, and scatter_reduce_ beside the insert; the insert also on
   all-distinct words and on 1,048,576 updates, beside an empty kernel at
   its grid (the launch floor).
3c. the t-digest folds (tools/port_probe_tdigest.py): K2a
   (compress_rows) bitwise equal to its plain version at [131,072, 192]
   (phase 4's staged fold), [1,024, 256], [65,536, 256] (import merges),
   [32,768, 256] (a 2-host mesh shard), [8,192, 1,152] (phase 10's import
   width) and ragged [4,099, 192] and [131,071, 256], each with 16 edge
   rows (+-0.0 in both orders, denormal means and weights, +-inf and NaN
   means, one centroid, an empty row, ties); K2b (add_batch) at (K, N) =
   (64, 256), (1,024, 65,536) and (16,384, 262,144), an edge batch and a
   batch all in one row, two rounds each; the signed zeros of digest min
   and max (XLA's order: -0.0 below +0.0, a NaN winning) on the card
   bitwise the CPU at widths 1, 9, 33 and 64, K2b's among them; the K2b
   chain's kernels in a torch.profiler trace (none of torch's). Medians
   of kernel (K2b: the whole chain from the unsorted batch, its sort
   included) and plain, the plain sort alone, and each kernel's bound
   (bytes over 3.35 TB/s). Then K3, the staged fold (core/worker.
   fold_staged), bitwise its plain chain at phase 4's [131,072, C = 128,
   B = 64], ragged 131,071 and 4,099 rows and B = 40, each dense, flat
   with unit weights and flat weighted and a dense mirror a third
   shorter, a 4-shard split of the first, and 16 edge rows each; one
   staged fold's torch.profiler trace (K3 alone, or the run fails); its
   median ms in each form, the plain chain's, the bound; the seconds it
   added.
3d. the JAX system's tools, ported (tools/port_*.py): td.cdf on digest
   rows (K2a's compress of [131,072, 192] digest candidates) at values
   on, next to, between and past every row's min and max, bitwise the
   CPU; the t-digest analysis's seven distributions at 100,000 samples
   through one digest row (K2b), every estimate bitwise the CPU run's and
   the worst q-error under 0.01; the differential fuzz's nine targets
   other than query at a fixed seed, 2 s each, with 0 divergences and
   device_fallback injecting all four fault kinds into a card worker
   (its faulted ops fail over to the CPU; K1, K2b, K3, K4 and K5 launch,
   ``launches_fuzz``), then query from its own seed: its quantile check
   diverges on every seed in both packages (ROADMAP §3, F9), so its
   divergence must be F9's, with the card's quantile_rows bitwise the
   CPU's there. The replay CLI's part runs in phase 15b, over its archive
   directory: ``--inspect``, ``--target`` into a card global (counters
   and gauges bitwise the flushed ones), ``--dedup`` twice (merged
   once). The phase's seconds are printed.
4. one worker interval at the mixed configuration of BASELINE.md
   (100k series, bench.py's "mixed" mix): 80,000 histogram/timer series
   made through process_metric, 40 samples each staged through
   _device_histo_step, 1,000 hot series with 200 samples each (past stage
   depth 64, so the spill fold runs), 10,000 counters, 9,000 gauges,
   sampled timers, and 25,000 set series: one line each through
   process_metric, then about 1.02 M set inserts through _device_set_step
   in 16,384-sample batches (64 series of 8,192 members, past the staged
   store's promotion to its dense tier; the rest of 20 members, sparse;
   members are strings, hashed as the parser hashes them);
   count_unique_timeseries on; then flush. The same interval on a second
   worker on the CPU must give bitwise the same snapshot (set estimates
   and registers and the unique-timeseries registers included).
4b. the same set traffic through set_store="dense" workers, card against
   CPU: a 32,768 x 16,384 int8 pool (512 MiB) on the card; every batch
   launches hll_insert and the flush hll_estimate over the whole pool.
4c. phase 4's interval rendered as about 45,000 DogStatsD datagrams
   (4.4 M lines: every bulk sample its series' line, every set member a
   set line) through workers with attach_native(), the C++ parser
   staging the samples: the card's snapshot must be bitwise equal to a
   native worker's on the CPU and to phase 4's Python-path snapshot. The
   flush compacts the C++ staging plane on the host, uploads it flat and
   rebuilds it on the card. Prints native_ingest_s, fold_s, the plane's
   upload bytes and the launches of the three kernels.
   In phases 4, 4b and 4c the CPU worker runs after the card's, in this
   process, so nothing else loads the host while the card's steps are
   timed; compare_snapshots holds the two snapshots to each other. The
   card's staged fold runs K3 and its spill folds (the hot series) K2b,
   the CPU's their plain versions: phases 4 and 4c fail unless both
   kernels launched.
5. server: the port's Server built by its factory with a UDP listener on
   port 0, a channel sink, a Datadog, a Prometheus-repeater and a
   forward-statsd sink on local listeners (HTTP, TCP, TCP), and
   count_unique_timeseries answers a few hundred real datagrams (set
   lines among them); one flush, columnar, through the native emit tier;
   its InterMetrics, its unique-timeseries tally and every byte its
   sinks sent equal a CPU server's over the same datagrams (one ``now``,
   one hostname, the idempotency keys' sender pinned). Two runs: the default configuration on traffic
   with no series past the staging depth, and micro_fold off on traffic
   whose two untagged series take 300 samples each, past the 64-deep
   staging plane, so the spill folds run (with micro-folds on, the
   native server's scheduler drains spill at times of its own, and spill
   cut at other points folds to other bits: ROADMAP.md section 3).
5b. each run's datagrams through a server with tpu_native_ingest and
   tpu_native_readers on: a C++ reader thread reads the socket (the
   script fails if a Python reader runs or native mode is off); its
   InterMetrics and tally equal the CPU server's of phase 5, and so do
   its sinks' Datadog series and other requests and its repeater and
   forward lines, as multisets.
   Phases 4 to 5b run the configuration's defaults, micro-folds and the
   device guard on (the workers' flush streams the staging plane through
   the mirror; the servers run the micro-fold scheduler; phase 5's spill
   run turns micro-folds off), and each fails on any guard fault, trip
   or degraded flush.
6. micro-folds at full width: phase 4's interval with micro_fold_once
   every 16 staging batches, on the card and on the CPU, and with
   micro-folds off on both; phase 4c's native interval with a micro-fold
   after every fourth drain, on the card. Every snapshot bitwise equal to
   phase 4's; micro-folds, mirror chunks and bytes, fold_s and the
   guarded calls of each run printed.
7. the guard on the card: phase 4's interval with faults injected at the
   dispatch seam (utils/faults.py): the first pool-growth pre-flight,
   spill fold, micro-fold scatter and set op each fault once (retried,
   replayed or dropped to the staging plane) and every extract faults;
   two faults in a row trip the breaker, the epoch goes on and flushes
   on the CPU: phase 4's snapshot, degraded. A first probe faults, a
   second re-admits the card, and a smaller interval runs on it,
   launching K1, K4 and K5 again. Then tools/port_guard_faults.py:
   a real allocator OOM through the HBM valve, and a device-side assert
   in a child process (classified lost, the probe fails, the CPU flushes
   on). The guard's host cost per call: a one-kernel op called directly
   and through the guard, in turns.
8. the egress at full width, after phase 5b (host work: no kernel
   runs): phase 4's card snapshot through generate_columnar
   (generate_s, object path against columnar), its materialize() equal
   to the object path as a multiset and its arrays bitwise the CPU
   snapshot's batch; then every ported metric sink (Datadog, SignalFx,
   the Prometheus repeater and pushgateway, forward-statsd, New Relic)
   of one factory-built server, on local listeners, flushes it through
   the server's negotiation in turn: the native tier on and off on the
   card's batch, on for the CPU's through the HTTP JSON sinks (Datadog,
   SignalFx, New Relic; the three line sinks' CPU arm is cut for the
   run's time). Every byte those sinks sent from the card's batch
   equals the CPU's (the Datadog bodies raw and inflated); native equals
   Python byte for byte for the lines, the exposition text and New
   Relic, and by value for the Datadog series and SignalFx points; the
   native encoders took every group of every native-capable sink. Each
   sink's seconds (native, Python), requests and bytes are printed.
9. reader shards at phase 4c's width: its datagrams dealt round-robin
   over 4 owned native contexts (ingest_owned, each reader's order
   kept) on the card, flushed through the stacked fold (the contexts'
   planes merged on the host into one flat plane, K3's staged fold);
   series-identical, bitwise, to a legacy worker fed the same datagrams
   in context order, and bitwise the sharded interval on the CPU; both
   card workers' staged folds launched K3. Prints
   fold_s with K3's time on the card over the interval's plane, the merge's
   seconds and each context's commits. Then phase 5b's server with
   num_readers 4 and the default reader_shards: 4 C++ reader threads in
   4 owned contexts, 8 UDP senders (each series on one flow); its
   InterMetrics, tally and sinks equal a Python-path CPU server's; each
   context's mutex record.
10. the global tier at bench.py's global_merge width: 8 port locals on
   the card (65,536 mixed-scope histogram and timer series over one
   series space, 40 samples each from the local's seed, 4,096 global
   counters and gauges, 1,024 mixed sets at p = 14) flush and forward in
   turn to a port global on the card with grpc_address and
   http_address, over gRPC streaming and (the first two locals: cut
   for the run's time) over HTTP /import. Every
   payload the global applied is replayed, in order, into a CPU global:
   the card global's snapshot (K1 over the 65,536 merged rows, K5 over
   the 1,024 merged sets) is bitwise the CPU global's and its
   forward-statsd sink's bytes equal; the native encoder and decoder
   took every gRPC payload. Prints each local's forward seconds, bytes
   and frames, the global's import seconds (decode, upsert), the merge
   at the swap, fold_s, extract_s, sets_s and its peak device memory;
   then merge_many at [8, 65,536, 128] on the card, bitwise the CPU's.
11. the SSF span path. 11a: bench.py's ssf_histo width (50,000
   indicator spans over 64 services, durations gamma(2.0, 5e6) ns from
   default_rng(3), indicator and objective timers, five passes each
   flushed) through a port server's native SSF path
   (handle_trace_packets_native, bursts of 4,096) and through its Python
   path with the columnar span pipeline, each on the card and on the
   CPU: every pass's snapshot card against CPU bitwise, and the native
   path's InterMetrics equal to the Python path's (uniqueness rate 0,
   one spill batch at the swap on both). 11b: phase 4's interval as the
   samples of about 280,000 spans of 16 samples (uniqueness rate 1.0):
   the native path at full width (spill folds, K1 at 131,072 rows, K4
   and K5 through the staged store's dense tier; on the card: its CPU
   twin is cut for the run's time) and the Python path on every 32nd
   span, card against CPU bitwise; then a factory-built
   server on the card with every listener of the slice, started: the
   spans of the series lines in turn over UDP (the C++ SSF reader),
   a unix stream socket and a unixgram socket, then 19,000 DogStatsD
   lines over mutual TLS (a CA and certificates made by openssl here),
   each sender paced and waited on; its snapshot bitwise a CPU server's
   fed the same in the same order. Span conservation from
   ingress_stats()["spans"] on every server; each arm's spans/s,
   flush_s and flush phases printed.
12. the proxy tier, right after phase 10 and from its outputs (the
   eight local snapshots and the gRPC global's snapshot and sink bytes,
   kept on the host): 12a, four fresh port globals on the card (import
   servers, forward-statsd taps) behind one port ProxyServer built as
   cli/proxy_main.py builds it (dedup and streaming on); port locals
   whose forward_address is the proxy forward the eight snapshots in
   turn over gRPC streaming, each fully delivered (the proxy's and the
   globals' counts) before the next; then each global flushes. Every
   series sits on the global the proxy's ring names, the four hold
   65,536 histogram rows, every row (digest arrays, quantiles, the ten
   aggregates), set estimate and scalar is bitwise phase 10's single
   global's, the four sinks' lines are its lines as a multiset, the
   proxy's ledgers are conserved, and K1 and K5 launched on every
   global. 12b: the same through two proxies, the locals' forward_address
   naming both (the factory's SpreadForwarder), both proxies used.
   Prints per local the delivery seconds, the proxy's route seconds (the
   routing worker's, the fragments' delivery to the globals included)
   and the fragments and bytes each global was handed; per global
   import_s, merge_at_swap_s, flush_s, fold_s, extract_s, sets_s; the
   peak device memory, the proxies' cpu_seconds (where the host has a
   per-thread schedstat) and each arm's wall time.
13. the live query path and per-tenant QoS at phase 4's width: phase
   4's interval with every series tagged tenant:t{i % 8} and the budget
   t7: 5,000 (10,625 of t7's series refused), a tenant sketch (top-k 8)
   and a QueryEngine on each worker. 13a: through the Python path on the
   card (its CPU twin is cut for the run's time; tests/test_torch_cuda.py
   holds every op's response to a CPU worker's): a query at the flush
   quantiles over every row is bitwise the flush's quantile_values, a
   32-quantile request runs K1's quantile blocks, and every op (host and
   device quantiles, scalars, cardinality over the 25,000 sets, top-k of
   each tenant, tenant totals, count-min estimates of 1,000 keys, epoch)
   answers; GET /metrics on the HTTP front is the
   exposition sink's body; the tallies conserve; the sketch pool the
   view captured is unchanged after the next interval's fold, and two
   query threads running through the next interval's ingest and flush
   only ever see one committed epoch's answers. The same series lines
   as datagrams through an attach_native() worker on the card (its CPU
   twin is cut for the run's time): refused rows kept and absent from
   every sink line, the ledger's counts the Python path's.
   Prints p50/p99 ms of 200 requests each (host quantiles, ad-hoc device
   quantiles with rotating qs, scalars, /metrics), K1's launches and ms
   at P = 4 and 32 over the view's fields, the sketch fold's seconds and
   the peak device memory with the view held against phase 4's. 13b:
   phase 5's server with query_listen_addrs (HTTP and gRPC) and the
   budgets, fed over UDP: after one flush both fronts answer what its
   sinks got, and its tenant.* and query.* counters and gauges equal a
   CPU twin's.
14. flush governance and the process lifecycle. 14a, right after phase
   7: phase 4's interval on a worker whose governor runs
   flush_chunk_target_ms 1, so the extraction launches K1 once per pow2
   row chunk (a contiguous slice of the pool with a shifted base, at
   least 8 chunks): the snapshot is bitwise phase 4's one-shot one, K1's
   launches equal the chunk count, and the chunk report (rows and
   milliseconds per chunk) and the transfer ledger's bytes are printed.
   14b: three intervals of phase 5's datagrams over UDP into a serial
   server and a flush_pipeline server on the card: InterMetrics and
   every sink byte equal. 14c, tools/soak_overload.py's shape cut to
   about 10 s: a native server (2 workers, 2 C++ readers, a 2 s
   interval, tpu_spill_cap 16,384 under a 262,144-sample pending batch,
   so the contexts shed before the pump drains) under two unthrottled
   blaster threads, self-telemetry to a local UDP socket: shed samples reported,
   the flushes keep at least 0.75 of the cadence, the spill-cap loop ran
   after every flush and each ingest.spill_cap gauge received is a change
   the loop made. 14d: the port's CLI in a subprocess on the card (native
   readers, enable_profiling): SIGHUP re-execs it on the same UDP socket
   and all 900 counter datagrams sent before, across and after the
   restart reach its forward-statsd listener, POST /quitquitquit exits 0,
   and the first image's torch.profiler trace holds K1's kernel.
15. the remaining sinks, the flush archive and the plugins, right after
   phase 8. 15a: phase 8's card batch (about 854,000 metrics) and its CPU
   twin through the VMB1 archive sink natively and in Python, the
   local-file and S3 plugins (the first quarter of the batch) and the
   blob plugin (a capturing opener, the clock pinned) and the Kafka
   metric sink into an in-process broker (the first 65,536 metrics of
   the batch): the native frame equals the
   Python frame, the native section encoder built every section of the
   native arms (a Python section there fails the run), and every frame,
   TSV, request body and produce request of the card batch equals the
   CPU batch's; seconds per sink and bytes per frame printed. 15b: a
   server built by build_server on the card with every key of this
   slice on (Kafka, Splunk HEC, X-Ray, LightStep, falconer, archive_dir,
   flush_file, aws_s3_bucket, archive_blob_bucket; each endpoint a local
   fake) takes phase 5's datagrams and 400 SSF spans and flushes once:
   K1 launched, the guard clean, the plugin pass ran, and every endpoint
   took the bytes a CPU-built server's took; its archive replays into a
   port global on the card whose counters and gauges are the flushed
   ones bitwise, and a dedup replay run twice merges once.
16. series shards and the mesh, right after 14a. 16a: phase 4's
   interval through workers with series_shards 4 on the one card
   (shard_devices repeats it), on the Python path and, from 4c's
   datagrams, the native path, micro-folds on: each snapshot bitwise
   phase 4's unsharded card snapshot, the Python path's InterMetrics
   equal to phase 4's; K1, K3, K4 and K5 launched at least once per shard
   (``launches_series``), sharding engaged (a quiet fall back fails the
   run). 16b: MESH_LOCALS card locals of MESH_SERIES series (phase 10's
   interval, cut in width) flush and encode their forward frames; a
   mesh global (tpu_mesh_devices 8, tpu_mesh_hosts 2) on a grid of the
   one card applies them through its ImportServer, and its CPU twin on
   a grid of the CPU: the snapshots bitwise equal, K1 and K2a once per
   series shard and K2b at least once (``launches_mesh``); the import,
   the merge and the flush timed.
17. the load generator, after every other phase, in a process of its
   own (``chip_smoke.py --loadgen-child``, started fresh as a server
   is, so no state of the earlier phases loads it; the parent logs its
   own threads, its GC-tracked objects and the time of one full
   collection just before): a LoadHarness
   (veneur_tpu_torch/loadgen) runs a server on the card with
   tools/port_bench_sustained.py's configuration (UDP, a 2 s interval,
   one worker, one C++ reader, the channel sink; the dense set store, so
   the workload's sets reach the set kernels) and drives its real socket
   with the C++ paced sender over the loadgen's default spec (a
   200,000-line ring). 17a: after the harness's warmup, LG_RATE lines/s
   for LG_INTERVALS intervals with no more than 1% loss and cadence at
   least 0.75, every sample accounted for, K1, K4 and K5 launched.
   17b: search_sustained on the same harness (LG_SEARCH); prints the
   confirmed sustained rate, the offered rate, the confirmation run's
   breakdown and /proc/sys/net/core/rmem_max; fails without a trial or a
   confirmation record. 17c: a second harness with SSF spans at
   LG_SSF_FRAC of LG_RATE: the span books balance exactly. Each part's
   launches are ``launches_loadgen``.
18. on the line before the last two, the card's name and power limit;
   then a ``kernels`` JSON line: every kernel with its launches on the
   main path (phases 4 to 5b: counts reset just before, read just
   after), its agreement with the plain version, its time, the plain
   time and its bound; its launches in phase 6 (``launches_micro``), in
   phase 7's intervals (``launches_guard``), in the real-OOM run of
   tools/port_guard_faults.py (``launches_guard_oom``), in phase 9
   (``launches_shards``), in phase 10 (``launches_global``), in phase
   12 (``launches_proxy``), in phase 11 (``launches_spans``) and in
   phase 13 (``launches_query``), in 14a (``launches_governed``), in
   14b (``launches_pipeline``), in phase 15 (``launches_sinks``), in
   16a (``launches_series``), in 16b (``launches_mesh``), in 3d's fuzz
   (``launches_fuzz``) and in 17a, 17b and 17c (``launches_loadgen``),
   each counted from 0 just before its run; the probe's variants beside
   it, with their build report and launches (only the variant
   flush_extract launches has any).
19. the last line: {"ok": true, "device": {...}}.

Without CUDA, or without the veneur_tpu_torch package beside it, the
script prints no result and exits 2. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import struct
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

S_FULL = 1_048_576
S_RAGGED = 1_000_003
QS = [0.5, 0.9, 0.99]
# the worker interval (BASELINE.md mixed configuration, 100k series)
N_HIST, N_HOT, N_COUNTERS, N_GAUGES = 80_000, 1_000, 10_000, 9_000
# its sets: a quarter of bench.py's mixed series; the big ones promote to
# the staged store's dense tier (8,192 members give ~6,300 registers of
# 16,384, past promote_entries = 2,048)
N_SETS, N_SETS_BIG, BIG_MEMBERS, SMALL_MEMBERS = 25_000, 64, 8_192, 20
EDGE_ROWS = 4099
DEVICE = "cuda"
# the card's name and power limit (nvidia-smi), set by main() and
# printed beside phase 11's figures
CARD = ""
probe = None  # tools/port_probe_extract.py, imported by main()
probe_hll = None  # tools/port_probe_hll.py, imported by main()
probe_td = None  # tools/port_probe_tdigest.py, imported by main()
guard_faults = None  # tools/port_guard_faults.py, imported by main()
# phase 3d's tools (tools/port_tdigest_analysis.py,
# tools/port_fuzz_differential.py, tools/port_replay_archive.py)
analysis_tool = fuzz_tool = replay_tool = None
# micro-folds in phase 6: one every this many 16,384-sample staging
# batches (Python path) or drains (native path)
MICRO_EVERY, MICRO_EVERY_NATIVE = 16, 4
# phase 7's interval after re-admission: the big sets' first members,
# four of the staged store's 65,536-update compactions, past which they
# promote to its dense tier (hll_insert, then hll_estimate at the flush)
READMIT_SET_SAMPLES = 262_144


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def reset_peak() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_bytes() -> int:
    """Peak device memory since reset_peak (0 off the card)."""
    import torch

    return torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0


# -- phase 2 ------------------------------------------------------------------


def sweep_sizes(variants) -> list[int]:
    """Row counts around each variant's chunk (R rows) and block round
    (4 warps x R rows), plus larger ragged and main-path sizes."""
    small = {1}
    for r in variants:
        for t in (r, 4 * r):
            small.update({t - 1, t, t + 1})
    return sorted(n for n in small if n > 0) + [4099, 131_072, S_RAGGED]


def _compare(got, ref, what: str) -> float:
    same, err = probe.bitwise_equal(got, ref)
    if not same:
        import torch

        bad = (got != ref) & ~(torch.isnan(got) & torch.isnan(ref))
        rows = torch.nonzero(bad.any(1)).flatten()[:5].tolist()
        raise AssertionError(f"kernel != plain at {what}, rows {rows}")
    return err


def phase_kernel_vs_plain(ek):
    """The production kernel at the main path's shapes, every variant
    over the sweep of sizes, quantile counts, a row-offset view and the
    edge-row pool; all bitwise against the plain version. Returns the
    pool (kept for the probe) and the numbers for the kernels line."""
    import numpy as np
    import torch

    dev = torch.device(DEVICE)
    fields = [torch.from_numpy(a).to(dev)
              for a in probe.make_pool(S_FULL, seed=11)]
    qs = torch.tensor(QS, dtype=torch.float32, device=dev)
    # the main path's shapes too: the worker interval's and the server's
    # effective pool rows (the pow2 bucket extract_snapshot slices to)
    s_main = [max(1024, 1 << (N_HIST + N_HOT - 1).bit_length()), 1024]
    # and a series shard's rows of the first (phase 16a)
    s_main.append(s_main[0] // SERIES_SHARDS)
    errs = []
    for s in [S_FULL, S_RAGGED] + s_main:
        sub = [f[:s] for f in fields]
        got = ek.flush_extract(*sub, qs)
        sync()
        ref = ek.flush_extract_plain(*sub, qs)
        sync()
        errs.append(_compare(got, ref, f"S={s}"))
        n_nan = int(torch.isnan(got[:, 0]).sum())
        log(f"[kernel] S={s}: bitwise_equal=True max_abs_err={errs[-1]} "
            f"empty_rows={n_nan} shape={tuple(got.shape)}")
        if s == S_RAGGED:
            plain_check = ref
    qs_by_p = {1: [1.0], 3: QS, 16: list(np.linspace(0.0, 1.0, 16))}
    edge = [torch.from_numpy(a).to(dev)
            for a in probe.edge_pool(EDGE_ROWS, seed=13)]
    cases = []  # (label, fields, qs)
    for p, qv in qs_by_p.items():
        q = torch.tensor(qv, dtype=torch.float32, device=dev)
        cases += [(f"S={s} P={p}", [f[:s] for f in fields], q)
                  for s in sweep_sizes(ek.VARIANTS)]
        cases.append((f"edge rows S={EDGE_ROWS} P={p}", edge, q))
        cases.append((f"edge rows [1:] P={p}", [f[1:] for f in edge], q))
    cases.append((f"[1:] S={S_FULL - 1} P=3", [f[1:] for f in fields], qs))
    for label, sub, q in cases:
        ref = ek.flush_extract_plain(*sub, q)
        for r in ek.VARIANTS:
            got = ek._flush_extract_variant(r, *sub, q)
            sync()
            errs.append(_compare(got, ref, f"r{r} {label}"))
        del ref, got
    log(f"[kernel] variants r{', r'.join(map(str, ek.VARIANTS))}: each "
        f"bitwise equal to the plain version in {len(cases)} cases (S in "
        f"{sweep_sizes(ek.VARIANTS)} x P in 1, 3, 16; the {EDGE_ROWS}-row "
        f"edge pool ({', '.join(probe.EDGE_KINDS)}) and row-offset views "
        f"[1:] of it and of the {S_FULL}-row pool)")
    sub = fields
    k_ms = probe.cuda_ms(lambda: ek.flush_extract(*sub, qs), reps=21,
                         spin_cycles=2_000_000)
    p_ms = probe.cuda_ms(lambda: ek.flush_extract_plain(*sub, qs), reps=5)
    b_ms, b_by = probe.bound(S_FULL, len(QS))
    log(f"[kernel] S={S_FULL} P={len(QS)}: kernel r{ek.ROWS_PER_WARP} "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), {b_ms / k_ms * 100:.1f}% of bound")
    at_main = {}
    for s in s_main:
        sub = [f[:s] for f in fields]
        t = probe.cuda_ms(lambda: ek.flush_extract(*sub, qs), reps=21,
                          spin_cycles=2_000_000)
        at_main[s] = {"ms": t, "bound_ms": probe.bound(s, len(QS))[0]}
        log(f"[kernel] S={s} P={len(QS)} (main path): kernel {t:.4f} ms, "
            f"bound {at_main[s]['bound_ms']:.4f} ms")
    return fields, qs, plain_check, {
        "max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "at_main_path": at_main}


# -- phase 4 ------------------------------------------------------------------


def interval_plan(seed: int):
    """The 100k-series interval: series lines (one sample each, made
    through process_metric), bulk staged samples in 16,384-sample
    batches, scalars and sampled timers."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_hist, n_hot = N_HIST, N_HOT
    series = []
    for i in range(n_hist):
        kind = "ms" if i % 2 else "h"
        rate = "|@0.5" if i % 10 == 0 else ""
        series.append(f"svc.lat.{i}:{rng.gamma(2.0, 20.0):.4f}|{kind}"
                      f"{rate}|#shard:{i % 16}".encode())
    for i in range(n_hot):
        series.append(f"hot.{i}:{rng.exponential(50.0):.4f}|ms".encode())
    scalars = [f"req.{i}:{1 + i % 5}|c|#code:{i % 7}".encode()
               for i in range(N_COUNTERS)]
    scalars += [f"queue.{i}:{rng.normal(10.0, 3.0):.5f}|g".encode()
                for i in range(N_GAUGES)]
    # bulk samples: 39 more per regular series (40 with the first), 199
    # more per hot series; shuffled so hot rows spill across batches
    rows = np.concatenate([np.repeat(np.arange(n_hist), 39),
                           np.repeat(np.arange(n_hist, n_hist + n_hot),
                                     199)]).astype(np.int32)
    perm = rng.permutation(len(rows))
    rows = rows[perm]
    vals = rng.gamma(2.0, 20.0, len(rows)).astype(np.float32)
    wts = np.where(rows % 10 == 0, np.float32(2.0),
                   np.float32(1.0)).astype(np.float32)
    return series, scalars, rows, vals, wts, set_plan(rng)


def member_hashes(ids):
    """hll_hash (FNV-1a 64, then murmur3's finalizer) of the member
    strings b"m%09d" % id, vectorized over the ids: the hash the port's
    Python path and the C++ parser give those set values."""
    import numpy as np

    d = np.empty((len(ids), 10), np.uint8)
    d[:, 0] = ord("m")
    v = np.asarray(ids, np.int64)
    for k in range(9, 0, -1):
        d[:, k] = 48 + v % 10
        v = v // 10
    h = np.full(len(ids), 0xCBF29CE484222325, np.uint64)
    for k in range(d.shape[1]):
        h ^= d[:, k].astype(np.uint64)
        h *= np.uint64(0x100000001B3)
    for mult in (0xFF51AFD7ED558CCD, 0xC4CEB9FE1A85EC53):
        h ^= h >> np.uint64(33)
        h *= np.uint64(mult)
    return h ^ (h >> np.uint64(33))


def set_plan(rng):
    """The sets of the interval: one line per set series (registers set
    rows 0..N_SETS-1 in order), then the bulk members, the strings
    b"m%09d" % id with a distinct id each, as (set row, register, rank)
    at p = 14 from their hashes, shuffled. Returns the ids too, so the
    members can be rendered as DogStatsD lines."""
    import numpy as np

    from veneur_tpu_torch.ops.hll import split_hashes

    lines = [f"users.{i}:u{int(rng.integers(0, 1 << 30))}|s|#shard:{i % 16}"
             .encode() for i in range(N_SETS)]
    rows = np.concatenate([
        np.repeat(np.arange(N_SETS_BIG), BIG_MEMBERS),
        np.repeat(np.arange(N_SETS_BIG, N_SETS), SMALL_MEMBERS),
    ]).astype(np.int32)
    perm = rng.permutation(len(rows))
    rows = rows[perm]
    ids = np.arange(len(rows), dtype=np.int64)
    idx, rank = split_hashes(member_hashes(ids), 14)
    return lines, rows, idx, rank, ids


def run_interval(worker, plan, parse, qs, step=contextlib.nullcontext,
                 micro_every: int = 0):
    """Drive one interval through a worker; returns (snapshot, seconds
    by step: lines through process_metric, bulk staging with its spill
    folds, and the flush with its staged fold and extract). ``step(name)``
    wraps each step (a profiler range in tools/port_profile_interval.py);
    with ``micro_every`` a micro-fold runs after every that many staging
    batches."""
    series, scalars, rows, vals, wts, (set_lines, srows, sidx, srank,
                                       _ids) = plan
    t0 = time.perf_counter()
    with step("process_metric"):
        for line in series:
            worker.process_metric(parse(line))
        for line in scalars:
            worker.process_metric(parse(line))
        for line in set_lines:
            worker.process_metric(parse(line))
        worker._flush_pending_histos()
        worker._flush_pending_sets()
        worker._sync()
    t1 = time.perf_counter()
    with step("staging"):
        # series lines registered rows 0..N-1 in order (one per line)
        b = worker.batch_size
        for k, i in enumerate(range(0, len(rows), b)):
            worker._device_histo_step(rows[i:i + b], vals[i:i + b],
                                      wts[i:i + b])
            if micro_every and k % micro_every == micro_every - 1:
                worker.micro_fold_once()
        worker._sync()
    t2 = time.perf_counter()
    set_insert_s = insert_sets(worker, srows, sidx, srank, step)
    t3 = time.perf_counter()
    with step("flush"):
        snap = worker.flush(qs)
    t4 = time.perf_counter()
    return snap, {"process_metric_s": t1 - t0, "staging_s": t2 - t1,
                  "set_insert_s": set_insert_s, "flush_s": t4 - t3,
                  **worker.last_extract_phases, **micro_stats(worker)}


def micro_stats(worker) -> dict:
    """The flushed epoch's micro-folds and the mirror's uploads."""
    return {"micro_folds": worker.micro_folds_swapped,
            "mirror_chunks": worker.last_micro_chunks,
            "mirror_bytes": worker.last_micro_bytes}


def check_guard_clean(worker, snap, what: str) -> None:
    """No guard fault, trip or degraded flush where none was injected."""
    c = worker.guard.counters()
    if c or worker.guard.quarantined or snap.degraded \
            or worker.host_fallback_flushes:
        raise AssertionError(f"{what}: guard counters {c}, degraded "
                             f"{snap.degraded}")


def insert_sets(worker, rows, idx, rank, step=contextlib.nullcontext
                ) -> float:
    """The bulk set members through _device_set_step in batch_size
    batches; seconds, ended by a device sync."""
    t0 = time.perf_counter()
    with step("sets"):
        b = worker.batch_size
        for i in range(0, len(rows), b):
            worker._device_set_step(rows[i:i + b], idx[i:i + b],
                                    rank[i:i + b])
        worker._sync()
    return time.perf_counter() - t0


def compare_snapshots(a, b, what: str) -> None:
    """Every array of two snapshots bitwise equal (NaN positions equal),
    the counters and gauges, and the directories' keys in row order."""
    import dataclasses

    import numpy as np
    import torch

    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            if va is None or vb is None or va.shape != vb.shape \
                    or va.dtype != vb.dtype:
                raise AssertionError(f"{what}: snapshot field {f.name} "
                                     "differs in shape/type")
            ta, tb = torch.from_numpy(np.ascontiguousarray(va)), \
                torch.from_numpy(np.ascontiguousarray(vb))
            if ta.dtype == torch.float32:
                same, err = probe.bitwise_equal(ta, tb)
            else:
                same, err = va.tobytes() == vb.tobytes(), 0.0
            if not same:
                raise AssertionError(f"{what}: snapshot field {f.name} "
                                     f"differs (max abs err {err})")
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        if pa.values[:pa.used].tobytes() != pb.values[:pb.used].tobytes():
            raise AssertionError(f"{what}: {pool} differ")
    for pool in ("histo", "sets"):
        if [r.key for r in getattr(a.directory, pool).rows] != \
                [r.key for r in getattr(b.directory, pool).rows]:
            raise AssertionError(f"{what}: {pool} directory differs")


def check_set_estimates(est) -> None:
    """The repo's own check of an HLL: each estimate within its error
    envelope of the true count, the bulk members plus the series line's
    one (1.04/sqrt(m) = 0.8% at p = 14; at 21 of 16,384 registers linear
    counting is off only by the values that share a register, about one
    set in 75 losing one)."""
    import numpy as np

    if est is None or est.shape != (N_SETS,) or not np.isfinite(est).all():
        raise AssertionError("set estimates missing or not finite")
    big, small = est[:N_SETS_BIG], est[N_SETS_BIG:]
    if np.abs(big / (BIG_MEMBERS + 1) - 1).max() > 0.05 \
            or np.abs(small - (SMALL_MEMBERS + 1)).max() > 3.0:
        raise AssertionError(f"set estimates off: big {big.min()}..."
                             f"{big.max()}, small {small.min()}..."
                             f"{small.max()}")


# the worker configuration of phases 4 and 4c, and of 4b, with the
# config's defaults micro_fold and device_guard on (micro_fold_rows 1:
# phase 6's micro_fold_once calls always find their drain due)
INTERVAL_KW = dict(compression=100.0, stage_depth=64, batch_size=16384,
                   initial_histo_rows=4096, count_unique_timeseries=True,
                   micro_fold=True, micro_fold_rows=1, device_guard=True)
DENSE_KW = dict(batch_size=16384, set_store="dense",
                count_unique_timeseries=True, micro_fold=True,
                device_guard=True)


def phase_worker(tw, generate, parse, qs):
    """Phase 4 on the card, then its CPU twin; the snapshots bitwise
    equal."""
    import numpy as np

    plan = interval_plan(seed=5)
    per_row = np.bincount(plan[2]) + 1  # + the series line's sample
    spilled = int(np.maximum(per_row - INTERVAL_KW["stage_depth"], 0).sum())
    reset_peak()
    gpu = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    before = td_launches()
    snap_g, t_g = run_interval(gpu, plan, parse, qs)
    t_g["peak_device_bytes"] = peak_bytes()
    t_g.update(check_td_launches(before, "phase 4, card"))
    check_guard_clean(gpu, snap_g, "phase 4, card")
    del gpu
    cpu = tw.DeviceWorker(**INTERVAL_KW, device="cpu")
    snap_c, t_c = run_interval(cpu, plan, parse, qs)
    check_guard_clean(cpu, snap_c, "phase 4, CPU")
    del cpu
    compare_snapshots(snap_g, snap_c, "phase 4, card against CPU")
    n = snap_g.directory.num_histo_rows
    qv = snap_g.quantile_values
    if qv.shape != (n, len(qs)) or not (qv == qv).all():
        raise AssertionError("quantiles not finite for every series")
    check_set_estimates(snap_g.set_estimates)
    if snap_g.set_registers.shape != (N_SETS, 1 << 14) \
            or not snap_g.unique_timeseries_registers.any():
        raise AssertionError("set registers or unique-timeseries "
                             "registers missing")
    t0 = time.perf_counter()
    metrics = generate(snap_g)
    t_g["generate_s"] = time.perf_counter() - t0
    samples = len(plan[0]) + len(plan[2])
    set_samples = len(plan[5][0]) + len(plan[5][1])
    log(f"[worker] {n} histogram series ({samples} samples, {spilled} "
        f"past stage depth {INTERVAL_KW['stage_depth']} through the spill "
        f"fold), "
        f"{snap_g.directory.num_set_rows} set series ({set_samples} set "
        f"samples; {N_SETS_BIG} promoted to the dense tier), "
        f"{len(snap_g.scalars.counter_meta)} counters, "
        f"{len(snap_g.scalars.gauge_meta)} gauges -> {len(metrics)} "
        f"InterMetrics; CUDA snapshot bitwise equal to CPU snapshot")
    for where, t in (("card", t_g), ("cpu", t_c)):
        log(f"[worker] {where}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    return {"card": t_g, "cpu": t_c, "series": n, "samples": samples,
            "spilled": spilled, "set_series": N_SETS,
            "set_samples": set_samples}, plan, snap_g, snap_c


# -- phase 4c -----------------------------------------------------------------


def render_datagrams(plan, lines_per_datagram: int = 100):
    """Phase 4's interval as DogStatsD datagrams, in the steps
    run_interval takes: the series, scalar and set lines; then the bulk
    histogram samples and the bulk set members, each cut into the
    worker's 16,384-sample batches. A bulk sample is its row's series
    line with the value written as the shortest decimal of the f64 that
    holds its f32 exactly (so it parses back to the same f32) and a
    weight of 2 as @0.5; a member is the string "m%09d" % id. Returns
    ([(step, [datagrams])], bytes), a step being what run_interval hands
    the worker between two drains. Vectorized with numpy's string
    arrays."""
    import numpy as np

    series, scalars, rows, vals, wts, (set_lines, srows, _i, _r, ids) = plan

    def grams(lines):
        return [b"\n".join(lines[i:i + lines_per_datagram])
                for i in range(0, len(lines), lines_per_datagram)]

    def text_grams(lines):
        lines = lines.tolist()
        return ["\n".join(lines[i:i + lines_per_datagram]).encode()
                for i in range(0, len(lines), lines_per_datagram)]

    steps = [("lines", grams(series + scalars + set_lines))]
    # each row's line around its value: name, then type, rate and tags
    # (the hot rows' lines carry no tags)
    r = np.arange(N_HIST)
    kind = np.where(r % 2 == 1, "ms", "h")
    shard = np.char.add("#shard:", (r % 16).astype(str))
    head = np.concatenate([
        np.char.add(np.char.add("svc.lat.", r.astype(str)), ":"),
        np.char.add(np.char.add("hot.", np.arange(N_HOT).astype(str)), ":")])
    tail1 = np.concatenate([
        np.char.add(np.char.add(np.char.add("|", kind), "|"), shard),
        np.full(N_HOT, "|ms")])
    tail2 = np.concatenate([
        np.char.add(np.char.add(np.char.add("|", kind), "|@0.5|"), shard),
        np.full(N_HOT, "|ms|@0.5")])
    b = 16_384
    for i in range(0, len(rows), b):
        rr = rows[i:i + b]
        tail = np.where(wts[i:i + b] == 2.0, tail2[rr], tail1[rr])
        v = vals[i:i + b].astype(np.float64).astype(str)
        steps.append(("histo", text_grams(
            np.char.add(np.char.add(head[rr], v), tail))))
    s = np.arange(N_SETS)
    set_head = np.char.add(np.char.add("users.", s.astype(str)), ":m")
    set_tail = np.char.add("|s|#shard:", (s % 16).astype(str))
    for i in range(0, len(srows), b):
        rr = srows[i:i + b]
        member = np.char.zfill(ids[i:i + b].astype(str), 9)
        steps.append(("sets", text_grams(np.char.add(
            np.char.add(set_head[rr], member), set_tail[rr]))))
    n = sum(len(g) for _s, gs in steps for g in gs)
    return steps, n


def run_native_interval(worker, steps, qs, micro_every: int = 0):
    """The datagrams through a worker with attach_native(): each step's
    datagrams, then a drain (the spill of a 16,384-sample batch folds as
    one batch, as run_interval's staging folds it), then the flush; with
    ``micro_every`` a micro-fold after every that many drains (it finds
    the batches drained, so the spill batches stay the same). Returns
    (snapshot, seconds by step)."""
    t_ingest = t_drain = 0.0
    for k, (_kind, grams) in enumerate(steps):
        t0 = time.perf_counter()
        for d in grams:
            worker.ingest_datagram(d)
        t1 = time.perf_counter()
        worker.drain_native()
        if micro_every and k % micro_every == micro_every - 1:
            worker.micro_fold_once()
        worker._sync()
        t_drain += time.perf_counter() - t1
        t_ingest += t1 - t0
    t1 = time.perf_counter()
    snap = worker.flush(qs)
    t2 = time.perf_counter()
    if worker.parse_errors or worker.overload_dropped_total:
        raise AssertionError(f"native worker on {worker.device}: "
                             f"{worker.parse_errors} parse errors, "
                             f"{worker.overload_dropped_total} shed")
    return snap, {"native_ingest_s": t_ingest + t_drain,
                  "ingest_datagram_s": t_ingest, "drain_s": t_drain,
                  "flush_s": t2 - t1, **worker.last_extract_phases,
                  "plane_upload_bytes": worker.last_plane_upload_bytes,
                  **micro_stats(worker)}


def phase_native(tw, ek, hll, qs, plan, python_snap):
    """Phase 4's interval as datagrams through native workers on the card
    and then on the CPU: bitwise equal to each other and to phase 4's
    Python-path snapshot on the card."""
    t0 = time.perf_counter()
    steps, n_bytes = render_datagrams(plan)
    render_s = time.perf_counter() - t0
    w = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    w.attach_native()
    k1, k4, k5 = (ek.flush_extract.launches, hll.insert_batch.launches,
                  hll.estimate.launches)
    k2 = td_launches()
    snap, card = run_native_interval(w, steps, qs)
    card.update(check_td_launches(k2, "phase 4c, card"))
    card.update({
        "flush_extract_launches": ek.flush_extract.launches - k1,
        "hll_insert_launches": hll.insert_batch.launches - k4,
        "hll_estimate_launches": hll.estimate.launches - k5})
    check_guard_clean(w, snap, "phase 4c, card")
    del w
    compare_snapshots(snap, python_snap, "phase 4c, native against phase 4")
    check_set_estimates(snap.set_estimates)
    if min(card[k] for k in ("flush_extract_launches", "hll_insert_launches",
                             "hll_estimate_launches")) < 1:
        raise AssertionError(f"native interval launches {card}")
    w = tw.DeviceWorker(**INTERVAL_KW, device="cpu")
    w.attach_native()
    snap_c, cpu = run_native_interval(w, steps, qs)
    check_guard_clean(w, snap_c, "phase 4c, CPU")
    del w
    compare_snapshots(snap, snap_c, "phase 4c, card against CPU")
    del snap_c
    dense = snap.directory.num_histo_rows * INTERVAL_KW["stage_depth"] * 4 * 2
    grams = sum(len(g) for _k, g in steps)
    log(f"[native] {grams} datagrams ({n_bytes} bytes; rendered in "
        f"{render_s:.2f} s) through attach_native() workers: the card's "
        f"snapshot bitwise equal to phase 4's Python-path snapshot and to "
        f"the native CPU worker's; plane upload "
        f"{card['plane_upload_bytes']} bytes (a dense plane of the used "
        f"rows: {dense}); launches flush_extract "
        f"{card['flush_extract_launches']}, hll_insert "
        f"{card['hll_insert_launches']}, hll_estimate "
        f"{card['hll_estimate_launches']}")
    for where, t in (("card", card), ("cpu", cpu)):
        log(f"[native] {where}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    return {"card": card, "cpu": cpu, "render_s": render_s,
            "datagrams": grams, "bytes": n_bytes}, steps


def dense_interval(worker, parse):
    """Phase 4b's set traffic (seed 6) through a set_store="dense"
    worker: the set lines, the bulk members, the flush. Returns
    (snapshot, seconds by step, pool rows, samples)."""
    import numpy as np

    set_lines, rows, idx, rank, _ids = set_plan(np.random.default_rng(6))
    t0 = time.perf_counter()
    for line in set_lines:
        worker.process_metric(parse(line))
    worker._flush_pending_sets()
    worker._sync()
    t1 = time.perf_counter()
    set_insert_s = insert_sets(worker, rows, idx, rank)
    pool_rows = worker._sets.shape[0]
    t2 = time.perf_counter()
    snap = worker.flush(np.asarray(QS))
    t3 = time.perf_counter()
    return snap, {"process_metric_s": t1 - t0, "set_insert_s": set_insert_s,
                  "flush_s": t3 - t2, **worker.last_extract_phases}, \
        pool_rows, len(set_lines) + len(rows)


def phase_dense_sets(tw, parse, hll):
    """The interval's set traffic alone through set_store="dense"
    workers, the card's then the CPU's: every batch scatters into the
    32,768-row pool on the card (hll_insert), the flush estimates all of
    it (hll_estimate)."""
    w = tw.DeviceWorker(**DENSE_KW, device=DEVICE)
    k0, e0 = hll.insert_batch.launches, hll.estimate.launches
    snap, card, pool_rows, samples = dense_interval(w, parse)
    card.update({"hll_insert_launches": hll.insert_batch.launches - k0,
                 "hll_estimate_launches": hll.estimate.launches - e0})
    check_guard_clean(w, snap, "phase 4b, card")
    del w
    w = tw.DeviceWorker(**DENSE_KW, device="cpu")
    snap_c, cpu, _rows, _n = dense_interval(w, parse)
    check_guard_clean(w, snap_c, "phase 4b, CPU")
    del w
    compare_snapshots(snap, snap_c, "phase 4b, card against CPU")
    del snap_c
    out = {"card": card, "cpu": cpu}
    check_set_estimates(snap.set_estimates)
    if pool_rows != 1 << N_SETS.bit_length():  # + its scratch row
        raise AssertionError(f"dense pool of {pool_rows} rows")
    log(f"[dense sets] {N_SETS} set series, {samples} "
        f"samples into a {pool_rows} x {1 << 14} int8 pool: CUDA snapshot "
        f"bitwise equal to CPU snapshot; card launches hll_insert "
        f"{out['card']['hll_insert_launches']}, hll_estimate "
        f"{out['card']['hll_estimate_launches']}")
    for where, t in out.items():
        log(f"[dense sets] {where}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    return out


# -- phases 6 and 7 -----------------------------------------------------------


def counting_guard():
    """A fault injector with an empty plan: it injects nothing and counts
    the guarded dispatches (utils/faults.DeviceFaultInjector)."""
    from veneur_tpu_torch.utils import faults as fl

    return fl.DeviceFaultInjector(fl.DeviceFaultPlan())


def phase_micro(tw, parse, qs, plan, steps, python_snap, phase4):
    """Phase 4's interval with micro-folds every MICRO_EVERY staging
    batches, card and CPU, and with micro-folds off, card and CPU; phase
    4c's native interval with a micro-fold every MICRO_EVERY_NATIVE
    drains on the card. Every snapshot bitwise phase 4's."""
    out = {}
    off = {**INTERVAL_KW, "micro_fold": False}
    for name, dev, kw, every in (("card_on", DEVICE, INTERVAL_KW, MICRO_EVERY),
                                 ("card_off", DEVICE, off, 0),
                                 ("cpu_on", "cpu", INTERVAL_KW, MICRO_EVERY),
                                 ("cpu_off", "cpu", off, 0)):
        w = tw.DeviceWorker(**kw, device=dev)
        with counting_guard() as inj:
            snap, t = run_interval(w, plan, parse, qs, micro_every=every)
        t["guarded_calls"] = inj.calls
        check_guard_clean(w, snap, f"phase 6 {name}")
        compare_snapshots(snap, python_snap, f"phase 6 {name} against "
                          f"phase 4")
        if every and (t["micro_folds"] < 2 or not t["mirror_chunks"]):
            raise AssertionError(f"phase 6 {name}: {t}")
        out[name] = t
        del w, snap
    w = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    w.attach_native()
    with counting_guard() as inj:
        snap, t = run_native_interval(w, steps, qs,
                                      micro_every=MICRO_EVERY_NATIVE)
    t["guarded_calls"] = inj.calls
    check_guard_clean(w, snap, "phase 6 native")
    compare_snapshots(snap, python_snap, "phase 6 native against phase 4")
    if t["micro_folds"] < 2 or t["plane_upload_bytes"]:
        raise AssertionError(f"phase 6 native: {t}")
    out["card_native_on"] = t
    del w, snap
    keys = ("micro_folds", "mirror_chunks", "mirror_bytes", "fold_s",
            "flush_s", "guarded_calls")
    for name, t in [("phase 4 card (residual only)", phase4["card"]),
                    ("phase 4 cpu (residual only)", phase4["cpu"])] + \
            list(out.items()):
        log(f"[micro] {name}: " + ", ".join(
            f"{k} {t[k]:.4f}" if isinstance(t.get(k), float)
            else f"{k} {t.get(k)}" for k in keys))
    log("[micro] every snapshot bitwise equal to phase 4's")
    return out


def guard_cost(n: int = 20_000) -> dict:
    """The guard's host cost per call on the card: one tiny kernel
    launched n times directly and n times through DeviceGuard.call, in
    turns (direct, guarded, guarded, direct), each run ended by a
    sync."""
    import torch

    from veneur_tpu_torch.ops import device_guard as dg

    g = dg.DeviceGuard()
    x = torch.zeros(1, device=DEVICE)

    def op():
        x.add_(1.0)

    def run(guarded):
        sync()
        t0 = time.perf_counter()
        if guarded:
            for _ in range(n):
                g.call("extract", op)
        else:
            for _ in range(n):
                op()
        sync()
        return (time.perf_counter() - t0) / n * 1e9

    run(False), run(True)  # warm up
    t = [run(False), run(True), run(True), run(False)]
    direct, guarded = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    out = {"direct_ns": direct, "guarded_ns": guarded,
           "cost_ns": guarded - direct, "calls": n, "turns_ns": t}
    log(f"[guard] one kernel launch {direct:.0f} ns direct, {guarded:.0f} "
        f"ns through the guard: {guarded - direct:.0f} ns a guarded call "
        f"(turns {', '.join(f'{v:.0f}' for v in t)})")
    return out


# phase 7's faults: the first dispatch of each ingest op and of the probe,
# and every extract; two faults in a row trip the breaker. At phase 4's
# size the growth pre-flight's fault is retried, the micro-fold's drops
# the mirror and the spill fold's right after it trips the breaker, so
# the rest of the interval and its flush run on the CPU. Where no two
# ingest faults meet (smaller intervals), the extract and its retry trip
# it at the flush. tests/test_torch_guard.py faults every op on the CPU.
PHASE7_ONCE = ("grow", "fold", "micro", "sets", "probe")


def phase_guard(tw, ek, hll, parse, qs, plan, python_snap):
    """Phase 4's interval with faults in the guarded ops; the probe's
    re-admission and a smaller interval on the card; the real OOM and the
    child's sticky fault (tools/port_guard_faults.py)."""
    from veneur_tpu_torch.utils import faults as fl

    w = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE, device_fault_streak=2)
    windows = {op: [(0, 1, "lost")] for op in PHASE7_ONCE}
    windows["extract"] = [(0, 10**6, "lost")]
    with fl.DeviceFaultInjector(fl.DeviceFaultPlan(
            seed=7, op_windows=windows)) as inj:
        snap, t = run_interval(w, plan, parse, qs, micro_every=MICRO_EVERY)
        w.guard.probe_interval_s = 0.0
        w.device_guard_tick()  # quarantines the live epoch; the probe faults
        failed_probe = w.guard.quarantined and w._host_live
        w.device_guard_tick()  # the probe passes: re-admission
    c = w.guard.counters()
    fired = dict(inj.op_injected)
    if not (snap.degraded and failed_probe and c.get("device.guard.trips")
            == 1 and c.get("device.guard.quarantines") == 1
            and c.get("device.guard.readmissions") == 1
            and len(set(fired) - {"probe"}) >= 3):
        raise AssertionError(f"phase 7: degraded {snap.degraded}, faults "
                             f"by op {fired}, counters {c}")
    compare_snapshots(snap, python_snap, "phase 7 faulted interval against "
                      "phase 4")
    faulted = {"faults_by_op": fired, "counters": c, **t}
    del snap
    if w.guard.quarantined or w._host_live:
        raise AssertionError(f"phase 7: not re-admitted {c}")
    # a smaller interval on the readmitted card: timers, and the bulk
    # members of the 64 big sets (they promote past the staged store's
    # compaction, so hll_insert runs, and hll_estimate at the flush)
    series, _sc, _r, _v, _w, (set_lines, srows, sidx, srank, _i) = plan
    big = srows < N_SETS_BIG
    k1, k4, k5 = (ek.flush_extract.launches, hll.insert_batch.launches,
                  hll.estimate.launches)
    for line in series[:20_000] + set_lines[:N_SETS_BIG]:
        w.process_metric(parse(line))
    w._flush_pending_sets()
    insert_sets(w, srows[big][:READMIT_SET_SAMPLES],
                sidx[big][:READMIT_SET_SAMPLES],
                srank[big][:READMIT_SET_SAMPLES])
    after = w.flush(qs)
    launched = {"flush_extract": ek.flush_extract.launches - k1,
                "hll_insert": hll.insert_batch.launches - k4,
                "hll_estimate": hll.estimate.launches - k5}
    if after.degraded or min(launched.values()) < 1:
        raise AssertionError(f"phase 7 after re-admission: degraded "
                             f"{after.degraded}, launches {launched}")
    ref = tw.DeviceWorker(**INTERVAL_KW, device="cpu")
    for line in series[:20_000] + set_lines[:N_SETS_BIG]:
        ref.process_metric(parse(line))
    ref._flush_pending_sets()
    insert_sets(ref, srows[big][:READMIT_SET_SAMPLES],
                sidx[big][:READMIT_SET_SAMPLES],
                srank[big][:READMIT_SET_SAMPLES])
    compare_snapshots(after, ref.flush(qs), "phase 7 after re-admission "
                      "against the CPU")
    del w, ref, after
    log(f"[guard] phase 4's interval under faults by op {fired}: counters "
        f"{c}; the flush equals phase 4's, degraded; a failed probe, then "
        f"re-admission; a smaller interval on the card equal to the CPU's, "
        f"launches {launched}")
    log("[guard] faulted interval: " + ", ".join(
        f"{k} {v:.4f}" for k, v in t.items() if isinstance(v, float)))
    return {"faulted": faulted, "readmitted_launches": launched}


def phase_real_faults() -> dict:
    """tools/port_guard_faults.py: the real OOM here, the sticky fault in
    a child process."""
    oom = guard_faults.run_grow_oom()
    log(f"[guard] real OOM through the valve: growth to {oom['rows']} "
        f"rows, pre-flight {oom['preflight_bytes']} bytes with "
        f"{oom['headroom']} free: counters {oom['counters']}; degraded "
        f"flush equal to the CPU's, re-admitted, next flush on the card "
        f"equal too")
    sticky = guard_faults.run_sticky_fault()
    log(f"[guard] sticky fault in a child: kind {sticky['kind']}, CUDA "
        f"error {sticky['error_code']}, counters {sticky['counters']}, the "
        f"next interval on the CPU equal to a CPU worker's "
        f"({sticky['wall_s']:.1f} s)")
    return {"grow_oom": oom, "sticky_fault": sticky}


# -- phase 5 ------------------------------------------------------------------


# -- sink listeners (phases 5, 5b and 8) --------------------------------------


# request headers a sink sets; urllib's own (Host, User-Agent, ...) vary
SINK_HEADERS = ("content-type", "content-encoding", "x-sf-token",
                "x-insert-key")


class HttpTap:
    """A local HTTP listener that records every POST (path, the sink's
    headers, body) and answers 202."""

    def __init__(self) -> None:
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        tap = self
        self.lock = threading.Lock()
        self.requests: list = []
        self.keys: set = set()

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                hdrs = tuple(sorted((k.lower(), v)
                                    for k, v in self.headers.items()
                                    if k.lower() in SINK_HEADERS))
                with tap.lock:
                    tap.requests.append((self.path, hdrs, body))
                    key = self.headers.get("Idempotency-Key")
                    if key is not None:
                        tap.keys.add(key)
                self.send_response(202)
                self.send_header("Content-Length", "2")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def opener(self, req, timeout: float) -> bytes:
        """The sinks' opener: a request for another host goes to this
        listener instead, path and query kept (New Relic's collector URL
        is fixed by its region); nothing leaves the machine."""
        import urllib.parse
        import urllib.request

        from veneur_tpu_torch.utils.http import default_opener

        u = urllib.parse.urlsplit(req.full_url)
        local = urllib.request.Request(
            self.base + u.path + (f"?{u.query}" if u.query else ""),
            data=req.data, method=req.get_method(),
            headers=dict(req.header_items()))
        return default_opener(local, timeout)

    def taken(self) -> list:
        with self.lock:
            return sorted(self.requests)

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


class TcpTap:
    """A local TCP listener keeping the byte stream of each connection."""

    def __init__(self) -> None:
        import socket
        import threading

        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.1)
        self.address = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self.lock = threading.Lock()
        self.streams: list[bytearray] = []
        self.readers: list = []
        self.stop = False
        self.thread = threading.Thread(target=self._accept, daemon=True)
        self.thread.start()

    def _accept(self) -> None:
        import socket
        import threading

        while not self.stop:
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            buf = bytearray()
            reader = threading.Thread(target=self._read, args=(conn, buf),
                                      daemon=True)
            with self.lock:
                # started under the lock: taken() joins only started ones
                reader.start()
                self.streams.append(buf)
                self.readers.append(reader)

    def _read(self, conn, buf: bytearray) -> None:
        import socket

        conn.settimeout(0.1)
        with conn:
            while not self.stop:
                try:
                    data = conn.recv(1 << 20)
                except socket.timeout:
                    continue
                except OSError:
                    return
                if not data:
                    return
                with self.lock:
                    buf += data

    def taken(self) -> bytes:
        """Every byte received, once the sink's connection was accepted
        and closed (close_sink_sockets)."""
        deadline = time.monotonic() + 60
        while not self.readers and time.monotonic() < deadline:
            time.sleep(0.01)
        with self.lock:
            readers = list(self.readers)
        if not readers:
            raise AssertionError("the sink never connected")
        for reader in readers:
            reader.join(timeout=60)
            if reader.is_alive():
                raise AssertionError("a sink kept its TCP connection open")
        with self.lock:
            return b"".join(bytes(s) for s in self.streams)

    def close(self) -> None:
        self.stop = True
        self.thread.join(timeout=2)
        self.sock.close()


class SinkTaps:
    """Local listeners behind a server's Datadog (HTTP), Prometheus
    repeater (TCP) and forward-statsd (TCP) sinks."""

    def __init__(self) -> None:
        self.http, self.repeater, self.forward = (HttpTap(), TcpTap(),
                                                  TcpTap())

    def config(self) -> dict:
        return {"datadog_api_key": "smoke",
                "datadog_api_hostname": self.http.base,
                "datadog_flush_max_per_body": 2000,
                "prometheus_repeater_address": self.repeater.address,
                "prometheus_network_type": "tcp",
                "forward_statsd_address": self.forward.address,
                "forward_statsd_network": "tcp"}

    def taken(self) -> dict:
        return {"datadog": self.http.taken(),
                "prometheus": self.repeater.taken(),
                "forward_statsd": self.forward.taken()}

    def close(self) -> None:
        for tap in (self.http, self.repeater, self.forward):
            tap.close()


def pin_idempotency(server) -> None:
    """Idempotency keys carry a random sender token per process: pin it,
    so two servers' requests compare byte for byte."""
    for sink in server.metric_sinks:
        if getattr(sink, "delivery", None) is not None:
            sink.delivery._mint_sender = "chip-smoke"


def close_sink_sockets(server) -> None:
    for sink in server.metric_sinks:
        sock = getattr(sink, "_sock", None)
        if sock is not None:
            sock.close()
            sink._sock = None


def datadog_entries(requests) -> list:
    """The series entries of Datadog requests, inflated and parsed, as a
    sorted list of canonical JSON strings (a point's value as a float:
    the native tier writes an integral rate as an integer, which JSON
    reads as the same number); the other requests as they came."""
    import zlib

    out = []
    for path, _hdrs, body in requests:
        if path.startswith("/api/v1/series"):
            for e in json.loads(zlib.decompress(body))["series"]:
                e["points"] = [[ts, None if v is None else float(v)]
                               for ts, v in e["points"]]
                out.append(json.dumps(e, sort_keys=True))
        else:
            out.append(json.dumps([path, body.decode()]))
    return sorted(out)


def lines_of(stream: bytes) -> list:
    return sorted(stream.split(b"\n"))


# -- phases 5 and 5b ----------------------------------------------------------


def server_datagrams(seed: int, spill: bool, n: int = 300) -> list[bytes]:
    """Phase 5's traffic. spill=False: no series passes the staging depth
    (at most 60 samples a series), so the interval is bitwise the same on
    every path whenever the micro-fold scheduler drains. spill=True: the
    histograms api.payload and api.slow carry no tags and take all 300
    samples each, past the 64-deep staging plane, so the spill folds run;
    such an interval is bitwise the same only with matching batch cuts
    (micro_fold off)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    route = "" if spill else "|#route:r{}"
    out = []
    for i in range(n):
        k = i % 37
        tag = route.format(i % 5)
        lines = [
            f"api.requests:{1 + k % 3}|c|#route:r{k % 5}",
            f"api.sampled:{1 + k % 2}|c|@0.5",
            f"api.inflight:{rng.normal(20.0, 4.0):.4f}|g|#pod:p{k % 4}",
            f"api.latency:{rng.gamma(2.0, 12.0):.4f}|ms|"
            f"#route:r{(k if spill else i) % 5}",
            f"api.payload:{rng.lognormal(6.0, 1.0):.3f}|h{tag}",
            f"api.slow:{rng.exponential(200.0):.3f}|ms|@0.25{tag}",
            f"api.users:u{int(rng.integers(0, 5000))}|s",
            f"api.users:u{k}|s|#veneurlocalonly",
        ]
        out.append("\n".join(lines).encode())
    out.append(b"_sc|api.health|0|#pod:p1|m:serving")
    # the event carries its date (else it is the time it was parsed)
    out.append(b"_e{7,13}:deploy!|api v2 rolled|d:1700000000|#team:core")
    return out


def canonical(metrics) -> list[tuple]:
    return sorted(
        (m.name, m.timestamp, struct.pack("<d", float(m.value)),
         tuple(m.tags), m.type.name, m.message, m.hostname,
         None if m.sinks is None else tuple(sorted(m.sinks)))
        for m in metrics)


def server_config(native: bool, spill: bool) -> dict:
    cfg = {"statsd_listen_addresses": ["udp://127.0.0.1:0"],
           "interval": "1h", "percentiles": [0.5, 0.9, 0.99],
           "aggregates": ["min", "max", "count", "sum", "avg", "median"],
           "hostname": "chip-smoke", "tpu_native_ingest": native,
           "tpu_native_readers": native, "count_unique_timeseries": True}
    if spill:
        # the spill run's batch cuts are the datagrams' on every path
        cfg["micro_fold"] = False
    else:
        # the scheduler drains the native staging plane while the
        # datagrams arrive (the Python path stages at the flush)
        cfg["micro_fold_max_age_s"] = 0.02
    return cfg


def check_server_guard_clean(server, what: str, micro: bool = True) -> None:
    """The guard on, micro-folds as asked, no fault, trip or degraded
    flush."""
    w = server.workers[0]
    if not (w.micro_fold == micro and w.guard.enabled):
        raise AssertionError(f"{what}: micro_fold {w.micro_fold}, guard "
                             f"{w.guard.enabled}: not the defaults")
    if server.guard_counters() or server.host_fallbacks \
            or server.quarantined_workers:
        raise AssertionError(f"{what}: guard counters "
                             f"{server.guard_counters()}, host fallbacks "
                             f"{server.host_fallbacks}")


def serve_once(data: dict, grams: list, now: int):
    """A factory-built server on the card with a channel sink and the
    network sinks of SinkTaps: the datagrams over UDP to its listener,
    one flush. Returns (server, InterMetrics of the flush, InterMetrics
    the channel sink got, what each network sink's listener took)."""
    import socket

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    sink = ChannelMetricSink()
    taps = SinkTaps()
    server = build_server(load_config(data={**data, **taps.config()}),
                          extra_metric_sinks=[sink], device=DEVICE)
    pin_idempotency(server)
    ports = server.start()
    try:
        if data["tpu_native_readers"]:
            # the C++ reader took the socket: no Python reader runs
            import threading

            py_readers = [t.name for t in threading.enumerate()
                          if t.name.startswith("statsd-udp")]
            if not server.native_mode or server.native_reader_threads != 1 \
                    or py_readers:
                raise AssertionError(
                    f"native server: native_mode {server.native_mode}, C++ "
                    f"readers {server.native_reader_threads}, Python readers "
                    f"{py_readers}")
        port = ports["udp://127.0.0.1:0"]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for d in grams:
                s.sendto(d, ("127.0.0.1", port))
                time.sleep(0.0005)
        deadline = time.time() + 60
        while server.packets_received < len(grams) \
                and time.time() < deadline:
            time.sleep(0.05)
        if server.packets_received != len(grams):
            raise AssertionError(f"received {server.packets_received} of "
                                 f"{len(grams)} datagrams")
        got = server.flush(now=now)
    finally:
        server.shutdown()
        close_sink_sockets(server)
    try:
        taken = taps.taken()
    finally:
        taps.close()
    delivered = []
    while not sink.queue.empty():
        delivered.extend(sink.queue.get_nowait())
    return server, got.materialize(), delivered, taken


def check_sink_counts(server, taken: dict, what: str) -> None:
    """Every network sink flushed without an error and its listener took
    bytes; nothing is left spilled."""
    counts = server.sink_counters()
    for name in taken:
        c = counts.get(name)
        if c is None or c["flush_error_total"] or \
                c["metrics_flushed_total"] < 1 or not taken[name]:
            raise AssertionError(f"{what}: sink {name}: {c}")
    for name, d in server.delivery_stats().items():
        if d["spilled_payloads"] or d["dropped_payloads"] or \
                d["delivered_payloads"] < 1:
            raise AssertionError(f"{what}: delivery of {name}: {d}")


def phase_server(ek, spill: bool):
    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server

    data = server_config(native=False, spill=spill)
    grams = server_datagrams(seed=9, spill=spill)
    what = "phase 5 (spill, micro_fold off)" if spill else "phase 5"
    before = ek.flush_extract.launches
    now = 1_700_000_000
    server, got, delivered, taken = serve_once(data, grams, now)
    check_server_guard_clean(server, what, micro=not spill)
    check_sink_counts(server, taken, what)
    launched = ek.flush_extract.launches - before
    taps = SinkTaps()
    ref_server = build_server(load_config(data={
        **data, "statsd_listen_addresses": [], **taps.config()}),
        device="cpu")
    pin_idempotency(ref_server)
    for d in grams:
        ref_server.process_metric_packet(d)
    try:
        ref = ref_server.flush(now=now).materialize()
        close_sink_sockets(ref_server)
        ref_taken = taps.taken()
    finally:
        ref_server.shutdown()
        taps.close()
    check_server_guard_clean(ref_server, f"{what}, CPU server",
                             micro=not spill)
    if canonical(got) != canonical(ref) or \
            canonical(delivered) != canonical(got):
        raise AssertionError("CUDA server InterMetrics != CPU server's")
    if taken != ref_taken:
        raise AssertionError(f"{what}: the card server's sinks sent other "
                             "bytes than the CPU server's")
    tally = server.last_unique_timeseries
    if tally is None or tally != ref_server.last_unique_timeseries \
            or tally < 1:
        raise AssertionError(f"unique-timeseries tally {tally} != CPU "
                             f"server's {ref_server.last_unique_timeseries}")
    users = [m.value for m in got if m.name == "api.users"]
    if len(users) != 2:
        raise AssertionError("the set gauges are missing")
    if launched < 1:
        raise AssertionError("the server flush launched no kernel")
    vals = [m.value for m in got]
    if not vals or any(v != v for v in vals):
        raise AssertionError("server emitted no or non-finite values")
    log(f"[server{' spill' if spill else ''}] {len(grams)} UDP datagrams -> "
        f"{len(got)} InterMetrics "
        f"on {server.device}, equal to the CPU server's; set gauges "
        f"api.users {sorted(users)}; unique timeseries {tally} on both; "
        f"flush_extract launches during the flush: {launched}; micro-folds "
        f"{server.workers[0].micro_folds_total}; sinks: " + ", ".join(
            f"{k} {len(v)} {'requests' if k == 'datadog' else 'bytes'}"
            for k, v in taken.items()) + ", equal to the CPU server's")
    return grams, canonical(ref), ref_server.last_unique_timeseries, taken


def phase_native_server(grams, ref, ref_tally, ref_taken, spill: bool):
    """Phase 5's datagrams through a server with tpu_native_ingest and
    tpu_native_readers on (a C++ reader thread on the UDP socket): its
    InterMetrics equal the Python-path CPU server's of phase 5, and so
    does what its sinks sent, as multisets (the C++ directory may order
    the rows otherwise): the Datadog series entries and the other
    requests, the repeater's and forward-statsd's lines."""
    t0 = time.perf_counter()
    server, got, delivered, taken = serve_once(
        server_config(native=True, spill=spill), grams, 1_700_000_000)
    wall = time.perf_counter() - t0
    what = "phase 5b (spill, micro_fold off)" if spill else "phase 5b"
    check_server_guard_clean(server, what, micro=not spill)
    check_sink_counts(server, taken, what)
    if datadog_entries(taken["datadog"]) != \
            datadog_entries(ref_taken["datadog"]) or any(
            lines_of(taken[k]) != lines_of(ref_taken[k])
            for k in ("prometheus", "forward_statsd")):
        raise AssertionError(f"{what}: the native server's sinks sent "
                             "other metrics than the CPU server's")
    if not spill and server.workers[0].micro_folds_total < 1:
        raise AssertionError("the native server's scheduler ran no "
                             "micro-fold")
    if canonical(got) != ref or canonical(delivered) != ref:
        raise AssertionError("native server InterMetrics != the Python-path "
                             "CPU server's")
    if server.last_unique_timeseries != ref_tally:
        raise AssertionError(f"native server tally "
                             f"{server.last_unique_timeseries} != {ref_tally}")
    if server.native_reader_threads != 0:
        raise AssertionError("a C++ reader outlived shutdown")
    log(f"[native server{' spill' if spill else ''}] {len(grams)} UDP "
        f"datagrams read by a C++ reader "
        f"thread (native_mode on, no Python reader) -> {len(got)} "
        f"InterMetrics on {server.device}, equal to the Python-path CPU "
        f"server's, and so are its sinks' series and lines; unique "
        f"timeseries {ref_tally}; micro-folds "
        f"{server.workers[0].micro_folds_total}; {wall:.2f} s")


# -- phase 8 ------------------------------------------------------------------


EGRESS_AGGS = ["min", "max", "count", "sum", "avg", "median", "hmean"]
EGRESS_NOW = 1_700_000_000
# the port's native encoders, each counted while phase 8's sinks flush
ENCODERS = ("encode_datadog_series", "encode_signalfx_body",
            "encode_prometheus_lines", "encode_forward_lines",
            "encode_prometheus_exposition")


@contextlib.contextmanager
def counting_encoders():
    """Count each native encoder's calls and the calls that returned a
    payload (None sends the group to the Python formatter)."""
    from veneur_tpu_torch import native

    counts = {name: [0, 0] for name in ENCODERS}
    saved = {name: getattr(native, name) for name in ENCODERS}

    def wrap(name):
        def call(*args, **kw):
            out = saved[name](*args, **kw)
            counts[name][0] += 1
            counts[name][1] += out is not None
            return out
        return call

    for name in ENCODERS:
        setattr(native, name, wrap(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)


def batch_arrays_equal(a, b, what: str) -> None:
    """Two ColumnarMetrics batches: every group's arrays bitwise, arenas
    and row metadata equal, the extras equal."""
    if len(a.groups) != len(b.groups):
        raise AssertionError(f"{what}: groups differ")
    for gi, (ga, gb) in enumerate(zip(a.groups, b.groups)):
        if (ga.nrows, ga.has_routing) != (gb.nrows, gb.has_routing) or \
                bytes(ga.meta_blob or b"") != bytes(gb.meta_blob or b"") \
                or (ga.meta_blob is None) != (gb.meta_blob is None):
            raise AssertionError(f"{what}: group {gi} rows or arena differ")
        if [(f.suffix, f.type) for f in ga.families] != \
                [(f.suffix, f.type) for f in gb.families]:
            raise AssertionError(f"{what}: group {gi} families differ")
        for fa, fb in zip(ga.families, gb.families):
            if fa.values.tobytes() != fb.values.tobytes() or \
                    (fa.mask is None) != (fb.mask is None) or (
                        fa.mask is not None
                        and fa.mask.tobytes() != fb.mask.tobytes()):
                raise AssertionError(f"{what}: group {gi} family "
                                     f"{fa.suffix!r} differs")
    if canonical(a.extras) != canonical(b.extras):
        raise AssertionError(f"{what}: extras differ")


def egress_server(http: HttpTap, repeater: TcpTap, forward: TcpTap):
    """A factory-built server on the card whose metric sinks are every
    ported network sink, pointed at the local listeners."""
    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server

    data = {"interval": "1h", "hostname": "chip-smoke",
            "percentiles": QS, "aggregates": EGRESS_AGGS,
            "tags": ["smoke:8"],
            "datadog_api_key": "smoke", "datadog_api_hostname": http.base,
            "signalfx_api_key": "smoke", "signalfx_endpoint_base": http.base,
            "prometheus_repeater_address": repeater.address,
            "prometheus_network_type": "tcp",
            "prometheus_pushgateway_address":
                f"{http.base}/metrics/job/smoke",
            "forward_statsd_address": forward.address,
            "forward_statsd_network": "tcp",
            "newrelic_insert_key": "smoke", "newrelic_account_id": 8}
    server = build_server(load_config(data=data), device=DEVICE,
                          opener=http.opener)
    pin_idempotency(server)
    for sink in server.metric_sinks:
        # New Relic's URL names its public collector: its requests must
        # go through the listener's opener
        if getattr(sink, "opener", http.opener) != http.opener:
            raise AssertionError(f"sink {sink.name()} has its own opener")
    return server


# the sinks the CPU batch flushes through in phase 8: the HTTP JSON
# sinks; the three line sinks (repeater, exposition, forward) are cut
# for the run's time (PERF.md section 4): their encoders read the batch's
# arrays, which are held bitwise equal to the CPU batch's first
CPU_BATCH_SINKS = ("DatadogMetricSink", "SignalFxMetricSink",
                   "NewRelicMetricSink")


def emit_once(batch, native: bool, only=None) -> dict:
    """Each sink of egress_server (or each named in ``only``) flushes the
    batch in turn through the server's negotiation, the native tier on or
    off; per sink its seconds, what its listener took, and the native
    encoder calls."""
    http, repeater, forward = HttpTap(), TcpTap(), TcpTap()
    server = egress_server(http, repeater, forward)
    server.flush_emit_native = native
    out = {}
    try:
        for sink in server.metric_sinks:
            if only is not None and type(sink).__name__ not in only:
                continue
            with counting_encoders() as enc:
                t0 = time.perf_counter()
                server._flush_sink_columnar(sink, batch, None)
                secs = time.perf_counter() - t0
            out[type(sink).__name__] = {"s": secs, "encoders": {
                k: v for k, v in enc.items() if v[0]}}
        close_sink_sockets(server)
        taken = {"http": http.taken(), "http_keys": sorted(http.keys),
                 "repeater": (repeater.taken() if "PrometheusMetricSink"
                              in out else None),
                 "forward": (forward.taken() if "ForwardStatsdSink" in out
                             else None)}
        counts = server.sink_counters()
        delivery = server.delivery_stats()
    finally:
        server.shutdown()
        for tap in (http, repeater, forward):
            tap.close()
    for name, c in counts.items():
        if c["flush_error_total"] or c["metrics_flushed_total"] < 1:
            raise AssertionError(f"phase 8: sink {name}: {c}")
    for name, d in delivery.items():
        if d["spilled_payloads"] or d["dropped_payloads"]:
            raise AssertionError(f"phase 8: delivery of {name}: {d}")
    return {"sinks": out, "taken": taken}


def http_by_sink(requests) -> dict:
    """The HTTP requests by sink, from their paths."""
    out = {"datadog": [], "signalfx": [], "exposition": [], "newrelic": []}
    for r in requests:
        path = r[0]
        key = ("datadog" if path.startswith(("/api/", "/intake")) else
               "signalfx" if path.startswith("/v2/") else
               "exposition" if path.startswith("/metrics/") else
               "newrelic" if path.startswith("/v1/accounts/") else None)
        if key is None:
            raise AssertionError(f"phase 8: request to {path}")
        out[key].append(r)
    return out


def signalfx_points(requests) -> list:
    out = []
    for path, _hdrs, body in requests:
        if path.startswith("/v2/datapoint"):
            for kind, pts in json.loads(body).items():
                for p in pts:
                    p["value"] = float(p["value"])
                    out.append(json.dumps([kind, p], sort_keys=True))
    return sorted(out)


def phase_egress(snap_g, snap_c) -> tuple:
    """Phase 8: phase 4's 100k-series snapshot from the card through
    generate_columnar (held to the object path, and to the CPU
    snapshot's batch bitwise), then through every ported metric sink to
    local listeners: native tier on and off on the card's batch, native
    on the CPU's through CPU_BATCH_SINKS. Raises on any difference.
    Returns the results and the card and CPU batches (phase 15a's
    input)."""
    import zlib

    from veneur_tpu_torch.core.flusher import (generate_columnar,
                                               generate_inter_metrics)
    from veneur_tpu_torch.core.metrics import HistogramAggregates

    aggs = HistogramAggregates.from_names(EGRESS_AGGS)
    t0 = time.perf_counter()
    objs = generate_inter_metrics(snap_g, False, QS, aggs, now=EGRESS_NOW)
    t_obj = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = generate_columnar(snap_g, False, QS, aggs, now=EGRESS_NOW)
    t_col = time.perf_counter() - t0
    t0 = time.perf_counter()
    mats = batch.materialize()
    t_mat = time.perf_counter() - t0
    if len(batch) != len(objs) or canonical(mats) != canonical(objs):
        raise AssertionError("phase 8: materialize() != the object path")
    del objs, mats
    batch_c = generate_columnar(snap_c, False, QS, aggs, now=EGRESS_NOW)
    batch_arrays_equal(batch, batch_c, "phase 8, card against CPU")
    plans = batch.emit_plan()
    if not plans or any(p is None for p in plans):
        raise AssertionError("phase 8: a group has no native emit plan")
    log(f"[egress] {len(batch)} metrics in {len(batch.groups)} groups; "
        f"generate_s object {t_obj:.4f}, columnar {t_col:.4f} "
        f"(materialize {t_mat:.4f}); materialize() equal to the object "
        f"path; the batch bitwise equal to the CPU snapshot's")

    runs = {"native": emit_once(batch, True),
            "python": emit_once(batch, False),
            "cpu_native": emit_once(batch_c, True, CPU_BATCH_SINKS)}
    # the native tier took every group of every native-capable sink
    for name, rec in runs["native"]["sinks"].items():
        enc = rec["encoders"]
        if name == "NewRelicMetricSink":
            if enc:
                raise AssertionError("phase 8: New Relic called an encoder")
            continue
        calls = sum(v[0] for v in enc.values())
        done = sum(v[1] for v in enc.values())
        if calls != len(batch.groups) or done != calls:
            raise AssertionError(f"phase 8: {name}: native encoders took "
                                 f"{done} of {len(batch.groups)} groups")
    for name, rec in runs["python"]["sinks"].items():
        if rec["encoders"]:
            raise AssertionError(f"phase 8: {name} encoded natively with "
                                 "the tier off")
    nat, py, cpu = (runs[k]["taken"] for k in ("native", "python",
                                                "cpu_native"))
    # card against CPU: every byte of the HTTP JSON sinks, the Datadog
    # bodies raw and inflated
    hn, hp, hc = (http_by_sink(x["http"]) for x in (nat, py, cpu))
    if any(hn[k] != hc[k] for k in ("datadog", "signalfx", "newrelic")):
        raise AssertionError("phase 8: the card batch's sinks sent other "
                             "bytes than the CPU batch's")
    inflate = [zlib.decompress(b) for p, _h, b in hn["datadog"]
               if p.startswith("/api/v1/series")]
    if inflate != [zlib.decompress(b) for p, _h, b in hc["datadog"]
                   if p.startswith("/api/v1/series")]:
        raise AssertionError("phase 8: inflated Datadog bodies differ")
    # native against Python: byte for byte where the formats are one
    # (lines, exposition text, New Relic), else the same series and
    # points (the native JSON bodies are compact and chunked per group)
    if nat["repeater"] != py["repeater"] or nat["forward"] != py["forward"]:
        raise AssertionError("phase 8: native lines != Python lines")
    if hn["exposition"] != hp["exposition"] or \
            hn["newrelic"] != hp["newrelic"]:
        raise AssertionError("phase 8: native exposition or New Relic "
                             "bytes != Python's")
    if datadog_entries(hn["datadog"]) != datadog_entries(hp["datadog"]):
        raise AssertionError("phase 8: native Datadog series != Python's")
    if signalfx_points(hn["signalfx"]) != signalfx_points(hp["signalfx"]):
        raise AssertionError("phase 8: native SignalFx points != Python's")

    sinks = {name: {f"{run}_s": runs[run]["sinks"][name]["s"]
                    for run in runs if name in runs[run]["sinks"]}
             for name in runs["native"]["sinks"]}
    for name, key in (("DatadogMetricSink", "datadog"),
                      ("SignalFxMetricSink", "signalfx"),
                      ("PrometheusExpositionSink", "exposition"),
                      ("NewRelicMetricSink", "newrelic")):
        sinks[name].update(
            requests=len(hn[key]), python_requests=len(hp[key]),
            bytes=sum(len(b) for _p, _h, b in hn[key]))
    sinks["PrometheusMetricSink"].update(
        requests=1, bytes=len(nat["repeater"]))
    sinks["ForwardStatsdSink"].update(requests=1, bytes=len(nat["forward"]))
    for name, s in sinks.items():
        cpu_s = (f"{s['cpu_native_s']:.4f} s" if "cpu_native_s" in s
                 else "not run")
        log(f"[egress] {name}: native {s['native_s']:.4f} s, Python "
            f"{s['python_s']:.4f} s (CPU batch native {cpu_s}); "
            f"{s['requests']} requests, {s['bytes']} bytes")
    log("[egress] the HTTP JSON sinks' bytes from the card batch equal "
        "the CPU batch's; native equal to Python; the native tier took "
        "every group of every native-capable sink")
    return {"metrics": len(batch), "groups": len(batch.groups),
            "generate_object_s": t_obj, "generate_columnar_s": t_col,
            "materialize_s": t_mat, "sinks": sinks}, batch, batch_c


# -- phase 9 ------------------------------------------------------------------


SHARDS = 4


def run_shard_interval(worker, steps, qs, sharded: bool):
    """Phase 4c's datagrams, datagram j of the interval to reader
    j % SHARDS (each reader's order kept). Sharded: each reader's through
    its own owned context (ingest_owned), interleaved as dealt. Legacy:
    the readers' streams serialized in context order through the home
    context. No drain before the swap on either side: a drained batch of
    context-level spill folds as a batch of its own, and spill cut into
    other batches folds to other bits (ROADMAP.md section 3); at the swap
    each side's spill is one batch. Returns (snapshot, seconds by step)."""
    t0 = time.perf_counter()
    if sharded:
        ctxs = worker._reader_ctxs
        j = 0
        for _kind, grams in steps:
            for d in grams:
                ctxs[j % SHARDS].ingest_owned(d)
                j += 1
    else:
        streams = [[] for _ in range(SHARDS)]
        j = 0
        for _kind, grams in steps:
            for d in grams:
                streams[j % SHARDS].append(d)
                j += 1
        for stream in streams:
            for d in stream:
                worker._native.ingest(d)
    t1 = time.perf_counter()
    snap = worker.flush(qs)
    t2 = time.perf_counter()
    if worker.parse_errors or worker.overload_dropped_total:
        raise AssertionError(f"phase 9 worker on {worker.device}: "
                             f"{worker.parse_errors} parse errors, "
                             f"{worker.overload_dropped_total} shed")
    return snap, {"native_ingest_s": t1 - t0, "flush_s": t2 - t1,
                  **worker.last_extract_phases,
                  "plane_upload_bytes": worker.last_plane_upload_bytes}


def gauges_through_many_readers(steps) -> int:
    """Gauge series whose lines reach more than one reader."""
    seen: dict = {}
    j = 0
    for _kind, grams in steps:
        for d in grams:
            for line in d.split(b"\n"):
                if line.endswith(b"|g") or b"|g|" in line:
                    seen.setdefault(line.split(b":", 1)[0], set()).add(
                        j % SHARDS)
            j += 1
    return sum(1 for readers in seen.values() if len(readers) > 1)


def phase_shards(tw, generate, qs, steps):
    """Phase 9: phase 4c's interval through SHARDS owned reader contexts
    on the card, against a legacy worker fed the same datagrams in
    context order (series-identical, bitwise) and against the sharded
    interval on the CPU (bitwise); then a server with num_readers 4 and
    the default reader_shards."""
    fold_args = []
    orig_fold = tw.fold_staged

    def keep_fold(*args, **kwargs):
        fold_args.append((args, kwargs))
        return orig_fold(*args, **kwargs)

    keep_fold.launches = 0
    w = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    w.attach_native()
    if not w.attach_reader_shards(SHARDS) or len(w._reader_ctxs) != SHARDS:
        raise AssertionError("phase 9: the reader shards did not attach")
    tw.fold_staged = keep_fold
    try:
        snap, card = run_shard_interval(w, steps, qs, sharded=True)
    finally:
        tw.fold_staged = orig_fold
    # the wrapped fold counted its launches on the name it was called by
    card["tdigest_fold_staged_launches"] = keep_fold.launches
    orig_fold.launches += keep_fold.launches
    check_guard_clean(w, snap, "phase 9, card")
    committed = list(w.reader_committed)
    if sum(committed) != w.processed_total or committed[0] != 0 \
            or min(committed[1:]) < 1:
        raise AssertionError(f"phase 9 attribution: committed {committed},"
                             f" processed {w.processed_total}")
    if len(fold_args) != 1 or w.micro_folds_total \
            or not isinstance(fold_args[0][0][1], tw.FlatStage):
        raise AssertionError(f"phase 9: {len(fold_args)} staged folds of "
                             f"the merged flat plane, "
                             f"{w.micro_folds_total} micro-folds")
    if DEVICE == "cuda" and card["tdigest_fold_staged_launches"] != 1:
        raise AssertionError("phase 9: the stacked fold did not launch K3")
    # K3 at this interval's shape, on the card: the merged plane's flat
    # samples folded into the pool (its launches here are not the path's)
    args, kwargs = fold_args[0]
    saved = orig_fold.launches
    card["k3_ms"] = probe.cuda_ms(lambda: orig_fold(*args, **kwargs), 21)
    orig_fold.launches = saved
    card["k3_share_of_fold"] = card["k3_ms"] / (1e3 * card["fold_s"])
    card["k3_rows"] = int(args[0][0].shape[0])
    card["k3_samples"] = int(args[1].counts.sum())
    del fold_args, args, kwargs, w
    legacy = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    legacy.attach_native()
    k3 = tw.fold_staged.launches
    snap_l, t_l = run_shard_interval(legacy, steps, qs, sharded=False)
    t_l["tdigest_fold_staged_launches"] = tw.fold_staged.launches - k3
    if DEVICE == "cuda" and t_l["tdigest_fold_staged_launches"] < 1:
        raise AssertionError("phase 9: the legacy worker's staged fold did "
                             "not launch K3")
    check_guard_clean(legacy, snap_l, "phase 9, legacy card")
    if legacy.processed_total != sum(committed):
        raise AssertionError("phase 9: the legacy worker processed "
                             f"{legacy.processed_total}, the shards "
                             f"{sum(committed)}")
    del legacy
    if canonical(generate(snap)) != canonical(generate(snap_l)):
        raise AssertionError("phase 9: sharded InterMetrics != legacy")
    if snap.unique_timeseries_registers.tobytes() != \
            snap_l.unique_timeseries_registers.tobytes():
        raise AssertionError("phase 9: unique-timeseries registers differ")
    del snap_l
    w = tw.DeviceWorker(**INTERVAL_KW, device="cpu")
    w.attach_native()
    w.attach_reader_shards(SHARDS)
    snap_c, cpu = run_shard_interval(w, steps, qs, sharded=True)
    check_guard_clean(w, snap_c, "phase 9, CPU")
    del w
    compare_snapshots(snap, snap_c, "phase 9, sharded card against CPU")
    del snap_c
    check_set_estimates(snap.set_estimates)
    many = gauges_through_many_readers(steps)
    log(f"[shards] phase 4c's interval through {SHARDS} owned reader "
        f"contexts (committed by context {committed}): series-identical "
        f"bitwise to the legacy worker ({many} gauge series reach more "
        f"than one reader, none left out), and bitwise the sharded CPU "
        f"worker's; K3 (the staged fold) {card['k3_ms']:.4f} ms over "
        f"{card['k3_rows']} rows and {card['k3_samples']} samples, "
        f"{100 * card['k3_share_of_fold']:.2f}% of fold_s")
    for where, t in (("card sharded", card), ("card legacy", t_l),
                     ("cpu sharded", cpu)):
        log(f"[shards] {where}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()))
    server = phase_shard_server()
    return {"card": card, "card_legacy": t_l, "cpu": cpu,
            "committed": committed, "gauges_many_readers": many,
            "server": server}


def shard_server_datagrams(seed: int, senders: int = 8) -> list:
    """Phase 5's traffic under the staging depth, datagram i from sender
    i % senders with every series renamed by its sender (api.s<k>.*):
    each series travels one UDP flow, so one reader takes all of it, in
    order, whichever reader the kernel gives the flow."""
    return [(i % senders, d.replace(b"api.", b"api.s%d." % (i % senders)))
            for i, d in enumerate(server_datagrams(seed, spill=False))]


def phase_shard_server() -> dict:
    """Phase 9's server: phase 5b's configuration with num_readers 4 and
    the default reader_shards, so 4 C++ reader threads each commit into
    an owned context; 8 senders. Its InterMetrics, tally and sink output
    equal a Python-path CPU server's over the same datagrams."""
    import socket
    import threading

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    sent = shard_server_datagrams(seed=11)
    grams = [d for _k, d in sent]
    now = 1_700_000_000
    data = {**server_config(native=True, spill=False), "num_readers": SHARDS}
    what = "phase 9 server"
    sink, taps = ChannelMetricSink(), SinkTaps()
    server = build_server(load_config(data={**data, **taps.config()}),
                          extra_metric_sinks=[sink], device=DEVICE)
    pin_idempotency(server)
    server.set_lock_stats(True)
    ports = server.start()
    try:
        py_readers = [t.name for t in threading.enumerate()
                      if t.name.startswith("statsd-udp")]
        if server._reader_shards != SHARDS or \
                len(server.workers[0]._reader_ctxs) != SHARDS or \
                server.native_reader_threads != SHARDS or py_readers:
            raise AssertionError(
                f"{what}: reader shards {server._reader_shards}, owned "
                f"contexts {len(server.workers[0]._reader_ctxs)}, C++ "
                f"readers {server.native_reader_threads}, Python readers "
                f"{py_readers}")
        port = ports["udp://127.0.0.1:0"]
        socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                 for _ in range(8)]
        try:
            for k, d in sent:
                socks[k].sendto(d, ("127.0.0.1", port))
                time.sleep(0.0005)
        finally:
            for s in socks:
                s.close()
        deadline = time.time() + 60
        while server.packets_received < len(grams) \
                and time.time() < deadline:
            time.sleep(0.05)
        if server.packets_received != len(grams):
            raise AssertionError(f"{what}: received "
                                 f"{server.packets_received} of "
                                 f"{len(grams)} datagrams")
        got = server.flush(now=now).materialize()
        ingress = server.ingress_stats()
    finally:
        server.shutdown()
        close_sink_sockets(server)
    try:
        taken = taps.taken()
    finally:
        taps.close()
    check_server_guard_clean(server, what)
    check_sink_counts(server, taken, what)
    delivered = []
    while not sink.queue.empty():
        delivered.extend(sink.queue.get_nowait())
    taps = SinkTaps()
    ref_server = build_server(load_config(data={
        **server_config(native=False, spill=False),
        "statsd_listen_addresses": [], **taps.config()}), device="cpu")
    pin_idempotency(ref_server)
    for d in grams:
        ref_server.process_metric_packet(d)
    try:
        ref = ref_server.flush(now=now).materialize()
        close_sink_sockets(ref_server)
        ref_taken = taps.taken()
    finally:
        ref_server.shutdown()
        taps.close()
    if canonical(got) != canonical(ref) or \
            canonical(delivered) != canonical(ref):
        raise AssertionError(f"{what}: InterMetrics != the CPU server's")
    if datadog_entries(taken["datadog"]) != \
            datadog_entries(ref_taken["datadog"]) or any(
            lines_of(taken[k]) != lines_of(ref_taken[k])
            for k in ("prometheus", "forward_statsd")):
        raise AssertionError(f"{what}: its sinks sent other metrics than "
                             "the CPU server's")
    if server.last_unique_timeseries != ref_server.last_unique_timeseries:
        raise AssertionError(f"{what}: tally "
                             f"{server.last_unique_timeseries} != "
                             f"{ref_server.last_unique_timeseries}")
    rs = ingress["reader_shards"]
    if rs["shards"] != SHARDS or sum(rs["committed"]) < 1:
        raise AssertionError(f"{what}: reader stats {rs}")
    locks = [{k: v for k, v in lk.items()} for lk in rs.get("lock", [])]
    log(f"[shards server] {len(grams)} UDP datagrams from 8 senders read "
        f"by {SHARDS} C++ reader threads into {SHARDS} owned contexts "
        f"(committed by context {rs['committed']}) -> {len(got)} "
        f"InterMetrics, equal to the Python-path CPU server's, and so are "
        f"its sinks' series and lines; unique timeseries "
        f"{server.last_unique_timeseries}")
    for i, lk in enumerate(locks):
        log(f"[shards server] context {i} mutex: " + ", ".join(
            f"{k} {v}" for k, v in lk.items()))
    return {"committed": rs["committed"], "lock": locks,
            "metrics": len(got)}


# -- phase 10 -----------------------------------------------------------------


# bench.py's global_merge width (bench.py:394-397): 8 hosts, 65,536 series
GM_HOSTS, GM_SERIES, GM_SAMPLES = 8, 65_536, 40
# the HTTP arm forwards the first two locals (cut for the run's time)
GM_HTTP_HOSTS = 2
GM_COUNTERS = GM_GAUGES = 4_096
GM_SETS, GM_MEMBERS = 1_024, 256
GM_NOW = 1_700_000_000
GM_AGGS = ["min", "max", "count", "sum"]


def gm_plan(host: int, series: int = GM_SERIES):
    """One local's interval: ``series`` mixed-scope histogram and timer
    series over the series space every local shares (one line each,
    then GM_SAMPLES - 1 bulk samples), global counters and gauges, and
    GM_SETS mixed-scope sets of GM_MEMBERS members of this host (the
    strings m%09d, p = 14), all from the host's own seed."""
    import numpy as np

    from veneur_tpu_torch.ops.hll import split_hashes

    rng = np.random.default_rng(7_000 + host)
    lines = [f"gm.lat.{i}:{rng.gamma(2.0, 20.0):.4f}|"
             f"{'ms' if i % 2 else 'h'}|#shard:{i % 16}".encode()
             for i in range(series)]
    lines += [f"gm.req.{i}:{1 + (i + host) % 5}|c|#veneurglobalonly"
              .encode() for i in range(GM_COUNTERS)]
    lines += [f"gm.queue.{i}:{rng.normal(10.0, 3.0):.5f}|g"
              f"|#veneurglobalonly".encode() for i in range(GM_GAUGES)]
    lines += [f"gm.users.{i}:h{host}|s|#shard:{i % 16}".encode()
              for i in range(GM_SETS)]
    rows = np.repeat(np.arange(series), GM_SAMPLES - 1).astype(np.int32)
    rows = rows[rng.permutation(len(rows))]
    vals = rng.gamma(2.0, 20.0, len(rows)).astype(np.float32)
    srows = np.repeat(np.arange(GM_SETS), GM_MEMBERS).astype(np.int32)
    srows = srows[rng.permutation(len(srows))]
    ids = host * GM_SETS * GM_MEMBERS + np.arange(len(srows))
    idx, rank = split_hashes(member_hashes(ids), 14)
    return lines, rows, vals, srows, idx, rank


def gm_ingest(worker, plan, parse) -> None:
    import numpy as np

    lines, rows, vals, srows, idx, rank = plan
    for line in lines:
        worker.process_metric(parse(line))
    worker._flush_pending_histos()
    worker._flush_pending_sets()
    b = worker.batch_size
    for i in range(0, len(rows), b):
        worker._device_histo_step(rows[i:i + b], vals[i:i + b],
                                  np.ones(len(rows[i:i + b]), np.float32))
    for i in range(0, len(srows), b):
        worker._device_set_step(srows[i:i + b], idx[i:i + b], rank[i:i + b])
    worker._sync()


class ForwardRecorder:
    """The forwarders' telemetry client (distributed/forward.py
    _report_forward): metrics, seconds, body bytes and errors of each
    forward."""

    def __init__(self) -> None:
        self.forwards: list[dict] = []

    def count(self, name, value, tags=None) -> None:
        if name == "forward.post_metrics_total":
            self.forwards.append({"metrics": int(value)})
        elif name == "forward.error_total":
            self.forwards[-1]["error"] = tags

    def time_in_nanoseconds(self, name, ns, tags=None) -> None:
        self.forwards[-1]["s"] = ns / 1e9

    def histogram(self, name, value, tags=None) -> None:
        self.forwards[-1]["bytes"] = int(value)


def capture_snapshots(server) -> list:
    """The snapshots the server's flush extracts, kept as they come."""
    got = []
    for w in server.workers:
        def wrapped(*a, _orig=w.extract_snapshot, **k):
            snap = _orig(*a, **k)
            got.append(snap)
            return snap
        w.extract_snapshot = wrapped
    return got


class ImportTap:
    """Wraps a global's import server: every payload it applies (a wire
    MetricBatch, or an HTTP body's decoded batch) kept in arrival order,
    with the seconds of its application; and the native decoder and
    upsert counted and timed."""

    def __init__(self, imp) -> None:
        self.payloads: list = []
        self.seconds = {"import_s": 0.0, "decode_s": 0.0, "upsert_s": 0.0,
                        "http_decode_s": 0.0}
        self._depth = 0
        orig_wire, orig_batch = imp._apply_wire, imp.handle_batch

        def apply_wire(blob):
            self.payloads.append(("wire", bytes(blob)))
            t0 = time.perf_counter()
            self._depth += 1
            try:
                return orig_wire(blob)
            finally:
                self._depth -= 1
                self.seconds["import_s"] += time.perf_counter() - t0

        def handle_batch(batch):
            if not self._depth:
                self.payloads.append(("batch", batch.SerializeToString()))
            t0 = time.perf_counter()
            try:
                return orig_batch(batch)
            finally:
                if not self._depth:
                    self.seconds["import_s"] += time.perf_counter() - t0

        imp._apply_wire = apply_wire
        imp.handle_batch = handle_batch


@contextlib.contextmanager
def counting_codec(tap: ImportTap, counts: dict):
    """Count and time the native histogram encoder (locals), decoder and
    batched upsert (the global) while the block runs."""
    from veneur_tpu_torch import native
    from veneur_tpu_torch.distributed import import_server

    saved = {n: getattr(native, n) for n in (
        "encode_histo_batch", "decode_metric_batch", "upsert_many")}
    saved_http = import_server.decode_http_import_body

    def encode(*a, **k):
        out = saved["encode_histo_batch"](*a, **k)
        counts["encoded" if out is not None else "encode_declined"] += 1
        return out

    def decode(blob):
        t0 = time.perf_counter()
        out = saved["decode_metric_batch"](blob)
        tap.seconds["decode_s"] += time.perf_counter() - t0
        counts["decoded" if out is not None else "decode_declined"] += 1
        return out

    def upsert(*a, **k):
        t0 = time.perf_counter()
        out = saved["upsert_many"](*a, **k)
        tap.seconds["upsert_s"] += time.perf_counter() - t0
        return out

    def http_decode(*a, **k):
        t0 = time.perf_counter()
        out = saved_http(*a, **k)
        tap.seconds["http_decode_s"] += time.perf_counter() - t0
        return out

    native.encode_histo_batch = encode
    native.decode_metric_batch = decode
    native.upsert_many = upsert
    import_server.decode_http_import_body = http_decode
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(native, n, fn)
        import_server.decode_http_import_body = saved_http


def gm_global_config(tap, listen: bool) -> dict:
    # the HTTP imports are traced hops: their veneur.import spans derive
    # on the card global only (the CPU global replays the payloads), so
    # they must derive nothing
    data = {"interval": "1h", "percentiles": QS, "aggregates": GM_AGGS,
            "hostname": "gm-global", "tpu_hll_precision": 14,
            "ssf_span_uniqueness_rate": 0.0,
            "forward_statsd_address": tap.address,
            "forward_statsd_network": "tcp"}
    if listen:
        data.update(grpc_address="127.0.0.1:0", http_address="127.0.0.1:0")
    return data


def gm_local_config(address: str, grpc: bool, host: int) -> dict:
    data = {"interval": "1h", "percentiles": QS, "aggregates": GM_AGGS,
            "hostname": f"gm-local-{host}", "tpu_hll_precision": 14,
            "tpu_native_ingest": False, "forward_address": address}
    if grpc:
        data["forward_use_grpc"] = True  # forward_streaming is the default
    return data


def global_flush(server) -> tuple:
    """The global's flush at GM_NOW through its forward-statsd sink, with
    the merge at swap timed; returns (snapshot, phases, merge seconds)."""
    snaps = capture_snapshots(server)
    w = server.workers[0]
    merge = {"s": 0.0}

    def timed_merge(_orig=w._merge_imports):
        t0 = time.perf_counter()
        _orig()
        merge["s"] += time.perf_counter() - t0

    w._merge_imports = timed_merge
    server.flush(now=GM_NOW)
    close_sink_sockets(server)
    if len(snaps) != 1:
        raise AssertionError(f"global flush extracted {len(snaps)} "
                             "snapshots")
    return snaps[0], dict(w.last_extract_phases), merge["s"]


def phase_global(parse) -> tuple:
    """Phase 10: eight port locals on the card flush and forward in turn
    to a port global on the card, over gRPC streaming and over HTTP
    /import; each payload the global applied is replayed in order into a
    CPU global. The card global's snapshot equals the CPU global's
    bitwise, and so do the bytes of its forward-statsd sink. Returns the
    results and, for phase 12, the eight local snapshots and the gRPC
    global's snapshot and sink bytes (on the host)."""
    import numpy as np
    import torch

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.distributed.import_server import ImportServer
    from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.sinks.blackhole import BlackholeMetricSink

    out: dict = {}
    local_snaps: list = []
    keep: dict = {}
    for transport in ("grpc", "http"):
        hosts = GM_HOSTS if transport == "grpc" else GM_HTTP_HOSTS
        tap = TcpTap()
        g = build_server(load_config(data=gm_global_config(tap, True)),
                         device=DEVICE)
        itap = ImportTap(g.import_server)
        counts = {"encoded": 0, "encode_declined": 0, "decoded": 0,
                  "decode_declined": 0}
        forwards = []
        expect = 0
        t_locals = time.perf_counter()
        try:
            with counting_codec(itap, counts):
                for host in range(hosts):
                    rec = ForwardRecorder()
                    if transport == "grpc":
                        # the local's own flush forwards, on its thread
                        local = build_server(load_config(data=gm_local_config(
                            f"127.0.0.1:{g.import_server.port}", True, host)),
                            extra_metric_sinks=[BlackholeMetricSink()],
                            device=DEVICE)
                        local.forwarder.stats = rec
                        snaps = capture_snapshots(local)
                        gm_ingest(local.workers[0], gm_plan(host), parse)
                        local.flush(now=GM_NOW)
                        local._forward_thread.join(120)
                        stream = local.forward_stats()["destinations"][
                            f"127.0.0.1:{g.import_server.port}"]["stream"]
                        local.shutdown()
                        local_snaps.append(snaps[0])
                    else:
                        # the same local snapshots through the factory's
                        # HTTP forwarder
                        local = build_server(load_config(data=gm_local_config(
                            f"http://127.0.0.1:{g.import_http.port}", False,
                            host)), device=DEVICE)
                        local.forwarder.stats = rec
                        local.forwarder([local_snaps[host]])
                        local.shutdown()
                        stream = None
                    f = rec.forwards[-1]
                    if "error" in f:
                        raise AssertionError(f"phase 10 {transport} local "
                                             f"{host}: forward error {f}")
                    expect += f["metrics"]
                    deadline = time.time() + 120
                    while g.import_server.received_metrics < expect \
                            and time.time() < deadline:
                        time.sleep(0.01)
                    if g.import_server.received_metrics != expect or \
                            g.import_server.import_errors:
                        raise AssertionError(
                            f"phase 10 {transport}: the global took "
                            f"{g.import_server.received_metrics} of {expect}"
                            f" metrics, {g.import_server.import_errors} "
                            "errors")
                    f["frames"] = (None if stream is None
                                   else stream["acked_total"])
                    forwards.append(f)
            t_locals = time.perf_counter() - t_locals
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            snap_g, phases_g, merge_g = global_flush(g)
            flush_g = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
        finally:
            g.shutdown()
        taken = tap.taken()
        tap.close()
        if transport == "grpc" and (
                counts["encoded"] != GM_HOSTS or counts["encode_declined"]
                or counts["decoded"] != sum(1 for k, _ in itap.payloads
                                            if k == "wire")
                or counts["decode_declined"] or not counts["decoded"]):
            raise AssertionError(f"phase 10: the native codec did not take "
                                 f"every payload: {counts}")
        # the CPU global, fed what the card's applied, in order
        tap_c = TcpTap()
        gc = build_server(load_config(data=gm_global_config(tap_c, False)),
                          device="cpu")
        imp_c = ImportServer(gc)
        t0 = time.perf_counter()
        for kind, blob in itap.payloads:
            if kind == "wire":
                imp_c._apply_wire(blob)
            else:
                imp_c.handle_batch(pb.MetricBatch.FromString(blob))
        replay_s = time.perf_counter() - t0
        try:
            snap_c, phases_c, merge_c = global_flush(gc)
        finally:
            gc.shutdown()
        taken_c = tap_c.taken()
        tap_c.close()
        compare_snapshots(snap_g, snap_c,
                          f"phase 10 {transport}, card global against CPU")
        if transport == "grpc":
            keep.update(snap=snap_g, taken=taken)
        if taken != taken_c or not taken:
            raise AssertionError(f"phase 10 {transport}: the card global's "
                                 "sink sent other bytes than the CPU's")
        n = snap_g.directory.num_histo_rows
        if n != GM_SERIES or not np.isfinite(snap_g.quantile_values).all() \
                or not (snap_g.dcount == hosts * GM_SAMPLES).all():
            raise AssertionError(f"phase 10 {transport}: {n} merged rows, "
                                 "counts or quantiles off")
        est = snap_g.set_estimates
        truth = hosts * (GM_MEMBERS + 1)
        if est is None or est.shape != (GM_SETS,) or \
                np.abs(est / truth - 1).max() > 0.05:
            raise AssertionError(f"phase 10 {transport}: set estimates off")
        del snap_c
        res = {"forwards": forwards, "locals_s": t_locals,
               "payloads": len(itap.payloads), **itap.seconds,
               "merge_at_swap_s": merge_g, "flush_s": flush_g,
               **{k: phases_g[k] for k in ("fold_s", "extract_s", "sets_s")
                  if k in phases_g},
               "peak_device_bytes": peak, "sink_bytes": len(taken),
               "cpu_replay_s": replay_s, "cpu_merge_at_swap_s": merge_c,
               **{f"cpu_{k}": phases_c[k] for k in ("fold_s", "extract_s",
                                                     "sets_s")
                  if k in phases_c}, "codec": counts}
        out[transport] = res
        log(f"[global {transport}] {hosts} locals x {GM_SERIES} series "
            f"forwarded in turn ({len(itap.payloads)} payloads applied; "
            f"native codec {counts}) -> {n} merged rows, "
            f"{snap_g.directory.num_set_rows} sets; the card global's "
            f"snapshot bitwise the CPU global's, its forward-statsd sink's "
            f"{len(taken)} bytes equal")
        for i, f in enumerate(forwards):
            log(f"[global {transport}] local {i}: {f['metrics']} metrics, "
                f"{f.get('bytes')} bytes, {f['frames']} frames, "
                f"{f['s']:.4f} s")
        log(f"[global {transport}] " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in res.items() if k not in ("forwards", "codec")))
    # merge_many over the eight locals' digest rows, card against CPU
    st = [np.stack([getattr(s, f) for s in local_snaps]).astype(np.float32)
          for f in ("digest_means", "digest_weights", "dmin", "dmax",
                    "drecip")]
    keep["local_snaps"] = local_snaps
    pool_g = td.TDigestPool(*(torch.from_numpy(a).to(DEVICE) for a in st))
    mm_ms = probe.cuda_ms(lambda: td.merge_many(pool_g), 5)
    got = td.merge_many(pool_g)
    ref = td.merge_many(td.TDigestPool(*(torch.from_numpy(a) for a in st)))
    for name, a, b in zip(td.TDigestPool._fields, got, ref):
        same, err = probe.bitwise_equal(a.cpu(), b)
        if not same:
            raise AssertionError(f"phase 10: merge_many {name} differs "
                                 f"(max abs err {err})")
    out["merge_many_ms"] = mm_ms
    log(f"[global] merge_many at {list(st[0].shape)} on the card "
        f"{mm_ms:.4f} ms, bitwise the CPU's")
    return out, keep


# -- phase 16 -----------------------------------------------------------------


# 16a: phase 4's interval over this many series shards on the one card
SERIES_SHARDS = 4
# 16b: the mesh global's grid, and its locals: phase 10's interval cut
# from 65,536 series a local to MESH_SERIES. The mesh's import re-ingests
# every centroid through a host loop and streams batches of MESH_BATCH
# to the grid (distributed/mesh.MeshHistoPool); tools/port_probe_mesh.py
# sized the cut: the CPU twin's import, past a minute at 65,536 series,
# takes about 7 s at 8,192 (17 s at 16,384, 43 s at 32,768), which
# leaves phase 17 its room inside the time limit on the slowest host seen
MESH_DEVICES, MESH_HOSTS = 8, 2
MESH_LOCALS, MESH_SERIES = 8, 8_192
MESH_BATCH = 1 << 18


def phase_series_shards(tw, ek, hll, parse, generate, qs, plan, steps,
                        python_snap, phase4) -> dict:
    """Phase 16a: phase 4's interval through series_shards 4 on the one
    card, the Python path and the native path (4c's datagrams), both with
    micro-folds; each snapshot bitwise phase 4's unsharded card
    snapshot, and each kernel launched at least once per shard."""
    import torch

    dev = torch.device(DEVICE)
    kw = {**INTERVAL_KW, "series_shards": SERIES_SHARDS,
          "shard_devices": [dev] * SERIES_SHARDS}
    out = {}
    for name in ("python", "native"):
        w = tw.DeviceWorker(**kw, device=DEVICE)
        if w._shard is None or w.series_shards != SERIES_SHARDS:
            raise AssertionError("phase 16a: series sharding did not engage")
        k0 = read_launches(ek, hll)
        if name == "python":
            snap, t = run_interval(w, plan, parse, qs,
                                   micro_every=MICRO_EVERY)
        else:
            w.attach_native()
            snap, t = run_native_interval(w, steps, qs,
                                          micro_every=MICRO_EVERY_NATIVE)
        k1 = read_launches(ek, hll)
        t.update({f"{k}_launches": k1[k] - k0[k] for k in (
            "flush_extract", "hll_insert", "hll_estimate",
            "tdigest_compress", "tdigest_add_batch", "tdigest_fold_staged")})
        t["h2d_per_shard"] = w.ledger.flush_h2d_per_shard()
        t["d2h_per_shard"] = w.ledger.flush_d2h_per_shard()
        check_guard_clean(w, snap, f"phase 16a {name}")
        del w
        compare_snapshots(snap, python_snap, f"phase 16a {name}, sharded "
                          "against phase 4's unsharded card snapshot")
        if t["micro_folds"] < 2:
            raise AssertionError(f"phase 16a {name}: {t}")
        need = ("flush_extract", "hll_insert", "hll_estimate") + (
            ("tdigest_fold_staged",) if DEVICE == "cuda" else ())
        if min(t[f"{k}_launches"] for k in need) < SERIES_SHARDS:
            raise AssertionError(f"phase 16a {name}: a kernel launched "
                                 f"less than once per shard: {t}")
        if name == "python":
            t0 = time.perf_counter()
            got, want = (sorted((m.name, str(m.type), tuple(m.tags),
                                 m.value) for m in generate(x))
                         for x in (snap, python_snap))
            if got != want:
                raise AssertionError("phase 16a: the sharded InterMetrics "
                                     "differ from phase 4's")
            t["intermetrics"] = len(got)
            t["compare_intermetrics_s"] = time.perf_counter() - t0
            del got, want
        out[name] = t
        del snap
    keys = ("flush_s", "fold_s", "extract_s", "sets_s", "micro_folds")
    for name, t in [("phase 4 card (unsharded)", phase4["card"])] + \
            list(out.items()):
        log(f"[series shards] {name}: " + ", ".join(
            f"{k} {t[k]:.4f}" if isinstance(t.get(k), float)
            else f"{k} {t.get(k)}" for k in keys))
    for name, t in out.items():
        log(f"[series shards] {name}: launches flush_extract "
            f"{t['flush_extract_launches']}, hll_insert "
            f"{t['hll_insert_launches']}, hll_estimate "
            f"{t['hll_estimate_launches']}; H2D bytes by shard "
            f"{t['h2d_per_shard']}, D2H bytes by shard {t['d2h_per_shard']}")
    log(f"[series shards] {SERIES_SHARDS} shards on one card: both "
        f"snapshots bitwise phase 4's unsharded card snapshot, "
        f"{out['python']['intermetrics']} InterMetrics equal")
    return out


def mesh_global(device: str, frames) -> tuple:
    """A mesh global (tpu_mesh_devices MESH_DEVICES over MESH_HOSTS
    hosts; on the card a grid of the one card) applies the locals'
    frames through its ImportServer, then flushes its worker. Returns
    (snapshot, seconds: import, merge at the swap, flush)."""
    import numpy as np
    import torch

    from veneur_tpu_torch.core.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.distributed.import_server import ImportServer

    # the mesh pool streams a batch to the grid every tpu_batch_size
    # centroids, and each batch's ingest compresses every row of every
    # block: a large batch keeps that to a few passes an import
    cfg = Config(interval="1h", percentiles=QS, aggregates=GM_AGGS,
                 tpu_hll_precision=14, num_workers=1,
                 tpu_batch_size=MESH_BATCH, tpu_mesh_devices=MESH_DEVICES,
                 tpu_mesh_hosts=MESH_HOSTS, ssf_span_uniqueness_rate=0.0)
    grid = (None if device == "cpu"
            else [torch.device(device)] * MESH_DEVICES)
    srv = Server(cfg, device=device, shard_devices=grid)
    try:
        w = srv.workers[0]
        if srv.mesh is None or w._mesh_pool is None:
            raise AssertionError(f"phase 16b ({device}): no mesh")
        imp = ImportServer(srv)
        t0 = time.perf_counter()
        for blob, _n in frames:
            imp._apply_wire(blob)
        t1 = time.perf_counter()
        expect = sum(n for _b, n in frames)
        if imp.received_metrics != expect or imp.import_errors:
            raise AssertionError(f"phase 16b ({device}): the global took "
                                 f"{imp.received_metrics} of {expect}")
        qs = np.asarray(QS, np.float64)
        with srv._worker_locks[0]:
            # the mesh's cross-host merge and extraction run at the swap
            t2 = time.perf_counter()
            swapped = w.swap(qs)
            t3 = time.perf_counter()
            snap = w.extract_snapshot(swapped, qs, 3600.0)
            t4 = time.perf_counter()
        check_guard_clean(w, snap, f"phase 16b ({device})")
    finally:
        srv.shutdown()
    return snap, {"import_s": t1 - t0, "merge_at_swap_s": t3 - t2,
                  "flush_s": t4 - t2}


def phase_mesh(tw, ek, hll, parse, qs) -> tuple:
    """Phase 16b: MESH_LOCALS locals on the card flush and encode their
    forward frames; the card's mesh global and the CPU's apply them and
    flush; the snapshots bitwise equal, K1 once per series shard.
    Returns (the phase's record, the card mesh global's own launches:
    counted from 0 after the locals' frames are built)."""
    import numpy as np

    from veneur_tpu_torch.distributed import codec

    t0 = time.perf_counter()
    frames = []
    for host in range(MESH_LOCALS):
        w = tw.DeviceWorker(compression=100.0, stage_depth=64,
                            batch_size=16384, hll_precision=14,
                            device=DEVICE)
        gm_ingest(w, gm_plan(host, MESH_SERIES), parse)
        frames.append(codec.snapshot_to_wire(w.flush(qs), 100.0, 14))
        del w
    locals_s = time.perf_counter() - t0
    reset_launches(ek, hll)
    snap_g, t_g = mesh_global(DEVICE, frames)
    launches = read_launches(ek, hll)
    launched = launches["flush_extract"]
    snap_c, t_c = mesh_global("cpu", frames)
    compare_snapshots(snap_g, snap_c, "phase 16b, the card's mesh global "
                      "against the CPU's")
    del snap_c
    n = snap_g.directory.num_histo_rows
    d = MESH_DEVICES // MESH_HOSTS
    if n != MESH_SERIES or not np.isfinite(snap_g.quantile_values).all() \
            or not (snap_g.dcount == MESH_LOCALS * GM_SAMPLES).all():
        raise AssertionError(f"phase 16b: {n} merged rows, counts or "
                             "quantiles off")
    if launched < d:
        raise AssertionError(f"phase 16b: flush_extract launched {launched}"
                             f" times, fewer than the {d} series shards")
    if DEVICE == "cuda" and (launches["tdigest_compress"] < d
                             or launches["tdigest_add_batch"] < 1):
        raise AssertionError(f"phase 16b: the t-digest folds launched "
                             f"{launches['tdigest_compress']} and "
                             f"{launches['tdigest_add_batch']} times")
    out = {"locals_s": locals_s, "frames": len(frames),
           "frame_bytes": sum(len(b) for b, _n in frames),
           "metrics": sum(n for _b, n in frames), "rows": n,
           "flush_extract_launches": launched, "card": t_g, "cpu": t_c}
    log(f"[mesh] {MESH_LOCALS} locals x {MESH_SERIES} series "
        f"({out['frame_bytes']} frame bytes, {out['metrics']} metrics, "
        f"encoded in {locals_s:.2f} s) into a {MESH_HOSTS} x {d} mesh "
        f"global on one card: {n} merged rows, the snapshot bitwise the "
        f"CPU mesh global's; flush_extract launched {launched} times")
    for where, t in (("card", t_g), ("cpu", t_c)):
        log(f"[mesh] {where}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()))
    return out, launches


# -- phase 12 -----------------------------------------------------------------


# one proxy, then two, in front of four globals (proxy_main's defaults but
# a handoff window and forward timeout long enough for a 43 MB local)
PX_GLOBALS = 4
PX_CONFIG = {"handoff_window_s": 60.0, "forward_timeout": "60s"}
PX_HISTO_FIELDS = ("quantile_values", "dmin", "dmax", "dsum", "dcount",
                   "drecip", "lmin", "lmax", "lsum", "lweight", "lrecip",
                   "digest_means", "digest_weights")


def gm_proxy(dests: list):
    """A ProxyServer built from a proxy config as cli/proxy_main.py
    builds it (dedup and streaming on by default)."""
    from veneur_tpu_torch.core.config import load_proxy_config, \
        parse_duration
    from veneur_tpu_torch.distributed.proxy import ProxyServer
    from veneur_tpu_torch.sinks.delivery import DeliveryPolicy

    cfg = load_proxy_config(data=PX_CONFIG, env={})
    timeout_s = parse_duration(cfg.forward_timeout)
    policy = DeliveryPolicy(
        retry_max=cfg.forward_retry_max,
        breaker_threshold=cfg.forward_breaker_threshold,
        spill_max_bytes=cfg.forward_spill_max_bytes,
        spill_max_payloads=cfg.forward_spill_max_payloads,
        timeout_s=min(timeout_s, cfg.handoff_window_s),
        deadline_s=cfg.handoff_window_s)
    proxy = ProxyServer(
        dests, timeout_s=timeout_s, delivery=policy,
        routing_workers=cfg.routing_pool_workers,
        routing_queue_max=cfg.routing_queue_max,
        handoff_window_s=cfg.handoff_window_s, dedup=cfg.forward_dedup,
        streaming=cfg.forward_streaming,
        stream_window=cfg.forward_stream_window)
    # the route of each batch (ring split, fragments) and what each
    # destination was handed, timed and counted
    proxy.route_s = 0.0
    proxy.handed = {}

    def route_one(kind, item, _orig=proxy._route_one):
        t0 = time.perf_counter()
        try:
            _orig(kind, item)
        finally:
            proxy.route_s += time.perf_counter() - t0

    def deliver(dest, frag, _orig=proxy._deliver_fragment):
        frags, nbytes = proxy.handed.get(dest, (0, 0))
        proxy.handed[dest] = (frags + 1, nbytes + frag.nbytes)
        return _orig(dest, frag)

    proxy._pool._route = route_one
    proxy._deliver_fragment = deliver
    return proxy


def schedstat_readable() -> bool:
    import threading

    try:
        with open(f"/proc/self/task/{threading.get_native_id()}/schedstat"):
            return True
    except OSError:
        return False


def series_index(snap) -> dict:
    """Each series of a snapshot by its ring key: ("h", row), ("s", row),
    ("c", row) or ("g", row)."""
    out = {}
    for i, r in enumerate(snap.directory.histo.rows):
        out[r.key.key_string()] = ("h", i)
    for i, r in enumerate(snap.directory.sets.rows):
        out[r.key.key_string()] = ("s", i)
    for kind, pool in (("c", snap.scalars.counters),
                       ("g", snap.scalars.gauges)):
        for i, meta in enumerate(pool.meta[:pool.used]):
            out[meta[0].key_string()] = (kind, i)
    return out


def check_against_single(snap, ref, ref_index: dict, owner: str, ring,
                         what: str) -> int:
    """Every series of one global's snapshot sits on the global the ring
    names, and its row is bitwise the single global's (phase 10) row:
    every extracted histogram array, the set estimate, the scalar.
    Returns the global's histogram rows."""
    import numpy as np

    rows = {"h": [], "s": [], "c": [], "g": []}
    mine = series_index(snap)
    for key, (kind, i) in mine.items():
        if ring.get(key) != owner:
            raise AssertionError(f"{what}: {key!r} landed on {owner}, its "
                                 f"ring owner is {ring.get(key)}")
        ref_kind, j = ref_index[key]
        if ref_kind != kind:
            raise AssertionError(f"{what}: {key!r} is {kind} here, "
                                 f"{ref_kind} on the single global")
        rows[kind].append((i, j))

    def same(a, b, name):
        if a.dtype != b.dtype or a.shape != b.shape \
                or a.tobytes() != b.tobytes():
            raise AssertionError(f"{what}: {name} differs from the single "
                                 "global's rows")

    for kind, pairs in rows.items():
        if not pairs:
            continue
        mi, ri = (np.array(x, np.int64) for x in zip(*sorted(pairs)))
        if kind == "h":
            for f in PX_HISTO_FIELDS:
                a, b = getattr(snap, f), getattr(ref, f)
                if a is None or b is None:
                    if (a is None) != (b is None):
                        raise AssertionError(f"{what}: {f} missing")
                    continue
                same(a[mi], b[ri], f)
        elif kind == "s":
            same(snap.set_estimates[mi], ref.set_estimates[ri],
                 "set_estimates")
        else:
            pool = "counters" if kind == "c" else "gauges"
            same(getattr(snap.scalars, pool).values[mi],
                 getattr(ref.scalars, pool).values[ri], pool)
    return len(rows["h"])


def run_proxy_tier(keep: dict, n_proxies: int, ek, hll) -> dict:
    """Phase 12a (one proxy) or 12b (two proxies, the locals' SpreadForwarder
    over both): four port globals on the card with import servers and
    forward-statsd taps; the eight phase-10 snapshots forwarded in turn
    by port locals over gRPC streaming, each fully delivered before the
    next; then each global flushed and held against phase 10's single
    gRPC global."""
    import numpy as np
    import torch

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.distributed.ring import ConsistentRing

    arm = "12a" if n_proxies == 1 else "12b"
    t_arm = time.perf_counter()
    taps = [TcpTap() for _ in range(PX_GLOBALS)]
    gs = [build_server(load_config(data=gm_global_config(tap, True)),
                       device=DEVICE) for tap in taps]
    itaps = [ImportTap(g.import_server) for g in gs]
    dests = [f"127.0.0.1:{g.import_server.port}" for g in gs]
    proxies = [gm_proxy(dests) for _ in range(n_proxies)]
    paddrs = [f"127.0.0.1:{p.start_grpc()}" for p in proxies]
    ring = ConsistentRing(dests)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    forwards = []
    res: dict = {"proxies": n_proxies, "globals": PX_GLOBALS}
    try:
        expect = 0
        for host, snap in enumerate(keep["local_snaps"]):
            rec = ForwardRecorder()
            local = build_server(load_config(data=gm_local_config(
                ",".join(paddrs), True, host)), device=DEVICE)
            if n_proxies > 1:
                # a fleet's locals sit at different points of their
                # rotation; fresh ones all start at the same lane
                # (ROADMAP §3), so stand each at its host's turn
                local.forwarder._rr = host
            local.forwarder.stats = rec
            route0 = sum(p.route_s for p in proxies)
            handed0 = [dict(p.handed) for p in proxies]
            t0 = time.perf_counter()
            local.forwarder([snap])
            f = rec.forwards[-1]
            if "error" in f:
                raise AssertionError(f"phase {arm} local {host}: forward "
                                     f"error {f}")
            expect += f["metrics"]
            deadline = time.time() + 120
            while time.time() < deadline and (
                    sum(p.proxied_metrics for p in proxies) < expect
                    or sum(g.import_server.received_metrics
                           for g in gs) < expect):
                time.sleep(0.005)
            f["delivered_s"] = time.perf_counter() - t0
            got = [g.import_server.received_metrics for g in gs]
            if sum(p.proxied_metrics for p in proxies) != expect \
                    or sum(got) != expect \
                    or any(g.import_server.import_errors for g in gs):
                raise AssertionError(
                    f"phase {arm} local {host}: the globals took {got} of "
                    f"{expect} metrics")
            if n_proxies > 1:
                f["spread"] = {a: d["picks"] for a, d in local.forward_stats()[
                    "destinations"].items()}
            local.shutdown()
            f["route_s"] = sum(p.route_s for p in proxies) - route0
            f["handed"] = {}
            for p, before in zip(proxies, handed0):
                for d, (n, b) in p.handed.items():
                    n0, b0 = before.get(d, (0, 0))
                    fr, by = f["handed"].get(d, (0, 0))
                    f["handed"][d] = (fr + n - n0, by + b - b0)
            forwards.append(f)
        for p in proxies:
            st = p.forward_stats()
            if not p.conserved() or st["drops"] or st["spilled_metrics"]:
                raise AssertionError(f"phase {arm}: the proxy is not "
                                     f"conserved or dropped: {st['drops']}")
        if n_proxies > 1:
            used = [p.proxied_metrics for p in proxies]
            if not all(used):
                raise AssertionError(f"phase {arm}: a proxy took nothing: "
                                     f"{used}")
            res["proxied_by_proxy"] = used
        # cpu_seconds() reads each thread's /proc schedstat and gives 0.0
        # where the host has none: then the proxies' CPU is not measured
        res["proxy_cpu_s"] = ([p.cpu_seconds() for p in proxies]
                              if schedstat_readable() else None)
        res["locals_s"] = time.perf_counter() - t_arm
        ref = keep["snap"]
        ref_index = series_index(ref)
        per_global = []
        rows = 0
        lines = []
        for gi, (g, tap, itap) in enumerate(zip(gs, taps, itaps)):
            before = read_launches(ek, hll)
            t0 = time.perf_counter()
            snap, phases, merge = global_flush(g)
            flush_s = time.perf_counter() - t0
            after = read_launches(ek, hll)
            for name in ("flush_extract", "hll_estimate",
                         "tdigest_compress"):
                if after[name] <= before[name]:
                    raise AssertionError(f"phase {arm}: {name} was not "
                                         f"launched on global {gi}")
            rows += check_against_single(snap, ref, ref_index, dests[gi],
                                         ring, f"phase {arm} global {gi}")
            lines += tap.taken().split(b"\n")
            per_global.append({
                "received": g.import_server.received_metrics,
                "histo_rows": snap.directory.num_histo_rows,
                "import_s": itap.seconds["import_s"],
                "merge_at_swap_s": merge, "flush_s": flush_s,
                **{k: phases[k] for k in ("fold_s", "extract_s", "sets_s")
                   if k in phases}})
            if not np.isfinite(snap.quantile_values).all():
                raise AssertionError(f"phase {arm}: global {gi} has "
                                     "non-finite quantiles")
        if rows != GM_SERIES:
            raise AssertionError(f"phase {arm}: the globals hold {rows} "
                                 f"histogram rows, not {GM_SERIES}")
        if sorted(ln for ln in lines if ln) != sorted(
                ln for ln in keep["taken"].split(b"\n") if ln):
            raise AssertionError(f"phase {arm}: the four sinks' lines are "
                                 "not the single global's")
        res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        for p in proxies:
            p.stop()
        for g in gs:
            g.shutdown()
        for tap in taps:
            tap.close()
    res["forwards"] = forwards
    res["per_global"] = per_global
    res["wall_s"] = time.perf_counter() - t_arm
    for i, f in enumerate(forwards):
        log(f"[proxy {arm}] local {i}: {f['metrics']} metrics, "
            f"{f.get('bytes')} bytes, delivered in {f['delivered_s']:.4f} s"
            f", proxy route {f['route_s']:.4f} s; fragments, bytes by "
            "destination " + ", ".join(
                f"{d} {n} {b}" for d, (n, b) in sorted(f["handed"].items()))
            + (f"; spread picks {f['spread']}" if "spread" in f else ""))
    for gi, pg in enumerate(per_global):
        log(f"[proxy {arm}] global {gi}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in pg.items()))
    log(f"[proxy {arm}] {n_proxies} prox{'y' if n_proxies == 1 else 'ies'}"
        f" -> {PX_GLOBALS} globals: every series on its ring owner, every "
        f"row bitwise phase 10's single global, the sinks' lines its "
        f"lines; peak device memory {res['peak_device_bytes']} B, proxy "
        f"cpu_seconds {res['proxy_cpu_s'] or 'not measured (no schedstat)'}"
        f", wall {res['wall_s']:.1f} s")
    return res


def phase_proxy(keep: dict, ek, hll) -> dict:
    """Phase 12: the proxy tier on the card (12a one proxy, 12b two)."""
    return {"one_proxy": run_proxy_tier(keep, 1, ek, hll),
            "two_proxies": run_proxy_tier(keep, 2, ek, hll)}


# -- phase 11 -----------------------------------------------------------------


# 11a: bench.py's ssf_histo width (bench.py:443-535)
SSF_SPANS, SSF_SERVICES, SSF_PASSES, SSF_BURST = 50_000, 64, 5, 4_096
SSF_NOW = 1_700_000_000
# 11b: phase 4's interval as the samples of spans, SPAN_SAMPLES a span;
# the Python arm takes every SPAN_PY_CUT-th span (PERF.md section 4)
SPAN_SAMPLES, SPAN_PY_CUT = 16, 32
# 11b's server arm: the spans carrying the series lines (one sample a
# series) over the SSF sockets, and TLS_LINES DogStatsD lines (phase 4's
# scalars renamed) over mutual TLS
TLS_LINES = 19_000
SPAN_KEYS = {"indicator_span_timer_name": "indicator",
             "objective_span_timer_name": "objective",
             "ssf_span_uniqueness_rate": 1.0}


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """A length-delimited protobuf field."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def ssf_histo_payloads() -> list[bytes]:
    """bench.py's ssf_histo spans: 50,000 indicator spans over 64
    services, operation "op", durations gamma(2.0, 5e6) ns from
    default_rng(3); the start a fixed instant instead of the clock."""
    import numpy as np

    from veneur_tpu_torch.gen import ssf_pb2

    rng = np.random.default_rng(3)
    base = SSF_NOW * 10**9
    out = []
    for i in range(SSF_SPANS):
        pb = ssf_pb2.SSFSpan(
            trace_id=i + 1, id=i + 1, start_timestamp=base + i,
            end_timestamp=base + i + int(rng.gamma(2.0, 5e6)),
            service=f"svc{i % SSF_SERVICES}", name="op", indicator=True)
        out.append(pb.SerializeToString())
    return out


def span_server(data: dict, device: str):
    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server

    return build_server(load_config(data={
        "interval": "1h", "num_workers": 1, "percentiles": QS,
        "aggregates": ["min", "max", "count"], "hostname": "chip-smoke",
        **SPAN_KEYS, **data}), device=device)


def check_span_books(server, what: str, received: int) -> dict:
    """Span conservation, native spans counted: received == derived +
    dropped + pending; the spans received as expected; no parse error."""
    st = server.ingress_stats()["spans"]
    if st["received"] != st["derived"] + st["dropped"] + st["pending"] \
            or st["received"] != received or st["dropped"] \
            or server.parse_errors:
        raise AssertionError(f"{what}: span books {st} (expected "
                             f"{received} received), parse errors "
                             f"{server.parse_errors}")
    return st


def run_ssf_histo(payloads, native: bool, device: str):
    """The five passes through one server: the native SSF path in bursts
    of SSF_BURST or the Python path span by span (columnar pipeline),
    each pass flushed. The batch size is past a pass's spill, so nothing
    drains before the swap and both paths fold the same spill batch; no
    uniqueness sample is drawn (rate 0), so both derive the same."""
    server = span_server({"tpu_native_ingest": native,
                          "tpu_batch_size": 1 << 20,
                          "ssf_span_uniqueness_rate": 0.0}, device)
    snaps = capture_snapshots(server)
    outs, times = [], []
    try:
        if server._native_ssf != native:
            raise AssertionError(f"native SSF path {server._native_ssf}, "
                                 f"asked {native}")
        for p in range(SSF_PASSES):
            t0 = time.perf_counter()
            if native:
                for i in range(0, len(payloads), SSF_BURST):
                    server.handle_trace_packets_native(
                        payloads[i:i + SSF_BURST])
            else:
                for pkt in payloads:
                    server.handle_trace_packet(pkt)
            t1 = time.perf_counter()
            got = server.flush(now=SSF_NOW + p)
            t2 = time.perf_counter()
            outs.append(canonical(got))
            times.append({"ingest_s": t1 - t0,
                          "spans_per_s": len(payloads) / (t1 - t0),
                          "flush_s": t2 - t1, **server.last_flush_phases,
                          **server.workers[0].last_extract_phases})
        # the last flush's own span waits in the pipeline
        books = check_span_books(server, "phase 11a",
                                 SSF_PASSES * (len(payloads) + 1))
        if native and server._spans_native_total != SSF_PASSES * len(
                payloads):
            raise AssertionError(f"phase 11a: {server._spans_native_total}"
                                 " spans through the native path")
    finally:
        server.shutdown()
    return outs, snaps, times, books


def phase_ssf_histo() -> dict:
    """11a: the ssf_histo spans through the native SSF path and the
    columnar Python path, each on the card and on the CPU."""
    t0 = time.perf_counter()
    payloads = ssf_histo_payloads()
    build_s = time.perf_counter() - t0
    res, out = {}, {"build_s": build_s}
    for native in (True, False):
        arm = "native" if native else "python"
        for dev in (DEVICE, "cpu"):
            res[arm, dev] = run_ssf_histo(payloads, native, dev)
        (oc, sc, tc, bc), (oh, sh, th, _bh) = res[arm, DEVICE], res[arm, "cpu"]
        if oc != oh:
            raise AssertionError(f"phase 11a {arm}: card InterMetrics "
                                 "differ from the CPU's")
        for p, (a, b) in enumerate(zip(sc, sh)):
            compare_snapshots(a, b, f"phase 11a {arm} pass {p}, card "
                              "against CPU")
        out[arm] = {"card": tc, "cpu": th, "books": bc,
                    "metrics": len(oc[-1])}
        for where, t in (("card", tc), ("cpu", th)):
            log(f"[spans 11a] {arm} {where} ({CARD}): pass 1 of "
                f"{SSF_PASSES}: " +
                ", ".join(f"{k} {v:.4f}" for k, v in t[0].items()))
            log(f"[spans 11a] {arm} {where} ({CARD}): last pass: " +
                ", ".join(f"{k} {v:.4f}" for k, v in t[-1].items()))
    # native and Python derive alike where neither draws a sample
    if res["native", DEVICE][0] != res["python", DEVICE][0]:
        raise AssertionError("phase 11a: native SSF path and Python path "
                             "derive different InterMetrics")
    n = out["native"]["metrics"]
    log(f"[spans 11a] {SSF_SPANS} spans x {SSF_PASSES} passes ({n} "
        f"InterMetrics a flush; payloads built in {build_s:.2f} s): card "
        "bitwise the CPU on both paths, native == Python")
    return out


def _sample_heads(metric: int, names, tags) -> list[bytes]:
    """The bytes of each series' SSF sample up to its value: the metric
    enum, the name and the tags (a map entry each). ``tags`` holds each
    series' "k:v" strings."""
    heads = []
    for name, tl in zip(names, tags):
        b = (b"\x08" + _varint(metric) if metric else b"") + _ld(
            2, name.encode())
        for t in tl:
            k, _, v = t.partition(":")
            b += _ld(8, _ld(1, k.encode()) + _ld(2, v.encode()))
        heads.append(b)
    return heads


def _wrap(body_head: bytes, value_len: int) -> bytes:
    """Span field 10 around a sample of ``body_head`` plus ``value_len``
    more bytes."""
    return _varint(10 << 3 | 2) + _varint(len(body_head) + value_len) + \
        body_head


def mixed_span_samples(plan, parse) -> list[bytes]:
    """Phase 4's interval as encoded SSF samples, in its order: each
    series, scalar and set line; then the bulk histogram samples (@0.5
    where the weight is 2); then the bulk set members "m%09d" % id."""
    import numpy as np

    series, scalars, rows, vals, wts, (set_lines, srows, _i, _r, ids) = plan
    kinds = {"counter": 0, "gauge": 1, "histogram": 2, "timer": 2,
             "set": 3}
    rate_b = {1.0: b"\x3d" + struct.pack("<f", 1.0),
              0.5: b"\x3d" + struct.pack("<f", 0.5)}
    out = []
    series_heads = []
    for line in series + scalars + set_lines:
        m = parse(line)
        head = _sample_heads(kinds[m.key.type], [m.name], [m.tags])[0]
        if m.key.type == "histogram" or m.key.type == "timer":
            series_heads.append(head)
        if m.key.type == "set":
            val = _ld(5, m.value.encode())
        else:
            val = b"\x1d" + struct.pack("<f", float(m.value))
        out.append(_wrap(head, len(val) + 5) + val + rate_b[m.sample_rate])
    # bulk histogram samples: head, the f32 value, the rate
    wrapped = [_wrap(h + b"\x1d", 4 + 5) for h in series_heads]
    vb = np.ascontiguousarray(vals, "<f4").tobytes()
    rb = (rate_b[1.0], rate_b[0.5])
    half = (wts == 2.0).tolist()
    out.extend(wrapped[r] + vb[4 * k:4 * k + 4] + rb[h]
               for k, (r, h) in enumerate(zip(rows.tolist(), half)))
    # bulk set members: the set series' heads, the member as the message
    s = np.arange(N_SETS)
    set_heads = _sample_heads(3, [f"users.{i}" for i in s],
                              [[f"shard:{i % 16}"] for i in s])
    wrapped = [_wrap(h + b"\x2a\x0a", 10 + 5) for h in set_heads]
    one = rate_b[1.0]
    out.extend(wrapped[r] + b"m%09d" % i + one
               for r, i in zip(srows.tolist(), ids.tolist()))
    return out


def mixed_span_payloads(samples: list[bytes]) -> list[bytes]:
    """SPAN_SAMPLES samples a span: root spans over 64 services,
    operation "op", 1 us each."""
    base = SSF_NOW * 10**9
    out = []
    for j, i in enumerate(range(0, len(samples), SPAN_SAMPLES)):
        head = (b"\x10" + _varint(j + 1) + b"\x18" + _varint(j + 1)
                + b"\x28" + _varint(base + j) + b"\x30"
                + _varint(base + j + 1000)
                + _ld(8, b"svc%d" % (j % SSF_SERVICES)) + _ld(13, b"op"))
        out.append(head + b"".join(samples[i:i + SPAN_SAMPLES]))
    return out


MIXED_KEYS = {"count_unique_timeseries": True, "micro_fold": False}


def run_mixed_spans(payloads, native: bool, device: str) -> tuple:
    """One interval of span payloads through a server, one flush; returns
    (snapshot, InterMetrics, seconds, span books)."""
    server = span_server({"tpu_native_ingest": native, **MIXED_KEYS},
                         device)
    snaps = capture_snapshots(server)
    try:
        t0 = time.perf_counter()
        if native:
            for i in range(0, len(payloads), SSF_BURST):
                server.handle_trace_packets_native(payloads[i:i + SSF_BURST])
        else:
            for pkt in payloads:
                server.handle_trace_packet(pkt)
        t1 = time.perf_counter()
        got = canonical(server.flush(now=SSF_NOW))
        t2 = time.perf_counter()
        books = check_span_books(server, f"phase 11b ({device})",
                                 len(payloads) + 1)
        w = server.workers[0]
        if w.overload_dropped_total:
            raise AssertionError(f"phase 11b: {w.overload_dropped_total} "
                                 "samples shed")
        return snaps[0], got, {
            "ingest_s": t1 - t0, "spans_per_s": len(payloads) / (t1 - t0),
            "flush_s": t2 - t1, **server.last_flush_phases,
            **w.last_extract_phases}, books
    finally:
        server.shutdown()


def make_pki(tmp: Path) -> dict:
    """A CA, a server certificate for 127.0.0.1 and a client certificate,
    made by openssl; raises if openssl fails."""
    import subprocess

    ec = ["-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:prime256v1",
          "-nodes"]

    def run(*args):
        subprocess.run(["openssl", *args], cwd=tmp, check=True,
                       capture_output=True, timeout=60)

    run("req", "-x509", *ec, "-keyout", "ca.key", "-out", "ca.pem", "-days",
        "2", "-subj", "/CN=chip-smoke-ca")
    (tmp / "san.ext").write_text("subjectAltName=IP:127.0.0.1\n")
    for who in ("server", "client"):
        run("req", *ec, "-keyout", f"{who}.key", "-out", f"{who}.csr",
            "-subj", f"/CN={who}")
        run("x509", "-req", "-in", f"{who}.csr", "-CA", "ca.pem", "-CAkey",
            "ca.key", "-CAcreateserial", "-out", f"{who}.pem", "-days", "2",
            "-extfile", "san.ext")
    return {k: str(tmp / v) for k, v in (
        ("ca", "ca.pem"), ("cert", "server.pem"), ("key", "server.key"),
        ("client_cert", "client.pem"), ("client_key", "client.key"))}


def wait_for(pred, what: str, timeout: float = 120.0) -> None:
    deadline = time.time() + timeout
    while not pred():
        if time.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


def phase_span_server(payloads, tls_lines) -> dict:
    """11b's server arm: a factory-built server on the card, native
    ingest and readers on, every listener of the span slice: the spans
    in turn over UDP (the C++ SSF reader), a unix stream socket and a
    unixgram socket, then DogStatsD lines over mutual TLS, each sender
    paced and waited on until the server counted all it sent. One flush;
    its snapshot bitwise a CPU server's fed the same in the same order
    through handle_trace_packet, handle_ssf and handle_metric_packet."""
    import shutil
    import socket
    import ssl
    import tempfile

    from veneur_tpu_torch.protocol import ssf_wire

    tmp = Path(tempfile.mkdtemp(prefix="vsmoke"))
    try:
        pki = make_pki(tmp)
        n = len(payloads)
        udp, unix, ugram = (payloads[:n // 3], payloads[n // 3:2 * n // 3],
                            payloads[2 * n // 3:])
        data = {"tpu_native_ingest": True, "tpu_native_readers": True,
                "count_unique_timeseries": True,
                "ssf_listen_addresses": [
                    "udp://127.0.0.1:0", f"unix://{tmp}/ssf.sock",
                    f"unixgram://{tmp}/ssfg.sock"],
                "statsd_listen_addresses": ["tcp://127.0.0.1:0"],
                "tls_key": pki["key"], "tls_certificate": pki["cert"],
                "tls_authority_certificate": pki["ca"]}
        server = span_server(data, DEVICE)
        snaps = capture_snapshots(server)
        t = {}
        try:
            ports = server.start()
            ctx = server.workers[0]._native
            if not server._native_ssf or len(server._native_ssf_readers) \
                    != 1:
                raise AssertionError("the C++ SSF reader is not running")
            t0 = time.perf_counter()
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                for i, pkt in enumerate(udp):
                    s.sendto(pkt, ("127.0.0.1", ports["udp://127.0.0.1:0"]))
                    if i % 16 == 15:
                        time.sleep(0.002)
            wait_for(lambda: ctx.ssf_spans == len(udp), "the UDP spans")
            t["udp_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(str(tmp / "ssf.sock"))
                s.sendall(b"".join(struct.pack(">BI", 0, len(p)) + p
                                   for p in unix))
            wait_for(lambda: server.ssf_spans_received_total == len(unix),
                     "the unix stream spans")
            t["unix_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            with socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM) as s:
                for i, pkt in enumerate(ugram):
                    s.sendto(pkt, str(tmp / "ssfg.sock"))
                    if i % 16 == 15:
                        time.sleep(0.002)
            wait_for(lambda: ctx.ssf_spans == len(udp) + len(ugram),
                     "the unixgram spans")
            t["unixgram_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            before = server.workers[0].processed
            tls = ssl.create_default_context(cafile=pki["ca"])
            tls.load_cert_chain(pki["client_cert"], pki["client_key"])
            raw = socket.create_connection(
                ("127.0.0.1", ports["tcp://127.0.0.1:0"]), timeout=60)
            with tls.wrap_socket(raw, server_hostname="127.0.0.1") as c:
                c.sendall(b"\n".join(tls_lines) + b"\n")
            wait_for(lambda: server.workers[0].processed - before
                     == len(tls_lines), "the TLS lines")
            t["tls_s"] = time.perf_counter() - t0
            reader_spans = ctx.ssf_spans
            t0 = time.perf_counter()
            got = canonical(server.flush(now=SSF_NOW))
            t["flush_s"] = time.perf_counter() - t0
            books = check_span_books(server, "phase 11b server", n + 1)
            tcp = server.stats.totals()
        finally:
            server.shutdown()
        ref = span_server({"tpu_native_ingest": True,
                           "count_unique_timeseries": True}, "cpu")
        ref_snaps = capture_snapshots(ref)
        try:
            for pkt in udp:
                ref.handle_trace_packet(pkt)
            for pkt in unix:
                ref.handle_ssf(ssf_wire.parse_ssf(pkt))
            for pkt in ugram:
                ref.handle_trace_packet(pkt)
            for line in tls_lines:
                ref.handle_metric_packet(line)
            want = canonical(ref.flush(now=SSF_NOW))
        finally:
            ref.shutdown()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    compare_snapshots(snaps[0], ref_snaps[0],
                      "phase 11b server, card against CPU")
    if got != want:
        raise AssertionError("phase 11b server: InterMetrics differ from "
                             "the CPU server's")
    if reader_spans < 1 or tcp.get(("tcp.connects", ())) != 1:
        raise AssertionError(f"phase 11b server: C++ SSF reader spans "
                             f"{reader_spans}, TLS connects {tcp}")
    log(f"[spans 11b] server: {len(udp)} spans over UDP (C++ SSF reader: "
        f"{reader_spans} native, with unixgram), {len(unix)} over a unix "
        f"stream, {len(ugram)} over unixgram, {len(tls_lines)} DogStatsD "
        "lines over mutual TLS: the card's snapshot bitwise a CPU server's "
        f"fed in the same order; ({CARD}) " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()))
    return {"seconds": t, "reader_spans": reader_spans, "books": books,
            "metrics": len(got)}


def phase_mixed_spans(parse) -> dict:
    """11b: phase 4's mixed interval as the samples of spans, through the
    native SSF path at full width (spill folds, K1 at 131,072 rows, K4
    and K5 through the staged store's dense tier) and the Python path at
    a cut, each on the card and the CPU; then the server arm."""
    t0 = time.perf_counter()
    plan = interval_plan(seed=5)
    samples = mixed_span_samples(plan, parse)
    payloads = mixed_span_payloads(samples)
    # the TLS lines are series of their own: a gauge written over two
    # paths would keep whichever write the readers' timing put last
    tls_lines = [b"tls." + line for line in plan[1][:TLS_LINES]]
    n_lines = len(plan[0]) + len(plan[1]) + len(plan[5][0])
    del plan, samples
    build_s = time.perf_counter() - t0
    out = {"build_s": build_s, "spans": len(payloads)}
    res = {}
    # the native arm's CPU twin is cut for the run's time (PERF.md
    # section 4): the native SSF path's card-against-CPU snapshots are
    # 11a's; the Python arm keeps its twin
    for arm, pay in (("native", payloads),
                     ("python", payloads[::SPAN_PY_CUT])):
        devs = (DEVICE,) if arm == "native" else (DEVICE, "cpu")
        for dev in devs:
            res[arm, dev] = run_mixed_spans(pay, arm == "native", dev)
        sc, oc, tc, bc = res[arm, DEVICE]
        th = None
        if arm == "python":
            sh, oh, th, _bh = res[arm, "cpu"]
            compare_snapshots(sc, sh, f"phase 11b {arm}, card against CPU")
            if oc != oh:
                raise AssertionError(f"phase 11b {arm}: card InterMetrics "
                                     "differ from the CPU's")
            del res[arm, "cpu"]
        if arm == "native":
            users = [i for i, r in enumerate(sc.directory.sets.rows)
                     if r.key.name.startswith("users.")]
            check_set_estimates(sc.set_estimates[users])
        out[arm] = {"card": tc, "cpu": th, "books": bc, "spans": len(pay),
                    "metrics": len(oc), "histo_rows":
                    sc.directory.num_histo_rows}
        for where, t in (("card", tc), ("cpu", th)):
            if t is not None:
                log(f"[spans 11b] {arm} {where} ({CARD}): " + ", ".join(
                    f"{k} {v:.4f}" for k, v in t.items()))
    log(f"[spans 11b] {len(payloads)} spans of {SPAN_SAMPLES} samples "
        f"(built in {build_s:.2f} s): native {out['native']['histo_rows']} "
        f"histogram rows, {out['native']['metrics']} InterMetrics; Python "
        f"arm one span in {SPAN_PY_CUT}, card bitwise the CPU")
    out["server"] = phase_span_server(payloads[:(n_lines + SPAN_SAMPLES - 1)
                                               // SPAN_SAMPLES], tls_lines)
    return out


def phase_spans(parse) -> dict:
    """Phase 11: 11a and 11b."""
    return {"ssf_histo": phase_ssf_histo(),
            "mixed": phase_mixed_spans(parse)}


# -- phase 13 -----------------------------------------------------------------

QUERY_BUDGETS = {"t7": 5_000}
QUERY_TENANTS = 8
QUERY_TOPK = 8
QUERY_REPS = 200
QUERY_ROWS = 10_000
QUERY_NOW = 1_700_000_000
QUERY_QS32 = [round(0.01 + 0.98 * k / 31, 6) for k in range(32)]


def tenant_plan(plan):
    """Phase 4's interval with every series line tagged tenant:t{i % 8},
    i its place among the interval's series (histograms, hot, counters,
    gauges, sets); the bulk samples as they are."""
    series, scalars, rows, vals, wts, (set_lines, srows, sidx, srank,
                                       ids) = plan
    tagged = []
    for i, line in enumerate(series + scalars + set_lines):
        sep = b"," if b"|#" in line else b"|#"
        tagged.append(line + sep + f"tenant:t{i % QUERY_TENANTS}".encode())
    a, b = len(series), len(series) + len(scalars)
    return (tagged[:a], tagged[a:b], rows, vals, wts,
            (tagged[b:], srows, sidx, srank, ids))


def query_worker(tw, engine, device, native: bool = False):
    """A phase 4 worker with the budgets, a tenant sketch on its device
    and the engine's publisher, as the server wires them."""
    import functools

    from veneur_tpu_torch.core.config import Config
    from veneur_tpu_torch.core.tenancy import TenantLedger, TenantSketch

    cfg = Config()
    w = tw.DeviceWorker(**INTERVAL_KW, device=device)
    if native and not w.attach_native():
        raise AssertionError("attach_native() failed")
    w.tenancy = TenantLedger(budgets=QUERY_BUDGETS)
    w.tenant_sketch = TenantSketch(
        depth=cfg.tenant_sketch_depth, width=cfg.tenant_sketch_width,
        topk=QUERY_TOPK, device=device)
    w.query_publisher = functools.partial(engine.stage, 0)
    return w


def run_tenant_interval(worker, tplan, parse, qs):
    """The tagged interval through the Python path: the series lines
    through process_metric (the ledger refuses t7's series past its
    budget: no row), then the bulk samples of the admitted series staged
    at the rows the worker gave them, the set members likewise, and the
    flush. Returns (snapshot, seconds by step)."""
    import numpy as np

    series, scalars, rows, vals, wts, (set_lines, srows, sidx, srank,
                                       _ids) = tplan
    t0 = time.perf_counter()
    for line in series + scalars + set_lines:
        worker.process_metric(parse(line))
    worker._flush_pending_histos()
    worker._flush_pending_sets()
    worker._sync()
    t1 = time.perf_counter()
    hrow = {m.key.name: r for r, m in
            enumerate(worker.directory.histo.rows)}
    hmap = np.array([hrow.get(f"svc.lat.{i}", -1) for i in range(N_HIST)]
                    + [hrow.get(f"hot.{i}", -1) for i in range(N_HOT)],
                    dtype=np.int64)
    srow = {m.key.name: r for r, m in enumerate(worker.directory.sets.rows)}
    smap = np.array([srow.get(f"users.{i}", -1) for i in range(N_SETS)],
                    dtype=np.int64)
    mrows = hmap[rows]
    keep = mrows >= 0
    mrows, mvals, mwts = (mrows[keep].astype(np.int32), vals[keep],
                          wts[keep])
    b = worker.batch_size
    for i in range(0, len(mrows), b):
        worker._device_histo_step(mrows[i:i + b], mvals[i:i + b],
                                  mwts[i:i + b])
    worker._sync()
    t2 = time.perf_counter()
    ms = smap[srows]
    skeep = ms >= 0
    set_s = insert_sets(worker, ms[skeep].astype(np.int32), sidx[skeep],
                        srank[skeep])
    t3 = time.perf_counter()
    snap = worker.flush(qs)
    t4 = time.perf_counter()
    return snap, {"process_metric_s": t1 - t0, "staging_s": t2 - t1,
                  "set_insert_s": set_s, "flush_s": t4 - t3,
                  "staged_samples": int(keep.sum()),
                  "set_samples": int(skeep.sum()),
                  **worker.last_extract_phases}


def query_requests(snap) -> list:
    """Every op of the query surface over a committed epoch: the device
    query at the flush quantiles and the cardinalities over every row,
    the other tables over their first QUERY_ROWS rows."""
    every = 10 ** 7
    keys = [m.key.key_string() for m in snap.directory.histo.rows
            if m.tenant == "t3"][:1000]
    return ([{"op": "quantiles", "limit": QUERY_ROWS},
             {"op": "quantiles", "force_device": True, "limit": every},
             {"op": "quantiles", "qs": QUERY_QS32, "force_device": True,
              "limit": QUERY_ROWS},
             {"op": "quantiles", "qs": [0.25, 0.75], "name": "svc.lat.3"},
             {"op": "scalars", "limit": QUERY_ROWS},
             {"op": "cardinality", "limit": every}]
            + [{"op": "topk", "tenant": f"t{k}"}
               for k in range(QUERY_TENANTS)]
            + [{"op": "tenant_totals"},
               {"op": "cms", "keys": keys, "tenant": "t3"},
               {"op": "epoch"}])


def answers(engine, reqs) -> list:
    return [json.dumps(engine.dispatch(dict(r))).encode() for r in reqs]


def check_answers(got: list, reqs, what: str) -> None:
    for g, q in zip(got, reqs):
        if b'"error"' in g[:20]:
            raise AssertionError(f"{what}: {q['op']} answered an error")


def refused_absent(snap, metrics, what: str) -> int:
    """No sink line carries a refused series; returns how many refused
    series the snapshot kept rows for."""
    refused = {(r.key.name, ",".join(r.tags))
               for pool in (snap.directory.histo, snap.directory.sets)
               for r in pool.rows if not r.admitted}
    for pool in (snap.scalars.counters, snap.scalars.gauges):
        refused |= {(m[0].name, ",".join(m[1]))
                    for m, code in zip(pool.meta, pool.admit_codes)
                    if not code}
    for m in metrics:
        tags = ",".join(m.tags)
        if (m.name, tags) in refused or \
                (m.name.rsplit(".", 1)[0], tags) in refused:
            raise AssertionError(f"{what}: refused series {m.name} "
                                 f"reached a sink line")
    return len(refused)


def latency_ms(fn, reps: int = QUERY_REPS) -> dict:
    out = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        out.append((time.perf_counter() - t0) * 1e3)
    out.sort()
    return {"p50_ms": out[len(out) // 2],
            "p99_ms": out[min(len(out) - 1, int(0.99 * len(out)))]}


def phase_query_worker(tw, parse, qs, aggs, ek) -> dict:
    """Phase 13a (see the module docstring)."""
    import threading
    import urllib.request

    import torch

    from veneur_tpu_torch.core.flusher import (generate_columnar,
                                               generate_inter_metrics)
    from veneur_tpu_torch.query import QueryEngine
    from veneur_tpu_torch.query.http import make_http_server
    from veneur_tpu_torch.sinks.prometheus import PrometheusExpositionSink

    out: dict = {}
    tplan = tenant_plan(interval_plan(seed=5))
    series_lines = tplan[0] + tplan[1] + tplan[5][0]
    n_series = len(series_lines)
    per_tenant = n_series // QUERY_TENANTS

    def engine():
        return QueryEngine(QS, aggs, is_local=True, topk=QUERY_TOPK)

    # the card arm; the fields the evaluator closes over, kept for K1's
    # timing
    reset_peak()
    eng_g = engine()
    wg = query_worker(tw, eng_g, DEVICE)
    held = {}
    make_eval = wg._make_query_eval

    def capture(fields):
        held["fields"] = fields
        return make_eval(fields)

    wg._make_query_eval = capture
    snap_g, t_g = run_tenant_interval(wg, tplan, parse, qs)
    eng_g.commit(QUERY_NOW)
    check_guard_clean(wg, snap_g, "phase 13, card")
    reqs = query_requests(snap_g)
    t0 = time.perf_counter()
    got = answers(eng_g, reqs)
    t_g["answers_s"] = time.perf_counter() - t0
    # (the CPU twin is cut for the run's time: tests/test_torch_cuda.py
    # holds the query path's responses to the CPU worker's)
    check_answers(got, reqs, "phase 13a")
    # the query at the flush quantiles over every row is the flush's
    # readback, bitwise
    dev = json.loads(got[1])["results"]
    n = snap_g.directory.num_histo_rows
    qv = torch.tensor([r["values"] for r in dev], dtype=torch.float32)
    same, err = probe.bitwise_equal(qv, torch.from_numpy(
        snap_g.quantile_values))
    if len(dev) != n or not same:
        raise AssertionError(f"phase 13a: the device query at the flush "
                             f"quantiles is not the flush's readback "
                             f"({len(dev)} of {n} rows, max abs err {err})")
    p32 = json.loads(got[2])["results"]
    if len(p32) != min(n, QUERY_ROWS) or len(p32[0]["values"]) != 32:
        raise AssertionError("phase 13a: the 32-quantile request")
    # the ledger and the tallies
    led = wg.tenancy
    live, rejected = led.live_counts(), led.series_rejected_counts()
    want_live = {f"t{k}": per_tenant for k in range(QUERY_TENANTS)}
    want_live["t7"] = QUERY_BUDGETS["t7"]
    if live != want_live or rejected != {
            "t7": per_tenant - QUERY_BUDGETS["t7"]}:
        raise AssertionError(f"phase 13a: ledger live {live}, refused "
                             f"{rejected}")
    life = wg.tenant_lifetime()
    for t, acc in life["accepted"].items():
        if acc != life["kept"].get(t, 0) + life["rejected"].get(t, 0) \
                + life["dropped"].get(t, 0):
            raise AssertionError(f"phase 13a: tallies of {t} do not "
                                 f"conserve: {life}")
    # /metrics on the HTTP front: the exposition sink's body
    posted = []
    sink = PrometheusExpositionSink("http://127.0.0.1:9/unused")
    sink._post = lambda body, count: posted.append(body)
    sink.flush_columnar(generate_columnar(snap_g, True, QS, aggs,
                                          now=QUERY_NOW))
    hsrv, hport = make_http_server(eng_g, "127.0.0.1:0")
    url = f"http://127.0.0.1:{hport}"
    try:
        with urllib.request.urlopen(url + "/metrics") as resp:
            body = resp.read()
        if body != posted[0] or body != eng_g.render_exposition()[0]:
            raise AssertionError("phase 13a: /metrics is not the "
                                 "exposition sink's body")
        out["metrics_bytes"] = len(body)
        # latencies on the card arm (K1 counted from here for its ms)
        rot = [0.1 + 0.8 * (i % 97) / 97.0 for i in range(97)]
        k1_before = ek.flush_extract.launches
        out["latency"] = {
            "quantiles_host": latency_ms(lambda i: eng_g.dispatch(
                {"op": "quantiles", "name": f"svc.lat.{i % 997}"})),
            "quantiles_device": latency_ms(lambda i: eng_g.dispatch(
                {"op": "quantiles", "qs": [rot[i % 97]],
                 "name": "svc.lat.7", "force_device": True})),
            "scalars": latency_ms(lambda i: eng_g.dispatch(
                {"op": "scalars", "name": f"svc.lat.{i % 997}"})),
            "metrics": latency_ms(lambda i: urllib.request.urlopen(
                url + "/metrics").read())}
        out["device_query_launches"] = ek.flush_extract.launches - k1_before
    finally:
        hsrv.shutdown()
        hsrv.server_close()
    # K1 timed over the view's fields: these launches are no query's, so
    # the counts are put back
    fields = held["fields"]
    out["k1_rows"] = int(fields[0].shape[0])
    counted = (ek.flush_extract.launches, dict(ek.variant_launches))
    for p, qv_ in (("p4", [0.25, 0.5, 0.75, 0.99]), ("p32", QUERY_QS32)):
        q = torch.tensor(qv_, dtype=torch.float32, device=fields[0].device)
        out[f"k1_ms_{p}"] = probe.cuda_ms(
            lambda: ek.flush_extract(*fields, q), 21,
            spin_cycles=2_000_000) if DEVICE == "cuda" else 0.0
    ek.flush_extract.launches = counted[0]
    ek.variant_launches.update(counted[1])
    out["peak_device_bytes_view_held"] = peak_bytes()
    # the native arm: the tagged series lines as datagrams, on the card
    # (its CPU twin is cut for the run's time, PERF.md section 4: the
    # native path's card-against-CPU snapshots are phase 4c's)
    grams = [b"\n".join(series_lines[i:i + 100])
             for i in range(0, n_series, 100)]
    eng_n = engine()
    wn = query_worker(tw, eng_n, DEVICE, native=True)
    t0 = time.perf_counter()
    for d in grams:
        wn.ingest_datagram(d)
    sn = wn.flush(qs)
    eng_n.commit(QUERY_NOW)
    t_n = time.perf_counter() - t0
    check_guard_clean(wn, sn, "phase 13 native, card")
    if wn.tenancy.live_counts() != want_live or \
            wn.tenancy.series_rejected_counts() != rejected:
        raise AssertionError("phase 13a native: the ledger's counts differ "
                             "from the Python path's")
    kept_rows = refused_absent(sn, generate_inter_metrics(
        sn, True, QS, aggs, now=QUERY_NOW), "phase 13a native")
    if kept_rows != rejected["t7"]:
        raise AssertionError(f"phase 13a native: {kept_rows} refused rows "
                             f"kept, the ledger refused {rejected['t7']}")
    # the Python path refuses before a row exists
    t7_rows = sum(m.tenant == "t7" for pool in (
        snap_g.directory.histo, snap_g.directory.sets) for m in pool.rows)
    if t7_rows > QUERY_BUDGETS["t7"] or snap_g.directory.histo.rejected_rows:
        raise AssertionError(f"phase 13a: {t7_rows} rows of t7")
    del wn, sn, eng_n
    # the next interval, with two query threads reading throughout: the
    # view's sketch pool stays as captured, and every response is one
    # committed epoch's
    view = eng_g.epoch().views[0]
    pool_ref = view.sketch.pool
    pool_before = pool_ref.clone()
    treqs = [{"op": "scalars", "name": "svc.lat.7"},
             {"op": "quantiles", "name": "svc.lat.7"},
             {"op": "tenant_totals"}, {"op": "cardinality",
                                       "name": "users.2"},
             {"op": "topk", "tenant": "t7"}]
    by_epoch = {1: answers(eng_g, treqs)}
    seen: list = []
    stop = threading.Event()

    def reader(k):
        i = k
        while not stop.is_set():
            j = i % len(treqs)
            b = json.dumps(eng_g.dispatch(dict(treqs[j]))).encode()
            seen.append((json.loads(b)["epoch"], j, b))
            i += 1
            time.sleep(0.005)  # leave the ingest thread the interpreter

    threads = [threading.Thread(target=reader, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    try:
        # the next interval: every seventh series line (every tenant)
        for line in series_lines[::7]:
            wg.process_metric(parse(line))
        wg.flush(qs)
        eng_g.commit(QUERY_NOW + 10)
        t_next = time.perf_counter() - t0
        time.sleep(0.2)
    finally:
        stop.set()
        for t in threads:
            t.join()
    by_epoch[2] = answers(eng_g, treqs)
    epochs = sorted({e for e, _j, _b in seen})
    for e, j, b in seen:
        if b != by_epoch[e][j]:
            raise AssertionError(f"phase 13a: a response of epoch {e} is "
                                 f"not that epoch's")
    if epochs != [1, 2]:
        raise AssertionError(f"phase 13a: the readers saw epochs {epochs}")
    if not torch.equal(pool_ref, pool_before) or \
            wg.tenant_sketch.pool is pool_ref:
        raise AssertionError("phase 13a: the captured sketch pool changed "
                             "with the next fold")
    out.update({
        "card": t_g, "series": n_series, "histo_rows": n,
        "ledger_live": live, "ledger_refused": rejected,
        "sketch_s": t_g.get("sketch_s"), "native_s": {"card": t_n},
        "native_refused_rows": kept_rows, "next_interval_s": t_next,
        "reader_responses": len(seen), "requests": len(reqs)})
    log(f"[query] 13a: {n_series} series in {QUERY_TENANTS} tenants, t7 "
        f"budget {QUERY_BUDGETS['t7']}: ledger live {live}, refused "
        f"{rejected}; {n} histogram rows, {len(reqs)} requests (answers "
        f"{t_g['answers_s']:.2f} s); the "
        f"device query at the flush quantiles bitwise the readback; "
        f"/metrics {out['metrics_bytes']} B = the exposition sink's body; "
        f"native arm: {kept_rows} refused rows kept, none in the sink "
        f"lines; {len(seen)} reader responses over epochs {epochs}, each "
        f"its epoch's; the captured sketch pool unchanged")
    log("[query] 13a latency (ms): " + ", ".join(
        f"{k} p50 {v['p50_ms']:.3f} p99 {v['p99_ms']:.3f}"
        for k, v in out["latency"].items()))
    log(f"[query] 13a: K1 over the view's {out['k1_rows']} rows "
        f"{out['k1_ms_p4']:.4f} ms at P = 4, {out['k1_ms_p32']:.4f} ms at "
        f"P = 32; the sketch fold {t_g.get('sketch_s', 0.0):.4f} s; peak "
        f"device memory with the view held "
        f"{out['peak_device_bytes_view_held']} B; card: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t_g.items()))
    return out


def tenant_server_datagrams(seed: int) -> list[bytes]:
    """Phase 5's traffic (no spill) with each line's series in tenant
    t{k % 8} (the service check and the event as they are)."""
    out = []
    for d in server_datagrams(seed=seed, spill=False):
        if not d.startswith(b"api."):
            out.append(d)
            continue
        lines = []
        for k, line in enumerate(d.split(b"\n")):
            sep = b"," if b"|#" in line else b"|#"
            lines.append(line + sep + f"tenant:t{(k + len(line)) % 8}"
                         .encode())
        out.append(b"\n".join(lines))
    return out


def phase_query_server(ek) -> dict:
    """Phase 13b (see the module docstring)."""
    import socket
    import urllib.request

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.query.service import QueryClient
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink
    from veneur_tpu_torch.sinks.exposition import render_columnar

    data = {**server_config(native=False, spill=False),
            "tenant_budgets": QUERY_BUDGETS, "tenant_topk": QUERY_TOPK,
            "ssf_span_uniqueness_rate": 0.0,
            "query_listen_addrs": ["http://127.0.0.1:0",
                                   "grpc://127.0.0.1:0"]}
    grams = tenant_server_datagrams(seed=9)
    reqs = [{"op": "quantiles"}, {"op": "scalars"}, {"op": "cardinality"},
            {"op": "quantiles", "qs": [0.1, 0.42], "force_device": True},
            {"op": "topk", "tenant": "t3"}, {"op": "tenant_totals"},
            {"op": "epoch"}]
    sink = ChannelMetricSink()
    server = build_server(load_config(data=data), extra_metric_sinks=[sink],
                          device=DEVICE)
    ports = server.start()
    before = ek.flush_extract.launches
    try:
        port = ports["udp://127.0.0.1:0"]
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for d in grams:
                s.sendto(d, ("127.0.0.1", port))
                time.sleep(0.0005)
        deadline = time.time() + 60
        while server.packets_received < len(grams) \
                and time.time() < deadline:
            time.sleep(0.05)
        if server.packets_received != len(grams):
            raise AssertionError(f"phase 13b: received "
                                 f"{server.packets_received} of "
                                 f"{len(grams)} datagrams")
        batch = server.flush(now=QUERY_NOW)
        delivered = []
        while not sink.queue.empty():
            delivered.extend(sink.queue.get_nowait())
        http = f"http://127.0.0.1:{ports['http://127.0.0.1:0']}"
        client = QueryClient(f"127.0.0.1:{ports['grpc://127.0.0.1:0']}")
        try:
            via_grpc = [client.query(r) for r in reqs]
        finally:
            client.close()
        via_http = []
        for r in reqs:
            post = urllib.request.Request(http + "/query",
                                          data=json.dumps(r).encode())
            with urllib.request.urlopen(post) as resp:
                via_http.append(json.load(resp))
        with urllib.request.urlopen(http + "/metrics") as resp:
            metrics_body = resp.read()
        launched = ek.flush_extract.launches - before
        server.flush(now=QUERY_NOW + 10)  # reports the queries served
    finally:
        server.shutdown()
    if via_grpc != via_http:
        raise AssertionError("phase 13b: the two fronts answer differently")
    if metrics_body != render_columnar(batch, sink_name=None)[0]:
        raise AssertionError("phase 13b: /metrics is not the flush batch's "
                             "exposition")
    # the fronts' quantiles and scalars are what the sink got
    sunk = {(m.name, tuple(sorted(m.tags))): m.value for m in delivered}
    checked = 0
    for res in via_grpc[0]["results"]:
        tags = tuple(sorted(res["tags"]))
        for q, v in zip(res["qs"], res["values"]):
            name = f"{res['name']}.{int(round(q * 100))}percentile"
            if (name, tags) in sunk:
                if sunk[(name, tags)] != v:
                    raise AssertionError(f"phase 13b: {name} {tags}: the "
                                         f"front says {v}, the sink got "
                                         f"{sunk[(name, tags)]}")
                checked += 1
    for res in via_grpc[1]["results"]:
        tags = tuple(sorted(res["tags"]))
        for agg in ("min", "max"):
            key = (f"{res['name']}.{agg}", tags)
            if key in sunk:
                if sunk[key] != res[agg]:
                    raise AssertionError(f"phase 13b: {key}: the front "
                                         "differs from the sink")
                checked += 1
    if checked < 3 or launched < 1:
        raise AssertionError(f"phase 13b: {checked} values checked against "
                             f"the sink, K1 launched {launched} times")
    # the CPU twin: the same config and datagrams, the same requests
    twin = build_server(load_config(data={
        **data, "statsd_listen_addresses": [], "query_listen_addrs": [
            "http://127.0.0.1:0"]}), extra_metric_sinks=[ChannelMetricSink()],
        device="cpu")
    try:
        for d in grams:
            twin.process_metric_packet(d)
        twin.flush(now=QUERY_NOW)
        for r in reqs:
            if twin.query_engine.dispatch(dict(r)) != via_grpc[reqs.index(r)]:
                raise AssertionError(f"phase 13b: {r['op']} differs from "
                                     "the CPU twin's")
            twin.query_engine.dispatch(dict(r))  # both fronts served it
        twin.flush(now=QUERY_NOW + 10)
    finally:
        twin.shutdown()

    def ours(d):
        return {k: v for k, v in d.items()
                if k[0].startswith(("tenant.", "query."))}

    counters, gauges = ours(server.stats.totals()), ours(server.stats.gauges())
    if counters != ours(twin.stats.totals()) or \
            gauges != ours(twin.stats.gauges()) or not gauges:
        raise AssertionError(f"phase 13b: counters {counters} / gauges "
                             f"{gauges} differ from the CPU twin's")
    log(f"[query] 13b: {len(grams)} UDP datagrams, one flush: HTTP and gRPC "
        f"answer alike, {checked} values equal the sink's, /metrics "
        f"{len(metrics_body)} B the batch's exposition; K1 launched "
        f"{launched} times; counters {counters}; gauges {gauges}, equal "
        f"to the CPU twin's")
    return {"datagrams": len(grams), "checked": checked,
            "launches": launched,
            "counters": {f"{k[0]}|{','.join(k[1])}": v
                         for k, v in counters.items()},
            "gauges": {f"{k[0]}|{','.join(k[1])}": v
                       for k, v in gauges.items()}}


def phase_query(tw, parse, qs, aggs, ek) -> dict:
    """Phase 13: 13a and 13b."""
    return {"worker": phase_query_worker(tw, parse, qs, aggs, ek),
            "server": phase_query_server(ek)}



# -- phase 14 -----------------------------------------------------------------

# the smallest flush_chunk_target_ms the configuration takes
GOV_CHUNK_MS = 1
GOV_MIN_CHUNKS = 8
PIPE_INTERVALS = 3
OVERLOAD_INTERVAL = "2s"
OVERLOAD_S = 10.0
# the overload run's spill cap and pending-batch size: the pump drains a
# context's spill only past the batch size, so the blasters' timers reach
# the cap first and the C++ contexts shed every interval. Two Python
# blasters offer about 100,000 timer samples a second here, some 50,000
# spilled samples a context an interval past the 64-deep plane: three
# times this cap (with the defaults the card folds the spill as fast as
# it arrives and nothing sheds). A cap at or below the loop's 65,536
# floor leaves the loop no room: it runs after every flush and keeps it
OVERLOAD_SPILL_CAP = 1 << 14
OVERLOAD_BATCH = 1 << 18
LIFECYCLE_GRAMS = 300


def phase_governed(tw, ek, parse, qs, plan, python_snap) -> dict:
    """14a: phase 4's interval on a worker whose governor runs a 1 ms
    chunk target: the extraction launches K1 once per pow2 row chunk,
    and the snapshot is bitwise phase 4's one-shot snapshot. Its staged
    fold is phase 4's, so K3's rows by path (the rank path's share of
    phase 4's rows) are tallied here, off phase 4's timed interval."""
    from veneur_tpu_torch.health import FlushDeadlineGovernor
    from veneur_tpu_torch.ops import tdigest_kernel as tk

    gov = FlushDeadlineGovernor(chunk_target_ms=GOV_CHUNK_MS,
                                interval_s=10.0)
    w = tw.DeviceWorker(**INTERVAL_KW, device=DEVICE)
    w.governor = gov
    gov.begin_flush()
    before = ek.flush_extract.launches
    with tk.counting_paths(DEVICE) as paths:
        snap, t = run_interval(w, plan, parse, qs)
    launched = ek.flush_extract.launches - before
    gov.end_flush()
    k3_paths = dict(zip(tk.PATHS, paths.cpu().tolist()))
    log(f"[governed] K3's rows by path in phase 4's interval: {k3_paths}")
    check_guard_clean(w, snap, "phase 14a")
    compare_snapshots(snap, python_snap,
                      "phase 14a, governed against phase 4's one-shot")
    rep = gov.last_report
    rows, times = list(gov._chunk_rows), list(gov._chunk_times)
    if rep.get("chunks", 0) < GOV_MIN_CHUNKS:
        raise AssertionError(f"phase 14a: {rep.get('chunks')} chunks, "
                             f"fewer than {GOV_MIN_CHUNKS}")
    if launched != rep["chunks"]:
        raise AssertionError(f"phase 14a: K1 launched {launched} times for "
                             f"{rep['chunks']} chunks")
    n = snap.directory.num_histo_rows
    s_eff = sum(rows)
    h2d, d2h = w.ledger.flush_h2d(), w.ledger.flush_d2h()
    if d2h.get("extract_packed") != s_eff * (len(qs) + 10) * 4 \
            or s_eff < n or s_eff & (s_eff - 1):
        raise AssertionError(f"phase 14a: packed readback {d2h} for "
                             f"{s_eff} rows")
    out = {"chunks": rep["chunks"], "chunk_rows": rows,
           "chunk_s": times, "chunk_max_s": rep["chunk_max_s"],
           "chunk_mean_s": rep["chunk_mean_s"], "rows": s_eff,
           "k1_launches": launched, "h2d_bytes": h2d, "d2h_bytes": d2h,
           "flush_s": t["flush_s"], "extract_s": t.get("extract_s"),
           "fold_s": t.get("fold_s"), "k3_paths": k3_paths}
    log(f"[governed] phase 4's interval with flush_chunk_target_ms "
        f"{GOV_CHUNK_MS}: {rep['chunks']} chunks over {s_eff} rows "
        f"(rows {rows}), K1 launched {launched} times, snapshot bitwise "
        f"phase 4's one-shot; chunk ms " + ", ".join(
            f"{x * 1e3:.3f}" for x in times)
        + f"; flush_s {t['flush_s']:.4f}, extract_s "
        f"{t.get('extract_s', 0.0):.4f}; ledger h2d {h2d}, d2h {d2h}")
    return out


def phase_pipeline(ek) -> dict:
    """14b: the same datagrams over UDP, three intervals, into a serial
    server and a flush_pipeline server on the card, each with a channel
    sink and the Datadog, repeater and forward-statsd sinks on local
    listeners: every interval's InterMetrics and every sink byte equal."""
    import socket

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.sinks.channel import ChannelMetricSink

    base = {**server_config(native=False, spill=False),
            "ssf_span_uniqueness_rate": 0.0}
    runs = {}
    for pipelined in (False, True):
        sink = ChannelMetricSink()
        taps = SinkTaps()
        server = build_server(load_config(data={
            **base, "flush_pipeline": pipelined, **taps.config()}),
            extra_metric_sinks=[sink], device=DEVICE)
        if (server.flush_pipeline is not None) != pipelined:
            raise AssertionError("phase 14b: flush_pipeline not built")
        pin_idempotency(server)
        port = server.start()["udp://127.0.0.1:0"]
        got, sent, t0 = [], 0, time.perf_counter()
        try:
            for i in range(PIPE_INTERVALS):
                grams = server_datagrams(seed=40 + i, spill=False)
                with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                    for d in grams:
                        s.sendto(d, ("127.0.0.1", port))
                        time.sleep(0.0005)
                sent += len(grams)
                wait_for(lambda: server.packets_received >= sent,
                         "phase 14b datagrams", 60)
                now = 1_700_000_000 + 10 * i
                if pipelined:
                    if server.flush_pipeline.tick(now=now) != "ok":
                        raise AssertionError("phase 14b: tick deferred")
                    if not server.flush_pipeline.drain(timeout=60):
                        raise AssertionError("phase 14b: no drain")
                else:
                    server.flush(now=now)
                got.append(canonical(sink.queue.get(timeout=60)))
            check_server_guard_clean(server, "phase 14b")
        finally:
            server.shutdown()
            close_sink_sockets(server)
        try:
            taken = taps.taken()
        finally:
            taps.close()
        runs[pipelined] = (got, taken, time.perf_counter() - t0, server)
    (got_s, taken_s, wall_s, _), (got_p, taken_p, wall_p, srv_p) = (
        runs[False], runs[True])
    if got_s != got_p:
        raise AssertionError("phase 14b: the pipelined InterMetrics differ "
                             "from the serial server's")
    if taken_s != taken_p:
        raise AssertionError("phase 14b: the pipelined server's sinks sent "
                             "other bytes than the serial server's")
    st = srv_p.flush_pipeline.stats()
    log(f"[pipeline] {PIPE_INTERVALS} intervals of UDP datagrams: the "
        f"flush_pipeline server's InterMetrics ({sum(map(len, got_p))}) and "
        f"sink bytes (" + ", ".join(
            f"{k} {len(v)}" for k, v in taken_p.items())
        + f") equal the serial server's; stages {st}; serial "
        f"{wall_s:.2f} s, pipelined {wall_p:.2f} s")
    return {"intervals": PIPE_INTERVALS, "metrics": sum(map(len, got_p)),
            "pipeline": st, "serial_s": wall_s, "pipelined_s": wall_p}


def phase_overload() -> dict:
    """14c, tools/soak_overload.py's shape cut for time: a native server
    (2 workers, 2 C++ readers) with a 2 s interval against two
    unthrottled blaster threads for about 10 s, its self-telemetry sent
    to a local UDP socket. Shed samples are counted in telemetry, the
    flushes keep the cadence, the spill-cap loop runs after every flush,
    and each ingest.spill_cap gauge is the loop's state when it
    changed."""
    import socket
    import threading

    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server
    from veneur_tpu_torch.sinks.blackhole import BlackholeMetricSink

    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(0.2)
    lines: list = []
    rx_stop = threading.Event()

    def receive():
        while not rx_stop.is_set():
            try:
                lines.extend(rx.recv(65536).split(b"\n"))
            except socket.timeout:
                continue
            except OSError:
                return

    rx_thread = threading.Thread(target=receive, daemon=True)
    rx_thread.start()
    server = build_server(load_config(data={
        "statsd_listen_addresses": ["udp://127.0.0.1:0"],
        "interval": OVERLOAD_INTERVAL, "percentiles": [0.5, 0.99],
        "aggregates": ["min", "max", "count"], "num_workers": 2,
        "num_readers": 2, "tpu_native_ingest": True,
        "tpu_native_readers": True, "tpu_spill_cap": OVERLOAD_SPILL_CAP,
        "tpu_batch_size": OVERLOAD_BATCH,
        "stats_address": f"127.0.0.1:{rx.getsockname()[1]}"}),
        extra_metric_sinks=[BlackholeMetricSink()], device=DEVICE)
    caps, loop_calls, flush_s = [], [0], []
    adapt, inner = server._adapt_spill_caps, server._flush_inner

    def adapt_rec(dur, allow_shrink=True):
        loop_calls[0] += 1
        was = server._spill_cap_now
        adapt(dur, allow_shrink)
        if server._spill_cap_now != was:
            caps.append(server._spill_cap_now)

    def inner_rec(now=None):
        t0 = time.perf_counter()
        try:
            return inner(now)
        finally:
            flush_s.append(time.perf_counter() - t0)

    server._adapt_spill_caps = adapt_rec
    server._flush_inner = inner_rec
    port = server.start()["udp://127.0.0.1:0"]
    stop = threading.Event()
    sent = [0, 0]

    def blast(tid: int):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        i = 0
        while not stop.is_set():
            out = []
            for j in range(3):
                k = (i * 3 + j) % 800
                out.append(f"soak.t{tid}.timer{k}:{k % 97}|ms")
                out.append(f"soak.t{tid}.count:1|c")
                out.append(f"soak.set:{i % 5000}|s")
            s.sendto("\n".join(out).encode(), ("127.0.0.1", port))
            i += 1
            if i % 200 == 0:
                time.sleep(0.002)
        sent[tid] = i
        s.close()

    blasters = [threading.Thread(target=blast, args=(t,), daemon=True)
                for t in range(2)]
    t0 = time.time()
    f0 = server.flush_count
    for b in blasters:
        b.start()
    time.sleep(OVERLOAD_S)
    window = time.time() - t0
    flushes = server.flush_count - f0
    stop.set()
    for b in blasters:
        b.join(timeout=10)
    time.sleep(server.interval + 0.5)  # one flush reports the tail
    shed_total = sum(w.overload_dropped_total for w in server.workers)
    server.shutdown()
    rx_stop.set()
    rx_thread.join(timeout=5)
    rx.close()
    told_shed = sum(float(ln.split(b":")[1].split(b"|")[0])
                    for ln in lines
                    if ln.startswith(b"veneur.ingest.overload_dropped_total:"))
    told_caps = [int(float(ln.split(b":")[1].split(b"|")[0]))
                 for ln in lines
                 if ln.startswith(b"veneur.ingest.spill_cap:")]
    cadence = flushes / (window / server.interval)
    if told_shed <= 0 or told_shed > shed_total:
        raise AssertionError(f"phase 14c: shed samples in telemetry "
                             f"{told_shed}, the workers' {shed_total}")
    if cadence < 0.75:
        raise AssertionError(f"phase 14c: {flushes} flushes in {window:.1f}"
                             f" s at a {OVERLOAD_INTERVAL} interval")
    if loop_calls[0] < server.flush_count - 1:
        raise AssertionError(f"phase 14c: the spill-cap loop ran "
                             f"{loop_calls[0]} times for "
                             f"{server.flush_count} flushes")
    if told_caps != caps or (caps and caps[-1] != server._spill_cap_now):
        raise AssertionError(f"phase 14c: spill_cap gauges {told_caps}, the "
                             f"loop's changes {caps}, now "
                             f"{server._spill_cap_now}")
    out = {"window_s": window, "flushes": flushes, "cadence": cadence,
           "packets_sent": sum(sent), "shed_samples": shed_total,
           "shed_in_telemetry": told_shed, "cap_changes": caps,
           "spill_cap_now": server._spill_cap_now,
           "loop_runs": loop_calls[0], "flush_s_max": max(flush_s),
           "flush_s_median": sorted(flush_s)[len(flush_s) // 2],
           "telemetry_lines": len(lines)}
    log(f"[overload] {sum(sent)} datagrams from 2 unthrottled blasters in "
        f"{window:.1f} s: {flushes} flushes (cadence {cadence:.3f}), "
        f"flush_s median {out['flush_s_median']:.4f} max "
        f"{out['flush_s_max']:.4f}; {shed_total} samples shed, "
        f"{told_shed:.0f} of them reported in telemetry by the last "
        f"flush; the spill-cap loop ran {loop_calls[0]} times, cap "
        f"changes {caps} (the gauges received: {told_caps}), cap now "
        f"{server._spill_cap_now}")
    return out


def phase_lifecycle() -> dict:
    """14d: the port's CLI on the card in a subprocess, native readers
    and enable_profiling on: SIGHUP re-execs it on the same UDP socket
    and every counter datagram sent before, across and after the restart
    reaches the forward-statsd listener; POST /quitquitquit ends it with
    0; the first image's profile names K1's kernel."""
    import signal
    import socket
    import subprocess
    import urllib.request

    def free_port() -> int:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        udp = s.getsockname()[1]
    http = free_port()
    tap = TcpTap()
    work = ROOT / "build" / "chip_smoke_lifecycle"
    prof = work / "profile"
    if work.exists():
        import shutil

        shutil.rmtree(work)
    prof.mkdir(parents=True)
    cfg = work / "cfg.yaml"
    cfg.write_text(
        f"statsd_listen_addresses: [udp://127.0.0.1:{udp}]\n"
        f"http_address: 127.0.0.1:{http}\nhttp_quit: true\ninterval: 1s\n"
        f"percentiles: [0.5, 0.99]\nforward_statsd_address: "
        f"{tap.address}\nforward_statsd_network: tcp\n"
        f"enable_profiling: true\nprofile_dir: {prof}\n")
    logf = work / "server.log"
    t_start = time.perf_counter()
    with open(logf, "wb") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "veneur_tpu_torch.cli.veneur_main", "-f",
             str(cfg), "--device", DEVICE], cwd=ROOT, stdout=out,
            stderr=out)

    def healthy(deadline: float, images: int) -> None:
        """The images-th process image has bound its listeners (its
        serving line is logged) and answers the healthcheck."""
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError("phase 14d: the CLI exited: "
                                     + logf.read_text()[-2000:])
            if logf.read_bytes().count(b" serving on ") < images:
                time.sleep(0.1)
                continue
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{http}/healthcheck", timeout=1).read()
                return
            except OSError:
                time.sleep(0.2)
        raise AssertionError("phase 14d: the CLI never became healthy")

    def send(n: int) -> None:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            for i in range(n):
                s.sendto(b"lc.count:1|c\nlc.t:%d|ms" % (i % 97),
                         ("127.0.0.1", udp))
                time.sleep(0.0005)

    def counted() -> float:
        with tap.lock:
            data = b"".join(bytes(s) for s in tap.streams)
        return sum(float(ln.split(b":")[1].split(b"|")[0])
                   for ln in data.split(b"\n")
                   if ln.startswith(b"lc.count:"))

    try:
        healthy(time.time() + 90, 1)
        t_up = time.perf_counter() - t_start
        send(LIFECYCLE_GRAMS)
        t_hup = time.perf_counter()
        proc.send_signal(signal.SIGHUP)
        send(LIFECYCLE_GRAMS)  # queued in the kernel across the re-exec
        deadline = time.time() + 90
        while b"adopting inherited listener fds" not in logf.read_bytes():
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError("phase 14d: no re-exec: "
                                     + logf.read_text()[-2000:])
            time.sleep(0.1)
        healthy(deadline, 2)
        t_restart = time.perf_counter() - t_hup
        send(LIFECYCLE_GRAMS)
        want = 3 * LIFECYCLE_GRAMS
        deadline = time.time() + 30
        while counted() < want and time.time() < deadline:
            time.sleep(0.1)
        got = counted()
        if got != want:
            raise AssertionError(f"phase 14d: {got} of {want} datagrams "
                                 "counted across the restart")
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{http}/quitquitquit", method="POST"),
            timeout=10).read()
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"phase 14d: /quitquitquit exited {rc}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        tap.close()
    traces = sorted(prof.glob("*.trace.json"), key=lambda p: p.stat().st_mtime)
    named = []
    for t in traces:
        events = json.loads(t.read_text()).get("traceEvents", [])
        named.append(sum(1 for e in events
                         if "flush_extract" in str(e.get("name", ""))
                         and e.get("cat") == "kernel"))
    if len(traces) != 2 or not (named[0] or DEVICE == "cpu"):
        raise AssertionError(f"phase 14d: traces {traces}, K1 kernel events "
                             f"{named}")
    out = {"datagrams": want, "counted": got, "start_s": t_up,
           "restart_s": t_restart, "traces": len(traces),
           "k1_kernel_events": named}
    log(f"[lifecycle] CLI on the card: healthy in {t_up:.1f} s; SIGHUP "
        f"re-exec healthy again in {t_restart:.1f} s on the same UDP socket;"
        f" {got:.0f} of {want} counter datagrams counted across the restart;"
        f" /quitquitquit exited 0; the two images' profiles hold {named} "
        f"K1 kernel events")
    return out


def phase_flush_ops(ek, hll) -> tuple:
    """Phases 14b to 14d, K1's and the HLL kernels' launches of 14b
    counted from 0."""
    reset_launches(ek, hll)
    out = {"pipeline": phase_pipeline(ek)}
    launches_pipeline = read_launches(ek, hll)
    out["overload"] = phase_overload()
    out["lifecycle"] = phase_lifecycle()
    return out, launches_pipeline


# -- phase 15 -----------------------------------------------------------------


# 15a's Kafka arm takes the first KAFKA_CUT metrics of the batch's
# materialization: one JSON message each, formatted in Python (PERF.md
# section 4 lists the cut)
KAFKA_CUT = 65_536
# and its local-file and S3 arms a quarter of it (host TSV formatting,
# 13 s a batch whole; PERF.md section 4 lists the cut)
PLUGIN_CUT_DIV = 4
SINKS_NOW = 1_700_000_000
SINKS_HOST = "chip-smoke"
# 15b: the SSF spans fed to the server beside phase 5's datagrams
SINK_SPANS = 400


class _StillClock:
    """A ``time`` module whose wall clock stands at SINKS_NOW; monotonic
    and sleep are the real ones."""

    monotonic = staticmethod(time.monotonic)
    sleep = staticmethod(time.sleep)

    @staticmethod
    def time() -> float:
        return float(SINKS_NOW)


@contextlib.contextmanager
def pinned_sink_clocks():
    """The wall clocks that reach the bytes of phase 15's sinks and
    plugins held still: the S3 plugin's and SigV4's date, gzip's header
    time, the Kafka messages' timestamps and the Splunk submit loop's
    idle cut (patched per module: gRPC's deadlines need the real
    clock)."""
    import datetime
    import gzip
    import types

    from veneur_tpu_torch.plugins import s3
    from veneur_tpu_torch.sinks import kafka_wire, splunk

    fixed = datetime.datetime.fromtimestamp(SINKS_NOW, datetime.timezone.utc)

    class _Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    _datetime = types.SimpleNamespace(datetime=_Clock,
                                      timezone=datetime.timezone)

    class _Gzip:
        @staticmethod
        def compress(data: bytes) -> bytes:
            return gzip.compress(data, mtime=SINKS_NOW)

    saved = [(s3, "datetime", s3.datetime), (s3, "gzip", s3.gzip),
             (kafka_wire, "time", kafka_wire.time),
             (splunk, "time", splunk.time)]
    s3.datetime, s3.gzip = _datetime, _Gzip
    kafka_wire.time = splunk.time = _StillClock
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


class KafkaTap:
    """A minimal in-process Kafka broker: one node and PARTS partitions a
    topic; it answers Metadata v0 and Produce v1 (every partition
    accepted) and keeps each produce request's bytes."""

    PARTS = 4

    def __init__(self) -> None:
        import socket
        import threading

        self.lock = threading.Lock()
        self.produce: list[bytes] = []
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.address = f"127.0.0.1:{self.port}"
        threading.Thread(target=self._serve, daemon=True,
                         name="kafka-tap").start()

    def close(self) -> None:
        self.sock.close()

    def _serve(self) -> None:
        import threading

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._conn, args=(conn,),
                             daemon=True).start()

    @staticmethod
    def _read(conn, n: int):
        buf = bytearray()
        while len(buf) < n:
            chunk = conn.recv(min(n - len(buf), 1 << 20))
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)

    def _conn(self, conn) -> None:
        from veneur_tpu_torch.sinks.kafka_wire import _Reader, enc_string

        with conn:
            while True:
                head = self._read(conn, 4)
                if head is None:
                    return
                frame = self._read(conn, struct.unpack(">i", head)[0])
                if frame is None:
                    return
                r = _Reader(frame)
                api, _version, corr = r.i16(), r.i16(), r.i32()
                r.string()
                out = [struct.pack(">i", corr)]
                if api == 3:
                    topics = [r.string() for _ in range(r.i32())]
                    out += [struct.pack(">ii", 1, 0), enc_string("127.0.0.1"),
                            struct.pack(">ii", self.port, len(topics))]
                    for t in topics:
                        out += [struct.pack(">h", 0), enc_string(t),
                                struct.pack(">i", self.PARTS)]
                        out += [struct.pack(">hiiiiii", 0, p, 0, 1, 0, 1, 0)
                                for p in range(self.PARTS)]
                else:
                    with self.lock:
                        self.produce.append(frame)
                    acks = r.i16()
                    r.i32()
                    ntopics = r.i32()
                    out.append(struct.pack(">i", ntopics))
                    for _ in range(ntopics):
                        out.append(enc_string(r.string()))
                        nparts = r.i32()
                        out.append(struct.pack(">i", nparts))
                        for _ in range(nparts):
                            pid = r.i32()
                            r._take(r.i32())
                            out.append(struct.pack(">ihq", pid, 0, 0))
                    out.append(struct.pack(">i", 0))
                    if acks == 0:
                        continue
                body = b"".join(out)
                conn.sendall(struct.pack(">i", len(body)) + body)


class CaptureOpener:
    """An opener that keeps every request (URL, method, headers, body)
    and answers 200."""

    def __init__(self) -> None:
        import threading

        self.lock = threading.Lock()
        self.requests: list = []

    def __call__(self, req, timeout):
        with self.lock:
            self.requests.append((req.full_url, req.get_method(),
                                  sorted(req.header_items()),
                                  req.data or b""))
        return b"{}"

    def to(self, prefix: str) -> list:
        with self.lock:
            return [r for r in self.requests if r[0].startswith(prefix)]


def archive_arms(batch, tmp: Path, tag: str) -> dict:
    """Phase 15a's sinks and plugins over one batch, in turn: what each
    produced (frames, file bytes, request bodies), its seconds, and the
    columnar sections each encoder built in the archive's arms."""
    from veneur_tpu_torch.archive import (ArchiveBlobPlugin,
                                          MetricArchiveSink,
                                          SegmentedArchiveWriter,
                                          read_archive, wire)
    from veneur_tpu_torch.plugins.localfile import LocalFilePlugin
    from veneur_tpu_torch.plugins.s3 import S3Plugin
    from veneur_tpu_torch.sinks.kafka import (KafkaMetricSink,
                                              default_producer)

    out, secs, sections = {}, {}, {}
    n = batch.count_for("archive")
    for name, native in (("archive_native", True), ("archive_python", False)):
        sink = MetricArchiveSink(
            SegmentedArchiveWriter(str(tmp / f"{tag}-{name}"),
                                   max_segment_bytes=1 << 30),
            hostname=SINKS_HOST)
        wire.reset_section_counts()
        t0 = time.perf_counter()
        if native:
            sink.flush_columnar_native(batch)
        else:
            sink.flush_columnar(batch)
        secs[name] = time.perf_counter() - t0
        sections[name] = dict(wire.SECTION_COUNTS)
        sink.stop()
        if sink.metrics_flushed != n or not sink.delivery.conserved():
            raise AssertionError(f"phase 15a {tag} {name}: "
                                 f"{sink.metrics_flushed} of {n} archived")
        out[name] = read_archive(str(tmp / f"{tag}-{name}"))
    path = tmp / f"{tag}-flush.tsv"
    local = LocalFilePlugin(str(path), 10.0)
    # iterating the batch is iterating its (memoized) materialization
    head = batch.materialize()[:len(batch) // PLUGIN_CUT_DIV]
    t0 = time.perf_counter()
    local.flush(head, SINKS_HOST)
    secs["localfile"] = time.perf_counter() - t0
    out["localfile"] = path.read_bytes()
    opener = CaptureOpener()
    s3p = S3Plugin("smoke-bucket", "us-west-2", "AK", "SK", 10.0,
                   opener=opener)
    t0 = time.perf_counter()
    s3p.flush(head, SINKS_HOST)
    secs["s3"] = time.perf_counter() - t0
    blob = ArchiveBlobPlugin("smoke-bucket", "us-west-2", "AK", "SK",
                             opener=opener)
    wire.reset_section_counts()
    t0 = time.perf_counter()
    blob.flush(batch, SINKS_HOST)
    secs["archive_blob"] = time.perf_counter() - t0
    sections["archive_blob"] = dict(wire.SECTION_COUNTS)
    if (local.flush_errors, s3p.uploads, s3p.flush_errors, blob.uploads,
            blob.flush_errors) != (0, 1, 0, 1, 0):
        raise AssertionError(f"phase 15a {tag}: a plugin failed")
    out["s3"] = opener.to("https://smoke-bucket.s3.us-west-2.amazonaws.com/"
                          f"{SINKS_HOST}/")
    out["archive_blob"] = opener.to(
        "https://smoke-bucket.s3.us-west-2.amazonaws.com/archive/")
    tap = KafkaTap()
    try:
        producer = default_producer(tap.address)
        kafka = KafkaMetricSink(producer, metric_topic="smoke-metrics")
        mats = batch.materialize()[:KAFKA_CUT]
        t0 = time.perf_counter()
        kafka.flush(mats)
        secs["kafka"] = time.perf_counter() - t0
        producer.close()
        if (kafka.flushed_metrics, producer.delivered, producer.dropped) \
                != (len(mats), len(mats), 0):
            raise AssertionError(
                f"phase 15a {tag}: Kafka delivered {producer.delivered} of "
                f"{len(mats)} (dropped {producer.dropped})")
        out["kafka"] = list(tap.produce)
    finally:
        tap.close()
    return {"out": out, "s": secs, "sections": sections}


def phase_sinks_batch(batch, batch_c) -> dict:
    """Phase 15a: phase 8's card batch and its CPU twin through the
    archive sink (native and Python), the local-file, S3 and blob
    plugins and the Kafka metric sink; every output of the card batch
    equals the CPU batch's, the native frame equals the Python frame,
    and the native encoder built every section of the native arms."""
    import gzip
    import tempfile

    from veneur_tpu_torch.archive import wire

    groups = sum(1 for g in batch.groups if g.families and g.nrows)
    with tempfile.TemporaryDirectory(prefix="vsmoke15") as tmp, \
            pinned_sink_clocks():
        runs = {"card": archive_arms(batch, Path(tmp), "card"),
                "cpu": archive_arms(batch_c, Path(tmp), "cpu")}
    for where, run in runs.items():
        sec = run["sections"]
        for name in ("archive_native", "archive_blob"):
            if sec[name] != {"native": groups, "python": 0}:
                raise AssertionError(
                    f"phase 15a {where}: {name} encoded its sections "
                    f"{sec[name]}, not all {groups} natively")
        if sec["archive_python"] != {"native": 0, "python": groups}:
            raise AssertionError(f"phase 15a {where}: the Python arm "
                                 f"encoded {sec['archive_python']}")
    card, cpu = runs["card"]["out"], runs["cpu"]["out"]
    for name in card:
        if card[name] != cpu[name]:
            raise AssertionError(f"phase 15a: the card batch's {name} "
                                 "differs from the CPU batch's")
    frames = card["archive_native"]
    if len(frames) != 1 or card["archive_python"] != frames:
        raise AssertionError("phase 15a: the native archive frame differs "
                             "from the Python frame")
    decoded = wire.decode_flush(frames[0])
    if len(decoded["samples"]) != len(batch):
        raise AssertionError("phase 15a: the frame decodes to "
                             f"{len(decoded['samples'])} of {len(batch)}")
    [s3_put] = card["s3"]
    if gzip.decompress(s3_put[3]) != card["localfile"]:
        raise AssertionError("phase 15a: the S3 body is not the local "
                             "file's TSV")
    [blob_put] = card["archive_blob"]
    if not card["kafka"]:
        raise AssertionError("phase 15a: no produce request")
    sizes = {"archive_native": len(frames[0]),
             "archive_python": len(frames[0]),
             "localfile": len(card["localfile"]), "s3": len(s3_put[3]),
             "archive_blob": len(blob_put[3]),
             "kafka": sum(len(f) for f in card["kafka"])}
    for name, b in sizes.items():
        log(f"[sinks] {name}: card batch {runs['card']['s'][name]:.4f} s, "
            f"CPU batch {runs['cpu']['s'][name]:.4f} s; {b} bytes")
    log(f"[sinks] {len(batch)} metrics in {groups} groups: the VMB1 frame "
        f"({len(frames[0])} bytes) native equals Python and the CPU batch's; "
        f"the TSV and S3 bodies ({len(batch) // PLUGIN_CUT_DIV} metrics), "
        f"the blob body and the Kafka produce requests "
        f"({min(KAFKA_CUT, len(batch))} messages) equal the CPU batch's")
    return {"metrics": len(batch), "groups": groups,
            "kafka_messages": min(KAFKA_CUT, len(batch)),
            "plugin_metrics": len(batch) // PLUGIN_CUT_DIV, "bytes": sizes,
            "card_s": runs["card"]["s"], "cpu_s": runs["cpu"]["s"]}


def sink_span_packets(n: int) -> list[bytes]:
    """15b's SSF spans: three services, indicator and error spans, a
    counter sample each."""
    import numpy as np

    from veneur_tpu_torch import ssf
    from veneur_tpu_torch.protocol import ssf_wire

    rng = np.random.default_rng(15)
    out = []
    for i in range(n):
        tid = int(rng.integers(1, 1 << 40))
        start = SINKS_NOW * 10**9 + i * 1000
        tags = {"host": f"h{i % 3}"}
        if i % 4 == 0:
            tags["resource"] = f"/r{i % 3}"
        out.append(ssf_wire.encode_datagram(ssf.SSFSpan(
            trace_id=tid if i % 5 else 77, id=tid + i + 1,
            parent_id=int(rng.integers(0, 9)), start_timestamp=start,
            end_timestamp=start + int(rng.gamma(2.0, 5e6)),
            error=bool(i % 6 == 1), service=f"svc{i % 3}",
            indicator=bool(i % 2), name=f"op{i % 4}", tags=tags,
            metrics=[ssf.SSFSample(metric=ssf.SSFMetricType.COUNTER,
                                   name="sk.hits", value=1.0,
                                   timestamp=SINKS_NOW)])))
    return out


class FalconerTap:
    """A falconer SpanSink gRPC servicer keeping each SendSpan request's
    bytes as read off the wire."""

    def __init__(self) -> None:
        import threading
        from concurrent import futures

        import grpc

        from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb
        from veneur_tpu_torch.sinks.grpsink import SERVICE_NAME

        self.lock = threading.Lock()
        self.messages: list[bytes] = []

        def send_span(request: bytes, context):
            with self.lock:
                self.messages.append(request)
            return pb.SendResponse()

        handlers = grpc.method_handlers_generic_handler(SERVICE_NAME, {
            "SendSpan": grpc.unary_unary_rpc_method_handler(
                send_span, request_deserializer=lambda b: b,
                response_serializer=pb.SendResponse.SerializeToString)})
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self.server.add_generic_rpc_handlers((handlers,))
        self.port = self.server.add_insecure_port("127.0.0.1:0")
        self.server.start()

    def close(self) -> None:
        self.server.stop(grace=1)


def sink_scalars(metrics) -> dict:
    """The counters and gauges of a flush as a global's import merges
    them, by name, tags and type: a counter's values summed, a gauge's
    last value (two rows of one series, as a local-only set's gauge and
    its global twin make, become one); each value's bits."""
    out: dict = {}
    for m in metrics:
        if m.type.name not in ("COUNTER", "GAUGE"):
            continue
        key = (m.name, tuple(sorted(m.tags)), m.type.name)
        if m.type.name == "COUNTER" and key in out:
            out[key] += float(m.value)
        else:
            out[key] = float(m.value)
    return {k: struct.pack("<d", v) for k, v in out.items()}


def sinks_server_once(device: str, grams, spans, tmp: Path, ek) -> dict:
    """15b's server on ``device``: every key of this slice on, each
    endpoint a local fake; the datagrams and spans in, the span worker
    drained, one flush. Everything each endpoint took, the flushed
    InterMetrics, the archive's frames and K1's launches in the flush."""
    import random
    import socket

    from veneur_tpu_torch.archive import read_archive
    from veneur_tpu_torch.core.config import load_config
    from veneur_tpu_torch.core.factory import build_server

    kafka, falconer, opener = KafkaTap(), FalconerTap(), CaptureOpener()
    xray = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    # every segment waits in the socket until the flush is done
    xray.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16 << 20)
    xray.bind(("127.0.0.1", 0))
    xray.settimeout(30)
    d = tmp / ("cpu" if device == "cpu" else "card")
    d.mkdir(parents=True)
    data = {"interval": "10s", "hostname": SINKS_HOST, "percentiles": QS,
            "aggregates": ["min", "max", "count", "sum"],
            "tpu_native_ingest": False, "micro_fold": False,
            "ssf_span_uniqueness_rate": 0.0, "span_channel_capacity": 10000,
            "span_flush_drain_s": 0.0,
            "kafka_broker": kafka.address,
            "kafka_metric_topic": "smoke-metrics",
            "kafka_span_topic": "smoke-spans",
            "splunk_hec_address": "http://hec.smoke:8088",
            "splunk_hec_token": "smoke", "splunk_hec_batch_size": 100_000,
            "xray_address": f"127.0.0.1:{xray.getsockname()[1]}",
            "xray_annotation_tags": ["host"],
            "lightstep_access_token": "smoke",
            "lightstep_collector_host": "http://lightstep.smoke",
            "falconer_address": f"127.0.0.1:{falconer.port}",
            "archive_dir": str(d / "archive"),
            "flush_file": str(d / "flush.tsv"),
            "aws_s3_bucket": "smoke-bucket", "aws_access_key_id": "AK",
            "aws_secret_access_key": "SK", "aws_region": "us-west-2",
            "archive_blob_bucket": "smoke-bucket",
            "archive_blob_access_key": "AK",
            "archive_blob_secret_key": "SK",
            "archive_blob_region": "us-west-2"}
    # the LightStep reporter ids come from the global random
    random.seed(15)
    server = build_server(load_config(data=data), device=device,
                          opener=opener)
    try:
        names = sorted(s.name() for s in server.span_sinks)
        if names != ["falconer", "kafka", "lightstep", "splunk", "xray"] \
                or [p.name() for p in server.plugins] != [
                    "localfile", "s3", "archive_blob"]:
            raise AssertionError(f"phase 15b: span sinks {names}, plugins "
                                 f"{[p.name() for p in server.plugins]}")
        for s in server.span_sinks:
            s.start()
        for g in grams:
            server.process_metric_packet(g)
        for p in spans:
            server.handle_trace_packet(p)
        sw = server.span_worker
        sw.chan.put(None)
        sw.work()
        for lane in list(sw._lanes.values()):
            lane.q.join()
        before = ek.flush_extract.launches
        t0 = time.perf_counter()
        got = server.flush(now=SINKS_NOW).materialize()
        flush_s = time.perf_counter() - t0
        launched = ek.flush_extract.launches - before
        phases = dict(server.last_flush_phases)
        [splunk] = [s for s in server.span_sinks if s.name() == "splunk"]
        splunk.stop()
        wait_for(lambda: len(falconer.messages) >= len(spans),
                 "falconer's spans")
        xray_grams = [xray.recv(65536) for _ in range(len(spans))]
        counts = sorted((s.name(), s.spans_flushed, s.spans_dropped)
                        for s in server.span_sinks)
        # what the endpoints took from the flush, before the sinks stop
        taken = {"kafka": list(kafka.produce),
                 "falconer": list(falconer.messages), "xray": xray_grams,
                 "http": sorted(opener.requests)}
        if device != "cpu":
            check_server_guard_clean(server, "phase 15b", micro=False)
    finally:
        server.shutdown()
        kafka.close()
        falconer.close()
        xray.close()
    return {"metrics": got, "launched": launched, "phases": phases,
            "flush_s": flush_s, "counts": counts, "taken": taken,
            "archive": read_archive(str(d / "archive")),
            "localfile": (d / "flush.tsv").read_bytes()}


def replay_into_global(frames, dedup_runs: int = 0):
    """A fresh port global on the card fed the archive's frames through
    its import server (plainly, or under the dedup envelope
    ``dedup_runs`` times); its flushed scalars, the replay stats and the
    import server."""
    from veneur_tpu_torch.archive.replay import replay_frames
    from veneur_tpu_torch.core.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.distributed.import_server import ImportServer

    glob = Server(Config(interval="10s"), device=DEVICE)
    try:
        imp = ImportServer(glob)
        if dedup_runs:
            stats = [replay_frames(frames, apply_wire=imp.handle_wire,
                                   dedup=True) for _ in range(dedup_runs)]
        else:
            stats = [replay_frames(frames, apply_batch=imp.handle_batch)]
        got = glob.flush(now=SINKS_NOW)
    finally:
        glob.shutdown()
    return sink_scalars(got), stats, imp


def phase_sinks_server(ek) -> dict:
    """Phase 15b: a server built by build_server on the card with every
    key of this slice on (Kafka, Splunk HEC, X-Ray, LightStep, falconer,
    the archive and the three plugins), phase 5's datagrams and
    SINK_SPANS spans in, one flush: K1 launched, the guard clean, the
    plugin pass ran, and every endpoint took the bytes a CPU-built
    server's took; then the archive replayed into a port global on the
    card gives the flushed counters and gauges bitwise, and a dedup
    replay run twice merges once."""
    import tempfile

    grams = server_datagrams(seed=9, spill=False)
    spans = sink_span_packets(SINK_SPANS)
    with tempfile.TemporaryDirectory(prefix="vsmoke15b") as tmp:
        with pinned_sink_clocks():
            card = sinks_server_once(DEVICE, grams, spans, Path(tmp), ek)
            cpu = sinks_server_once("cpu", grams, spans, Path(tmp) / "twin",
                                    ek)
        # phase 3d's replay CLI, over this phase's archive directory
        t0 = time.perf_counter()
        replay_cli = phase_replay_cli(Path(tmp) / "card" / "archive",
                                      card["archive"],
                                      sink_scalars(card["metrics"]))
        replay_cli["seconds"] = time.perf_counter() - t0
    if card["launched"] < 1:
        raise AssertionError("phase 15b: the flush launched no K1")
    if "plugin_flush_s" not in card["phases"]:
        raise AssertionError("phase 15b: the plugin pass did not run")
    for name, sent, dropped in card["counts"]:
        if (sent, dropped) != (len(spans), 0):
            raise AssertionError(f"phase 15b: span sink {name} sent {sent} "
                                 f"of {len(spans)}, dropped {dropped}")
    if canonical(card["metrics"]) != canonical(cpu["metrics"]):
        raise AssertionError("phase 15b: the card server's InterMetrics "
                             "differ from the CPU server's")
    for key in ("kafka", "falconer", "xray", "http"):
        if card["taken"][key] != cpu["taken"][key]:
            raise AssertionError(f"phase 15b: {key} took other bytes from "
                                 "the card server than from the CPU server")
    for key in ("archive", "localfile", "counts"):
        if card[key] != cpu[key]:
            raise AssertionError(f"phase 15b: the card server's {key} "
                                 "differs from the CPU server's")
    http = card["taken"]["http"]
    hosts = sorted({u.split("/")[2] for u, *_ in http})
    if hosts != ["hec.smoke:8088", "lightstep.smoke",
                 "smoke-bucket.s3.us-west-2.amazonaws.com"]:
        raise AssertionError(f"phase 15b: requests went to {hosts}")
    # the archive replayed into a port global on the card
    expected = sink_scalars(card["metrics"])
    t0 = time.perf_counter()
    got, [stats], _imp = replay_into_global(card["archive"])
    replay_s = time.perf_counter() - t0
    if stats["skipped_inexact"] or got != expected:
        raise AssertionError(f"phase 15b: the replayed global's counters "
                             f"and gauges differ from the flush's ({stats})")
    got2, (s1, s2), imp = replay_into_global(card["archive"], dedup_runs=2)
    if got2 != expected or imp.metrics_deduped != s2["imported"] \
            or s1["imported"] != s2["imported"] or not s1["imported"]:
        raise AssertionError(f"phase 15b: the dedup replay merged "
                             f"{imp.metrics_deduped} of {s2['imported']} "
                             "twice")
    log(f"[sinks server] {len(grams)} datagrams and {len(spans)} spans -> "
        f"{len(card['metrics'])} InterMetrics on {DEVICE}, flush "
        f"{card['flush_s']:.4f} s (sink_flush_s "
        f"{card['phases'].get('sink_flush_s', 0.0):.4f}, plugin_flush_s "
        f"{card['phases']['plugin_flush_s']:.4f}), flush_extract launches "
        f"{card['launched']}; every span sink sent {len(spans)} spans; "
        f"Kafka, falconer, X-Ray, HEC, LightStep, S3 and blob bytes, the "
        f"archive and the flush file equal the CPU server's; the archive "
        f"replayed into a card global: {len(expected)} counters "
        f"and gauges bitwise ({replay_s:.4f} s), a dedup replay twice "
        f"merged once ({imp.metrics_deduped} deduped)")
    return {"datagrams": len(grams), "spans": len(spans),
            "metrics": len(card["metrics"]), "flush_s": card["flush_s"],
            "phases": card["phases"], "launched": card["launched"],
            "replay_s": replay_s, "scalars": len(expected),
            "deduped": imp.metrics_deduped, "replay_cli": replay_cli}


# -- phase 3d -----------------------------------------------------------------


# 3d's cdf runs on digest rows compressed from phase 3c's K2a shape; the
# analysis takes the tool's default sample count. The fuzz runs its nine
# targets other than query for FUZZ_S seconds each from FUZZ_SEED: the
# first seed whose device_fallback cases inject all four fault kinds and
# reach K1 to K5 within 8 cases (a CPU run of the target counted them).
# query runs from QUERY_SEED, the seed of 1 to 400 whose first quantile
# divergence comes latest (50 clean cases: the HLL, CMS and quantile
# programs run on the card first), until that divergence or QUERY_S: on
# every seed its quantile check diverges on a row whose slot search
# passes the last live centroid (ROADMAP §3, F9, in both packages).
CDF_SHAPE = (131_072, 192)
ANALYSIS_SAMPLES = 100_000
FUZZ_SEED, FUZZ_S = 12, 2.0
QUERY_SEED, QUERY_S = 104, 10.0


def phase_cdf(td) -> dict:
    """td.cdf on the card over digest rows (K2a's compress of phase 3c's
    [131,072, 192] digest candidates, 16 edge rows in front) at values on,
    next to, between and past each row's min and max: bitwise the CPU's,
    every finite fraction in [0, 1]."""
    import torch

    from veneur_tpu_torch.ops import exactnum as exn

    s, m = CDF_SHAPE
    cm, cw = probe_td.digest_candidates(s, m, s + m, DEVICE)
    cm[:16], cw[:16] = probe_td.edge_rows(m, DEVICE)
    means, w = td.compress_rows(cm, cw, probe_td.COMPRESSION, probe_td.C)
    del cm, cw
    live = w > 0
    inf = float("inf")
    dmin = exn.amin(torch.where(live, means, inf), 1)
    dmax = exn.amax(torch.where(live, means, -inf), 1)
    u = torch.rand((s,), generator=probe_td._gen(s, DEVICE), device=DEVICE)
    odd = torch.arange(s, device=DEVICE) % 2 == 1
    down, up = torch.full_like(dmin, -inf), torch.full_like(dmin, inf)
    # five value sets, each row meeting both sides of its min and max:
    # the next float past a bound (half the rows each side), the bound
    # itself (the same halves), the next float inside each bound, and a
    # value between them
    values = {"past": torch.where(odd, torch.nextafter(dmax, up),
                                  torch.nextafter(dmin, down)),
              "at": torch.where(odd, dmin, dmax),
              "above_min": torch.nextafter(dmin, up),
              "below_max": torch.nextafter(dmax, down),
              "inside": dmin + u * (dmax - dmin)}
    cpu = [t.cpu() for t in (means, w, dmin, dmax)]
    out = {}
    for name, v in values.items():
        sync()
        t0 = time.perf_counter()
        got = td.cdf(means, w, dmin, dmax, v)
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        ref = td.cdf(*cpu, v.cpu())
        same, _ = probe.bitwise_equal(got.cpu(), ref)
        fin = got[torch.isfinite(got)]
        if not same or bool(((fin < 0) | (fin > 1)).any()):
            raise AssertionError(f"phase 3d: cdf at {name} is not bitwise "
                                 "the CPU's, or a fraction leaves [0, 1]")
        out[name] = {"ms": ms, "nan_rows": int(torch.isnan(got).sum())}
    log(f"[tools] cdf on [{s:,}, {probe_td.C}] digest rows (K2a of "
        f"[{s:,}, {m}]) at {len(values)} value sets across every row's "
        f"min and max: bitwise the CPU's, fractions in [0, 1]")
    return out


def phase_analysis(td) -> dict:
    """tools/port_tdigest_analysis.py's seven distributions at
    ANALYSIS_SAMPLES samples through one digest row on the card (K2b) and
    on the CPU: every estimate bitwise, the worst q-error under the
    tool's bound."""
    import tempfile

    import numpy as np

    out = {}
    before = td.add_batch.launches
    with tempfile.TemporaryDirectory(prefix="vsmoke3d") as tmp:
        for name in sorted(analysis_tool.DISTRIBUTIONS):
            draw = analysis_tool.DISTRIBUTIONS[name]
            card = analysis_tool.analyze(name, draw, ANALYSIS_SAMPLES, 100.0,
                                         f"{tmp}/card", device=DEVICE)
            cpu = analysis_tool.analyze(name, draw, ANALYSIS_SAMPLES, 100.0,
                                        f"{tmp}/cpu", device="cpu")
            if not np.array_equal(card["estimated"].view(np.uint32),
                                  cpu["estimated"].view(np.uint32)):
                raise AssertionError(f"phase 3d: the {name} analysis's "
                                     "estimates on the card differ from "
                                     "the CPU's")
            out[name] = {k: card[k] for k in ("max_q_err", "mean_q_err",
                                              "centroids", "seconds")}
            out[name]["cpu_seconds"] = cpu["seconds"]
    launched = td.add_batch.launches - before
    worst = max(r["max_q_err"] for r in out.values())
    if worst >= analysis_tool.MAX_Q_ERR or (DEVICE == "cuda"
                                             and launched < len(out)):
        raise AssertionError(f"phase 3d: worst q-error {worst} (bound "
                             f"{analysis_tool.MAX_Q_ERR}), K2b launched "
                             f"{launched} times for {len(out)} digests")
    log(f"[tools] t-digest analysis, {len(out)} distributions x "
        f"{ANALYSIS_SAMPLES:,} samples through K2b: estimates bitwise the "
        f"CPU's, worst q-error {worst:.5f}, card "
        f"{sum(r['seconds'] for r in out.values()):.3f} s in all")
    return {"distributions": out, "worst_q_err": worst,
            "add_batch_launches": launched}


def phase_fuzz() -> dict:
    """tools/port_fuzz_differential.py on the card: its nine targets
    other than query for FUZZ_S each from FUZZ_SEED, with 0 divergences
    and device_fallback injecting every fault kind; then query from
    QUERY_SEED, whose divergence must be the one of ROADMAP §3's F9 (the
    quantile slot past the last live centroid) with the card's
    quantile_rows bitwise the CPU's on that case."""
    import torch

    from veneur_tpu_torch.ops import query as qops

    nine = [t for t in fuzz_tool.TARGETS if t != "query"]
    res = fuzz_tool.run_round(nine, FUZZ_S, FUZZ_SEED, DEVICE)
    if res["divergences"] or sorted(res["per_target"]) != sorted(nine):
        raise AssertionError(f"phase 3d: the fuzz diverged: "
                             f"{res['divergences']}")
    injected = res["stats"]["device_fallback"]["injected"]
    if min(injected.values()) < 1:
        raise AssertionError(f"phase 3d: device_fallback injected {injected}"
                             ", not every fault kind")
    q = fuzz_tool.run_round(["query"], QUERY_S, QUERY_SEED, DEVICE)
    case = q["stats"].get("query", {}).pop("case", None)
    query = {"cases": q["per_target"].get("query"),
             "seconds": q["seconds"]["query"]}
    if q["divergences"]:
        rows = torch.from_numpy(case["rows"])
        cpu = qops.quantile_rows(*(torch.from_numpy(case[k]) for k in (
            "means", "weights", "dmin", "dmax")), rows,
            torch.from_numpy(case["qs"])).numpy()
        same, _ = probe.bitwise_equal(torch.from_numpy(case["got"]),
                                      torch.from_numpy(cpu))
        if q["stats"]["query"]["failed_check"] != "quantile" or not same \
                or not fuzz_tool.quantile_case_past_last_live(case):
            raise AssertionError(f"phase 3d: query diverged on "
                                 f"{q['stats']['query']} otherwise than "
                                 "F9, or the card's quantile_rows differs "
                                 "from the CPU's there")
        query["cases"], query["f9"] = case["index"], True
    log(f"[tools] fuzz on {DEVICE}, seed {FUZZ_SEED}, {FUZZ_S} s a target: "
        + ", ".join(f"{k} {v:,}" for k, v in res["per_target"].items())
        + f" cases clean; device_fallback injected {injected}; query from "
        f"seed {QUERY_SEED}: {query['cases']} cases clean, then "
        + ("F9's quantile case, the card bitwise the CPU there"
           if q["divergences"] else "no divergence"))
    return {"per_target": res["per_target"], "seconds": res["seconds"],
            "injected": injected, "seed": FUZZ_SEED, "query": query,
            "query_seed": QUERY_SEED}


def phase_replay_cli(archive: Path, frames: list, expected: dict) -> dict:
    """tools/port_replay_archive.py over 15b's archive directory:
    ``--inspect``, then ``--target`` into a fresh port global on the card
    over gRPC (its counters and gauges bitwise the flushed ones), then a
    ``--dedup`` replay run twice into another (merged once)."""
    import io

    from veneur_tpu_torch.core.config import Config
    from veneur_tpu_torch.core.server import Server
    from veneur_tpu_torch.distributed.import_server import ImportServer

    def cli(*args) -> dict:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = replay_tool.main(["--dir", str(archive), *args])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0:
            raise AssertionError(f"phase 3d: the replay CLI {args} exited "
                                 f"{rc}: {line}")
        return line

    census = cli("--inspect")
    if census["frames"] != len(frames) or census["frames_undecodable"] \
            or census["skipped_inexact"] or not census["importable"]:
        raise AssertionError(f"phase 3d: the replay CLI's census {census}")
    out = {"inspect": census}
    for mode, flags, runs in (("replay", (), 1), ("dedup", ("--dedup",), 2)):
        glob = Server(Config(interval="10s"), device=DEVICE)
        imp = ImportServer(glob)
        try:
            imp.start_grpc("127.0.0.1:0")
            lines = [cli("--target", imp.address, *flags)
                     for _ in range(runs)]
            got = sink_scalars(glob.flush(now=SINKS_NOW))
        finally:
            imp.stop()
            glob.shutdown()
        if got != expected:
            raise AssertionError(f"phase 3d: the CLI's {mode} into a card "
                                 "global gave other counters and gauges "
                                 "than the flush")
        if flags and (imp.metrics_deduped != lines[1]["imported"]
                     or lines[0]["imported"] != lines[1]["imported"]):
            raise AssertionError(f"phase 3d: the CLI's dedup replay run "
                                 f"twice merged {imp.metrics_deduped} of "
                                 f"{lines[1]['imported']} twice")
        out[mode] = {"stats": lines, "deduped": imp.metrics_deduped}
    log(f"[tools] replay CLI over 15b's archive ({len(frames)} frames): "
        f"--inspect {census['importable']} importable, --target into a "
        f"global on {DEVICE}: {len(expected)} counters and gauges bitwise, "
        f"--dedup twice merged once ({out['dedup']['deduped']} deduped)")
    return out


# -- main ---------------------------------------------------------------------


# -- phase 17 -----------------------------------------------------------------


# 17a's floor rate and trial length; 17b's search (start, growth, trial
# and confirmation intervals, bisection steps); 17c's SSF share of LG_RATE.
# tools/port_bench_sustained.py sized the search on the card: up to 5
# growth trials bracket the cliff, each trial and bisection step takes
# about 8 s and each confirmation attempt 22 s (up to three, backing off
# 10% each), so 3 bisection steps and a retry took 115 s; one step leaves
# the found rate further from the cliff, where a confirmation holds.
# Growth 2.0 (a trial fewer than 1.6 over 200,000-1,600,000 lines/s) and
# 5 confirmation intervals keep the whole script inside its limit on a
# slower host
LG_RATE = 100_000
LG_INTERVALS = 3
LG_SEARCH = dict(start_rate=200_000.0, growth=2.0, trial_intervals=3,
                 bisect_steps=1, confirm_intervals=5)
LG_SSF_FRAC = 0.1
LG_BREAKDOWN = ("tick_block_ms_mean", "ingest_stall_ms_mean",
                "flush_ms_mean", "drain_ms_mean", "generate_ms_mean",
                "emit_ms_mean", "micro_folds_total")


def check_trial_books(harness, trial: dict, what: str) -> None:
    """Every sample the server took is in its lifetime tally, nothing
    was shed or mis-parsed, and the flushes emitted series."""
    st = harness.server.ingress_stats()
    if st["parse_errors"] or st["overload_dropped"] or trial["total_shed"]:
        raise AssertionError(f"{what}: parse errors {st['parse_errors']}, "
                             f"shed {st['overload_dropped']}")
    if trial["total_accepted"] <= 0 or harness.flushed_series <= 0:
        raise AssertionError(f"{what}: nothing accepted or flushed")
    if any(k not in st for k in ("flush_count", "last_tick_s",
                                 "micro_folds_total", "last_micro_folds")):
        raise AssertionError(f"{what}: ingress_stats lacks the cadence keys")


def phase_loadgen(ek, hll) -> tuple:
    """Phase 17: the port's server on the card driven at wire rate by
    the loadgen, with tools/port_bench_sustained.py's configuration and
    the dense set store (the spec's sets hold at most tag_cardinality
    members, under the staged store's promotion, so on the default
    store no set kernel runs). Returns (the phase's record, each part's
    launches)."""
    import port_bench_sustained as bench
    from veneur_tpu_torch.loadgen import (LoadHarness, WorkloadSpec,
                                          run_trial, search_sustained)
    from veneur_tpu_torch.loadgen.controller import result_artifact

    spec = WorkloadSpec()
    out: dict = {"rmem_max": bench.rmem_max(), "spec": spec.to_dict()}
    launches = {}
    t0 = time.perf_counter()
    harness = LoadHarness(bench.bench_config(set_store="dense"), spec,
                          device=DEVICE)
    try:
        out["ring"] = {"datagrams": len(harness.ring),
                       "lines": harness.ring.total_lines,
                       "bytes": harness.ring.total_bytes,
                       "content_hash": "%016x" % harness.ring.content_hash}
        if not harness.warmup():
            raise AssertionError("phase 17: the harness's warmup never "
                                 "saw three flushes on cadence")
        out["warmup_s"] = time.perf_counter() - t0
        # 17a: the floor rate
        reset_launches(ek, hll)
        # the native contexts' lock record (the reader's waits, Python's
        # holds) beside the collector's pauses: where a stall would show
        harness.server.set_lock_stats(True)
        try:
            with gc_pauses() as pauses:
                trial = run_trial(harness, LG_RATE, LG_INTERVALS)
            locks = lock_record(harness.server)
        finally:
            harness.server.set_lock_stats(False)
        launches["a"] = read_launches(ek, hll)
        out["a"] = {k: v for k, v in trial.items() if k != "intervals"}
        out["a"]["intervals"] = trial["intervals"]
        out["a"]["gc_pauses"] = pauses
        out["a"]["native_locks"] = locks
        if not trial["passed"]:
            raise AssertionError(
                f"phase 17a: {LG_RATE} lines/s not held: loss "
                f"{trial['loss_frac']}, cadence {trial['cadence_frac']}, "
                f"{trial['intervals_completed']} intervals; by interval "
                + "; ".join(
                    f"sent {i['sent_lines']} accepted {i['accepted_lines']}"
                    f" shed {i['shed_lines']} {i['duration_s']} s flush "
                    f"{i['flush_ms']} ms" for i in trial["intervals"])
                + f"; GC pauses {pauses}; native locks {locks}")
        check_trial_books(harness, trial, "phase 17a")
        for name in ("flush_extract", "hll_insert", "hll_estimate"):
            if launches["a"][name] < 1:
                raise AssertionError(f"phase 17a: {name} was not launched")
        log(f"[loadgen] 17a: {LG_RATE} lines/s for {LG_INTERVALS} "
            f"intervals: accepted {trial['accepted_lines_per_s']}/s, loss "
            f"{trial['loss_frac']}, cadence {trial['cadence_frac']}, "
            + ", ".join(f"{k} {trial[k]}" for k in LG_BREAKDOWN)
            + f"; GC pauses {pauses}; native locks {locks}; launches "
            f"{launches['a']}")
        out["a_s"] = time.perf_counter() - t0
        # 17b: the sustained-rate search on the same harness
        t1 = time.perf_counter()
        reset_launches(ek, hll)
        search = search_sustained(harness, **LG_SEARCH)
        launches["b"] = read_launches(ek, hll)
        res = result_artifact(spec, harness, search,
                              "cuda" if DEVICE != "cpu" else "cpu")
        out["b"] = res
        out["b_s"] = time.perf_counter() - t1
        confirm = search.get("confirm")
        if not search["search_trials"] or not confirm:
            raise AssertionError("phase 17b: the search ran no trial or "
                                 "has no confirmation record")
        log(f"[loadgen] 17b: rmem_max {out['rmem_max']}; sustained "
            f"{res['sustained_pipeline_lines_per_s']} lines/s accepted at "
            f"{res['sustained_offered_lines_per_s']} offered (confirmed "
            f"{res['confirmed']}, loss {res['loss_frac']}, cadence "
            f"{res['cadence_frac']}, {len(search['search_trials'])} "
            "trials); confirmation: "
            + ", ".join(f"{k} {confirm.get(k)}" for k in LG_BREAKDOWN)
            + f"; {out['b_s']:.1f} s; launches {launches['b']}")
        for t in search["search_trials"]:
            log(f"[loadgen] 17b trial {t['offered_lines_per_s']:.0f}: "
                f"accepted {t['accepted_lines_per_s']}, loss "
                f"{t['loss_frac']}, cadence {t['cadence_frac']}, "
                f"{'pass' if t['passed'] else 'fail'}")
    finally:
        harness.close()
    # 17c: statsd and SSF spans mixed, the span books exact
    t1 = time.perf_counter()
    harness = LoadHarness(bench.bench_config(set_store="dense", ssf=True),
                          spec, device=DEVICE, ssf_frac=LG_SSF_FRAC)
    try:
        reset_launches(ek, hll)
        trial = run_trial(harness, LG_RATE, LG_INTERVALS)
        launches["c"] = read_launches(ek, hll)
        books = bench.settled_conservation(harness)
        phases = harness.server.ingress_stats()["last_flush_phases"]
    finally:
        harness.close()
    out["c"] = {k: v for k, v in trial.items() if k != "intervals"}
    out["c"]["span_books"] = books
    out["c"]["last_flush_phases"] = phases
    out["c_s"] = time.perf_counter() - t1
    if trial["intervals_completed"] != LG_INTERVALS \
            or not books.get("balanced") \
            or trial.get("total_spans_received", 0) <= 0:
        raise AssertionError(f"phase 17c: span books {books} over "
                             f"{trial['intervals_completed']} intervals")
    log(f"[loadgen] 17c: {LG_RATE} lines/s with spans at "
        f"{LG_SSF_FRAC}: accepted {trial['accepted_lines_per_s']}/s, loss "
        f"{trial['loss_frac']}, spans sent {trial['total_spans_sent']} "
        f"received {trial['total_spans_received']}, cadence "
        f"{trial['cadence_frac']}; last flush "
        + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
        + f"; books {books}; launches {launches['c']}")
    return out, launches


def lock_record(server) -> list:
    """Each native context's commit-mutex record since
    ``set_lock_stats(True)``: acquisitions, contended ones, the wait and
    hold totals and the longest of the latest 4,096 of each, in ms."""
    out = []
    for w in server.workers:
        for ctx in w._all_ctxs():
            st = ctx.lock_stats()
            out.append({
                "acquisitions": st["acquisitions"],
                "contended": st["contended"],
                "wait_ms": st["wait_ns_total"] / 1e6,
                "wait_max_ms": max(st["wait_ns_samples"] or [0]) / 1e6,
                "hold_ms": st["hold_ns_total"] / 1e6,
                "hold_max_ms": max(st["hold_ns_samples"] or [0]) / 1e6})
    return out


@contextlib.contextmanager
def gc_pauses():
    """Yields a dict that, once the block ends, holds the count and the
    longest pause (s) of the collector's runs in it, by generation."""
    import gc

    got: dict = {}
    began = [0.0]

    def cb(phase: str, info: dict) -> None:
        if phase == "start":
            began[0] = time.perf_counter()
            return
        g = got.setdefault(f"gen{info['generation']}",
                           {"runs": 0, "max_s": 0.0})
        g["runs"] += 1
        g["max_s"] = max(g["max_s"], time.perf_counter() - began[0])

    gc.callbacks.append(cb)
    try:
        yield got
    finally:
        gc.callbacks.remove(cb)


def process_state() -> dict:
    """This process's live threads, its GC-tracked objects and the time
    one full collection takes now."""
    import gc
    import threading

    names = sorted(t.name for t in threading.enumerate())
    n_obj = len(gc.get_objects())
    t = time.perf_counter()
    gc.collect()
    return {"threads": len(names), "thread_names": names[:40],
            "gc_objects": n_obj,
            "full_collect_s": time.perf_counter() - t}


def phase_loadgen_child(timeout_s: float = 600.0) -> tuple:
    """Phase 17 in a process of its own: ``chip_smoke.py
    --loadgen-child`` writes the phase's record and its launches, each
    counted from 0 in that process, to a file under build/."""
    import subprocess

    state = process_state()
    log(f"[loadgen] this process before phase 17: {state['threads']} "
        f"threads alive, {state['gc_objects']} GC-tracked objects, a "
        f"full collection {state['full_collect_s']:.4f} s; phase 17 runs "
        "in a process of its own")
    path = ROOT / "build" / "chip_smoke_loadgen.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    rc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                         "--loadgen-child", str(path)], cwd=ROOT,
                        timeout=timeout_s).returncode
    if rc != 0:
        raise AssertionError(f"phase 17: its process exited {rc}")
    got = json.loads(path.read_text())
    got["out"]["parent_process"] = state
    return got["out"], got["launches"]


def reset_launches(ek, hll) -> None:
    from veneur_tpu_torch.core import worker as tw
    from veneur_tpu_torch.ops import tdigest as td

    ek.flush_extract.launches = 0
    for r in ek.variant_launches:
        ek.variant_launches[r] = 0
    hll.insert_batch.launches = hll.estimate.launches = 0
    td.compress_rows.launches = td.add_batch.launches = 0
    tw.fold_staged.launches = 0


def read_launches(ek, hll) -> dict:
    """Each kernel's launches since reset_launches, by kernels-line name."""
    from veneur_tpu_torch.core import worker as tw
    from veneur_tpu_torch.ops import tdigest as td

    return {"flush_extract": ek.flush_extract.launches,
            **{f"flush_extract_r{r}": n
               for r, n in ek.variant_launches.items()},
            "hll_insert": hll.insert_batch.launches,
            "hll_estimate": hll.estimate.launches,
            "tdigest_compress": td.compress_rows.launches,
            "tdigest_add_batch": td.add_batch.launches,
            "tdigest_fold_staged": tw.fold_staged.launches}


def td_launches() -> tuple[int, int, int]:
    """K2a's, K2b's and K3's launch counts now."""
    from veneur_tpu_torch.core import worker as tw
    from veneur_tpu_torch.ops import tdigest as td

    return (td.compress_rows.launches, td.add_batch.launches,
            tw.fold_staged.launches)


def check_td_launches(before: tuple, what: str) -> dict:
    """K2a's, K2b's and K3's launches since ``before``; raises unless the
    staged fold launched K3 and the spill folds K2b: a fold that quietly
    ran its plain version on the card fails the run. (The staged fold
    runs K2a's row routine inside K3; K2a's own launches are the import
    merges'.)"""
    a, b, k = td_launches()
    got = {"tdigest_compress_launches": a - before[0],
           "tdigest_add_batch_launches": b - before[1],
           "tdigest_fold_staged_launches": k - before[2]}
    if DEVICE == "cuda" and min(got["tdigest_add_batch_launches"],
                                got["tdigest_fold_staged_launches"]) < 1:
        raise AssertionError(f"{what}: the t-digest folds did not launch "
                             f"their kernels ({got})")
    return got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--loadgen-child", metavar="PATH",
                    help="run only phase 17 (the kernels already built) "
                         "and write its record and launches to PATH")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("CUDA is not available: the port's smoke test needs a card",
              file=sys.stderr)
        return 2
    if not (ROOT / "veneur_tpu_torch" / "csrc").is_dir():
        print("veneur_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    global probe, probe_hll, probe_td, guard_faults
    global analysis_tool, fuzz_tool, replay_tool
    import port_fuzz_differential as fuzz_tool
    import port_guard_faults as guard_faults
    import port_replay_archive as replay_tool
    import port_tdigest_analysis as analysis_tool
    import port_probe_extract as probe
    import port_probe_hll as probe_hll
    import port_probe_tdigest as probe_td

    global CARD
    card = CARD = probe.card_line()
    if args.loadgen_child:
        from veneur_tpu_torch.ops import extract_kernel as ek
        from veneur_tpu_torch.ops import hll, hll_kernel
        from veneur_tpu_torch.ops import tdigest_kernel as tk

        ek.load()
        hll_kernel.load()
        tk.load()
        out, launches = phase_loadgen(ek, hll)
        Path(args.loadgen_child).write_text(json.dumps(
            {"out": out, "launches": launches}))
        return 0

    # 1. setup
    log(f"[setup] card: {card}")
    log(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__}"
        f", cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from veneur_tpu_torch.core import worker as tw
    from veneur_tpu_torch.core.flusher import (device_quantiles,
                                               generate_inter_metrics)
    from veneur_tpu_torch.core.metrics import HistogramAggregates
    from veneur_tpu_torch.ops import extract_kernel as ek
    from veneur_tpu_torch.ops import hll, hll_kernel
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.ops import tdigest_kernel as tk
    from veneur_tpu_torch.protocol.dogstatsd import parse_metric
    from veneur_tpu_torch import native

    t_start = t0 = time.perf_counter()
    # one nvcc per kernel source and the g++ of the native library,
    # started together
    with ThreadPoolExecutor(max_workers=5) as pool:
        builds = [pool.submit(ek.build), pool.submit(hll_kernel.build),
                  pool.submit(tk.build), pool.submit(native.build),
                  pool.submit(native.build_loadgen)]
        lib_paths = [f.result() for f in builds]
    ek.load()
    hll_kernel.load()
    tk.load()
    if native.source_hash() != native.source_stamp() \
            or native.loadgen_source_hash() != native.loadgen_source_stamp():
        raise AssertionError("a native library's source stamp is not its "
                             "sources' hash")
    log(f"[setup] built and loaded "
        f"{', '.join(str(p.relative_to(ROOT)) for p in lib_paths)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for r, rep in sorted(ek.build_report().items()):
        log(f"[setup] ptxas flush_extract r{r}: " + ", ".join(
            f"{k} {v}" for k, v in rep.items()))
    wide_build = ek.build_report(wide=True)
    for r, rep in sorted(wide_build.items()):
        log(f"[setup] ptxas flush_extract wide r{r} (P > 16): " + ", ".join(
            f"{k} {v}" for k, v in rep.items()))
    hll_build = hll_kernel.build_report()
    for name, rep in sorted(hll_build.items()):
        log(f"[setup] ptxas {name}: " + ", ".join(
            f"{k} {v}" for k, v in rep.items()))
    td_build = tk.build_report()
    for name, rep in sorted(td_build.items()):
        log(f"[setup] ptxas {name}: " + ", ".join(
            f"{k} {v}" for k, v in rep.items()))
    wall = {"setup_s": time.perf_counter() - t_start}

    # 2. kernel vs plain, 3. the variant probe, 3b. the HLL kernels
    t0 = time.perf_counter()
    fields, qs3, plain_check, kres = phase_kernel_vs_plain(ek)
    wall["kernel_vs_plain_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    variants = probe.probe_variants(fields, qs3, plain_check)
    if not all(v["bitwise"] for v in variants):
        raise AssertionError("a variant is not bitwise equal to the plain "
                             "version")
    wide = probe.probe_wide(fields)
    if not all(all(v["bitwise"].values()) for v in wide):
        raise AssertionError("a wide kernel (P > 16) is not bitwise equal "
                             "to the plain version")
    yardstick = probe.read_yardstick(fields)
    del fields, plain_check
    wall["variant_probe_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hll_checks = {"hll_insert": probe_hll.check_insert(hll),
                  "hll_estimate": probe_hll.check_estimate(hll)}
    hll_times = probe_hll.time_kernels(hll)
    wall["hll_kernels_s"] = time.perf_counter() - t0
    # 3c. the t-digest folds (K2a, K2b)
    t0 = time.perf_counter()
    td_checks = {"tdigest_compress": probe_td.check_compress(td),
                 "tdigest_add_batch": probe_td.check_add(td),
                 "signed_zeros": probe_td.check_signed_zeros(td)}
    td_chain = probe_td.profile_chain(td)
    if DEVICE == "cuda" and td_chain["foreign"]:
        raise AssertionError(f"add_batch launched kernels not of "
                             f"tdigest.cu: {td_chain['foreign']}")
    td_times = probe_td.time_kernels(td, tk)
    wall["tdigest_kernels_s"] = time.perf_counter() - t0
    # 3c. K3, the staged fold (its seconds apart: this slice's addition)
    t0 = time.perf_counter()
    td_checks["tdigest_fold_staged"] = probe_td.check_fold_staged(tw)
    td_fold_trace = probe_td.profile_fold(tw)
    if DEVICE == "cuda" and (td_fold_trace["foreign"]
                             or td_fold_trace["kernels"] != 1):
        raise AssertionError(f"a staged fold on the card launched "
                             f"{td_fold_trace['names']}, not K3 alone")
    td_times["fold_staged"] = probe_td.time_fold_staged(tw)
    # K3's rank path: its edge rows against the CPU, the rows of
    # phase 4's shape by path, and td_fold_warps' registers and spill
    td_checks["tdigest_rank_cases"] = probe_td.check_rank_cases(tw, tk)
    td_times["fold_paths"] = probe_td.fold_paths(tw, tk)
    td_times["fold_ptxas"] = td_build.get("td_fold_warps", {})
    log("[tdigest] ptxas td_fold_warps: " + ", ".join(
        f"{k} {v}" for k, v in td_times["fold_ptxas"].items()))
    wall["tdigest_fold_staged_s"] = time.perf_counter() - t0
    log(f"[tdigest] K3's checks, trace and times added "
        f"{wall['tdigest_fold_staged_s']:.1f} s")
    # 3d: td.cdf, the t-digest analysis and the fuzz on the card (the
    # replay CLI's part runs in phase 15b, over its archive directory);
    # the fuzz's launches counted from 0 just before it
    t0 = time.perf_counter()
    tools_rec = {"cdf": phase_cdf(td), "analysis": phase_analysis(td)}
    reset_launches(ek, hll)
    tools_rec["fuzz"] = phase_fuzz()
    launches_fuzz = read_launches(ek, hll)
    for name in ("flush_extract", "tdigest_add_batch", "tdigest_fold_staged",
                 "hll_insert", "hll_estimate"):
        if launches_fuzz[name] < 1:
            raise AssertionError(f"{name} was not launched by the fuzz "
                                 "(phase 3d)")
    wall["tools_s"] = time.perf_counter() - t0

    # 4 + 5: the main path, launch counts reset just before
    aggs = HistogramAggregates.from_names(["min", "max", "count"])
    qs = device_quantiles(QS, aggs)

    def generate(snap):
        """A standalone server's InterMetrics for the snapshot."""
        return generate_inter_metrics(snap, False, QS, aggs, now=0)

    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases, plan, python_snap, cpu_snap = phase_worker(
        tw, generate, parse_metric, qs)
    wall["worker_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phases["dense_sets"] = phase_dense_sets(tw, parse_metric, hll)
    wall["dense_sets_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phases["native"], steps = phase_native(tw, ek, hll, qs, plan,
                                           python_snap)
    wall["native_s"] = time.perf_counter() - t0
    wall["server_s"] = wall["native_server_s"] = 0.0
    for spill in (False, True):
        t0 = time.perf_counter()
        server_grams, server_ref, server_tally, server_taken = \
            phase_server(ek, spill)
        wall["server_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_native_server(server_grams, server_ref, server_tally,
                            server_taken, spill)
        wall["native_server_s"] += time.perf_counter() - t0
    launches = read_launches(ek, hll)
    for name in ("flush_extract", "hll_insert", "hll_estimate",
                 "tdigest_fold_staged", "tdigest_add_batch"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the main "
                                 f"path")
    # 8: the egress of phase 4's snapshot (host work: no kernel runs)
    t0 = time.perf_counter()
    phases["egress"], batch, batch_c = phase_egress(python_snap, cpu_snap)
    del cpu_snap
    wall["egress_s"] = time.perf_counter() - t0
    # 15: the remaining sinks, the archive and the plugins: 15a over
    # phase 8's batches, 15b a server on the card; counted from 0
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["sinks"] = {"batch": phase_sinks_batch(batch, batch_c)}
    del batch, batch_c
    phases["sinks"]["server"] = phase_sinks_server(ek)
    tools_rec["replay_cli"] = phases["sinks"]["server"].pop("replay_cli")
    phases["tools"] = tools_rec
    cli_s = tools_rec["replay_cli"]["seconds"]
    wall["sinks_s"] = time.perf_counter() - t0 - cli_s
    wall["tools_s"] += cli_s
    log(f"[tools] phase 3d took {wall['tools_s']:.1f} s (the replay CLI's "
        f"{cli_s:.1f} s of it in phase 15b)")
    launches_sinks = read_launches(ek, hll)
    if launches_sinks["flush_extract"] < 1:
        raise AssertionError("flush_extract was not launched on the sinks' "
                             "path (phase 15)")
    # this slice's own paths, each counted from 0 just before its run
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["micro"] = phase_micro(tw, parse_metric, qs, plan, steps,
                                  python_snap, phases)
    wall["micro_s"] = time.perf_counter() - t0
    launches_micro = read_launches(ek, hll)
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["guard"] = phase_guard(tw, ek, hll, parse_metric, qs, plan,
                                  python_snap)
    launches_guard = read_launches(ek, hll)
    wall["guard_s"] = time.perf_counter() - t0
    # 14a: phase 4's interval through the governed (chunked) extraction,
    # counted from 0
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["governed"] = phase_governed(tw, ek, parse_metric, qs, plan,
                                        python_snap)
    wall["governed_s"] = time.perf_counter() - t0
    launches_governed = read_launches(ek, hll)
    # 16a: series shards, 16b: the mesh global, each counted from 0
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["series_shards"] = phase_series_shards(
        tw, ek, hll, parse_metric, generate, qs, plan, steps, python_snap,
        phases)
    del plan, python_snap
    wall["series_shards_s"] = time.perf_counter() - t0
    launches_series = read_launches(ek, hll)
    t0 = time.perf_counter()
    phases["mesh"], launches_mesh = phase_mesh(tw, ek, hll, parse_metric, qs)
    wall["mesh_s"] = time.perf_counter() - t0
    for name in ("flush_extract", "hll_insert", "hll_estimate"):
        if launches_series[name] < SERIES_SHARDS:
            raise AssertionError(f"{name} was not launched once per shard "
                                 "in phase 16a")
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["guard"].update(phase_real_faults())
    launches_guard_oom = read_launches(ek, hll)
    phases["guard"]["guard_cost"] = guard_cost()
    wall["guard_s"] += time.perf_counter() - t0
    # 9: reader shards, 10: the global tier, each counted from 0
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["shards"] = phase_shards(tw, generate, qs, steps)
    del steps
    wall["shards_s"] = time.perf_counter() - t0
    launches_shards = read_launches(ek, hll)
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["global"], keep = phase_global(parse_metric)
    wall["global_s"] = time.perf_counter() - t0
    launches_global = read_launches(ek, hll)
    if launches_global["tdigest_compress"] < 1:
        raise AssertionError("tdigest_compress was not launched by phase "
                             "10's import merge")
    # 12: the proxy tier against phase 10's gRPC global, counted from 0
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["proxy"] = phase_proxy(keep, ek, hll)
    del keep
    wall["proxy_s"] = time.perf_counter() - t0
    launches_proxy = read_launches(ek, hll)
    # 11: the SSF span path, counted from 0
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["spans"] = phase_spans(parse_metric)
    wall["spans_s"] = time.perf_counter() - t0
    launches_spans = read_launches(ek, hll)
    # 13: the live query path and tenancy, counted from 0
    reset_launches(ek, hll)
    t0 = time.perf_counter()
    phases["query"] = phase_query(tw, parse_metric, qs, aggs, ek)
    wall["query_s"] = time.perf_counter() - t0
    launches_query = read_launches(ek, hll)
    # 14b-d: the flush pipeline, overload and the lifecycle; 14b's
    # launches counted from 0
    t0 = time.perf_counter()
    phases["flush_ops"], launches_pipeline = phase_flush_ops(ek, hll)
    wall["flush_ops_s"] = time.perf_counter() - t0
    if launches_governed["flush_extract"] < GOV_MIN_CHUNKS \
            or launches_pipeline["flush_extract"] < PIPE_INTERVALS:
        raise AssertionError("flush_extract was not launched on the governed "
                             "or the pipelined path (phase 14)")
    if launches_query["flush_extract"] < 1:
        raise AssertionError("flush_extract was not launched on the query "
                             "path (phase 13)")
    for name in ("flush_extract", "hll_estimate"):
        for where, got in (("shards", launches_shards),
                           ("global", launches_global),
                           ("proxy", launches_proxy)):
            if got[name] < 1:
                raise AssertionError(f"{name} was not launched in phase "
                                     f"{where}")
    for name in ("flush_extract", "hll_insert", "hll_estimate"):
        if launches_spans[name] < 1:
            raise AssertionError(f"{name} was not launched on the span "
                                 "path (phase 11)")
    # 17: the load generator at wire rate, each part counted from 0
    t0 = time.perf_counter()
    phases["loadgen"], launches_loadgen = phase_loadgen_child()
    wall["loadgen_s"] = time.perf_counter() - t0

    def counts(name: str) -> dict:
        return {"launches": launches[name],
                "launches_micro": launches_micro[name],
                "launches_guard": launches_guard[name],
                "launches_guard_oom": launches_guard_oom[name],
                "launches_shards": launches_shards[name],
                "launches_global": launches_global[name],
                "launches_spans": launches_spans[name],
                "launches_proxy": launches_proxy[name],
                "launches_query": launches_query[name],
                "launches_governed": launches_governed[name],
                "launches_pipeline": launches_pipeline[name],
                "launches_sinks": launches_sinks[name],
                "launches_series": launches_series[name],
                "launches_mesh": launches_mesh[name],
                "launches_fuzz": launches_fuzz[name],
                "launches_loadgen": {part: got[name] for part, got
                                     in launches_loadgen.items()}}

    source = "veneur_tpu_torch/csrc/flush_extract.cu"
    kernels = {"kernels": [{
        "name": "flush_extract", "route": "cuda", "source": source,
        "replaces": "veneur_tpu/ops/pallas_kernels.py:36",
        **counts("flush_extract"), "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"], "plain_ms": kres["plain_ms"],
        "bound_ms": kres["bound_ms"], "bound_by": kres["bound_by"],
        "library_ms": None, "rows_per_warp": ek.ROWS_PER_WARP,
        "at_main_path": kres["at_main_path"],
        "wide": [{k: v for k, v in w.items() if k != "bitwise"}
                 for w in wide
                 if w["rows_per_warp"] == ek.ROWS_PER_WARP]}]}
    for v in variants:
        r = v["rows_per_warp"]
        kernels["kernels"].append({
            "name": f"flush_extract_r{r}", "route": "cuda",
            "source": source,
            "replaces": "tools/probe_pallas_variants.py:130",
            **counts(f"flush_extract_r{r}"),
            "max_abs_err": v["max_abs_err"],
            "ms": v["ms"], "plain_ms": kres["plain_ms"],
            "bound_ms": v["bound_ms"], "bound_by": v["bound_by"],
            "library_ms": None, "rows_per_warp": r,
            "bitwise": v["bitwise"], "build": v["build"],
            "wide": {k: x for w in wide if w["rows_per_warp"] == r
                     for k, x in w.items() if k != "bitwise"},
            **{k: v.get(k) for k in (
                "registers", "spill_stores", "spill_loads", "local_bytes",
                "static_smem_bytes", "dynamic_smem_bytes",
                "blocks_per_sm")}})
    for name, line in (("hll_insert", 73), ("hll_estimate", 126)):
        t = hll_times[name]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "veneur_tpu_torch/csrc/hll.cu",
            "replaces": f"veneur_tpu/ops/hll.py:{line}",
            **counts(name),
            "max_abs_err": hll_checks[name]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "build": hll_build.get(name, "no ptxas report"),
            **{k: t[k] for k in ("rows", "precision", "batch",
                                 "library_note", "noop_ms", "noop_grid",
                                 "ms_main_path", "ms_distinct", "ms_big",
                                 "big_batch", "bound_ms_big",
                                 "library_ms_big") if k in t}})
    for name, what, line in (
            ("tdigest_compress", "compress", 142),
            ("tdigest_add_batch", "add_batch", 224)):
        t = td_times[what]
        main_t = t[0] if what == "compress" else t[-1]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "veneur_tpu_torch/csrc/tdigest.cu",
            "replaces": f"veneur_tpu/ops/tdigest.py:{line}",
            **counts(name),
            "max_abs_err": td_checks[name]["max_abs_err"],
            "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
            "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes it",
            "at_shapes": t,
            **({"chain": td_chain, "signed_zeros": td_checks["signed_zeros"]}
               if what == "add_batch" else {}),
            **({"main_path_note": "phases 4 to 5b fold through K3, which "
                "runs K2a's row routine; K2a's own launches are the import "
                "merges' (launches_global) and the mesh's (launches_mesh)"}
               if what == "compress" else {}),
            "build": {k: v for k, v in td_build.items()
                      if k.startswith("td_compress") == (
                          what == "compress")
                      and not k.startswith(("td_fold", "td_stage"))}})
    main_t = td_times["fold_staged"][0]
    kernels["kernels"].append({
        "name": "tdigest_fold_staged", "route": "cuda",
        "source": "veneur_tpu_torch/csrc/tdigest.cu",
        "replaces": "veneur_tpu/core/worker.py:216",
        **counts("tdigest_fold_staged"),
        "max_abs_err": td_checks["tdigest_fold_staged"]["max_abs_err"],
        "ms": main_t["ms"], "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"], "bound_by": main_t["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes it",
        "also_replaces": "veneur_tpu/core/worker.py:245 (the staged fold "
                         "around _compress_rows)",
        "at_forms": td_times["fold_staged"], "trace": td_fold_trace,
        "row_paths": {"phase4": phases["governed"]["k3_paths"],
                      "phase3c": td_times["fold_paths"],
                      "rank_cases": td_checks["tdigest_rank_cases"]["paths"]},
        "build": {k: v for k, v in td_build.items()
                  if k.startswith(("td_fold", "td_stage"))}})
    wall["total_s"] = time.perf_counter() - t_start
    log("[timing] " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, **kernels, "worker": phases,
             "yardstick": yardstick, "wall_s": wall, **result},
            indent=1))
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
