"""F8: ``test_torch_loadgen.py::test_harness_trial_loses_nothing`` failing
in a run of the whole suite with 6 workers on 8 cores. Its causes, each
held here without timing:

* A CPU server's compute threads ran torch's ops on an OpenMP team as
  wide as the host. A flush's fold is hundreds of small ops; each
  parallel region waits for its whole team, and with the cores held by
  the other workers a team thread is often parked, so a flush of 0.1-0.2
  s of CPU took 0.5-2.5 s and the trial missed its cadence. The compute
  threads now take one intra-op thread each (device.serial_host_thread).
* A full collection over the test worker's heap took 1.9-2.9 s inside a
  flush. The server keeps what the process held at its start out of the
  collector's passes (gc.freeze) until shutdown, and no collection runs
  while Python holds a native context's lock (native.collector_paused),
  where the C++ reader would wait behind it.
* Lines the C++ reader commits while a flush's swap sits between its
  count of the epoch's lines and the native context's lock, or while a
  Python-path sample's ``processed += 1`` sat between its read and its
  write of the native count.
* A sample the server derives from its own flush spans
  (``ssf.names_unique``, at ``ssf_span_uniqueness_rate``) counted as one
  more than the trial sent: the test's configuration sets that rate to
  0 (test_torch_loadgen.py).

The native reader commits into the worker's context under the context's
own mutex, not under the worker lock the swap holds. The swap drains,
detaches and resets the context under that mutex; a count of the
epoch's lines taken before it misses every line committed in between:
those lines are drained into the swapped epoch (the flush has them) and
the reset then zeroes the context's count, so the server's lifetime
``samples_processed`` never includes them. Under load (a GIL switch, a
collection, a descheduled flush thread between the count and the lock)
that is what made ``test_torch_loadgen.py::test_harness_trial_loses_nothing``
see fewer lines processed than sent.

Here the window is held open deterministically: the swap's lock call
first commits a datagram into the context through the same C++ commit
path a reader takes (``NativeIngest.ingest``), then takes the lock.
Every line must be counted once, in the epoch that flushed it.
"""

from __future__ import annotations

import gc
import threading
import time

import pytest
import torch

from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.protocol import dogstatsd as tdog
from veneur_tpu_torch.sinks.channel import ChannelMetricSink as TChannel

NOW = 1_700_000_000
# no sample derived from the server's own flush spans: the counts hold
# only the lines ingested here
BASE = {"interval": "10s", "percentiles": [0.5], "num_workers": 1,
        "tpu_native_ingest": True, "tpu_native_readers": False,
        "ssf_span_uniqueness_rate": 0.0}


def _lines(prefix: bytes, n: int, kind: bytes) -> bytes:
    return b"\n".join(b"%s.%d:%d|%s" % (prefix, i % 7, i, kind)
                      for i in range(n))


def _late_commit(monkeypatch, ctx, datagram: bytes) -> dict:
    """Arm every swap so that its first lock call on ``ctx`` commits
    ``datagram`` into it (as a reader thread would) before locking."""
    state = {"armed": False, "fired": 0, "accepted": 0}
    lock, swap = tnative.NativeIngest.lock, tw.DeviceWorker.swap

    def late_lock(self):
        if state["armed"] and self is ctx:
            state["armed"] = False
            state["accepted"] += self.ingest(datagram)
            state["fired"] += 1
        lock(self)

    def armed_swap(self, quantiles):
        state["armed"] = True
        return swap(self, quantiles)

    monkeypatch.setattr(tnative.NativeIngest, "lock", late_lock)
    monkeypatch.setattr(tw.DeviceWorker, "swap", armed_swap)
    return state


@pytest.mark.parametrize("kind", [b"h", b"ms", b"c"])
def test_swap_counts_a_commit_before_its_lock(monkeypatch, kind):
    """37 lines committed between the swap's count and its lock: the
    flush has them, and samples_processed counts them once (counted
    before the lock, 50 of the 87 lines were counted, for good)."""
    server = build_server(tload(data=BASE), extra_metric_sinks=[TChannel()],
                          device="cpu")
    try:
        assert server.native_mode and not server.workers[0]._reader_ctxs
        server.process_metric_packet(_lines(b"f8.early", 50, kind))
        state = _late_commit(monkeypatch, server.workers[0]._native,
                             _lines(b"f8.late", 37, kind))
        metrics = server.flush(now=NOW)
        assert state["fired"] == 1 and state["accepted"] == 37
        late = [m for m in metrics if m.name.startswith("f8.late")]
        if kind == b"c":
            assert sum(m.value for m in late) == sum(range(37))
        else:
            assert sum(m.value for m in late
                       if m.name.endswith(".count")) == 37
        assert server.ingress_stats()["samples_processed"] == 87
        # the next epoch counts its own lines, and nothing twice
        server.process_metric_packet(_lines(b"f8.next", 5, kind))
        server.flush(now=NOW + 10)
        assert state["fired"] == 2 and state["accepted"] == 74
        assert server.ingress_stats()["samples_processed"] == 87 + 5 + 37
    finally:
        server.shutdown()


def test_cpu_compute_threads_take_one_intra_op_thread(monkeypatch):
    """The flush ticker of a CPU server runs its flushes on one intra-op
    thread (not on the host's count); the thread that built the server
    keeps its own count, and a thread started while the server runs, or
    after it, takes torch's default as before."""
    own = torch.get_num_threads()
    seen = []
    flush = Server.flush

    def counted(self, *a, **kw):
        seen.append(torch.get_num_threads())
        return flush(self, *a, **kw)

    def fresh_count() -> int:
        got = []
        t = threading.Thread(target=lambda: got.append(
            torch.get_num_threads()))
        t.start()
        t.join()
        return got[0]

    monkeypatch.setattr(Server, "flush", counted)
    server = build_server(tload(data={**BASE, "interval": "0.05s"}),
                          extra_metric_sinks=[TChannel()], device="cpu")
    server.start()
    try:
        deadline = time.time() + 60
        while len(seen) < 2 and time.time() < deadline:
            time.sleep(0.02)
        during = fresh_count()
    finally:
        server.shutdown()
    assert len(seen) >= 2 and set(seen) == {1}, seen
    assert torch.get_num_threads() == own
    assert during == own
    assert fresh_count() == own


def test_no_collection_inside_a_native_lock_hold(monkeypatch):
    """Every hold of a native context's lock (the series sync, the
    drain, the swap's drain, detach and reset) runs with the collector
    paused, and the collector runs again after it."""
    enabled = []
    lock = tnative.NativeIngest.lock

    def seen_lock(self):
        enabled.append(gc.isenabled())
        lock(self)

    monkeypatch.setattr(tnative.NativeIngest, "lock", seen_lock)
    assert gc.isenabled()
    server = build_server(tload(data=BASE), extra_metric_sinks=[TChannel()],
                          device="cpu")
    try:
        worker = server.workers[0]
        server.process_metric_packet(_lines(b"f8.gc", 40, b"h"))
        worker.sync_native_series()
        worker.drain_native()
        server.flush(now=NOW)
    finally:
        server.shutdown()
    assert len(enabled) >= 3 and not any(enabled), enabled
    assert gc.isenabled()


def test_server_keeps_its_start_heap_out_of_collections():
    """A started server freezes what the process holds (gc.freeze), and
    its shutdown unfreezes it."""
    server = build_server(tload(data={**BASE, "interval": "1s"}),
                          extra_metric_sinks=[TChannel()], device="cpu")
    try:
        server.start()
        assert gc.get_freeze_count() > 0
    finally:
        server.shutdown()
    assert gc.get_freeze_count() == 0


def test_heap_stays_frozen_until_the_last_server_shuts_down():
    """Two servers in one process: the first one's shutdown leaves the
    heap frozen for the second, whose shutdown unfreezes it."""
    cfg = {**BASE, "interval": "1s"}
    first = build_server(tload(data=cfg), extra_metric_sinks=[TChannel()],
                         device="cpu")
    second = build_server(tload(data=cfg), extra_metric_sinks=[TChannel()],
                          device="cpu")
    try:
        first.start()
        second.start()
        first.shutdown()
        first.shutdown()  # a second shutdown releases nothing more
        assert gc.get_freeze_count() > 0
    finally:
        first.shutdown()
        second.shutdown()
    assert gc.get_freeze_count() == 0


def test_python_path_count_keeps_native_commits(monkeypatch):
    """A Python-path sample counted while the reader commits 37 lines
    into the native context: all 50 + 37 + 1 are counted (a count that
    read the native total and wrote it back lost the 37 committed
    between its read and its write)."""
    server = build_server(tload(data=BASE), extra_metric_sinks=[TChannel()],
                          device="cpu")
    try:
        worker = server.workers[0]
        ctx = worker._native
        server.process_metric_packet(_lines(b"f8.early", 50, b"c"))
        late = _lines(b"f8.late", 37, b"c")
        armed = {"on": True}
        real = tnative.NativeIngest.processed

        def processed(self):
            n = real.fget(self)
            if armed["on"] and self is ctx:
                armed["on"] = False
                self.ingest(late)
            return n

        monkeypatch.setattr(tnative.NativeIngest, "processed",
                            property(processed))
        worker.process_metric(tdog.parse_metric(b"f8.py:1|c"))
        if armed["on"]:
            # the count read no native total: the reader commits now
            armed["on"] = False
            ctx.ingest(late)
        assert worker.processed == 50 + 37 + 1
    finally:
        server.shutdown()
