"""The port's network fault wrappers (veneur_tpu_torch/utils/faults.py)
against the JAX package's, on the CPU.

* ``FaultyOpener``, ``FaultySocket`` and ``FaultyStreamSink`` built from
  the same seeded ``FaultPlan`` give the JAX wrappers' outcome sequence:
  each call's result or exception type, the sleeps they asked for, what
  reached the inner sink or socket, and the injection tallies.
* tests/test_delivery.py's seeded-fault cases on the port: one seed one
  sequence, down-range overrides, a slow response past the timeout, and
  conservation through a port ``DeliveryManager`` (whose books equal the
  JAX manager's under the same plan).
* tests/test_stream_forward.py's scripted-congestion cases over the
  port's gRPC stream: a busy storm collapses the adaptive window and
  clean acks regrow it; with adaptive off the window stays pinned; a
  stream torn mid-collapse and replayed merges each frame once.
"""

from __future__ import annotations

import time

import pytest

from veneur_tpu.sinks import delivery as jdelivery
from veneur_tpu.utils import faults as jfaults
from veneur_tpu_torch.core.config import Config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.distributed import codec, rpc
from veneur_tpu_torch.distributed.import_server import (ImportServer,
                                                        StreamCoalescer)
from veneur_tpu_torch.gen import veneur_tpu_pb2 as pb
from veneur_tpu_torch.sinks import delivery as tdelivery
from veneur_tpu_torch.utils import faults as tfaults

PLANS = {
    "mixed": dict(seed=42, p_refuse=0.2, p_5xx=0.2, p_slow=0.1,
                  p_reset=0.1, p_reject=0.1, slow_s=0.0),
    "down_ranges": dict(seed=1, down_ranges=[(2, 5)]),
    "slow_past_timeout": dict(seed=0, p_slow=1.0, slow_s=5.0),
    "slow_within_timeout": dict(seed=3, p_slow=0.5, slow_s=0.25),
    "duplicates": dict(seed=9, p_refuse=0.1, p_duplicate=0.3),
    "congestion": dict(seed=5, busy_ranges=[(3, 7)],
                       ack_delay_ranges=[(9, 12)], ack_delay_s=0.5),
}


def _outcomes(call, n: int) -> list:
    out = []
    for i in range(n):
        try:
            got = call(i)
            out.append(("ok", got))
        except Exception as e:  # the sequence records what was raised
            out.append((type(e).__name__, getattr(e, "status", None)))
    return out


class _Recorder:
    """An inner opener or socket that records what reached it."""

    def __init__(self):
        self.seen = []
        self.timeouts = []

    def __call__(self, req, timeout):
        self.seen.append(req)
        return b"body-%d" % len(self.seen)

    def send(self, data):
        self.seen.append(data)
        return len(data)

    def sendall(self, data):
        self.seen.append(data)

    def settimeout(self, timeout):
        self.timeouts.append(timeout)


def _run_opener(mod, plan_kw, n=200, timeout=1.0):
    slept, inner = [], _Recorder()
    op = mod.FaultyOpener(mod.FaultPlan(**plan_kw), inner=inner,
                          sleep_fn=slept.append)
    seq = _outcomes(lambda i: op(b"req-%d" % i, timeout), n)
    return seq, slept, inner.seen, dict(op.injected), op.calls


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_faulty_opener_sequence_equals_jax(plan):
    assert _run_opener(tfaults, PLANS[plan]) == \
        _run_opener(jfaults, PLANS[plan])


def _run_socket(mod, plan_kw, n=200, timeout=1.0, use_sendall=False):
    slept, inner = [], _Recorder()
    sock = mod.FaultySocket(mod.FaultPlan(**plan_kw), inner=inner,
                            sleep_fn=slept.append)
    sock.settimeout(timeout)
    send = sock.sendall if use_sendall else sock.send
    seq = _outcomes(lambda i: send(b"line-%d\n" % i), n)
    return (seq, slept, inner.seen, inner.timeouts, dict(sock.injected),
            sock.calls)


@pytest.mark.parametrize("use_sendall", [False, True],
                         ids=["send", "sendall"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_faulty_socket_sequence_equals_jax(plan, use_sendall):
    assert _run_socket(tfaults, PLANS[plan], use_sendall=use_sendall) == \
        _run_socket(jfaults, PLANS[plan], use_sendall=use_sendall)


def test_faulty_socket_degrades_http_kinds_to_reset():
    """No HTTP on a raw socket: 5xx and rejection surface as resets,
    tallied under their own kinds; clean traffic without an inner socket
    is discarded."""
    sock = tfaults.FaultySocket(tfaults.FaultPlan(seed=2, p_5xx=0.5,
                                                  p_reject=0.5))
    kinds = {k for k, _ in _outcomes(lambda i: sock.send(b"x"), 40)}
    assert kinds == {"ConnectionResetError"}
    assert sock.injected["http_5xx"] + sock.injected["rejected"] == 40
    assert tfaults.FaultySocket(tfaults.FaultPlan()).send(b"abc") == 3


class _AckSink:
    def __init__(self):
        self.taken = []

    def submit(self, body, done):
        self.taken.append(body)
        done(True)

    def stats(self):
        return {"taken": len(self.taken)}


def _run_stream_sink(mod, plan_kw, n=20):
    slept, inner, acks = [], _AckSink(), []
    sink = mod.FaultyStreamSink(mod.FaultPlan(**plan_kw), inner,
                                sleep_fn=slept.append)
    for i in range(n):
        sink.submit(b"frame-%d" % i, acks.append)
    return acks, slept, inner.taken, sink.stats(), sink.frames


@pytest.mark.parametrize("plan", ["congestion", "mixed"])
def test_faulty_stream_sink_sequence_equals_jax(plan):
    got = _run_stream_sink(tfaults, PLANS[plan])
    assert got == _run_stream_sink(jfaults, PLANS[plan])
    if plan == "congestion":
        acks = got[0]
        assert acks.count(codec.STREAM_ACK_BUSY) == 4
        assert got[1] == [0.5] * 3


# -- tests/test_delivery.py's seeded-fault cases on the port ------------------


def test_faulty_opener_is_deterministic_per_seed():
    plan = tfaults.FaultPlan(**PLANS["mixed"])
    runs = []
    for _ in range(2):
        op = tfaults.FaultyOpener(plan, sleep_fn=lambda s: None)
        kinds = [k for k, _ in _outcomes(lambda i: op(None, 1.0), 200)]
        runs.append((kinds, dict(op.injected)))
    assert runs[0] == runs[1]
    for kind in ("refused", "http_5xx", "reset", "rejected", "passed"):
        assert runs[0][1][kind] > 0, kind


def test_faulty_opener_down_ranges_override():
    op = tfaults.FaultyOpener(tfaults.FaultPlan(seed=1,
                                                down_ranges=[(2, 5)]))
    outcomes = [k for k, _ in _outcomes(lambda i: op(None, 1.0), 7)]
    assert outcomes == ["ok", "ok"] + ["ConnectionRefusedError"] * 3 + [
        "ok", "ok"]


def test_faulty_opener_slow_past_timeout_raises():
    slept = []
    op = tfaults.FaultyOpener(tfaults.FaultPlan(seed=0, p_slow=1.0,
                                                slow_s=5.0),
                              sleep_fn=slept.append)
    with pytest.raises(TimeoutError):
        op(None, 0.5)
    assert slept == [0.5]  # a real socket times out after exactly timeout


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def time(self):
        return self.t

    def sleep(self, s):
        self.t += s


class _MaxRng:
    def uniform(self, a, b):
        return b


def _conservation_run(fmod, dmod) -> tuple:
    plan = fmod.FaultPlan(seed=7, p_refuse=0.15, p_5xx=0.15, p_reset=0.1,
                          p_reject=0.1, slow_s=0.0)
    op = fmod.FaultyOpener(plan, sleep_fn=lambda s: None)
    clock = _FakeClock()
    mgr = dmod.DeliveryManager(
        "chaos",
        dmod.DeliveryPolicy(retry_max=1, breaker_threshold=3,
                            deadline_s=10.0, backoff_base_s=0.01,
                            spill_max_payloads=8, spill_max_bytes=1 << 16),
        time_fn=clock.time, sleep_fn=clock.sleep, rng=_MaxRng())
    delivered = [0]
    for i in range(300):
        if i % 10 == 0:
            mgr.begin_flush()
            mgr.retry_spill()

        def send(timeout):
            op(None, timeout)
            delivered[0] += 1
        mgr.deliver(send, 20)
    return mgr, delivered[0], dict(op.injected)


def test_conservation_under_seeded_faults():
    """Every payload pushed through a port DeliveryManager fed by a
    FaultyOpener is delivered, declared dropped, or in the bounded spill
    — exactly; the books equal the JAX manager's under the same seed."""
    mgr, delivered, injected = _conservation_run(tfaults, tdelivery)
    assert mgr.conserved()
    s = mgr.stats()
    assert s["delivered_payloads"] == delivered
    assert s["delivered_payloads"] > 0 and s["dropped_payloads"] > 0
    assert s["retries"] > 0
    jmgr, jdelivered, jinjected = _conservation_run(jfaults, jdelivery)
    assert (s, delivered, injected) == (jmgr.stats(), jdelivered, jinjected)


# -- tests/test_stream_forward.py's congestion cases on the port --------------


def _send_retrying(client, blob, deadline_s=10.0):
    end = time.time() + deadline_s
    while True:
        try:
            client.send_raw_or_raise(blob, 1)
            return
        except rpc.ForwardError as e:
            if not e.transient or time.time() >= end:
                raise
            time.sleep(0.05)


def _wait_until(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def test_adaptive_window_collapses_to_min_and_recovers():
    """A scripted busy storm halves the port client's window to the
    floor; clean acks afterwards grow it back."""
    sink = tfaults.FaultyStreamSink(
        tfaults.FaultPlan(busy_ranges=[(30, 42)]), _AckSink())
    srv, port = rpc.make_server(None, raw_handler=None, compat=False,
                                stream_sink=sink)
    client = rpc.ForwardClient(f"127.0.0.1:{port}", timeout_s=5.0,
                               streaming=True, stream_window=8,
                               stream_window_min=1, stream_window_max=16)
    try:
        adaptive = rpc.stream_adaptive_enabled(True)
        for i in range(30):
            client.send_raw_or_raise(b"frame-%d" % i, 1)
        grown = client.stats()["stream"]["window_current"]
        assert grown > 8 if adaptive else grown == 8
        _send_retrying(client, b"storm")
        s = client.stats()["stream"]
        if adaptive:
            assert s["window_min_seen"] == 1
            assert s["shrink_events"] >= 4
            assert s["window_current"] <= 2
        else:
            assert s["window_min_seen"] == 8 and s["shrink_events"] == 0
        for i in range(80):
            client.send_raw_or_raise(b"rec-%d" % i, 1)
        s = client.stats()["stream"]
        assert s["window_current"] >= grown
        assert s["window_max_seen"] <= 16
        assert client.stream_reconnects == 0
        assert sink.injected["busy"] == 12
    finally:
        client.close()
        srv.stop(0)


def test_adaptive_off_pins_fixed_window():
    sink = tfaults.FaultyStreamSink(
        tfaults.FaultPlan(busy_ranges=[(2, 5)]), _AckSink())
    srv, port = rpc.make_server(None, raw_handler=None, compat=False,
                                stream_sink=sink)
    client = rpc.ForwardClient(f"127.0.0.1:{port}", timeout_s=5.0,
                               streaming=True, stream_window=8,
                               stream_adaptive=False)
    try:
        for i in range(2):
            client.send_raw_or_raise(b"a-%d" % i, 1)
        _send_retrying(client, b"storm")
        for i in range(10):
            client.send_raw_or_raise(b"b-%d" % i, 1)
        s = client.stats()["stream"]
        assert s["adaptive"] is False
        assert s["window_current"] == 8
        assert s["window_min_seen"] == 8 and s["window_max_seen"] == 8
        assert s["shrink_events"] == 0
        assert client.errors["busy"] >= 1
        assert sink.injected["busy"] == 3
    finally:
        client.close()
        srv.stop(0)


def _counter_blob(name: str, value: int = 1, tags=()) -> bytes:
    batch = pb.MetricBatch()
    m = batch.metrics.add()
    m.name = name
    m.tags.extend(tags)
    m.kind = pb.KIND_COUNTER
    m.scope = pb.SCOPE_GLOBAL
    m.counter.value = value
    return batch.SerializeToString()


def test_duplicates_zero_across_reconnect_mid_collapse():
    """A busy storm collapses the window, the stream tears mid-collapse,
    and the replayed tail under its dedup keys merges exactly once."""
    gsrv = Server(Config(interval="10s", percentiles=[0.5],
                         num_workers=2), device="cpu")
    imp = ImportServer(gsrv)
    imp._coalescer = tfaults.FaultyStreamSink(
        tfaults.FaultPlan(busy_ranges=[(4, 10)]), StreamCoalescer(imp))
    port = imp.start_grpc()
    addr = f"127.0.0.1:{port}"
    client = rpc.ForwardClient(addr, timeout_s=2.0, streaming=True,
                               stream_window=8, stream_window_min=1)
    bodies = {
        i: codec.encode_dedup_envelope(
            "sender-a", i, 1, _counter_blob("mc.c", 1, (f"id:{i}",)))
        for i in range(1, 6)}
    try:
        for i in range(1, 5):
            client.send_raw_or_raise(bodies[i], 1)
        _send_retrying(client, bodies[5])
        assert _wait_until(lambda: imp.received_metrics >= 5)
        if rpc.stream_adaptive_enabled(True):
            s = client.stats()["stream"]
            assert s["shrink_events"] >= 3 and s["window_min_seen"] == 1
        imp.stop(grace=0)
        with pytest.raises(rpc.ForwardError) as ei:
            client.send_raw_or_raise(bodies[5], 1)
        assert ei.value.transient
        imp.start_grpc(addr)
        for i in range(1, 6):
            _send_retrying(client, bodies[i])
        assert _wait_until(lambda: imp.metrics_deduped >= 5)
        time.sleep(0.1)
        assert imp.received_metrics == 5
        assert client.stream_reconnects >= 1
    finally:
        client.close()
        imp.stop()
        gsrv.shutdown()
