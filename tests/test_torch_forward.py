"""The global tier's wire in the PyTorch port against the JAX package, on
the CPU: the forward codec, the forwarders, the import servers.

* The codec: ``snapshot_to_wire`` and ``snapshot_to_batch`` of a port
  local's snapshot are byte for byte a JAX local's on the same lines,
  through the native histogram encoder and the Python one; the native
  stream-frame, ack and dedup-envelope codecs equal the pinned Python
  references.
* End to end over gRPC (unary and streaming) and HTTP ``/import``: JAX
  local -> port global and port local -> JAX global against JAX -> JAX
  and port -> port, the locals forwarding one after another: every
  global snapshot array bitwise equal.
* A port local ``Server.flush`` forwards on its thread to a port global
  built by the factory from ``grpc_address``/``http_address``.
* The receiver: ``StreamCoalescer`` batching, dedup and fallback, the
  ``DedupWindow`` (replays, per-sender ids, eviction, byte cap,
  forgotten ids after a failed merge, ``forward_dedup: false``), the
  kind/value check of the native decode path.
* The import HTTP server's GET surface (``/healthcheck``, ``/version``,
  ``/builddate``, ``/debug/pprof``) answers as the JAX one does.
* ``POST /import`` is a traced hop: a forward carrying trace headers
  leaves a ``veneur.import`` span in the global's span pipeline, and the
  global's next two flushes (the import, the hop's span and each flush's
  own span derived) equal the JAX global's.
* The factory: the forwarder from one ``forward_address``, the import
  servers from their keys; a multi-destination ``forward_address`` and
  ``forward_discovery_file`` build the sharded proxy tier's
  ``SpreadForwarder``, and ``spill_journal_dir`` the spill journal, as
  in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.flusher import device_quantiles
from veneur_tpu.core.metrics import HistogramAggregates
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.distributed import codec as jcodec
from veneur_tpu.distributed import forward as jfwd
from veneur_tpu.distributed import import_server as jimp
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu.trace import opentracing as jot
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import Config as TConfig
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import UnportedConfigError, build_server
from veneur_tpu_torch.core.server import Server as TServer
from veneur_tpu_torch.distributed import codec as tcodec
from veneur_tpu_torch.distributed import forward as tfwd
from veneur_tpu_torch.distributed import import_server as timp
from veneur_tpu_torch.distributed import rpc as trpc
from veneur_tpu_torch.gen import veneur_tpu_pb2 as tpb
from veneur_tpu_torch.protocol import dogstatsd as tdog
from veneur_tpu_torch.trace import opentracing as tot

AGGS = HistogramAggregates.from_names(["min", "max", "count", "sum"])
PCTS = [0.5, 0.9, 0.99]
QS = device_quantiles(PCTS, AGGS)
P = 10


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype, a.shape,
                                                       b.shape)
    if a.dtype.kind == "f":
        assert np.array_equal(np.isnan(a), np.isnan(b)), what
        ok = ~np.isnan(a)
        a, b = a[ok], b[ok]
    assert a.tobytes() == b.tobytes(), what


def _snapshots_equal(a, b, what):
    for f in dataclasses.fields(a):
        if f.name in ("directory", "scalars"):
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, (what, f.name)
            _same(va, vb, (what, f.name))
        else:
            assert va == vb, (what, f.name, va, vb)
    for pool in ("histo", "sets"):
        rows = [[(r.key.name, r.key.type, r.key.joined_tags, list(r.tags),
                  int(r.scope_class)) for r in getattr(s.directory, pool).rows]
                for s in (a, b)]
        assert rows[0] == rows[1], (what, pool)
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        assert pa.used == pb.used, (what, pool)
        _same(pa.values[:pa.used], pb.values[:pb.used], (what, pool))


def _wait_until(pred, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _local_lines(host: int):
    """One local's interval: mixed-scope histograms and timers over a
    shared series space (forwarded), local-only ones (kept), global
    counters and gauges, mixed sets."""
    rng = np.random.default_rng(100 + host)
    out = []
    for i in range(240):
        k = i % 24
        kind = "ms" if k % 2 else "h"
        out.append(f"fw.lat{k}:{rng.gamma(2.0, 15.0):.4f}|{kind}|#a:{k % 3}")
        out.append(f"fw.only{k % 4}:{rng.normal(5, 1):.4f}|ms"
                   f"|#veneurlocalonly")
        out.append(f"fw.c{k % 5}:{1 + k % 3}|c|#veneurglobalonly")
        out.append(f"fw.g{k % 3}:{rng.normal():.5f}|g|#veneurglobalonly")
        out.append(f"fw.s{k % 6}:u{int(rng.integers(0, 500))}|s")
    return [ln.encode() for ln in out]


def _local_snapshots(host: int):
    """The same interval through a JAX local worker and the port's."""
    kw = dict(compression=100, stage_depth=16, batch_size=64,
              initial_histo_rows=8, initial_set_rows=8, is_local=True,
              hll_precision=P)
    jwk, twk = jw.DeviceWorker(**kw), tw.DeviceWorker(**kw, device="cpu")
    for line in _local_lines(host):
        jwk.process_metric(jdog.parse_metric(line))
        twk.process_metric(tdog.parse_metric(line))
    return jwk.flush(QS), twk.flush(QS)


def _histo_native_off(mod, monkeypatch):
    monkeypatch.setattr(mod, "_histo_wire_native", lambda *a: None)


# -- the codec -------------------------------------------------------------


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_snapshot_wire_bytes_equal(native, monkeypatch):
    js, ts = _local_snapshots(0)
    if not native:
        _histo_native_off(jcodec, monkeypatch)
        _histo_native_off(tcodec, monkeypatch)
    jb, jn = jcodec.snapshot_to_wire(js, 100.0, P)
    tb, tn = tcodec.snapshot_to_wire(ts, 100.0, P)
    assert jn == tn and jn > 24
    assert jb == tb
    assert (jcodec.snapshot_to_batch(js, 100.0, P).SerializeToString()
            == tcodec.snapshot_to_batch(ts, 100.0, P).SerializeToString())


def test_native_and_python_histogram_encoders_agree(monkeypatch):
    _, ts = _local_snapshots(1)
    nb, nn = tcodec.snapshot_to_wire(ts, 100.0, P)
    _histo_native_off(tcodec, monkeypatch)
    pb_, pn = tcodec.snapshot_to_wire(ts, 100.0, P)
    assert nn == pn
    a = sorted(m.SerializeToString()
               for m in tpb.MetricBatch.FromString(nb).metrics)
    b = sorted(m.SerializeToString()
               for m in tpb.MetricBatch.FromString(pb_).metrics)
    assert a == b


def test_codec_native_python_parity():
    c = tcodec
    assert c._native_codec() is not None
    for seq in (0, 1, 2**32, 2**63, 2**64 - 1):
        for body in (b"", b"x", b"\x00\xff" * 200):
            frame = c.encode_stream_frame(seq, body)
            assert frame == c.encode_stream_frame_py(seq, body)
            assert frame == jcodec.encode_stream_frame_py(seq, body)
            assert c.decode_stream_frame(frame) == (seq, body)
    for status in (True, False, 0, 1, 2, 255):
        ack = c.encode_stream_ack(9, status)
        assert ack == c.encode_stream_ack_py(9, status)
        assert c.decode_stream_ack(ack) == c.decode_stream_ack_py(ack)
    for sender in ("s", 'quo"te\\slash', "unié中\U0001f600", "ctl\x01\x1f"):
        for did, cnt in ((1, 1), (0, 0), (2**63 - 1, 7), (-(2**63), 3)):
            env = c.encode_dedup_envelope(sender, did, cnt, b"BODY")
            assert env == c.encode_dedup_envelope_py(sender, did, cnt,
                                                     b"BODY")
            assert env == jcodec.encode_dedup_envelope_py(sender, did, cnt,
                                                          b"BODY")
            assert c.decode_dedup_envelope(env) == ((sender, did, cnt),
                                                    b"BODY")
    env = c.encode_dedup_envelope("s", 2**64, 1, b"B")
    assert env == c.encode_dedup_envelope_py("s", 2**64, 1, b"B")
    assert c.decode_dedup_envelope(b"nope") == (None, b"nope")
    for blob in (b"nope", b"VSF1\x00", b"VDE1\xff\xff", b""):
        for fn in (c.decode_stream_frame, c.decode_stream_frame_py,
                   c.decode_stream_ack, c.decode_stream_ack_py):
            with pytest.raises(ValueError):
                fn(blob)
    for blob in (b"VDE1\xff\xff", b"VDE1\x05\x00abc", b"VDE1\x02\x00{}"):
        with pytest.raises(ValueError):
            c.decode_dedup_envelope(blob)


# -- end to end ------------------------------------------------------------


def _global(pkg):
    if pkg == "jax":
        srv = JServer(JConfig(interval="10s", percentiles=PCTS,
                              num_workers=2, tpu_hll_precision=P))
        imp = jimp.ImportServer(srv)
        http = jimp.ImportHTTPServer(imp)
    else:
        srv = TServer(TConfig(interval="10s", percentiles=PCTS,
                              num_workers=2, tpu_hll_precision=P),
                      device="cpu")
        imp = timp.ImportServer(srv)
        http = timp.ImportHTTPServer(imp)
    grpc_port = imp.start_grpc("127.0.0.1:0")
    http_port = http.start("127.0.0.1", 0)
    return srv, imp, http, grpc_port, http_port


def _forwarder(pkg, transport, grpc_port, http_port):
    mod = jfwd if pkg == "jax" else tfwd
    if transport == "http":
        return mod.HTTPForwarder(f"http://127.0.0.1:{http_port}", 10.0,
                                 100.0, P)
    return mod.GRPCForwarder(f"127.0.0.1:{grpc_port}", 10.0, 100.0, P,
                             streaming=(transport == "stream"))


def _run(sender, receiver, transport, snaps):
    """Forward each local's snapshot in turn (the next send starts when
    the global counted the last), then flush the global's workers."""
    srv, imp, http, gport, hport = _global(receiver)
    fwd = _forwarder(sender, transport, gport, hport)
    try:
        expect = 0
        for snap in snaps:
            n = (jcodec if sender == "jax" else tcodec).snapshot_to_wire(
                snap, 100.0, P)[1]
            expect += n
            fwd([snap])
            assert _wait_until(lambda: imp.received_metrics >= expect)
        assert imp.received_metrics == expect and imp.import_errors == 0
        out = []
        for w, lock in zip(srv.workers, srv._worker_locks):
            with lock:
                out.append(w.flush(QS, 10.0))
        return out
    finally:
        if hasattr(fwd, "close"):
            fwd.close()
        http.stop()
        imp.stop()


@pytest.mark.parametrize("transport", ["grpc", "stream", "http"])
def test_cross_package_forward_equals_jax(transport):
    locals_ = [_local_snapshots(h) for h in range(3)]
    jsnaps = [j for j, _ in locals_]
    tsnaps = [t for _, t in locals_]
    ref = _run("jax", "jax", transport, jsnaps)
    for sender, receiver, snaps in (("jax", "port", jsnaps),
                                    ("port", "jax", tsnaps),
                                    ("port", "port", tsnaps)):
        got = _run(sender, receiver, transport, snaps)
        for i, (a, b) in enumerate(zip(ref, got)):
            _snapshots_equal(a, b, (sender, receiver, transport, i))
    assert ref[0].directory.num_histo_rows + ref[1].directory.num_histo_rows \
        == 24


def test_port_local_server_forwards_on_flush():
    """Factory-built: a port global with grpc_address and http_address,
    a port local with a single forward_address, streaming gRPC."""
    g = build_server(tload(data={
        "interval": "10s", "percentiles": PCTS, "num_workers": 1,
        "tpu_hll_precision": P, "grpc_address": "127.0.0.1:0",
        "http_address": "127.0.0.1:0"}), device="cpu")
    try:
        assert g.import_server is not None and g.import_http is not None
        assert g.forward_stats() is None
        local = build_server(tload(data={
            "interval": "10s", "percentiles": PCTS, "num_workers": 1,
            "tpu_hll_precision": P, "forward_use_grpc": True,
            "forward_address": f"127.0.0.1:{g.import_server.port}"}),
            device="cpu")
        try:
            assert isinstance(local.forwarder, tfwd.GRPCForwarder)
            assert local.is_local and not g.is_local
            for line in _local_lines(0):
                local.process_metric_packet(line)
            local.flush(now=1_700_000_000)
            local._forward_thread.join(20)
            assert not local._forward_thread.is_alive()
            fs = local.forward_stats()
            dest = fs["destinations"][f"127.0.0.1:{g.import_server.port}"]
            assert dest["sent_metrics"] > 24 and dest["errors"]["send"] == 0
            assert _wait_until(lambda: g.import_server.received_metrics
                               == dest["sent_metrics"])
        finally:
            local.shutdown()
        snap = g.workers[0].flush(QS, 10.0)
        assert snap.directory.num_histo_rows == 24
        # the HTTP face answers too
        with urllib.request.urlopen(
                f"http://127.0.0.1:{g.import_http.port}/healthcheck",
                timeout=5) as r:
            assert r.status == 200
    finally:
        g.shutdown()


# -- the receiver ------------------------------------------------------------


def _counter_batch(n, name="imp", start=0):
    batch = tpb.MetricBatch()
    for i in range(start, start + n):
        m = batch.metrics.add()
        m.name = f"{name}{i}"
        m.kind = tpb.KIND_COUNTER
        m.scope = tpb.SCOPE_GLOBAL
        m.counter.value = 1
    return batch


def _wrap(batch, sender="proxy-a", did=1):
    return tcodec.encode_dedup_envelope(sender, did, len(batch.metrics),
                                        batch.SerializeToString())


def _imp(**kw):
    kw.setdefault("interval", "10s")
    kw.setdefault("num_workers", 2)
    srv = TServer(TConfig(**kw), device="cpu")
    return srv, timp.ImportServer(srv)


def test_wire_replay_is_rejected_and_counted():
    _, imp = _imp()
    blob = _wrap(_counter_batch(4), did=7)
    assert imp.handle_wire(blob) == 4
    assert imp.handle_wire(blob) == 4
    assert imp.received_metrics == 4 and imp.metrics_deduped == 4
    st = imp.stats()
    assert st["dedup"]["hits"] == 1 and st["dedup"]["inserts"] == 1


def test_headerless_and_per_sender_ids():
    _, imp = _imp()
    blob = _counter_batch(3).SerializeToString()
    assert imp.handle_wire(blob) == 3
    assert imp.handle_wire(blob) == 3
    assert imp.received_metrics == 6
    assert imp.handle_wire(_wrap(_counter_batch(1), sender="p1", did=1)) == 1
    assert imp.handle_wire(_wrap(_counter_batch(1), sender="p2", did=1)) == 1
    assert imp.received_metrics == 8 and imp.metrics_deduped == 0


def test_window_eviction_and_forgotten_ids():
    _, imp = _imp(forward_dedup_window_ids=2)
    b = _counter_batch(1)
    for did in (1, 2, 3):
        imp.handle_wire(_wrap(b, did=did))
    st = imp.stats()["dedup"]
    assert st["evictions"] == 1 and st["window_ids"] == 2
    imp.handle_wire(_wrap(b, did=1))
    assert imp.received_metrics == 4 and imp.metrics_deduped == 0
    bad = tcodec.encode_dedup_envelope("s", 9, 1, b"\xff\xff\xff garbage")
    with pytest.raises(Exception):
        imp.handle_wire(bad)
    assert imp.handle_wire(_wrap(b, sender="s", did=9)) == 1


def test_forward_dedup_off_and_bytes_cap():
    _, imp = _imp(forward_dedup=False)
    blob = _wrap(_counter_batch(2), did=5)
    assert imp.handle_wire(blob) == 2 and imp.handle_wire(blob) == 2
    assert imp.received_metrics == 4 and imp.metrics_deduped == 0
    w = timp.DedupWindow(max_ids=1000, max_bytes=3 * (100 + 6))
    for did in range(5):
        assert not w.seen_or_insert("sender", did)
    assert w.stats()["window_ids"] == 3 and w.stats()["evictions"] == 2
    assert w.seen_or_insert("sender", 2)
    assert not w.seen_or_insert("sender", 5)
    assert w.seen_or_insert("sender", 2)


def test_handle_wire_rejects_kind_value_mismatch():
    srv, imp = _imp()
    batch = _counter_batch(1, name="legit")
    evil = batch.metrics.add()
    evil.name = "evil"
    evil.kind = tpb.KIND_SET
    evil.scope = tpb.SCOPE_MIXED
    evil.counter.value = 999
    imp.handle_wire(batch.SerializeToString())
    assert imp.received_metrics == 1 and imp.import_errors == 1
    vals = [w.scalars.counter_values.tolist() for w in srv.workers]
    assert sorted(sum(vals, [])) == [1.0]


class _StubImport:
    dedup_enabled = True

    def __init__(self):
        self.dedup = timp.DedupWindow()
        self.applied = []
        self.deduped = 0
        self.fail_blobs = set()

    def _apply_wire(self, blob):
        if blob in self.fail_blobs:
            raise ValueError("poisoned")
        self.applied.append(blob)
        return 1

    def note_deduped(self, n):
        self.deduped += n


def test_coalescer_batches_dedups_and_falls_back():
    env = tcodec.encode_dedup_envelope
    imp = _StubImport()
    co = timp.StreamCoalescer(imp, max_frames=3, auto_flush=False)
    acks = []
    try:
        co.submit(env("sender-a", 1, 1, b"B1"), acks.append)
        co.submit(env("sender-b", 7, 1, b"B7"), acks.append)
        assert acks == []
        co.submit(env("sender-a", 2, 1, b"B2"), acks.append)
        assert acks == [True, True, True]
        assert imp.applied == [b"B1B7B2"]
        assert co.stats()["batches"] == 1
    finally:
        co.close()
    imp = _StubImport()
    co = timp.StreamCoalescer(imp, max_frames=2, auto_flush=False)
    acks = []
    try:
        body = env("s", 42, 3, b"X")
        co.submit(body, acks.append)
        co.submit(body, acks.append)
        assert acks == [True, True]
        assert imp.applied == [b"X"] and imp.deduped == 3
    finally:
        co.close()
    imp = _StubImport()
    imp.fail_blobs = {b"GOODBAD", b"BAD"}
    co = timp.StreamCoalescer(imp, max_frames=2, auto_flush=False)
    acks = []
    try:
        co.submit(env("s", 1, 1, b"GOOD"), acks.append)
        co.submit(env("s", 2, 1, b"BAD"), acks.append)
        assert acks == [True, False]
        assert imp.applied == [b"GOOD"]
        assert not imp.dedup.seen_or_insert("s", 2)
        assert co.stats()["batch_fallbacks"] == 1
    finally:
        co.close()


def test_streaming_client_to_streaming_server():
    _, imp = _imp()
    port = imp.start_grpc("127.0.0.1:0")
    client = trpc.ForwardClient(f"127.0.0.1:{port}", timeout_s=5.0,
                                streaming=True, stream_window=8)
    try:
        for i in range(20):
            client.send_raw_or_raise(
                _counter_batch(1, name=f"s.c{i}").SerializeToString(), 1)
        assert _wait_until(lambda: imp.received_metrics >= 20)
        s = client.stats()["stream"]
        assert s["opened"] == 1 and s["acked_total"] == 20
        assert not s["downgraded"]
        assert imp.stats()["stream"]["frames"] >= 20
    finally:
        client.close()
        imp.stop()


# -- the HTTP API ------------------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=5) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_import_http_get_surface_equals_jax():
    """GET /healthcheck, /version, /builddate, /debug/pprof and an
    unknown path: the same status codes from both packages' import HTTP
    servers, the same bodies but the thread dump's."""
    jsrv = JServer(JConfig(interval="10s"))
    tsrv = TServer(TConfig(interval="10s"), device="cpu")
    jh = jimp.ImportHTTPServer(jimp.ImportServer(jsrv))
    th = timp.ImportHTTPServer(timp.ImportServer(tsrv))
    jp, tp = jh.start(), th.start()
    try:
        for path in ("/healthcheck", "/healthcheck/tracing", "/version",
                     "/builddate", "/debug/pprof", "/debug/pprof/goroutine",
                     "/nope"):
            (jc, jb), (tc, tb) = _get(jp, path), _get(tp, path)
            assert jc == tc, path
            if path.startswith("/debug/pprof"):
                assert tc == 200 and b"Thread" in tb, tb[:200]
            else:
                assert jb == tb, path
    finally:
        jh.stop()
        th.stop()


def test_http_import_hop_is_traced_as_jax():
    jsnap, tsnap = _local_snapshots(0)
    outs = []
    for pkg, snap in (("jax", jsnap), ("port", tsnap)):
        cfg_cls, srv_cls, mod, fmod, kw = (
            (JConfig, JServer, jimp, jfwd, {}) if pkg == "jax"
            else (TConfig, TServer, timp, tfwd, {"device": "cpu"}))
        srv = srv_cls(cfg_cls(interval="10s", percentiles=PCTS,
                              num_workers=2, tpu_hll_precision=P,
                              ssf_span_uniqueness_rate=1.0), **kw)
        imp = mod.ImportServer(srv)
        http = mod.ImportHTTPServer(imp)
        port = http.start("127.0.0.1", 0)
        tracer = (jot if pkg == "jax" else tot).Tracer(service="local")
        fwd = fmod.HTTPForwarder(f"http://127.0.0.1:{port}", 10.0, 100.0,
                                 P, tracer=tracer)
        try:
            fwd([snap])
            assert fwd.errors == 0 and imp.received_metrics > 0
            # the hop's span finishes after the response is written
            assert _wait_until(lambda: srv.ssf_spans_received_total == 1)
            outs.append([sorted((m.name, m.value, tuple(m.tags))
                                for m in srv.flush(now=1_700_000_000 + k))
                         for k in range(2)])
        finally:
            http.stop()
            imp.stop()
            srv.shutdown()
    assert outs[0] == outs[1]
    # the hop's span (a child of the forward's) in the first flush, the
    # first flush's own (a root) in the second
    assert [[m[2] for m in o if m[0] == "ssf.names_unique"]
            for o in outs[1]] == [
        [("indicator:false", "root_span:false", "service:veneur-tpu")],
        [("indicator:false", "root_span:true", "service:veneur-tpu")]]


# -- the factory -------------------------------------------------------------


@pytest.mark.parametrize("key,value", [
    ("forward_address", "127.0.0.1:9,127.0.0.1:10"),
    ("forward_discovery_file", "/nonexistent"),
    ("spill_journal_dir", "/nonexistent"),
])
def test_fleet_forwarding_and_journal_refused_by_name(key, value, tmp_path):
    """The proxy tier's keys, refused until the proxy tier was ported,
    now build what the JAX factory builds: a SpreadForwarder for a
    comma-separated ``forward_address`` or ``forward_discovery_file``,
    and the spill journal (attached at ``start()``) for
    ``spill_journal_dir``. The keys still unported stay refused."""
    from veneur_tpu.core.factory import build_server as jbuild
    from veneur_tpu.core.config import load_config as jload

    if key == "spill_journal_dir":
        value = str(tmp_path / "wal")
    data = {"interval": "10s", "forward_use_grpc": True, key: value}
    built = [jbuild(jload(data=data)),
             build_server(tload(data=data), device="cpu")]
    try:
        kinds = [type(s.forwarder).__name__ for s in built]
        assert kinds[0] == kinds[1]
        assert kinds[1] == ("NoneType" if key == "spill_journal_dir"
                            else "SpreadForwarder")
        assert built[1].config.spill_journal_dir == (
            value if key == "spill_journal_dir" else "")
    finally:
        for s in built:
            s.shutdown()
    with pytest.raises(UnportedConfigError, match="series_shards"):
        build_server(tload(data={**data, "series_shards": 2}), device="cpu")


@pytest.mark.parametrize("data,cls", [
    ({"forward_address": "http://127.0.0.1:9"}, "HTTPForwarder"),
    ({"forward_address": "127.0.0.1:9", "forward_use_grpc": True},
     "GRPCForwarder"),
    ({"forward_address": "127.0.0.1:9", "forward_use_grpc": True,
      "forward_format": "forwardrpc"}, "CompatForwarder"),
    ({"forward_address": "http://127.0.0.1:9",
      "forward_format": "jsonmetric"}, "HTTPForwarder"),
])
def test_factory_builds_the_forwarder(data, cls):
    srv = build_server(tload(data={"interval": "10s", **data}), device="cpu")
    try:
        assert type(srv.forwarder).__name__ == cls
        assert srv.is_local and srv.import_server is None
    finally:
        srv.shutdown()


def test_forward_past_4_mib_lands_on_a_port_global():
    """One local's flush is one gRPC message. The JAX package's import
    server keeps gRPC's 4 MiB receive limit, so a local with 16,384
    forwarded histogram series (about 6.5 MB) is refused there; the
    port's takes it (rpc.MAX_MESSAGE_BYTES)."""
    s = 16_384
    w = tw.DeviceWorker(device="cpu", is_local=True, hll_precision=P)
    for i in range(s):
        w.process_metric(tdog.parse_metric(
            f"big.lat.{i}:1.5|ms|#shard:{i % 16}".encode()))
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(s), 39).astype(np.int32)
    rng.shuffle(rows)
    vals = rng.gamma(2.0, 20.0, len(rows)).astype(np.float32)
    for i in range(0, len(rows), 16_384):
        w._device_histo_step(rows[i:i + 16_384], vals[i:i + 16_384],
                             np.ones(len(vals[i:i + 16_384]), np.float32))
    snap = w.flush(QS)
    blob, n = tcodec.snapshot_to_wire(snap, 100.0, P)
    assert n == s and len(blob) > 4 << 20
    for pkg in ("port", "jax"):
        srv, imp, http, gport, _ = _global(pkg)
        fwd = tfwd.GRPCForwarder(f"127.0.0.1:{gport}", 20.0, 100.0, P)
        try:
            fwd([snap])
            if pkg == "port":
                assert _wait_until(lambda: imp.received_metrics == s)
                assert fwd.client.last_error_cause is None
            else:
                # RESOURCE_EXHAUSTED: unary counts it as "send", a
                # stream's reset as "unavailable"
                assert fwd.client.last_error_cause in ("send",
                                                       "unavailable")
                assert imp.received_metrics == 0
        finally:
            fwd.close()
            http.stop()
            imp.stop()
