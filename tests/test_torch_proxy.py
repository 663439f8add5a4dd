"""The proxy tier of the PyTorch port against the JAX package, on the CPU.

* The consistent ring: placement of 10,000 keys (``get`` and the
  vectorized ``owners_for_hashes``), each ``RingChange`` (version,
  joined and departed members, moved hash ranges) and the version over a
  scripted sequence of membership changes, equal to the JAX ring's.
* ``_route_wire``: the fragments a port proxy hands each destination for
  a seeded local batch are byte for byte the JAX proxy's, with the dedup
  envelope off and on, and each metric sits on the destination the
  Python ring names for it.
* Three locals -> a proxy -> two globals, port against JAX: each
  global's snapshot bitwise, its forward-statsd sink's bytes equal, and
  the two port globals' rows together bitwise a one-global run's.
* The HTTP proxy's ``POST /import`` split, ``TraceProxy`` destinations
  by trace id (framed SSF and Datadog JSON), the runtime reporter's
  deltas, and ``proxy_main -validate-config`` exit codes: equal to the
  JAX package's.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import json
import socket
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from veneur_tpu.core import worker as jw
from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.factory import build_server as jbuild
from veneur_tpu.core.flusher import device_quantiles
from veneur_tpu.core.metrics import HistogramAggregates
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu_torch.core import worker as tw
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server as tbuild
from veneur_tpu_torch.protocol import dogstatsd as tdog

AGGS = HistogramAggregates.from_names(["min", "max", "count", "sum"])
PCTS = [0.5, 0.9, 0.99]
QS = device_quantiles(PCTS, AGGS)
P = 10
NOW = 1_700_000_000
ROOTS = {"jax": "veneur_tpu", "port": "veneur_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _wait_until(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# -- the ring ----------------------------------------------------------------


MEMBERSHIP = [
    ("set", ["g-a:1", "g-b:1", "g-c:1"]),
    ("add", "g-d:1"),
    ("remove", "g-b:1"),
    ("add", "g-d:1"),          # no change: None, no version bump
    ("set", ["g-x:1", "g-a:1", "g-y:1"]),
    ("set", []),
    ("set", ["g-a:1"]),
]


def _ring_trace(pkg: str, keys: list[str]) -> list:
    ring_mod = mod(pkg, "distributed.ring")
    ring = ring_mod.ConsistentRing()
    hashes = np.array([ring_mod.ConsistentRing._hash(k) for k in keys],
                      np.uint64)
    out = []
    for op, arg in MEMBERSHIP:
        if op == "set":
            change = ring.set_members(arg, cause="scripted")
        else:
            change = getattr(ring, op)(arg)
        rec = {"version": ring.version, "members": ring.members(),
               "change": None if change is None else (
                   change.version, sorted(change.added),
                   sorted(change.removed), change.moved_ranges,
                   change.moved_fraction())}
        if len(ring):
            owners = [ring.get(k) for k in keys]
            assert owners == ring.owners_for_hashes(hashes)
            rec["owners"] = owners
            if change is not None:
                rec["moved"] = [change.owner_changed(int(h))
                                for h in hashes[:500]]
        out.append(rec)
    return out


def test_ring_placement_changes_and_versions_equal_jax():
    keys = [f"series.{i}h,shard:{i % 17}" for i in range(10_000)]
    jt, tt = _ring_trace("jax", keys), _ring_trace("port", keys)
    assert jt == tt
    # a join moves about a quarter of the keys, a leave only the
    # departed member's; the versions count the mutations
    a, b = tt[0]["owners"], tt[1]["owners"]
    moved = sum(x != y for x, y in zip(a, b))
    assert 0 < moved < len(keys) // 2
    assert all(y == "g-d:1" for x, y in zip(a, b) if x != y)
    c = tt[2]["owners"]
    assert all(x == "g-b:1" for x, y in zip(b, c) if x != y)
    assert [r["version"] for r in tt] == [1, 2, 3, 3, 4, 5, 6]
    assert tt[3]["change"] is None


# -- wire routing --------------------------------------------------------------


def _local_lines(host: int, n: int = 120):
    """One local's interval: mixed-scope histograms and timers, global
    counters and gauges, mixed sets, all over a series space every local
    shares."""
    rng = np.random.default_rng(300 + host)
    out = []
    for i in range(n):
        k = i % 48
        kind = "ms" if k % 2 else "h"
        out.append(f"px.lat{k}:{rng.gamma(2.0, 15.0):.4f}|{kind}|#a:{k % 3}")
        out.append(f"px.c{k % 7}:{1 + k % 3}|c|#veneurglobalonly")
        out.append(f"px.g{k % 5}:{rng.normal():.5f}|g|#veneurglobalonly")
        out.append(f"px.s{k % 9}:u{int(rng.integers(0, 400))}|s")
    return [ln.encode() for ln in out]


def _local_snapshots(host: int):
    kw = dict(compression=100, stage_depth=16, batch_size=64,
              initial_histo_rows=8, initial_set_rows=8, is_local=True,
              hll_precision=P)
    jwk, twk = jw.DeviceWorker(**kw), tw.DeviceWorker(**kw, device="cpu")
    for line in _local_lines(host):
        jwk.process_metric(jdog.parse_metric(line))
        twk.process_metric(tdog.parse_metric(line))
    return {"jax": jwk.flush(QS), "port": twk.flush(QS)}


class _CaptureConn:
    def __init__(self, dest, sent):
        self.dest, self.sent = dest, sent

    def send_raw_or_raise(self, blob, count, timeout_s=None):
        self.sent.append((self.dest, bytes(blob), count))

    def stats(self):
        return {"address": self.dest, "errors": {}}

    def close(self):
        pass


def _route(pkg: str, blob: bytes, dests, dedup: bool):
    proxy_mod = mod(pkg, "distributed.proxy")
    sent: list = []
    proxy = proxy_mod.ProxyServer(
        dests, handoff_window_s=60.0, dedup=dedup, dedup_sender="sender",
        client_factory=lambda d, t, i: _CaptureConn(d, sent))
    try:
        proxy._route_wire(blob)
        stats = proxy.forward_stats()
        return sent, stats["proxied_metrics"], stats["dedup"]["minted"], \
            proxy.conserved()
    finally:
        proxy.stop()


@pytest.mark.parametrize("dedup", [False, True], ids=["plain", "dedup"])
def test_route_wire_fragments_byte_equal_jax(dedup):
    snaps = _local_snapshots(0)
    blobs = {pkg: mod(pkg, "distributed.codec").snapshot_to_wire(
        snaps[pkg], 100.0, P) for pkg in ROOTS}
    assert blobs["jax"] == blobs["port"]
    blob, n = blobs["port"]
    dests = ["g-a:1", "g-b:1", "g-c:1"]
    jsent, jn, jm, jok = _route("jax", blob, dests, dedup)
    tsent, tn, tm, tok = _route("port", blob, dests, dedup)
    assert tsent == jsent and (tn, tm, tok) == (jn, jm, jok)
    assert tn == n and tok and len({d for d, _, _ in tsent}) == 3
    assert tm == (3 if dedup else 0)
    # each metric on the destination the Python ring names for it
    tcodec = mod("port", "distributed.codec")
    ring = mod("port", "distributed.ring").ConsistentRing(dests)
    pb = mod("port", "gen.veneur_tpu_pb2")
    total = 0
    for dest, payload, count in tsent:
        if dedup:
            key, payload = tcodec.decode_dedup_envelope(payload)
            assert key[0] == "sender" and key[2] == count
        batch = pb.MetricBatch.FromString(payload)
        assert len(batch.metrics) == count
        total += count
        for m in batch.metrics:
            assert ring.get(tcodec.metric_key(m).key_string()) == dest
    assert total == n


def test_route_wire_undecodable_body_drop_counted_as_jax():
    for pkg in ROOTS:
        sent: list = []
        proxy = mod(pkg, "distributed.proxy").ProxyServer(
            ["g-a:1", "g-b:1"],
            client_factory=lambda d, t, i: _CaptureConn(d, sent))
        try:
            proxy._route_wire(b"\xfd\x17\xf4\xb7")
            proxy._route_wire(b"")
            assert proxy.drops == 1 and sent == [], pkg
        finally:
            proxy.stop()


# -- locals -> proxy -> globals ----------------------------------------------


class _CaptureSock:
    """Stands in for a forward-statsd sink's TCP socket."""

    def __init__(self):
        self.data = bytearray()

    def settimeout(self, t):
        pass

    def sendall(self, b):
        self.data += b

    def close(self):
        pass


def _global(pkg: str):
    data = {"interval": "1h", "percentiles": PCTS,
            "aggregates": ["min", "max", "count", "sum"], "num_workers": 2,
            "tpu_hll_precision": P, "hostname": "g",
            "ssf_span_uniqueness_rate": 0.0, "grpc_address": "127.0.0.1:0",
            "forward_statsd_address": "127.0.0.1:9",
            "forward_statsd_network": "tcp"}
    if pkg == "jax":
        srv = jbuild(jload(data=data))
    else:
        srv = tbuild(tload(data=data), device="cpu")
    sock = _CaptureSock()
    for sink in srv.metric_sinks:
        if sink.name() == "forward_statsd":
            sink._sock = sock
    return srv, sock


def _flush_global(srv, sock):
    snaps = []
    for w in srv.workers:
        def wrapped(*a, _orig=w.extract_snapshot, **k):
            snap = _orig(*a, **k)
            snaps.append(snap)
            return snap
        w.extract_snapshot = wrapped
    srv.flush(now=NOW)
    return snaps, bytes(sock.data)


def _tier(pkg: str, snaps, n_globals: int, via_proxy: bool):
    """Forward each local snapshot in turn over gRPC streaming, through a
    proxy or straight to one global; wait until every metric of a local
    is delivered before the next; then flush the globals."""
    globals_ = [_global(pkg) for _ in range(n_globals)]
    # ring members are names, the same in both packages; each maps to
    # its global's ephemeral port
    addrs = [f"global-{i}:1" for i in range(n_globals)]
    real = {a: f"127.0.0.1:{g.import_server.port}"
            for a, (g, _) in zip(addrs, globals_)}
    codec = mod(pkg, "distributed.codec")
    rpc = mod(pkg, "distributed.rpc")
    proxy = None
    if via_proxy:
        proxy = mod(pkg, "distributed.proxy").ProxyServer(
            addrs, handoff_window_s=30.0,
            client_factory=lambda d, t, i: rpc.ForwardClient(real[d], t))
        target = f"127.0.0.1:{proxy.start_grpc()}"
    else:
        target = real[addrs[0]]
    fwd = mod(pkg, "distributed.forward").GRPCForwarder(
        target, 10.0, 100.0, P, streaming=True)
    try:
        expect = 0
        for snap in snaps:
            expect += codec.snapshot_to_wire(snap, 100.0, P)[1]
            fwd([snap])
            assert _wait_until(lambda: sum(
                g.import_server.received_metrics
                for g, _ in globals_) == expect and (
                    proxy is None or proxy.proxied_metrics == expect))
        received = [g.import_server.received_metrics for g, _ in globals_]
        outs = [_flush_global(g, sock) for g, sock in globals_]
        stats = None if proxy is None else {
            k: proxy.forward_stats()[k] for k in (
                "proxied_metrics", "drops", "spilled_metrics",
                "ring_version", "ring_members")}
        if proxy is not None:
            assert proxy.conserved()
        return outs, received, addrs, stats
    finally:
        fwd.close()
        if proxy is not None:
            proxy.stop()
        for g, _ in globals_:
            g.shutdown()


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
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
        rows = [[(r.key.name, r.key.type, r.key.joined_tags,
                  int(r.scope_class)) for r in getattr(s.directory, pool).rows]
                for s in (a, b)]
        assert rows[0] == rows[1], (what, pool)
    for pool in ("counters", "gauges"):
        pa, pb = getattr(a.scalars, pool), getattr(b.scalars, pool)
        assert [m[0].key_string() for m in pa.meta[:pa.used]] == \
            [m[0].key_string() for m in pb.meta[:pb.used]], (what, pool)
        _same(pa.values[:pa.used], pb.values[:pb.used], (what, pool))


HISTO_FIELDS = ("quantile_values", "dmin", "dmax", "dsum", "dcount",
                "drecip", "lmin", "lmax", "lsum", "lweight", "lrecip",
                "digest_means", "digest_weights")


def rows_by_series(snap) -> dict:
    """Each series of a snapshot, keyed by its ring key: the bytes of its
    histogram row (every extracted array), set estimate or scalar
    value."""
    out = {}
    for i, r in enumerate(snap.directory.histo.rows):
        out[r.key.key_string()] = tuple(
            getattr(snap, f)[i].tobytes() for f in HISTO_FIELDS
            if getattr(snap, f) is not None)
    for i, r in enumerate(snap.directory.sets.rows):
        out[r.key.key_string()] = snap.set_estimates[i].tobytes()
    for pool in (snap.scalars.counters, snap.scalars.gauges):
        for i, meta in enumerate(pool.meta[:pool.used]):
            out[meta[0].key_string()] = pool.values[i].tobytes()
    return out


def test_three_locals_proxy_two_globals_equal_jax_and_one_global():
    locals_ = [_local_snapshots(h) for h in range(3)]
    runs = {pkg: _tier(pkg, [s[pkg] for s in locals_], 2, True)
            for pkg in ROOTS}
    (jouts, jrecv, _, jstats), (touts, trecv, addrs, tstats) = \
        runs["jax"], runs["port"]
    assert trecv == jrecv and all(trecv) and tstats == jstats
    assert tstats["drops"] == 0 and tstats["spilled_metrics"] == 0
    for gi, ((js, jbytes), (ts, tbytes)) in enumerate(zip(jouts, touts)):
        assert len(js) == len(ts) == 2
        for wi, (a, b) in enumerate(zip(js, ts)):
            _snapshots_equal(a, b, ("global", gi, "worker", wi))
        assert tbytes == jbytes and tbytes, gi
    # every series on the global the ring names; the union of the two
    # globals bitwise a single global fed the same locals directly
    ring = mod("port", "distributed.ring").ConsistentRing(addrs)
    union: dict = {}
    lines: list = []
    for addr, (snaps, sink) in zip(addrs, touts):
        for snap in snaps:
            for key, row in rows_by_series(snap).items():
                assert ring.get(key) == addr, key
                assert key not in union, key
                union[key] = row
        lines += sink.splitlines()
    (one, one_sink), = _tier("port", [s["port"] for s in locals_], 1,
                             False)[0]
    single: dict = {}
    for snap in one:
        single.update(rows_by_series(snap))
    assert union.keys() == single.keys() and len(union) > 60
    for key in single:
        assert union[key] == single[key], key
    assert sorted(lines) == sorted(one_sink.splitlines()) and lines


# -- the HTTP proxy and the trace proxy ----------------------------------------


def _http_import_split(pkg: str, bodies):
    proxy_mod = mod(pkg, "distributed.proxy")
    sent: list = []
    lock = threading.Lock()

    class Conn(_CaptureConn):
        def send_or_raise(self, batch, timeout_s=None):
            with lock:
                self.sent.append((self.dest, batch.SerializeToString(),
                                  len(batch.metrics)))

    proxy = proxy_mod.ProxyServer(
        ["g-a:1", "g-b:1"], routing_workers=1, handoff_window_s=60.0,
        client_factory=lambda d, t, i: Conn(d, sent))
    front = proxy_mod.ProxyHTTPServer(proxy)
    port = front.start()
    codes = []
    try:
        expect = 0
        for body, enc, n in bodies:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/import", data=body,
                headers={"Content-Encoding": enc} if enc else {})
            try:
                with urllib.request.urlopen(req, timeout=10) as r:
                    codes.append(r.status)
                expect += n
            except urllib.error.HTTPError as e:
                codes.append(e.code)
            assert _wait_until(lambda: proxy.proxied_metrics == expect)
        return codes, sent, proxy.proxied_metrics, proxy.drops
    finally:
        front.stop()
        proxy.stop()


def test_http_proxy_import_split_equals_jax():
    import base64
    import zlib

    snap = _local_snapshots(1)["port"]
    tcodec = mod("port", "distributed.codec")
    batch = tcodec.snapshot_to_batch(snap, 100.0, P)
    raw = batch.SerializeToString()
    as_json = json.dumps([
        {"name": m.name, "value": base64.b64encode(
            m.SerializeToString()).decode()} for m in batch.metrics]).encode()
    n = len(batch.metrics)
    bodies = [(raw, "", n), (zlib.compress(as_json), "deflate", n),
              (b"not a batch", "", 0)]
    jres = _http_import_split("jax", bodies)
    tres = _http_import_split("port", bodies)
    assert tres == jres
    codes, sent, proxied, drops = tres
    assert codes[:2] == [200, 200] and codes[2] == 400
    assert proxied == 2 * n and drops == 0
    assert {d for d, _, _ in sent} == {"g-a:1", "g-b:1"}


def _trace_routes(pkg: str, trace_ids):
    """Where a trace proxy sends each span, framed SSF over UDP and
    Datadog JSON arrays over HTTP, each kind to two receivers: the
    receiver's position by trace id, and the position the proxy's own
    ring names."""
    proxy_mod = mod(pkg, "distributed.proxy")
    ssf_wire = mod(pkg, "protocol.ssf_wire")
    ssf = mod(pkg, "ssf")
    rx = []
    for _ in range(2):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.bind(("127.0.0.1", 0))
        s.settimeout(5)
        rx.append(s)
    got: dict = {}
    lock = threading.Lock()

    def http_rx(label):
        class Rx(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with lock:
                    for sp in json.loads(body):
                        got.setdefault(("dd", sp["trace_id"]),
                                       set()).add(label)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), Rx)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    hx = [http_rx(0), http_rx(1)]
    udp = [f"127.0.0.1:{s.getsockname()[1]}" for s in rx]
    web = [f"http://127.0.0.1:{h.server_port}" for h in hx]
    tp_udp, tp_web = proxy_mod.TraceProxy(udp), proxy_mod.TraceProxy(web)
    want = {}
    for tid in trace_ids:
        want[("ssf", tid)] = [udp.index(tp_udp.ring.get(str(tid)))]
        want[("dd", tid)] = [web.index(tp_web.ring.get(str(tid)))]
    front = proxy_mod.ProxyHTTPServer(proxy_mod.ProxyServer([]),
                                      trace_proxy=tp_udp)
    fport = front.start()
    front_web = proxy_mod.ProxyHTTPServer(proxy_mod.ProxyServer([]),
                                          trace_proxy=tp_web)
    wport = front_web.start()
    try:
        buf = io.BytesIO()
        for tid in trace_ids:
            for sid in (1, 2):
                ssf_wire.write_ssf(buf, ssf.SSFSpan(
                    id=sid, trace_id=tid, service="svc", start_timestamp=1,
                    end_timestamp=2))
        req = urllib.request.Request(f"http://127.0.0.1:{fport}/spans",
                                     data=buf.getvalue())
        assert urllib.request.urlopen(req, timeout=10).status == 200
        n = 2 * len(trace_ids)
        assert _wait_until(lambda: tp_udp.proxied_spans >= n)
        for label, s in enumerate(rx):
            for _ in range(2 * sum(1 for t in trace_ids
                                   if want[("ssf", t)] == [label])):
                span = ssf_wire.parse_ssf(s.recvfrom(65536)[0])
                got.setdefault(("ssf", span.trace_id), set()).add(label)
        traces = [{"trace_id": tid, "span_id": sid, "parent_id": 0,
                   "name": "op", "resource": "GET /", "service": "svc",
                   "start": 1, "duration": 5, "error": 0}
                  for tid in trace_ids for sid in (1, 2)]
        req = urllib.request.Request(
            f"http://127.0.0.1:{wport}/spans",
            data=json.dumps(traces).encode(),
            headers={"Content-Type": "application/json"})
        assert urllib.request.urlopen(req, timeout=10).status == 202
        assert _wait_until(lambda: tp_web.proxied_spans >= n)
        with lock:
            return ({k: sorted(v) for k, v in got.items()}, want,
                    tp_udp.drops + tp_web.drops)
    finally:
        front.stop()
        front_web.stop()
        tp_udp.stop()
        tp_web.stop()
        for s in rx:
            s.close()
        for h in hx:
            h.shutdown()


def test_trace_proxy_destinations_equal_jax():
    tids = [101, 202, 303, 404, 505, 606, 707, 808]
    for pkg in ROOTS:
        got, want, drops = _trace_routes(pkg, tids)
        # every span of a trace on the one receiver its ring names
        assert got == want and drops == 0, pkg
    # the two packages' trace rings place every trace id alike
    members = ["collector-a:8128", "collector-b:8128", "collector-c:8128"]
    rings = [mod(pkg, "distributed.proxy").TraceProxy(members)
             for pkg in ROOTS]
    try:
        placed = [[tp.ring.get(str(t)) for t in range(2_000)]
                  for tp in rings]
        assert placed[0] == placed[1] and len(set(placed[1])) == 3
    finally:
        for tp in rings:
            tp.stop()


def test_runtime_reporter_deltas_equal_jax():
    outs = {}
    for pkg in ROOTS:
        sc = mod(pkg, "scopedstatsd")
        proxy_mod = mod(pkg, "distributed.proxy")
        cap = sc.CaptureSender()
        stats = sc.ScopedClient(cap, namespace="veneur_proxy.")
        proxy = proxy_mod.ProxyServer(["127.0.0.1:1"], streaming=True)
        tp = proxy_mod.TraceProxy([])
        try:
            rep = proxy_mod.ProxyRuntimeReporter(proxy, stats, 60.0,
                                                 trace_proxy=tp)
            for proxied, drops, spans in ((10, 3, 4), (25, 3, 9),
                                          (25, 7, 9)):
                proxy.proxied_metrics, proxy.drops = proxied, drops
                tp.proxied_spans = spans
                rep.report_once()
            outs[pkg] = [ln for ln in cap.lines
                         if not ln.startswith("veneur_proxy.mem.rss")]
            assert any(ln.startswith("veneur_proxy.mem.rss")
                       for ln in cap.lines)
        finally:
            proxy.stop()
            tp.stop()
    assert outs["port"] == outs["jax"]
    by_dest = [ln.split("|")[0] for ln in outs["port"]
               if ln.startswith("veneur_proxy.metrics_by_destination")]
    assert by_dest == ["veneur_proxy.metrics_by_destination:10",
                       "veneur_proxy.metrics_by_destination:15",
                       "veneur_proxy.metrics_by_destination:0"]


PROXY_CONFIGS = {
    "static": ("grpc_address: 127.0.0.1:0\n"
               "grpc_forward_address: 127.0.0.1:9\n", 0),
    "membership_file": ("grpc_address: 127.0.0.1:0\n"
                        "elastic_membership_file: {dir}/m.json\n"
                        "forward_dedup: true\n", 0),
    "empty": ("grpc_address: 127.0.0.1:0\n", 0),
    "bad_window": ("grpc_forward_address: 127.0.0.1:9\n"
                   "handoff_window_s: 0\n", 1),
    "bad_dedup": ("grpc_forward_address: 127.0.0.1:9\n"
                  "forward_dedup_window_ids: 0\n", 1),
    "bad_stream": ("grpc_forward_address: 127.0.0.1:9\n"
                   "forward_stream_window_min: 0\n", 1),
    "bad_probe": ("grpc_forward_address: 127.0.0.1:9\n"
                  "elastic_probe_timeout_s: -1\n", 1),
    "not_yaml": ("grpc_address: [unclosed\n", 1),
}


@pytest.mark.parametrize("name", sorted(PROXY_CONFIGS))
def test_proxy_main_validate_config_exit_codes(name, tmp_path):
    text, rc = PROXY_CONFIGS[name]
    p = tmp_path / "proxy.yaml"
    p.write_text(text.format(dir=tmp_path))
    codes = [mod(pkg, "cli.proxy_main").main(["-f", str(p),
                                              "-validate-config"])
             for pkg in ROOTS]
    assert codes == [rc, rc]


def test_proxy_main_refuses_empty_destinations(tmp_path):
    p = tmp_path / "proxy.yaml"
    p.write_text("grpc_address: 127.0.0.1:0\n")
    assert [mod(pkg, "cli.proxy_main").main(["-f", str(p)])
            for pkg in ROOTS] == [1, 1]
