"""The write-ahead spill journal (utils/journal.py) of the PyTorch port
against the JAX package's, on the CPU.

* The same appends, acks, mints, rolls and compactions leave the same
  bytes on disk in both packages, and each package replays the other's
  journal.
* Crash shapes: a torn tail keeps the prefix, a bit flip skips that
  record only, a zero-length segment is harmless, a double restart
  replays the unacked records once more under the same ids; minted ids
  never repeat across a dirty restart; the sender token is stable until
  the directory is wiped.
* A proxy's spill survives a restart through its journal and is
  delivered by the next incarnation, with the same counters and wire
  attempts as the JAX proxy's.
* A server's ``_attach_journals`` recovers a local's sink spill: a
  forward-statsd sink that could not deliver journals its payload, the
  next incarnation replays it ahead of fresh data, and the listener gets
  the same bytes from both packages.
"""

from __future__ import annotations

import importlib
import os
import socket
import threading
import time

import pytest

from veneur_tpu.core.config import load_config as jload
from veneur_tpu.core.factory import build_server as jbuild
from veneur_tpu_torch.core.config import load_config as tload
from veneur_tpu_torch.core.factory import build_server as tbuild

ROOTS = {"jax": "veneur_tpu", "port": "veneur_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{ROOTS[pkg]}.{name}")


def _journal(pkg, path, **kw):
    kw.setdefault("fsync", "never")
    return mod(pkg, "utils.journal").SpillJournal(str(path), **kw)


def _files(path) -> dict:
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def _both(scenario):
    outs = {pkg: scenario(pkg) for pkg in ROOTS}
    assert outs["port"] == outs["jax"]
    return outs["port"]


def test_journal_bytes_on_disk_equal_jax(tmp_path):
    def scenario(pkg):
        d = tmp_path / pkg
        j = _journal(pkg, d, max_bytes=1 << 20, max_segments=4,
                     segment_bytes=160)
        j.reserve_block = 8
        ids = []
        for i in range(30):
            ids.append(j.append(f"payload-{i}".encode() * (1 + i % 3)))
            if i % 7 == 3:
                ids.append(j.mint_id())
            if i < 26 and i % 9:
                j.ack(ids[-1] if i % 7 != 3 else ids[-2])
        j.set_policy(fsync="always")
        j.append(b"after-policy")
        j.sync()
        stats = j.stats()
        j.close()
        return ids, stats, _files(d)

    ids, stats, files = _both(scenario)
    assert stats["compacted_segments"] > 0 and len(files) > 1
    assert ids == sorted(set(ids))
    # each package replays the other's journal
    for writer, reader in (("jax", "port"), ("port", "jax")):
        got = _journal(reader, tmp_path / writer).replay_pending()
        ref = _journal(writer, tmp_path / writer).replay_pending()
        assert got == ref and got


def _crash(pkg, tmp_path, kind):
    d = tmp_path / f"{pkg}-{kind}"
    j = _journal(pkg, d)
    ids = [j.append(f"rec-{i}".encode()) for i in range(4)]
    segs = [n for n in os.listdir(d) if n.endswith(".wal")] or \
        [n for n in os.listdir(d) if n != "sender.id"]
    path = os.path.join(d, sorted(segs)[0])
    j.close()
    if kind == "torn":
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(size - 5)
    elif kind == "flip":
        data = bytearray(open(path, "rb").read())
        rec = len(data) // 4
        data[rec + rec // 2] ^= 0xFF
        open(path, "wb").write(bytes(data))
    elif kind == "empty":
        seg = mod(pkg, "utils.journal")._segment_name(99)
        open(os.path.join(d, seg), "wb").close()
    j2 = _journal(pkg, d)
    first = j2.replay_pending()
    if first:
        j2.ack(first[0][0])
    after = j2.append(b"fresh")
    st2 = j2.stats()
    j2.close()
    j3 = _journal(pkg, d)
    second = j3.replay_pending()
    st3 = j3.stats()
    j3.close()
    return ids, first, after, st2, second, st3


@pytest.mark.parametrize("kind", ["torn", "flip", "empty", "clean"])
def test_crash_shapes_and_double_restart_equal_jax(tmp_path, kind):
    ids, first, after, st2, second, st3 = _both(
        lambda pkg: _crash(pkg, tmp_path, kind))
    payloads = [p for _, p in first]
    if kind == "torn":
        assert payloads == [b"rec-0", b"rec-1", b"rec-2"]
        assert st2["torn_tails"] == 1 and st2["skipped_corrupt"] == 0
    elif kind == "flip":
        assert [r for r, _ in first] == [ids[0], ids[2], ids[3]]
        assert st2["skipped_corrupt"] == 1
    else:
        assert payloads == [f"rec-{i}".encode() for i in range(4)]
    # the second restart replays what is still unacked, same ids
    assert [r for r, _ in second] == [r for r, _ in first[1:]] + [after]
    assert after > max(r for r, _ in first) and st3["appended"] == 0


def test_mint_ids_never_repeat_and_sender_token(tmp_path):
    def scenario(pkg):
        j = _journal(pkg, tmp_path / f"{pkg}-mint")
        j.reserve_block = 4
        minted = [j.mint_id() for _ in range(6)]
        reserved = j.stats()["reserved_blocks"]
        j2 = _journal(pkg, tmp_path / f"{pkg}-mint")   # dirty restart
        again = [j2.mint_id() for _ in range(4)]
        j2.close()
        jr = _journal(pkg, tmp_path / f"{pkg}-roll", max_bytes=1 << 20,
                      max_segments=8, segment_bytes=100)
        jr.reserve_block = 1000
        first = jr.mint_id()
        for _ in range(12):
            jr.ack(jr.append(b"x" * 24))
        compacted = jr.stats()["compacted_segments"]
        jr.close()
        jr2 = _journal(pkg, tmp_path / f"{pkg}-roll")
        bound = jr2.mint_id()
        jr2.close()
        return minted, reserved, again, first, compacted, bound

    minted, reserved, again, first, compacted, bound = _both(scenario)
    assert minted == sorted(set(minted)) and reserved == 2
    assert min(again) > max(minted)
    assert compacted > 0 and bound >= first + 1000
    import shutil

    token = mod("port", "utils.journal").sender_token
    d = str(tmp_path / "tok")
    t1 = token(d)
    assert t1 and t1 == token(d)
    j = _journal("port", d)
    j.append(b"x")
    j.close()
    assert token(d) == t1
    shutil.rmtree(d)
    assert token(d) != t1


# -- a proxy's spill across a restart -----------------------------------------


class Client:
    def __init__(self, pkg, dest, down):
        self._rpc = mod(pkg, "distributed.rpc")
        self._codec = mod(pkg, "distributed.codec")
        self._pb = mod(pkg, "gen.veneur_tpu_pb2")
        self.address = dest
        self.down = down
        self.attempts = []

    def send_raw_or_raise(self, blob, n_metrics, timeout_s=None):
        key, body = self._codec.decode_dedup_envelope(blob)
        names = [m.name for m in self._pb.MetricBatch.FromString(body).metrics]
        self.attempts.append((key, names, not self.down))
        if self.down:
            raise self._rpc.ForwardError("unavailable", self.address, "down")

    def stats(self):
        return {"address": self.address, "errors": {}}

    def close(self):
        pass


def _counter_wire(pkg, n):
    pb = mod(pkg, "gen.veneur_tpu_pb2")
    b = pb.MetricBatch()
    for i in range(n):
        m = b.metrics.add()
        m.name = f"px{i}"
        m.kind = pb.KIND_COUNTER
        m.scope = pb.SCOPE_GLOBAL
        m.counter.value = i + 1
    return b.SerializeToString()


def _proxy_restart(pkg, tmp_path):
    proxy_mod = mod(pkg, "distributed.proxy")
    policy = mod(pkg, "sinks.delivery").DeliveryPolicy(
        retry_max=0, timeout_s=0.3, deadline_s=5.0, backoff_base_s=0.001)
    jdir = tmp_path / f"{pkg}-proxy"
    dests = ["g-a:1", "g-b:1"]
    down = {d: Client(pkg, d, True) for d in dests}
    proxy = proxy_mod.ProxyServer(
        dests, handoff_window_s=60.0, delivery=policy, dedup=True,
        dedup_sender="s", journal=_journal(pkg, jdir),
        client_factory=lambda d, t, i: down[d])
    proxy._route_wire(_counter_wire(pkg, 12))
    first = (proxy.spilled_metrics, proxy._journal.pending_records())
    proxy.stop()            # the RAM spill dies with the process
    files = _files(jdir)
    up = {d: Client(pkg, d, False) for d in dests}
    proxy2 = proxy_mod.ProxyServer(
        dests, handoff_window_s=60.0, delivery=policy, dedup=True,
        dedup_sender="s", journal=_journal(pkg, jdir),
        client_factory=lambda d, t, i: up[d])
    try:
        rec = proxy2.recover_journal()
        st = proxy2.forward_stats()
        return (first, files, rec, {d: c.attempts for d, c in down.items()},
                {d: c.attempts for d, c in up.items()},
                {k: st[k] for k in ("proxied_metrics", "spilled_metrics",
                                    "drops", "journal_recovered_payloads",
                                    "journal_recovered_metrics", "dedup")},
                st["journal"]["pending_records"], proxy2.conserved())
    finally:
        proxy2.stop()


def test_proxy_spill_survives_restart_through_the_journal(tmp_path):
    first, files, rec, down, up, stats, pending, conserved = _both(
        lambda pkg: _proxy_restart(pkg, tmp_path))
    assert first == (12, 2) and len(files) >= 1
    assert rec == {"recovered_payloads": 2, "recovered_metrics": 12}
    # each recovered fragment goes back out under the key it was minted
    # with on its first attempt
    down_keys = {tuple(n): k for d in down.values() for k, n, _ in d}
    for attempts in up.values():
        for key, names, ok in attempts:
            assert ok and down_keys[tuple(names)] == key
    assert stats["proxied_metrics"] == 12 and stats["drops"] == 0
    assert stats["journal_recovered_metrics"] == 12
    assert pending == 0 and conserved


# -- a server's sink spill across a restart ------------------------------------


class Recorder:
    """An HTTP server keeping every POST (path, idempotency key, body)
    on a given port."""

    def __init__(self, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        got = self.posts = []
        lock = self.lock = threading.Lock()

        class H(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with lock:
                    got.append((self.path,
                                self.headers.get("Idempotency-Key"), body))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), H)
        self.port = self.httpd.server_port
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _closed_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _server(pkg, port, jdir):
    data = {"interval": "1h", "hostname": "h", "num_workers": 1,
            "ssf_span_uniqueness_rate": 0.0, "tpu_native_ingest": False,
            "statsd_listen_addresses": [], "micro_fold": False,
            "prometheus_pushgateway_address":
                f"http://127.0.0.1:{port}/metrics/job/j",
            "sink_retry_max": 0, "flush_timeout_s": 0.5,
            "spill_journal_dir": str(jdir),
            "shutdown_drain_deadline_s": 0.2}
    if pkg == "jax":
        srv = jbuild(jload(data=data))
    else:
        srv = tbuild(tload(data=data), device="cpu")
    srv.start()           # attaches and replays the journals
    # idempotency keys carry the journal's random sender token: pin it
    srv.metric_sinks[0].delivery._mint_sender = "s"
    return srv


def _delivery(srv) -> dict:
    return dict(srv._delivery_managers())["prometheus"].stats()


def _sink_restart(pkg, tmp_path):
    jdir = tmp_path / f"{pkg}-wal"
    # the journal keeps the request's URL: the next incarnation's
    # receiver comes up on the port the first could not reach
    port = _closed_port()
    srv = _server(pkg, port, jdir)
    try:
        for i in range(5):
            srv.process_metric_packet(
                f"jr.c{i}:{i + 1}|c|#veneurglobalonly".encode())
        srv.flush(now=1_700_000_000)
        drain = srv.graceful_drain()
        journaled = srv.ingress_stats()["journal"]["prometheus"]
    finally:
        srv.shutdown()
    closed = dict(srv._journals)
    rx = Recorder(port)
    srv2 = _server(pkg, port, jdir)
    try:
        recovered = _delivery(srv2)
        srv2.process_metric_packet(b"jr.fresh:1|c|#veneurglobalonly")
        srv2.flush(now=1_700_000_010)
        st = _delivery(srv2)
        with rx.lock:
            posts = list(rx.posts)
    finally:
        srv2.shutdown()
        rx.close()
    keep = ("clipped_payloads", "deadline_clipped", "final_flush",
            "journal_pending_records")
    return ({k: drain[k] for k in keep},
            {k: journaled[k] for k in ("appended", "pending_records")},
            closed, recovered["journal_recovered"],
            recovered["spilled_payloads"], posts,
            st["delivered_payloads"], st["journal_pending"])


def test_server_attach_journals_recovers_a_sink_spill(tmp_path):
    (drain, journaled, closed, recovered, spilled, posts, delivered,
     pending) = _both(lambda pkg: _sink_restart(pkg, tmp_path))
    assert drain["clipped_payloads"] == 1 and drain["deadline_clipped"]
    assert drain["journal_pending_records"] == 1
    assert journaled["pending_records"] == 1 and closed == {}
    assert (recovered, spilled) == (1, 1)
    # the journaled interval goes out first, then the fresh one
    assert [p[0] for p in posts] == ["/metrics/job/j"] * 2
    assert posts[0][2] == b"".join(b"jr_c%d %d.0\n" % (i, i + 1)
                                   for i in range(5))
    assert posts[1][2] == b"jr_fresh 1.0\n"
    assert delivered == 2 and pending == 0
