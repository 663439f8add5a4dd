"""Port servers with real listeners against JAX servers, on the CPU.

A JAX server and a port server, each with SSF listeners on UDP, a unix
stream socket and a unix datagram socket and DogStatsD listeners on TCP
and a unix datagram socket, take the same traffic: DogStatsD lines first
(waited on until every line is counted), then SSF spans (waited on until
every span is counted), each listener carrying series of its own so the
interleaving of the listeners' threads cannot reorder a series. One
flush at a pinned ``now``: every InterMetric equal, on the Python path
and on the native path (the C++ SSF reader on UDP, the C++ line-stream
reader on plain TCP), and the C++ SSF reader committed spans.

DogStatsD over TLS and mutual TLS with a CA and certificates made by
``openssl`` at test time: the lines of an authenticated client land in
both servers alike, and a client without a certificate is refused and
counted (``tcp.tls_handshake_failures``).

The unixgram SSF listener reads up to ``trace_max_length_bytes``, the UDP
one up to that clamped to 65,536 bytes: a datagram longer than the
buffer is cut by the receive and counted as an unmarshal error by both
packages.
"""

from __future__ import annotations

import shutil
import socket
import ssl
import struct
import subprocess
import time

import numpy as np
import pytest

from veneur_tpu import ssf as jssf
from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import ssf_wire as jwire
from veneur_tpu_torch.core.config import Config as TConfig
from veneur_tpu_torch.core.server import Server as TServer

PCTS = [0.5, 0.9, 0.99]
IND, OBJ = "sp.indicator", "sp.objective"
NOW = 1_700_000_000


def _canonical(metrics) -> list[tuple]:
    return sorted(
        (m.name, m.timestamp, struct.pack("<d", float(m.value)),
         tuple(m.tags), m.type.name, m.message, m.hostname)
        for m in metrics)


def _wait_until(pred, timeout=30.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _spans(listener: str, seed: int, n: int, status: bool) -> list[bytes]:
    """SSF datagrams of one listener: its own services and sample names,
    indicator spans, attached counters, gauges, timers, sets and (with
    ``status``) status checks."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        samples = [
            jssf.SSFSample(metric=jssf.SSFMetricType.COUNTER,
                           name=f"{listener}.hits", value=float(1 + i % 3),
                           timestamp=NOW, tags={"k": f"v{i % 3}"}),
            jssf.SSFSample(metric=jssf.SSFMetricType.HISTOGRAM,
                           name=f"{listener}.lat",
                           value=float(np.round(rng.gamma(2.0, 9.0), 4)),
                           timestamp=NOW, sample_rate=0.5 if i % 4 else 1.0),
            jssf.SSFSample(metric=jssf.SSFMetricType.GAUGE,
                           name=f"{listener}.load", value=float(i),
                           timestamp=NOW),
            jssf.SSFSample(metric=jssf.SSFMetricType.SET,
                           name=f"{listener}.users", message=f"u{i % 17}",
                           timestamp=NOW)]
        if status and i % 5 == 0:
            samples.append(jssf.SSFSample(
                metric=jssf.SSFMetricType.STATUS, name=f"{listener}.chk",
                status=jssf.SSFStatus.WARNING, timestamp=NOW))
        tid = 1000 + i
        start = 1_000_000_000 + i * 1000
        span = jssf.SSFSpan(
            trace_id=tid, id=tid if i % 3 == 0 else tid + 7,
            start_timestamp=start,
            end_timestamp=start + int(rng.gamma(2.0, 5e6)),
            error=bool(i % 6 == 1), service=f"{listener}-svc{i % 2}",
            indicator=bool(i % 2 == 0), name=f"op{i % 3}", metrics=samples,
            tags={"ssf_objective": "obj"} if i % 7 == 0 else {})
        out.append(jwire.encode_datagram(span))
    return out


def _statsd(listener: str, seed: int, n: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [f"{listener}.t{i % 5}:{rng.gamma(2.0, 9.0):.4f}|ms|#x:{i % 3}"
            .encode() if i % 3 else f"{listener}.c{i % 4}:2|c".encode()
            for i in range(n)]


def _processed(srv) -> int:
    """Samples the live epoch took, the native context's included."""
    return srv.workers[0].processed


def _spans_in(srv) -> int:
    n = srv.ssf_spans_received_total
    if srv._native_ssf:
        n += srv.workers[0]._native.ssf_spans
    return n


def _server(pkg: str, tmp_path, native: bool, **extra):
    d = dict(interval="10s", percentiles=PCTS, num_workers=1,
             aggregates=["min", "max", "count", "sum"],
             tpu_native_ingest=native, tpu_native_readers=native,
             micro_fold=False, indicator_span_timer_name=IND,
             objective_span_timer_name=OBJ, ssf_span_uniqueness_rate=1.0,
             tpu_hll_precision=10, **extra)
    return (JServer(JConfig(**d)) if pkg == "jax"
            else TServer(TConfig(**d), device="cpu"))


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_listeners_equal_jax(tmp_path, native):
    statsd = {"tcp": _statsd("tcp", 1, 300), "ug": _statsd("ug", 2, 300)}
    spans = {"udp": _spans("udp", 3, 150, status=True),
             "unix": _spans("unix", 4, 150, status=True),
             "ugram": _spans("ugram", 5, 150, status=True)}
    outs = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        srv = _server(
            pkg, tmp_path, native,
            statsd_listen_addresses=["tcp://127.0.0.1:0",
                                     f"unixgram://{d}/statsd.sock"],
            ssf_listen_addresses=["udp://127.0.0.1:0", f"unix://{d}/ssf.sock",
                                  f"unixgram://{d}/ssfg.sock"])
        try:
            assert srv._native_ssf is native
            ports = srv.start_listeners()
            ports.update(srv.start_ssf_listeners())
            # one listener at a time, each waited on: a series' samples
            # then arrive in one order, and so do the spill batches
            with socket.create_connection(
                    ("127.0.0.1", ports["tcp://127.0.0.1:0"])) as c:
                c.sendall(b"\n".join(statsd["tcp"]) + b"\n")
            assert _wait_until(lambda: _processed(srv) == 300), (
                pkg, _processed(srv))
            ug = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            for i in range(0, len(statsd["ug"]), 10):
                ug.sendto(b"\n".join(statsd["ug"][i:i + 10]),
                          str(d / "statsd.sock"))
            ug.close()
            assert _wait_until(lambda: _processed(srv) == 600), (
                pkg, _processed(srv))
            udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for i, pkt in enumerate(spans["udp"]):
                udp.sendto(pkt, ("127.0.0.1", ports["udp://127.0.0.1:0"]))
                if i % 25 == 24:
                    time.sleep(0.005)
            udp.close()
            assert _wait_until(lambda: _spans_in(srv) == 150), (
                pkg, _spans_in(srv))
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as us:
                us.connect(str(d / "ssf.sock"))
                us.sendall(b"".join(struct.pack(">BI", 0, len(p)) + p
                                    for p in spans["unix"]))
            assert _wait_until(lambda: _spans_in(srv) == 300), (
                pkg, _spans_in(srv))
            ugs = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            for pkt in spans["ugram"]:
                ugs.sendto(pkt, str(d / "ssfg.sock"))
            ugs.close()
            assert _wait_until(lambda: _spans_in(srv) == 450), (
                pkg, _spans_in(srv))
            if native:
                # C++ took the datagrams without STATUS samples (UDP through
                # the C++ SSF reader, unixgram per packet); the 60 STATUS
                # spans and the unix stream's 150 took the Python path
                assert srv.workers[0]._native.ssf_spans == 240
                assert srv.ssf_spans_received_total == 210
            outs.append(_canonical(srv.flush(now=NOW)))
            st = srv.ingress_stats()["spans"]
            assert st["received"] == st["derived"] + st["dropped"] + \
                st["pending"]
        finally:
            srv.shutdown()
    assert outs[0] == outs[1]
    names = {m[0] for m in outs[1]}
    for lst in ("tcp", "ug", "udp", "unix", "ugram"):
        assert any(n.startswith(lst + ".") for n in names), lst
    assert any(n.startswith(IND) for n in names)


def test_truncated_ssf_datagrams_counted_alike(tmp_path):
    big = jssf.SSFSpan(trace_id=5, id=6, start_timestamp=1,
                       end_timestamp=2, service="s", name="op",
                       tags={"pad": "z" * 900})
    data = jwire.encode_datagram(big)
    got = []
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        d.mkdir()
        srv = _server(pkg, tmp_path, False, trace_max_length_bytes=512,
                      ssf_listen_addresses=[f"unixgram://{d}/ssfg.sock",
                                            "udp://127.0.0.1:0"])
        counts = {}
        if pkg == "jax":
            def count(name, value, tags=None, **_):
                k = (name, tuple(tags or ()))
                counts[k] = counts.get(k, 0) + value
            srv.stats.count = count
        try:
            port = srv.start_ssf_listeners()["udp://127.0.0.1:0"]
            s = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
            u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            for _ in range(3):
                s.sendto(data, str(d / "ssfg.sock"))
                u.sendto(data, ("127.0.0.1", port))
            s.close()
            u.close()
            assert _wait_until(lambda: srv.parse_errors == 6)
            if pkg == "port":
                counts = {k: v for k, v in srv.stats.totals().items()
                          if k[0] == "ssf.error_total"}
            got.append((srv.parse_errors, srv.ssf_spans_received_total,
                        counts))
        finally:
            srv.shutdown()
    assert got[0] == got[1]
    assert got[1][2] == {("ssf.error_total", (
        "ssf_format:packet", "packet_type:ssf_metric",
        "reason:unmarshal")): 6}


# -- TLS ----------------------------------------------------------------------


def _openssl(tmp, *args) -> None:
    subprocess.run(["openssl", *args], cwd=tmp, check=True,
                   capture_output=True, timeout=60)


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """A CA, a server certificate for 127.0.0.1 and a client certificate,
    made by openssl here."""
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    tmp = tmp_path_factory.mktemp("pki")
    ec = ["-newkey", "ec", "-pkeyopt", "ec_paramgen_curve:prime256v1",
          "-nodes"]
    _openssl(tmp, "req", "-x509", *ec, "-keyout", "ca.key", "-out",
             "ca.pem", "-days", "2", "-subj", "/CN=test-ca")
    (tmp / "san.ext").write_text("subjectAltName=IP:127.0.0.1\n")
    for who in ("server", "client"):
        _openssl(tmp, "req", *ec, "-keyout", f"{who}.key", "-out",
                 f"{who}.csr", "-subj", f"/CN={who}")
        _openssl(tmp, "x509", "-req", "-in", f"{who}.csr", "-CA", "ca.pem",
                 "-CAkey", "ca.key", "-CAcreateserial", "-out",
                 f"{who}.pem", "-days", "2", "-extfile", "san.ext")
    return tmp


def _tls_client(pki, port: int, cert: bool) -> ssl.SSLSocket:
    ctx = ssl.create_default_context(cafile=str(pki / "ca.pem"))
    if cert:
        ctx.load_cert_chain(str(pki / "client.pem"), str(pki / "client.key"))
    raw = socket.create_connection(("127.0.0.1", port), timeout=10)
    return ctx.wrap_socket(raw, server_hostname="127.0.0.1")


@pytest.mark.parametrize("mutual", [False, True], ids=["tls", "mutual_tls"])
def test_statsd_tls_equal_jax(pki, mutual):
    lines = _statsd("tls", 9, 200)
    outs = []
    for pkg in ("jax", "port"):
        extra = dict(statsd_listen_addresses=["tcp://127.0.0.1:0"],
                     tls_key=str(pki / "server.key"),
                     tls_certificate=str(pki / "server.pem"))
        if mutual:
            extra["tls_authority_certificate"] = str(pki / "ca.pem")
        srv = _server(pkg, pki, True, **extra)
        counts = {}
        if pkg == "jax":
            def count(name, value, tags=None, **_):
                counts[name] = counts.get(name, 0) + value
            srv.stats.count = count
        try:
            port = srv.start_listeners()["tcp://127.0.0.1:0"]
            with _tls_client(pki, port, cert=True) as c:
                c.sendall(b"\n".join(lines) + b"\n")
            if mutual:
                # no client certificate: the handshake fails, counted
                try:
                    with _tls_client(pki, port, cert=False) as c:
                        c.sendall(b"nocert.c:1|c\n")
                        c.recv(1)
                except (ssl.SSLError, OSError):
                    pass
            assert _wait_until(lambda: _processed(srv) == len(lines))
            if mutual:
                failures = (lambda: counts.get("tcp.tls_handshake_failures")
                            if pkg == "jax" else srv.stats.totals().get(
                                ("tcp.tls_handshake_failures", ())))
                assert _wait_until(lambda: failures() == 1)
            outs.append(_canonical(srv.flush(now=NOW)))
        finally:
            srv.shutdown()
    assert outs[0] == outs[1]
    assert sum(1 for m in outs[1] if m[0].startswith("tls.")) > 10
    assert not any(m[0].startswith("nocert") for m in outs[1])
