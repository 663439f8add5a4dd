"""The SSF wire and the internal tracer of the PyTorch port against the
JAX package, on the CPU.

* ``protocol/ssf_wire``: numpy-seeded spans (every sample kind, unknown
  enum values, empty names and ids, the name-tag normalization) encode
  to the same bytes in both packages and parse back to equal spans;
  framed streams read alike; every framing error (version, length over
  the limit, a truncated frame) and unmarshal error raises the same
  class with the same message; a truncated datagram fails to parse in
  both.
* The server's SSF error accounting: zero-length, unmarshal, empty-id
  and truncated datagrams count ``ssf.error_total`` with the reference's
  tag sets and bump the parse errors as the JAX server does, on the
  Python path and the native SSF path.
* ``trace/``: spans, the OpenTracing tracer's inject/extract in every
  header format, ``traced_server_hop`` and the trace client's backends
  give the same ids, headers and bytes under the same ``random`` seed.
"""

from __future__ import annotations

import io
import random
import socket

import numpy as np
import pytest

from veneur_tpu import ssf as jssf
from veneur_tpu import trace as jtrace
from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.protocol import ssf_wire as jwire
from veneur_tpu.trace import opentracing as jot
from veneur_tpu_torch import ssf as tssf
from veneur_tpu_torch import trace as ttrace
from veneur_tpu_torch.core.config import Config as TConfig
from veneur_tpu_torch.core.server import Server as TServer
from veneur_tpu_torch.protocol import ssf_wire as twire
from veneur_tpu_torch.trace import opentracing as tot


def span_specs(seed: int, n: int) -> list[dict]:
    """Plain-data spans from a numpy seed: every sample kind, unknown
    metric enums, empty sample names, empty ids, roots, invalid trace
    spans (end 0), indicator and error flags, ssf_objective overrides and
    a name given only as a tag."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        samples = []
        for _ in range(int(rng.integers(0, 5))):
            kind = int(rng.integers(0, 8))
            samples.append(dict(
                metric=kind if kind < 5 else (4 if kind == 5 else 9),
                name="" if kind == 7 else f"sp.m{int(rng.integers(0, 6))}",
                value=float(np.round(rng.gamma(2.0, 10.0), 4)),
                timestamp=1_700_000_000 + i,
                message=f"u{int(rng.integers(0, 40))}",
                status=int(rng.integers(0, 4)),
                sample_rate=(0.0, 0.5, 1.0)[int(rng.integers(0, 3))],
                tags=({"k": f"v{int(rng.integers(0, 3))}"}
                      if rng.random() < 0.5 else {}),
                unit="ns" if kind == 3 else ""))
        tid = int(rng.integers(1, 1 << 40))
        sid = 0 if i % 17 == 5 else (tid if i % 4 == 0 else tid + 1 + i)
        tags = {"host": f"h{i % 3}"}
        if i % 5 == 0:
            tags["ssf_objective"] = f"obj{i % 2}"
        name = "" if i % 11 == 3 else f"op{int(rng.integers(0, 4))}"
        if not name:
            tags["name"] = "from-tag"
        start = 1_000_000_000 + i * 1000
        out.append(dict(
            trace_id=tid, id=sid, parent_id=int(rng.integers(0, 9)),
            start_timestamp=start,
            end_timestamp=0 if i % 13 == 7 else start + int(
                rng.gamma(2.0, 5e6)),
            error=bool(rng.random() < 0.2),
            service="" if i % 9 == 8 else f"svc{int(rng.integers(0, 3))}",
            tags=tags, indicator=bool(rng.random() < 0.6), name=name,
            metrics=samples))
    return out


def build_span(mod, spec: dict):
    """One spec as ``mod.SSFSpan`` (mod: either package's ssf)."""
    s = dict(spec)
    s["metrics"] = [mod.SSFSample(**{**m, "tags": dict(m["tags"])})
                    for m in spec["metrics"]]
    s["tags"] = dict(spec["tags"])
    return mod.SSFSpan(**s)


def _plain(span) -> dict:
    d = {k: getattr(span, k) for k in (
        "version", "trace_id", "id", "parent_id", "start_timestamp",
        "end_timestamp", "error", "service", "tags", "indicator", "name")}
    d["metrics"] = [(int(m.metric), m.name, m.value, m.timestamp,
                     m.message, int(m.status), m.sample_rate, m.tags,
                     m.unit, int(m.scope)) for m in span.metrics]
    return d


# -- the wire ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_datagram_bytes_and_parse_equal(seed):
    for spec in span_specs(seed, 40):
        jb = jwire.encode_datagram(build_span(jssf, spec))
        tb = twire.encode_datagram(build_span(tssf, spec))
        assert jb == tb
        assert _plain(jwire.parse_ssf(jb)) == _plain(twire.parse_ssf(tb))


def test_framed_stream_equal():
    specs = span_specs(3, 30)
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    for spec in specs:
        jwire.write_ssf(jbuf, build_span(jssf, spec))
        twire.write_ssf(tbuf, build_span(tssf, spec))
    assert jbuf.getvalue() == tbuf.getvalue()
    jbuf.seek(0)
    tbuf.seek(0)
    n = 0
    while True:
        a, b = jwire.read_ssf(jbuf), twire.read_ssf(tbuf)
        if a is None:
            assert b is None
            break
        assert _plain(a) == _plain(b)
        n += 1
    assert n == len(specs)


_BAD_FRAMES = [
    ("version", b"\x01\x00\x00\x00\x00", None),
    ("oversize", b"\x00\xff\xff\xff\xff", None),
    ("truncated_body", b"\x00\x00\x00\x00\x09abc", None),
    ("truncated_header", b"\x00\x00\x00", None),
    ("over_max_length", b"\x00\x00\x00\x01\x00" + b"\x00" * 256, 128),
    ("unmarshal", b"\x00\x00\x00\x00\x03\xff\xff\xff", None),
]


@pytest.mark.parametrize("case,data,max_len", _BAD_FRAMES,
                         ids=[c[0] for c in _BAD_FRAMES])
def test_framing_errors_equal(case, data, max_len):
    kw = {} if max_len is None else {"max_length": max_len}
    errs = []
    for mod in (jwire, twire):
        with pytest.raises(mod.FramingError) as ei:
            mod.read_ssf(io.BytesIO(data), **kw)
        errs.append((type(ei.value).__name__, str(ei.value)))
    assert errs[0] == errs[1]
    assert (errs[0][0] == "SSFUnmarshalError") == (case == "unmarshal")


def test_truncated_datagram_fails_in_both():
    spec = span_specs(4, 1)[0]
    spec["tags"] = {"pad": "x" * 3000}
    data = jwire.encode_datagram(build_span(jssf, spec))
    pos = data.index(b"x" * 3000)
    # a cut inside the length-delimited tag: what a receive buffer
    # shorter than the datagram leaves
    for cut in (pos + 1, pos + 1500, pos + 2999):
        for mod in (jwire, twire):
            with pytest.raises(mod.SSFUnmarshalError):
                mod.parse_ssf(data[:cut])


# -- the server's SSF error accounting ----------------------------------------


def _jax_counts(srv):
    got = {}

    def count(name, value, tags=None, **_):
        k = (name, tuple(tags or ()))
        got[k] = got.get(k, 0) + value

    srv.stats.count = count
    return got


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_ssf_error_accounting_equal(native):
    spec = span_specs(5, 1)[0]
    spec["id"] = 0
    empty_id = jwire.encode_datagram(build_span(jssf, spec))
    spec["id"] = 77
    spec["tags"] = {"pad": "y" * 2000}
    good = jwire.encode_datagram(build_span(jssf, spec))
    cut = good.index(b"y" * 2000) + 1000
    packets = [b"", b"\xff\xff\xff", empty_id, good[:cut], good, b"",
               empty_id]
    kw = dict(interval="10s", tpu_native_ingest=native, num_workers=1,
              ssf_span_uniqueness_rate=0.0)
    js = JServer(JConfig(**kw))
    ts = TServer(TConfig(**kw), device="cpu")
    try:
        assert ts._native_ssf is native and js._native_ssf is native
        jc = _jax_counts(js)
        for pkt in packets:
            js.handle_trace_packet(pkt)
            ts.handle_trace_packet(pkt)
        tc = {k: v for k, v in ts.stats.totals().items()
              if k[0] == "ssf.error_total"}
        assert tc == jc
        assert ts.parse_errors == js.parse_errors == 4
    finally:
        js.shutdown()
        ts.shutdown()


# -- the tracer ---------------------------------------------------------------


class _Rec:
    def __init__(self):
        self.spans = []

    def record(self, span):
        self.spans.append(span)


def _trace_run(ot, tr, ssf_mod):
    """One seeded tracing session: nested spans, tags, errors, the
    header formats, a server hop; returns everything it produced."""
    rec = _Rec()
    tracer = ot.Tracer(client=rec, service="svc")
    out = []
    with tracer.start_span("root", tags={"a": 1}) as root:
        child = tracer.start_span("child", child_of=root)
        child.set_tag("k", "v")
        child.set_baggage_item("bag", "gage")
        child.set_error()
        child.finish()
        for fmt in (ot.HTTP_HEADERS, ot.TEXT_MAP):
            carrier = {}
            tracer.inject(child.context(), fmt, carrier)
            out.append(sorted(carrier.items()))
            ctx = tracer.extract(fmt, carrier)
            out.append((ctx.trace_id, ctx.span_id, ctx.resource))
        headers = {}
        tracer.inject_header(root.context(), headers)
        with ot.traced_server_hop(headers, "veneur.import",
                                  resource="/import",
                                  tracer=tracer) as hop:
            hop.set_tag("x", "y")
        assert ot.traced_server_hop({}, "none").span is None
    plain = tr.start_span("plain", service="s2")
    kid = plain.child("kid", indicator=True)
    kid.add(ssf_mod.count("c", 2.0, {"t": "1"}))
    h = {}
    kid.inject_headers(h)
    out.append(sorted(h.items()))
    rec.record(kid.finish())
    for s in rec.spans:
        d = _plain(s)
        d.pop("start_timestamp")
        d.pop("end_timestamp")
        d["metrics"] = [m[:3] + m[4:] for m in d["metrics"]]
        out.append(d)
    return out


def test_tracer_ids_headers_and_spans_equal():
    random.seed(11)
    a = _trace_run(jot, jtrace, jssf)
    random.seed(11)
    b = _trace_run(tot, ttrace, tssf)
    assert a == b
    assert len(a) > 6


def test_trace_client_udp_bytes_equal():
    """The trace client's UDP backend sends each package's spans as the
    same datagrams."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(10.0)
    specs = span_specs(6, 8)
    try:
        got = []
        for tr, mod in ((jtrace, jssf), (ttrace, tssf)):
            client = tr.Client(tr.UDPBackend(rx.getsockname()))
            for spec in specs:
                client.record(build_span(mod, spec))
            client.close()  # joins the backend thread: every span sent
            assert client.records_sent == len(specs)
            got.append([rx.recv(65536) for _ in specs])
        assert got[0] == got[1]
        assert [_plain(twire.parse_ssf(d)) for d in got[1]] == [
            _plain(jwire.parse_ssf(d)) for d in got[0]]
    finally:
        rx.close()
