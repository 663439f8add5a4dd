"""The port's native emit tier against the JAX package's, and against the
port's own Python formatters, on the CPU (after tests/test_emit_parity.py).

Every ``veneur_tpu_torch.native.encode_*`` and ``deflate`` is held byte for
byte to ``veneur_tpu.native``'s on the same columnar batch (UTF-8 names
and tags, magic host/device tags, NaN and ±Inf, subnormals, masked
families, excluded tags). Each port sink's native path is held to its
Python formatter: byte-identical line blobs and exposition text, and for
the JSON sinks the same values in the same order (the reference's
contract: the native bodies are compact and chunked per group). A
separator-laden group falls back to the Python formatter alone, an empty
batch emits nothing, and ``VENEUR_EMIT_NATIVE=0`` masks the tier.
"""

from __future__ import annotations

import json
import zlib

import numpy as np
import pytest

from veneur_tpu import native as jnative
from veneur_tpu.core import columnar as jcol
from veneur_tpu.core.directory import build_frag as jfrag
from veneur_tpu.core.metrics import MetricType as JType
from veneur_tpu_torch import native as tnative
from veneur_tpu_torch.core import columnar as tcol
from veneur_tpu_torch.core.directory import build_frag as tfrag
from veneur_tpu_torch.core.metrics import InterMetric, MetricType

NAN = float("nan")
INF = float("inf")

ROWS = [
    ("service.latency", ["env:prod", "host:web-1", "device:sda",
                         "region:us-east"]),
    ("über.metric", ["dc:köln", "emoji:✨sparkle", "tab:a\tb"]),
    ("plain", []),
    ("dots.and-dashes", ["k:v:w", "bare", "dup:a", "dup:b",
                         "quote:say \"hi\"", "back:a\\b"]),
    ("drop.me.please", ["env:prod"]),
]
VALS_A = [1.5, NAN, 0.1, float(2) / 3, 100000.0]
VALS_B = [1e15, 1e16, -INF, -0.0, 5e-324]
VALS_C = [20.0, -123.456, INF, 1e-310, 1.7976931348623157e308]
FAMS = [("", "COUNTER", VALS_A, None),
        (".count", "COUNTER", VALS_B, [1, 0, 1, 1, 1]),
        (".p99", "GAUGE", VALS_C, [1, 1, 1, 0, 1])]


def make_batch(col, mtype, frag, rows, fams, ts=1700000000, extras=()):
    """A one-group batch shaped like generate_columnar's output, from one
    package's classes."""
    arena = bytearray()
    clean = True
    for r, (name, tags) in enumerate(rows):
        f = frag(name, tags)
        if f is None:
            clean = False
            break
        if r:
            arena += b"\x1e"
        arena += f
    families = [col.MetricFamily(s, getattr(mtype, t),
                                 np.asarray(v, np.float64),
                                 None if m is None else np.asarray(m, bool))
                for s, t, v, m in fams]
    g = col.ColumnGroup(
        nrows=len(rows), meta_at=lambda i: (rows[i][0], rows[i][1], None),
        families=families, frag_at=lambda i: frag(*rows[i]),
        meta_blob=arena if clean else None)
    return col.ColumnarMetrics(timestamp=ts, groups=[g], extras=list(extras))


def tbatch(rows=ROWS, fams=FAMS, extras=()):
    return make_batch(tcol, MetricType, tfrag, rows, fams, extras=extras)


def jbatch(rows=ROWS, fams=FAMS):
    return make_batch(jcol, JType, jfrag, rows, fams)


def _plans():
    jp, = jbatch().emit_plan()
    tp, = tbatch().emit_plan()
    assert bytes(jp.meta_blob) == bytes(tp.meta_blob)
    return jp, tp


def _args(p):
    return (p.meta_blob, p.nrows, p.suffixes, p.family_types, p.values,
            p.masks)


def test_emit_tier_available_in_both():
    assert tnative.emit_available() and jnative.emit_available()


# -- the encoders against the JAX package's ---------------------------------


@pytest.mark.parametrize("fn", ["encode_prometheus_lines",
                                "encode_forward_lines",
                                "encode_prometheus_exposition"])
@pytest.mark.parametrize("excl", [[], ["dup", "env", "host"]],
                         ids=["all", "excl"])
def test_line_encoders_equal_jax(fn, excl):
    jp, tp = _plans()
    j = getattr(jnative, fn)(*_args(jp), excl)
    t = getattr(tnative, fn)(*_args(tp), excl)
    assert t == j and t[1] > 0


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "deflate"])
@pytest.mark.parametrize("excl", [[], ["env", "host"]], ids=["all", "excl"])
def test_datadog_series_equals_jax(compress, excl):
    jp, tp = _plans()
    extra = (1700000000, 10.0, "agg-1", b'"common:tag"', excl, ["secret"],
             ["drop."], 4)
    j = jnative.encode_datadog_series(*_args(jp), *extra, compress=compress)
    t = tnative.encode_datadog_series(*_args(tp), *extra, compress=compress)
    assert t == j and len(t[0]) > 1
    if compress:
        raw = tnative.encode_datadog_series(*_args(tp), *extra)
        assert [zlib.decompress(b) for b in t[0]] == raw[0]


@pytest.mark.parametrize("excl", [[], ["dc", "env"]], ids=["all", "excl"])
def test_signalfx_body_equals_jax(excl):
    jp, tp = _plans()
    extra = (1700000000000, "host", "h0", ["drop."], ["quote:"], excl)
    j = jnative.encode_signalfx_body(*_args(jp), *extra)
    t = tnative.encode_signalfx_body(*_args(tp), *extra)
    assert t == j and t[1] > 0


def test_deflate_equals_jax_and_zlib():
    for p in (b"", b"x", b'{"series":[]}' * 500, bytes(range(256)) * 64):
        assert tnative.deflate(p) == jnative.deflate(p) == zlib.compress(p)


# -- each sink's native path against its Python formatter --------------------


@pytest.mark.parametrize("excl", [None, {"env", "dup", "host"}],
                         ids=["all", "excl"])
@pytest.mark.parametrize("kind", ["forward", "repeater"])
def test_line_sinks_native_equals_python(kind, excl):
    from veneur_tpu_torch.sinks.forward_statsd import ForwardStatsdSink
    from veneur_tpu_torch.sinks.prometheus import PrometheusMetricSink

    cls = ForwardStatsdSink if kind == "forward" else PrometheusMetricSink
    sink = cls("127.0.0.1:9125")
    sent = []
    sink._send = sent.append
    batch = tbatch()
    sink.flush_columnar(batch, excluded_tags=excl)
    assert sink.flush_columnar_native(batch, excluded_tags=excl)
    py_lines, native_entries = sent
    assert b"\n".join(py_lines) == b"\n".join(native_entries)
    assert py_lines and len(native_entries) == 1


@pytest.mark.parametrize("excl", [None, {"dup", "emoji"}],
                         ids=["all", "excl"])
def test_exposition_native_equals_python(excl):
    from veneur_tpu_torch.sinks.prometheus import PrometheusExpositionSink

    sink = PrometheusExpositionSink("http://127.0.0.1:9091/metrics/job/v")
    posted = []
    sink._post = lambda body, count: posted.append((body, count))
    batch = tbatch()
    sink.flush_columnar(batch, excluded_tags=excl)
    assert sink.flush_columnar_native(batch, excluded_tags=excl)
    assert posted[0] == posted[1] and posted[0][1]


def test_exposition_label_rules():
    from veneur_tpu_torch.sinks.prometheus import PrometheusExpositionSink

    rows = [("m", ["a.b:1", "a_b:2", "k:v", "ümläut:x", "gone:y"])]
    batch = tbatch(rows, [("", "GAUGE", [2.0], None)])
    sink = PrometheusExpositionSink("http://127.0.0.1:9091/x")
    posted = []
    sink._post = lambda body, count: posted.append(body)
    sink.flush_columnar(batch, excluded_tags={"gone"})
    assert sink.flush_columnar_native(batch, excluded_tags={"gone"})
    assert posted[0] == posted[1] == b'm{a_b="2",k="v",_ml_ut="x"} 2.0\n'


@pytest.mark.parametrize("excl", [None, {"env", "host"}],
                         ids=["all", "excl"])
def test_datadog_native_equals_python(excl):
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink

    status = InterMetric("svc.up", 1700000000, 0.0, ["env:prod"],
                         MetricType.STATUS, message="ok")
    batch = tbatch(extras=[status])
    posted = []

    def capture(dd_metrics, checks, raw_bodies=None, raw_count=0,
                precompressed=False):
        posted.append((dd_metrics, checks, raw_bodies or [], raw_count,
                       precompressed))

    sink = DatadogMetricSink(
        interval=10.0, flush_max_per_body=4, hostname="agg-1",
        tags=["common:tag", "secret:x"], dd_hostname="https://dd",
        api_key="k", metric_name_prefix_drops=["drop."],
        excluded_tags=["secret"])
    sink._post_all = capture
    sink.flush_columnar(batch, excluded_tags=excl)
    assert sink.flush_columnar_native(batch, excluded_tags=excl)
    (py_series, py_checks, py_raw, _, _), \
        (nat_series, nat_checks, nat_raw, nat_n, nat_pre) = posted
    assert not py_raw and nat_pre
    entries = list(nat_series)
    for body in nat_raw:
        raw = zlib.decompress(body)
        assert zlib.compress(raw) == body
        parsed = json.loads(raw)
        assert len(parsed["series"]) <= 4
        entries.extend(parsed["series"])
    assert entries == py_series
    assert nat_checks == py_checks and py_checks
    assert nat_n == len(entries) - len(nat_series)
    assert [e for e in py_series for (_, v) in e["points"] if v is None]


def test_signalfx_native_equals_python():
    from veneur_tpu_torch.sinks.signalfx import SignalFxMetricSink

    batch = tbatch(fams=[
        ("", "COUNTER", [1.5, 2.0, 0.25, 4.0, 8.0], None),
        (".p50", "GAUGE", [9.0, -1.0, 0.5, 7.0, 3.0], [1, 1, 0, 1, 1])])
    sink = SignalFxMetricSink(api_key="k", hostname="h0")
    posted = []
    sink._post_buckets = lambda by_key, raw_bodies=None: posted.append(
        (by_key, raw_bodies or []))
    sink.flush_columnar(batch)
    assert sink.flush_columnar_native(batch)
    (py_buckets, py_raw), (nat_buckets, nat_raw) = posted
    assert not py_raw and not nat_buckets

    def points(buckets):
        return {k: [p for b in buckets for p in b.get(k, [])]
                for k in ("counter", "gauge")}

    assert points([json.loads(b) for b, _ in nat_raw]) == \
        points(list(py_buckets.values()))


def test_empty_batch_all_serializers():
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
    from veneur_tpu_torch.sinks.forward_statsd import ForwardStatsdSink
    from veneur_tpu_torch.sinks.prometheus import (PrometheusExpositionSink,
                                                   PrometheusMetricSink)

    empty = tcol.ColumnarMetrics(timestamp=1)
    norows = tbatch([], [("", "COUNTER", [], None)])
    for batch in (empty, norows):
        sent = []
        fwd = ForwardStatsdSink("127.0.0.1:9125")
        fwd._send = sent.append
        assert fwd.flush_columnar_native(batch)
        rep = PrometheusMetricSink("127.0.0.1:9125")
        rep._send = sent.append
        assert rep.flush_columnar_native(batch)
        assert b"".join(b"".join(e) for e in sent) == b""
        expo = PrometheusExpositionSink("http://127.0.0.1:9091/x")
        bodies = []
        expo._post = lambda body, count: bodies.append((body, count))
        assert expo.flush_columnar_native(batch)
        assert all(b == b"" for b, _ in bodies)
        dd = DatadogMetricSink(interval=10.0, flush_max_per_body=100,
                               hostname="h", tags=[],
                               dd_hostname="https://dd", api_key="k")
        dd_posted = []
        dd._post_all = lambda *a, **kw: dd_posted.append(a)
        assert dd.flush_columnar_native(batch)
        dd_metrics, checks, raw, n = dd_posted[-1]
        assert not dd_metrics and not checks and not raw and not n


@pytest.mark.parametrize("kind", ["forward", "repeater", "datadog"])
def test_separator_laden_group_falls_back_to_python(kind, monkeypatch):
    """A row whose name holds an arena separator poisons its group's
    arena: the native flush emits that group through the Python
    formatter, identically to the Python flush, and calls no encoder."""
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
    from veneur_tpu_torch.sinks.forward_statsd import ForwardStatsdSink
    from veneur_tpu_torch.sinks.prometheus import PrometheusMetricSink

    rows = [("weird\x1fname", []), ("fine", ["k:v"])]
    batch = tbatch(rows, [("", "GAUGE", [1.0, 2.0], None)])
    assert batch.groups[0].meta_blob is None
    assert batch.emit_plan() == [None]
    for fn in ("encode_forward_lines", "encode_prometheus_lines",
               "encode_datadog_series"):
        monkeypatch.setattr(tnative, fn, None)
    if kind == "datadog":
        sink = DatadogMetricSink(interval=10.0, flush_max_per_body=10,
                                 hostname="h", tags=[],
                                 dd_hostname="https://dd", api_key="k")
        sent = []
        sink._post_all = lambda m, c, raw=None, n=0, precompressed=False: \
            sent.append((m, c, raw or []))
    else:
        cls = ForwardStatsdSink if kind == "forward" else \
            PrometheusMetricSink
        sink = cls("127.0.0.1:9125")
        sent = []
        sink._send = sent.append
    sink.flush_columnar(batch)
    assert sink.flush_columnar_native(batch)
    assert sent[0] == sent[1] and len(sent[0][0] if kind == "datadog"
                                      else sent[0]) == 2


def test_emit_masked_by_env(monkeypatch):
    from veneur_tpu_torch.sinks.datadog import DatadogMetricSink
    from veneur_tpu_torch.sinks.forward_statsd import ForwardStatsdSink
    from veneur_tpu_torch.sinks.prometheus import (PrometheusExpositionSink,
                                                   PrometheusMetricSink)
    from veneur_tpu_torch.sinks.signalfx import SignalFxMetricSink

    monkeypatch.setenv("VENEUR_EMIT_NATIVE", "0")
    assert not tnative.emit_available()
    batch = tbatch()
    for sink in (DatadogMetricSink(interval=10.0, flush_max_per_body=100,
                                   hostname="h", tags=[],
                                   dd_hostname="https://dd", api_key="k"),
                 ForwardStatsdSink("127.0.0.1:9125"),
                 PrometheusMetricSink("127.0.0.1:9125"),
                 PrometheusExpositionSink("http://127.0.0.1:9091/x"),
                 SignalFxMetricSink(api_key="k", hostname="h")):
        assert not sink.flush_columnar_native(batch), sink.name()
