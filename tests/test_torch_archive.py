"""The port's flush archive against the JAX package's, on the CPU (after
tests/test_archive.py).

The same numpy-seeded interval goes through ``veneur_tpu.core.worker.
DeviceWorker`` and ``veneur_tpu_torch.core.worker.DeviceWorker(device=
"cpu")``; each snapshot's columnar batch is archived as VMB1 by each
package, and the frames are equal byte for byte: native and Python
sections, routed groups, excluded tags, the object path. The corruption
matrix raises in both decoders. The segmented writer leaves the same
segment files; the archive sink keeps the same delivery ledger under a
failing disk; replay merges once under the dedup envelope. A JAX-written
archive replays in a port global, and a port archive in a JAX global, and
the counters and gauges each global flushes are bitwise the archiving
server's.
"""

from __future__ import annotations

import os
import struct
import zlib
from collections import Counter

import numpy as np
import pytest

from veneur_tpu.archive import replay as jreplay
from veneur_tpu.archive import sink as jsink
from veneur_tpu.archive import wire as jwire
from veneur_tpu.core.config import Config as JConfig
from veneur_tpu.core.flusher import device_quantiles as jdq
from veneur_tpu.core.flusher import generate_columnar as jgen
from veneur_tpu.core.metrics import HistogramAggregates as JAggs
from veneur_tpu.core.metrics import InterMetric as JInter
from veneur_tpu.core.metrics import MetricType as JType
from veneur_tpu.core.server import Server as JServer
from veneur_tpu.core.worker import DeviceWorker as JWorker
from veneur_tpu.distributed.import_server import ImportServer as JImport
from veneur_tpu.protocol import dogstatsd as jdog
from veneur_tpu.sinks.delivery import DeliveryPolicy as JPolicy
from veneur_tpu_torch.archive import replay as treplay
from veneur_tpu_torch.archive import sink as tsink
from veneur_tpu_torch.archive import wire as twire
from veneur_tpu_torch.core.config import Config as TConfig
from veneur_tpu_torch.core.flusher import device_quantiles as tdq
from veneur_tpu_torch.core.flusher import generate_columnar as tgen
from veneur_tpu_torch.core.metrics import HistogramAggregates as TAggs
from veneur_tpu_torch.core.metrics import InterMetric as TInter
from veneur_tpu_torch.core.metrics import MetricType as TType
from veneur_tpu_torch.core.server import Server as TServer
from veneur_tpu_torch.core.worker import DeviceWorker as TWorker
from veneur_tpu_torch.distributed.import_server import ImportServer as TImport
from veneur_tpu_torch.protocol import dogstatsd as tdog
from veneur_tpu_torch.sinks.delivery import DeliveryPolicy as TPolicy

PCTS = [0.5, 0.99]
AGG_NAMES = ["min", "max", "count"]
NOW = 1234

PKGS = {
    "jax": dict(wire=jwire, sink=jsink, replay=jreplay, Worker=JWorker,
                dq=jdq, gen=jgen, Aggs=JAggs, dog=jdog, Server=JServer,
                Config=JConfig, Import=JImport, Policy=JPolicy,
                Inter=JInter, Type=JType, kw={}),
    "port": dict(wire=twire, sink=tsink, replay=treplay, Worker=TWorker,
                 dq=tdq, gen=tgen, Aggs=TAggs, dog=tdog, Server=TServer,
                 Config=TConfig, Import=TImport, Policy=TPolicy,
                 Inter=TInter, Type=TType, kw={"device": "cpu"}),
}


def _lines(seed: int = 7) -> list[bytes]:
    """tests/test_archive.py's interval: digests, counters, gauges, a set,
    a routed counter and a status check."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(12):
        for v in rng.gamma(2.0, 50.0, 15):
            out.append(f"h{i}:{v:.3f}|ms|#k:{i}".encode())
    for i in range(20):
        out.append(f"c{i}:3|c|#a:{i},b:x".encode())
        out.append(f"g{i}:7.25|g".encode())
    for j in range(40):
        out.append(f"s0:item{j}|s".encode())
    out.append(b"routed:1|c|#veneursinkonly:datadog")
    return out


def _batch(pkg: str, now: int = NOW):
    p = PKGS[pkg]
    w = p["Worker"](**p["kw"])
    for line in _lines():
        w.process_metric(p["dog"].parse_metric(line))
    w.process_metric(p["dog"].parse_service_check(
        b"_sc|svc.check|1|m:all good"))
    aggs = p["Aggs"].from_names(AGG_NAMES)
    snap = w.flush(p["dq"](PCTS, aggs), interval_s=10.0)
    return p["gen"](snap, True, PCTS, aggs, now=now)


@pytest.fixture(scope="module")
def batches():
    return {pkg: _batch(pkg) for pkg in PKGS}


def _canon(m):
    """Bit-exact sample identity (timestamps and hostnames aside)."""
    get = (m.get if isinstance(m, dict) else
           lambda k: getattr(m, k))
    return (get("name"), tuple(sorted(get("tags"))), int(get("type")),
            struct.pack("<d", float(get("value"))).hex())


def _canon_flush(out):
    mats = out.materialize() if hasattr(out, "materialize") else list(out)
    return Counter(map(_canon, mats))


def _objects(pkg: str):
    p = PKGS[pkg]
    return [
        p["Inter"](name="c", timestamp=99, value=17.0, tags=["a:1"],
                   type=p["Type"].COUNTER),
        p["Inter"](name="g", timestamp=99, value=0.1 + 0.2, tags=[],
                   type=p["Type"].GAUGE),
        p["Inter"](name="chk", timestamp=99, value=1.0, tags=["t:x"],
                   type=p["Type"].STATUS, message="all good",
                   hostname="h9"),
    ]


# -- the VMB1 wire ------------------------------------------------------------


def test_object_path_roundtrip_is_exact():
    frames = {pkg: PKGS[pkg]["wire"].encode_metrics(_objects(pkg),
                                                    hostname="me")
              for pkg in PKGS}
    assert frames["port"] == frames["jax"]
    frame, n = frames["port"]
    assert n == 3
    out = twire.decode_flush(frame)
    assert out == jwire.decode_flush(frame)
    assert out["hostname"] == "me" and out["timestamp"] == 99
    assert [s["name"] for s in out["samples"]] == ["c", "g", "chk"]
    assert struct.pack("<d", out["samples"][1]["value"]) == struct.pack(
        "<d", 0.1 + 0.2)
    assert out["samples"][2]["message"] == "all good"
    assert out["samples"][2]["hostname"] == "h9"


def test_columnar_frame_matches_materialize_bit_exact(batches):
    frame, n = twire.encode_flush(batches["port"], "host1", use_native=False)
    assert (frame, n) == jwire.encode_flush(batches["jax"], "host1",
                                            use_native=False)
    mats = batches["port"].materialize()
    assert n == len(mats)
    decoded = twire.decode_flush(frame)
    assert sorted(map(_canon, decoded["samples"])) == sorted(
        map(_canon, mats))


def test_native_and_python_frames_byte_identical(batches):
    twire.reset_section_counts()
    py = twire.encode_flush(batches["port"], "host1", use_native=False)
    assert twire.SECTION_COUNTS["native"] == 0
    python_sections = twire.SECTION_COUNTS["python"]
    assert python_sections > 0
    twire.reset_section_counts()
    nat = twire.encode_flush(batches["port"], "host1", use_native=True)
    # every plan-capable group went through the native encoder, the rest
    # (no emit plan) through Python
    planned = sum(plan is not None and bool(g.families) and g.nrows > 0
                  for g, plan in zip(batches["port"].groups,
                                     batches["port"].emit_plan()))
    assert planned > 0
    assert twire.SECTION_COUNTS == {"native": planned,
                                    "python": python_sections - planned}
    assert py == nat
    assert nat == jwire.encode_flush(batches["jax"], "host1",
                                     use_native=True)
    assert nat == jwire.encode_flush(batches["jax"], "host1",
                                     use_native=False)


def test_routing_honors_sink_name(batches):
    def frames(pkg, **kw):
        return PKGS[pkg]["wire"].encode_flush(batches[pkg],
                                              use_native=False, **kw)

    for kw in ({}, {"sink_name": "archive"}, {"sink_name": "datadog"}):
        assert frames("port", **kw) == frames("jax", **kw)
    _, total = frames("port")
    frame_arch, n_arch = frames("port", sink_name="archive")
    names_arch = {s["name"] for s in twire.decode_flush(frame_arch)["samples"]}
    assert "routed" not in names_arch
    assert "svc.check" in names_arch
    frame_dd, n_dd = frames("port", sink_name="datadog")
    names_dd = {s["name"] for s in twire.decode_flush(frame_dd)["samples"]}
    assert "routed" in names_dd
    assert n_dd == total and n_arch == total - 1


def test_excluded_tags_rewrite_rows(batches):
    frame, n = twire.encode_flush(batches["port"], excluded_tags={"a"},
                                  use_native=False)
    assert (frame, n) == jwire.encode_flush(
        batches["jax"], excluded_tags={"a"}, use_native=False)
    # exclusion takes the Python encoder even when native is asked for
    assert twire.encode_flush(batches["port"], excluded_tags={"a"},
                              use_native=True) == (frame, n)
    decoded = twire.decode_flush(frame)
    assert n == len(batches["port"].materialize())
    assert all(not t.startswith("a:")
               for s in decoded["samples"] for t in s["tags"])
    assert any("b:x" in s["tags"] for s in decoded["samples"])


def _good():
    good, _ = twire.encode_metrics(
        [TInter(name="x", timestamp=1, value=2.0, tags=[],
                type=TType.GAUGE)])
    return good


def _corruptions():
    good = _good()
    flipped = bytearray(good)
    flipped[12] ^= 0x40
    yield "bad-magic", b"XXXX" + good[4:]
    yield "empty", b""
    yield "truncated-header", good[:6]
    yield "truncated-payload", good[:-3]
    yield "payload-bitflip", bytes(flipped)
    yield "trailing-bytes", good + b"\x00"
    yield "unknown-section-kind", twire._frame(1, "", [(7, b"")])
    yield "truncated-section", twire._frame(1, "", [(1, b"\x01\x00")])
    yield "columnar-plane-mismatch", twire._frame(1, "", [(0, (
        struct.pack("<I", 1) + struct.pack("<I", 1) + b"n"
        + struct.pack("<I", 1)
        + struct.pack("<IH", 0, 0)
        + struct.pack("<I", 1) + struct.pack("<BI", 0, 0)
        + b"\x00" * 5))])


@pytest.mark.parametrize("name,frame", list(_corruptions()),
                         ids=[n for n, _ in _corruptions()])
def test_corruption_matrix_raises_never_garbage(name, frame):
    with pytest.raises(ValueError) as port_err:
        twire.decode_flush(frame)
    with pytest.raises(ValueError) as jax_err:
        jwire.decode_flush(frame)
    assert str(port_err.value) == str(jax_err.value)


def test_decoder_accepts_what_the_matrix_mutated():
    good = _good()
    assert good == jwire.encode_metrics(
        [JInter(name="x", timestamp=1, value=2.0, tags=[],
                type=JType.GAUGE)])[0]
    assert twire.decode_flush(good)["samples"][0]["name"] == "x"


# -- the segmented writer -----------------------------------------------------


def _segments(d) -> dict:
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def test_writer_rotates_prunes_and_reads_back(tmp_path):
    frames = [f"frame-{i:04d}".encode() * 4 for i in range(10)]
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        w = PKGS[pkg]["sink"].SegmentedArchiveWriter(
            str(d), max_segment_bytes=120, max_segments=2)
        for f in frames:
            w.write(f, 1.0)
        w.close()
        got[pkg] = (_segments(d), PKGS[pkg]["sink"].read_archive(str(d)))
    assert got["port"] == got["jax"]
    segs, back = got["port"]
    assert 1 <= len(segs) <= 2
    assert all(n.startswith("metrics-") and n.endswith(".vmb") for n in segs)
    assert back and back == frames[-len(back):]


def test_writer_seq_resumes_without_clobbering(tmp_path):
    got = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        mod = PKGS[pkg]["sink"]
        w = mod.SegmentedArchiveWriter(str(d), max_segment_bytes=1,
                                       max_segments=8)
        w.write(b"first", 1.0)
        w.close()
        w2 = mod.SegmentedArchiveWriter(str(d), max_segment_bytes=1,
                                        max_segments=8)
        w2.write(b"second", 1.0)
        w2.close()
        got[pkg] = (_segments(d), mod.read_archive(str(d)))
    assert got["port"] == got["jax"]
    assert got["port"][1] == [b"first", b"second"]
    assert len(got["port"][0]) == 2


def test_read_archive_stops_at_torn_tail(tmp_path):
    for pkg in PKGS:
        d = tmp_path / pkg
        mod = PKGS[pkg]["sink"]
        w = mod.SegmentedArchiveWriter(str(d))
        w.write(b"good-frame", 1.0)
        w.write(b"also-good", 1.0)
        w.close()
        seg = d / sorted(os.listdir(d))[-1]
        with open(seg, "ab") as fh:
            fh.write(struct.pack("<II", 100, zlib.crc32(b"never-written")))
            fh.write(b"partial")
    assert _segments(tmp_path / "port") == _segments(tmp_path / "jax")
    for reader in (tsink.read_archive, jsink.read_archive):
        assert reader(str(tmp_path / "port")) == [b"good-frame",
                                                  b"also-good"]


# -- the archive sink under a failing disk ------------------------------------


class _FlakyWriter:
    def __init__(self):
        self.fail = False
        self.frames = []

    def write(self, payload: bytes, timeout_s: float) -> None:
        if self.fail:
            raise OSError("disk full")
        self.frames.append(payload)

    def close(self) -> None:
        pass


def _policy(pkg: str, **kw):
    base = dict(retry_max=0, breaker_threshold=0,
                spill_max_bytes=1 << 20, spill_max_payloads=16,
                timeout_s=1.0, deadline_s=1.0, backoff_base_s=0.0,
                backoff_max_s=0.0)
    base.update(kw)
    return PKGS[pkg]["Policy"](**base)


def _ledger(sink) -> tuple:
    st = sink.delivery.stats()
    return (sink.metrics_flushed, sink.metrics_dropped, sink.metrics_deferred,
            sink.frames_encoded, sink.bytes_encoded,
            {k: st[k] for k in ("delivered_payloads", "dropped_payloads",
                                "spilled_payloads", "accepted_payloads")},
            sink.delivery.conserved())


def test_sink_spills_and_redelivers_on_disk_recovery(batches):
    got = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        _, n = p["wire"].encode_flush(batches[pkg], sink_name="archive",
                                      use_native=False)
        writer = _FlakyWriter()
        sink = p["sink"].MetricArchiveSink(writer, hostname="h",
                                           delivery=_policy(pkg))
        writer.fail = True
        sink.flush_columnar(batches[pkg])
        first = _ledger(sink)
        assert sink.metrics_deferred == n and sink.metrics_flushed == 0
        writer.fail = False
        sink.flush_columnar(batches[pkg])
        got[pkg] = (writer.frames, first, _ledger(sink), n)
    assert got["port"] == got["jax"]
    frames, _first, (flushed, *_rest, conserved), n = got["port"]
    assert len(frames) == 2 and flushed == n and conserved


def test_sink_drops_honestly_with_spill_disabled(batches):
    got = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        _, n = p["wire"].encode_flush(batches[pkg], sink_name="archive",
                                      use_native=False)
        writer = _FlakyWriter()
        sink = p["sink"].MetricArchiveSink(
            writer, delivery=_policy(pkg, spill_max_bytes=0,
                                     spill_max_payloads=0))
        writer.fail = True
        sink.flush_columnar(batches[pkg])
        got[pkg] = (_ledger(sink), n)
    assert got["port"] == got["jax"]
    (flushed, dropped, deferred, *_r, st, conserved), n = got["port"]
    assert dropped == n and flushed == 0 and deferred == 0
    assert st["dropped_payloads"] == 1 and conserved


# -- capture and replay ------------------------------------------------------


def _archive_server(pkg: str, d, lines, hostname="a", **cfg):
    """One flush of ``lines`` through a server whose only metric sink is
    the archive; its flushed samples and the archive's frames."""
    p = PKGS[pkg]
    sink = p["sink"].MetricArchiveSink(
        p["sink"].SegmentedArchiveWriter(str(d)), hostname=hostname)
    srv = p["Server"](p["Config"](interval="10s", **cfg),
                      metric_sinks=[sink], **p["kw"])
    try:
        for line in lines:
            srv.process_metric_packet(line)
        expected = _canon_flush(srv.flush(now=NOW))
    finally:
        srv.shutdown()
    return sink, expected, p["sink"].read_archive(str(d))


def _replay_into(pkg: str, frames, dedup_runs: int = 0):
    """A fresh global of ``pkg`` fed the frames through its import server
    (plainly, or ``dedup_runs`` times under the dedup envelope); its
    flushed samples, the replay stats and the import server."""
    p = PKGS[pkg]
    srv = p["Server"](p["Config"](interval="10s"), **p["kw"])
    try:
        imp = p["Import"](srv)
        if dedup_runs:
            stats = [p["replay"].replay_frames(
                frames, apply_wire=imp.handle_wire, dedup=True)
                for _ in range(dedup_runs)]
        else:
            stats = [p["replay"].replay_frames(
                frames, apply_batch=imp.handle_batch)]
        out = srv.flush(now=NOW)
        return _canon_flush(out), stats, imp
    finally:
        srv.shutdown()


REPLAY_LINES = [line for i in range(30) for line in (
    f"rt.c{i}:{3 * i + 1}|c".encode(), f"rt.g{i}:{i}.625|g".encode(),
    f"rt.t{i}:{i}.5|ms".encode())]


def test_capture_replay_bit_identical(tmp_path):
    got = {}
    for pkg in PKGS:
        sink, expected, frames = _archive_server(
            pkg, tmp_path / pkg, REPLAY_LINES, percentiles=PCTS,
            aggregates=AGG_NAMES)
        assert frames and sink.metrics_flushed == sum(expected.values())
        flushed, [stats], _imp = _replay_into(pkg, frames)
        assert stats["frames_applied"] == len(frames)
        assert stats["skipped_status"] == stats["skipped_inexact"] == 0
        assert flushed == expected
        got[pkg] = (frames, expected, stats)
    assert got["port"] == got["jax"]


def test_replay_twice_with_dedup_merges_once(tmp_path):
    lines = [f"dd.c{i}:5|c".encode() for i in range(10)]
    got = {}
    for pkg in PKGS:
        _sink, expected, frames = _archive_server(pkg, tmp_path / pkg, lines)
        flushed, (s1, s2), imp = _replay_into(pkg, frames, dedup_runs=2)
        assert s1["sender"] == s2["sender"]
        assert s1["sender"].startswith("archive:")
        assert imp.metrics_deduped == s2["imported"] > 0
        assert flushed == expected
        got[pkg] = (frames, s1, s2, imp.metrics_deduped)
    assert got["port"] == got["jax"]


def test_replay_requires_wire_entrypoint_for_dedup():
    for mod in (treplay, jreplay):
        with pytest.raises(ValueError):
            mod.replay_frames([], apply_batch=lambda b: None, dedup=True)


def test_replay_skips_status_and_inexact_counters():
    samples = [
        {"name": "ok", "tags": ["a:1"], "type": int(TType.COUNTER),
         "value": 4.0, "message": "", "hostname": ""},
        {"name": "frac", "tags": [], "type": int(TType.COUNTER),
         "value": 1.5, "message": "", "hostname": ""},
        {"name": "chk", "tags": [], "type": int(TType.STATUS),
         "value": 1.0, "message": "m", "hostname": "h"},
        {"name": "g", "tags": [], "type": int(TType.GAUGE),
         "value": 2.5, "message": "", "hostname": ""},
    ]
    batch, skipped = treplay.samples_to_batch(samples)
    jbatch, jskipped = jreplay.samples_to_batch(samples)
    assert batch.SerializeToString() == jbatch.SerializeToString()
    assert [m.name for m in batch.metrics] == ["ok", "g"]
    assert skipped == jskipped == {"status": 1, "inexact": 1}


def test_replay_counts_undecodable_frames_not_fatal():
    good = _good()
    applied = []
    stats = treplay.replay_frames([good, b"garbage", good],
                                  apply_batch=applied.append)
    jstats = jreplay.replay_frames([good, b"garbage", good],
                                   apply_batch=lambda b: None)
    assert stats == jstats
    assert stats["frames_undecodable"] == 1
    assert stats["frames_applied"] == 2 and len(applied) == 2


def test_sender_token_is_content_derived():
    a = treplay.archive_sender_token([b"f1", b"f2"])
    assert a == jreplay.archive_sender_token([b"f1", b"f2"])
    assert a == treplay.archive_sender_token([b"f1", b"f2"])
    assert a != treplay.archive_sender_token([b"f2", b"f1"])
    assert a.startswith("archive:")


# -- the server's archive sink on the native emit path -------------------------


def test_server_flush_drives_archive_sink_natively(tmp_path):
    lines = [line for i in range(8) for line in (
        f"nv{i}:2|c".encode(), f"nt{i}:3.5|ms".encode())]
    got = {}
    twire.reset_section_counts()
    for pkg in PKGS:
        sink, expected, frames = _archive_server(
            pkg, tmp_path / pkg, lines, hostname="nat", percentiles=[0.5],
            aggregates=AGG_NAMES)
        [frame] = frames
        decoded = PKGS[pkg]["wire"].decode_flush(frame)
        assert decoded["hostname"] == "nat"
        assert Counter(map(_canon, decoded["samples"])) == expected
        assert sink.metrics_flushed == sum(expected.values())
        assert sink.frames_encoded == 1
        assert sink.bytes_encoded == len(frame)
        got[pkg] = frame
    assert got["port"] == got["jax"]
    # the server's negotiation took the native encoder, never Python
    assert twire.SECTION_COUNTS["native"] > 0
    assert twire.SECTION_COUNTS["python"] == 0


# -- the archive carried across the packages ----------------------------------


CROSS_LINES = REPLAY_LINES + [
    b"rt.neg:-7|c", b"rt.tiny:5e-324|g", b"rt.big:1.7976931348623157e308|g",
    b"rt.c0:9|c|#env:x", b"rt.g0:0.1|g|#env:x", b"rt.g0:0.30000000000000004|g"]


def _scalars(counter: Counter) -> Counter:
    """The counters and gauges of a canonical flush."""
    keep = {int(TType.COUNTER), int(TType.GAUGE)}
    return Counter({k: v for k, v in counter.items() if k[2] in keep})


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")],
                         ids=["jax-archive-into-port", "port-archive-into-jax"])
def test_archive_replays_across_packages(tmp_path, writer, reader):
    _sink, expected, frames = _archive_server(
        writer, tmp_path / "arch", CROSS_LINES, percentiles=PCTS,
        aggregates=AGG_NAMES)
    flushed, [stats], _imp = _replay_into(reader, frames)
    assert stats["frames_applied"] == len(frames) == 1
    assert stats["skipped_inexact"] == 0
    assert flushed == _scalars(expected)
    # the same frames in the writer's own global give the same rows
    own, [own_stats], _ = _replay_into(writer, frames)
    assert own == flushed and own_stats == stats
    # and the dedup replay run twice merges once in the reading package
    flushed2, (s1, s2), imp = _replay_into(reader, frames, dedup_runs=2)
    assert flushed2 == flushed
    assert imp.metrics_deduped == s2["imported"] == s1["imported"] > 0
