"""The port's counterparts of the JAX system's last pieces, against the JAX
package's on the CPU.

* ``td.cdf`` (veneur_tpu_torch/ops/tdigest.py): on pools the JAX
  ``add_batch`` builds and ``pool_from_numpy`` carries across, at values
  inside, at, next to and past each row's bounds, denormal values and
  signed zeros: within 1e-6 of the JAX package's (whose ``jnp.sum`` has
  no fixed order), exactly 0.0 and 1.0 at or past the bounds, NaN on the
  same rows; and the twin of tests/test_tdigest.py's round trip.
* tools/port_tdigest_analysis.py against tools/tdigest_analysis.py: the
  same CSV bytes, estimates bitwise, the q-error bound met.
* tools/port_replay_archive.py against tools/replay_archive.py: the same
  ``--inspect`` line; ``--target`` into a port global over gRPC gives
  the flushed counters and gauges bitwise; ``--dedup`` twice merges once.
* tools/port_fuzz_differential.py: every target but query clean at a
  fixed seed on the CPU, every target reporting a planted fault (one
  flipped bit or verdict in the function it tests), no target running
  without a device asked for where there is no card, ``--tally`` writing
  only its own file. The query target's quantile check diverges in both
  packages on the same case, a slot past the row's last live centroid
  (ROADMAP §3, F9).
"""

from __future__ import annotations

import contextlib
import io
import json
import random
import struct
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from veneur_tpu.ops import query as jqops
from veneur_tpu.ops import tdigest as jtd
from veneur_tpu_torch import native
from veneur_tpu_torch.archive import sink as tsink
from veneur_tpu_torch.core.config import Config
from veneur_tpu_torch.core.server import Server
from veneur_tpu_torch.core.worker import DeviceWorker
from veneur_tpu_torch.distributed import codec, gob
from veneur_tpu_torch.distributed.import_server import ImportServer
from veneur_tpu_torch.ops import exactnum as exn
from veneur_tpu_torch.ops import hll
from veneur_tpu_torch.ops import tdigest as ttd
from veneur_tpu_torch.protocol import dogstatsd, ssf_wire

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import fuzz_differential as jfuzz  # noqa: E402
import port_fuzz_differential as fuzz  # noqa: E402
import port_replay_archive as replay_cli  # noqa: E402
import port_tdigest_analysis as analysis  # noqa: E402
import replay_archive as jreplay_cli  # noqa: E402
import tdigest_analysis as janalysis  # noqa: E402

C = 128
CPU = torch.device("cpu")


def _no_card_raises(call) -> None:
    """``call()`` leaves the device to its default: on a host without
    CUDA it raises before running anything; with a card it runs there."""
    if torch.cuda.is_available():
        assert call() == 0
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


# -- td.cdf -------------------------------------------------------------------


def _jax_pool(k: int, seed: int, weighted: bool):
    """A JAX pool of k rows from add_batch: rows 0 and 1 empty, row 2 a
    single sample, row 3 signed zeros among its samples, row 4 denormal
    samples among its samples, the rest gamma samples."""
    rng = np.random.default_rng(seed)
    n = 60 * k
    rows = rng.integers(5, k, n).astype(np.int32)
    vals = rng.gamma(2.0, 30.0, n).astype(np.float32)
    rows[:1] = 2
    rows[1:41] = 3
    vals[1:21] = np.where(np.arange(20) % 2 == 0, 0.0, -0.0)
    rows[41:81] = 4
    vals[41:61] = rng.integers(1, 2 ** 20, 20).astype(np.float32) * 1e-45
    wts = (rng.choice([0.5, 1.0, 3.0], n) if weighted
           else np.ones(n)).astype(np.float32)
    out = jtd.add_batch(*jtd.init_pool(k, C), jnp.asarray(rows),
                        jnp.asarray(vals), jnp.asarray(wts))
    return jtd.TDigestPool(*out[:5])


def _value_sets(dmin: np.ndarray, dmax: np.ndarray, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    k = dmin.shape[0]
    with np.errstate(invalid="ignore", over="ignore"):
        inside = (dmin + rng.random(k) * (dmax - dmin)).astype(np.float32)
    den = rng.integers(1, 2 ** 20, k).astype(np.float32) * np.float32(1e-45)
    return {
        "min": dmin, "max": dmax,
        "below_min": np.nextafter(dmin, np.float32(-np.inf)),
        "above_min": np.nextafter(dmin, np.float32(np.inf)),
        "below_max": np.nextafter(dmax, np.float32(-np.inf)),
        "above_max": np.nextafter(dmax, np.float32(np.inf)),
        "inside": inside,
        "outside": np.where(rng.random(k) < 0.5, dmin - 1, dmax + 1),
        "denormal": np.where(rng.random(k) < 0.5, den, -den),
        "signed_zero": np.where(np.arange(k) % 2 == 0, np.float32(0.0),
                                np.float32(-0.0)),
    }


@pytest.mark.parametrize("weighted", [False, True])
def test_cdf_equals_jax(weighted):
    jpool = _jax_pool(24, 3 + weighted, weighted)
    tpool = ttd.pool_from_numpy(jtd.pool_to_numpy(jpool), "cpu")
    dmin, dmax = np.asarray(jpool.min), np.asarray(jpool.max)
    z = exn.flush_denormals
    fmin, fmax = z(tpool.min), z(tpool.max)
    for name, v in _value_sets(dmin, dmax, 9 + weighted).items():
        v = np.array(v, np.float32)
        j = np.asarray(jtd.cdf(jpool.means, jpool.weights, jpool.min,
                               jpool.max, jnp.asarray(v)))
        t = ttd.cdf(tpool.means, tpool.weights, tpool.min, tpool.max,
                    torch.from_numpy(v)).numpy()
        nan = np.isnan(j)
        assert np.array_equal(nan, np.isnan(t)), name
        assert nan[:2].all() and not nan[2:].any(), name
        assert np.abs(t[~nan] - j[~nan]).max() <= 1e-6, name
        fv = z(torch.from_numpy(v))
        # the JAX function's order: at or past the max wins over the min
        high = (fv >= fmax).numpy() & ~nan
        low = (fv <= fmin).numpy() & ~nan & ~high
        assert (t[low] == 0.0).all() and (j[low] == 0.0).all(), name
        assert (t[high] == 1.0).all() and (j[high] == 1.0).all(), name
        fin = t[~nan]
        assert ((fin >= 0.0) & (fin <= 1.0)).all(), name


def test_cdf_roundtrip():
    """tests/test_tdigest.py's round trip on the port's digest."""
    rng = np.random.default_rng(17)
    vals = rng.uniform(0, 100, 20000).astype(np.float32)
    pool = ttd.init_pool(1, C, device="cpu")
    for lo in range(0, len(vals), 4096):
        chunk = torch.from_numpy(vals[lo:lo + 4096])
        n = chunk.shape[0]
        pool = ttd.TDigestPool(*ttd.add_batch(
            *pool, torch.zeros(n, dtype=torch.int32), chunk,
            torch.ones(n))[:5])

    def cdf_at(v: float) -> float:
        return float(ttd.cdf(pool.means, pool.weights, pool.min, pool.max,
                             torch.tensor([v], dtype=torch.float32))[0])

    for v in (10.0, 50.0, 90.0):
        assert abs(cdf_at(v) - v / 100.0) < 0.01, v
    assert cdf_at(-1.0) == 0.0 and cdf_at(101.0) == 1.0


# -- the t-digest analysis ----------------------------------------------------


@pytest.mark.parametrize("name", ["gamma", "heavy_tail"])
def test_analysis_estimates_equal_jax(tmp_path, name):
    port = analysis.analyze(name, analysis.DISTRIBUTIONS[name], 20_000,
                            100.0, str(tmp_path / "port"), device="cpu")
    jax_r = janalysis.analyze(name, janalysis.DISTRIBUTIONS[name], 20_000,
                              100.0, str(tmp_path / "jax"))
    got = (tmp_path / "port" / f"{name}.csv").read_bytes()
    assert got == (tmp_path / "jax" / f"{name}.csv").read_bytes()
    est = np.array([line.split(",")[1] for line in
                    got.decode().splitlines()[1:]], np.float32)
    assert np.array_equal(est.view(np.uint32),
                          port["estimated"].view(np.uint32))
    assert port["max_q_err"] == jax_r["max_q_err"] < analysis.MAX_Q_ERR
    assert port["centroids"] == jax_r["centroids"]


def test_analysis_cli_on_the_cpu(tmp_path, capsys):
    assert analysis.main(["--device", "cpu", "--samples", "5000",
                          "--out-dir", str(tmp_path),
                          "--distributions", "uniform", "bimodal"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bimodal.csv", "uniform.csv"]
    assert "worst-case q-err" in capsys.readouterr().out


def test_analysis_cli_needs_a_card_by_default(tmp_path):
    _no_card_raises(lambda: analysis.main([
        "--samples", "1000", "--out-dir", str(tmp_path),
        "--distributions", "gamma"]))
    if not torch.cuda.is_available():
        assert not tmp_path.exists() or not any(tmp_path.iterdir())


# -- the archive replay CLI ---------------------------------------------------


NOW = 1_700_000_000
ARCHIVE_LINES = [line for i in range(30) for line in (
    f"rp.c{i}:{3 * i + 1}|c|#k:{i % 4}".encode(),
    f"rp.g{i}:{i}.625|g".encode(), f"rp.t{i}:{i}.5|ms".encode())] + [
    b"_sc|rp.check|1|m:all good"]


def _scalars(metrics) -> dict:
    """Counters and gauges by (name, tags, type), as an import merges
    them, each value's bits."""
    out: dict = {}
    for m in metrics:
        if m.type.name not in ("COUNTER", "GAUGE"):
            continue
        key = (m.name, tuple(sorted(m.tags)), m.type.name)
        v = float(m.value) + (out[key] if m.type.name == "COUNTER"
                              and key in out else 0.0)
        out[key] = v
    return {k: struct.pack("<d", v) for k, v in out.items()}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """A port server's archive directory after one flush, its frames and
    the flushed counters and gauges."""
    d = tmp_path_factory.mktemp("archive")
    sink = tsink.MetricArchiveSink(tsink.SegmentedArchiveWriter(str(d)),
                                   hostname="a")
    srv = Server(Config(interval="10s", percentiles=[0.5, 0.99],
                        aggregates=["min", "max", "count"]),
                 metric_sinks=[sink], device="cpu")
    try:
        for line in ARCHIVE_LINES:
            srv.process_metric_packet(line)
        flushed = srv.flush(now=NOW).materialize()
    finally:
        srv.shutdown()
    frames = tsink.read_archive(str(d))
    assert frames
    return d, frames, _scalars(flushed)


def _run_cli(main, argv) -> tuple[int, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_replay_inspect_equals_jax(archive, monkeypatch):
    d, frames, _ = archive
    for tail in (["--inspect"], []):
        rc, port = _run_cli(replay_cli.main, ["--dir", str(d), *tail])
        monkeypatch.setattr(sys, "argv",
                            ["replay_archive.py", "--dir", str(d), *tail])
        jrc, jax_line = _run_cli(lambda _argv: jreplay_cli.main(), None)
        assert rc == jrc == 0
        assert port == jax_line
        assert port["frames"] == len(frames) and port["skipped_status"] == 1
        assert port["mode"] == "inspect" and port["importable"] > 0


def test_replay_empty_dir_exits_1(tmp_path, monkeypatch):
    rc, port = _run_cli(replay_cli.main, ["--dir", str(tmp_path)])
    monkeypatch.setattr(sys, "argv",
                        ["replay_archive.py", "--dir", str(tmp_path)])
    jrc, jax_line = _run_cli(lambda _argv: jreplay_cli.main(), None)
    assert rc == jrc == 1 and port == jax_line


def _replay_into_global(d, runs: int, *flags):
    glob = Server(Config(interval="10s"), device="cpu")
    imp = ImportServer(glob)
    try:
        imp.start_grpc("127.0.0.1:0")
        lines = []
        for _ in range(runs):
            rc, line = _run_cli(replay_cli.main, [
                "--dir", str(d), "--target", imp.address, *flags])
            assert rc == 0, line
            lines.append(line)
        got = _scalars(glob.flush(now=NOW))
    finally:
        imp.stop()
        glob.shutdown()
    return got, lines, imp


def test_replay_target_is_bitwise(archive):
    d, frames, expected = archive
    got, [line], imp = _replay_into_global(d, 1)
    assert got == expected
    assert line["mode"] == "replay" and line["frames_applied"] == len(frames)
    assert line["imported"] == imp.received_metrics > 0
    assert line["skipped_inexact"] == 0 and line["skipped_status"] == 1


def test_replay_dedup_twice_merges_once(archive):
    d, _frames, expected = archive
    got, (first, second), imp = _replay_into_global(d, 2, "--dedup")
    assert got == expected
    assert first["sender"] == second["sender"]
    assert first["sender"].startswith("archive:")
    assert imp.metrics_deduped == second["imported"] == first["imported"]


def test_replay_send_failure_is_one_json_line(archive):
    d, _frames, _ = archive
    rc, line = _run_cli(replay_cli.main, [
        "--dir", str(d), "--target", "127.0.0.1:1", "--timeout-s", "0.5"])
    assert rc == 1 and line["error"].startswith("send failed")


# -- the differential fuzz harness --------------------------------------------


SEED = 12
CLEAN = [t for t in fuzz.TARGETS if t != "query"]


@pytest.fixture(scope="module")
def native_built():
    """The native libraries built before any target's clock starts."""
    native.load_library()
    native.load_loadgen_library()
    codec._native_codec()


def _run(name: str, seconds: float, seed: int = SEED) -> tuple[int, dict]:
    stats: dict = {}
    with contextlib.redirect_stdout(io.StringIO()):
        n = fuzz.TARGETS[name](random.Random(seed), time.time() + seconds,
                               CPU, stats)
    return n, stats


def test_targets_match_the_jax_tool():
    assert list(fuzz.TARGETS) == list(jfuzz.TARGETS)
    assert fuzz.DEFAULT_TARGETS.split(",") == [
        t for t in jfuzz.TARGETS if t != "device_fallback"]


@pytest.mark.parametrize("name", CLEAN)
def test_target_is_clean_on_the_cpu(native_built, name):
    n, stats = _run(name, 0.5)
    assert n > 0, name
    if name == "device_fallback":
        assert sum(stats["injected"].values()) > 0


def test_query_target_finds_f9_in_both_packages(native_built, capsys):
    """The query target's quantile check diverges at seed 1 in both
    tools: a row whose Hillis-Steele prefix at its last live centroid is
    below its total sends a target at the total past that centroid; the
    port's quantile_rows is the JAX package's there, bit for bit."""
    n, stats = _run("query", 30.0, seed=1)
    case = stats["case"]
    assert n == -1 and stats["failed_check"] == "quantile"
    assert fuzz.quantile_case_past_last_live(case)
    assert fuzz.slot_past_last_live(case)[:case["nrows"], :case["norig"]].any()
    jax_got = np.asarray(jqops.quantile_rows(*(jnp.asarray(case[k]) for k in (
        "means", "weights", "dmin", "dmax", "rows", "qs"))))
    assert np.array_equal(np.isnan(jax_got), np.isnan(case["got"]))
    ok = ~np.isnan(jax_got)
    assert np.array_equal(jax_got[ok].view(np.uint32),
                          case["got"][ok].view(np.uint32))
    assert jfuzz.fuzz_query(random.Random(1), time.time() + 120) == -1
    assert "query QUANTILE DIVERGE" in capsys.readouterr().out
    assert fuzz.main(["--device", "cpu", "--seed", "1", "--seconds", "30",
                      "--targets", "query"]) == 1


def _flip_parse(monkeypatch):
    orig = dogstatsd.parse_metric

    def flipped(line):
        try:
            orig(line)
        except dogstatsd.ParseError:
            return None
        raise dogstatsd.ParseError("planted")

    monkeypatch.setattr(dogstatsd, "parse_metric", flipped)


def _reject_ssf(monkeypatch):
    def rejected(payload):
        raise ValueError("planted")

    monkeypatch.setattr(ssf_wire, "parse_ssf", rejected)


def _miscount_batch(monkeypatch):
    orig = native.decode_metric_batch

    def miscounted(blob):
        d = orig(blob)
        if d is not None:
            d.n += 1
        return d

    monkeypatch.setattr(native, "decode_metric_batch", miscounted)


def _crash_gob(monkeypatch):
    orig = gob.decode_merging_digest

    def crashing(blob):
        try:
            return orig(blob)
        except gob.GobError as e:
            raise IndexError("planted") from e

    monkeypatch.setattr(gob, "decode_merging_digest", crashing)


def _unrecoverable_frames(monkeypatch):
    orig = ssf_wire.read_ssf

    def read(f, *a, **kw):
        try:
            return orig(f, *a, **kw)
        except ssf_wire.SSFUnmarshalError as e:
            raise ssf_wire.FramingError("planted") from e

    monkeypatch.setattr(ssf_wire, "read_ssf", read)


def _flip_first_byte(cls, name):
    def patch(monkeypatch):
        orig = getattr(cls, name)

        def flipped(self, data, *a, **kw):
            data = bytes(data)
            if data:
                data = bytes([data[0] ^ 1]) + data[1:]
            return orig(self, data, *a, **kw)

        monkeypatch.setattr(cls, name, flipped)
    return patch


def _flip_ring_datagram(monkeypatch):
    orig = native.LoadgenRing.datagram

    def flipped(self, i):
        d = orig(self, i)
        return bytes([d[0] ^ 1]) + d[1:]

    monkeypatch.setattr(native.LoadgenRing, "datagram", flipped)


def _flip_estimate(monkeypatch):
    orig = hll.estimate

    def flipped(registers, precision=hll.DEFAULT_PRECISION):
        out = orig(registers, precision).clone()
        out.view(torch.int32)[0] ^= 1 << 30
        return out

    monkeypatch.setattr(hll, "estimate", flipped)


def _flip_frame(monkeypatch):
    orig = codec.encode_stream_frame

    def flipped(seq, body):
        f = orig(seq, body)
        return f[:-1] + bytes([f[-1] ^ 1]) if f else f

    monkeypatch.setattr(codec, "encode_stream_frame", flipped)


def _flip_degraded_flush(monkeypatch):
    orig = DeviceWorker.flush

    def flush(self, *a, **kw):
        snap = orig(self, *a, **kw)
        if snap.degraded:
            for f in snap.__dataclass_fields__:
                v = getattr(snap, f)
                if isinstance(v, np.ndarray) and v.dtype.kind == "f" \
                        and v.size:
                    v = np.array(v, order="C")
                    v.view(np.uint8).reshape(-1)[0] ^= 1
                    setattr(snap, f, v)
                    break
        return snap

    monkeypatch.setattr(DeviceWorker, "flush", flush)


PLANTED = {
    "dogstatsd": (_flip_parse, SEED, None),
    "ssf": (_reject_ssf, SEED, None),
    "metricpb": (_miscount_batch, SEED, None),
    "gob": (_crash_gob, SEED, None),
    "ssf_stream": (_unrecoverable_frames, SEED, None),
    "loadgen": (_flip_ring_datagram, SEED, None),
    "reader_commit": (_flip_first_byte(native.NativeIngest, "ingest_owned"),
                      SEED, None),
    # a seed whose first quantile cases pass, so the planted HLL fault
    # is what the target reports
    "query": (_flip_estimate, 104, "hll"),
    "forward_codec": (_flip_frame, SEED, None),
    "device_fallback": (_flip_degraded_flush, SEED, None),
}


@pytest.mark.parametrize("name", list(PLANTED))
def test_target_reports_a_planted_fault(native_built, monkeypatch, name):
    plant, seed, check = PLANTED[name]
    plant(monkeypatch)
    n, stats = _run(name, 20.0, seed)
    assert n == -1, name
    if check:
        assert stats["failed_check"] == check


def test_fuzz_cli_needs_a_card_by_default(native_built):
    _no_card_raises(lambda: fuzz.main(["--seconds", "0.05",
                                       "--targets", "gob"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fuzz.main(["--device", "cuda", "--seconds", "0.05",
                       "--targets", "gob"])


def test_fuzz_tally_writes_only_its_path(native_built, tmp_path):
    jax_tally = (ROOT / "FUZZ_TALLY.json").read_bytes()
    path = tmp_path / "tally.json"
    for _ in range(2):
        assert fuzz.main(["--device", "cpu", "--seconds", "0.05",
                          "--seed", "3", "--targets", "gob,forward_codec",
                          "--tally", str(path)]) == 0
    tally = json.loads(path.read_text())
    assert tally["runs"] == 2 and tally["seeds"] == [3, 3]
    assert sorted(tally["per_target"]) == ["forward_codec", "gob"]
    assert tally["divergences_found"] == []
    assert (ROOT / "FUZZ_TALLY.json").read_bytes() == jax_tally
    assert sorted(p.name for p in tmp_path.iterdir()) == ["tally.json"]


def test_f9_needs_weights_the_folds_never_write():
    """F9's slot past the last live centroid at q = 1.0: rows that
    add_batch writes reach their max there in both packages (their
    weights are differences of one prefix scan, which the scan sums
    exactly), while rows of random f32 weights and a +inf tail send some
    targets past the last live centroid, to a value that is not finite,
    in both packages alike."""
    jpool = _jax_pool(512, 21, weighted=True)
    q1 = np.array([1.0], np.float32)
    j = np.asarray(jtd.quantile(jpool.means, jpool.weights, jpool.min,
                                jpool.max, jnp.asarray(q1)))[:, 0]
    live = np.asarray(jpool.weights).sum(axis=1) > 0
    assert np.array_equal(j[live], np.asarray(jpool.max)[live])

    rng = np.random.default_rng(5)
    s = 512
    weights = rng.uniform(0.1, 8.0, (s, C)).astype(np.float32)
    weights[np.arange(C)[None, :] >= rng.integers(1, C + 1, s)[:, None]] = 0
    means = np.sort(rng.uniform(-1e3, 1e3, (s, C)), axis=1).astype(
        np.float32)
    means[weights == 0] = np.inf
    last = (weights > 0).sum(axis=1) - 1
    dmin, dmax = means[:, 0].copy(), means[np.arange(s), last].copy()
    case = {"weights": weights, "rows": np.arange(s), "qs": q1}
    past = fuzz.slot_past_last_live(case)[:, 0]
    assert past.any()
    args = (means, weights, dmin, dmax)
    j = np.asarray(jtd.quantile(*(jnp.asarray(a) for a in args),
                                jnp.asarray(q1)))[:, 0]
    t = ttd.quantile(*(torch.from_numpy(a) for a in args),
                     torch.from_numpy(q1)).numpy()[:, 0]
    assert np.array_equal(j.view(np.uint32), t.view(np.uint32))
    assert np.allclose(j[~past], dmax[~past], rtol=1e-4, atol=0)
    assert not np.isfinite(j[past]).all()
