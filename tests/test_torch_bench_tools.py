"""The port's cell tools (tools/port_bench_{e2e_flush,import,query,
overlap}.py) against the JAX system's (tools/bench_*.py) on the CPU.

* e2e flush: ``build_datagrams`` gives the JAX tool's bytes; one cut run
  of each tool (512 series) flushes as many InterMetrics.
* import: the local's wire blob (``codec.snapshot_to_wire`` of the
  tool's snapshot) is the JAX tool's bytes at 512 series, and the
  global's merged quantiles and aggregates after ``handle_wire`` and
  after ``handle_batch`` are bitwise the JAX global's.
* query: every op's response of a 128-series unsharded cell equals the
  JAX engine's (``json.dumps`` bytes; the exposition as returned), and
  the port's 4-shard cell answers as its unsharded one.
* Each tool's artifact (the JAX tool's ``main`` run with its module's
  ``__file__`` in a temporary directory, so that its root-relative
  artifact lands there) has the JAX tool's keys plus the port's added
  ones, and no port tool writes a file at the repository root: its
  artifact lands under ``VENEUR_ARTIFACT_DIR`` (or its ``--out``).
No test here gates a time or a rate.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import bench_e2e_flush as je2e  # noqa: E402
import bench_import as jimport  # noqa: E402
import bench_overlap as joverlap  # noqa: E402
import bench_query as jquery  # noqa: E402
import port_bench_e2e_flush as te2e  # noqa: E402
import port_bench_import as timport  # noqa: E402
import port_bench_overlap as toverlap  # noqa: E402
import port_bench_query as tquery  # noqa: E402

ADDED = {"device", "cores", "launches"}
NO_LAUNCHES = dict.fromkeys(("K1", "K2a", "K2b", "K3", "K4", "K5"), 0)


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """The port tools' artifact directory; afterwards, the repository
    root's files are the ones that were there, unchanged."""
    def root_files():
        return {p.name: p.stat().st_mtime_ns for p in ROOT.iterdir()
                if p.is_file()}

    before = root_files()
    out = tmp_path / "port"
    monkeypatch.setenv("VENEUR_ARTIFACT_DIR", str(out))
    yield out
    assert root_files() == before


def _jax_main(mod, monkeypatch, tmp_path, artifact: str, argv=()) -> dict:
    monkeypatch.setattr(mod, "__file__",
                        str(tmp_path / "jax" / "tools" / "tool.py"))
    (tmp_path / "jax").mkdir(exist_ok=True)
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    mod.main()
    return json.loads((tmp_path / "jax" / artifact).read_text())


# -- e2e flush -----------------------------------------------------------------


@pytest.mark.parametrize("series,per,max_len", [
    (1, 1, 8192), (1000, 4, 8192), (4097, 3, 1432), (300, 2, 64)])
def test_e2e_datagrams_equal_the_jax_tools(series, per, max_len):
    assert te2e.build_datagrams(series, per, max_len) \
        == je2e.build_datagrams(series, per, max_len)


def test_e2e_flush_keys_and_output_equal_the_jax_tools(
        artifacts, tmp_path, monkeypatch):
    monkeypatch.setenv("VENEUR_E2E_SERIES", "512")
    assert te2e.main(["--device", "cpu"]) == 0
    port = json.loads((artifacts / "E2E_FLUSH.json").read_text())
    ref = _jax_main(je2e, monkeypatch, tmp_path, "E2E_FLUSH.json")
    assert set(port) == set(ref) | ADDED | {"device_memory_mb"}
    # the port's server times the span pipeline's flush every flush
    assert set(port["flush_phases"]) - {"span_flush_s"} \
        == set(ref["flush_phases"]) - {"span_flush_s"}
    assert port["inter_metrics"] == ref["inter_metrics"] > 0
    assert port["samples"] == ref["samples"] == 512 * 4
    assert port["launches"] == NO_LAUNCHES
    assert port["platform"] == "cpu" and port["device_memory_mb"] is None


# -- import --------------------------------------------------------------------


def _jax_local_blob(series: int):
    """The JAX tool's local worker and wire blob (tools/bench_import.py's
    lines)."""
    from veneur_tpu.core.directory import ScopeClass
    from veneur_tpu.core.flusher import device_quantiles
    from veneur_tpu.core.metrics import HistogramAggregates, MetricKey
    from veneur_tpu.core.worker import DeviceWorker
    from veneur_tpu.distributed import codec

    w = DeviceWorker(initial_histo_rows=series)
    for i in range(series):
        w.directory.upsert_histo(
            MetricKey(name=f"m{i}", type="timer", joined_tags="env:prod"),
            ScopeClass.MIXED, ["env:prod"])
    w._ensure_histo(series)
    rng = np.random.default_rng(0)
    rows = ((np.arange(series * 4, dtype=np.int64)) % series
            ).astype(np.int32)
    w._device_histo_step(rows, rng.gamma(2.0, 50.0, series * 4
                                         ).astype(np.float32),
                         np.ones(series * 4, np.float32))
    qs = device_quantiles([0.5], HistogramAggregates.from_names(["count"]))
    return codec.snapshot_to_wire(w.flush(qs, interval_s=10.0)), qs


def _jax_global_snapshot(name: str, blob: bytes, qs):
    from veneur_tpu.core.config import Config
    from veneur_tpu.core.server import Server
    from veneur_tpu.distributed.import_server import ImportServer
    from veneur_tpu.gen import veneur_tpu_pb2 as pb

    g = Server(Config(interval="10s", percentiles=[0.5]))
    imp = ImportServer(g)
    if name == "wire_native":
        imp.handle_wire(blob)
    else:
        imp.handle_batch(pb.MetricBatch.FromString(blob))
    snap = g.workers[0].flush(qs, 10.0)
    g.shutdown()
    return snap


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_import_blob_and_merge_are_bitwise_the_jax_tools():
    from veneur_tpu_torch.distributed import codec

    series = 512
    (jblob, jn), jqs = _jax_local_blob(series)
    blob, n = codec.snapshot_to_wire(timport.local_snapshot(series, "cpu"))
    assert (blob, n) == (jblob, jn)
    for name in ("wire_native", "python_pb"):
        _, tsnap, _, launches = timport.run_global(name, blob, n, series, 1,
                                                   "cpu")
        jsnap = _jax_global_snapshot(name, jblob, jqs)
        assert launches == {"merge": NO_LAUNCHES, "all": NO_LAUNCHES}
        assert tsnap.directory.num_histo_rows == series
        for k in ("quantile_values", "dmin", "dmax", "dsum", "dcount",
                  "digest_means", "digest_weights"):
            np.testing.assert_array_equal(
                _bits(getattr(tsnap, k)), _bits(getattr(jsnap, k)),
                err_msg=(name, k))


def test_import_keys_equal_the_jax_tools(artifacts, tmp_path, monkeypatch):
    monkeypatch.setenv("VENEUR_IMPORT_SERIES", "512")
    monkeypatch.setenv("VENEUR_IMPORT_ROUNDS", "1")
    assert timport.main(["--device", "cpu"]) == 0
    port = json.loads((artifacts / "IMPORT_SCALING.json").read_text())
    ref = _jax_main(jimport, monkeypatch, tmp_path, "IMPORT_SCALING.json")
    assert set(port) == set(ref) | ADDED
    assert set(port["results"]) == set(ref["results"])
    for k, v in ref["results"].items():
        if isinstance(v, dict):
            assert set(port["results"][k]) == set(v), k
    assert port["batch_bytes"] == ref["batch_bytes"]


# -- query ---------------------------------------------------------------------


def _responses(eng, series: int) -> dict:
    out = {}
    for name, fn in tquery.op_calls(eng, series).items():
        vals = [fn(i) for i in range(3)]
        out[name] = (vals if name == "exposition"
                     else [json.dumps(v, sort_keys=True) for v in vals])
    return out


def test_query_responses_equal_the_jax_engines():
    jeng, _, _, _ = jquery._build_cell(128, 0)
    teng, _, _, _ = tquery._build_cell(128, 0, "cpu")
    want = _responses(jeng, 128)
    got = _responses(teng, 128)
    assert set(got) == {"quantiles_host", "quantiles_device", "scalars",
                        "exposition"}
    for op in got:
        assert got[op] == want[op], op
    seng, _, _, _ = tquery._build_cell(128, 4, "cpu")
    assert _responses(seng, 128) == got


def test_query_artifact_passes_the_jax_schema(artifacts, tmp_path):
    out = tmp_path / "q.json"
    assert tquery.main(["--device", "cpu", "--smoke", "--reps", "4",
                        "--ab-cycles", "1", "--min-ab-ratio", "0",
                        "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert jquery.validate_schema(doc) == []
    assert set(doc) == {"ts_utc", "rev", "smoke", "platform", "grid",
                        "sustained_ab"} | ADDED
    assert [(c["series"], c["shards"]) for c in doc["grid"]] \
        == [(128, 0), (128, 4)]
    cell = jquery.bench_cell(128, 0, True, 3)
    assert set(doc["grid"][0]) == set(cell)
    assert set(doc["grid"][0]["ops"]) == set(cell["ops"])
    assert doc["launches"] == {"grid": NO_LAUNCHES,
                               "sustained_ab": NO_LAUNCHES}


# -- overlap -------------------------------------------------------------------


def test_overlap_keys_equal_the_jax_tools(artifacts, tmp_path, monkeypatch):
    monkeypatch.setenv("VENEUR_OVERLAP_SERIES", "256")
    monkeypatch.setenv("VENEUR_OVERLAP_SECONDS", "0.3")
    assert toverlap.main(["--device", "cpu"]) == 0
    port = json.loads((artifacts / "OVERLAP.json").read_text())
    ref = _jax_main(joverlap, monkeypatch, tmp_path, "OVERLAP.json")
    assert set(port) == set(ref) | {"cores", "launches"}
    for k in ("locked_extract", "overlapped", "verdict"):
        assert set(port[k]) == set(ref[k])
    assert port["launches"] == {"locked_extract": NO_LAUNCHES,
                                "overlapped": NO_LAUNCHES}
    assert port["verdict"]["ingest_proceeds_during_extract"] in (True, False)
