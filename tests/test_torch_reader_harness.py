"""The port's native bindings that the measuring harness needs, and its
reader tools (tools/port_bench_{reader,ingest_scaling,lock_contention}.py),
on the CPU.

* ``NativeRouter.reset_lock_stats``, ``NativeIngest.num_rows`` and
  ``NativeIngest.stage_total`` against the JAX package's bindings on the
  same datagrams, through the shared native sources: the same row
  counts, the same staged totals, and the same lock-stats totals after a
  reset (acquisitions and contended commits; the port's and the JAX
  package's libraries are separate builds with their own switch).
* Every lane of the three reader tools at small sizes commits exactly
  the lines it sent, and each tool's artifact has the JAX tool's keys
  plus the port's added ones (the JAX tool's ``main`` run with its
  module's ``__file__`` in a temporary directory, so that its
  root-relative artifact lands there; its reader with one trial, its
  scaling lanes at 400 datagrams).
* tools/port_thread_diag.py runs every lane at both switch intervals on
  the CPU, each reader lane committing every line, the ring exact.
No test here gates a rate.
"""

from __future__ import annotations

import functools
import importlib
import json
import sys
from pathlib import Path

from veneur_tpu import native as jnative
from veneur_tpu_torch import native as tnative

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import port_bench_ingest_scaling as scaling  # noqa: E402
import port_bench_lock_contention as contention  # noqa: E402
import port_bench_reader as reader  # noqa: E402


def _datagrams(n: int = 40) -> list[bytes]:
    out = []
    for d in range(n):
        lines = [b"rh.t%d:%d|ms|#k:%d" % (d * 7 + i, i, i % 3)
                 for i in range(9)]
        lines += [b"rh.c%d:1|c" % (d % 5), b"rh.g%d:2|g" % (d % 4),
                  b"rh.s:%d|s" % d]
        out.append(b"\n".join(lines))
    return out


def test_num_rows_and_stage_total_equal_the_jax_bindings():
    dgrams = _datagrams()
    for depth in (0, 4, 64):
        j, t = jnative.NativeIngest(), tnative.NativeIngest()
        j.set_stage_depth(depth)
        t.set_stage_depth(depth)
        assert j.num_rows() == t.num_rows() == (0, 0, 0, 0)
        assert j.stage_total == t.stage_total == 0
        for i, d in enumerate(dgrams):
            j.ingest(d)
            t.ingest(d)
            if i % 10 == 9:
                assert t.num_rows() == j.num_rows()
                assert t.stage_total == j.stage_total
        assert t.num_rows() == j.num_rows()
        histo, sets, counters, gauges = t.num_rows()
        assert (sets, counters, gauges) == (1, 5, 4)
        assert histo == len({(d * 7 + i, i % 3) for d in range(40)
                             for i in range(9)})
        assert t.stage_total == j.stage_total
        assert (t.stage_total > 0) == (depth > 0)


def _lock_totals(router, shards: int) -> list:
    return [{k: router.lock_stats(s)[k]
             for k in ("acquisitions", "contended")}
            for s in range(shards)]


def test_reset_lock_stats_equals_the_jax_binding():
    dgrams = _datagrams()
    records = {}
    for name, mod in (("jax", jnative), ("port", tnative)):
        ctxs = [mod.NativeIngest() for _ in range(3)]
        router = mod.NativeRouter(ctxs)
        router.set_lock_stats(True)
        for d in dgrams:
            router.ingest(d)
        first = _lock_totals(router, 3)
        router.reset_lock_stats()
        after_reset = [router.lock_stats(s) for s in range(3)]
        for d in dgrams[:10]:
            router.ingest(d)
        again = _lock_totals(router, 3)
        router.set_lock_stats(False)
        assert all(st["acquisitions"] == st["contended"] == 0
                   and st["wait_ns_total"] == st["hold_ns_total"] == 0
                   and st["hold_ns_samples"] == []
                   for st in after_reset), name
        assert sum(r["acquisitions"] for r in first) > 0
        records[name] = (first, again)
    assert records["port"] == records["jax"]


def _jax_tool_artifact(monkeypatch, tmp_path: Path, tool: str,
                       artifact: str, **patches) -> dict:
    """Run the JAX tool's ``main`` with its module's ``__file__`` under
    ``tmp_path/tools``, so that its root-relative artifact lands in
    ``tmp_path``; ``patches`` replace module attributes."""
    mod = importlib.import_module(tool)
    monkeypatch.setattr(mod, "__file__",
                        str(tmp_path / "tools" / (tool + ".py")))
    for name, value in patches.items():
        monkeypatch.setattr(mod, name, value)
    mod.main()
    return json.loads((tmp_path / artifact).read_text())


def test_reader_lanes_commit_every_line_sent(tmp_path, monkeypatch):
    out = reader.measure("cpu", trials=2, n_burst=120)
    for lane in ("python_reader", "native_reader"):
        rec = out[lane]
        assert rec["drained_dgrams"] == rec["burst_dgrams"] == 120
        assert rec["lines_committed"] == rec["lines_sent"] == 2 * 120 * 25
        assert rec["rcvbuf_asked"] == reader.RCVBUF
        assert rec["rcvbuf_reported"] > 0
    assert out["launches"] == dict.fromkeys(
        ("K1", "K2a", "K2b", "K3", "K4", "K5"), 0)
    jax_tool = importlib.import_module("bench_reader")
    ref = _jax_tool_artifact(
        monkeypatch, tmp_path, "bench_reader", "NATIVE_READER.json",
        run=functools.partial(jax_tool.run, trials=1))
    assert set(out) == set(ref) | {"device", "cores", "rmem_max",
                                   "launches"}
    for lane in ("python_reader", "native_reader"):
        assert set(out[lane]) == set(ref[lane]) | {
            "rcvbuf_asked", "rcvbuf_reported", "lines_sent",
            "lines_committed", "best_send_drain_lines_per_s"}


def test_ingest_scaling_lanes_commit_every_line_sent(tmp_path,
                                                     monkeypatch):
    # each lane raises unless its contexts committed every line sent
    out = scaling.measure(n_datagrams=400)
    ref = _jax_tool_artifact(monkeypatch, tmp_path, "bench_ingest_scaling",
                             "INGEST_SCALING.json", N_DATAGRAMS=400)
    assert set(out["results"]) == set(ref["results"])
    assert set(out) - {"see_also"} == set(ref) - {"see_also"} | {"cores"}


def test_lock_contention_lanes_commit_every_line_sent(tmp_path,
                                                      monkeypatch):
    out, sc = contention.measure(shards=2, max_readers=3, seconds=0.2,
                                 series=600)
    runs = out["runs"] + out["reader_sharded"]["runs"]
    assert [r["readers"] for r in runs] == [1, 2, 3, 1, 2, 3]
    for r in runs:
        assert r["lines_committed"] == r["lines_sent"] > 0
        assert r["samples_committed"] > 0
    # the routed lane's acquisitions are the commits since the reset
    assert all(r["samples_committed"] == r["lines_sent"]
               for r in out["runs"])
    for key, value in (("SECONDS", "0.2"), ("SERIES", "600"),
                       ("SHARDS", "2"), ("READERS", "3")):
        monkeypatch.setenv("VENEUR_LOCK_" + key, value)
    ref = _jax_tool_artifact(monkeypatch, tmp_path, "bench_lock_contention",
                             "INGEST_CONTENTION.json")
    ref_sc = json.loads((tmp_path / "READER_SCALING.json").read_text())
    assert set(out) == set(ref) | {"cores"}
    assert set(out["runs"][0]) == set(ref["runs"][0]) | {
        "lines_sent", "lines_committed"}
    assert set(sc) == set(ref_sc) | {"cores"}
    assert set(sc["verdict"]) == set(ref_sc["verdict"])


def test_thread_diag_runs_every_lane_on_the_cpu(tmp_path, monkeypatch):
    """tools/port_thread_diag.py: every variant at both switch intervals,
    each reader lane committing every line, the ring trial exact."""
    import port_thread_diag as diag

    monkeypatch.setenv("VENEUR_ARTIFACT_DIR", str(tmp_path))
    assert diag.main(["--device", "cpu", "--trials", "1",
                      "--ring-rate", "2000"]) == 0
    out = json.loads((tmp_path / "THREAD_DIAG.json").read_text())
    assert [r["switch_interval_s"] for r in out["runs"]] == [0.005, 0.0005]
    for r in out["runs"]:
        for name, rec in r.items():
            if name.startswith("python_reader"):
                assert rec["lines_committed"] == rec["lines_sent"], name
        assert r["ring_trial"]["conservation_exact"] is True
        assert r["ring_trial"]["duplicates_observed"] == 0
    assert "python_reader_micro_fold_off" in out["runs"][0]
    assert sys.getswitchinterval() == 0.005
