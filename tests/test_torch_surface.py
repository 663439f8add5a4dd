"""The port's public surface against the JAX package's, by AST.

Every module of ``veneur_tpu/`` is walked: each public function, class
and method (a name without a leading underscore, at a module's top level
or in a top-level class) must have a counterpart of the same name in the
port's module of the same path, or stand in ``DEPARTURES`` with the
reason it has none. A departure that the port has since filled, or that
names nothing of the JAX package, fails too, so the list stays exact.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "veneur_tpu"
PORT_PKG = ROOT / "veneur_tpu_torch"

_HOST_ENGINE = ("the NumPy failover engine: the port's failover runs its "
                "own torch programs on device='cpu' (ROADMAP.md §1)")
_NP_TWIN = ("a NumPy twin of a device program for the NumPy failover "
            "engine, which the port does not have: its CPU path is the "
            "same torch code")
_JIT_STEP = ("a jitted shard_map step; the port's SeriesSharding runs "
             "each shard's program in a loop over its devices "
             "(ingest_rows, import_rows, fold_staged, the mirror's "
             "records sent to every shard)")

# module path (relative to the package) -> {public name: reason}
DEPARTURES: dict[str, dict[str, str]] = {
    "ops/host_engine.py": {
        name: _HOST_ENGINE for name in (
            "HostHistoState", "HostHistoState.create",
            "HostHistoState.fields", "HostHistoState.from_fields",
            "HostHistoState.grow", "HostHistoState.num_rows",
            "np_add_batch", "np_comp_add", "np_compress_rows",
            "np_expand_flat_planes", "np_flush_extract", "np_fold_staged",
            "np_hll_estimate_exact", "np_hll_insert_batch", "np_hll_merge",
            "np_import_step", "np_ingest_step", "np_pack_extract_columns",
            "np_quantile", "np_row_count", "np_row_sum",
            "np_unit_wts_plane")},
    "ops/pallas_kernels.py": {
        name: ("the Pallas kernel K1 and its A/B helpers became "
               "csrc/flush_extract.cu behind ops/extract_kernel.py")
        for name in ("ab_verdict_ok", "flush_extract",
                     "flush_extract_reference", "supported")},
    "utils/backend.py": {
        name: ("JAX backend names; device.py resolves the port's torch "
               "device") for name in ("is_tpu_backend",
                                      "normalize_backend")},
    "ops/exactnum.py": {
        name: _NP_TWIN for name in ("np_block", "np_cumsum",
                                    "np_kscale_bucket", "np_tsum",
                                    "np_tsum0")},
    "ops/segments.py": {
        name: _NP_TWIN for name in ("np_last_marked_carry",
                                    "np_segmented_cumsum")},
    "ops/series_shard.py": {
        name: _JIT_STEP for name in (
            "SeriesSharding.expand_flat", "SeriesSharding.import_step",
            "SeriesSharding.ingest_step", "SeriesSharding.mirror_dense",
            "SeriesSharding.scatter_chunk")},
    "core/worker.py": {
        "HistoDeviceState.placed": (
            "commits a fresh pool to a JAX mesh; the port's "
            "HistoDeviceState.create takes the SeriesSharding and builds "
            "each shard's tensors on its device"),
    },
    "health/ledger.py": {
        "TransferLedger.epoch_h2d": (
            "counts and performs a micro-fold upload with jnp.asarray; "
            "the port's mirror uploads its records itself and books "
            "them through count_epoch_h2d"),
    },
    "ops/hll.py": {
        "insert_batch_scatter": (
            "the plain scatter-max variant kept for an on-TPU A/B; the "
            "port's insert is K4 (csrc/hll.cu), held to the JAX variant "
            "by tests/test_torch_hll.py"),
    },
    "ops/tdigest.py": {
        "TDigestPool.capacity": (
            "shape accessors of the JAX pool; the port's pool fields are "
            "torch tensors read through .shape"),
        "TDigestPool.num_rows": (
            "shape accessors of the JAX pool; the port's pool fields are "
            "torch tensors read through .shape"),
        "pool_to_numpy": (
            "the port reads the JAX package's dict through "
            "pool_from_numpy and its own pools with .cpu().numpy()"),
    },
    "native.py": {
        "NativeRouter.start_ssf_reader": (
            "the native SSF path is single-shard: the port's reader "
            "belongs to NativeIngest.start_ssf_reader, which "
            "tests/test_torch_spans.py holds to the JAX router's"),
        "NativeRouter.stop_ssf_reader": (
            "moved with start_ssf_reader to NativeIngest.stop_ssf_reader"),
    },
}


def public_names(path: Path) -> set[str]:
    """A module's public top-level functions and classes, and the public
    methods of its top-level classes (``Class.method``)."""
    tree = ast.parse(path.read_text())
    out: set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                out.add(node.name)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.add(node.name)
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not sub.name.startswith("_")):
                    out.add(f"{node.name}.{sub.name}")
    return out


MODULES = sorted(str(p.relative_to(JAX_PKG))
                 for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart_or_a_reason(rel):
    want = public_names(JAX_PKG / rel)
    port = PORT_PKG / rel
    have = public_names(port) if port.exists() else set()
    reasons = DEPARTURES.get(rel, {})
    missing = sorted(want - have - set(reasons))
    assert not missing, f"{rel}: no counterpart and no reason: {missing}"
    # the list stays exact: every departure names a JAX public name the
    # port still lacks
    assert sorted(set(reasons) - want) == []
    assert sorted(set(reasons) & have) == []
    assert all(len(r) > 20 for r in reasons.values())


def test_departures_name_modules_of_the_jax_package():
    assert set(DEPARTURES) <= set(MODULES)
    # the three files left out on purpose (ROADMAP.md §1) and no others
    assert sorted(rel for rel in MODULES
                  if not (PORT_PKG / rel).exists()) == [
        "ops/host_engine.py", "ops/pallas_kernels.py", "utils/backend.py"]


def test_the_native_bindings_the_harness_needs_exist():
    have = public_names(PORT_PKG / "native.py")
    assert {"NativeRouter.reset_lock_stats", "NativeIngest.num_rows",
            "NativeIngest.stage_total"} <= have
    assert "native.py" not in DEPARTURES or not (
        {"NativeRouter.reset_lock_stats", "NativeIngest.num_rows",
         "NativeIngest.stage_total"} & set(DEPARTURES["native.py"]))
