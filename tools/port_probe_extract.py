#!/usr/bin/env python3
"""Variant probe of the flush-extract kernel on one NVIDIA card.

    python3 tools/port_probe_extract.py [--json PATH] [--against DIR]

The port's counterpart of the TPU lowering probes
tools/probe_pallas_variants.py (``run_variant``: which formulation of the
extract kernel lowers, and does it agree with the XLA path) and
tools/probe_pallas_minimal.py (``tryk``: does each pattern lower). On
Hopper the matching questions are which variant of
veneur_tpu_torch/csrc/flush_extract.cu builds without spills and which is
fastest while bitwise equal to the plain version. For every variant R
(rows per warp) it prints one verdict line with

* ptxas's report of the build (``nvcc -Xptxas -v``): registers per
  thread, spill stores and loads, local memory, static shared memory,
  plus the dynamic shared memory of a block and the resident blocks per
  SM;
* bitwise equality with ``flush_extract_plain`` at S = 1,000,003 rows,
  P = 3 (max |a - b| over the finite values);
* the median of 21 launches at S = 1,048,576, P = 3 (CUDA events, each
  launch queued behind a spin so the host's launch cost is not timed),
  and that time's share of the memory bound.

Then the fastest variant that is bitwise and spill-free, and, as a
yardstick of the card's read rate, ``torch.sum`` over means and weights.
Before all that, ``cuobjdump -sass`` of the library: how many of the
kernels' f32 adds, multiplies, compares and min/max carry .FTZ (the
library is built with -ftz=true to read and write denormals as XLA on
the CPU does).
With ``--against DIR`` it also times ``flush_extract`` of another
checkout of the repository at DIR (say the parent commit, unpacked with
``git archive``) in turns with this checkout's: other, this, this, other.
Imports torch, numpy and the port only; chip_smoke.py runs the same probe
as one of its phases. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

S_CHECK = 1_000_003
S_TIME = 1_048_576
QS = [0.5, 0.9, 0.99]
REPS = 21
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed ({smi.returncode})"


def bitwise_equal(a, b) -> tuple[bool, float]:
    """(bits equal with NaN positions equal, max |a - b| over non-NaN)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False, float("inf")
    ok = ~na
    va, vb = a[ok], b[ok]
    fin = torch.isfinite(va) & torch.isfinite(vb)
    err = float((va[fin] - vb[fin]).abs().max()) if fin.any() else 0.0
    return torch.equal(va.view(torch.int32), vb.view(torch.int32)), err


def cuda_ms(fn, reps: int, spin_cycles: int = 0) -> float:
    """Median milliseconds of fn() on the card, CUDA events around each
    call. With ``spin_cycles`` the card first spins that long, so a call
    whose host work is shorter than the spin is timed from the moment
    its kernels are queued, not from when the host began."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    times.sort()
    return times[len(times) // 2]


def make_pool(s: int, seed: int):
    """Seeded numpy pool state (14 f32 fields): row occupancy 0 (5%),
    1 (5%), full 128 (10%), else uniform; means ascending per row, +inf
    and weight 0 past the occupancy."""
    import numpy as np

    c = 128
    rng = np.random.default_rng(seed)
    kind = rng.random(s)
    occ = rng.integers(2, c, s)
    occ[kind < 0.05] = 0
    occ[(kind >= 0.05) & (kind < 0.10)] = 1
    occ[(kind >= 0.10) & (kind < 0.20)] = c
    steps = rng.random((s, c), dtype=np.float32) * np.float32(3.0)
    means = np.cumsum(steps, axis=1, dtype=np.float32)
    means += rng.normal(100.0, 40.0, (s, 1)).astype(np.float32)
    weights = rng.integers(1, 50, (s, c)).astype(np.float32)
    empty = np.arange(c)[None, :] >= occ[:, None]
    means[empty] = np.inf
    weights[empty] = 0.0
    has = occ > 0
    dmin = np.where(has, means[:, 0], np.inf).astype(np.float32)
    dmax = np.where(has, means[np.arange(s), np.maximum(occ - 1, 0)],
                    -np.inf).astype(np.float32)
    extra = [rng.normal(0.0, 5.0, s).astype(np.float32) for _ in range(10)]
    return [means, weights, dmin, dmax] + extra


EDGE_KINDS = ("empty", "one", "127", "128", "equal_means", "denormal",
              "huge", "real", "spread", "integer", "denormal_scalars",
              "underflow")


def edge_pool(s: int, seed: int):
    """Seeded numpy pool state whose rows cycle through EDGE_KINDS:
    occupancy 0, 1, 127 and 128; equal means; denormal weights; weights
    near the f32 maximum (sums overflow to inf); real-valued weights and
    weights spread over twelve decades, whose Hillis-Steele prefixes are
    not monotone; plain integer weights; denormal means, dmin, dmax and
    row scalars, with one pair of tiny normal scalars (lsum, lsum_c)
    whose sum is denormal; normal inputs whose intermediates underflow
    (means of alternating sign in [tiny, 2 tiny), so midpoints, products
    m·w and the row sum's partial sums are denormal; on every other such
    row also weights in [tiny, 2 tiny) at occupancy 2 to 8, so prefixes,
    targets q·total and their differences are)."""
    import numpy as np

    c = 128
    rng = np.random.default_rng(seed)
    kind = np.arange(s) % len(EDGE_KINDS)
    occ = rng.integers(2, c + 1, s)
    occ[kind == 0], occ[kind == 1] = 0, 1
    occ[kind == 2], occ[kind == 3] = 127, 128
    steps = rng.random((s, c), dtype=np.float32) * np.float32(2.0)
    means = np.cumsum(steps, axis=1, dtype=np.float32)
    means += rng.normal(50.0, 20.0, (s, 1)).astype(np.float32)
    means[kind == 4] = rng.normal(7.0, 1.0, (int((kind == 4).sum()), 1))
    weights = rng.integers(1, 9, (s, c)).astype(np.float32)
    k = kind[:, None]
    weights = np.where(k == 5, rng.integers(1, 2**20, (s, c)).astype(
        np.float32) * np.float32(1e-45), weights)
    weights = np.where(k == 6, rng.uniform(1e37, 3e38, (s, c)), weights)
    weights = np.where(k == 7, rng.gamma(1.0, 3.0, (s, c)), weights)
    weights = np.where(k == 8, rng.random((s, c)) ** 8 * 1e6, weights)
    weights = weights.astype(np.float32)
    empty = np.arange(c)[None, :] >= occ[:, None]
    means[empty] = np.inf
    weights[empty] = 0.0
    means = means.astype(np.float32)
    has = occ > 0
    dmin = np.where(has, means[:, 0], np.inf).astype(np.float32)
    dmax = np.where(has, means[np.arange(s), np.maximum(occ - 1, 0)],
                    -np.inf).astype(np.float32)
    extra = [rng.normal(0.0, 5.0, s).astype(np.float32) for _ in range(10)]
    sub = kind == EDGE_KINDS.index("denormal_scalars")
    n_sub = int(sub.sum())
    tiny = np.float32(1e-45)
    means[sub] = np.where(empty[sub], np.inf, np.cumsum(
        rng.integers(1, 64, (n_sub, c)), axis=1) * tiny).astype(np.float32)
    dmin[sub] = means[sub, 0]
    dmax[sub] = means[sub][np.arange(n_sub), np.maximum(occ[sub] - 1, 0)]
    for j, e in enumerate(extra):
        e[sub] = rng.integers(-2**22, 2**22, n_sub) * tiny
        if j == 4:  # lsum
            e[sub] = np.float32(1.5e-38)
        elif j == 5:  # lsum_c
            e[sub] = np.float32(-1.2e-38)
    und = np.flatnonzero(kind == EDGE_KINDS.index("underflow"))
    ftiny = np.finfo(np.float32).tiny
    for i, r in enumerate(und):
        sign = np.where(np.arange(c) % 2, -1.0, 1.0)
        means[r] = sign * ftiny * (1.0 + rng.random(c))
        if i % 2:
            occ[r] = rng.integers(2, 9)
            weights[r] = ftiny * (1.0 + rng.random(c))
        else:
            weights[r] = rng.uniform(0.5, 2.0, c)
        means[r, occ[r]:], weights[r, occ[r]:] = np.inf, 0.0
        dmin[r] = means[r, :occ[r]].min()
        dmax[r] = means[r, :occ[r]].max()
    return [means, weights, dmin, dmax] + extra


SASS_OPS = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX")


def cuobjdump() -> str:
    """cuobjdump from the CUDA toolkit, or the copy Triton ships."""
    import shutil

    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(path).exists():
        return path
    try:
        import triton
    except ImportError as e:
        raise RuntimeError("no cuobjdump: neither the CUDA toolkit's nor "
                           "Triton's") from e
    return str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
               / "cuobjdump")


def sass_ftz(lib: Path, kernel: str) -> dict[str, dict[str, int]]:
    """Per f32 opcode of SASS_OPS, over the functions of the library
    ``lib`` whose name matches the regex ``kernel``: how many carry .FTZ
    and how many do not (``cuobjdump -sass``)."""
    import re

    text = subprocess.run([cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    out = {op: {"ftz": 0, "plain": 0} for op in SASS_OPS}
    inside = False
    pat = re.compile(r"\b(" + "|".join(SASS_OPS) + r")((?:\.[A-Z0-9_]+)*)\s")
    for line in text.splitlines():
        if "Function :" in line:
            inside = re.search(kernel, line) is not None
            continue
        m = pat.search(line) if inside else None
        if m:
            out[m.group(1)]["ftz" if ".FTZ" in m.group(2) else "plain"] += 1
    return out


def bound(s: int, p: int) -> tuple[float, str]:
    """Least time for the flush extract at S rows and P quantiles: the
    larger of bytes (each input read once, the output written once) over
    HBM rate and f32 operations over the f32 peak."""
    c = 128
    nbytes = 4 * (2 * s * c + 12 * s + p + s * (p + 10))
    # per row: scan 7*C adds, two trees 2*(C-1), C products, C midpoint
    # adds + divides, 6 ops per quantile, 5 compensated-column adds
    ops = s * (7 * c + 2 * (c - 1) + c + 2 * c + 6 * p + 5)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_variants(fields, qs, plain_check=None) -> list[dict]:
    """One verdict per variant (see the module docstring). ``fields``
    are the 14 pool tensors on the card with at least S_TIME rows;
    ``plain_check`` is flush_extract_plain on their first S_CHECK rows
    (computed here when not given)."""
    import torch

    from veneur_tpu_torch.ops import extract_kernel as ek

    dev = fields[0].device
    sub = [f[:S_CHECK] for f in fields]
    if plain_check is None:
        plain_check = ek.flush_extract_plain(*sub, qs)
    report = ek.build_report()
    lib = ek.load()
    b_ms, b_by = bound(S_TIME, qs.shape[0])
    full = [f[:S_TIME] for f in fields]
    out = []
    for r in ek.VARIANTS:
        v = {"rows_per_warp": r, "build": "OK", **report.get(r, {}),
             "dynamic_smem_bytes": getattr(
                 lib, f"flush_extract_smem_bytes_r{r}")(),
             "bound_ms": b_ms, "bound_by": b_by}
        if r not in report:
            v["build"] = "FAIL: no ptxas report for the variant"
        try:
            v["blocks_per_sm"] = ek.blocks_per_sm(r, dev)
            got = ek._flush_extract_variant(r, *sub, qs)
            torch.cuda.synchronize()
            same, err = bitwise_equal(got, plain_check)
            del got
            v.update(bitwise=same, max_abs_err=err)
            v["ms"] = cuda_ms(lambda: ek._flush_extract_variant(
                r, *full, qs), REPS, spin_cycles=2_000_000)
        except RuntimeError as e:
            v.update(build=f"FAIL: {e}", bitwise=False,
                     max_abs_err=float("inf"), ms=float("inf"))
        v["share_of_bound"] = b_ms / v["ms"]
        v["spill_free"] = (v.get("spill_stores", 1) == 0
                           and v.get("spill_loads", 1) == 0
                           and v.get("local_bytes", 1) == 0)
        log(f"[probe] r{r} build {v['build']}: "
            f"{v.get('registers', '?')} registers, "
            f"{v.get('spill_stores', '?')} B spill stores, "
            f"{v.get('spill_loads', '?')} B spill loads, "
            f"{v.get('local_bytes', '?')} B local, "
            f"{v.get('static_smem_bytes', '?')} B static smem, "
            f"{v['dynamic_smem_bytes']} B dynamic smem per block, "
            f"{v.get('blocks_per_sm', '?')} blocks per SM")
        log(f"[probe] r{r} S={S_CHECK} P={qs.shape[0]}: bitwise_equal="
            f"{v['bitwise']} max_abs_err={v['max_abs_err']}; S={S_TIME}: "
            f"{v['ms']:.4f} ms (median of {REPS}), "
            f"{100 * v['share_of_bound']:.1f}% of the {b_ms:.4f} ms "
            f"bound ({b_by})")
        out.append(v)
    ok = [v for v in out if v["bitwise"] and v["spill_free"]]
    best = min(ok, key=lambda v: v["ms"]) if ok else None
    log(f"[probe] fastest bitwise spill-free variant: "
        f"{'r%d' % best['rows_per_warp'] if best else 'none'}; "
        f"flush_extract launches r{ek.ROWS_PER_WARP}")
    return out


def read_yardstick(fields) -> dict:
    """torch.sum over means and weights at S_TIME rows: the card's
    practical read rate for the extract's bytes."""
    import torch

    m, w = fields[0][:S_TIME], fields[1][:S_TIME]
    ms = cuda_ms(lambda: (torch.sum(m), torch.sum(w)), REPS,
                 spin_cycles=2_000_000)
    nbytes = 2 * m.numel() * 4
    log(f"[probe] yardstick: torch.sum over means and weights at "
        f"S={S_TIME} ({nbytes} B) {ms:.4f} ms, {nbytes / ms / 1e9:.1f} "
        f"TB/s read")
    return {"ms": ms, "bytes": nbytes}


def load_other(other: Path, *names: str) -> list:
    """Modules ``veneur_tpu_torch.<name>`` of the checkout at ``other``,
    imported with that checkout's own package (its sources, its build
    directory, its flags); this process's own modules are back in place
    when it returns."""
    pkg = "veneur_tpu_torch"
    mine = {k: v for k, v in sys.modules.items()
            if k == pkg or k.startswith(pkg + ".")}
    for k in mine:
        del sys.modules[k]
    sys.path.insert(0, str(other))
    try:
        return [importlib.import_module(f"{pkg}.{n}") for n in names]
    finally:
        sys.path.remove(str(other))
        for k in [k for k in sys.modules
                  if k == pkg or k.startswith(pkg + ".")]:
            del sys.modules[k]
        sys.modules.update(mine)


def time_against(other: Path, fields, qs) -> dict:
    """flush_extract of the checkout at ``other`` (its own source, built
    into its own build/kernels) and of this one at S_TIME rows, each held
    bitwise against the plain version, timed in turns."""
    from veneur_tpu_torch.ops import extract_kernel as ek

    oek, = load_other(other, "ops.extract_kernel")
    full = [f[:S_TIME] for f in fields]
    ref = ek.flush_extract_plain(*full, qs)
    runs = {"other": [], "this": []}
    for name in ("other", "this", "this", "other"):
        fn = (oek if name == "other" else ek).flush_extract
        same, _ = bitwise_equal(fn(*full, qs), ref)
        if not same:
            raise AssertionError(f"{name} checkout's kernel != plain")
        runs[name].append(cuda_ms(lambda: fn(*full, qs), REPS,
                                  spin_cycles=2_000_000))
    log(f"[probe] S={S_TIME}: flush_extract of {other} "
        f"{', '.join(f'{t:.4f}' for t in runs['other'])} ms, of this "
        f"checkout {', '.join(f'{t:.4f}' for t in runs['this'])} ms "
        f"(medians of {REPS}, in turns other, this, this, other; both "
        f"bitwise equal to the plain version)")
    # the edge rows, by kind: rows where each checkout's kernel differs
    # from the plain version (reported, not asserted, for the other one)
    import torch

    edge = [torch.from_numpy(a).to(fields[0].device)
            for a in edge_pool(4099, seed=13)]
    kind = torch.arange(4099, device=edge[0].device) % len(EDGE_KINDS)
    for qv in ([1.0], QS):
        q = torch.tensor(qv, dtype=torch.float32, device=edge[0].device)
        ref = ek.flush_extract_plain(*edge, q)
        for name, mod in (("other", oek), ("this", ek)):
            got = mod.flush_extract(*edge, q)
            bad = ((got != ref) & ~(torch.isnan(got) & torch.isnan(ref))
                   ).any(1)
            by_kind = {EDGE_KINDS[k]: int((bad & (kind == k)).sum())
                       for k in range(len(EDGE_KINDS))}
            runs[f"edge_rows_differing_{name}_qs{qv}"] = by_kind
            log(f"[probe] edge rows, qs={qv}: {name} checkout's kernel "
                f"differs from the plain version in {int(bad.sum())} of "
                f"4099 rows; by kind {by_kind}")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--against", type=Path,
                    help="another checkout whose flush_extract to time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: the probe needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from veneur_tpu_torch.ops import extract_kernel as ek

    card = card_line()
    log(f"[probe] card: {card}")
    ek.load()
    sass = {"this": sass_ftz(ek.library_path(), "flush_extract_kernel")}
    if args.against:
        oek, = load_other(args.against.resolve(), "ops.extract_kernel")
        oek.load()
        sass["other"] = sass_ftz(oek.library_path(), "flush_extract_kernel")
        for r, rep in sorted(oek.build_report().items()):
            log(f"[probe] other checkout's ptxas r{r}: " + ", ".join(
                f"{k} {v}" for k, v in rep.items()))
    for who, rep in sass.items():
        log(f"[probe] SASS of {who} checkout's flush_extract kernels, f32 "
            f"ops with .FTZ / without: " + ", ".join(
                f"{op} {v['ftz']}/{v['plain']}" for op, v in rep.items()))
    fields = [torch.from_numpy(a).cuda()
              for a in make_pool(S_TIME, seed=11)]
    qs = torch.tensor(QS, dtype=torch.float32, device="cuda")
    variants = probe_variants(fields, qs)
    yard = read_yardstick(fields)
    against = time_against(args.against.resolve(), fields, qs) \
        if args.against else None
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "variants": variants, "yardstick": yard,
             "against": against, "sass_ftz": sass}, indent=1))
    print(json.dumps({"card": card, "variants": variants}), flush=True)
    return 0 if any(v["bitwise"] for v in variants) else 1


if __name__ == "__main__":
    sys.exit(main())
