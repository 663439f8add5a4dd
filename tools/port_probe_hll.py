#!/usr/bin/env python3
"""The HyperLogLog kernels on one NVIDIA card: cases, checks, times, bounds.

    python3 tools/port_probe_hll.py [--json PATH]

Holds ``hll_insert`` and ``hll_estimate`` (veneur_tpu_torch/csrc/hll.cu)
against their plain PyTorch versions (veneur_tpu_torch/ops/hll.py) on the
card, bytewise and in f32 bits, in the cases chip_smoke.py runs:

* hll_insert: N = 16,384 and 1,048,576 updates into pools of 1,024 and
  32,768 rows at p = 14, and into 4,099-row pools at p = 4, 8 and 18.
  The updates hold duplicate slots, rank-0 padding on the last row and
  rows outside the pool (negative and past the end), so some are dropped.
* hll_estimate: 32,768 rows at p = 14, 1 row, 4,099 rows at p = 4, 8 and
  18. Rows cycle through every regime of the estimator: all zero; few
  distinct values (linear counting); about 2m to 3m distinct values, on
  both sides of the raw <= 2.5m switch; many (raw); full with no zero
  register; every register at the largest rank 64 - p + 1.

Then, at the main path's shapes (p = 14: one 16,384-update batch into the
32,768-row dense pool; the estimate over that pool), the median of 21
launches behind a device spin (port_probe_extract.cuda_ms), the plain
version's time, the least time the card could take (bytes moved over
3.35 TB/s or f32 operations over 67 TFLOP/s, the larger), and for the
insert one PyTorch call computing the same function,
``scatter_reduce_(0, flat, rank, "amax")``. Inputs are made on the card
from a seed (torch.Generator). Imports torch and the port only; exits 2
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import port_probe_extract as pe  # noqa: E402

HBM_BYTES_PER_S = pe.HBM_BYTES_PER_S
F32_FLOPS_PER_S = pe.F32_FLOPS_PER_S
REPS = 21
MAIN_P = 14
MAIN_ROWS = 32_768  # the dense pool of 25,000 set series (+ scratch)
MAIN_BATCH = 16_384  # the worker's batch size
INSERT_CASES = ([(n, s, MAIN_P) for n in (16_384, 1_048_576)
                 for s in (1_024, MAIN_ROWS)]
                + [(n, 4_099, p) for n in (16_384, 1_048_576)
                   for p in (4, 8, 18)])
ESTIMATE_CASES = [(MAIN_ROWS, MAIN_P), (1, MAIN_P), (4_099, 4), (4_099, 8),
                  (4_099, 18)]
KINDS = ("zero", "linear", "switch", "raw", "full", "saturated")
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def _sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def regime_pool(s: int, p: int, seed: int, device):
    """int8[s, 2^p] register rows whose kind cycles through KINDS. A row
    of n distinct values has registers distributed as the max of
    Poisson(n/m) geometric ranks: P(reg <= k) = exp(-λ 2^-k), λ = n/m,
    sampled by the inverse; λ is drawn per row for its kind."""
    import torch

    m = 1 << p
    top = 64 - p + 1
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty((s, m), dtype=torch.int8, device=device)
    kind = torch.arange(s, device=device) % len(KINDS)
    lo = torch.tensor([0.0, 0.01, 2.0, 5.0, 20.0, 0.0], device=device)
    hi = torch.tensor([0.0, 1.0, 3.0, 50.0, 60.0, 0.0], device=device)
    lam = lo[kind] + (hi[kind] - lo[kind]) * torch.rand(
        s, generator=g, device=device)
    step = max(1, (1 << 24) // m)
    for a in range(0, s, step):
        b = min(s, a + step)
        u = torch.rand((b - a, m), generator=g, device=device)
        u = torch.clamp(u, min=1e-30, max=1.0 - 1e-7)
        reg = torch.ceil(torch.log2(lam[a:b, None] / -torch.log(u)))
        reg = torch.clamp(reg, 0, top)
        k = kind[a:b, None]
        reg = torch.where(k == 4, torch.clamp(reg, min=1), reg)
        reg = torch.where(k == 5, float(top), reg)
        reg = torch.where(k == 0, 0.0, reg)
        # one register at the largest rank in every raw row
        reg[:, 0] = torch.where(kind[a:b] == 3, float(top), reg[:, 0])
        out[a:b] = reg.to(torch.int8)
    return out


def updates(s: int, p: int, n: int, seed: int, device):
    """n (row, register, rank) updates into an s-row pool: int32 rows with
    a quarter on 64 hot rows (duplicate slots), a tenth rank-0 padding on
    the last row, a fiftieth outside [0, s); int32 registers; int8 ranks
    in [0, 64 - p + 1]."""
    import torch

    m = 1 << p
    g = torch.Generator(device=device).manual_seed(seed)

    def rint(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=g, device=device)

    rows = rint(0, max(1, s - 1), n)
    u = torch.rand(n, generator=g, device=device)
    rows = torch.where(u < 0.25, rint(0, min(64, s), n), rows)
    idx = rint(0, m, n)
    idx = torch.where(u < 0.25, rint(0, 8, n), idx)
    rank = rint(1, 64 - p + 2, n)
    pad = (u >= 0.25) & (u < 0.35)
    rows = torch.where(pad, s - 1, rows)
    rank = torch.where(pad, 0, rank)
    out = (u >= 0.35) & (u < 0.37)
    rows = torch.where(out, torch.where(u < 0.36, -1 - rint(0, 5, n),
                                        s + rint(0, 5, n)), rows)
    return (rows.to(torch.int32), idx.to(torch.int32),
            rank.to(torch.int8))


def insert_bound(s: int, p: int, rows, idx) -> tuple[float, str]:
    """Least time for one insert batch: each update's 9 bytes read once,
    each register it touches (distinct in-range slots) read and written
    once; no float work."""
    import torch

    m = 1 << p
    flat = rows.to(torch.int64) * m + idx.to(torch.int64)
    touched = int(torch.unique(flat[(flat >= 0) & (flat < s * m)]).numel())
    nbytes = 9 * rows.numel() + 2 * touched
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def estimate_bound(s: int, p: int) -> tuple[float, str]:
    """Least time for the estimate: S·m register bytes read once, S f32
    written; S·m f32 adds."""
    m = 1 << p
    t_bytes = (s * m + 4 * s) / HBM_BYTES_PER_S * 1e3
    t_ops = s * m / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_insert(hll) -> dict:
    """Every INSERT_CASES case: the kernel and the plain version on clones
    of one start pool, bytewise equal."""
    import torch

    dev = torch.device(DEVICE)
    for k, (n, s, p) in enumerate(INSERT_CASES):
        start = regime_pool(s, p, 100 + k, dev)
        a, b = start.clone(), start.clone()
        rows, idx, rank = updates(s, p, n, 200 + k, dev)
        hll.hll_kernel.insert(a, rows, idx, rank)
        _sync()
        hll.insert_batch_plain(b, rows, idx, rank)
        _sync()
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"hll_insert != plain at N={n} S={s} "
                                 f"p={p}: {bad} registers differ")
        if torch.equal(a, start):
            raise AssertionError(f"hll_insert changed nothing at N={n}")
        del start, a, b
    log(f"[hll] hll_insert bytewise equal to the plain version in "
        f"{len(INSERT_CASES)} cases (N, S, p) = {INSERT_CASES}")
    return {"cases": len(INSERT_CASES), "max_abs_err": 0.0}


def check_estimate(hll) -> dict:
    """Every ESTIMATE_CASES case: kernel and plain estimates equal in f32
    bits; every regime present."""
    import torch

    dev = torch.device(DEVICE)
    err = 0.0
    for k, (s, p) in enumerate(ESTIMATE_CASES):
        regs = regime_pool(s, p, 300 + k, dev)
        got = hll.hll_kernel.estimate(regs, p)
        _sync()
        ref = hll.estimate_plain(regs, p)
        _sync()
        same, e = pe.bitwise_equal(got, ref)
        if not same:
            bad = torch.nonzero(got.view(torch.int32) != ref.view(
                torch.int32)).flatten()[:5].tolist()
            raise AssertionError(f"hll_estimate != plain at S={s} p={p}, "
                                 f"rows {bad}")
        err = max(err, e)
        if s >= len(KINDS):
            m = 1 << p
            zeros = (regs == 0).sum(dim=1)
            lin = hll.hll_kernel._table("linear", p, dev)[zeros]
            on_lin = (got == lin) & (zeros > 0)
            sw = torch.arange(s, device=dev) % len(KINDS) == 2
            if not (bool((on_lin & sw).any()) and bool((~on_lin & sw).any())
                    and bool((zeros == 0).any())
                    and bool((regs == 64 - p + 1).any())):
                raise AssertionError(f"S={s} p={p}: a regime is missing")
            del zeros, lin, on_lin
        log(f"[hll] hll_estimate S={s} p={p}: bitwise_equal=True "
            f"max_abs_err={e} (f32 bits equal)")
        del regs, got, ref
    return {"cases": len(ESTIMATE_CASES), "max_abs_err": err}


def time_kernels(hll) -> dict:
    """Times at the main path's shapes: one insert batch of MAIN_BATCH
    updates into the MAIN_ROWS-row pool at p = 14 (each of the 22 calls
    of a timing gets a batch of its own, so the pool fills as an
    interval's does) and the estimate over that pool."""
    import torch

    dev = torch.device(DEVICE)
    s, p, n = MAIN_ROWS, MAIN_P, MAIN_BATCH
    m = 1 << p
    out = {}
    pool = regime_pool(s, p, 7, dev)
    batches = [updates(s, p, n, 1000 + i, dev) for i in range(3 * 23)]
    it = iter(batches)

    def nxt():
        return next(it)

    k_ms = pe.cuda_ms(lambda: hll.hll_kernel.insert(pool, *nxt()), REPS,
                      spin_cycles=2_000_000)
    p_ms = pe.cuda_ms(lambda: hll.insert_batch_plain(pool, *nxt()), REPS,
                      spin_cycles=2_000_000)
    flats = []
    for rows, idx, rank in batches[2 * 23:]:
        flat = rows.to(torch.int64) * m + idx.to(torch.int64)
        ok = (flat >= 0) & (flat < s * m)
        flats.append((flat[ok].contiguous(), rank[ok].contiguous()))
    fit = iter(flats)

    def library():
        f, r = next(fit)
        pool.view(-1).scatter_reduce_(0, f, r, "amax")

    try:
        lib_ms, lib_note = pe.cuda_ms(library, REPS,
                                      spin_cycles=2_000_000), None
    except RuntimeError as e:  # torch may refuse int8 amax on CUDA
        lib_ms, lib_note = None, f"scatter_reduce_ refused: {e}"[:300]
    b_ms, b_by = insert_bound(s, p, *batches[0][:2])
    out["hll_insert"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms,
                         "library_note": lib_note, "batch": n, "rows": s,
                         "precision": p}
    log(f"[hll] hll_insert N={n} into S={s} p={p}: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.4f} ms, library scatter_reduce_ "
        f"{'%.4f ms' % lib_ms if lib_ms is not None else lib_note}, "
        f"bound {b_ms:.6f} ms ({b_by})")
    k_ms = pe.cuda_ms(lambda: hll.hll_kernel.estimate(pool, p), REPS,
                      spin_cycles=2_000_000)
    p_ms = pe.cuda_ms(lambda: hll.estimate_plain(pool, p), 5)
    b_ms, b_by = estimate_bound(s, p)
    out["hll_estimate"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": None,
                           "rows": s, "precision": p}
    log(f"[hll] hll_estimate S={s} p={p}: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * b_ms / k_ms:.1f}% of bound; no single PyTorch call "
        f"computes it")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: the probe needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from veneur_tpu_torch.ops import hll, hll_kernel

    card = pe.card_line()
    log(f"[hll] card: {card}")
    hll_kernel.load()
    for name, rep in sorted(hll_kernel.build_report().items()):
        log(f"[hll] ptxas {name}: " + ", ".join(
            f"{k} {v}" for k, v in rep.items()))
    res = {"card": card, "insert": check_insert(hll),
           "estimate": check_estimate(hll), "times": time_kernels(hll)}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
