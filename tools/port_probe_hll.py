#!/usr/bin/env python3
"""The HyperLogLog kernels on one NVIDIA card: cases, checks, times, bounds.

    python3 tools/port_probe_hll.py [--json PATH] [--against DIR]

Holds ``hll_insert`` and ``hll_estimate`` (veneur_tpu_torch/csrc/hll.cu)
against their plain PyTorch versions (veneur_tpu_torch/ops/hll.py) on the
card, bytewise and in f32 bits, in the cases chip_smoke.py runs:

* hll_insert: N = 16,384, 16,383 and 1,048,576 updates into pools of
  1,024 and 32,768 rows at p = 14, and into 4,099-row pools at p = 4, 8
  and 18, plus N = 1,000,003 at p = 14. The updates hold duplicate words
  within a warp (a quarter on 64 hot rows and 8 registers), rank-0
  padding on the last row and rows outside the pool (negative ones wrap
  once or drop, past the end drop); every other start pool holds odd
  negative register values, which any update lifts.
* hll_estimate: 32,768 rows at p = 14, 1 row, 4,099 rows at p = 4, 8 and
  18. Rows cycle through every regime of the estimator: all zero; few
  distinct values (linear counting); about 2m to 3m distinct values, on
  both sides of the raw <= 2.5m switch; many (raw); full with no zero
  register; every register at the largest rank 64 - p + 1.

Then, at the main path's shapes (p = 14, the 32,768-row dense pool), the
median of 21 launches behind a device spin (port_probe_extract.cuda_ms)
of: an empty kernel at the insert's grid (the launch floor); hll_insert
on 16,384 all-distinct words, on the main path's own 16,384-update
batches (chip_smoke.py phase 4b's sets, with their duplicates) and on
1,048,576 updates; the plain version; the least time the card could take
(bytes moved over 3.35 TB/s or f32 operations over 67 TFLOP/s, the
larger); ``scatter_reduce_(0, flat, rank, "amax")``, one PyTorch call
computing the same function; and the estimate over that pool. The wall
time of one dense-store ``_device_set_step`` is split into its host
packing, its upload and its launch. With ``--against DIR`` the same
insert timings run for the checkout at DIR (say the parent commit,
unpacked with ``git archive``) in turns with this one (other, this,
this, other), and its ``_device_set_step`` is split too (padding, three
uploads, launch). The ptxas report of both libraries is printed. Inputs
are made on the card from a seed (torch.Generator). Imports torch and
the port only; exits 2 without CUDA.
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
INSERT_CASES = ([(n, s, MAIN_P) for n in (16_384, 16_383, 1_048_576)
                 for s in (1_024, MAIN_ROWS)]
                + [(n, 4_099, p) for n in (16_384, 1_048_576)
                   for p in (4, 8, 18)] + [(1_000_003, MAIN_ROWS, MAIN_P)])
BIG_BATCH = 1_048_576
# chip_smoke.py's sets: 64 series of 8,192 members, the rest of 20
N_SETS, N_SETS_BIG, BIG_MEMBERS, SMALL_MEMBERS = 25_000, 64, 8_192, 20
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


def odd_registers(pool, seed: int):
    """One register in eight of ``pool`` set to a random int8 in
    [-128, -1] (in place): values an import may leave, which signed max
    must lift on any update."""
    import torch

    g = torch.Generator(device=pool.device).manual_seed(seed)
    sel = torch.rand(pool.shape, generator=g, device=pool.device) < 0.125
    neg = torch.randint(-128, 0, pool.shape, generator=g,
                        device=pool.device).to(torch.int8)
    pool[sel] = neg[sel]
    return pool


def distinct_updates(s: int, p: int, n: int, seed: int, device):
    """n updates on n distinct 32-bit words of an s-row pool (no two in
    one word), ranks in [1, 64 - p + 1]."""
    import torch

    m = 1 << p
    g = torch.Generator(device=device).manual_seed(seed)
    words = torch.randperm(s * m // 4, generator=g, device=device)[:n]
    flat = words * 4 + torch.randint(0, 4, (n,), generator=g, device=device)
    rank = torch.randint(1, 64 - p + 2, (n,), generator=g, device=device)
    return ((flat // m).to(torch.int32), (flat % m).to(torch.int32),
            rank.to(torch.int8))


def main_path_batches(count: int, seed: int, device):
    """``count`` 16,384-update batches of the main path's set traffic at
    p = 14 (chip_smoke.py's set plan: members shuffled over the sets,
    random 64-bit hashes split into register and rank)."""
    import numpy as np
    import torch

    from veneur_tpu_torch.ops.hll import split_hashes

    rng = np.random.default_rng(seed)
    rows = np.concatenate([
        np.repeat(np.arange(N_SETS_BIG), BIG_MEMBERS),
        np.repeat(np.arange(N_SETS_BIG, N_SETS), SMALL_MEMBERS),
    ]).astype(np.int32)
    rows = rows[rng.permutation(len(rows))][:count * MAIN_BATCH]
    idx, rank = split_hashes(rng.integers(0, 2**64, len(rows),
                                          dtype=np.uint64), MAIN_P)
    return [tuple(torch.from_numpy(np.ascontiguousarray(a[i:i + MAIN_BATCH]))
                  .to(device) for a in (rows, idx, rank))
            for i in range(0, len(rows), MAIN_BATCH)]


def insert_bound(s: int, p: int, rows, idx) -> tuple[float, str]:
    """Least time for one insert batch: each update's 8-byte record read
    once, each register it touches (distinct slots in the pool, negative
    ones wrapped) read and written once; no float work."""
    import torch

    m = 1 << p
    flat = rows.to(torch.int64) * m + idx.to(torch.int64)
    flat = torch.where(flat < 0, flat + s * m, flat)
    touched = int(torch.unique(flat[(flat >= 0) & (flat < s * m)]).numel())
    nbytes = 8 * rows.numel() + 2 * touched
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
        if k % 2:
            odd_registers(start, 150 + k)
        rows, idx, rank = updates(s, p, n, 200 + k, dev)
        b = hll.insert_batch_plain(start.clone(), rows, idx, rank)
        a = hll.hll_kernel.insert(start.clone(),
                                  hll.records(rows, idx, rank, dev))
        _sync()
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            raise AssertionError(f"hll_insert != plain at N={n} S={s} "
                                 f"p={p}: {bad} registers differ")
        if torch.equal(b, start):
            raise AssertionError(f"hll_insert changed nothing at N={n}")
        del start, a, b
    log(f"[hll] hll_insert bytewise equal to the plain version in "
        f"{len(INSERT_CASES)} cases (N, S, p) = {INSERT_CASES}, odd "
        f"negative registers in every other start pool")
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


def _insert_fn(mod, pool, batch):
    """A call of checkout ``mod``'s hll_insert launcher on one batch,
    its inputs made beforehand: records for a launcher that takes them,
    three vectors for one that takes those (the parent's)."""
    import inspect

    params = inspect.signature(mod.hll_kernel.insert).parameters
    if "recs" in params:
        recs = mod.records(*batch, pool.device)
        return lambda: mod.hll_kernel.insert(pool, recs)
    return lambda: mod.hll_kernel.insert(pool, *batch)


def time_insert(hll, pool, batches) -> float:
    """Median ms of hll_insert over ``batches`` into ``pool``, emptied
    first (one batch per timed call, so the pool fills as the main path's
    dense pool does from the start of an interval)."""
    pool.zero_()
    calls = iter([_insert_fn(hll, pool, b) for b in batches])
    return pe.cuda_ms(lambda: next(calls)(), REPS, spin_cycles=2_000_000)


def time_kernels(hll, other=None) -> dict:
    """Times at the main path's shapes (see the module docstring); with
    ``other`` (that checkout's ops.hll) its insert in turns with this
    one's."""
    import torch

    dev = torch.device(DEVICE)
    s, p, n = MAIN_ROWS, MAIN_P, MAIN_BATCH
    m = 1 << p
    out = {}
    pool = regime_pool(s, p, 7, dev)  # the estimate's: every regime
    ipool = torch.zeros_like(pool)  # the inserts'
    k = REPS + 1
    sets = {"main_path": main_path_batches(2 * k, 11, dev),
            "distinct": [distinct_updates(s, p, n, 2000 + i, dev)
                         for i in range(2 * k)],
            "big": [updates(s, p, BIG_BATCH, 3000 + i, dev)
                    for i in range(2)]}
    grid = -(-n // hll.hll_kernel.load().hll_insert_threads_per_block())
    floor = pe.cuda_ms(lambda: hll.hll_kernel.noop(grid, dev), REPS,
                       spin_cycles=2_000_000)
    t = {"noop_ms": floor, "noop_grid": grid}
    for name, bs in sets.items():
        reps = bs if name != "big" else bs * k
        t[f"ms_{name}"] = time_insert(hll, ipool, reps)
    it = iter(sets["main_path"][k:])
    ipool.zero_()
    p_ms = pe.cuda_ms(lambda: hll.insert_batch_plain(ipool, *next(it)),
                      REPS, spin_cycles=2_000_000)

    def library_fn(batch):
        rows, idx, rank = batch
        flat = rows.to(torch.int64) * m + idx.to(torch.int64)
        flat = torch.where(flat < 0, flat + s * m, flat)
        ok = (flat >= 0) & (flat < s * m)
        f, r = flat[ok].contiguous(), rank[ok].contiguous()
        return lambda: ipool.view(-1).scatter_reduce_(0, f, r, "amax")

    lib = {}
    for name, bs in (("", sets["main_path"][:k]), ("_big", sets["big"])):
        ipool.zero_()
        calls = iter([library_fn(b) for b in (bs if name == "" else bs * k)])
        try:
            lib[name] = pe.cuda_ms(lambda: next(calls)(), REPS,
                                   spin_cycles=2_000_000)
        except RuntimeError as e:  # torch may refuse int8 amax on CUDA
            lib[name] = None
            t["library_note"] = f"scatter_reduce_ refused: {e}"[:300]
    b_ms, b_by = insert_bound(s, p, *sets["main_path"][0][:2])
    big_b_ms, _ = insert_bound(s, p, *sets["big"][0][:2])
    out["hll_insert"] = {"ms": t["ms_main_path"], "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "library_ms": lib[""], "library_ms_big":
                         lib["_big"], "bound_ms_big": big_b_ms,
                         "batch": n, "big_batch": BIG_BATCH, "rows": s,
                         "precision": p, **t}
    log(f"[hll] hll_insert N={n} into S={s} p={p}: main-path batches "
        f"{t['ms_main_path']:.4f} ms, distinct words "
        f"{t['ms_distinct']:.4f} ms, empty kernel at {grid} blocks "
        f"{floor:.4f} ms; N={BIG_BATCH}: {t['ms_big']:.4f} ms (bound "
        f"{big_b_ms:.4f} ms); plain {p_ms:.4f} ms; scatter_reduce_ "
        f"{lib['']} ms, at N={BIG_BATCH} {lib['_big']} ms; bound "
        f"{b_ms:.6f} ms ({b_by})")
    if other is not None:
        turns = {"other": {}, "this": {}}
        for who in ("other", "this", "this", "other"):
            mod = other if who == "other" else hll
            for name, bs in sets.items():
                reps = bs if name != "big" else bs * k
                turns[who].setdefault(name, []).append(
                    time_insert(mod, ipool, reps))
        out["hll_insert"]["against"] = turns
        for name in sets:
            log(f"[hll] hll_insert {name}: other checkout "
                f"{turns['other'][name]} ms, this checkout "
                f"{turns['this'][name]} ms (in turns other, this, this, "
                f"other)")
    del ipool
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


def step_split(worker_mod, reps: int = 21) -> dict:
    """Median wall seconds of one dense-store ``_device_set_step`` of
    checkout ``worker_mod`` (its core.worker) on the main path's batches,
    ended by a device sync, and of its parts as that checkout runs them:
    host packing (or padding), upload(s), launch, each ended by a sync."""
    import time

    import numpy as np
    import torch

    batches = [tuple(a.cpu().numpy() for a in b)
               for b in main_path_batches(reps + 1, 12, DEVICE)]
    w = worker_mod.DeviceWorker(set_store="dense", batch_size=MAIN_BATCH,
                                device=DEVICE)
    w._ensure_sets(N_SETS)
    hll = worker_mod.hll_ops
    parts: dict[str, list] = {}

    def clock(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        parts.setdefault(name, []).append(time.perf_counter() - t0)
        return r

    new_api = hasattr(hll, "HostInserter")
    buf = torch.empty((MAIN_BATCH, 2), dtype=torch.int32,
                      pin_memory=DEVICE == "cuda")
    for rows, idx, rank in batches:
        clock("step_s", lambda: w._device_set_step(rows, idx, rank))
        if new_api:
            host = clock("pack_s", lambda: hll.pack_updates(
                rows, idx, rank, buf.numpy()))
            recs = clock("upload_s", lambda: buf[:host].to(
                DEVICE, non_blocking=True))
            clock("launch_s", lambda: hll._insert_records(w._sets, recs))
        else:
            regs = w._sets

            def pad():
                n = worker_mod._next_pow2(len(rows), 256)
                pr = np.full(n, regs.shape[0] - 1, np.int32)
                pr[:len(rows)] = rows
                pi = np.zeros(n, np.int32)
                pi[:len(rows)] = idx
                pk = np.zeros(n, np.int8)
                pk[:len(rows)] = rank
                return pr, pi, pk

            padded = clock("pad_s", pad)
            dev = clock("upload_s", lambda: [worker_mod._to_device(a, DEVICE)
                                             for a in padded])
            clock("launch_s", lambda: hll.insert_batch(regs, *dev))
    return {k: sorted(v[1:])[len(v[1:]) // 2] for k, v in parts.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--against", type=Path,
                    help="another checkout whose hll_insert to time")
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
    ohll = oworker = None
    if args.against:
        ohll, ohk, oworker = pe.load_other(
            args.against.resolve(), "ops.hll", "ops.hll_kernel",
            "core.worker")
        ohk.load()
        for name, rep in sorted(ohk.build_report().items()):
            log(f"[hll] other checkout's ptxas {name}: " + ", ".join(
                f"{k} {v}" for k, v in rep.items()))
    res = {"card": card, "insert": check_insert(hll),
           "estimate": check_estimate(hll),
           "times": time_kernels(hll, ohll)}
    from veneur_tpu_torch.core import worker
    res["set_step"] = {"this": step_split(worker)}
    if oworker is not None:
        res["set_step"]["other"] = step_split(oworker)
    for who, split in res["set_step"].items():
        log(f"[hll] {who} checkout's _device_set_step, medians: " + ", ".join(
            f"{k} {v * 1e3:.4f} ms" for k, v in split.items()))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
