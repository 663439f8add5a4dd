#!/usr/bin/env python3
"""The t-digest fold kernels (K2, K3) on one NVIDIA card: checks, times, bounds.

    python3 tools/port_probe_tdigest.py [--json PATH] [--quick]

Holds K2a (``compress_rows``) and K2b (``add_batch``) of
veneur_tpu_torch/csrc/tdigest.cu against their plain PyTorch versions
(veneur_tpu_torch/ops/tdigest.py ``_compress_rows_plain``,
``add_batch_plain``) on the same CUDA inputs, every output in f32 bits
(NaN positions equal):

* K2a at the main path's shapes, on random rows and on digest rows as
  the main path builds them (``digest_candidates``: compressed rows side
  by side, then the staged fold's raw samples): [131,072, 192]
  (chip_smoke.py phase 4's
  staged fold, C + 64), [1,024, 256] and [65,536, 256] (import merges,
  C + W), [32,768, 256] (a 2-host mesh shard, H * C), [8,192, 1,152] (a
  global's import of 8 locals' digests, C + 1,024) and ragged [4,099,
  192] and [131,071, 256]; each with 16 edge rows in front (empty, one
  centroid, +0.0 and -0.0 means in both orders, denormal means,
  denormal weights, -0.0 weights, +-inf and NaN means, ties, underflowing
  products, weights near the f32 maximum).
* K2b at (K, N) = (64, 256), (1,024, 65,536) and (16,384, 262,144): a
  fresh pool, then the same batch again into the rows it made; N mostly
  live samples with zero-weight padding; edge batches (+-0.0 values,
  denormal values and weights, +-inf and NaN values, one hot row, ties,
  a row of one sample) at (16, 4,096); and a batch of 70,000 samples all
  in one row (the sort's merge passes over the whole batch).

* K3, the staged fold (core/worker.fold_staged: ``td_fold_warps``, or
  ``td_stage_rows`` and K2a past a warp's 256 candidates) against its
  plain chain (``_fold_staged_plain``) at FOLD_CASES, [131,072, C = 128,
  B = 64] (phase 4's) first, ragged 131,071 and 4,099 rows, B = 40: the
  plane dense, flat with unit weights, flat weighted, and a dense mirror
  a third shorter than the pool; at the first case the pool split in 4
  row blocks (a sharded worker's segments); 16 edge rows each
  (``fold_inputs``: +-0.0, denormal, +-inf and NaN samples, denormal
  and non-positive weights, w / v and v * w denormal, empty, full and
  one-sample rows; pool scalars normal, +-0.0, +-inf, NaN, denormal).
* The signed zeros of digest min and max (``check_signed_zeros``): the
  port's XLA-order min and max (ops/exactnum.py: ``minimum``,
  ``maximum``, ``amin``, ``amax``, ``scatter_amin_``, ``scatter_amax_``,
  ``pmin0``, ``pmax0``) on the card against the CPU, on rows that mix
  +0.0, -0.0 and NaN at widths 1, 9, 33 and 64, every bit and every
  NaN's sign; and K2b's min and max of +-0.0 batches into +-0.0 (and NaN)
  digest scalars against its plain version.

Then the median of REPS calls behind a device spin
(port_probe_extract.cuda_ms) of each kernel, its plain version on the
card, and, beside K2b (timed as the whole chain of its launches from the
unsorted batch, the sort included), the dispatcher ``add_batch``
(``with_sort_ms``), the plain version's sort alone on the card
(``sort_ms``: the two stable torch.sort calls of ``_sort_batch``, off the
path since the sort moved into the kernels) and the chain's kernel
launches (``launches``: the launcher's count, and the kernels a
torch.profiler trace of one call at (1,024, 65,536) records, with no
kernel of torch's among them); the least time the card could take
(bytes over 3.35 TB/s: K2a reads S * M * 8 and writes S * C * 8; K2b
reads the [K, C] rows, three scalars a row and the batch's N * 12 and
writes the [K, C] rows and eight scalars a row; K3 ``fold_bound``); K3's
kernels in a torch.profiler trace of one fold (``profile_fold``: K3
alone); and ptxas's report.
Inputs are made on the card from a seed (torch.Generator). No single
PyTorch call computes either function (library_ms null). ``--quick``
checks one shape of each, the edges and the signed zeros and times
nothing; ``--fold`` checks, traces and times K3 alone (with K2a alone
over the same candidates beside it), holds its rank path's edge rows
(``rank_case``) to the CPU with the card's tally of each row's path,
and reports the paths of [131,072, C = 128, B = 64]'s rows. Imports
torch and the port only; exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import port_probe_extract as pe  # noqa: E402

HBM_BYTES_PER_S = pe.HBM_BYTES_PER_S
REPS = 21
C = 128
COMPRESSION = 100.0
COMPRESS_CASES = [(131_072, 192), (1_024, 256), (65_536, 256),
                  (32_768, 256), (8_192, 1_152), (4_099, 192),
                  (131_071, 256)]
# timed at the main path's shapes
COMPRESS_TIMED = [(131_072, 192), (65_536, 256), (32_768, 256),
                  (8_192, 1_152)]
ADD_CASES = [(64, 256), (1_024, 65_536), (16_384, 262_144)]
EDGE_ADD = (16, 4_096)
ONE_ROW_ADD = (4, 70_000)  # every sample in one row: the sort's merges
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def _gen(seed: int, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def edge_rows(m: int, device):
    """16 candidate rows [16, m] of edge cases (the module docstring)."""
    import torch

    f32 = torch.float32
    tiny = torch.finfo(f32).tiny
    g = _gen(1000 + m, device)
    means = torch.randn((16, m), generator=g, device=device) * 20 + 50
    w = torch.ones((16, m), dtype=f32, device=device)
    half = m // 2
    w[0] = 0.0                                       # empty
    w[1] = 0.0
    w[1, 3] = 2.5                                    # one centroid
    means[2, :half] = torch.where(torch.arange(half, device=device) % 2 == 0,
                                  0.0, -0.0)         # +0, -0
    means[2, half:] = torch.where(
        torch.arange(m - half, device=device) % 2 == 0, -0.0, 0.0)
    means[3] = (torch.randint(-2 ** 20, 2 ** 20, (m,), generator=g,
                              device=device).to(f32) * 1e-45)  # denormal
    w[4] = (torch.randint(1, 2 ** 20, (m,), generator=g,
                          device=device).to(f32) * 1e-45)
    w[5, ::2] = -0.0
    means[6, ::3] = float("inf")
    means[6, 1::5] = float("-inf")
    means[7, ::4] = float("nan")
    means[7, 1::9] = -float("nan")
    means[8] = torch.round(means[8] / 10) * 10       # ties
    means[9] = (torch.where(torch.rand((m,), generator=g, device=device)
                            < 0.5, -1.0, 1.0) * tiny
                * (1 + torch.rand((m,), generator=g, device=device)))
    w[10] = torch.rand((m,), generator=g, device=device) * 3e38
    means[11, : m // 3] = 7.0                        # one long tie run
    w[12, m // 2:] = 0.0
    means[13] = torch.arange(m, 0, -1, device=device).to(f32)
    w[14] = torch.rand((m,), generator=g, device=device) * 1e-3
    w[15, ::7] = 0.0
    return means.contiguous(), w.contiguous()


def candidates(s: int, m: int, seed: int, device, edges: bool = True):
    """[s, m] candidate rows as a fold builds them: a digest row of up to
    C centroids (sorted, +inf padding) beside m - C raw samples; a third
    of the slots empty; with ``edges``, edge rows in front."""
    import torch

    g = _gen(seed, device)
    means = torch.randn((s, m), generator=g, device=device) * 20 + 50
    w = torch.exp(torch.randn((s, m), generator=g, device=device))
    empty = torch.rand((s, m), generator=g, device=device) < 0.3
    w = torch.where(empty, 0.0, w)
    means = torch.where(empty, float("inf"), means)
    head = means[:, :C].sort(dim=-1).values
    means = torch.cat([head, means[:, C:]], dim=-1)
    if edges:
        em, ew = edge_rows(m, device)
        k = min(16, s)
        means[:k], w[:k] = em[:k], ew[:k]
    return means.contiguous(), w.contiguous()


def digest_candidates(s: int, m: int, seed: int, device):
    """[s, m] candidate rows as the main path builds them: m // C digest
    rows side by side (each a compressed row: live centroids sorted, then
    +inf and weight 0), then m % C raw samples (the staged fold's),
    unsorted, a third of them empty."""
    import torch

    from veneur_tpu_torch.ops import tdigest as td

    parts_m, parts_w = [], []
    for r in range(m // C):
        cm, cw = candidates(s, 2 * C, seed + r, device, edges=False)
        cm, cw = td.compress_rows(cm, cw, COMPRESSION, C)
        parts_m.append(cm)
        parts_w.append(cw)
    if m % C:
        g = _gen(seed + 99, device)
        raw = torch.randn((s, m % C), generator=g, device=device) * 20 + 50
        rw = (torch.rand((s, m % C), generator=g, device=device)
              > 1 / 3).float()
        parts_m.append(raw)
        parts_w.append(rw)
    return (torch.cat(parts_m, dim=1).contiguous(),
            torch.cat(parts_w, dim=1).contiguous())


def sample_batch(k: int, n: int, seed: int, device, edge: bool = False):
    """A spill batch of n samples over k rows (int32 rows, f32 values and
    weights; a tenth zero-weight padding on the last row), or, with
    ``edge``, the edge batch of the module docstring."""
    import torch

    f32 = torch.float32
    g = _gen(seed, device)
    rows = torch.randint(0, k, (n,), generator=g, device=device,
                         dtype=torch.int32)
    u = torch.rand((2, n), generator=g, device=device)
    vals = (-torch.log(u[0] * u[1]) * 30.0).to(f32)  # gamma(2, 30)
    wts = torch.ones((n,), dtype=f32, device=device)
    wts[torch.rand((n,), generator=g, device=device) < 0.2] = 2.0
    pad = torch.rand((n,), generator=g, device=device) < 0.1
    rows = torch.where(pad, k - 1, rows)
    wts = torch.where(pad, 0.0, wts)
    if edge:
        tiny = torch.finfo(f32).tiny
        r = rows % 16
        vals = torch.where(r == 0, torch.where(torch.arange(
            n, device=device) % 2 == 0, 0.0, -0.0), vals)
        vals = torch.where(r == 1, torch.randint(
            -2 ** 20, 2 ** 20, (n,), generator=g, device=device).to(f32)
            * 1e-45, vals)
        wts = torch.where(r == 2, torch.randint(
            1, 2 ** 20, (n,), generator=g, device=device).to(f32) * 1e-45,
            wts)
        vals = torch.where((r == 3) & (torch.arange(n, device=device) % 3
                                       == 0), float("inf"), vals)
        vals = torch.where((r == 4) & (torch.arange(n, device=device) % 5
                                       == 0), float("nan"), vals)
        vals = torch.where(r == 5, tiny * 1.5, vals)
        vals = torch.where(r == 6, torch.round(vals / 10) * 10, vals)
        rows = torch.where(torch.arange(n, device=device) < n // 4, 7, rows)
        rows = torch.where(rows == 8, 9, rows)
        rows[0] = 8  # a row of one sample
        wts[0] = 1.0
        vals = torch.where(r == 10, -vals, vals)
    return rows.contiguous(), vals.contiguous(), wts.contiguous()


def empty_pool(k: int, device):
    from veneur_tpu_torch.ops import tdigest as td

    return tuple(td.init_pool(k, C, device=device))


def _equal(got, ref, what: str) -> float:
    ok, err = pe.bitwise_equal(got, ref)
    if not ok:
        raise AssertionError(f"{what}: the kernel is not bitwise equal to "
                             f"the plain version (max |diff| {err})")
    return err


def check_compress(td, cases=COMPRESS_CASES) -> dict:
    """K2a against the plain version at every case; the worst error."""
    worst = 0.0
    for s, m in cases:
        for kind, make in (("16 edge rows", candidates),
                           ("digest rows", digest_candidates)):
            means, w = make(s, m, s + m, DEVICE)
            km, kw = td.compress_rows(means, w, COMPRESSION, C)
            pm, pw = td._compress_rows_plain(means, w, COMPRESSION, C)
            worst = max(worst,
                        _equal(km, pm, f"compress [{s}, {m}] means"),
                        _equal(kw, pw, f"compress [{s}, {m}] weights"))
            del means, w, km, kw, pm, pw
        log(f"[tdigest] K2a [{s:,}, {m:,}]: bitwise equal (random rows, 16 "
            f"edge rows; digest rows as the main path builds them)")
    return {"cases": [list(c) for c in cases], "bitwise": True,
            "max_abs_err": worst}


def _add_both(td, pool, batch):
    k_out = td.add_batch(*pool, *batch, compression=COMPRESSION)
    p_out = td.add_batch_plain(*pool, *batch, compression=COMPRESSION)
    return k_out, p_out


def check_add(td, cases=ADD_CASES) -> dict:
    """K2b against the plain version: each case's batch into a fresh pool
    and again into the rows it made; the edge batch and a batch all in
    one row likewise."""
    import torch

    worst = 0.0
    names = ("means", "weights", "min", "max", "recip") + tuple(
        f"stats.{f}" for f in td.BatchStats._fields)
    runs = [(k, n, False) for k, n in cases] + [(*EDGE_ADD, True),
                                                 (*ONE_ROW_ADD, False)]
    for k, n, edge in runs:
        batch = sample_batch(k, n, k + n, DEVICE, edge)
        if (k, n) == ONE_ROW_ADD:
            batch = (torch.full_like(batch[0], 2),) + batch[1:]
        pool = empty_pool(k, DEVICE)
        for rnd in range(2):
            k_out, p_out = _add_both(td, pool, batch)
            kf = list(k_out[:5]) + list(k_out[5])
            pf = list(p_out[:5]) + list(p_out[5])
            for name, a, b in zip(names, kf, pf):
                worst = max(worst, _equal(
                    a, b, f"add_batch ({k}, {n}) round {rnd} {name}"))
            pool = tuple(p_out[:5])
        log(f"[tdigest] K2b (K {k:,}, N {n:,}){' edge' if edge else ''}: "
            f"bitwise equal, two rounds")
    return {"cases": [list(c) for c in cases] + [list(EDGE_ADD),
                                                 list(ONE_ROW_ADD)],
            "bitwise": True, "max_abs_err": worst}


NAN_POS, NAN_NEG = 0x7FC00001, 0xFFC00002
F6_WIDTHS = (1, 9, 33, 64)


def mixed(g, shape, device, nan: bool = True):
    """f32 values drawn from +0.0 and -0.0 (most), +-1, +-inf and, with
    ``nan``, NaNs of both signs; the first row alternating zeros."""
    import torch

    pool = torch.tensor([0.0, -0.0, 0.0, -0.0, 1.0, -1.0, float("inf"),
                         float("-inf")], device=device)
    if nan:
        bits = torch.tensor([NAN_POS, NAN_NEG], dtype=torch.int64)
        pool = torch.cat([pool, bits.to(torch.int32).view(torch.float32)
                          .to(device)])
    idx = torch.randint(0, pool.numel(), shape, generator=g, device=device)
    out = pool[idx].reshape(-1, shape[-1])
    out[0] = torch.where(torch.arange(shape[-1], device=device) % 2 == 0,
                         0.0, -0.0)
    return out.reshape(shape).contiguous()


def _same_signed(got, ref, what: str) -> None:
    """Bits equal, NaN positions and NaN signs equal."""
    import torch

    got = got.cpu()
    ok, _ = pe.bitwise_equal(got, ref)
    if not ok or not torch.equal(torch.signbit(got), torch.signbit(ref)):
        raise AssertionError(f"{what}: the card differs from the CPU in "
                             f"min or max (bits or a sign)")


def check_signed_zeros(td) -> dict:
    """XLA-order min and max on the card against the CPU, and K2b's min
    and max of signed zeros against its plain version."""
    import torch

    from veneur_tpu_torch.ops import exactnum as exn

    g = _gen(77, DEVICE)
    cases = 0
    for w in F6_WIDTHS:
        a, b = mixed(g, (8, w), DEVICE), mixed(g, (8, w), DEVICE)
        ac, bc = a.cpu(), b.cpu()
        pairs = [(exn.minimum(a, b), exn.minimum(ac, bc), "minimum"),
                 (exn.maximum(a, b), exn.maximum(ac, bc), "maximum"),
                 (exn.pmin0(a), exn.pmin0(ac), "pmin0"),
                 (exn.pmax0(a), exn.pmax0(ac), "pmax0")]
        for axis in (0, -1):
            pairs += [(exn.amin(a, axis), exn.amin(ac, axis), "amin"),
                      (exn.amax(a, axis), exn.amax(ac, axis), "amax")]
        dst = mixed(g, (1, 5), DEVICE)[0]
        idx = torch.randint(0, 5, (w,), generator=g, device=DEVICE)
        src = mixed(g, (1, w), DEVICE)[0]
        pairs += [(exn.scatter_amin_(dst.clone(), idx, src),
                   exn.scatter_amin_(dst.cpu().clone(), idx.cpu(), src.cpu()),
                   "scatter_amin_"),
                  (exn.scatter_amax_(dst.clone(), idx, src),
                   exn.scatter_amax_(dst.cpu().clone(), idx.cpu(), src.cpu()),
                   "scatter_amax_")]
        for got, ref, name in pairs:
            _same_signed(got, ref, f"{name} width {w}")
            cases += 1
        k, n = w, 4 * w
        rows = torch.randint(0, k, (n,), generator=g, device=DEVICE,
                             dtype=torch.int32)
        vals = mixed(g, (1, n), DEVICE, nan=False)[0]
        wts = torch.ones((n,), device=DEVICE)
        pool = list(empty_pool(k, DEVICE))
        pool[2], pool[3] = mixed(g, (2, k), DEVICE)
        got = td.add_batch(*pool, rows, vals, wts)
        ref = td.add_batch_plain(*pool, rows, vals, wts)
        for i, name in ((2, "min"), (3, "max")):
            _same_signed(got[i], ref[i].cpu(), f"add_batch {name} width {w}")
            cases += 1
    log(f"[tdigest] signed zeros: the card equals the CPU in {cases} min "
        f"and max cases (widths {', '.join(map(str, F6_WIDTHS))}), "
        f"K2b's min and max its plain version's")
    return {"cases": cases, "widths": list(F6_WIDTHS), "bitwise": True}


def profile_chain(td, k: int = 1_024, n: int = 65_536) -> dict:
    """The kernels one ``add_batch`` at (k, n) launches, from a
    torch.profiler trace: their names, counts and device microseconds,
    and whether any is not csrc/tdigest.cu's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows, vals, wts = sample_batch(k, n, 5, DEVICE)
    pool = empty_pool(k, DEVICE)
    td.add_batch(*pool, rows, vals, wts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        td.add_batch(*pool, rows, vals, wts)
        torch.cuda.synchronize()
    names, us = {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.name.startswith(("Memcpy", "Memset")):
            continue
        m = re.search(r"(td_\w+)(<(true|false)>)?", ev.name)
        short = (m.group(1) + ("_block" if m.group(3) == "true" else
                               "_warp" if m.group(3) else "")
                 if m else ev.name)
        names[short] = names.get(short, 0) + 1
        t = getattr(ev, "device_time", None)
        us[short] = us.get(short, 0.0) + float(
            t if t is not None else ev.cuda_time)
    foreign = sorted(nm for nm in names if "td_" not in nm)
    out = {"rows": k, "samples": n, "kernels": sum(names.values()),
           "names": names, "device_us": us, "foreign": foreign}
    log(f"[tdigest] K2b chain at (K {k:,}, N {n:,}): {out['kernels']} "
        f"kernel launches in a trace, {len(foreign)} not of tdigest.cu; "
        f"device us: " + ", ".join(f"{nm} {v:.1f}" for nm, v in us.items()))
    return out


# K3, the staged fold: phase 4's shape, ragged pools, a shallower plane
FOLD_CASES = [(131_072, 64), (131_071, 64), (4_099, 64), (4_099, 40)]
FOLD_TIMED = (131_072, 64)
FOLD_SHARDS = 4
FOLD_FORMS = ("dense", "flat_unit", "flat_weighted")
SCALAR_POOL = (-1.0, 1.0, 0.0, -0.0, float("inf"), float("-inf"),
               float("nan"), 3e-38, 1.5e-38, -1.3e-38, 1e-40, -2e-40)


def fold_inputs(s: int, b: int, seed: int, device, edges: bool = True):
    """The worker's 14 pool fields over s rows (compressed digest rows,
    each scalar drawn from SCALAR_POOL: normal, +-0.0, +-inf, NaN and
    denormal) and a staged plane [s, b] as the host stages it (each
    row's count of samples first, empty slots 0.0 and weight 0.0): the
    values, the weights and the counts. With ``edges``, the first 16
    rows (i % 16): +-0.0 samples, denormal samples, denormal weights,
    +-inf, NaN, samples whose w / v or v * w is denormal, weights 0, -1
    and NaN, an empty row, a full row, a row of one sample."""
    import torch

    from veneur_tpu_torch.ops import tdigest as td

    f32 = torch.float32
    g = _gen(seed, device)
    means, w = candidates(s, 2 * C, seed, device, edges=False)
    means, w = td.compress_rows(means, w, COMPRESSION, C)
    pool = torch.tensor(SCALAR_POOL, dtype=f32, device=device)
    scal = pool[torch.randint(0, len(SCALAR_POOL), (12, s), generator=g,
                              device=device)]
    fields = [means, w] + [t.contiguous() for t in scal.unbind(0)]
    v = torch.randn((s, b), generator=g, device=device) * 20 + 50
    wt = torch.tensor([1.0, 0.5, 2.0, 4.0], device=device)[torch.randint(
        0, 4, (s, b), generator=g, device=device)]
    counts = torch.randint(0, b + 1, (s,), generator=g, device=device)
    if edges:
        k = min(16, s)

        def pick(*vals):
            t = torch.tensor(vals, dtype=f32, device=device)
            return t[torch.randint(0, len(vals), (b,), generator=g,
                                   device=device)]

        tiny = torch.finfo(f32).tiny
        rows = {0: (pick(0.0, -0.0), None),
                1: (pick(1e-40, -3e-41, 2e-45), None),
                2: (None, pick(1e-40, 5e-39)),
                3: (pick(float("inf"), float("-inf"), 3.0), None),
                4: (pick(float("nan"), -float("nan"), 1.0), None),
                5: (pick(1e38, -3e38), pick(1.0)),
                6: (pick(1e-20, -3e-20), pick(1e-19)),
                7: (None, pick(0.0, -1.0, float("nan"), 1.0)),
                8: (pick(tiny, -tiny, 1.5 * tiny), None)}
        for r in range(k):
            vv, ww = rows.get(r, (None, None))
            if vv is not None:
                v[r] = vv
            if ww is not None:
                wt[r] = ww
        counts[9 % s] = 0
        counts[10 % s] = b
        counts[11 % s] = 1
    valid = torch.arange(b, device=device)[None, :] < counts[:, None]
    v = torch.where(valid, v, 0.0).contiguous()
    wt = torch.where(valid, wt, 0.0).contiguous()
    return fields, v, wt, counts.to(torch.int32).cpu().numpy()


def flat_plane(v, w, counts, unit: bool):
    """A staged plane's compaction as the worker uploads it: the filled
    slots row-major, padded to a power of two (at least 1,024), the
    weights None with ``unit``."""
    import torch

    mask = torch.arange(v.shape[1], device=v.device)[None, :] \
        < torch.from_numpy(counts).to(v.device)[:, None]
    n = int(mask.sum())
    n_pad = max(1024, 1 << max(n - 1, 0).bit_length())
    fv = torch.zeros(n_pad, dtype=v.dtype, device=v.device)
    fv[:n] = v[mask]
    fw = None
    if not unit:
        fw = torch.zeros(n_pad, dtype=v.dtype, device=v.device)
        fw[:n] = w[mask]
    return fv, fw


def stage_of(tw, form: str, v, w, counts, rows=None):
    """The plane as the fold takes it: ``form`` dense (its first ``rows``
    rows: a mirror shorter than the pool), flat_unit (every weight 1.0,
    ``w`` unread) or flat_weighted."""
    if form == "dense":
        r = v.shape[0] if rows is None else rows
        return tw.DenseStage(v[:r].contiguous(), w[:r].contiguous())
    fv, fw = flat_plane(v, w, counts, form == "flat_unit")
    return tw.FlatStage(fv, fw, counts, v.shape[1])


# K3's rank path (the pool row sorted, the staged tail placed by rank):
# edge rows by kind, at these depths; each row's path predicted on the
# host (``row_paths``) as td_fold_warps' row routine chooses it
RANK_KINDS = ("ties", "specials", "denormals", "sparse", "full", "unsorted")
# the widest tail the rank path places (wider tails are sorted), read
# from the kernel's source: csrc/tdigest.cu kRankMax
RANK_MAX = int(re.search(
    r"constexpr int kRankMax = (\d+);",
    (ROOT / "veneur_tpu_torch" / "csrc" / "tdigest.cu").read_text())[1])
RANK_DEPTHS = (1, 33, 40, 64, 128)


def _flush_np(x):
    """exactnum.flush_denormals in numpy: a denormal becomes its zero."""
    import numpy as np

    u = x.view(np.uint32)
    return np.where((u & 0x7F800000) == 0,
                    (u & 0x80000000).view(np.float32), x).astype(np.float32)


def order_key_np(x):
    """The kernels' 32-bit order key (ops/tdigest._order_key as uint32):
    ascending, -0.0 == +0.0, every NaN above +inf."""
    import numpy as np

    u = x.view(np.uint32).astype(np.uint64)
    k = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    k = np.where((u & 0x7FFFFFFF) == 0, 0x80000000, k)
    return np.where(np.isnan(x), 0xFFFFFFFF, k).astype(np.uint32)


def row_paths(means, weights, v, w):
    """Each row's path in td_fold_warps (tdigest_kernel.PATHS index) for
    the pool rows (numpy [S, C]) and the dense staged slots [S, B] as
    the kernel reads them (a flat plane's unit weights 1.0 below the
    count): the candidates' keys (zero-weight slots +inf); every run of
    C sorted -> "runs"; the pool part sorted and a tail of at most
    RANK_MAX -> "rank", of at most 128 -> "tail"; else "network"."""
    import numpy as np

    c = means.shape[1]
    cw = _flush_np(np.concatenate([weights, w], axis=1))
    cm = np.where(cw > 0, _flush_np(np.concatenate([means, v], axis=1)),
                  np.float32(np.inf)).astype(np.float32)
    k = order_key_np(cm).astype(np.int64)
    down = k[:, 1:] < k[:, :-1]          # position i + 1 below i
    at = np.arange(1, k.shape[1])
    pow2 = c & (c - 1) == 0 and 2 * c <= 256
    start = (at % c == 0) if pow2 else (at == c)
    good = ~(down & ~start[None, :]).any(axis=1)
    head = ~down[:, :c - 1].any(axis=1)
    tn = k.shape[1] - c
    return np.where(good, 0, np.where(head & (tn <= RANK_MAX), 1, np.where(
        head & (tn <= 128), 2, 3)))


def rank_case(kind: str, b: int, s: int = 24, seed: int = 0):
    """The 14 pool fields (numpy) and a dense staged plane [s, b] with
    its counts, for the rank path's edge rows of ``kind``:

    * ties: centroids and samples from one grid with +0.0 and -0.0, so
      samples equal (in order key) to centroids and runs of equal
      samples; 0 to C live centroids;
    * specials: NaN, -NaN, +-inf samples, zero weights among the counted
      slots (a +inf sample beside zero-weight slots), rows with a live
      +inf centroid before the padding or a NaN one after it;
    * denormals: f32 denormal samples and weights among normal ones;
    * sparse: empty rows and rows of one live centroid;
    * full: every centroid live;
    * unsorted: as ties, with two centroids swapped (the whole network).
    """
    import numpy as np

    f32 = np.float32
    rng = np.random.default_rng(1_000 * RANK_KINDS.index(kind) + b + seed)
    grid = np.array([-2.0, -1.0, -0.0, 0.0, 0.5, 1.0, 2.0, 3.0], f32)
    means = np.full((s, C), np.inf, f32)
    wts = np.zeros((s, C), f32)
    if kind == "sparse":
        live = np.where(np.arange(s) % 2 == 0, 0, 1)
    elif kind == "full":
        live = np.full(s, C)
    elif kind == "unsorted":
        live = rng.integers(2, C + 1, s)
    else:
        live = rng.integers(0, C + 1, s)
    for r in range(s):
        k = int(live[r])
        if kind in ("ties", "unsorted"):
            row = rng.choice(grid, k)
        else:
            row = rng.normal(1.0, 2.0, k).astype(f32)
        row = row[np.argsort(order_key_np(row), kind="stable")]
        means[r, :k] = row
        wts[r, :k] = rng.choice(np.array([1.0, 2.0], f32), k)
        if kind == "specials" and 0 < k < C - 1:
            # a live +inf centroid before the padding, or a NaN one after
            # it (where a compression puts NaN means)
            at = C - 1 if r % 2 else k
            means[r, at] = np.nan if r % 2 else np.inf
            wts[r, at] = 1.0
        if kind == "unsorted":
            a = int(rng.integers(0, k - 1))
            means[r, a], means[r, k - 1] = means[r, k - 1], means[r, a]
            if means[r, a] == means[r, k - 1]:
                means[r, a] = means[r, k - 1] + 1.0
    # the 12 scalars from SCALAR_POOL; min and max (0, 1, 4, 5) never
    # denormal, as a pool never holds them (where XLA's fold at depth 1
    # would pass one through a row with no live sample)
    scal = np.array(SCALAR_POOL, f32)
    normal = scal[(scal == 0) | (np.abs(scal) >= np.finfo(f32).tiny)
                  | np.isnan(scal)]
    fields = [means, wts] + [rng.choice(normal if k in (0, 1, 4, 5)
                                        else scal, s).astype(f32)
                             for k in range(12)]
    counts = rng.integers(0, b + 1, s).astype(np.int32)
    counts[0] = b
    if kind in ("ties", "unsorted", "sparse"):
        v = rng.choice(grid, (s, b))
    else:
        v = rng.normal(1.0, 2.0, (s, b)).astype(f32)
    w = rng.choice(np.array([1.0, 0.5, 2.0], f32), (s, b))
    if kind == "specials":
        v = np.where(rng.random((s, b)) < 0.4, rng.choice(np.array(
            [np.nan, -np.nan, np.inf, -np.inf], f32), (s, b)), v)
        w = np.where(rng.random((s, b)) < 0.2, f32(0.0), w)
    if kind == "denormals":
        v = np.where(rng.random((s, b)) < 0.5, (rng.integers(
            -2**20, 2**20, (s, b)) * f32(1e-45)).astype(f32), v)
        w = np.where(rng.random((s, b)) < 0.3, (rng.integers(
            1, 2**20, (s, b)) * f32(1e-45)).astype(f32), w)
    valid = np.arange(b)[None, :] < counts[:, None]
    v = np.where(valid, v, f32(0.0)).astype(f32)
    w = np.where(valid, w, f32(0.0)).astype(f32)
    return fields, v, w, counts


def check_fold_staged(tw, cases=FOLD_CASES) -> dict:
    """K3 (core/worker.fold_staged) against its plain chain
    (``_fold_staged_plain``: the planes rebuilt, then the staged fold's
    torch ops and K2a) on the same card inputs, all 14 fields: every
    case dense, flat with unit weights and flat weighted, a dense plane
    a third shorter than the pool, and at the first case the pool split
    in FOLD_SHARDS row blocks (each its own flat segment and counts)."""
    import torch

    worst = 0.0
    calls, before = 0, tw.fold_staged.launches
    for s, b in cases:
        fields, v, w, counts = fold_inputs(s, b, s + b, DEVICE)
        stages = [(f, stage_of(tw, f, v, w, counts)) for f in FOLD_FORMS]
        stages.append(("dense_short", stage_of(tw, "dense", v, w, counts,
                                               rows=s - s // 3)))
        for form, stage in stages:
            got = tw.fold_staged(fields, stage)
            calls += 1
            ref = tw._fold_staged_plain(fields, stage)
            for i, (a, r) in enumerate(zip(got, ref)):
                worst = max(worst, _equal(a, r, f"fold_staged [{s}, {b}] "
                                                f"{form} field {i}"))
        if (s, b) == cases[0]:
            ref = tw._fold_staged_plain(fields, stages[2][1])
            cut = [d * (s // FOLD_SHARDS) for d in range(FOLD_SHARDS)] + [s]
            parts = []
            for d in range(FOLD_SHARDS):
                sl = slice(cut[d], cut[d + 1])
                st = stage_of(tw, "flat_weighted", v[sl], w[sl],
                              counts[sl].copy())
                parts.append(tw.fold_staged([f[sl].contiguous()
                                             for f in fields], st))
                calls += 1
            for i, r in enumerate(ref):
                got = torch.cat([p[i] for p in parts])
                worst = max(worst, _equal(got, r, f"fold_staged [{s}, {b}] "
                                                  f"{FOLD_SHARDS} shards "
                                                  f"field {i}"))
        log(f"[tdigest] K3 [{s:,}, C {C}, B {b}]: bitwise equal to the "
            f"plain chain (dense, flat unit, flat weighted, a short "
            f"mirror{', a 4-shard split' if (s, b) == cases[0] else ''}; "
            f"16 edge rows)")
        del fields, v, w, stages
    launched = tw.fold_staged.launches - before
    if DEVICE == "cuda" and launched != calls:
        raise AssertionError(f"fold_staged launched K3 {launched} times in "
                             f"{calls} calls on the card")
    return {"cases": [list(c) for c in cases], "bitwise": True,
            "max_abs_err": worst, "launches": launched}


def check_rank_cases(tw, tk) -> dict:
    """K3's rank path on the card against the CPU's plain chain at every
    RANK_KINDS x RANK_DEPTHS case (``rank_case``), dense, flat unit and
    flat weighted, all 14 fields bitwise, and the card's tally of its
    rows' paths equal to ``row_paths``' prediction; the tallies summed."""
    import numpy as np
    import torch

    total = np.zeros(len(tk.PATHS), np.int64)
    for kind in RANK_KINDS:
        for b in RANK_DEPTHS:
            f_np, v, w, counts = rank_case(kind, b)
            fields = [torch.from_numpy(a).to(DEVICE) for a in f_np]
            cpu = [torch.from_numpy(a) for a in f_np]
            for form in FOLD_FORMS:
                wd = w
                if form == "flat_unit":
                    wd = (np.arange(b)[None, :]
                          < counts[:, None]).astype(np.float32)
                st = stage_of(tw, form, torch.from_numpy(v).to(DEVICE),
                              torch.from_numpy(wd).to(DEVICE), counts)
                with tk.counting_paths(DEVICE) as paths:
                    got = tw.fold_staged(fields, st)
                ref = tw.fold_staged(cpu, stage_of(
                    tw, form, torch.from_numpy(v), torch.from_numpy(wd),
                    counts))
                for i, (a, r) in enumerate(zip(got, ref)):
                    _equal(a.cpu(), r, f"rank case {kind} B {b} {form} "
                                       f"field {i}")
                want = np.bincount(row_paths(f_np[0], f_np[1], v, wd),
                                   minlength=len(tk.PATHS))
                tally = paths.cpu().numpy()
                if tally.tolist() != want.tolist():
                    raise AssertionError(f"rank case {kind} B {b} {form}: "
                                         f"paths {tally} not {want}")
                total += tally
    out = dict(zip(tk.PATHS, (int(x) for x in total)))
    log(f"[tdigest] K3's rank-path cases ({len(RANK_KINDS)} kinds x "
        f"depths {RANK_DEPTHS}, 3 forms): bitwise equal to the CPU, rows "
        f"by path {out}")
    return {"bitwise": True, "paths": out}


def fold_paths(tw, tk, s: int = FOLD_TIMED[0], b: int = FOLD_TIMED[1]
               ) -> dict:
    """The rows of one K3 fold at [s, C, b] (``fold_inputs``, no edge
    rows) by path, each form: td_fold_warps' tally."""
    fields, v, w, counts = fold_inputs(s, b, 17, DEVICE, edges=False)
    out = {}
    for form in FOLD_FORMS:
        with tk.counting_paths(DEVICE) as paths:
            tw.fold_staged(fields, stage_of(tw, form, v, w, counts))
        out[form] = dict(zip(tk.PATHS, paths.cpu().tolist()))
    log(f"[tdigest] K3 at [{s:,}, C {C}, B {b}]: rows by path {out}")
    return out


def fold_bound(s: int, b: int, form: str, samples: int) -> float:
    """Bytes over 3.35 TB/s: the pool's rows and 12 scalars read and
    written, the staged plane read once (dense: [S, B] values and
    weights; flat: the samples, their weights unless unit, the offsets)."""
    staged = (s * b * 8 if form == "dense"
              else samples * (4 if form == "flat_unit" else 8) + s * 4)
    return (2 * (s * C * 8 + 12 * s * 4) + staged) / HBM_BYTES_PER_S * 1e3


def staged_fold_fn(wmod, fields, form: str, v, w, counts):
    """One staged fold over ``form`` as the checkout of ``wmod`` runs it
    on the card: its ``fold_staged`` where it has one (K3, the offsets'
    upload included), else its chain: the counts' upload,
    ``_expand_flat_planes`` for a flat plane, ``_histo_fold_staged``."""
    import torch

    if hasattr(wmod, "fold_staged"):
        stage = stage_of(wmod, form, v, w, counts)
        return lambda: wmod.fold_staged(fields, stage)
    if form == "dense":
        return lambda: wmod._histo_fold_staged(*fields, v, w)
    unit = form == "flat_unit"
    fv, fw = flat_plane(v, w, counts, unit)

    def chain():
        cj = torch.from_numpy(counts).to(v.device)
        sv, sw = wmod._expand_flat_planes(fv, fv if unit else fw, cj,
                                          v.shape[1], unit)
        return wmod._histo_fold_staged(*fields, sv, sw)

    return chain


def time_fold_staged(tw, reps: int = REPS) -> list:
    """K3's medians at FOLD_TIMED in each form, its plain chain's, the
    bound (bytes)."""
    spin = 2_000_000
    s, b = FOLD_TIMED
    fields, v, w, counts = fold_inputs(s, b, 17, DEVICE, edges=False)
    samples = int(counts.sum())
    out = []
    for form in FOLD_FORMS:
        stage = stage_of(tw, form, v, w, counts)
        saved = tw.fold_staged.launches
        ms = pe.cuda_ms(lambda: tw.fold_staged(fields, stage), reps, spin)
        tw.fold_staged.launches = saved  # timing launches are not the path's
        plain = pe.cuda_ms(lambda: tw._fold_staged_plain(fields, stage),
                           max(5, reps // 4), spin)
        bnd = fold_bound(s, b, form, samples)
        out.append({"rows": s, "depth": b, "form": form, "samples": samples,
                    "ms": ms, "plain_ms": plain, "bound_ms": bnd,
                    "bound_by": "bytes", "share": bnd / ms})
        log(f"[tdigest] K3 [{s:,}, C {C}, B {b}] {form}: {ms:.4f} ms "
            f"(bound {bnd:.4f} ms, {100 * bnd / ms:.1f}%), plain chain "
            f"{plain:.4f} ms")
    # K2a alone over the candidates K3 builds in shared memory: what the
    # load and the row stats add to its row routine
    import torch

    from veneur_tpu_torch.ops import exactnum as exn
    from veneur_tpu_torch.ops import tdigest_kernel as tk

    cm = torch.cat([fields[0], v], dim=1).contiguous()
    cw = torch.cat([fields[1], w], dim=1).contiguous()
    table = exn._table(COMPRESSION, torch.device(DEVICE))
    out[0]["k2a_same_rows_ms"] = pe.cuda_ms(
        lambda: tk.compress(cm, cw, C, table), reps, spin)
    log(f"[tdigest] K2a alone over the same [{s:,}, {C + b}] candidates: "
        f"{out[0]['k2a_same_rows_ms']:.4f} ms")
    return out


def profile_fold(wmod, form: str = "flat_unit", s: int = FOLD_TIMED[0],
                 b: int = FOLD_TIMED[1]) -> dict:
    """The kernels one staged fold of ``wmod``'s checkout launches at
    [s, C, b] (``staged_fold_fn``), from a torch.profiler trace: their
    names, counts and device microseconds, and those not of tdigest.cu."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fields, v, w, counts = fold_inputs(s, b, 19, DEVICE, edges=False)
    fn = staged_fold_fn(wmod, fields, form, v, w, counts)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names, us = {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.name.startswith(("Memcpy", "Memset")):
            continue
        m = re.search(r"(td_\w+)", ev.name)
        short = m.group(1) if m else ev.name[:60]
        names[short] = names.get(short, 0) + 1
        t = getattr(ev, "device_time", None)
        us[short] = us.get(short, 0.0) + float(
            t if t is not None else ev.cuda_time)
    foreign = sorted(nm for nm in names if not nm.startswith("td_"))
    out = {"rows": s, "depth": b, "form": form,
           "kernels": sum(names.values()), "names": names, "device_us": us,
           "foreign": foreign}
    log(f"[tdigest] a staged fold ({form}) at [{s:,}, C {C}, B {b}]: "
        f"{out['kernels']} kernel launches in a trace, {len(foreign)} "
        f"kinds not of tdigest.cu; device us: " + ", ".join(
            f"{nm} {x:.1f}" for nm, x in sorted(us.items(),
                                                key=lambda kv: -kv[1])[:8]))
    return out


def compress_bound(s: int, m: int) -> float:
    return (s * m * 8 + s * C * 8) / HBM_BYTES_PER_S * 1e3


def add_bound(k: int, n: int) -> float:
    return (2 * k * C * 8 + k * 3 * 4 + n * 12 + k * 8 * 4) \
        / HBM_BYTES_PER_S * 1e3


def time_kernels(td, tk, reps: int = REPS) -> dict:
    """Medians of kernel and plain at the main path's shapes, the bounds,
    and beside K2b its batch sort and the whole dispatcher."""
    import torch

    from veneur_tpu_torch.ops import exactnum as exn

    spin = 2_000_000
    out = {"compress": [], "add_batch": []}
    table = exn._table(COMPRESSION, torch.device(DEVICE))
    for s, m in COMPRESS_TIMED:
        means, w = candidates(s, m, 7 + s + m, DEVICE)
        ms = pe.cuda_ms(lambda: tk.compress(means, w, C, table), reps, spin)
        plain = pe.cuda_ms(lambda: td._compress_rows_plain(
            means, w, COMPRESSION, C), max(5, reps // 4), spin)
        dm, dw = digest_candidates(s, m, 3 + s + m, DEVICE)
        ms_d = pe.cuda_ms(lambda: tk.compress(dm, dw, C, table), reps, spin)
        b = compress_bound(s, m)
        out["compress"].append({"rows": s, "m": m, "ms": ms,
                                "ms_digest_rows": ms_d,
                                "plain_ms": plain, "bound_ms": b,
                                "bound_by": "bytes", "share": b / ms})
        log(f"[tdigest] K2a [{s:,}, {m:,}]: {ms:.4f} ms (bound {b:.4f} ms, "
            f"{100 * b / ms:.1f}%), on digest rows {ms_d:.4f} ms, plain "
            f"{plain:.4f} ms")
        del means, w, dm, dw
    for k, n in ADD_CASES:
        rows, vals, wts = sample_batch(k, n, 11 + k + n, DEVICE)
        pool = empty_pool(k, DEVICE)
        pool = tuple(td.add_batch(*pool, rows, vals, wts)[:5])
        ms = pe.cuda_ms(lambda: tk.add_batch(*pool, rows, vals, wts, table),
                        reps, spin)
        sort_ms = pe.cuda_ms(lambda: td._sort_batch(rows, vals, wts, k),
                             reps, spin)
        whole = pe.cuda_ms(lambda: td.add_batch(*pool, rows, vals, wts),
                           reps, spin)
        plain = pe.cuda_ms(lambda: td.add_batch_plain(*pool, rows, vals,
                                                      wts),
                           max(5, reps // 4), spin)
        b = add_bound(k, n)
        launches = tk.chain_launches(n)
        out["add_batch"].append({"rows": k, "samples": n, "ms": ms,
                                 "sort_ms": sort_ms, "with_sort_ms": whole,
                                 "plain_ms": plain, "bound_ms": b,
                                 "bound_by": "bytes", "share": b / ms,
                                 "launches": launches})
        log(f"[tdigest] K2b (K {k:,}, N {n:,}): the chain {ms:.4f} ms, "
            f"{launches} launches (bound {b:.4f} ms, {100 * b / ms:.1f}%), "
            f"the dispatcher {whole:.4f} ms, the plain sort alone "
            f"{sort_ms:.4f} ms, plain {plain:.4f} ms")
    return out


def build_log(tk) -> dict:
    rep = tk.build_report()
    for name, r in sorted(rep.items()):
        log(f"[tdigest] ptxas {name}: " + ", ".join(
            f"{k} {v}" for k, v in r.items()))
    return rep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--quick", action="store_true",
                    help="one shape of each kernel and the edges, no times")
    ap.add_argument("--fold", action="store_true",
                    help="K3 alone: one check, its trace and its times")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: the probe needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from veneur_tpu_torch.core import worker as tw
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.ops import tdigest_kernel as tk

    card = pe.card_line()
    log(f"[tdigest] card: {card}")
    tk.load()
    res = {"card": card, "build": build_log(tk)}
    if args.fold:
        res["fold_staged"] = check_fold_staged(tw, [(4_099, 64)])
        res["rank_cases"] = check_rank_cases(tw, tk)
        res["fold_paths"] = fold_paths(tw, tk)
        res["fold_trace"] = profile_fold(tw)
        res["times"] = {"fold_staged": time_fold_staged(tw)}
    elif args.quick:
        res["compress"] = check_compress(td, [(4_099, 192), (1_024, 1_152)])
        res["add_batch"] = check_add(td, [(64, 256)])
        res["signed_zeros"] = check_signed_zeros(td)
        res["fold_staged"] = check_fold_staged(tw, [(4_099, 64)])
    else:
        res["compress"] = check_compress(td)
        res["add_batch"] = check_add(td)
        res["signed_zeros"] = check_signed_zeros(td)
        res["chain"] = profile_chain(td)
        res["times"] = time_kernels(td, tk)
        res["fold_staged"] = check_fold_staged(tw)
        res["fold_trace"] = profile_fold(tw)
        res["times"]["fold_staged"] = time_fold_staged(tw)
    res["launches"] = {"compress_rows": td.compress_rows.launches,
                       "add_batch": td.add_batch.launches,
                       "fold_staged": tw.fold_staged.launches}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
