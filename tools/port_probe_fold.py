#!/usr/bin/env python3
"""The t-digest fold steps on one NVIDIA card, this checkout against another.

    python3 tools/port_probe_fold.py --against DIR [--json PATH]

Times the worker's fold steps of this checkout and of the checkout at DIR
(say the parent commit, unpacked with ``git archive``; each imports its
own package, sources and kernel builds) in turns, other, this, this,
other, at the shapes chip_smoke.py's phases give them:

* staged fold: a 131,072-row pool of C = 128 and a [131,072, 64] staged
  plane (phase 4's fold at the swap), each checkout's staged fold as it
  runs on the card (port_probe_tdigest.staged_fold_fn: ``fold_staged``,
  K3, where the checkout has it, else ``_expand_flat_planes`` and
  ``_histo_fold_staged``), the plane dense (the mirror's) and flat (a
  compacted native or reader-shard plane: its upload of the counts or
  offsets included), unit and weighted;
* spill fold: _histo_ingest_rows (the update, before its writes) at
  (K, N) = (1,024, 16,384), phase 4's hot-series batches, and (64, 256);
* import merge: _histo_import_rows, 65,536 rows each merging W = 1,024
  imported centroids into a 65,537-row pool (phase 10's merge at the
  swap, its device part; the host packing is not in it);
* mesh merge: ops/tdigest._compress_rows over [2,048, 256] (phase 16b's
  compress a series shard).

* the kernels alone at every shape port_probe_tdigest times (chip_smoke
  phase 3c): K2a (``compress_rows``) at [131,072, 192], [65,536, 256],
  [32,768, 256] and [8,192, 1,152], on random rows behind a sorted
  digest row (``candidates``) and on digest rows as the main path builds
  them (``digest_candidates``), and K2b as each checkout's
  ``add_batch`` from the unsorted batch (its sort included: torch.sort
  before the kernels in a checkout that sorts so, inside them in one
  that does not) at (64, 256), (1,024, 65,536) and (16,384, 262,144);
  and the kernels one ``add_batch`` of each checkout launches at (1,024,
  65,536), from a torch.profiler trace (port_probe_tdigest.profile_chain).

Each time is the median of REPS calls behind a device spin
(port_probe_extract.cuda_ms); every output of the two checkouts is
bitwise equal (the inputs hold no signed zero, NaN or denormal). Then
phase 4's interval (chip_smoke.py's plan and worker configuration) once
a checkout in turns, its ``fold_s`` split into the staged fold (the
folds of the staged planes and of the mirror), the mirror's residual
feed at the swap (its chunks' uploads and scatters, and ``finish``), the
deferred spill folds and the rest, each step synchronised before and
after (so their sum runs a little past an unsplit fold_s). Then
the edge rows of port_probe_tdigest (16 kinds, 4,096 rows) through each
checkout's compress: the rows where the other checkout's card result
differs from this one's, which is bitwise its plain version and the
CPU's, are counted by kind (reported, not asserted); and the digest
min and max of the staged fold over rows that mix +0.0 and -0.0: the
rows where the checkouts differ, by field (reported, not asserted: a
checkout that keeps whichever zero its op picks differs from one in
XLA's order). Inputs are made on the card from a seed. Imports torch
and the port only; exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import port_probe_extract as pe  # noqa: E402
import port_probe_tdigest as ptd  # noqa: E402

REPS = 21
C = 128
STAGED_ROWS = 131_072
SPILL_CASES = ((1_024, 16_384), (64, 256))
IMPORT_ROWS, IMPORT_WIDTH = 65_536, 1_024
MESH_ROWS = 2_048


def log(msg: str) -> None:
    print(msg, flush=True)


def pool(s: int, seed: int, td, device, plain: bool = False):
    """The worker's 14 pool fields over s rows: compressed digest rows
    (``plain``: the candidates' first C slots), their scalars, the
    sampler-local scalars."""
    import torch

    means, w = ptd.candidates(s, 2 * C, seed, device, edges=False)
    if plain:
        means, w = means[:, :C].contiguous(), w[:, :C].contiguous()
    else:
        means, w = td.compress_rows(means, w, 100.0, C)
    z = torch.zeros((s,), dtype=torch.float32, device=device)
    inf = torch.full((s,), float("inf"), device=device)
    return [means, w, -inf + 0, inf.clone(), z.clone(), z.clone(),
            -inf + 0, inf.clone(), z.clone(), z.clone(), z.clone(),
            z.clone(), z.clone(), z.clone()]


def cases(td, device) -> dict:
    """name -> (function name in core/worker or ops/tdigest, args)."""
    import torch

    out = {}
    for k, n in SPILL_CASES:
        f = pool(k + 1, 3 + k, td, device)
        rows, vals, wts = ptd.sample_batch(k, n, 4 + k, device)
        active = torch.arange(k, dtype=torch.int64, device=device)
        out[f"spill_fold_{k}x{n}"] = ("_histo_ingest_rows",
                                      (*f, active, rows, vals, wts))
    k, w = IMPORT_ROWS, IMPORT_WIDTH
    f = pool(k + 1, 5, td, device)
    imp_m, imp_w = ptd.candidates(k, w, 6, device, edges=False)
    rows = torch.arange(k, dtype=torch.int64, device=device)
    z = torch.zeros((k,), dtype=torch.float32, device=device)
    out[f"import_merge_{k}x{w}"] = (
        "_histo_import_rows", (*f[:6], rows, imp_m, imp_w, z - 1, z + 1e3,
                               z + 0.5))
    m, wt = ptd.candidates(MESH_ROWS, 2 * C, 7, device, edges=False)
    out[f"mesh_merge_{MESH_ROWS}x{2 * C}"] = ("_compress_rows",
                                              (m, wt, 100.0, C))
    return out


def kernel_cases(device) -> dict:
    """name -> (dispatcher in ops/tdigest, args) at the probe's shapes."""
    out = {}
    for s, m in ptd.COMPRESS_TIMED:
        means, w = ptd.candidates(s, m, 7 + s + m, device)
        out[f"k2a_{s}x{m}"] = ("compress_rows", (means, w, 100.0, C))
        means, w = ptd.digest_candidates(s, m, 3 + s + m, device)
        out[f"k2a_{s}x{m}_digest_rows"] = ("compress_rows",
                                           (means, w, 100.0, C))
    for k, n in ptd.ADD_CASES:
        rows, vals, wts = ptd.sample_batch(k, n, 11 + k + n, device)
        out[f"k2b_{k}x{n}"] = ("add_batch",
                               (*ptd.empty_pool(k, device), rows, vals, wts))
    return out


def staged_cases(worker, ow, td, device) -> dict:
    """name -> (this checkout's staged fold, the other's), over one pool
    and one [STAGED_ROWS, 64] plane in each form."""
    fields = pool(STAGED_ROWS, 1, td, device)
    _f, v, w, counts = ptd.fold_inputs(STAGED_ROWS, 64, 2, device,
                                       edges=False)
    return {f"staged_fold_{STAGED_ROWS}x64_{form}": (
        ptd.staged_fold_fn(worker, fields, form, v, w, counts),
        ptd.staged_fold_fn(ow, fields, form, v, w, counts))
        for form in ptd.FOLD_FORMS}


def fold_split(wmod, mfmod, parse, reps: int = 1, device="cuda") -> dict:
    """Phase 4's interval on a worker of ``wmod``'s checkout (chip_smoke's
    plan and INTERVAL_KW; micro-folds on and none run before the swap, so
    the whole plane streams into the mirror as its residual feed): the
    extraction's ``fold_s`` split by step (module docstring), medians of
    ``reps`` intervals."""
    import torch

    import chip_smoke as cs
    from veneur_tpu_torch.core.flusher import device_quantiles
    from veneur_tpu_torch.core.metrics import HistogramAggregates

    qs = device_quantiles(cs.QS, HistogramAggregates.from_names(
        ["min", "max", "count"]))
    plan = cs.interval_plan(seed=5)
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    acc = {"staged_fold_s": 0.0, "residual_feed_s": 0.0, "spill_s": 0.0}
    state = {"in_extract": False}

    def timed(cls, name, key, always=True):
        real = getattr(cls, name)

        def wrap(*args, **kwargs):
            if not (always or state["in_extract"]):
                return real(*args, **kwargs)
            sync()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            sync()
            acc[key] += time.perf_counter() - t0
            return out

        setattr(cls, name, wrap)
        return real

    w_cls, m_cls = wmod.DeviceWorker, mfmod.MicroFoldMirror
    real_extract = w_cls.extract_snapshot

    def extract(self, *args, **kwargs):
        state["in_extract"] = True
        try:
            return real_extract(self, *args, **kwargs)
        finally:
            state["in_extract"] = False

    saved = [(w_cls, "extract_snapshot", real_extract)]
    w_cls.extract_snapshot = extract
    for cls, name, key, always in (
            (w_cls, "_fold_mirror", "staged_fold_s", True),
            (w_cls, "_fold_one_plane", "staged_fold_s", True),
            (w_cls, "_fold_spill_chunk", "spill_s", False),
            (m_cls, "feed", "residual_feed_s", False),
            (m_cls, "finish", "residual_feed_s", False)):
        saved.append((cls, name, timed(cls, name, key, always)))
    runs = []
    try:
        for _ in range(reps):
            for k in acc:
                acc[k] = 0.0
            wk = wmod.DeviceWorker(**cs.INTERVAL_KW, device=device)
            _snap, t = cs.run_interval(wk, plan, parse, qs)
            del wk, _snap
            split = {"fold_s": t["fold_s"], **acc}
            split["rest_s"] = split["fold_s"] - sum(acc.values())
            runs.append(split)
    finally:
        for cls, name, real in saved:
            setattr(cls, name, real)
    out = {k: sorted(r[k] for r in runs)[len(runs) // 2] for k in runs[0]}
    log("[fold] phase 4's fold_s split: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()))
    return out


def signed_zero_report(worker, ow, device) -> dict:
    """Rows of the staged fold's dmin, dmax, lmin and lmax where the other
    checkout differs from this one, over 4,096 rows whose scalars and
    staged values are +0.0 and -0.0 (port_probe_tdigest.mixed, no NaN)."""
    import torch

    g = ptd._gen(13, device)
    s = 4_096
    fields = pool(s, 12, None, device, plain=True)
    fields[2], fields[3], fields[6], fields[7] = ptd.mixed(
        g, (4, s), device, nan=False)
    svals = ptd.mixed(g, (s, 64), device, nan=False)
    swts = torch.ones((s, 64), device=device)
    this = worker._histo_fold_staged(*[t.clone() for t in fields], svals,
                                     swts)
    other = ow._histo_fold_staged(*[t.clone() for t in fields], svals,
                                  swts)
    out = {}
    for i, name in ((2, "dmin"), (3, "dmax"), (6, "lmin"), (7, "lmax")):
        out[name] = int((this[i].view(torch.int32)
                         != other[i].view(torch.int32)).sum())
    log(f"[fold] signed zeros (rows of {s:,} where the other checkout's "
        f"staged fold differs from this one's; expected where it keeps "
        f"the zero its op picks): {out}")
    return out


def _call(worker, td, name, args):
    fn = getattr(td if name == "_compress_rows" else worker, name)
    return fn(*args)


def _flat(out) -> list:
    if hasattr(out, "data_ptr"):
        return [out]
    return [t for x in out for t in _flat(x)]


def edge_report(td, otd, device) -> dict:
    """Per edge-row kind (port_probe_tdigest.edge_rows, row i % 16), the
    rows of a [4,096, 192] compress where the other checkout's result
    differs from this one's."""
    import torch

    em, ew = ptd.edge_rows(2 * C, device)
    means = em.repeat(256, 1).contiguous()
    w = ew.repeat(256, 1).contiguous()
    this = td.compress_rows(means, w, 100.0, C)
    other = otd._compress_rows(means, w, 100.0, C)
    bad = torch.zeros(means.shape[0], dtype=torch.bool, device=device)
    for a, b in zip(this, other):
        same = (a.view(torch.int32) == b.view(torch.int32)) | (
            torch.isnan(a) & torch.isnan(b))
        bad |= ~same.all(dim=1)
    kind = torch.arange(means.shape[0], device=device) % 16
    out = {k: int((bad & (kind == k)).sum()) for k in range(16)}
    log(f"[fold] edge rows (kind: rows of 256 differing, other checkout "
        f"against this): {out}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", type=Path, required=True,
                    help="the other checkout (say the parent commit)")
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: the probe needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from veneur_tpu_torch.core import worker
    from veneur_tpu_torch.ops import microfold as mf
    from veneur_tpu_torch.ops import tdigest as td
    from veneur_tpu_torch.protocol.dogstatsd import parse_metric

    dev = torch.device("cuda")
    ow, otd, omf, odsd = pe.load_other(
        args.against.resolve(), "core.worker", "ops.tdigest",
        "ops.microfold", "protocol.dogstatsd")
    oparse = odsd.parse_metric
    card = pe.card_line()
    log(f"[fold] card: {card}")
    res = {"card": card, "reps": REPS, "cases": {}}
    spin = 2_000_000
    for name, (fn, fargs) in cases(td, dev).items():
        got = {"this": _flat(_call(worker, td, fn, fargs)),
               "other": _flat(_call(ow, otd, fn, fargs))}
        for a, b in zip(got["this"], got["other"]):
            if a.dtype == torch.float32:
                ok, _ = pe.bitwise_equal(a, b)
            else:
                ok = torch.equal(a, b)
            if not ok:
                raise AssertionError(f"{name}: the checkouts differ")
        runs = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            mods = (ow, otd) if who == "other" else (worker, td)
            runs[who].append(pe.cuda_ms(
                lambda: _call(*mods, fn, fargs), REPS, spin))
        res["cases"][name] = runs
        log(f"[fold] {name}: other {runs['other'][0]:.4f} "
            f"{runs['other'][1]:.4f} ms, this {runs['this'][0]:.4f} "
            f"{runs['this'][1]:.4f} ms (medians of {REPS}; outputs bitwise "
            f"equal)")
    for name, (this_fn, other_fn) in staged_cases(worker, ow, td,
                                                  dev).items():
        for a, b in zip(_flat(this_fn()), _flat(other_fn())):
            if not pe.bitwise_equal(a, b)[0]:
                raise AssertionError(f"{name}: the checkouts differ")
        runs = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            fn = other_fn if who == "other" else this_fn
            saved = worker.fold_staged.launches
            runs[who].append(pe.cuda_ms(fn, REPS, spin))
            worker.fold_staged.launches = saved
        res["cases"][name] = runs
        log(f"[fold] {name}: other {runs['other'][0]:.4f} "
            f"{runs['other'][1]:.4f} ms, this {runs['this'][0]:.4f} "
            f"{runs['this'][1]:.4f} ms (medians of {REPS}; outputs bitwise "
            f"equal)")
    for name, (fn, fargs) in kernel_cases(dev).items():
        got = {"this": _flat(getattr(td, fn)(*fargs)),
               "other": _flat(getattr(otd, fn)(*fargs))}
        for a, b in zip(got["this"], got["other"]):
            if not pe.bitwise_equal(a, b)[0]:
                raise AssertionError(f"{name}: the checkouts differ")
        runs = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            mod = otd if who == "other" else td
            runs[who].append(pe.cuda_ms(
                lambda: getattr(mod, fn)(*fargs), REPS, spin))
        res["cases"][name] = runs
        log(f"[fold] {name}: other {runs['other'][0]:.4f} "
            f"{runs['other'][1]:.4f} ms, this {runs['this'][0]:.4f} "
            f"{runs['this'][1]:.4f} ms (medians of {REPS}; outputs bitwise "
            f"equal)")
    res["chain"] = {"this": ptd.profile_chain(td), "other":
                    ptd.profile_chain(otd)}
    res["staged_trace"] = {
        form: {"this": ptd.profile_fold(worker, form),
               "other": ptd.profile_fold(ow, form)}
        for form in ("dense", "flat_unit")}
    log("[fold] a staged fold at [131,072, 64], kernels in a trace: " +
        ", ".join(f"{form} this {t['this']['kernels']}, other "
                  f"{t['other']['kernels']}"
                  for form, t in res["staged_trace"].items()))
    split = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        wmod, mfmod, parse = ((ow, omf, oparse) if who == "other"
                              else (worker, mf, parse_metric))
        split[who].append(fold_split(wmod, mfmod, parse))
    res["fold_split"] = split
    log(f"[fold] K2b at (1,024, 65,536), kernels in a trace: this "
        f"{res['chain']['this']['kernels']}, other "
        f"{res['chain']['other']['kernels']}")
    res["edge_rows_differing"] = edge_report(td, otd, dev)
    res["signed_zero_rows_differing"] = signed_zero_report(worker, ow, dev)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
