#!/usr/bin/env python3
"""The t-digest fold steps on one NVIDIA card, this checkout against another.

    python3 tools/port_probe_fold.py --against DIR [--json PATH]

Times the worker's fold steps of this checkout and of the checkout at DIR
(say the parent commit, unpacked with ``git archive``; each imports its
own package, sources and kernel builds) in turns, other, this, this,
other, at the shapes chip_smoke.py's phases give them:

* staged fold: core/worker._histo_fold_staged over a 131,072-row pool of
  C = 128 and a [131,072, 64] staged plane (phase 4's fold at the swap);
* spill fold: _histo_ingest_rows (the update, before its writes) at
  (K, N) = (1,024, 16,384), phase 4's hot-series batches, and (64, 256);
* import merge: _histo_import_rows, 65,536 rows each merging W = 1,024
  imported centroids into a 65,537-row pool (phase 10's merge at the
  swap, its device part; the host packing is not in it);
* mesh merge: ops/tdigest._compress_rows over [2,048, 256] (phase 16b's
  compress a series shard).

Each time is the median of REPS calls behind a device spin
(port_probe_extract.cuda_ms); every output of the two checkouts is
bitwise equal (the inputs hold no signed zero, NaN or denormal). Then
the edge rows of port_probe_tdigest (16 kinds, 4,096 rows) through each
checkout's compress: the rows where the other checkout's card result
differs from this one's, which is bitwise its plain version and the
CPU's, are counted by kind (reported, not asserted). Inputs are made on
the card from a seed. Imports torch and the port only; exits 2 without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import port_probe_extract as pe  # noqa: E402
import port_probe_tdigest as ptd  # noqa: E402

REPS = 11
C = 128
STAGED_ROWS = 131_072
SPILL_CASES = ((1_024, 16_384), (64, 256))
IMPORT_ROWS, IMPORT_WIDTH = 65_536, 1_024
MESH_ROWS = 2_048


def log(msg: str) -> None:
    print(msg, flush=True)


def pool(s: int, seed: int, td, device):
    """The worker's 14 pool fields over s rows: compressed digest rows,
    their scalars, the sampler-local scalars."""
    import torch

    means, w = ptd.candidates(s, 2 * C, seed, device, edges=False)
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
    s = STAGED_ROWS
    fields = pool(s, 1, td, device)
    g = ptd._gen(2, device)
    svals = torch.randn((s, 64), generator=g, device=device) * 20 + 50
    swts = (torch.rand((s, 64), generator=g, device=device) < 0.6).float()
    out[f"staged_fold_{s}x64"] = ("_histo_fold_staged",
                                  (*fields, svals, swts))
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
    from veneur_tpu_torch.ops import tdigest as td

    dev = torch.device("cuda")
    ow, otd = pe.load_other(args.against.resolve(), "core.worker",
                            "ops.tdigest")
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
    res["edge_rows_differing"] = edge_report(td, otd, dev)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
