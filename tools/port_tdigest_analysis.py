#!/usr/bin/env python3
"""Offline t-digest accuracy analysis of the port's digest.

The counterpart of tools/tdigest_analysis.py (the reference's
tdigest/analysis tool) over veneur_tpu_torch.ops.tdigest: each
distribution's samples go into one digest row through ``add_batch``
(K2b on the card, its plain version on the CPU) and the row's quantiles
are held against the exact order statistics of the sample.

Usage:
    python3 tools/port_tdigest_analysis.py [--device cpu] [--samples 100000]
        [--compression 100] [--out-dir analysis_out]
        [--distributions gamma normal ...]

Runs on the card unless --device names another device (without CUDA it
raises). Writes one CSV per distribution: q, estimated, actual, abs_err,
q_err (q_err = |CDF(estimated) - q|, the error in quantile space, the
bound a t-digest promises), and a summary line per distribution. Exits 0
when the worst q-error over the distributions is under 0.01.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DISTRIBUTIONS = {
    "uniform": lambda rng, n: rng.random(n),
    "normal": lambda rng, n: rng.normal(50, 15, n),
    "exponential": lambda rng, n: rng.exponential(100, n),
    "lognormal": lambda rng, n: rng.lognormal(3, 1, n),
    "gamma": lambda rng, n: rng.gamma(2.0, 50.0, n),
    "bimodal": lambda rng, n: np.concatenate(
        [rng.normal(10, 2, n // 2), rng.normal(100, 10, n - n // 2)]),
    "heavy_tail": lambda rng, n: rng.pareto(1.5, n) + 1.0,
}

QS = np.array([0.001, 0.01, 0.05, 0.1, 0.25, 0.5, 0.75,
               0.9, 0.95, 0.99, 0.999], np.float64)

#: the worst q-error the run accepts: 1% at δ = 100
MAX_Q_ERR = 0.01


def analyze(name: str, draw, n: int, compression: float, out_dir: str,
            seed: int = 42, device=None) -> dict:
    """One distribution through a one-row digest on ``device`` (none
    asked for: the card). Its CSV path, q-errors, centroid count, the
    estimates (f32, in QS order) and the seconds the digest took."""
    import torch

    from veneur_tpu_torch.device import resolve
    from veneur_tpu_torch.ops import tdigest as td

    dev = resolve(device)
    rng = np.random.default_rng(seed)
    samples = draw(rng, n).astype(np.float32)

    t0 = time.perf_counter()
    pool = td.init_pool(1, td.capacity_for(compression), device=dev)
    means, weights, dmin, dmax, _, _ = td.add_batch(
        *pool, torch.zeros(n, dtype=torch.int32, device=dev),
        torch.from_numpy(samples).to(dev),
        torch.ones(n, dtype=torch.float32, device=dev),
        compression=compression)
    est = td.quantile(means, weights, dmin, dmax, torch.from_numpy(
        QS.astype(np.float32)).to(dev)).cpu().numpy()[0]
    seconds = time.perf_counter() - t0

    actual = np.quantile(samples.astype(np.float64), QS)
    # the estimate's rank within the true sample: the error in q space
    est_rank = np.searchsorted(np.sort(samples), est) / n
    q_err = np.abs(est_rank - QS)
    abs_err = np.abs(est - actual)

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["q", "estimated", "actual", "abs_err", "q_err"])
        for i, q in enumerate(QS):
            w.writerow([q, est[i], actual[i], abs_err[i], q_err[i]])

    return {
        "name": name,
        "max_q_err": float(q_err.max()),
        "mean_q_err": float(q_err.mean()),
        "centroids": int((weights[0] > 0).sum()),
        "csv": path,
        "estimated": est,
        "seconds": seconds,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    p.add_argument("--samples", type=int, default=100_000)
    p.add_argument("--compression", type=float, default=100.0)
    p.add_argument("--out-dir", default="analysis_out")
    p.add_argument("--distributions", nargs="*",
                   default=sorted(DISTRIBUTIONS))
    args = p.parse_args(argv)

    worst = 0.0
    for name in args.distributions:
        r = analyze(name, DISTRIBUTIONS[name], args.samples,
                    args.compression, args.out_dir, device=args.device)
        worst = max(worst, r["max_q_err"])
        print(f"{r['name']:>12}: max q-err {r['max_q_err']:.5f}  "
              f"mean {r['mean_q_err']:.5f}  centroids {r['centroids']}  "
              f"-> {r['csv']}")
    print(f"worst-case q-err across distributions: {worst:.5f}")
    return 0 if worst < MAX_Q_ERR else 1


if __name__ == "__main__":
    sys.exit(main())
