"""Whether the NIW model can separate a Gaussian mixture's true clusters.

    PYTHONPATH=src python3 tools/split_evidence.py --n 100000 --d 256 --k 16
    PYTHONPATH=src python3 tools/split_evidence.py --n 100000 --d 256 \
        --k 16 --fit            # also fit it (on the card by default)

For every pair of the clusters of ``generate_gmm(n, d, k, seed=0)``, the
split Hastings ratio ``splitmerge.log_hastings_split`` of the cluster made
of the two, with the two as its sub-clusters, in float64 on the CPU and
with the fits' prior (``DPMMConfig()``). Below 0 the model prefers one
cluster to the two, so no sampler keeps them apart; a full covariance has
d (d + 3) / 2 parameters, which a few thousand points a cluster do not
pay for at d = 256. ``tests/test_torch_split_evidence.py`` holds the
verdicts against the JAX package's ``log_hastings_split`` on the same
stats. ``--fit`` also runs ``DPMM.fit`` with the settings of
``chip_smoke.py``'s fits and reports K and NMI. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import DPMMConfig
from repro_torch.core import niw, splitmerge
from repro_torch.core.family import GAUSSIAN
from repro_torch.core.sampler import DPMM
from repro_torch.data.synthetic import generate_gmm


def pair_evidence(x: np.ndarray, y: np.ndarray, k: int) -> list:
    """(log H_split, a, b) for every pair a < b of true clusters."""
    xt = torch.as_tensor(x, dtype=torch.float64)
    cfg = DPMMConfig()
    prior = GAUSSIAN.build_prior(cfg, xt.mean(0, keepdim=True).float())
    prior = niw.NIWPrior(*(t.double() for t in (
        prior.m, prior.psi, prior.kappa, prior.nu)))
    stats = []
    for j in range(k):
        xs = xt[torch.as_tensor(y == j)]
        stats.append((torch.tensor(float(xs.shape[0]), dtype=torch.float64),
                      xs.sum(0), xs.T @ xs))
    out = []
    for a in range(k):
        for b in range(a + 1, k):
            sub = niw.GaussStats(*(torch.stack([u, v])[None] for u, v in
                                   zip(stats[a], stats[b])))
            full = niw.GaussStats(*((u + v)[None] for u, v in
                                    zip(stats[a], stats[b])))
            log_h = splitmerge.log_hastings_split(prior, GAUSSIAN, full, sub,
                                                  cfg.alpha)
            out.append((float(log_h[0]), a, b))
    return sorted(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--d", type=int, required=True)
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--fit", action="store_true",
                    help="also fit the mixture and report K and NMI")
    ap.add_argument("--device", default=None,
                    help="device of the fit (default: the card)")
    opts = ap.parse_args()
    x, y = generate_gmm(opts.n, opts.d, opts.k, seed=0)
    pairs = pair_evidence(x, y, opts.k)
    report = {"n": opts.n, "d": opts.d, "k": opts.k,
              "points_per_cluster": np.bincount(y, minlength=opts.k).tolist(),
              "pairs": len(pairs),
              "pairs_merged_by_the_model": sum(h < 0 for h, _, _ in pairs),
              "min_log_h_split": pairs[0][0], "max_log_h_split": pairs[-1][0]}
    if opts.fit:
        cfg = DPMMConfig(k_max=64, iters=40, burnout=10, log_every=10)
        res = DPMM(cfg, device=opts.device).fit(x)
        report.update(fit_device=res.device, k_found=res.k, nmi=res.nmi(y),
                      k_history=res.history["k"].tolist())
    print(json.dumps(report))


if __name__ == "__main__":
    main()
