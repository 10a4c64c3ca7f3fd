"""DPMM sampling CLI of the PyTorch port (paper §3.4 entry point).

    PYTHONPATH=src python -m repro_torch.launch.sample_dpmm \
        --n 100000 --d 2 --k 10 --alpha 10 --iters 100 \
        [--data-path x.npy] [--result-path out.json] [--device cuda]

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. Only the Gaussian family is ported (``--prior-type Gaussian``).
The result JSON has the keys of ``repro.launch.sample_dpmm``'s for these
flags: labels, weights, k, nmi, iter_times_s, device_bytes, config,
dist, recoveries.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.configs import DPMMConfig
from repro_torch.core.sampler import DPMM
from repro_torch.data.synthetic import generate_gmm


def _component_of(prior_type: str) -> str:
    if prior_type.lower() != "gaussian":
        raise SystemExit(
            f"--prior-type {prior_type!r} is not ported to repro_torch yet: "
            "only Gaussian is (ROADMAP.md queues the linear families)")
    return "gaussian"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=2)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prior-type", "--prior_type", default="Gaussian")
    ap.add_argument("--data-path", default="", help=".npy (N, d) input")
    ap.add_argument("--result-path", "--result_path", default="")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (kernels, default) or 'cpu' (plain path)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    cfg = DPMMConfig(component=_component_of(args.prior_type),
                     alpha=args.alpha, iters=args.iters, seed=args.seed)
    if args.data_path:
        x, gt = np.load(args.data_path), None
    else:
        x, gt = generate_gmm(args.n, args.d, args.k, seed=args.seed)
    print(f"DPMM fit: N={x.shape[0]} d={x.shape[1]} component="
          f"{cfg.component} alpha={cfg.alpha} iters={cfg.iters} "
          f"device={args.device}")
    t0 = time.time()
    result = DPMM(cfg, device=args.device).fit(x, verbose=args.verbose)
    wall = time.time() - t0
    nmi = result.nmi(gt) if gt is not None else float("nan")
    steady = result.iter_times_s[cfg.log_every:] or result.iter_times_s
    print(f"done in {wall:.1f}s: K={result.k} NMI={nmi:.4f} "
          f"mean iter {np.mean(steady) * 1e3:.1f} ms")
    device_bytes = {"mode": "resident", "device": result.device,
                    "peak_bytes_in_use": result.peak_bytes,
                    "peak_bytes_source": ("torch.cuda.max_memory_allocated"
                                          if result.peak_bytes is not None
                                          else None)}
    if args.result_path:
        weights = np.exp(result.state.logweights.cpu().numpy())
        active = result.state.active.cpu().numpy()
        out = {
            "labels": result.labels.tolist(),
            "weights": weights[active].tolist(),
            "k": result.k,
            "nmi": nmi,
            "iter_times_s": result.iter_times_s,
            "device_bytes": device_bytes,
            "config": dataclasses.asdict(cfg),
            "dist": None,
            "recoveries": [],
        }
        with open(args.result_path, "w") as f:
            json.dump(out, f)
        print(f"wrote {args.result_path}")


if __name__ == "__main__":
    main()
