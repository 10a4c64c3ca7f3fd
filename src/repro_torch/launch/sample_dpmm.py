"""DPMM sampling CLI of the PyTorch port (paper §3.4 entry point).

    PYTHONPATH=src python -m repro_torch.launch.sample_dpmm \
        --n 100000 --d 2 --k 10 --alpha 10 --iters 100 \
        [--data-path x.npy] [--tile-size 65536] [--result-path out.json] \
        [--device cuda] [--checkpoint-path model.npz]

Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is given. ``--prior-type`` takes any family of the registry (gaussian,
diag_gaussian, multinomial, poisson) or the reference CLI's aliases
(Gaussian, DiagGaussian, Multinomial, Poisson); without ``--data-path`` the
data comes from the family's generator (``generate_gmm`` for the two
Gaussian families, ``generate_pmm``, ``generate_mnmm``). ``--tile-size``
streams the points in tiles of that many rows (the out-of-core plane:
device memory O(k_max + tile_size)); with ``--data-path`` the .npy is
then memory-mapped and never loaded whole. The result JSON has the keys
of ``repro.launch.sample_dpmm``'s for these flags: labels, weights, k,
nmi, iter_times_s, device_bytes, config, dist, recoveries. ``--checkpoint-path`` writes the fitted model with
``core/checkpoint.save_model`` (the reference's format v2), which
``repro_torch.launch.serve_dpmm`` (or the JAX package's) serves.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from repro_torch.configs import DPMMConfig
from repro_torch.core import checkpoint
from repro_torch.core.family import available_families
from repro_torch.core.sampler import DPMM
from repro_torch.data.source import HostTiledSource, as_source
from repro_torch.data.synthetic import (generate_gmm, generate_mnmm,
                                        generate_pmm)

# reference-CLI aliases on top of the registry's names
_PRIOR_ALIASES = {"gaussian": "gaussian", "multinomial": "multinomial",
                  "poisson": "poisson", "diaggaussian": "diag_gaussian"}
_GENERATORS = {"gaussian": generate_gmm, "diag_gaussian": generate_gmm,
               "poisson": generate_pmm, "multinomial": generate_mnmm}


def _component_of(prior_type: str) -> str:
    name = prior_type.lower()
    name = _PRIOR_ALIASES.get(name, name)
    if name not in available_families():
        raise SystemExit(
            f"unknown --prior-type {prior_type!r}; known: "
            f"{', '.join(available_families())} (or reference-CLI aliases "
            f"{', '.join(sorted(_PRIOR_ALIASES))})")
    return name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=2)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=10.0)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prior-type", "--prior_type", default="Gaussian",
                    help="component family: a registry name or the "
                         "reference CLI's capitalized alias")
    ap.add_argument("--data-path", default="", help=".npy (N, d) input; "
                    "with --tile-size it is memory-mapped, never fully "
                    "loaded (out-of-core)")
    ap.add_argument("--tile-size", "--tile_size", type=int, default=None,
                    help="stream points through tiles of this many rows "
                         "(out-of-core data plane; device memory becomes "
                         "O(k_max + tile_size)). Default: resident")
    ap.add_argument("--result-path", "--result_path", default="")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (kernels, default) or 'cpu' (plain path)")
    ap.add_argument("--checkpoint-path", "--checkpoint_path", default="",
                    help="write the fitted ModelState npz here")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    cfg = DPMMConfig(component=_component_of(args.prior_type),
                     alpha=args.alpha, iters=args.iters,
                     tile_size=args.tile_size, seed=args.seed)
    if args.data_path:
        gt = None
        if cfg.tile_size is not None:
            x = HostTiledSource.from_npy(args.data_path)
        else:
            x = np.load(args.data_path)
    else:
        x, gt = _GENERATORS[cfg.component](args.n, args.d, args.k,
                                           seed=args.seed)
    source = as_source(x)
    print(f"DPMM fit: N={source.n} d={source.d} component="
          f"{cfg.component} alpha={cfg.alpha} iters={cfg.iters} "
          f"device={args.device}")
    t0 = time.time()
    result = DPMM(cfg, device=args.device).fit(source,
                                               verbose=args.verbose)
    wall = time.time() - t0
    nmi = result.nmi(gt) if gt is not None else float("nan")
    steady = result.iter_times_s[cfg.log_every:] or result.iter_times_s
    print(f"done in {wall:.1f}s: K={result.k} NMI={nmi:.4f} "
          f"mean iter {np.mean(steady) * 1e3:.1f} ms")
    if result.recoveries:
        kinds = sorted({e["kind"] for e in result.recoveries})
        print(f"recovered from {len(result.recoveries)} fault event(s) "
              f"({', '.join(kinds)}) — see FitResult.recoveries")
    device_bytes = {"mode": result.mode, "device": result.device,
                    "tile_size": result.tile_size,
                    "est_peak_bytes": result.est_peak_bytes,
                    "peak_bytes_in_use": result.peak_bytes,
                    "peak_bytes_source": ("torch.cuda.max_memory_allocated"
                                          if result.peak_bytes is not None
                                          else None)}
    if args.checkpoint_path:
        path = checkpoint.save_model(args.checkpoint_path, result.state,
                                     cfg.component)
        print(f"wrote checkpoint {path}")
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
            "recoveries": result.recoveries,
        }
        with open(args.result_path, "w") as f:
            json.dump(out, f)
        print(f"wrote {args.result_path}")


if __name__ == "__main__":
    main()
