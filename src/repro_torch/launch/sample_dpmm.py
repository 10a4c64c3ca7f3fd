"""DPMM sampling CLI of the PyTorch port (paper §3.4 entry point).

    PYTHONPATH=src python -m repro_torch.launch.sample_dpmm \
        --n 100000 --d 2 --k 10 --alpha 10 --iters 100 \
        [--data-path x.npy] [--tile-size 65536] [--result-path out.json] \
        [--device cuda] [--checkpoint-path model.npz] [--params-path p.json] \
        [--n-chains 4] [--checkpoint-every 10] [--resume]

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
nmi, iter_times_s, device_bytes, config, dist, recoveries.
``--checkpoint-path`` writes the fitted model with
``core/checkpoint.save_model`` (the reference's format v2), which
``repro_torch.launch.serve_dpmm`` (or the JAX package's) serves; with
``--checkpoint-every`` it is instead the prefix of the fit's
auto-checkpoint rotation, and ``--resume`` continues a killed fit from its
newest member that verifies (``--iters`` is the total target).
``--n-chains C`` runs C chains, prints their scores and split-R-hats and
keeps the best chain (result and checkpoint). ``--params-path`` is a JSON
file of config overrides, the reference CLI's keys (alpha, iters, k_max —
``"auto"`` included —, burnout, log_every, tile_size). ``--workers`` is
not ported (ROADMAP.md §1 item 6).
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
    ap.add_argument("--params-path", "--params_path", default="",
                    help="JSON config overrides: alpha, iters, k_max "
                         "(an int or \"auto\"), burnout, log_every, "
                         "tile_size")
    ap.add_argument("--n-chains", "--n_chains", type=int, default=1,
                    help="chains sharing one device copy of x; the result "
                         "(and checkpoint) is the best-scoring chain, with "
                         "split-R-hat printed")
    ap.add_argument("--checkpoint-path", "--checkpoint_path", default="",
                    help="write the fitted ModelState npz here; with "
                         "--checkpoint-every the auto-checkpoint rotation "
                         "prefix instead")
    ap.add_argument("--checkpoint-every", "--checkpoint_every", type=int,
                    default=None,
                    help="auto-checkpoint every this many iterations to "
                         "the --checkpoint-path rotation")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed fit from the newest verifying "
                         "member of the --checkpoint-path rotation; "
                         "--iters is the total target, and no member yet "
                         "means a fresh fit")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    overrides = {}
    if args.params_path:
        with open(args.params_path) as f:
            overrides = json.load(f)
    if overrides.get("workers"):
        raise SystemExit("workers (multi-process fits) is not ported")
    cfg = DPMMConfig(
        component=_component_of(args.prior_type),
        alpha=overrides.get("alpha", args.alpha),
        iters=overrides.get("iters", args.iters),
        k_max=overrides.get("k_max", 64),
        burnout=overrides.get("burnout", 15),
        log_every=overrides.get("log_every", 10),
        tile_size=(args.tile_size if args.tile_size is not None
                   else overrides.get("tile_size")),
        checkpoint_path=args.checkpoint_path or None,
        checkpoint_every=args.checkpoint_every, seed=args.seed)
    if (args.resume or args.checkpoint_every) and not args.checkpoint_path:
        raise SystemExit("--resume/--checkpoint-every need "
                         "--checkpoint-path (the rotation prefix)")
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
    result = DPMM(cfg, device=args.device).fit(
        source, verbose=args.verbose, n_chains=args.n_chains,
        resume=args.resume)
    wall = time.time() - t0
    if result.n_chains > 1:
        try:
            rhats = {k: round(v, 3) for k, v in result.rhats().items()}
        except ValueError:          # too few iterations for split-R-hat
            rhats = "n/a (needs >= 4 iters)"
        print(f"chains: scores={np.round(np.asarray(result.score), 2)} "
              f"rhat={rhats}")
        result = result.select_best()
    nmi = result.nmi(gt) if gt is not None else float("nan")
    steady = (result.iter_times_s[cfg.log_every:] or result.iter_times_s
              or [float("nan")])       # a resume with nothing left to run
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
    if args.checkpoint_path and not args.checkpoint_every:
        path = checkpoint.save_model(args.checkpoint_path, result.state,
                                     cfg.component)
        print(f"wrote checkpoint {path}")
    elif args.checkpoint_every:
        # the fit wrote the final rotation member
        members = checkpoint.list_checkpoints(cfg.checkpoint_path)
        if members:
            print(f"final checkpoint {members[0][1]}")
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
