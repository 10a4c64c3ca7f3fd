"""Time one checkout's DPMM fits at the smoke run's shapes.

    python3 tools/time_fit.py [--src PATH/TO/src] [--tile-size ROWS]
        [--fits gaussian,multinomial,gaussian_d128,gaussian_d256]

Fits, with the ``repro_torch`` package under ``--src`` (default: this
checkout's ``src``), the smoke run's Gaussian (10^6 x 32) and multinomial
(10^6 x 128) mixtures, or with ``--fits gaussian_d128`` its 2e5 x 128
Gaussian mixture (the one-read sweep's wide layout) or ``gaussian_d256``
its 4e5 x 256 one (through the three-pass sweep), with
``DPMMConfig(k_max=64, iters=40, burnout=10,
log_every=10)``, seed 0, each ``--repeats`` times in one process (the
first also builds the kernels and warms up), on the card. Prints one JSON
line per fit: the steady ms per iteration (the chunks after the first),
K, and the card's name and power limit. ``--tile-size`` fits through the
tiled plane, from a ``HostTiledSource`` over the points in host memory
(a checkout that has it). To compare two versions, run it on both
checkouts on one card, in turns (old, new, new, old).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# name: (component, generator, d, N or None for --n)
FITS = {"gaussian": ("gaussian", "generate_gmm", 32, None),
        "multinomial": ("multinomial", "generate_mnmm", 128, None),
        "gaussian_d128": ("gaussian", "generate_gmm", 128, 200_000),
        "gaussian_d256": ("gaussian", "generate_gmm", 256, 400_000)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--tile-size", type=int, default=None)
    ap.add_argument("--fits", default="gaussian,multinomial",
                    help="comma-separated of " + ", ".join(FITS))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_fit: no CUDA device")
    sys.path.insert(0, opts.src)
    from repro_torch.configs import DPMMConfig
    from repro_torch.core.sampler import DPMM
    from repro_torch.data import synthetic
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    for name in opts.fits.split(","):
        comp, gen, d, n = FITS[name]
        n = n or opts.n
        x, y = getattr(synthetic, gen)(n, d, 16, seed=0)
        cfg = DPMMConfig(component=comp, k_max=64, iters=40, burnout=10,
                         log_every=10, **({} if opts.tile_size is None else
                                          {"tile_size": opts.tile_size}))
        src = x
        if opts.tile_size is not None:
            from repro_torch.data.source import HostTiledSource
            src = HostTiledSource(x)
        for rep in range(opts.repeats):
            res = DPMM(cfg).fit(src)
            print(json.dumps({
                "src": opts.src, "component": comp, "n": n, "d": d,
                "tile_size": opts.tile_size, "repeat": rep, "k": res.k,
                "nmi": res.nmi(y), "steady_ms_per_iter": 1e3 * float(
                    np.mean(res.iter_times_s[cfg.log_every:])),
                "nvidia_smi": smi}), flush=True)


if __name__ == "__main__":
    main()
