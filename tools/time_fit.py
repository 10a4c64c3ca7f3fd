"""Time one checkout's DPMM fits at the smoke run's shapes.

    python3 tools/time_fit.py [--src PATH/TO/src] [--tile-size ROWS]
        [--fits gaussian,multinomial,gaussian_d128,gaussian_d256,
                gaussian_d128_three_pass,k4096_dense,k10000,gaussian_d300,
                gaussian_d384,k1024] [--serve]

Fits, with the ``repro_torch`` package under ``--src`` (default: this
checkout's ``src``), the smoke run's Gaussian (10^6 x 32) and multinomial
(10^6 x 128) mixtures, or with ``--fits gaussian_d128`` its 2e5 x 128
Gaussian mixture (the one-read sweep's wide layout), ``gaussian_d256``
its 4e5 x 256 one (through the three-pass sweep) or
``gaussian_d128_three_pass`` the 2e5 x 128 one through the three-pass
sweep (``gibbs.sweep_tile`` with ``fused=False``: ``assign_gauss``,
``sub_assign_gauss``, ``suffstats_labels``), with
``DPMMConfig(k_max=64, iters=40, burnout=10,
log_every=10)``, seed 0, each ``--repeats`` times in one process (the
first also builds the kernels and warms up), on the card. The fits past
the one-read sweep's slot and width limits: ``k4096_dense`` (10^5 x 8,
``k_max=4096, compact=False``: every sweep on the 4096-slot slab),
``k10000`` (10^5 x 8, ``k_max=10000``: its init fold is past 8192
slots), ``gaussian_d300`` and ``gaussian_d384`` (8 true clusters of
50,000 points, d = 300 and 384, through the three-pass sweep), and
``k1024`` (10^5 x 16, ``k_max=1024``: a compacting fit whose merge
proposals run over 1024 slots). Prints
one JSON line per fit: the steady ms per iteration (the chunks after the
first), K, NMI, the fit's peak device bytes (``FitResult.peak_bytes``),
the chain's bits (``chain_bits``: its K history and digests of its
labels, histories and final stats, to compare two checkouts' chains)
and the card's name and power limit; a fit the checkout refuses is
printed with the error it raised. ``--serve`` also serves each
fitted Gaussian model (``DPMMEngine`` from its checkpoint, the default
ladder) and gives the host-clock p50 / p99 of SERVE_REQUESTS requests of
SERVE_B rows of the fit's points, answered (``query``: ``loglik_gauss``)
and answered with a posterior draw (``sample=True``: ``assign_gauss``
too), after SERVE_WARM warm-up requests. ``--tile-size`` fits through the
tiled plane, from a ``HostTiledSource`` over the points in host memory
(a checkout that has it). To compare two versions, run it on both
checkouts on one card, in turns (old, new, new, old).
"""
import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# name: (component, generator, d, N or None for --n, one-read sweep)
FITS = {"gaussian": ("gaussian", "generate_gmm", 32, None, True),
        "multinomial": ("multinomial", "generate_mnmm", 128, None, True),
        "gaussian_d128": ("gaussian", "generate_gmm", 128, 200_000, True),
        "gaussian_d256": ("gaussian", "generate_gmm", 256, 400_000, True),
        "gaussian_d128_three_pass": ("gaussian", "generate_gmm", 128,
                                     200_000, False),
        "k4096_dense": ("gaussian", "generate_gmm", 8, 100_000, True),
        "k10000": ("gaussian", "generate_gmm", 8, 100_000, True),
        "gaussian_d300": ("gaussian", "generate_gmm", 300, 400_000, True),
        "gaussian_d384": ("gaussian", "generate_gmm", 384, 400_000, True),
        "k1024": ("gaussian", "generate_gmm", 16, 100_000, True)}
# name: (DPMMConfig fields over the default fit's, true clusters)
FIT_EXTRA = {"k4096_dense": (dict(k_max=4096, compact=False), 16),
             "k10000": (dict(k_max=10_000), 16),
             "gaussian_d300": ({}, 8),
             "gaussian_d384": ({}, 8),
             "k1024": (dict(k_max=1024), 16)}

# --serve: rows a request (the default ladder's largest step), requests
# timed, and warm-up requests before them
SERVE_B, SERVE_REQUESTS, SERVE_WARM = 8192, 50, 10


def chain_bits(res) -> dict:
    """The fit's K history and sha256 digests (16 hex digits) of its
    labels, its per-iteration histories and its final stats and
    sub-stats: two fits with equal digests ran the same chain bit for
    bit."""
    def digest(arrays) -> str:
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]
    st = res.state
    names = [f.name for f in dataclasses.fields(st.stats)]
    return {"k_history": [int(v) for v in res.history["k"]],
            "labels": digest([res.labels]),
            "history": digest([res.history[k] for k in sorted(res.history)]),
            "stats": digest([getattr(s, f).cpu().numpy()
                             for s in (st.stats, st.substats)
                             for f in names])}


def serve_times(res, comp: str, x) -> dict:
    """p50 / p99 host ms of SERVE_B-row requests to an engine built from
    ``res``'s checkpoint, answered without and with a posterior draw."""
    from repro_torch.core import checkpoint
    from repro_torch.serve.dpmm import DPMMEngine
    with tempfile.TemporaryDirectory() as tmp:
        eng = DPMMEngine.from_checkpoint(checkpoint.save_model(
            str(Path(tmp) / "model.npz"), res.state, comp))
    out = {}
    for name, sample in (("query", False), ("query_sample", True)):
        times = []
        for i in range(SERVE_WARM + SERVE_REQUESTS):
            s = (i * 997) % (x.shape[0] - SERVE_B + 1)
            t0 = time.perf_counter()
            eng.query(x[s:s + SERVE_B], sample=sample)
            times.append(time.perf_counter() - t0)
        times = np.array(times[SERVE_WARM:]) * 1e3
        out[name] = {"p50_ms": float(np.percentile(times, 50)),
                     "p99_ms": float(np.percentile(times, 99))}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--tile-size", type=int, default=None)
    ap.add_argument("--serve", action="store_true",
                    help="also time SERVE_B-row requests to each fitted "
                    "Gaussian model")
    ap.add_argument("--fits", default="gaussian,multinomial",
                    help="comma-separated of " + ", ".join(FITS))
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_fit: no CUDA device")
    sys.path.insert(0, opts.src)
    import functools
    from repro_torch.configs import DPMMConfig
    from repro_torch.core import gibbs
    from repro_torch.core.sampler import DPMM
    from repro_torch.data import synthetic
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    one_read = gibbs.sweep_tile
    for name in opts.fits.split(","):
        comp, gen, d, n, fused = FITS[name]
        # the three-pass body swapped in as the reference's own tests do
        gibbs.sweep_tile = (one_read if fused else
                            functools.partial(one_read, fused=False))
        n = n or opts.n
        extra, k_true = FIT_EXTRA.get(name, ({}, 16))
        x, y = getattr(synthetic, gen)(n, d, k_true, seed=0)
        fields = dict(component=comp, k_max=64, iters=40, burnout=10,
                      log_every=10, **({} if opts.tile_size is None else
                                       {"tile_size": opts.tile_size}))
        fields.update(extra)
        cfg = DPMMConfig(**fields)
        src = x
        if opts.tile_size is not None:
            from repro_torch.data.source import HostTiledSource
            src = HostTiledSource(x)
        head = {"src": opts.src, "fit": name, "component": comp, "n": n,
                "d": d, "k_max": cfg.k_max, "compact": cfg.compact,
                "tile_size": opts.tile_size}
        for rep in range(opts.repeats):
            try:
                res = DPMM(cfg).fit(src)
            except (ValueError, RuntimeError) as e:
                print(json.dumps({**head, "repeat": rep,
                                  "refused": f"{type(e).__name__}: {e}",
                                  "nvidia_smi": smi}), flush=True)
                break
            served = ({"serve": serve_times(res, comp, x)}
                      if opts.serve and comp == "gaussian" else {})
            print(json.dumps({
                **head, "repeat": rep, "k": res.k,
                "nmi": res.nmi(y), "steady_ms_per_iter": 1e3 * float(
                    np.mean(res.iter_times_s[cfg.log_every:])),
                "peak_bytes": res.peak_bytes, "bits": chain_bits(res),
                **served, "nvidia_smi": smi}),
                flush=True)


if __name__ == "__main__":
    main()
