"""Time a one-read sweep kernel of one checkout at a fit's shape.

    python3 tools/time_sweep.py [--src PATH/TO/src] [--kernel gauss|linear]

Builds ``sweep_gauss`` or ``sweep_linear`` from the ``repro_torch``
package under ``--src`` (default: this checkout's ``src``) and times its
``*_cuda`` wrapper on random operands of the shape of the smoke run's fit
at its final state. Defaults: Gaussian, N = 10^6 points, d = 32, a 64-row
slab with 17 live rows; linear (the multinomial fit), N = 10^6, d' = 128,
a 32-row slab with 16 live rows (``--n 11314 --d 20000`` is the
20newsgroups width). Prints one JSON line with the median of CUDA-event
times and the card's name and power limit. To compare two versions, run
it on both checkouts on one card, in turns (old, new, new, old).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def gauss_args(n, d, k, act, g):
    return (torch.randn(n, d, generator=g) * 3,
            torch.randn(k, d, generator=g) * 3,
            torch.randn(k, d, d, generator=g) * 0.2 + torch.eye(d),
            torch.randn(k, generator=g),
            torch.log_softmax(torch.randn(k, generator=g), 0), act,
            torch.randn(k, 2, d, generator=g) * 3,
            torch.randn(k, 2, d, d, generator=g) * 0.2 + torch.eye(d),
            torch.randn(k, 2, generator=g),
            torch.log_softmax(torch.randn(k, 2, generator=g), 1),
            torch.ones(n), torch.arange(n, dtype=torch.int64),
            torch.tensor([1, 2]), torch.tensor([3, 4]),
            torch.arange(k, dtype=torch.int32))


def linear_args(n, dp, k, act, g):
    """Multinomial operands: counts, log topic weights, zero constants."""
    logp = lambda *s: torch.log_softmax(torch.randn(*s, dp, generator=g), -1)
    return (torch.poisson(torch.full((n, dp), 2.0), generator=g),
            logp(k), torch.zeros(k),
            torch.log_softmax(torch.randn(k, generator=g), 0), act,
            logp(k, 2), torch.zeros(k, 2),
            torch.log_softmax(torch.randn(k, 2, generator=g), 1),
            torch.ones(n), torch.arange(n, dtype=torch.int64),
            torch.tensor([1, 2]), torch.tensor([3, 4]),
            torch.arange(k, dtype=torch.int32))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--kernel", choices=("gauss", "linear"), default="gauss")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=None,
                    help="d (gauss, default 32) or d' (linear, default 128)")
    ap.add_argument("--k", type=int, default=None,
                    help="slab rows (default 64 gauss, 32 linear)")
    ap.add_argument("--live", type=int, default=None,
                    help="live rows (default 17 gauss, 16 linear)")
    ap.add_argument("--runs", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_sweep: no CUDA device")
    sys.path.insert(0, opts.src)
    from repro_torch.kernels import sweep
    gauss = opts.kernel == "gauss"
    n, dev = opts.n, torch.device("cuda")
    d = opts.d or (32 if gauss else 128)
    k = opts.k or (64 if gauss else 32)
    live = opts.live or (17 if gauss else 16)
    g = torch.Generator().manual_seed(0)
    act = torch.zeros(k, dtype=torch.int32)
    act[torch.randperm(k, generator=g)[:live]] = 1
    args = (gauss_args if gauss else linear_args)(n, d, k, act, g)
    args = tuple(a.to(dev).contiguous() for a in args)
    run = sweep.sweep_gauss_cuda if gauss else sweep.sweep_linear_cuda
    run(*args)                                          # build, warm up
    times = []
    for _ in range(opts.runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run(*args)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": opts.src, "kernel": opts.kernel, "n": n,
                      "d": d, "k": k, "k_live": live,
                      "ms": float(np.median(times)), "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
