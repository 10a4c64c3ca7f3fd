"""Time the Gaussian sweep kernel of one checkout at the fit's shape.

    python3 tools/time_sweep_gauss.py [--src PATH/TO/src] [--d 32]

Builds ``sweep_gauss`` from the ``repro_torch`` package under ``--src``
(default: this checkout's ``src``), then times ``sweep_gauss_cuda`` on
the shape of the smoke run's Gaussian fit at its final state: N = 10^6
points, a 64-row slab with 17 live rows (the compaction of a 17-cluster
fit), d = 32. Prints one JSON line with the median of CUDA-event times and
the card's name and power limit. To compare two versions, run it on both
checkouts on one card, in turns (old, new, new, old).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--live", type=int, default=17)
    ap.add_argument("--runs", type=int, default=20)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_sweep_gauss: no CUDA device")
    sys.path.insert(0, opts.src)
    from repro_torch.kernels import sweep
    n, d, k, dev = opts.n, opts.d, opts.k, torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    act = torch.zeros(k, dtype=torch.int32)
    act[torch.randperm(k, generator=g)[:opts.live]] = 1
    args = (torch.randn(n, d, generator=g) * 3,
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
    args = tuple(a.to(dev).contiguous() for a in args)
    sweep.sweep_gauss_cuda(*args)                       # build, warm up
    times = []
    for _ in range(opts.runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        sweep.sweep_gauss_cuda(*args)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": opts.src, "n": n, "d": d, "k": k,
                      "k_live": opts.live, "ms": float(np.median(times)),
                      "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
