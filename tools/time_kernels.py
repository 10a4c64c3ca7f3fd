"""Time the dense ``suffstats`` kernel and the ``matmul`` kernel of one or
two checkouts, in turns on one card.

    python3 tools/time_kernels.py [--src A/src [--src B/src]]
        [--out RESULT.json]

Each ``--src`` is the ``src`` directory of a checkout (default: this
checkout's). With two, the checkouts run in turns, A, B, B, A, each turn a
process of its own that builds the kernels of its checkout (into that
checkout's ``build/``) and times them:

- ``suffstats_cuda`` at the shapes of ``chip_smoke.py``'s
  ``kernel_check_dense`` (random points; one-hot or Dirichlet(1)
  responsibilities), beside the library route (``resp.sum(0)``,
  ``resp.T @ x``, the einsum; TF32 off) and the bound;
- ``matmul_cuda`` at the serving products (8192 and 256 rows, K = 32 and
  128, N = 16 slots) beside ``torch.matmul``.

Every time is given two ways, with ``chip_smoke.py``'s timers: the median
single-call time (``cuda_ms``: what one caller sees, host time included)
and the per-launch device time of a run of back-to-back calls
(``run_ms``, with the host's per-call enqueue time). Each turn also keeps
the ``matmul`` kernel's outputs on fixed inputs over a grid of shapes
(M in {1, 255, 256, 8192}, K in {1, 32, 33, 128, 300}, N in {1, 16, 17,
32, 33, 64, 65}); with two checkouts the last line says whether the two
kernels gave the same bits at every shape. Prints one JSON line per turn
and a summary line (medians by checkout), and with ``--out`` writes all
of it to that file.
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# (name, N, d, K, responsibilities): chip_smoke.py's kernel_check_dense
DENSE_CASES = (("fit_d32_one_hot", 1_000_000, 32, 32, "one_hot"),
               ("fit_d32_soft", 1_000_000, 32, 32, "soft"),
               ("fit_d128_one_hot", 200_000, 128, 32, "one_hot"),
               ("ragged", 1003, 7, 5, "soft"),
               ("d256", 100_000, 256, 32, "one_hot"),
               ("ref_2000x16x16", 2000, 16, 16, "one_hot"),
               ("ref_10000x32x32", 10_000, 32, 32, "one_hot"))
# (M, K, N): a serving step's products (the diagonal x^2 prec^T at d = 32,
# the multinomial x W^T at d' = 128) at the ladder's top and bottom step
MATMUL_CASES = ((8192, 32, 16), (8192, 128, 16), (256, 32, 16),
                (256, 128, 16))
BITS_M = (1, 255, 256, 8192)
BITS_K = (1, 32, 33, 128, 300)
BITS_N = (1, 16, 17, 32, 33, 64, 65)


def timed(fn, runs: int, cuda_ms, run_ms) -> dict:
    device, host = run_ms(fn, runs)
    return {"single_ms": cuda_ms(fn, runs), "device_ms": device,
            "host_ms": host}


def worker(src: str, save: str) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    from chip_smoke import bound, card, cuda_ms, dense_work, run_ms
    from repro_torch.kernels import build, matmul, suffstats
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build()
    out = {"src": src, "nvidia_smi": card(), "dense": {},
           "matmul": {}}
    g = torch.Generator(device=dev).manual_seed(0)
    for name, n, d, k, kind in DENSE_CASES:
        x = torch.randn(n, d, device=dev, generator=g) * 3
        if kind == "one_hot":
            lab = torch.randint(0, k, (n,), device=dev, generator=g)
            resp = torch.nn.functional.one_hot(lab, k).to(torch.float32)
        else:
            gam = torch._standard_gamma(torch.ones(n, k, device=dev),
                                        generator=g)
            resp = gam / gam.sum(dim=1, keepdim=True)
        r = {"n": n, "d": d, "k": k, "resp": kind}
        r["bound_ms"], r["bound_by"] = bound(*dense_work(n, k, d))
        r["kernel"] = timed(lambda: suffstats.suffstats_cuda(x, resp), 10,
                            cuda_ms, run_ms)
        r["library"] = timed(lambda: (
            resp.sum(dim=0), resp.T @ x,
            torch.einsum("nk,nd,ne->kde", resp, x, x)), 10, cuda_ms, run_ms)
        out["dense"][name] = r
        del x, resp
    for m, k, n in MATMUL_CASES:
        a = torch.randn(m, k, device=dev, generator=g)
        b = torch.randn(k, n, device=dev, generator=g)
        r = {"kernel": timed(lambda: matmul.matmul_cuda(a, b), 100,
                             cuda_ms, run_ms),
             "torch_matmul": timed(lambda: torch.matmul(a, b), 100,
                                   cuda_ms, run_ms)}
        r["bound_ms"], r["bound_by"] = bound(2 * m * k * n,
                                             4 * (m * k + k * n + m * n))
        out["matmul"][f"{m}x{k}x{n}"] = r
    gc = torch.Generator().manual_seed(1)
    outs = {}
    for m in BITS_M:
        for k in BITS_K:
            a = torch.randn(m, k, generator=gc).to(dev)
            for n in BITS_N:
                b = torch.randn(k, n, generator=gc).to(dev)
                outs[f"{m}x{k}x{n}"] = matmul.matmul_cuda(a, b).cpu()
    torch.save(outs, save)
    return out


def median_of(turns, path) -> float:
    vals = []
    for t in turns:
        v = t
        for key in path:
            v = v[key]
        vals.append(v)
    return float(np.median(vals))


def summary(trees, results) -> dict:
    """Per checkout, the median over its turns of every time."""
    out = {}
    for src in trees:
        turns = [r for r in results if r["src"] == src]
        s = {"dense": {}, "matmul": {}}
        for name in turns[0]["dense"]:
            s["dense"][name] = {
                f"{route}_{key}": median_of(turns, ("dense", name, route,
                                                    key))
                for route in ("kernel", "library")
                for key in ("single_ms", "device_ms", "host_ms")}
            s["dense"][name]["bound_ms"] = turns[0]["dense"][name][
                "bound_ms"]
        for name in turns[0]["matmul"]:
            s["matmul"][name] = {
                f"{route}_{key}": median_of(turns, ("matmul", name, route,
                                                    key))
                for route in ("kernel", "torch_matmul")
                for key in ("single_ms", "device_ms", "host_ms")}
            s["matmul"][name]["bound_ms"] = turns[0]["matmul"][name][
                "bound_ms"]
        out[src] = s
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=None)
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", default="", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    if opts.worker:
        print(json.dumps(worker(opts.src[0], opts.save)), flush=True)
        return
    trees = [str(Path(s).resolve()) for s in (opts.src or [str(ROOT
                                                             / "src")])]
    if len(trees) > 2:
        raise SystemExit("time_kernels: at most two checkouts")
    order = trees if len(trees) == 1 else [trees[0], trees[1], trees[1],
                                           trees[0]]
    results, saved = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(order):
            save = str(Path(tmp) / f"matmul_{i}.pt")
            proc = subprocess.run(
                [sys.executable, __file__, "--worker", "--src", src,
                 "--save", save], capture_output=True, text=True)
            if proc.returncode != 0:
                raise SystemExit(f"time_kernels: turn {i} ({src}) failed:\n"
                                 f"{proc.stdout[-4000:]}"
                                 f"{proc.stderr[-4000:]}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            res["turn"] = i
            print(json.dumps(res), flush=True)
            results.append(res)
            saved.setdefault(src, save)
        report = {"order": order, "summary": summary(trees, results)}
        if len(trees) == 2:
            a, b = (torch.load(saved[t]) for t in trees)
            differ = [s for s in a if not torch.equal(a[s], b[s])]
            report["matmul_bitwise"] = {"shapes": len(a),
                                        "differ": differ,
                                        "equal": not differ}
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(json.dumps({"turns": results, **report},
                                             indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
