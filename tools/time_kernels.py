"""Time the dense ``suffstats`` kernel, the ``matmul`` kernel and the
Gaussian ``assign_gauss`` and ``loglik`` kernels past d = 128 of one or
two checkouts, in turns on one card.

    python3 tools/time_kernels.py [--src A/src [--src B/src]]
        [--kernels dense,matmul,gauss] [--out RESULT.json]

Each ``--src`` is the ``src`` directory of a checkout (default: this
checkout's). With two, the checkouts run in turns, A, B, B, A, each turn a
process of its own that builds the kernels of its checkout (into that
checkout's ``build/``) and times them:

- ``suffstats_cuda`` at the shapes of ``chip_smoke.py``'s
  ``kernel_check_dense`` (random points; one-hot or Dirichlet(1)
  responsibilities), beside the library route (``resp.sum(0)``,
  ``resp.T @ x``, the einsum; TF32 off) and the bound;
- ``matmul_cuda`` at the serving products (8192 and 256 rows, K = 32 and
  128, N = 16 slots) beside ``torch.matmul``;
- ``assign_gauss_cuda`` and ``loglik_cuda`` at the d = 256 fit's state
  (4e5 x 256, a 32-slot slab with 16 live slots; loglik over all 32),
  at a d = 256 serving step of 8192 and of 256 rows (K = 32), at an odd
  width (4e5 x 160) and at d = 512 and d = 1000 (8192 rows, K = 8), each
  beside its plain version and the bound of its work. A case a checkout's
  wrapper refuses (d > 256 before the panel redesign) is recorded as
  refused with the wrapper's message.

``--kernels`` picks the groups to time (default: all three).

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
# (name, N, d, K): assign_gauss (K // 2 live slots) and loglik (all K)
GAUSS_CASES = (("fit_d256", 400_000, 256, 32),
               ("serve_d256_8192", 8192, 256, 32),
               ("serve_d256_256", 256, 256, 32),
               ("fit_d160", 400_000, 160, 32),
               ("d512", 8192, 512, 8),
               ("d1000", 8192, 1000, 8))
KERNEL_GROUPS = ("dense", "matmul", "gauss")
BITS_M = (1, 255, 256, 8192)
BITS_K = (1, 32, 33, 128, 300)
BITS_N = (1, 16, 17, 32, 33, 64, 65)


def timed(fn, runs: int, cuda_ms, run_ms) -> dict:
    device, host = run_ms(fn, runs)
    return {"single_ms": cuda_ms(fn, runs), "device_ms": device,
            "host_ms": host}


def gauss_operands(n, d, k, dev, g):
    """``assign_gauss`` operands on the card: x and means of scale 3,
    factors I + 0.2 N(0, 1) / sqrt(d), the first k // 2 slots live,
    dense-slot counters of a slab twice as wide."""
    x = torch.randn(n, d, device=dev, generator=g) * 3
    mu = torch.randn(k, d, device=dev, generator=g) * 3
    f = (torch.randn(k, d, d, device=dev, generator=g) * (0.2 / d ** 0.5)
         + torch.eye(d, device=dev))
    ld = torch.randn(k, device=dev, generator=g)
    lw = torch.log_softmax(torch.randn(k, device=dev, generator=g), 0)
    act = (torch.arange(k, device=dev) < k // 2).to(torch.int32)
    gidx = torch.arange(n, device=dev, dtype=torch.int64)
    kz = torch.tensor([5, 4_000_000_000], device=dev)
    slots = torch.randperm(2 * k, device=dev, generator=g)[:k].to(
        torch.int32)
    return x, mu, f, ld, lw, act, gidx, kz, slots


def time_gauss(assign, loglik, bound, cuda_ms, run_ms, dev, g) -> dict:
    out = {}
    for name, n, d, k in GAUSS_CASES:
        a = gauss_operands(n, d, k, dev, g)
        live = k // 2
        runs = 10 if n * d * d > 10 ** 10 else 50
        r = {"n": n, "d": d, "k": k, "k_live": live}
        for kern, cuda, plain, work in (
                ("assign_gauss", lambda: assign.assign_gauss_cuda(*a),
                 lambda: assign.assign_gauss_plain(*a),
                 (2 * n * live * d * (d + 1),
                  4 * n * d + 12 * n + 4 * k * (d * d + d + 4))),
                ("loglik", lambda: loglik.loglik_cuda(*a[:4]),
                 lambda: loglik.loglik_plain(*a[:4]),
                 (2 * n * k * d * (d + 1),
                  4 * (n * d + k * (d * d + d + 1) + n * k)))):
            t = {}
            t["bound_ms"], t["bound_by"] = bound(*work)
            try:
                cuda()
            except ValueError as e:
                t["refused"] = str(e)
            else:
                t["kernel"] = timed(cuda, runs, cuda_ms, run_ms)
            t["plain"] = timed(plain, 3, cuda_ms, run_ms)
            r[kern] = t
        out[name] = r
        del a
        torch.cuda.empty_cache()
    return out


def worker(src: str, save: str, groups) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    from chip_smoke import bound, card, cuda_ms, dense_work, run_ms
    from repro_torch.kernels import assign, build, loglik, matmul, suffstats
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build.build()
    out = {"src": src, "nvidia_smi": card(), "dense": {},
           "matmul": {}, "gauss": {}}
    g = torch.Generator(device=dev).manual_seed(0)
    if "gauss" in groups:
        out["gauss"] = time_gauss(assign, loglik, bound, cuda_ms, run_ms,
                                  dev, g)
    for name, n, d, k, kind in DENSE_CASES if "dense" in groups else ():
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
    if "matmul" not in groups:
        return out
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
        s = {"dense": {}, "matmul": {}, "gauss": {}}
        for name, case in turns[0]["gauss"].items():
            s["gauss"][name] = {}
            for kern in ("assign_gauss", "loglik"):
                row = {"bound_ms": case[kern]["bound_ms"]}
                for route in ("kernel", "plain"):
                    if route in case[kern]:
                        for key in ("single_ms", "device_ms", "host_ms"):
                            row[f"{route}_{key}"] = median_of(
                                turns, ("gauss", name, kern, route, key))
                if "refused" in case[kern]:
                    row["refused"] = case[kern]["refused"]
                s["gauss"][name][kern] = row
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
    ap.add_argument("--kernels", default=",".join(KERNEL_GROUPS),
                    help="comma-separated groups of " + ", ".join(
                        KERNEL_GROUPS))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", default="", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    groups = opts.kernels.split(",")
    if not set(groups) <= set(KERNEL_GROUPS):
        raise SystemExit(f"time_kernels: --kernels takes {KERNEL_GROUPS}")
    if opts.worker:
        print(json.dumps(worker(opts.src[0], opts.save, groups)),
              flush=True)
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
                 "--save", save, "--kernels", opts.kernels],
                capture_output=True, text=True)
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
        if len(trees) == 2 and "matmul" in groups:
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
