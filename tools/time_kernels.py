"""Time the dense ``suffstats`` kernel, the ``matmul`` kernel, the
Gaussian ``assign_gauss`` and ``loglik`` kernels past d = 128, and
``suffstats_labels`` and ``sweep_gauss`` of one or two checkouts, in turns
on one card, and compare the two checkouts' bits.

    python3 tools/time_kernels.py [--src A/src [--src B/src]]
        [--kernels dense,matmul,gauss,stats,sweep] [--out RESULT.json]

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
  refused with the wrapper's message;
- ``suffstats_labels_cuda`` (``stats``) at the Gaussian fits' final states
  (10^6 x 32 over 64 slots, 17 live; 2e5 x 128 over 64, 16 live; 4e5 x
  256 over 32, 16 live) and a ragged N at an odd width, and
  ``sweep_gauss_cuda`` (``sweep``) at the one-read fits' states (10^6 x 32,
  a 64-slot slab with 17 live; 2e5 x 128, 32 slots, 16 live), a ragged N
  and 10^6 x 8 and x 16 (64 slots, 17 live), each beside its plain version
  and its bound. Points are drawn from the live slots' mixture (so the
  labels spread as at a fit's end) and the stats cases take the labels and
  sub-labels of that mixture. The sweep cases also time the three-pass
  kernels on the same operands
  (``assign_gauss``, ``sub_assign_gauss``, ``suffstats_labels`` over the
  sweep's segments), which run the sweep's device code one step at a
  time: the split of the sweep's time into steps (e), (f) and the fold.
  Each sweep case also gives the device time of each kernel the call
  launches (``torch.profiler``: the tiled step (e) and the (f) + fold
  kernel above d = 16, the one fused kernel at and below it).

``--kernels`` picks the groups to time (default: all five).

Every time is given two ways, with ``chip_smoke.py``'s timers: the median
single-call time (``cuda_ms``: what one caller sees, host time included)
and the per-launch device time of a run of back-to-back calls
(``run_ms``, with the host's per-call enqueue time). Each turn also keeps
the ``matmul`` kernel's outputs on fixed inputs over a grid of shapes
(M in {1, 255, 256, 8192}, K in {1, 32, 33, 128, 300}, N in {1, 16, 17,
32, 33, 64, 65}); with two checkouts the last line says whether the two
kernels gave the same bits at every shape. The ``stats`` and ``sweep``
groups keep, the same way, a fingerprint of every output (labels,
sub-labels, n, sx, sxx: a position-weighted sum of the raw bits, so any
changed bit changes it) over a grid of seeded shapes: d in {1, 3, 4, 31,
32, 33, 63, 64, 65, 100, 127, 128} (and 129, 200, 255, 256 for the stats),
K in {1, 2, 17, 64, 300}, N in {1, 1023, 1025, 4097}, plus blocks whose
points are all invalid, blocks that are one segment, random valid-mask
zeros, and the timed fit states. Prints one JSON line per turn and a
summary line (medians by checkout), and with ``--out`` writes all of it
to that file.
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
DEV = torch.device("cuda")
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
# (name, N, d, K slots, live slots): suffstats_labels at the Gaussian
# fits' split/merge folds and a ragged N at an odd width
STATS_CASES = (("fit_d32", 1_000_000, 32, 64, 17),
               ("fit_d128", 200_000, 128, 64, 16),
               ("fit_d256", 400_000, 256, 32, 16),
               ("ragged", 100_003, 33, 64, 17))
# (name, N, d, K slots, live slots): sweep_gauss at the one-read fits'
# final states, a ragged N, and the d = 32 fit's state at d = 8 and 16,
# where step (e) runs in the (f) + fold block (below sweep.TE_MIN_D)
SWEEP_CASES = (("fit_d32", 1_000_000, 32, 64, 17),
               ("fit_d128", 200_000, 128, 32, 16),
               ("ragged", 100_003, 33, 64, 17),
               ("d8", 1_000_000, 8, 64, 17),
               ("d16", 1_000_000, 16, 64, 17))
KERNEL_GROUPS = ("dense", "matmul", "gauss", "stats", "sweep")
BITS_STATS_D = (1, 3, 4, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 200,
                255, 256)
BITS_SWEEP_D = (1, 3, 4, 31, 32, 33, 63, 64, 65, 100, 127, 128)
BITS_GRID_K = (1, 2, 17, 64, 300)
BITS_GRID_N = (1, 1023, 1025, 4097)
# the edge cases' N and K: four blocks and a ragged one, 17 slots
EDGE_N, EDGE_K = 4097, 17
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


def kernel_split(fn, runs: int) -> dict:
    """Device ms per call of each kernel ``fn`` launches, by
    ``torch.profiler`` over ``runs`` calls (after a warm-up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _device_us
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: _device_us(e) * 1e-3 / runs
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0}


def fingerprint(t: torch.Tensor) -> int:
    """A position-weighted sum of ``t``'s raw 32-bit words (int64,
    wrapping): equal tensors give equal sums, and a changed bit anywhere
    changes the sum but for a 2^-64 chance."""
    bits = t.contiguous().view(torch.int32).flatten().to(torch.int64)
    pos = torch.arange(bits.numel(), device=t.device, dtype=torch.int64)
    w = (pos * 2654435761 + 97) % 2147483647 + 1
    return int((bits * w).sum())


def mixture_operands(n, d, k, live, dev, seed):
    """``sweep_gauss`` operands whose points come from the mixture of the
    first ``live`` of ``k`` slots (means of scale 3, unit noise), as a fit's
    state leaves them: factors I + 0.2 N(0, 1) / sqrt(d), sub-means half a
    unit about the means, dense-slot counters of a slab twice as wide.
    Also returns the points' true components."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mu = torch.randn(k, d, device=dev, generator=g) * 3
    z = torch.randint(0, live, (n,), device=dev, generator=g)
    x = mu[z] + torch.randn(n, d, device=dev, generator=g)
    eye = torch.eye(d, device=dev)
    f = torch.randn(k, d, d, device=dev, generator=g) * (0.2 / d ** 0.5) + eye
    ld = torch.randn(k, device=dev, generator=g)
    lw = torch.log_softmax(torch.randn(k, device=dev, generator=g), 0)
    act = (torch.arange(k, device=dev) < live).to(torch.int32)
    smu = mu[:, None] + 0.5 * torch.randn(k, 2, d, device=dev, generator=g)
    sf = (torch.randn(k, 2, d, d, device=dev, generator=g) * (0.2 / d ** 0.5)
          + eye)
    sld = torch.randn(k, 2, device=dev, generator=g)
    slw = torch.log_softmax(torch.randn(k, 2, device=dev, generator=g), 1)
    valid = torch.ones(n, device=dev)
    gidx = torch.arange(n, device=dev, dtype=torch.int64)
    kz = torch.tensor([11, 3_000_000_001], device=dev)
    kzb = torch.tensor([12, 4_000_000_003], device=dev)
    slots = torch.randperm(2 * k, device=dev, generator=g)[:k].to(
        torch.int32)
    args = (x, mu, f, ld, lw, act, smu, sf, sld, slw, valid, gidx, kz, kzb,
            slots)
    return tuple(a.contiguous() for a in args), z.to(torch.int32)


def grid_sweep_args(n, d, k, dev, seed, kind="grid"):
    """Seeded ``sweep_gauss`` operands of the bits grid (made on the CPU,
    so both checkouts get the same): random points and slots, about 60 % of
    the slots live. ``kind`` "empty": every point invalid; "one_segment":
    one live slot and a far second sub-cluster, so the block is one
    segment; "valid_zeros": half the points invalid."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) * 3
    mu = torch.randn(k, d, generator=g) * 3
    f = torch.randn(k, d, d, generator=g) * 0.2 + torch.eye(d)
    ld = torch.randn(k, generator=g)
    lw = torch.log_softmax(torch.randn(k, generator=g), 0)
    act = (torch.rand(k, generator=g) < 0.6).to(torch.int32)
    act[0] = 1
    smu = torch.randn(k, 2, d, generator=g) * 3
    sf = torch.randn(k, 2, d, d, generator=g) * 0.2 + torch.eye(d)
    sld = torch.randn(k, 2, generator=g)
    slw = torch.log_softmax(torch.randn(k, 2, generator=g), 1)
    valid = torch.ones(n)
    if kind == "empty":
        valid.zero_()
    elif kind == "valid_zeros":
        valid = (torch.rand(n, generator=g) < 0.5).float()
    elif kind == "one_segment":
        act.zero_()
        act[k // 2] = 1
        smu[:, 1] += 1e3
    gidx = torch.arange(n, dtype=torch.int64) + 7
    kz = torch.randint(0, 1 << 32, (2,), generator=g, dtype=torch.int64)
    kzb = torch.randint(0, 1 << 32, (2,), generator=g, dtype=torch.int64)
    slots = torch.randperm(2 * k, generator=g)[:k].to(torch.int32)
    args = (x, mu, f, ld, lw, act, smu, sf, sld, slw, valid, gidx, kz, kzb,
            slots)
    return tuple(a.to(dev).contiguous() for a in args)


def grid_stats_args(n, d, k, dev, seed, kind="grid"):
    """Seeded ``suffstats_labels`` operands of the bits grid: labels in
    [-1, k] (out-of-range ones add nothing), random sub-labels, all points
    valid; ``kind`` as in ``grid_sweep_args`` ("one_segment": every point
    label k // 2, sub-label 1)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) * 3
    lab = torch.randint(-1, k + 1, (n,), generator=g, dtype=torch.int32)
    sub = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    valid = torch.ones(n)
    if kind == "empty":
        valid.zero_()
    elif kind == "valid_zeros":
        valid = (torch.rand(n, generator=g) < 0.5).float()
    elif kind == "one_segment":
        lab.fill_(k // 2)
        sub.fill_(1)
    return (x.to(dev), lab.to(dev), sub.to(dev), valid.to(dev), k)


def bits_cases(ds):
    """(name, n, d, k, kind) of the bits grid and its edge cases."""
    for d in ds:
        for k in BITS_GRID_K:
            for n in BITS_GRID_N:
                yield f"{n}x{d}x{k}", n, d, k, "grid"
        for kind in ("empty", "one_segment", "valid_zeros"):
            yield f"{kind}_{EDGE_N}x{d}x{EDGE_K}", EDGE_N, d, EDGE_K, kind


def time_stats(suffstats, gauss_work, bound, cuda_ms, run_ms, dev,
               prints) -> dict:
    out = {}
    for name, n, d, k, live in STATS_CASES:
        a, z = mixture_operands(n, d, k, live, dev, seed=1)
        sub = (a[0][:, 0] > a[1][z.long(), 0]).to(torch.int32)
        s_args = (a[0], z, sub, a[10], k)
        r = {"n": n, "d": d, "k": k, "k_live": live}
        r["bound_ms"], r["bound_by"] = bound(
            *gauss_work(n, d, k, live, k)["suffstats_labels"])
        runs = 10 if n * d * d > 10 ** 10 else 20
        r["kernel"] = timed(lambda: suffstats.suffstats_labels_cuda(*s_args),
                            runs, cuda_ms, run_ms)
        r["plain"] = {"single_ms": cuda_ms(
            lambda: suffstats.suffstats_labels_plain(*s_args), 1)}
        prints[f"fit_{name}"] = [fingerprint(t) for t in
                                 suffstats.suffstats_labels_cuda(*s_args)]
        out[name] = r
        del a, z, sub, s_args
        torch.cuda.empty_cache()
    return out


def time_sweep(sweep, assign, suffstats, gauss_work, bound, cuda_ms, run_ms,
               dev, prints) -> dict:
    out = {}
    for name, n, d, k, live in SWEEP_CASES:
        a, _ = mixture_operands(n, d, k, live, dev, seed=2)
        r = {"n": n, "d": d, "k": k, "k_live": live}
        r["bound_ms"], r["bound_by"] = bound(
            *gauss_work(n, d, k, live, k)["sweep_gauss"])
        res = sweep.sweep_gauss_cuda(*a)
        prints[f"fit_{name}"] = [fingerprint(t) for t in res]
        r["kernel"] = timed(lambda: sweep.sweep_gauss_cuda(*a), 20, cuda_ms,
                            run_ms)
        r["plain"] = {"single_ms": cuda_ms(
            lambda: sweep.sweep_gauss_plain(*a), 1)}
        # device time of each kernel of the call (the tiled step (e), then
        # the (f) + fold kernel)
        r["split"] = kernel_split(lambda: sweep.sweep_gauss_cuda(*a), 10)
        # the three-pass kernels on the same operands: steps (e), (f) and
        # the fold, one at a time, with the sweep's own labels
        e_args = a[:6] + (a[11], a[12], a[14])
        f_args = (a[0], a[6], a[7], a[8], a[9], res[0], a[11], a[13])
        s_args = (a[0], res[0], res[1], a[10], k)
        r["three_pass"] = {
            "assign_gauss": timed(lambda: assign.assign_gauss_cuda(*e_args),
                                  20, cuda_ms, run_ms),
            "sub_assign_gauss": timed(
                lambda: assign.sub_assign_gauss_cuda(*f_args), 20, cuda_ms,
                run_ms),
            "suffstats_labels": timed(
                lambda: suffstats.suffstats_labels_cuda(*s_args), 20,
                cuda_ms, run_ms)}
        out[name] = r
        del a, res, e_args, f_args, s_args
        torch.cuda.empty_cache()
    return out


def bits_grid(fn, ds, make, prints) -> None:
    """Fingerprints of ``fn``'s outputs over the bits grid; a shape the
    wrapper refuses is kept as its message."""
    for i, (name, n, d, k, kind) in enumerate(bits_cases(ds)):
        args = make(n, d, k, DEV, 1000 + i, kind)
        try:
            res = fn(*args)
        except ValueError as e:
            prints[name] = str(e)
            continue
        prints[name] = [fingerprint(t) for t in res]
        del res, args
    torch.cuda.synchronize()


# sources each group's kernels need
GROUP_SOURCES = {"dense": ("suffstats_dense",), "matmul": ("matmul",),
                 "gauss": ("assign_gauss", "loglik_gauss"),
                 "stats": ("suffstats_labels",),
                 "sweep": ("sweep_gauss", "assign_gauss", "sub_assign_gauss",
                           "suffstats_labels")}


def worker(src: str, save: str, groups) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    from chip_smoke import bound, card, cuda_ms, dense_work, gauss_work, \
        run_ms
    from repro_torch.kernels import (assign, build, loglik, matmul,
                                     suffstats, sweep)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"src": src, "build_s": build.build(sorted(
        {n for grp in groups for n in GROUP_SOURCES[grp]})),
           "ptxas": {n: [ln for ln in (build.ptxas_report(n) or "")
                         .splitlines() if "registers" in ln or "spill" in ln
                         or "Compiling" in ln]
                     for grp in groups for n in GROUP_SOURCES[grp]}}
    out.update({"nvidia_smi": card(), "dense": {},
           "matmul": {}, "gauss": {}, "stats": {}, "sweep": {}})
    bits = {}
    g = torch.Generator(device=dev).manual_seed(0)
    if "stats" in groups:
        bits["stats"] = {}
        out["stats"] = time_stats(suffstats, gauss_work, bound, cuda_ms,
                                  run_ms, dev, bits["stats"])
        bits_grid(suffstats.suffstats_labels_cuda, BITS_STATS_D,
                  grid_stats_args, bits["stats"])
    if "sweep" in groups:
        bits["sweep"] = {}
        out["sweep"] = time_sweep(sweep, assign, suffstats, gauss_work,
                                  bound, cuda_ms, run_ms, dev, bits["sweep"])
        bits_grid(sweep.sweep_gauss_cuda, BITS_SWEEP_D,
                  grid_sweep_args, bits["sweep"])
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
    if "matmul" in groups:
        for m, k, n in MATMUL_CASES:
            a = torch.randn(m, k, device=dev, generator=g)
            b = torch.randn(k, n, device=dev, generator=g)
            r = {"kernel": timed(lambda: matmul.matmul_cuda(a, b), 100,
                                 cuda_ms, run_ms),
                 "torch_matmul": timed(lambda: torch.matmul(a, b), 100,
                                       cuda_ms, run_ms)}
            r["bound_ms"], r["bound_by"] = bound(
                2 * m * k * n, 4 * (m * k + k * n + m * n))
            out["matmul"][f"{m}x{k}x{n}"] = r
        gc = torch.Generator().manual_seed(1)
        bits["matmul"] = {}
        for m in BITS_M:
            for k in BITS_K:
                a = torch.randn(m, k, generator=gc).to(dev)
                for n in BITS_N:
                    b = torch.randn(k, n, generator=gc).to(dev)
                    bits["matmul"][f"{m}x{k}x{n}"] = matmul.matmul_cuda(
                        a, b).cpu()
    torch.save(bits, save)
    return out


def same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def bits_report(a: dict, b: dict) -> dict:
    """Per group: shapes compared, those equal, those that differ (and the
    shapes either checkout refused)."""
    out = {}
    for group in a:
        if group not in b:
            continue
        differ = [s for s in a[group] if not same_bits(a[group][s],
                                                       b[group].get(s))]
        refused = [s for s in a[group]
                   if isinstance(a[group][s], str)
                   or isinstance(b[group].get(s), str)]
        out[group] = {"shapes": len(a[group]),
                      "bitwise": len(a[group]) - len(differ),
                      "differ": differ, "refused": refused,
                      "equal": not differ}
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
        s = {"dense": {}, "matmul": {}, "gauss": {}, "stats": {},
             "sweep": {}}
        for group in ("stats", "sweep"):
            for name, case in turns[0][group].items():
                row = {"bound_ms": case["bound_ms"],
                       "plain_single_ms": median_of(
                           turns, (group, name, "plain", "single_ms"))}
                for key in ("single_ms", "device_ms", "host_ms"):
                    row[f"kernel_{key}"] = median_of(
                        turns, (group, name, "kernel", key))
                for kern in case.get("three_pass", {}):
                    row[f"{kern}_device_ms"] = median_of(
                        turns, (group, name, "three_pass", kern,
                                "device_ms"))
                if "split" in case:
                    row["split_device_ms"] = {
                        kern: median_of(turns, (group, name, "split", kern))
                        for kern in case["split"]}
                s[group][name] = row
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
    order = trees if len(trees) == 1 else [
        trees[0], trees[1], trees[1], trees[0]]
    results, saved = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(order):
            save = str(Path(tmp) / f"bits_{i}.pt")
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
        if len(trees) == 2:
            a, b = (torch.load(saved[t]) for t in trees)
            report["bitwise"] = bits_report(a, b)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(json.dumps({"turns": results, **report},
                                             indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
