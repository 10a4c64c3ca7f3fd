"""Time the dense ``suffstats`` kernel, the ``matmul`` kernel, the
Gaussian ``assign_gauss`` and ``loglik`` kernels,
``suffstats_labels``, ``sweep_gauss``, ``sub_assign_gauss``,
``sweep_linear`` and the stat fold of one or two checkouts, in turns on
one card, and compare the two checkouts' bits.

    python3 tools/time_kernels.py [--src A/src [--src B/src]]
        [--kernels dense,matmul,gauss,stats,sweep,sub,linear,moments,fold]
        [--bits-only] [--out RESULT.json]

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
- ``assign_gauss_cuda`` and ``loglik_cuda`` (``gauss``) at the cases of
  ``GAUSS_CASES``: past d = 128 the d = 256 fit's state (4e5 x 256, a
  32-slot slab with 16 live slots; loglik over all 32), a d = 256 serving
  step of 8192 and of 256 rows, an odd width (4e5 x 160) and d = 512 and
  1000 (8192 rows, K = 8); at d <= 128 the serving steps (8192 rows, 32
  slots, 17 live) at d = 32 and 128, a 256-row step, the three-pass fits'
  states, a ragged N at an odd width and d = 8 and 16 at 8192 and 10^6
  rows, where a checkout with a d <= 16 switch (``assign.GAUSS_NARROW_D``)
  is timed on both of its routes; each beside its plain version and the
  bound of its work. A case a checkout's wrapper refuses is recorded as
  refused with the wrapper's message;
- ``suffstats_labels_cuda`` (``stats``) at the Gaussian fits' final states
  (10^6 x 32 over 64 slots, 17 live; 2e5 x 128 over 64, 16 live; 4e5 x
  256 over 32, 16 live) and a ragged N at an odd width, the d = 256 fit's
  whole label folds over 32 and 64 slots (``stats_from_labels``, in the
  checkout's stat windows, split by kernel), and
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

- ``sub_assign_gauss_cuda`` (``sub``) at the d = 256 fit's state (4e5 x
  256, 32 slots, 16 live), the sweep group's states (2e5 x 128, 10^6 x
  32), a ragged N at an odd width and 2e5 x 64 / x 65 (the two sides of
  ``assign.sub_plan``'s route switch), labels from ``assign_gauss`` on the
  same operands, each beside its plain version and bound, split by kernel
  (``torch.profiler``);
- ``sweep_linear_cuda`` (``linear``) at the multinomial fit's final state
  (a 10^6 x 128 fit, ``chip_smoke.py`` ``fit_linear_args``), the
  20newsgroups width (11,314 x 20,000, 32 slots), a diagonal-Gaussian
  state (d' = 64), a Poisson state, a ragged N at an odd d' and
  10^6 x 64 / x 68 (the two sides of ``sweep.linear_plan``'s step-(f)
  route switch), beside its plain version, its bound and the Threefry
  draws it makes, split by
  kernel (``torch.profiler``) and by the three-pass kernels on the same
  operands (``assign_linear``, ``sub_assign_linear``, ``moments_labels``
  over the sweep's segments); and ``assign_linear`` and
  ``sub_assign_linear`` alone (``linear_steps``) at the 8192-row
  multinomial and diagonal-Gaussian serving steps, 2e5 x 128, 10^6 x 128
  and the 20newsgroups width, each beside its bound, its plain version
  and the per-kernel split of ``sweep_linear`` on the same operands.

- ``moments``: ``moments_labels``'s bits over d' in {1, 3, 4, 32, 128,
  129, 1000}, K in {1, 2, 17, 300, 2048, 8192} and the block edge cases
  (no timing);
- ``fold``: the fold of the 10^6 x 32 fit's per-block partials (n, sx,
  sxx of ``sweep_gauss`` on the mixture of 17 live of 64 slots) from a
  nonzero accumulator, one launch a field (``fold_partials_cuda``) and,
  where the checkout has it, all three in one launch
  (``fold_fields_cuda``, held bitwise against the loop of adds), beside
  the bound; and the fold's bits over nb x m shapes.

``--kernels`` picks the groups to time (default: all nine).
``--bits-only`` keeps every group's bits grid and times nothing (nor
keeps the timed states' prints).
``--bits-out FILE`` keeps the first checkout's bits, and a later run's
``--bits-against FILE`` compares each of its checkouts with them (the
summary's ``bitwise_against``).

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
zeros, and the timed fit states; and many slots: K in {2048, 8192} at d
in {1, 32, 128, 129, 256} for the stats and ``sub`` (the sweep at
K = 2048, d in {1, 32, 128}). The ``dense`` group keeps the dense
oracle's outputs over d in {1, 7, 32, 128, 129, 256}, K in {1, 17, 2048,
8192}, N in {1, 1025}. The ``sub`` group's grid: d in {1, 3, 4,
31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 160, 200, 255, 256}, the same
K and N, labels in [-1, K] (outside [0, K): sub-label 0), every label one
and all labels distinct. The ``linear`` group's, for ``sweep_linear``,
``assign_linear`` and ``sub_assign_linear`` (step (f) under labels in
[-1, K]) on the same operands: d' in {1, 3, 4, 24, 64, 65, 127, 128, 129,
1000, 20000}, K in {1, 2, 17, 64, 300, 2048}, N in {1, 1023, 1025,
11314}, the three block edge cases and a misaligned feature view (the
scalar path), each beside the count of its inactive slots' draws in the
Threefry top bin; and past 2048 slots, K in {2049, 4096, 10000} at d' in
{1, 3, 24, 64, 65, 128, 129, 20000} and N in {1, 1025, 4097} (the sweep's
refusal kept as its message). The ``gauss`` group's grid keeps both kernels' outputs
(labels, log-likelihood rows) at d in {1, 4, 16, 17, 31, 32, 33, 64, 65,
127, 128}, K in {1, 2, 5, 17, 32, 64, 300, 2049, 4097}, N in {1, 127,
128, 129, 4097, 8192}, with no slot active, one active, an inactive slot
whose draw lies in the top bin, 4097 slots 90 % live at N = 40,000, and
five shapes past d = 128 (the panel layout).
Prints one JSON line per turn and a summary line
(medians by checkout), and with ``--out`` writes all of it to that
file.
"""
import argparse
import json
import shutil
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
# (name, N, d, K, live): assign_gauss (``live`` slots active) and loglik
# (all K). Past d = 128: the d = 256 fit's state, serving steps, an odd
# width, d = 512 and 1000. At d <= 128: chip_smoke.py's serving steps
# (8192 rows, 32 slots, 17 live) at d = 32 and 128, a 256-row step, the
# three-pass fits' states (10^6 x 32, 64 slots, 17 live; 2e5 x 128, 32
# slots, 16 live), a ragged N at an odd width, and d = 8 and 16 at 8192
# and 10^6 rows, where both routes of the d <= 16 switch are timed.
GAUSS_CASES = (("fit_d256", 400_000, 256, 32, 16),
               ("serve_d256_8192", 8192, 256, 32, 16),
               ("serve_d256_256", 256, 256, 32, 16),
               ("fit_d160", 400_000, 160, 32, 16),
               ("d512", 8192, 512, 8, 4),
               ("d1000", 8192, 1000, 8, 4),
               ("serve_d32_8192", 8192, 32, 32, 17),
               ("serve_d128_8192", 8192, 128, 32, 17),
               ("serve_d32_256", 256, 32, 32, 17),
               ("fit_d32", 1_000_000, 32, 64, 17),
               ("fit_d128", 200_000, 128, 32, 16),
               ("ragged", 100_003, 33, 64, 17),
               ("serve_d8_8192", 8192, 8, 32, 17),
               ("serve_d16_8192", 8192, 16, 32, 17),
               ("d8", 1_000_000, 8, 64, 17),
               ("d16", 1_000_000, 16, 64, 17))
# the bits grid of assign_gauss and loglik at d <= 128, and its edge cases
# (N = 4097, 17 slots): no slot active, one active, an inactive slot whose
# draw lies in the Threefry top bin (+inf); and many live slots (90 % of
# 4097) at N = 40,000, where a block lists its live slots in chunks
BITS_GAUSS_D = (1, 4, 16, 17, 31, 32, 33, 64, 65, 127, 128)
BITS_GAUSS_K = (1, 2, 5, 17, 32, 64, 300, 2049, 4097)
BITS_GAUSS_N = (1, 127, 128, 129, 4097, 8192)
GAUSS_KINDS = ("inactive", "one_active", "top_bin")
GAUSS_MANY = ((40_000, 32, 4097), (40_000, 128, 4097))
# and past d = 128 (the panel layout; several slot groups at 8192 rows)
GAUSS_PANEL = ((1, 129, 5), (8192, 129, 32), (8192, 300, 17),
               (300, 300, 5), (4097, 257, 300))
# (name, N, d, K slots, live slots): suffstats_labels at the Gaussian
# fits' split/merge folds and a ragged N at an odd width
STATS_CASES = (("fit_d32", 1_000_000, 32, 64, 17),
               ("fit_d128", 200_000, 128, 64, 16),
               ("fit_d256", 400_000, 256, 32, 16),
               ("ragged", 100_003, 33, 64, 17))
# (name, N, d, K slots, live slots): the d = 256 fit's label folds whole,
# through the family's ``stats_from_labels`` (a checkout with stat
# windows runs suffstats_labels and the fold a window at a time): over its
# sweep's 32-slot slab and over its split/merge fold's 64 slots
LABEL_FOLD_CASES = (("fold_d256_k32", 400_000, 256, 32, 16),
                    ("fold_d256_k64", 400_000, 256, 64, 16))
# (name, N, d, K slots, live slots): sweep_gauss at the one-read fits'
# final states, a ragged N, and the d = 32 fit's state at d = 8 and 16,
# where step (e) runs in the (f) + fold block (below sweep.TE_MIN_D)
SWEEP_CASES = (("fit_d32", 1_000_000, 32, 64, 17),
               ("fit_d128", 200_000, 128, 32, 16),
               ("ragged", 100_003, 33, 64, 17),
               ("d8", 1_000_000, 8, 64, 17),
               ("d16", 1_000_000, 16, 64, 17))
# (name, N, d, K slots, live slots): sub_assign_gauss at the Gaussian
# fits' states (the sweep group's operands; labels from assign_gauss, which
# are the sweep's), a ragged N at an odd width, and d = 64 and 65, the two
# sides of assign.sub_plan's route switch
SUB_CASES = (("fit_d256", 400_000, 256, 32, 16),
             ("fit_d128", 200_000, 128, 32, 16),
             ("fit_d32", 1_000_000, 32, 64, 17),
             ("ragged", 100_003, 33, 64, 17),
             ("d64", 200_000, 64, 32, 16),
             ("d65", 200_000, 65, 32, 16))
# (name, family, generator, N, d, true clusters, seed, compact slots):
# sweep_linear at the 20newsgroups width (chip_smoke.py's news20 state),
# the diagonal-Gaussian pack (d' = 2 d), a Poisson state, a ragged N at
# an odd d' (the scalar path) and d' = 64 / 68, the two sides of
# linear_plan's step-(f) route switch; "fit_multinomial" is the
# multinomial fit's final state (chip_smoke.py fit_linear_args)
LINEAR_CASES = (("news20", "multinomial", "generate_mnmm", 11_314, 20_000,
                 20, 0, 32),
                ("diag_gaussian", "diag_gaussian", "generate_gmm",
                 1_000_000, 32, 16, 1, 32),
                ("poisson", "poisson", "generate_pmm", 1_000_000, 32, 16, 1,
                 32),
                ("ragged", "multinomial", "generate_mnmm", 100_003, 33, 16,
                 1, 32),
                ("d64", "multinomial", "generate_mnmm", 1_000_000, 64, 16,
                 1, 32),
                ("d68", "multinomial", "generate_mnmm", 1_000_000, 68, 16,
                 1, 32))
LINEAR_FIT = (1_000_000, 128, 16)
KERNEL_GROUPS = ("dense", "matmul", "gauss", "stats", "sweep", "sub",
                 "linear", "moments", "fold")
BITS_STATS_D = (1, 3, 4, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 200,
                255, 256)
BITS_SWEEP_D = (1, 3, 4, 31, 32, 33, 63, 64, 65, 100, 127, 128)
BITS_SUB_D = (1, 3, 4, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 160,
              200, 255, 256)
BITS_LINEAR_D = (1, 3, 4, 24, 64, 65, 127, 128, 129, 1000, 20_000)
BITS_LINEAR_K = (1, 2, 17, 64, 300, 2048)
BITS_LINEAR_N = (1, 1023, 1025, 11_314)
# and past the one-read sweep's 2048 slots (assign_linear and
# sub_assign_linear take any K; the sweep's refusal is kept as its message)
BITS_LINEAR_BIG_D = (1, 3, 24, 64, 65, 128, 129, 20_000)
BITS_LINEAR_BIG_K = (2049, 4096, 10_000)
BITS_LINEAR_BIG_N = (1, 1025, 4097)
# (name, family, generator, N, d, true clusters, seed, compact slots):
# assign_linear and sub_assign_linear alone at chip_smoke.py's serving
# steps (8192 rows, 32 slots, 17 live: multinomial d' = 128, diagonal
# Gaussian d' = 64), the three-pass multinomial fit's state (2e5 x 128) and
# the one-read fit's (10^6 x 128; 32 slots, 16 live), and the 20newsgroups
# width; sweep_linear's (e) + (f) launch is split out beside them
LINEAR_STEP_CASES = (
    ("serve_multinomial", "multinomial", "generate_mnmm", 8192, 128, 17, 2,
     32),
    ("serve_diag_gaussian", "diag_gaussian", "generate_gmm", 8192, 32, 17,
     2, 32),
    ("multinomial_2e5", "multinomial", "generate_mnmm", 200_000, 128, 16, 1,
     32),
    ("multinomial_1e6", "multinomial", "generate_mnmm", 1_000_000, 128, 16,
     1, 32),
    ("news20", "multinomial", "generate_mnmm", 11_314, 20_000, 20, 0, 32))
BITS_GRID_K = (1, 2, 17, 64, 300)
BITS_GRID_N = (1, 1023, 1025, 4097)
# many slots: the stat and step-(f) kernels at K = 2048 and 8192 (8192
# is the most slots one launch takes; past it a call runs slot windows) and the one-read sweep at its K = 2048, over the
# widths either side of the Gram tile's and the tiled step (f)'s
# switches
BITS_BIG_K = (2048, 8192)
BITS_BIG_D = (1, 32, 128, 129, 256)
BITS_BIG_N = (1, 1025)
BITS_SWEEP_BIG_D = (1, 32, 128)
# moments_labels: d' either side of its 128-feature chunk, K to 8192
BITS_MOMENTS_D = (1, 3, 4, 32, 128, 129, 1000)
BITS_MOMENTS_K = (1, 2, 17, 300, 2048, 8192)
# the dense oracle: d either side of its column tiles, K to 8192
BITS_DENSE_D = (1, 7, 32, 128, 129, 256)
BITS_DENSE_K = (1, 17, 2048, 8192)
BITS_DENSE_N = (1, 1025)
# the fold: blocks x elements of one field, from a nonzero accumulator
BITS_FOLD_NB = (1, 2, 17, 56, 977)
BITS_FOLD_M = (1, 3, 4, 128, 4097, 131072, 1 << 20)
# the fold's timed case: the 10^6 x 32 fit's per-block partials (64
# slots, 17 live: sweep_gauss on the mixture of mixture_operands)
FOLD_FIT = (1_000_000, 32, 64, 17)
FP_CHUNK = 1 << 26
# the edge cases' N and K: four blocks and a ragged one, 17 slots
EDGE_N, EDGE_K = 4097, 17
BITS_M = (1, 255, 256, 8192)
BITS_K = (1, 32, 33, 128, 300)
BITS_N = (1, 16, 17, 32, 33, 64, 65)


def timed(fn, runs: int, cuda_ms, run_ms) -> dict:
    device, host = run_ms(fn, runs)
    return {"single_ms": cuda_ms(fn, runs), "device_ms": device,
            "host_ms": host}


def gauss_operands(n, d, k, live, dev, g):
    """``assign_gauss`` operands on the card: x and means of scale 3,
    factors I + 0.2 N(0, 1) / sqrt(d), the first ``live`` slots active,
    dense-slot counters of a slab twice as wide."""
    x = torch.randn(n, d, device=dev, generator=g) * 3
    mu = torch.randn(k, d, device=dev, generator=g) * 3
    f = (torch.randn(k, d, d, device=dev, generator=g) * (0.2 / d ** 0.5)
         + torch.eye(d, device=dev))
    ld = torch.randn(k, device=dev, generator=g)
    lw = torch.log_softmax(torch.randn(k, device=dev, generator=g), 0)
    act = (torch.arange(k, device=dev) < live).to(torch.int32)
    gidx = torch.arange(n, device=dev, dtype=torch.int64)
    kz = torch.tensor([5, 4_000_000_000], device=dev)
    slots = torch.randperm(2 * k, device=dev, generator=g)[:k].to(
        torch.int32)
    return x, mu, f, ld, lw, act, gidx, kz, slots


def gauss_routes(assign, d) -> dict:
    """The routes of ``assign_gauss`` / ``loglik`` to time at width d:
    the checkout's own plan ("kernel") and, at or below the d <= 16 switch
    of a checkout that has one (``assign.GAUSS_NARROW_D``), each side of
    it forced: the narrow in-block layout and the register tile."""
    if d > 16 or not hasattr(assign, "GAUSS_NARROW_D"):
        return {"kernel": None}
    return {"kernel": None, "kernel_narrow": 16, "kernel_tiled": 0}


def forced(assign, switch, fn):
    """``fn`` with ``assign.GAUSS_NARROW_D`` set to ``switch`` (None: as
    the checkout has it), the plan's cache cleared around it."""
    def run():
        if switch is None:
            return fn()
        keep = assign.GAUSS_NARROW_D
        assign.GAUSS_NARROW_D = switch
        assign.gauss_plan.cache_clear()
        try:
            return fn()
        finally:
            assign.GAUSS_NARROW_D = keep
            assign.gauss_plan.cache_clear()
    return run


def time_gauss(assign, loglik, bound, cuda_ms, run_ms, dev, g) -> dict:
    out = {}
    for name, n, d, k, live in GAUSS_CASES:
        a = gauss_operands(n, d, k, live, dev, g)
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
            for route, switch in gauss_routes(assign, d).items():
                fn = forced(assign, switch, cuda)
                try:
                    fn()
                except ValueError as e:
                    t["refused"] = str(e)
                else:
                    t[route] = timed(fn, runs, cuda_ms, run_ms)
            t["plain"] = timed(plain, 3, cuda_ms, run_ms)
            r[kern] = t
        out[name] = r
        del a
        torch.cuda.empty_cache()
    return out


def top_bin_slot(kz, gidx, lo: int) -> tuple:
    """(point, slot id >= lo) whose Threefry draw under key ``kz`` lies in
    the top bin (a +inf Gumbel), the least such slot id found, searched
    in chunks of 4096 ids over the points' counters ``gidx``."""
    from repro_torch.kernels import prng
    for c0 in range(lo, lo + 64 * 4096, 4096):
        c = torch.arange(c0, c0 + 4096, device=gidx.device)
        bits, _ = prng.threefry2x32(kz[0], kz[1], gidx[:, None], c[None, :])
        hit = torch.nonzero(bits >= 0xFFFFFF00)
        if hit.numel():
            p, j = (int(v) for v in hit[0])
            return p, c0 + j
    raise RuntimeError("no top-bin draw found")


def grid_gauss_args(n, d, k, dev, seed, kind="grid"):
    """Seeded ``assign_gauss`` operands of the bits grid (made with a
    generator on the card, so both checkouts get the same; ``loglik``
    takes the first four): about 60 % of the slots live; ``kind``
    "inactive": none live; "one_active": slot k // 2 alone; "top_bin":
    the first inactive slot gets a slot id whose draw for some point lies
    in the Threefry top bin; "many": 90 % live."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=g) * 3
    mu = torch.randn(k, d, device=dev, generator=g) * 3
    f = (torch.randn(k, d, d, device=dev, generator=g) * 0.2
         + torch.eye(d, device=dev))
    ld = torch.randn(k, device=dev, generator=g)
    lw = torch.log_softmax(torch.randn(k, device=dev, generator=g), 0)
    u = torch.rand(k, device=dev, generator=g)
    act = (u < (0.9 if kind == "many" else 0.6)).to(torch.int32)
    act[0] = 1
    gidx = torch.arange(n, device=dev, dtype=torch.int64) + 7
    kz = torch.randint(0, 1 << 32, (2,), device=dev, generator=g,
                       dtype=torch.int64)
    slots = torch.randperm(2 * k, device=dev, generator=g)[:k].to(
        torch.int32)
    if kind == "inactive":
        act.zero_()
    elif kind == "one_active":
        act.zero_()
        act[k // 2] = 1
    elif kind == "top_bin":
        act[1] = 0
        _, sid = top_bin_slot(kz, gidx, 2 * k)
        slots[1] = sid
    return (x, mu, f, ld, lw, act, gidx, kz, slots)


def gauss_bits_cases():
    """(name, n, d, k, kind) of the assign_gauss / loglik bits grid."""
    yield from bits_cases(BITS_GAUSS_D, BITS_GAUSS_K, BITS_GAUSS_N,
                          GAUSS_KINDS)
    for n, d, k in GAUSS_MANY:
        yield f"many_{n}x{d}x{k}", n, d, k, "many"
    for n, d, k in GAUSS_PANEL:
        yield f"panel_{n}x{d}x{k}", n, d, k, "grid"


def gauss_bits(assign, loglik):
    """Both kernels' outputs on the bits grid's operands: the labels,
    then the log-likelihood rows."""
    return lambda *a: (assign.assign_gauss_cuda(*a),
                       loglik.loglik_cuda(*a[:4]))


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
    wrapping, taken in chunks of FP_CHUNK words so a tensor of 2^30 words
    needs no 32 GB of temporaries): equal tensors give equal sums, and a
    changed bit anywhere changes the sum but for a 2^-64 chance."""
    words = t.contiguous().view(torch.int32).flatten()
    total = 0
    for s in range(0, words.numel(), FP_CHUNK):
        bits = words[s:s + FP_CHUNK].to(torch.int64)
        pos = torch.arange(s, s + bits.numel(), device=t.device,
                           dtype=torch.int64)
        w = (pos * 2654435761 + 97) % 2147483647 + 1
        total = (total + int((bits * w).sum())) % (1 << 64)
    return total


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


def grid_sub_args(n, d, k, dev, seed, kind="grid"):
    """Seeded ``sub_assign_gauss`` operands of the bits grid (made with a
    generator on the card, so both checkouts get the same): labels in
    [-1, k] (outside [0, k) they get sub-label 0); ``kind`` "one_label":
    every label k // 2; "distinct": a permutation of k = n labels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=g) * 3
    smu = torch.randn(k, 2, d, device=dev, generator=g) * 3
    sf = (torch.randn(k, 2, d, d, device=dev, generator=g) * 0.2
          + torch.eye(d, device=dev))
    sld = torch.randn(k, 2, device=dev, generator=g)
    slw = torch.log_softmax(torch.randn(k, 2, device=dev, generator=g), 1)
    if kind == "one_label":
        lab = torch.full((n,), k // 2, device=dev, dtype=torch.int32)
    elif kind == "distinct":
        lab = torch.randperm(k, device=dev, generator=g).to(torch.int32)
    else:
        lab = torch.randint(-1, k + 1, (n,), device=dev, generator=g,
                            dtype=torch.int32)
    gidx = torch.arange(n, device=dev, dtype=torch.int64) + 7
    kzb = torch.randint(0, 1 << 32, (2,), device=dev, generator=g,
                        dtype=torch.int64)
    return (x, smu, sf, sld, slw, lab, gidx, kzb)


def grid_linear_args(n, dp, k, dev, seed, kind="grid"):
    """Seeded ``sweep_linear`` operands of the bits grid (made on the
    card): Poisson counts, log-probability weights, about 60 % of the slots
    live; ``kind`` as in ``grid_sweep_args``, and "misaligned": the
    features a contiguous view one float into its buffer (the scalar
    path)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.poisson(torch.full((n, dp), 3.0, device=dev), generator=g)
    logp = lambda *s: torch.log_softmax(
        torch.randn(*s, device=dev, generator=g) * 2, -1)
    w = logp(k, dp)
    cst = torch.randn(k, device=dev, generator=g)
    lw = torch.log_softmax(torch.randn(k, device=dev, generator=g), 0)
    act = (torch.rand(k, device=dev, generator=g) < 0.6).to(torch.int32)
    act[0] = 1
    subw = logp(k, 2, dp)
    subc = torch.randn(k, 2, device=dev, generator=g)
    slw = torch.log_softmax(torch.randn(k, 2, device=dev, generator=g), 1)
    valid = torch.ones(n, device=dev)
    if kind == "empty":
        valid.zero_()
    elif kind == "valid_zeros":
        valid = (torch.rand(n, device=dev, generator=g) < 0.5).float()
    elif kind == "one_segment":
        act.zero_()
        act[k // 2] = 1
        subc[:, 1] -= 1e4
    elif kind == "misaligned":
        buf = torch.empty(n * dp + 1, device=dev)
        buf[1:] = feats.flatten()
        feats = buf[1:].view(n, dp)
    gidx = torch.arange(n, device=dev, dtype=torch.int64) + 7
    kz = torch.randint(0, 1 << 32, (2,), device=dev, generator=g,
                       dtype=torch.int64)
    kzb = torch.randint(0, 1 << 32, (2,), device=dev, generator=g,
                        dtype=torch.int64)
    slots = torch.randperm(2 * k, device=dev, generator=g)[:k].to(
        torch.int32)
    return (feats, w, cst, lw, act, subw, subc, slw, valid, gidx, kz, kzb,
            slots)


def bits_cases(ds, ks=BITS_GRID_K, ns=BITS_GRID_N,
               kinds=("empty", "one_segment", "valid_zeros")):
    """(name, n, d, k, kind) of the bits grid and its edge cases (the
    "distinct" kind at n = k = 1025)."""
    for d in ds:
        for k in ks:
            for n in ns:
                yield f"{n}x{d}x{k}", n, d, k, "grid"
        for kind in kinds:
            n, k = (1025, 1025) if kind == "distinct" else (EDGE_N, EDGE_K)
            yield f"{kind}_{n}x{d}x{k}", n, d, k, kind


def big_cases(ds, ks=BITS_BIG_K, ns=BITS_BIG_N):
    """(name, n, d, k, "grid") of a grid without edge cases (the many-slot
    shapes), named as ``bits_cases`` names its grid."""
    for d in ds:
        for k in ks:
            for n in ns:
                yield f"{n}x{d}x{k}", n, d, k, "grid"


def grid_moments_args(n, dp, k, dev, seed, kind="grid"):
    """Seeded ``moments_labels`` operands (made on the CPU): Poisson
    counts as features, labels in [-1, k], random sub-labels; ``kind`` as
    in ``grid_stats_args``."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.poisson(torch.full((n, dp), 3.0), generator=g)
    x, lab, sub, valid, _ = grid_stats_args(n, 1, k, torch.device("cpu"),
                                            seed, kind)
    return (feats.to(dev), lab.to(dev), sub.to(dev), valid.to(dev), k)


def grid_dense_args(n, d, k, dev, seed, kind="grid"):
    """Seeded dense-oracle operands (made on the card): points of scale 3
    and Dirichlet(1) responsibilities."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=g) * 3
    gam = torch._standard_gamma(torch.ones(n, k, device=dev), generator=g)
    return (x, gam / gam.sum(dim=1, keepdim=True))


def grid_fold_args(nb, m, k, dev, seed, kind="grid"):
    """Seeded fold operands (made on the card): a nonzero accumulator of
    m elements and nb blocks of partials of mixed scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.randn(m, device=dev, generator=g) * 100
    parts = (torch.randn(nb, m, device=dev, generator=g)
             * torch.rand(nb, 1, device=dev, generator=g) * 1e3)
    return (acc, parts)


def fold_cases():
    for nb in BITS_FOLD_NB:
        for m in BITS_FOLD_M:
            yield f"{nb}x{m}", nb, m, 0, "grid"


def time_fold(fold, sweep, bound, cuda_ms, run_ms, dev, prints) -> dict:
    """The fold of the 10^6 x 32 fit's per-block partials (n, sx, sxx of
    ``sweep_gauss`` on FOLD_FIT's mixture) from a nonzero accumulator: each
    field's ``fold_partials_cuda`` (one launch a field), and where the
    checkout has it the one launch of all three (``fold_fields_cuda``),
    held bitwise against the per-field folds and the plain loop of adds;
    each beside the bound of its bytes."""
    n, d, k, live = FOLD_FIT
    a, _ = mixture_operands(n, d, k, live, dev, seed=2)
    parts = sweep.sweep_gauss_cuda(*a)[2:]
    del a
    g = torch.Generator(device=dev).manual_seed(5)
    accs = [torch.randn(p.shape[1:], device=dev, generator=g) * 10
            for p in parts]
    out = {"n": n, "d": d, "k": k, "k_live": live, "blocks": parts[0].shape[0]}
    want = [fold.fold_partials_plain(c, p) for c, p in zip(accs, parts)]
    per = []
    total_bytes = 0
    for name, c, p, w in zip(("n", "sx", "sxx"), accs, parts, want):
        got = fold.fold_partials_cuda(c, p)
        if not torch.equal(got, w):
            raise SystemExit(f"time_kernels: fold ({name}) is not the loop "
                             "of adds")
        prints[f"fit_{name}"] = [fingerprint(got)]
        nbytes = 4 * (p.numel() + 2 * c.numel())
        total_bytes += nbytes
        r = {"elements": c.numel(),
             "kernel": timed(lambda: fold.fold_partials_cuda(c, p), 20,
                             cuda_ms, run_ms)}
        r["bound_ms"], r["bound_by"] = bound(p.numel(), nbytes)
        out[name] = r
        per.append(r["kernel"]["device_ms"])
    out["per_field_device_ms_sum"] = float(sum(per))
    out["bound_ms"], out["bound_by"] = bound(
        sum(p.numel() for p in parts), total_bytes)
    if hasattr(fold, "fold_fields_cuda"):
        got = fold.fold_fields_cuda(accs, parts)
        if not all(torch.equal(u, v) for u, v in zip(got, want)):
            raise SystemExit("time_kernels: the one-launch fold is not the "
                             "loop of adds")
        out["one_launch"] = {
            "kernel": timed(lambda: fold.fold_fields_cuda(accs, parts), 20,
                            cuda_ms, run_ms),
            "bitwise_loop_of_adds": True}
    return out


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
    from repro_torch.core.family import get_family
    fam = get_family("gaussian")
    for name, n, d, k, live in LABEL_FOLD_CASES:
        a, z = mixture_operands(n, d, k, live, dev, seed=1)
        sub = (a[0][:, 0] > a[1][z.long(), 0]).to(torch.int32)
        x, valid = a[0], a[10]
        del a

        def call():
            return fam.stats_from_labels(x, valid, z, sub, k)
        r = {"n": n, "d": d, "k": k, "k_live": live,
             "windows": (len(fam.windows(x, k)) if hasattr(fam, "windows")
                         else 1)}
        r["kernel"] = timed(call, 5, cuda_ms, run_ms)
        r["split"] = kernel_split(call, 3)
        out[name] = r
        del x, valid, z, sub
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


def sub_work(n, d, k):
    """(FLOP, bytes) of ``sub_assign_gauss``: two whitening products a
    point, x, labels, indices and sub-labels, and the sub-components."""
    return (4 * n * d * (d + 1), 4 * n * d + 16 * n + 8 * k * (d * d + d + 2))


def time_sub(assign, bound, cuda_ms, run_ms, dev, prints) -> dict:
    out = {}
    for name, n, d, k, live in SUB_CASES:
        a, _ = mixture_operands(n, d, k, live, dev, seed=2)
        lab = assign.assign_gauss_cuda(*(a[:6] + (a[11], a[12], a[14])))
        f_args = (a[0], a[6], a[7], a[8], a[9], lab, a[11], a[13])
        r = {"n": n, "d": d, "k": k, "k_live": live}
        r["bound_ms"], r["bound_by"] = bound(*sub_work(n, d, k))
        prints[f"fit_{name}"] = [fingerprint(
            assign.sub_assign_gauss_cuda(*f_args))]
        runs = 10 if n * d * d > 10 ** 10 else 20
        r["kernel"] = timed(lambda: assign.sub_assign_gauss_cuda(*f_args),
                            runs, cuda_ms, run_ms)
        r["plain"] = {"single_ms": cuda_ms(
            lambda: assign.sub_assign_gauss_plain(*f_args), 1)}
        r["split"] = kernel_split(
            lambda: assign.sub_assign_gauss_cuda(*f_args), 5)
        out[name] = r
        del a, lab, f_args
        torch.cuda.empty_cache()
    return out


def linear_work(args):
    """(FLOP, bytes) of ``sweep_linear`` on ``args`` (chip_smoke.py
    time_linear's count) and the Threefry draws it makes: one a (point,
    slot) of step (e), two a point of step (f)."""
    feats = args[0]
    n, dp = feats.shape
    k = args[1].shape[0]
    live = int(args[4].sum())
    nsb = -(-n // 1024)
    return ((2 * n * dp * (live + 3),
             n * dp * 4 + n * (4 + 8) + 8 * n + k * (3 * dp + 6) * 4
             + nsb * 2 * k * (1 + dp) * 4),
            {"step_e_live": n * live, "step_e_inactive": n * (k - live),
             "step_f": 2 * n})


def linear_states(dev):
    """(name, operands) of the linear group: the multinomial fit's final
    state (a fit of LINEAR_FIT's mixture as chip_smoke.py runs it) and the
    synthetic states of LINEAR_CASES."""
    from chip_smoke import FIT_CFG, fit_linear_args, linear_sweep_args
    from repro_torch.configs import DPMMConfig
    from repro_torch.core import gibbs, sampler
    from repro_torch.core.family import get_family
    from repro_torch.core.sampler import DPMM
    from repro_torch.data import synthetic
    n, d, k = LINEAR_FIT
    x_np, _ = synthetic.generate_mnmm(n, d, k, seed=1)
    res = DPMM(DPMMConfig(component="multinomial", **FIT_CFG)).fit(x_np)
    gen = torch.Generator(device=dev).manual_seed(6)
    args, _ = fit_linear_args(get_family("multinomial"), res.state,
                              torch.as_tensor(x_np, device=dev), gibbs,
                              sampler, gen)
    yield "fit_multinomial", args
    del args, res
    for name, fam, make, n, d, k_true, seed, k_c in LINEAR_CASES:
        x_np, y_np = getattr(synthetic, make)(n, d, k_true, seed=seed)
        yield name, linear_sweep_args(get_family(fam),
                                      torch.as_tensor(x_np, device=dev),
                                      y_np, k_c, dev)


def time_linear_group(sweep, assign, suffstats, bound, cuda_ms, run_ms, dev,
                      prints) -> dict:
    out = {}
    for name, a in linear_states(dev):
        n, dp = a[0].shape
        k = a[1].shape[0]
        work, draws = linear_work(a)
        r = {"n": n, "d_feat": dp, "k": k, "k_live": int(a[4].sum()),
             "draws": draws}
        r["bound_ms"], r["bound_by"] = bound(*work)
        res = sweep.sweep_linear_cuda(*a)
        prints[f"fit_{name}"] = [fingerprint(t) for t in res]
        r["kernel"] = timed(lambda: sweep.sweep_linear_cuda(*a), 20, cuda_ms,
                            run_ms)
        r["plain"] = {"single_ms": cuda_ms(
            lambda: sweep.sweep_linear_plain(*a), 1)}
        r["split"] = kernel_split(lambda: sweep.sweep_linear_cuda(*a), 10)
        # the three-pass kernels on the same operands: steps (e), (f) and
        # the fold, one at a time, with the sweep's own labels
        e_args = a[:5] + (a[9], a[10], a[12])
        f_args = (a[0], a[5], a[6], a[7], res[0], a[9], a[11])
        m_args = (a[0], res[0], res[1], a[8], k)
        r["three_pass"] = {
            "assign_linear": timed(lambda: assign.assign_linear_cuda(*e_args),
                                   20, cuda_ms, run_ms),
            "sub_assign_linear": timed(
                lambda: assign.sub_assign_linear_cuda(*f_args), 20, cuda_ms,
                run_ms),
            "moments_labels": timed(
                lambda: suffstats.moments_labels_cuda(*m_args), 20, cuda_ms,
                run_ms)}
        out[name] = r
        del a, res, e_args, f_args, m_args
        torch.cuda.empty_cache()
    return out


def linear_e_args(a):
    """``assign_linear``'s operands from ``sweep_linear``'s."""
    return a[:5] + (a[9], a[10], a[12])


def linear_f_args(a, labels=None):
    """``sub_assign_linear``'s operands from ``sweep_linear``'s, with
    ``labels`` or, by default, labels in [-1, K] made from the global
    indices (outside [0, K): sub-label 0)."""
    if labels is None:
        k = a[1].shape[0]
        labels = ((a[9] * 2654435761) % (k + 2) - 1).to(torch.int32)
    return (a[0], a[5], a[6], a[7], labels, a[9], a[11])


def linear_step_work(a, step: str):
    """(FLOP, bytes) of ``assign_linear`` ("e": live slots only) or
    ``sub_assign_linear`` ("f") on ``sweep_linear`` operands ``a``: each
    input read once, each output written once."""
    n, dp = a[0].shape
    k = a[1].shape[0]
    if step == "e":
        live = int(a[4].sum())
        return (2 * n * live * dp,
                4 * n * dp + 12 * n + 4 * n + 4 * k * (dp + 4) + 16)
    return (4 * n * dp, 4 * n * dp + 16 * n + 4 * n + 8 * k * (dp + 2) + 16)


def time_linear_steps(sweep, assign, bound, cuda_ms, run_ms, dev) -> dict:
    """``assign_linear`` and ``sub_assign_linear`` alone at
    LINEAR_STEP_CASES (sub-labels under ``assign_linear``'s labels), each
    beside its bound and plain version, and the per-kernel split of
    ``sweep_linear`` on the same operands where the sweep takes them."""
    from chip_smoke import linear_sweep_args
    from repro_torch.core.family import get_family
    from repro_torch.data import synthetic
    out = {}
    for name, fam, make, n, d, k_true, seed, k_c in LINEAR_STEP_CASES:
        x_np, y_np = getattr(synthetic, make)(n, d, k_true, seed=seed)
        a = linear_sweep_args(get_family(fam), torch.as_tensor(
            x_np, device=dev), y_np, k_c, dev)
        e_args = linear_e_args(a)
        lab = assign.assign_linear_cuda(*e_args)
        f_args = linear_f_args(a, lab)
        r = {"n": a[0].shape[0], "d_feat": a[0].shape[1], "k": k_c,
             "k_live": int(a[4].sum())}
        for kern, fn, plain, args, step in (
                ("assign_linear", assign.assign_linear_cuda,
                 assign.assign_linear_plain, e_args, "e"),
                ("sub_assign_linear", assign.sub_assign_linear_cuda,
                 assign.sub_assign_linear_plain, f_args, "f")):
            t = timed(lambda: fn(*args), 50, cuda_ms, run_ms)
            t["bound_ms"], t["bound_by"] = bound(*linear_step_work(a, step))
            t["plain_single_ms"] = cuda_ms(lambda: plain(*args), 1)
            r[kern] = t
        r["sweep_split"] = kernel_split(lambda: sweep.sweep_linear_cuda(*a),
                                        10)
        out[name] = r
        print(json.dumps({f"linear_steps/{name}": r}), file=sys.stderr,
              flush=True)
        del a, e_args, f_args, lab
        torch.cuda.empty_cache()
    return out


def top_bin_draws(args) -> int:
    """(point, inactive slot) pairs of ``sweep_linear`` operands whose
    step-(e) draw lies in the Threefry top bin (an inactive slot's logit
    +inf), counted with the plain Threefry of ``kernels/prng.py``."""
    from repro_torch.kernels import prng
    slots = args[12][args[4] == 0].long()
    if slots.numel() == 0:
        return 0
    total = 0
    for g in args[9].split(4096):
        bits, _ = prng.threefry2x32(args[10][0], args[10][1], g[:, None],
                                    slots[None, :])
        total += int((bits >= 0xFFFFFF00).sum())
    return total


def bits_grid(fn, cases, make, prints, note=None, seed0=1000) -> None:
    """Fingerprints of ``fn``'s outputs over the bits grid ``cases``
    (``bits_cases``), the i-th case's operands seeded ``seed0 + i``; a
    shape the wrapper refuses is kept as its message. ``note(args)``, if
    given, is kept beside each shape's prints."""
    for i, (name, n, d, k, kind) in enumerate(cases):
        args = make(n, d, k, DEV, seed0 + i, kind)
        if note is not None:
            prints[f"{name}/note"] = note(args)
        try:
            res = fn(*args)
        except ValueError as e:
            prints[name] = str(e)
            continue
        if isinstance(res, torch.Tensor):
            res = (res,)
        prints[name] = [fingerprint(t) for t in res]
        del res, args
        torch.cuda.empty_cache()
    torch.cuda.synchronize()


# sources each group's kernels need
GROUP_SOURCES = {"dense": ("suffstats_dense",), "matmul": ("matmul",),
                 "gauss": ("assign_gauss", "loglik_gauss"),
                 "stats": ("suffstats_labels", "fold_partials"),
                 "sweep": ("sweep_gauss", "assign_gauss", "sub_assign_gauss",
                           "suffstats_labels"),
                 "sub": ("sub_assign_gauss", "assign_gauss"),
                 "linear": ("sweep_linear", "assign_linear",
                            "sub_assign_linear", "moments_labels"),
                 "moments": ("moments_labels",),
                 "fold": ("fold_partials", "sweep_gauss")}


def worker(src: str, save: str, groups, bits_only: bool) -> dict:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, src)
    from chip_smoke import bound, card, cuda_ms, dense_work, gauss_work, \
        run_ms
    from repro_torch.kernels import (assign, build, fold, loglik, matmul,
                                     suffstats, sweep)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"src": src, "build_s": build.build(sorted(
        {n for grp in groups for n in GROUP_SOURCES[grp]})),
           "ptxas": {n: [ln for ln in (build.ptxas_report(n) or "")
                         .splitlines() if "registers" in ln or "spill" in ln
                         or "Compiling" in ln]
                     for grp in groups for n in GROUP_SOURCES[grp]}}
    out.update({"nvidia_smi": card(), **{grp: {} for grp in KERNEL_GROUPS}})
    bits = {}
    g = torch.Generator(device=dev).manual_seed(0)
    timing = not bits_only
    if "stats" in groups:
        bits["stats"] = {}
        if timing:
            out["stats"] = time_stats(suffstats, gauss_work, bound, cuda_ms,
                                      run_ms, dev, bits["stats"])
        bits_grid(suffstats.suffstats_labels_cuda, bits_cases(BITS_STATS_D),
                  grid_stats_args, bits["stats"])
        bits_grid(suffstats.suffstats_labels_cuda, big_cases(BITS_BIG_D),
                  grid_stats_args, bits["stats"], seed0=5000)
    if "sweep" in groups:
        bits["sweep"] = {}
        if timing:
            out["sweep"] = time_sweep(sweep, assign, suffstats, gauss_work,
                                      bound, cuda_ms, run_ms, dev,
                                      bits["sweep"])
        bits_grid(sweep.sweep_gauss_cuda, bits_cases(BITS_SWEEP_D),
                  grid_sweep_args, bits["sweep"])
        bits_grid(sweep.sweep_gauss_cuda,
                  big_cases(BITS_SWEEP_BIG_D, (2048,), BITS_GRID_N),
                  grid_sweep_args, bits["sweep"], seed0=5000)
    if "sub" in groups:
        bits["sub"] = {}
        if timing:
            out["sub"] = time_sub(assign, bound, cuda_ms, run_ms, dev,
                                  bits["sub"])
        bits_grid(assign.sub_assign_gauss_cuda,
                  bits_cases(BITS_SUB_D, kinds=("one_label", "distinct")),
                  grid_sub_args, bits["sub"])
        bits_grid(assign.sub_assign_gauss_cuda,
                  big_cases(BITS_BIG_D, BITS_BIG_K, (1, 1025, 4097)),
                  grid_sub_args, bits["sub"], seed0=5000)
    if "linear" in groups:
        bits["linear"] = {}
        if timing:
            out["linear"] = time_linear_group(sweep, assign, suffstats,
                                              bound, cuda_ms, run_ms, dev,
                                              bits["linear"])
            out["linear_steps"] = time_linear_steps(
                sweep, assign, bound, cuda_ms, run_ms, dev)
        # the three kernels over one grid: the sweep (past 2048 slots its
        # refusal), steps (e) and (f) alone on the same operands (step (f)
        # under labels in [-1, K])
        for key, fn, note in (
                ("linear", sweep.sweep_linear_cuda, top_bin_draws),
                ("linear_assign",
                 lambda *a: assign.assign_linear_cuda(*linear_e_args(a)),
                 None),
                ("linear_sub",
                 lambda *a: assign.sub_assign_linear_cuda(*linear_f_args(a)),
                 None)):
            bits.setdefault(key, {})
            bits_grid(fn, bits_cases(BITS_LINEAR_D, BITS_LINEAR_K,
                                     BITS_LINEAR_N,
                                     ("empty", "one_segment", "valid_zeros",
                                      "misaligned")),
                      grid_linear_args, bits[key], note=note)
            bits_grid(fn, big_cases(BITS_LINEAR_BIG_D, BITS_LINEAR_BIG_K,
                                    BITS_LINEAR_BIG_N),
                      grid_linear_args, bits[key], seed0=5000)
    if "moments" in groups:
        bits["moments"] = {}
        bits_grid(suffstats.moments_labels_cuda,
                  bits_cases(BITS_MOMENTS_D, BITS_MOMENTS_K, BITS_GRID_N),
                  grid_moments_args, bits["moments"])
    if "fold" in groups:
        bits["fold"] = {}
        if timing:
            out["fold"] = time_fold(fold, sweep, bound, cuda_ms, run_ms, dev,
                                    bits["fold"])
        bits_grid(fold.fold_partials_cuda, fold_cases(), grid_fold_args,
                  bits["fold"])
    if "gauss" in groups:
        bits["gauss"] = {}
        if timing:
            out["gauss"] = time_gauss(assign, loglik, bound, cuda_ms,
                                      run_ms, dev, g)
        bits_grid(gauss_bits(assign, loglik), gauss_bits_cases(),
                  grid_gauss_args, bits["gauss"])
    if "dense" in groups:
        bits["dense"] = {}
        bits_grid(suffstats.suffstats_cuda,
                  big_cases(BITS_DENSE_D, BITS_DENSE_K, BITS_DENSE_N),
                  grid_dense_args, bits["dense"])
    for name, n, d, k, kind in (DENSE_CASES if "dense" in groups and timing
                                else ()):
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
        for m, k, n in MATMUL_CASES if timing else ():
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
    """The median of the value at ``path`` over the turns that have it (a
    profiler's split may miss an activity, such as a memset, in a turn)."""
    vals = []
    for t in turns:
        v = t
        for key in path:
            v = v.get(key) if isinstance(v, dict) else None
            if v is None:
                break
        if v is not None:
            vals.append(v)
    return float(np.median(vals)) if vals else float("nan")


def summary(trees, results) -> dict:
    """Per checkout, the median over its turns of every time."""
    out = {}
    for src in trees:
        turns = [r for r in results if r["src"] == src]
        s = {grp: {} for grp in KERNEL_GROUPS}
        for group in ("stats", "sweep", "sub", "linear"):
            for name, case in turns[0][group].items():
                row = {"bound_ms": case.get("bound_ms"),
                       "plain_single_ms": median_of(
                           turns, (group, name, "plain", "single_ms"))}
                for key in ("single_ms", "device_ms", "host_ms"):
                    row[f"kernel_{key}"] = median_of(
                        turns, (group, name, "kernel", key))
                for kern in case.get("three_pass", {}):
                    row[f"{kern}_device_ms"] = median_of(
                        turns, (group, name, "three_pass", kern,
                                "device_ms"))
                split = {kern for t in turns
                         for kern in t[group][name].get("split", {})}
                if split:
                    row["split_device_ms"] = {
                        kern: median_of(turns, (group, name, "split", kern))
                        for kern in sorted(split)}
                s[group][name] = row
        for name, case in turns[0]["gauss"].items():
            s["gauss"][name] = {}
            for kern in ("assign_gauss", "loglik"):
                row = {"bound_ms": case[kern]["bound_ms"]}
                for route in ("kernel", "kernel_narrow", "kernel_tiled",
                              "plain"):
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
        if turns[0]["fold"]:
            f = turns[0]["fold"]
            s["fold"] = {"bound_ms": f["bound_ms"], "per_field_device_ms_sum":
                         median_of(turns, ("fold", "per_field_device_ms_sum"))}
            for name in ("n", "sx", "sxx"):
                s["fold"][f"{name}_device_ms"] = median_of(
                    turns, ("fold", name, "kernel", "device_ms"))
            if "one_launch" in f:
                for key in ("single_ms", "device_ms", "host_ms"):
                    s["fold"][f"one_launch_{key}"] = median_of(
                        turns, ("fold", "one_launch", "kernel", key))
        for name in turns[0]["matmul"]:
            s["matmul"][name] = {
                f"{route}_{key}": median_of(turns, ("matmul", name, route,
                                                    key))
                for route in ("kernel", "torch_matmul")
                for key in ("single_ms", "device_ms", "host_ms")}
            s["matmul"][name]["bound_ms"] = turns[0]["matmul"][name][
                "bound_ms"]
        if turns[0].get("linear_steps"):
            s["linear_steps"] = {}
            for name, case in turns[0]["linear_steps"].items():
                row = {}
                for kern in ("assign_linear", "sub_assign_linear"):
                    row[kern] = {"bound_ms": case[kern]["bound_ms"]}
                    for key in ("single_ms", "device_ms", "host_ms",
                                "plain_single_ms"):
                        row[kern][key] = median_of(
                            turns, ("linear_steps", name, kern, key))
                row["sweep_split_device_ms"] = {
                    kern: median_of(turns, ("linear_steps", name,
                                            "sweep_split", kern))
                    for kern in sorted(case.get("sweep_split", {}))}
                s["linear_steps"][name] = row
        out[src] = s
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=None)
    ap.add_argument("--out", default="")
    ap.add_argument("--kernels", default=",".join(KERNEL_GROUPS),
                    help="comma-separated groups of " + ", ".join(
                        KERNEL_GROUPS))
    ap.add_argument("--bits-out", default="",
                    help="save the first checkout's bits to this file")
    ap.add_argument("--bits-against", default="",
                    help="compare each checkout's bits with a file that "
                    "--bits-out wrote")
    ap.add_argument("--bits-only", action="store_true",
                    help="keep the bits grids' fingerprints and time "
                    "nothing")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", default="", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    groups = opts.kernels.split(",")
    if not set(groups) <= set(KERNEL_GROUPS):
        raise SystemExit(f"time_kernels: --kernels takes {KERNEL_GROUPS}")
    if opts.worker:
        print(json.dumps(worker(opts.src[0], opts.save, groups,
                                opts.bits_only)), flush=True)
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
                 "--save", save, "--kernels", opts.kernels]
                + (["--bits-only"] if opts.bits_only else []),
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
        if opts.bits_out:
            Path(opts.bits_out).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(saved[trees[0]], opts.bits_out)
        if opts.bits_against:
            ref = torch.load(opts.bits_against)
            report["bitwise_against"] = {
                t: bits_report(ref, torch.load(saved[t])) for t in trees}
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text(json.dumps({"turns": results, **report},
                                             indent=1))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
