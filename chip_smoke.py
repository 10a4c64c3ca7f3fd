"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile TRACE.json]

Builds the port's ten CUDA kernels from ``src/repro_torch/csrc`` and
holds each against its plain PyTorch version on the card (phases
``kernel_check``: sweep_gauss, suffstats_labels; ``kernel_check_linear``:
sweep_linear, moments_labels, at the multinomial fit's width, the diagonal
Gaussian pack and the 20newsgroups width d' = 20,000;
``kernel_check_serve``: loglik_gauss, assign_gauss at d = 32 and 128,
assign_linear at d' = 128 and 20,000, matmul, at one serving step of
8192 rows). Then it runs
``DPMM.fit`` (k_max = 64, 40 iterations, 16 true clusters) on a
1,000,000 x 32 Gaussian mixture (``fit``), on a 1,000,000 x 128
multinomial mixture — the top of the paper's DPMNMM grid —
(``fit_multinomial``) and at 200,000 x 32 for the Poisson and diagonal
Gaussian families (``fit_poisson``, ``fit_diag_gaussian``). Each fit must
reach NMI >= 0.9 and launch every kernel of its path. The fits' model-side
draws (Dirichlet, Beta and NIW posterior for the Gaussian fit; Dirichlet,
Gamma and NIG posterior for the linear ones; on the card and on the CPU)
are held against their analytic moments (``model_draws``,
``model_draws_linear``), and each kernel and its plain version are timed
at the fits' final states (``kernel_times``, which also holds the linear
kernels against their plain versions at every linear fit's final state).
A Gaussian fit at 200,000 x 128 (``fit_gaussian_d128``) runs the wide
layout of the Gaussian kernels, and its final state holds sweep_gauss and
suffstats_labels against their plain versions and times them
(``kernels_d128``). The three-pass sweep (``gibbs.sweep_tile`` with
``fused=False``: ``assign``, ``sub_assign``, the stat fold) runs a
200,000 x 128 multinomial and a 200,000 x 32 Gaussian fit beside the
fused fits on the same data and seed (``fit_three_pass``: K trajectories,
the first iteration whose labels part, NMI, ms/iter). A 400,000 x 256
Gaussian fit (``fit_gaussian_d256``), past the one-read sweep's
d <= 128, runs every sweep through ``sweep_ref`` (``assign_gauss``,
``sub_assign_gauss``, ``suffstats_labels``); its final state, all its
points, holds those kernels and ``loglik_gauss`` against their plain
versions and times them (``kernels_d256``). The Gaussian,
multinomial, diagonal-Gaussian and d = 256 Gaussian fits are then
served: each is written with ``save_model`` and loaded by
``DPMMEngine.from_checkpoint`` (default
ladder 256/2048/8192), which answers 100,000 fresh rows of the fit's
mixture as one request and as requests of 1 to 9,000 rows (bitwise equal
to the same rows of the whole), is held against an engine on the kernels'
plain versions on the same card, must reach NMI >= 0.9 for ``predict``,
swaps to a redrawn model, and reports latency by request size
(``serve_<family>``, ``serve_gaussian_d256``). ``kernel_times`` also
times the serving kernels at one step. ``kernel_check_three_pass`` holds
``sub_assign_gauss`` (at the d = 32 fit's final state) and
``sub_assign_linear`` (at the multinomial and diagonal-Gaussian fits'
final states, the 20newsgroups width and the three-pass multinomial
fit's final state) against their plain versions and the one-read sweeps'
step (f), and the three-pass tile against the one-read tile on the same
states, and times both kernels. The kernels line gives each step-(f)
kernel's time at the final state of the fit whose launches it counts:
``sub_assign_gauss`` the d = 256 fit's, ``sub_assign_linear`` the
three-pass multinomial fit's.
``matmul_crossover`` times ``matmul`` against ``torch.matmul`` over a
ladder of sizes. Each phase prints one JSON line;
any failed check raises, so the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``.

``--profile TRACE.json`` adds two phases: after the Gaussian fit and after
the multinomial fit, the same fit again under ``torch.profiler``, reported
as device-busy time, idle share and the heaviest device-side events, with
the Chrome traces written to TRACE.json and TRACE_multinomial.json.

Needs a CUDA device and the repository's ``src/`` beside this file; it
exits non-zero without either. It imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM data-sheet peaks (dense, at the 700 W limit): HBM3 bytes/s and
# fp32 FLOP/s outside the tensor cores — the kernels use no tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_FLOP_S = 67e12

FIT_N, FIT_D, FIT_K = 1_000_000, 32, 16
FIT_CFG = dict(k_max=64, iters=40, burnout=10, log_every=10)
# the linear families' fits: (component, generator, N, d), 16 clusters
LINEAR_FITS = (("multinomial", "generate_mnmm", 1_000_000, 128),
               ("poisson", "generate_pmm", 200_000, 32),
               ("diag_gaussian", "generate_gmm", 200_000, 32))
# the 20newsgroups width (README, benchmarks/bench_real_data.py): N
# documents over a vocabulary of d' words, 20 topics, a 32-row slab
NEWS_N, NEWS_D, NEWS_K, NEWS_KC = 11_314, 20_000, 20, 32
CHECK_N = 131_072
# The Gaussian fit at the top of the paper's DPGMM grid (d = 128), cut to
# a fifth of N like the poisson and diag_gaussian fits.
D128_N, D128_D = 200_000, 128
# The Gaussian fit past the one-read sweep's d <= 128, through the
# three-pass sweep: twice the top of the DPGMM grid, N cut to 0.4. At a
# tenth (6,250 points a cluster) the NIW evidence prefers merging every
# pair of the 16 true clusters, so no sampler finds them; at 400,000 it
# splits every pair (tools/split_evidence.py). Its kernels are held and
# timed at its final state.
D256_N, D256_D = 400_000, 256
# The three-pass fits held against the fused fits on the same data and
# seed: (component, generator, d), at a fifth of N.
THREE_PASS_N = 200_000
THREE_PASS_FITS = (("multinomial", "generate_mnmm", 128),
                   ("gaussian", "generate_gmm", 32))
# Serving: the default ladder's largest step, the compact slab of the
# checks (17 live rows of 32), request sizes (a single row, ladder steps,
# a ragged 300, and longer than the largest step) and query rows.
SERVE_B, SERVE_KC, SERVE_LIVE = 8192, 32, 17
SERVE_SIZES = (1, 256, 300, 2048, 8192, 9000)
SERVE_ROWS = 100_000
# Log-likelihoods and products of kernel and plain version: fp32 sums in
# another order, relative to the array's scale.
SERVE_RTOL = 1e-5
# Labels of kernel and plain version may differ only where the two best
# logits are this close (relative): sums taken in another order.
TIE_RTOL = 1e-4
MAX_TIE_SHARE = 1e-4
# Stats partials: long float32 sums in another order.
STATS_RTOL = 1e-4
# Model-side draws: replicas per device, and the largest |z| allowed for
# an empirical mean against its analytic mean (standard errors from the
# analytic variances). About 10^5 means are tested per device; with normal
# tails a correct sampler exceeds 6.5 anywhere with chance below 1e-5,
# while a 1 % bias in the chi-square draws at the fit's state is ~30 z.
DRAWS = 256
Z_MAX = 6.5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int) -> float:
    """Median of ``runs`` single-call CUDA-event times, after a warm-up."""
    fn()
    times = []
    for _ in range(runs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def stats_err(got, want) -> float:
    """max |got - want| over the three partial arrays; raises unless n is
    exact and sx/sxx are within STATS_RTOL of the array's scale."""
    if not torch.equal(got[0], want[0]):
        fail("stat counts n differ between kernel and plain version")
    worst = 0.0
    for g, w in zip(got[1:], want[1:]):
        err = (g - w).abs()
        bound = STATS_RTOL * (w.abs() + w.abs().max())
        if bool((err > bound).any()):
            fail(f"stat partials beyond rtol {STATS_RTOL}: max err "
                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst


def near_ties(mismatches, args, out_k, out_p) -> int:
    """Count label mismatches (``mismatches``: the sweep's
    ``label_mismatches`` function); raise unless each is a near-tie of the
    two logits involved and there are at most MAX_TIE_SHARE of the
    points."""
    bad, not_ties = mismatches(args, out_k[0], out_k[1], out_p[0],
                               out_p[1], TIE_RTOL)
    if not_ties:
        fail(f"{not_ties} label mismatches are not near-ties")
    if bad > MAX_TIE_SHARE * args[0].shape[0]:
        fail(f"{bad} near-tie mismatches of {args[0].shape[0]} points")
    return bad


def synthetic_sweep_args(n, d, k, dev, seed=0):
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
    valid[-1000:] = 0.0
    gidx = torch.arange(n, dtype=torch.int64)
    kz = torch.randint(0, 1 << 32, (2,), generator=g, dtype=torch.int64)
    kzb = torch.randint(0, 1 << 32, (2,), generator=g, dtype=torch.int64)
    slots = torch.randperm(2 * k, generator=g)[:k].to(torch.int32)
    args = (x, mu, f, ld, lw, act, smu, sf, sld, slw, valid, gidx, kz, kzb,
            slots)
    return tuple(a.to(dev).contiguous() for a in args)


def fit_sweep_args(model, x, gibbs, sampler, generator):
    """The arguments the fit's next sweep would give the kernel: the final
    state's compact slab, as ``gibbs.sweep_tile`` builds it."""
    from repro_torch.core import niw
    k_max = model.active.shape[0]
    k_c = sampler._k_compact(int(model.k_hat), 2, k_max, 8) or k_max
    plan = gibbs.compaction_plan(model.active, k_c)
    p = gibbs.compact_gather(plan, model.params)
    sp = gibbs.compact_gather(plan, model.subparams)
    mu, f, ld, smu, sf, sld = niw.sweep_pack(p, sp)
    n = x.shape[0]
    dev = x.device
    kz = torch.randint(0, 1 << 32, (2,), generator=generator, device=dev)
    kzb = torch.randint(0, 1 << 32, (2,), generator=generator, device=dev)
    args = (x, mu, f, ld, gibbs.compact_gather(plan, model.logweights),
            gibbs.compact_gather(plan, model.active).to(torch.int32), smu,
            sf, sld, gibbs.compact_gather(plan, model.sub_logweights),
            torch.ones(n, device=dev), torch.arange(n, device=dev), kz, kzb,
            plan.slot_of_compact.to(torch.int32))
    return tuple(a.contiguous() for a in args), k_c


def max_z(samples, mean, var, mask=None) -> float:
    """Largest |z| of the empirical mean of ``samples`` ((draws, ...)) about
    its analytic ``mean``, in standard errors sqrt(var / draws)."""
    z = (samples.mean(0) - mean).abs() / (var / samples.shape[0]).sqrt()
    return float(z[mask].max() if mask is not None else z.max())


def check_model_draws(active, stats, substats, prior, alpha: float,
                      where: str) -> dict:
    """Steps (a)-(d) of the sampler drawn DRAWS times on ``where`` from
    one model state, each held against its analytic moments: Dirichlet
    weights and Beta sub-weights (mean and variance of pi), and the NIW
    posterior of every cluster and sub-cluster (E[Sigma^-1] = nu Psi^-1
    entry by entry with the Wishart variances, E[log|Sigma^-1|], and the
    mean of mu where nu > d + 9, so its t tails are light). Raises if any
    |z| exceeds Z_MAX."""
    from repro_torch.core import gibbs, niw
    dev = torch.device(where)
    g = torch.Generator(device=dev).manual_seed(2)
    act = active.to(dev)
    nk, nkl, nkr = (t.to(dev) for t in (stats.n, substats.n[:, 0],
                                         substats.n[:, 1]))
    pi = torch.stack([gibbs.sample_weights(g, act, nk, alpha).exp()
                      for _ in range(DRAWS)]).double()
    pl = torch.stack([gibbs.sample_subweights(g, act, nkl, nkr, alpha)[:, 0]
                      .exp() for _ in range(DRAWS)]).double()
    a = torch.where(act, nk.clamp(min=1e-2), 0.0).double()
    a0 = a.sum() + alpha
    bl, br = (nkl + alpha / 2).double(), (nkr + alpha / 2).double()
    z = {"weights": max_z(pi, a / a0, a * (a0 - a) / (a0 ** 2 * (a0 + 1)),
                          act),
         "subweights": max_z(pl, bl / (bl + br),
                             bl * br / ((bl + br) ** 2 * (bl + br + 1)),
                             act)}

    d = prior.m.shape[0]
    prior = niw.NIWPrior(*(t.to(dev) for t in (prior.m, prior.psi,
                                                 prior.kappa, prior.nu)))
    both = niw.GaussStats(*(torch.cat([u.to(dev), v.to(dev).flatten(0, 1)])
                            for u, v in ((stats.n, substats.n),
                                         (stats.sx, substats.sx),
                                         (stats.sxx, substats.sxx))))
    reps = niw.GaussStats(*(t.expand((DRAWS,) + t.shape).contiguous()
                            for t in (both.n, both.sx, both.sxx)))
    p = niw.sample_posterior(prior, reps, g)
    m_n, psi_n, kappa_n, nu_n = (t.double() for t in
                                 niw.posterior(prior, both))
    v = torch.linalg.inv(psi_n)
    vd = torch.diagonal(v, dim1=-2, dim2=-1)
    nu = nu_n[:, None, None]
    prec = (p.chol_prec @ p.chol_prec.transpose(-1, -2)).double()
    z["precision"] = max_z(prec, nu * v,
                           nu * (v * v + vd[:, :, None] * vd[:, None, :]))
    half = (nu_n[:, None] - torch.arange(d, dtype=torch.float64,
                                         device=dev)) / 2
    z["logdet_prec"] = max_z(
        p.logdet_prec.double(),
        torch.special.digamma(half).sum(-1) + d * math.log(2)
        - torch.linalg.slogdet(psi_n)[1],
        torch.special.polygamma(1, half).sum(-1))
    pd = torch.diagonal(psi_n, dim1=-2, dim2=-1)
    light = (nu_n > d + 9)[:, None].expand(-1, d)
    z["mu"] = max_z(p.mu.double(), m_n,
                    pd / (kappa_n * (nu_n - d - 1)).clamp(min=1e-9)[:, None],
                    light)
    worst = max(z.values())
    if not math.isfinite(worst) or worst > Z_MAX:
        fail(f"model-side draws on {where} off their analytic moments: "
             f"max |z| {z}")
    return z


def linear_sweep_args(family, x, y, k_c: int, dev, seed: int = 0):
    """``sweep_linear`` operands at points ``x`` with generator labels
    ``y``: a ``k_c``-row compact slab whose live rows are the posterior
    means of the true clusters and of a random split of each into two
    sub-clusters, the other rows inactive at the prior mean, with
    dense-slot Gumbel counters from a slab twice as wide — what a fit's
    sweep sees once it has found the clusters."""
    from repro_torch.configs import DPMMConfig
    from repro_torch.core.state import tree_map
    g = torch.Generator(device=dev).manual_seed(seed)
    n = x.shape[0]
    valid = torch.ones(n, device=dev)
    lab = torch.as_tensor(y, device=dev)
    sub = torch.randint(0, 2, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    prior = family.build_prior(DPMMConfig(), x.mean(dim=0, keepdim=True))
    stats2 = family.stats_from_labels(x, valid, lab, sub, k_c)
    stats = tree_map(lambda a: a.sum(dim=1), stats2)
    pack = family.module.sweep_pack(x, family.expected_params(prior, stats),
                          family.expected_params(prior, stats2))
    live = stats.n > 0
    logw = torch.where(live, torch.log(stats.n.clamp(min=1) / n), -1e30)
    words = lambda: torch.randint(0, 1 << 32, (2,), generator=g, device=dev)
    feats, w, const, subw, subconst = (t.contiguous() for t in pack)
    return (feats, w, const, logw, live.to(torch.int32), subw, subconst,
            torch.full((k_c, 2), math.log(0.5), device=dev), valid,
            torch.arange(n, device=dev), words(), words(),
            torch.randperm(2 * k_c, generator=g, device=dev)[:k_c]
            .to(torch.int32))


def fit_linear_args(family, model, x, gibbs, sampler, generator):
    """The operands the linear fit's next sweep would give the kernel: the
    final state's compact slab, packed as ``family.sweep`` packs it."""
    k_max = model.active.shape[0]
    k_c = sampler._k_compact(int(model.k_hat), 2, k_max, 8) or k_max
    plan = gibbs.compaction_plan(model.active, k_c)
    take = lambda t: gibbs.compact_gather(plan, t)
    feats, w, const, subw, subconst = family.module.sweep_pack(
        x, take(model.params), take(model.subparams))
    n, dev = x.shape[0], x.device
    words = lambda: torch.randint(0, 1 << 32, (2,), generator=generator,
                                  device=dev)
    args = (feats, w, const, take(model.logweights),
            take(model.active).to(torch.int32), subw, subconst,
            take(model.sub_logweights), torch.ones(n, device=dev),
            torch.arange(n, device=dev), words(), words(),
            plan.slot_of_compact.to(torch.int32))
    return tuple(a.contiguous() for a in args), k_c


def check_linear_kernels(args, k_sm: int, sweep, suffstats, gen) -> dict:
    """``sweep_linear`` and ``moments_labels`` on ``args`` against their
    plain versions: repeat launches bitwise equal, labels exact except
    near-ties, partials within STATS_RTOL; moments on random labels over
    ``k_sm`` clusters (the split/merge fold's width)."""
    feats, valid = args[0], args[8]
    out_k = sweep.sweep_linear_cuda(*args)
    out_k2 = sweep.sweep_linear_cuda(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_k2)):
        fail("sweep_linear: two launches on the same inputs differ")
    out_p = sweep.sweep_linear_plain(*args)
    ties = near_ties(sweep.label_mismatches_linear, args, out_k, out_p)
    err_sweep = stats_err(out_k[2:], suffstats.moments_labels_plain(
        feats, out_k[0], out_k[1], valid, args[1].shape[0]))
    n = feats.shape[0]
    lab = torch.randint(0, k_sm, (n,), generator=gen, device=feats.device,
                        dtype=torch.int32)
    sub = torch.randint(0, 2, (n,), generator=gen, device=feats.device,
                        dtype=torch.int32)
    m_k = suffstats.moments_labels_cuda(feats, lab, sub, valid, k_sm)
    m_k2 = suffstats.moments_labels_cuda(feats, lab, sub, valid, k_sm)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(m_k, m_k2)):
        fail("moments_labels: two launches on the same inputs differ")
    err_m = stats_err(m_k, suffstats.moments_labels_plain(feats, lab, sub,
                                                          valid, k_sm))
    return {"n": n, "d_feat": feats.shape[1],
            "sweep_linear": {"k": args[1].shape[0],
                             "k_live": int(args[4].sum()),
                             "near_tie_mismatches": ties,
                             "max_abs_err": err_sweep,
                             "repeat_bitwise": True},
            "moments_labels": {"k": k_sm, "max_abs_err": err_m,
                               "repeat_bitwise": True}}


def check_fit_state(family, res, x, gibbs, sampler, gen, sweep,
                    suffstats):
    """``sweep_linear`` and ``moments_labels`` at a linear fit's final
    state against their plain versions: the operands its next sweep would
    pack (labels exact except near-ties, partials within STATS_RTOL), and
    the split/merge fold of its final labels over the packed features.
    Returns the report, the sweep's operands and the fold's labels,
    sub-labels and width."""
    largs, k_c = fit_linear_args(family, res.state, x, gibbs, sampler, gen)
    feats, valid = largs[0], largs[8]
    out_k = sweep.sweep_linear_cuda(*largs)
    out_p = sweep.sweep_linear_plain(*largs)
    ties = near_ties(sweep.label_mismatches_linear, largs, out_k, out_p)
    err_sweep = stats_err(out_k[2:], suffstats.moments_labels_plain(
        feats, out_k[0], out_k[1], valid, k_c))
    k_sm = min(64, 2 * k_c)
    plan = gibbs.compaction_plan(res.state.active, k_sm)
    lab = plan.compact_of_slot[torch.as_tensor(
        res.labels, device=x.device).long()].to(torch.int32)
    sub = out_k[1]
    err_mom = stats_err(
        suffstats.moments_labels_cuda(feats, lab, sub, valid, k_sm),
        suffstats.moments_labels_plain(feats, lab, sub, valid, k_sm))
    report = {"n": feats.shape[0], "d_feat": feats.shape[1], "k_sweep": k_c,
              "k_live": int(largs[4].sum()), "k_stats": k_sm,
              "near_tie_mismatches": ties,
              "sweep_linear_max_abs_err": err_sweep,
              "moments_labels_max_abs_err": err_mom}
    return report, largs, lab, sub, k_sm


def run_fit(DPMM, cfg, x_np, y_np, kernels, gpu, phase: str):
    """``DPMM(cfg).fit`` on the card with every launch count set to 0 just
    before and read just after; emits ``phase`` and raises unless the
    output is well formed, NMI >= 0.9 and each of ``kernels`` launched.
    Returns the fit's result and its launch counts."""
    from repro_torch.kernels import ops
    model = DPMM(cfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = model.fit(x_np)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    nmi = res.nmi(y_np)
    hist_ok = all(np.isfinite(v).all() for v in res.history.values())
    steady = res.iter_times_s[cfg.log_every:]
    # points left in an inactive slot: the Threefry top bin's +inf Gumbel
    # (ROADMAP.md, faults), shown rather than gated
    in_inactive = int((~res.state.active.cpu()[
        torch.as_tensor(res.labels).long()]).sum())
    n, d = x_np.shape
    emit(phase, component=cfg.component, n=n, d=d,
         k_true=int(y_np.max()) + 1, k_found=res.k, nmi=nmi,
         ari=res.ari(y_np), iters=cfg.iters, wall_s=wall,
         steady_ms_per_iter=1e3 * float(np.mean(steady)),
         first_chunk_ms_per_iter=1e3 * float(np.mean(
             res.iter_times_s[:cfg.log_every])),
         peak_bytes=res.peak_bytes, launches=launches,
         launches_per_iter={k: v / cfg.iters for k, v in launches.items()},
         labels_in_inactive_slots=in_inactive,
         k_history=res.history["k"].tolist(), nvidia_smi=gpu)
    if res.labels.shape != (n,) or not hist_ok:
        fail(f"{phase}: output has the wrong shape or non-finite history")
    if nmi < 0.9:
        fail(f"{phase}: NMI {nmi:.4f} < 0.9")
    for name in kernels:
        if launches[name] == 0:
            fail(f"{phase}: kernel {name} was never launched by the fit")
    return res, launches


def check_linear_draws(family, active, stats, substats, prior,
                       where: str) -> dict:
    """The linear families' posterior draws (step (c)/(d)), DRAWS times on
    ``where`` for every cluster and sub-cluster of one state, held against
    their analytic moments: Dirichlet E theta = c / sum c (multinomial),
    Gamma E lambda = a_n / b_n (poisson), NIG E tau = a_n / b_n and
    E mu = m_n where a_n > 5, so the t tails of mu are light
    (diag_gaussian). Raises if any |z| exceeds Z_MAX."""
    import dataclasses
    dev = torch.device(where)
    g = torch.Generator(device=dev).manual_seed(2)
    mod = family.module
    prior = dataclasses.replace(prior, **{
        f.name: getattr(prior, f.name).to(dev)
        for f in dataclasses.fields(prior)
        if isinstance(getattr(prior, f.name), torch.Tensor)})
    both = family.stats_cls(**{
        f.name: torch.cat([getattr(stats, f.name).to(dev),
                           getattr(substats, f.name).to(dev).flatten(0, 1)])
        for f in dataclasses.fields(family.stats_cls)})
    reps = family.stats_cls(**{
        f.name: getattr(both, f.name).expand(
            (DRAWS,) + getattr(both, f.name).shape).contiguous()
        for f in dataclasses.fields(family.stats_cls)})
    p = family.sample_posterior(prior, reps, g)
    if family.name == "multinomial":
        c = mod.posterior(prior, both).double()
        tot = c.sum(-1, keepdim=True)
        z = {"theta": max_z(p.logtheta.double().exp(), c / tot,
                            c * (tot - c) / (tot ** 2 * (tot + 1)))}
    elif family.name == "poisson":
        a_n, b_n = (t.double() for t in mod.posterior(prior, both))
        b_n = b_n.expand_as(a_n)
        z = {"rate": max_z(p.log_rate.double().exp(), a_n / b_n,
                           a_n / b_n ** 2)}
    else:
        m_n, kappa_n, a_n, b_n = (t.double() for t in
                                  mod.posterior(prior, both))
        a = a_n[:, None].expand_as(b_n)
        z = {"precision": max_z(p.log_prec.double().exp(), a / b_n,
                                a / b_n ** 2),
             "mu": max_z(p.mu.double(), m_n,
                         b_n / (kappa_n[:, None] * (a - 1)).clamp(min=1e-9),
                         a > 5)}
    worst = max(z.values())
    if not math.isfinite(worst) or worst > Z_MAX:
        fail(f"{family.name} posterior draws on {where} off their analytic "
             f"moments: max |z| {z}")
    return z


def time_linear(args, lab, sub, k_sm: int, sweep, suffstats) -> dict:
    """Kernel and plain times of ``sweep_linear`` on ``args`` and of
    ``moments_labels`` on labels ``lab``/``sub`` over ``k_sm`` clusters,
    their bounds from these inputs, and ``library_ms``: one
    ``index_add_`` of valid * feats into the (nsb * 2 k_sm, d') partials,
    which computes the same sums in another order, with atomics."""
    feats, valid = args[0], args[8]
    n, dp = feats.shape
    k = args[1].shape[0]
    nsb = -(-n // suffstats.STATS_BLOCK)
    live = int(args[4].sum())
    out = {"n": n, "d_feat": dp, "k_sweep": k, "k_live": live, "k_stats": k_sm}
    out["sweep_linear"] = {
        "ms": cuda_ms(lambda: sweep.sweep_linear_cuda(*args), 20),
        "plain_ms": cuda_ms(lambda: sweep.sweep_linear_plain(*args), 3),
        # step (e) over the live slots, step (f) over two rows, the fold
        "flop": 2 * n * dp * (live + 3),
        "bytes": (n * dp * 4 + n * (4 + 8) + 8 * n + k * (3 * dp + 6) * 4
                  + nsb * 2 * k * (1 + dp) * 4),
        "library_ms": None}
    idx = ((torch.arange(n, device=feats.device) // suffstats.STATS_BLOCK)
           * (2 * k_sm) + 2 * lab.long() + sub.long())
    src = feats * valid[:, None]
    buf = torch.zeros(nsb * 2 * k_sm, dp, device=feats.device)
    out["moments_labels"] = {
        "ms": cuda_ms(lambda: suffstats.moments_labels_cuda(
            feats, lab, sub, valid, k_sm), 20),
        "plain_ms": cuda_ms(lambda: suffstats.moments_labels_plain(
            feats, lab, sub, valid, k_sm), 3),
        "flop": 2 * n * dp,
        "bytes": n * (4 * dp + 12) + nsb * 2 * k_sm * (1 + dp) * 4,
        "library_ms": cuda_ms(lambda: buf.index_add_(0, idx, src), 20)}
    for name in ("sweep_linear", "moments_labels"):
        r = out[name]
        r["bound_ms"], r["bound_by"] = bound(r["flop"], r["bytes"])
    return out


def bound(flop: float, nbytes: float):
    """(least ms, "operations" or "bytes") of work on the card's peaks."""
    t_ops = flop / PEAK_FP32_FLOP_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def gauss_work(n, d, k_c, n_act, k_sm) -> dict:
    """(FLOP, bytes) each Gaussian kernel needs: ``sweep_gauss`` on a
    ``k_c``-row slab with ``n_act`` live rows (step (e) over the live
    slots, step (f) over two sub-clusters, the sx/sxx fold; FMA = 2 FLOP,
    each input read once, labels and partials written once) and
    ``suffstats_labels`` over ``k_sm`` clusters."""
    nsb = -(-n // 1024)
    entries = 1 + d + d * d
    return {
        "sweep_gauss": (2 * n * d * d * (n_act + 2) + 2 * n * (d * d + d),
                        n * d * 4 + n * (4 + 8) + k_c * (d * d + d + 4) * 4
                        + k_c * 2 * (d * d + d + 2) * 4 + 8 * n
                        + nsb * 2 * k_c * entries * 4),
        "suffstats_labels": (2 * n * (d * d + d),
                             n * (4 * d + 12) + nsb * 2 * k_sm * entries * 4)}


# ---------------------------------------------------------------------------
# Serving: the four kernels of DPMMEngine's query and sample steps
# ---------------------------------------------------------------------------
def gauss_step_e_args(n, d, k, live, dev, seed=0):
    """``assign_gauss`` operands: ``n`` points, a ``k``-row slab with
    ``live`` active rows, dense-slot counters from a slab twice as wide."""
    a = synthetic_sweep_args(n, d, k, dev, seed)
    g = torch.Generator().manual_seed(seed + 1)
    act = torch.zeros(k, dtype=torch.int32)
    act[torch.randperm(k, generator=g)[:live]] = 1
    return (a[0], a[1], a[2], a[3], a[4], act.to(dev), a[11], a[12], a[14])


def rel_err(got, want, rtol: float, what: str) -> float:
    """max |got - want|; raises unless within ``rtol`` of the array's
    scale."""
    err = (got - want).abs()
    if bool((err > rtol * (want.abs() + want.abs().max())).any()):
        fail(f"{what}: beyond rtol {rtol}: max err {float(err.max())}")
    return float(err.max())


def check_serve_kernels(sweep, suffstats, assign, loglik, matmul, news_np,
                        dev) -> dict:
    """Each serving kernel against its plain version on the card at the
    serving step's B = SERVE_B rows: labels exact except float64-proven
    near-ties, log-likelihoods and products within SERVE_RTOL, repeat
    launches bitwise equal."""
    from repro_torch.core.family import get_family
    from repro_torch.data import synthetic
    out = {}
    for d in (32, 128):
        args = gauss_step_e_args(SERVE_B, d, SERVE_KC, SERVE_LIVE, dev,
                                 seed=d)
        ll = loglik.loglik_cuda(*args[:4])
        lab = assign.assign_gauss_cuda(*args)
        torch.cuda.synchronize()
        if not (torch.equal(ll, loglik.loglik_cuda(*args[:4]))
                and torch.equal(lab, assign.assign_gauss_cuda(*args))):
            fail(f"d={d}: two launches on the same inputs differ")
        ties = assign_ties(assign, True, args, lab,
                           assign.assign_gauss_plain(*args))
        out[f"gauss_d{d}"] = {
            "loglik_gauss_max_abs_err": rel_err(
                ll, loglik.loglik_plain(*args[:4]), SERVE_RTOL,
                f"loglik_gauss d={d}"),
            "assign_gauss_near_tie_mismatches": ties}
    fam = get_family("multinomial")
    for name, (xn, yn) in (
            ("linear_d128", synthetic.generate_mnmm(SERVE_B, 128, FIT_K,
                                                    seed=2)),
            ("linear_d20000", (news_np[0][:SERVE_B], news_np[1][:SERVE_B]))):
        la = linear_sweep_args(fam, torch.as_tensor(xn, device=dev), yn,
                               SERVE_KC, dev)
        # SERVE_LIVE live rows: the generator's clusters first
        act = torch.zeros_like(la[4])
        act[torch.argsort(1 - la[4], stable=True)[:SERVE_LIVE]] = 1
        args = la[:4] + (act,) + la[9:11] + (la[12],)
        lab = assign.assign_linear_cuda(*args)
        torch.cuda.synchronize()
        if not torch.equal(lab, assign.assign_linear_cuda(*args)):
            fail(f"assign_linear {name}: two launches differ")
        out[name] = {"d_feat": args[0].shape[1], "k_live": int(act.sum()),
                     "assign_linear_near_tie_mismatches": assign_ties(
                         assign, False, args, lab,
                         assign.assign_linear_plain(*args))}
    g = torch.Generator(device=dev).manual_seed(5)
    for m, k, n in ((SERVE_B, 32, 32), (300, 33, 17)):
        a = torch.randn(m, k, device=dev, generator=g)
        b = torch.randn(k, n, device=dev, generator=g)
        c = matmul.matmul_cuda(a, b)
        torch.cuda.synchronize()
        if not torch.equal(c, matmul.matmul_cuda(a, b)):
            fail(f"matmul {m}x{k}x{n}: two launches differ")
        out[f"matmul_{m}x{k}x{n}"] = {"max_abs_err": rel_err(
            c, matmul.matmul_plain(a, b), SERVE_RTOL, "matmul")}
    return out


def assign_ties(assign, gauss: bool, args, got, want) -> int:
    bad, not_ties = assign.assign_mismatches(gauss, args, got, want,
                                             TIE_RTOL)
    if not_ties:
        fail(f"{not_ties} step-(e) label mismatches are not near-ties")
    if bad > MAX_TIE_SHARE * args[0].shape[0] + 1:
        fail(f"{bad} near-tie mismatches of {args[0].shape[0]} points")
    return bad


def plain_family(fam):
    """``fam`` with its query likelihood and step (e) on the kernels'
    plain versions: the yardstick engine the kernel path is held
    against on the same card."""
    import dataclasses
    from repro_torch.core import diag_gaussian, multinomial, poisson
    from repro_torch.kernels import assign, loglik

    def ll(x, p):
        if fam.name == "gaussian":
            return loglik.loglik_plain(x, p.mu, p.chol_prec, p.logdet_prec)
        return {"diag_gaussian": diag_gaussian, "multinomial": multinomial,
                "poisson": poisson}[fam.name].loglik(x, p)

    def step_e(x, p, logw, active, gidx, key_z, slots):
        if fam.name == "gaussian":
            return assign.assign_gauss_plain(x, p.mu, p.chol_prec,
                                             p.logdet_prec, logw, active,
                                             gidx, key_z, slots)
        return assign.assign_linear_plain(*fam.module.assign_pack(x, p),
                                          logw, active, gidx, key_z, slots)
    return dataclasses.replace(fam, loglik_fn=ll, assign_step=step_e)


def logits64(fam, engine, x, rows, key_words=None):
    """float64 (len(rows), K_max) logits of ``rows`` under the engine's
    model (plus the Gumbel noise of a draw with ``key_words``): the
    referee of near-ties between two float32 paths."""
    from repro_torch.kernels import loglik, prng
    ops_ = engine._served.ops
    p = type(ops_.params)(**{k: v.double() for k, v in
                             vars(ops_.params).items()})
    xr = torch.as_tensor(x[rows], device=engine.device).double()
    if fam.name == "gaussian":
        ll = loglik.loglik_plain(xr, p.mu, p.chol_prec, p.logdet_prec)
    else:
        ll = fam.module.loglik(xr, p)
    t = torch.where(ops_.active[None, :], ll + ops_.logw.double()[None, :],
                    -1e30)
    if key_words is not None:
        t = t + prng.gumbel(torch.as_tensor(key_words,
                                            device=engine.device),
                            torch.as_tensor(rows, device=engine.device)
                            [:, None], ops_.slots[None, :]).double()
    dense = torch.full((len(rows), engine.k_max), -1e30, dtype=torch.float64,
                       device=engine.device)
    dense[:, ops_.slots] = t
    return dense.cpu().numpy()


def label_ties(fam, engine, x, a, b, key_words=None) -> int:
    """Rows where labellings ``a`` and ``b`` differ; raises unless each is
    a float64-proven near-tie and they are few."""
    rows = np.flatnonzero(a != b)
    if rows.size == 0:
        return 0
    t = logits64(fam, engine, x, rows, key_words)
    i = np.arange(rows.size)
    ta, tb = t[i, a[rows]], t[i, b[rows]]
    gap = np.abs(ta - tb) / np.maximum(1.0, np.maximum(np.abs(ta),
                                                       np.abs(tb)))
    if (gap > TIE_RTOL).any():
        fail(f"{int((gap > TIE_RTOL).sum())} served label mismatches are "
             "not near-ties")
    if rows.size > MAX_TIE_SHARE * a.size + 1:
        fail(f"{rows.size} near-tie mismatches of {a.size} served rows")
    return int(rows.size)


def serve_model(name, res, fam_name, xq, yq, x_fit, tmp, gpu) -> dict:
    """Drive ``DPMMEngine`` on the fit ``res``: checkpoint -> engine ->
    requests of SERVE_SIZES rows and one of all rows -> checks -> swap ->
    latency. The launch counts are set to 0 just before and read just
    after. Returns the phase's report, with the engine and the request
    rows for the timings."""
    from repro_torch.core import checkpoint, gibbs
    from repro_torch.configs import DPMMConfig
    from repro_torch.core.family import get_family
    from repro_torch.core.metrics import nmi
    from repro_torch.kernels import ops
    from repro_torch.serve.dpmm import DPMMEngine
    fam = get_family(fam_name)
    path = checkpoint.save_model(str(tmp / f"{name}.npz"), res.state,
                                 fam_name)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    eng = DPMMEngine.from_checkpoint(path)
    build_s = time.perf_counter() - t0
    words = np.array([0x1234567, 0x89ABCDEF], np.int64)
    whole = eng.query(xq, sample=True, key_words=words)
    start = 0
    for n in SERVE_SIZES:
        part = eng.query(xq[start:start + n])
        same = all(np.array_equal(getattr(part, f),
                                  getattr(whole, f)[start:start + n])
                   for f in ("labels", "logprobs", "log_predictive"))
        # a draw counts on the request's own row index: the same rows
        # from row 0 again give the whole request's first draws
        again = eng.sample(xq[:n], key_words=words)
        if not same or not np.array_equal(again, whole.sampled_labels[:n]):
            fail(f"serve {name}: a {n}-row request differs from the same "
                 "rows inside the whole request")
        start += n
    launches = ops.launch_counts()
    want = {"gaussian": ("loglik_gauss", "assign_gauss"),
            "diag_gaussian": ("matmul", "assign_linear"),
            "multinomial": ("matmul", "assign_linear")}[fam_name]
    for k in want:
        if launches[k] == 0:
            fail(f"serve {name}: kernel {k} was never launched")
    # the plain-path engine on the same card
    plain = DPMMEngine(eng.model, plain_family(fam), eng.cfg)
    ref = plain.query(xq, sample=True, key_words=words)
    ties = label_ties(fam, eng, xq, whole.labels, ref.labels)
    sties = label_ties(fam, eng, xq, whole.sampled_labels,
                       ref.sampled_labels, words)
    act = np.zeros(eng.k_max, bool)
    act[eng.slots[:eng.k_active]] = True
    lp_err = rel_err(torch.as_tensor(whole.logprobs[:, act]),
                     torch.as_tensor(ref.logprobs[:, act]), SERVE_RTOL,
                     f"serve {name} logprobs")
    lpd_err = rel_err(torch.as_tensor(whole.log_predictive),
                      torch.as_tensor(ref.log_predictive), SERVE_RTOL,
                      f"serve {name} log_predictive")
    if not (np.isfinite(whole.log_predictive).all()
            and (whole.logprobs[:, ~act] == np.float32(-1e30)).all()):
        fail(f"serve {name}: non-finite or unmasked answers")
    score = nmi(torch.as_tensor(yq), torch.as_tensor(whole.labels),
                int(yq.max()) + 1, eng.k_max)
    if score < 0.9:
        fail(f"serve {name}: NMI of predict {score:.4f} < 0.9")
    # swap to the fitted state after one more model-side step (weights
    # and params redrawn); a query before the flip is the old model's, a
    # query after it the new model's, bit for bit
    g = torch.Generator(device=eng.device).manual_seed(9)
    xf = torch.as_tensor(x_fit, device=eng.device)
    prior = fam.build_prior(DPMMConfig(component=fam_name),
                            xf.mean(dim=0, keepdim=True))
    nxt = gibbs.sweep_model(res.state, prior, fam, DPMMConfig().alpha, g)
    path2 = checkpoint.save_model(str(tmp / f"{name}_next.npz"), nxt,
                                  fam_name)
    probe = xq[:SERVE_B]
    old = eng.query(probe)
    if not np.array_equal(old.log_predictive,
                          whole.log_predictive[:SERVE_B]):
        fail(f"serve {name}: the model changed before the swap")
    epoch = eng.swap(path2)
    new = eng.query(probe)
    fresh = DPMMEngine.from_checkpoint(path2).query(probe)
    if not (epoch == 1 and new.model_epoch == 1
            and np.array_equal(new.log_predictive, fresh.log_predictive)
            and np.array_equal(new.labels, fresh.labels)
            and not np.array_equal(new.log_predictive,
                                   old.log_predictive)):
        fail(f"serve {name}: the swap did not flip to the new model")
    lat = {}
    for n in SERVE_SIZES + (xq.shape[0],):
        reps = 5 if n > SERVE_B else 30
        times = []
        for i in range(reps):
            s = (i * 997) % (xq.shape[0] - n + 1)
            t1 = time.perf_counter()
            eng.query(xq[s:s + n])
            times.append(time.perf_counter() - t1)
        lat[str(n)] = {"p50_ms": 1e3 * float(np.percentile(times, 50)),
                       "p99_ms": 1e3 * float(np.percentile(times, 99)),
                       "rows_per_s": n / float(np.median(times))}
    report = {"family": fam_name, "k_max": eng.k_max,
              "k_active": eng.k_active, "k_compact": len(eng.slots),
              "d": eng.d, "rows": int(xq.shape[0]),
              "engine_build_s": build_s, "nmi_predict": score,
              "bitwise_ragged": True, "request_sizes": list(SERVE_SIZES),
              "near_tie_mismatches": {"labels": ties, "sampled": sties},
              "max_abs_err": {"logprobs": lp_err,
                              "log_predictive": lpd_err},
              "swap_epoch": epoch, "launches": launches,
              "latency": lat, "nvidia_smi": gpu}
    return report, eng, launches


def time_serve_kernels(engines, xq, assign, loglik, matmul, dev) -> dict:
    """Kernel, plain and library times of the four serving kernels on the
    engines' compact operands at one SERVE_B-row step, with the bound of
    that work."""
    out = {}
    x = torch.as_tensor(xq["gaussian"][:SERVE_B], device=dev)
    op = engines["gaussian"]._served.ops
    p = op.params
    k, d = p.mu.shape
    live = int(op.active.sum())
    gidx = torch.arange(SERVE_B, device=dev)
    words = torch.tensor([5, 6], device=dev)
    act, slots = op.active.to(torch.int32), op.slots.to(torch.int32)
    gargs = (x, p.mu, p.chol_prec, p.logdet_prec, op.logw, act, gidx, words,
             slots)
    out["loglik_gauss"] = dict(
        ms=cuda_ms(lambda: loglik.loglik_cuda(*gargs[:4]), 50),
        plain_ms=cuda_ms(lambda: loglik.loglik_plain(*gargs[:4]), 10),
        flop=2 * SERVE_B * k * d * (d + 1),
        bytes=4 * (SERVE_B * d + k * (d * d + d + 1) + SERVE_B * k),
        library_ms=None, shape=f"B={SERVE_B} d={d} K={k}",
        max_abs_err=rel_err(loglik.loglik_cuda(*gargs[:4]),
                            loglik.loglik_plain(*gargs[:4]), SERVE_RTOL,
                            "loglik_gauss at the serve step"))
    out["assign_gauss"] = dict(
        ms=cuda_ms(lambda: assign.assign_gauss_cuda(*gargs), 50),
        plain_ms=cuda_ms(lambda: assign.assign_gauss_plain(*gargs), 10),
        flop=2 * SERVE_B * live * d * (d + 1),
        bytes=(4 * SERVE_B * d + 12 * SERVE_B
               + 4 * k * (d * d + d + 4)),
        library_ms=None, shape=f"B={SERVE_B} d={d} K={k} live={live}",
        max_abs_err=float(assign_ties(
            assign, True, gargs, assign.assign_gauss_cuda(*gargs),
            assign.assign_gauss_plain(*gargs))))
    eng = engines["multinomial"]
    op = eng._served.ops
    feats, w, const = eng.family.module.assign_pack(
        torch.as_tensor(xq["multinomial"][:SERVE_B], device=dev), op.params)
    k, dp = w.shape
    live = int(op.active.sum())
    largs = (feats.contiguous(), w.contiguous(), const.contiguous(), op.logw,
             op.active.to(torch.int32), gidx, words,
             op.slots.to(torch.int32))
    out["assign_linear"] = dict(
        ms=cuda_ms(lambda: assign.assign_linear_cuda(*largs), 50),
        plain_ms=cuda_ms(lambda: assign.assign_linear_plain(*largs), 10),
        flop=2 * SERVE_B * live * dp,
        bytes=4 * SERVE_B * dp + 12 * SERVE_B + 4 * k * (dp + 4),
        library_ms=None, shape=f"B={SERVE_B} d'={dp} K={k} live={live}",
        max_abs_err=float(assign_ties(
            assign, False, largs, assign.assign_linear_cuda(*largs),
            assign.assign_linear_plain(*largs))))
    op = engines["diag_gaussian"]._served.ops
    xd = torch.as_tensor(xq["diag_gaussian"][:SERVE_B], device=dev)
    prec = torch.exp(op.params.log_prec)
    a, b = (xd * xd).contiguous(), prec.T.contiguous()
    m, kk = a.shape
    n = b.shape[1]
    out["matmul"] = dict(
        ms=cuda_ms(lambda: matmul.matmul_cuda(a, b), 50),
        plain_ms=cuda_ms(lambda: matmul.matmul_plain(a, b), 50),
        flop=2 * m * kk * n, bytes=4 * (m * kk + kk * n + m * n),
        library_ms=cuda_ms(lambda: torch.matmul(a, b), 50),
        shape=f"({m}, {kk}) @ ({kk}, {n})",
        max_abs_err=rel_err(matmul.matmul_cuda(a, b),
                            matmul.matmul_plain(a, b), SERVE_RTOL,
                            "matmul at the serve step"))
    for r in out.values():
        r["bound_ms"], r["bound_by"] = bound(r["flop"], r["bytes"])
    return out


def matmul_crossover(matmul, dev) -> dict:
    """The blocked kernel against ``torch.matmul`` over a ladder of row
    counts N for (N, d) @ (d, 16) at d = 32 and 128: the least d N at
    which the library is faster (``ops.matmul_auto``'s size test; the
    reference keeps the paper's 640,000). Also whether the library's
    first 256 rows of an 8192-row product equal a 256-row product's, the
    property the serving ladder needs of a row (the kernel's hold by
    construction)."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(7)
    for d in (32, 128):
        rows, first = [], None
        b = torch.randn(d, 16, device=dev, generator=g)
        a = torch.randn(SERVE_B, d, device=dev, generator=g)
        invariant = {
            "torch_matmul": torch.equal(torch.matmul(a[:256], b),
                                        torch.matmul(a, b)[:256]),
            "kernel": torch.equal(matmul.matmul_cuda(a[:256].contiguous(),
                                                     b),
                                  matmul.matmul_cuda(a, b)[:256])}
        for n in (1024, 4096, 8192, 16384, 32768, 65536, 131072, 262144,
                  524288):
            a = torch.randn(n, d, device=dev, generator=g)
            ms_k = cuda_ms(lambda: matmul.matmul_cuda(a, b), 20)
            ms_l = cuda_ms(lambda: torch.matmul(a, b), 20)
            rows.append({"n": n, "dn": d * n, "kernel_ms": ms_k,
                         "torch_matmul_ms": ms_l})
            if first is None and ms_l < ms_k:
                first = d * n
        out[f"d{d}"] = {"rows": rows, "first_dn_library_faster": first,
                        "cublas_rows_batch_invariant": invariant}
    return out


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_fit(x_np, cfg, trace: str) -> dict:
    """The fit again under ``torch.profiler`` (the first fit warmed up the
    kernels and library handles): wall seconds, device-busy seconds (the
    device-side events: kernels and copies), the idle share (an upper
    bound: profiling slows the host) and the heaviest device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.sampler import DPMM
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = DPMM(cfg).fit(x_np)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace)
    # device-side events only: the CPU operators that launched them carry
    # the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    busy = sum(_device_us(e) for e in events) * 1e-6
    heavy = sorted(events, key=_device_us, reverse=True)[:15]
    return {"k_found": res.k, "wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "steady_ms_per_iter": 1e3 * float(np.mean(
                res.iter_times_s[cfg.log_every:])),
            "top": [{"name": e.key[:90], "count": e.count,
                     "device_ms": _device_us(e) * 1e-3} for e in heavy],
            "trace": trace}


# ---------------------------------------------------------------------------
# The three-pass sweep: step (f) alone, and the tile and the fit through it
# ---------------------------------------------------------------------------
def sub_ties(assign, gauss: bool, args, got, want) -> int:
    """Step-(f) mismatches of ``got`` against ``want``; raises unless each
    is a float64-proven near-tie and they are few."""
    bad, not_ties = assign.sub_assign_mismatches(gauss, args, got, want,
                                                 TIE_RTOL)
    if not_ties:
        fail(f"{not_ties} step-(f) sub-label mismatches are not near-ties")
    if bad > MAX_TIE_SHARE * args[0].shape[0] + 1:
        fail(f"{bad} near-tie mismatches of {args[0].shape[0]} points")
    return bad


def gauss_sub_args(a, labels):
    """``sub_assign_gauss`` operands from ``sweep_gauss`` operands ``a``."""
    return (a[0], a[6], a[7], a[8], a[9], labels, a[11], a[13])


def linear_sub_args(a, labels):
    """``sub_assign_linear`` operands from ``sweep_linear`` operands."""
    return (a[0], a[5], a[6], a[7], labels, a[9], a[11])


def check_sub_assign(assign, gauss: bool, args, one_read=None) -> dict:
    """A step-(f) kernel on ``args`` against its plain version: repeat
    launches bitwise equal, sub-labels exact except near-ties. With
    ``one_read`` (the fused sweep's sub-labels for the same labels) the
    kernel, which runs the sweep's device code, must equal it bit for
    bit."""
    cuda = (assign.sub_assign_gauss_cuda if gauss
            else assign.sub_assign_linear_cuda)
    plain = (assign.sub_assign_gauss_plain if gauss
             else assign.sub_assign_linear_plain)
    got = cuda(*args)
    again = cuda(*args)
    torch.cuda.synchronize()
    name = "sub_assign_gauss" if gauss else "sub_assign_linear"
    if not torch.equal(got, again):
        fail(f"{name}: two launches on the same inputs differ")
    out = {"n": args[0].shape[0], "width": args[0].shape[1],
           "k": args[1].shape[0],
           "near_tie_mismatches": sub_ties(assign, gauss, args, got,
                                           plain(*args)),
           "repeat_bitwise": True}
    if one_read is not None:
        if not torch.equal(got, one_read):
            fail(f"{name}: differs from the one-read sweep's step (f)")
        out["equals_one_read_sweep"] = True
    return out


def check_three_pass_tile(fam, model, x, args, mismatches, gibbs) -> dict:
    """``gibbs.sweep_tile(fused=False)`` against ``fused=True`` at a fit's
    final state, on the compact slab and key words of ``args`` (the fused
    kernel's operands, ``fit_sweep_args`` / ``fit_linear_args``). The
    target is bitwise equal labels, sub-labels and stats; otherwise every
    differing point must be a float64-proven near-tie and the stats of the
    one-read labelling, folded by the three-pass fold, within STATS_RTOL.
    Two three-pass runs must give the same bits."""
    import dataclasses
    from repro_torch.core.state import PointState
    dev = x.device
    n, d = x.shape
    k_c = args[1].shape[0]
    plan = gibbs.compaction_plan(model.active, k_c)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    point = PointState(labels=zeros, sublabels=zeros,
                       valid=torch.ones(n, device=dev))
    gidx = gibbs.global_indices(n, dev)

    def tile(fused):
        return gibbs.sweep_tile(model, x, point, gidx,
                                gibbs.empty_substats(fam, k_c, d, dev), fam,
                                args[-3], args[-2], plan=plan, fused=fused)
    one, acc1 = tile(True)
    three, acc3 = tile(False)
    again, acc3b = tile(False)
    torch.cuda.synchronize()
    fields = [f.name for f in dataclasses.fields(acc1)]
    same = lambda a, b: all(torch.equal(getattr(a, f), getattr(b, f))
                            for f in fields)
    if not (torch.equal(three.labels, again.labels)
            and torch.equal(three.sublabels, again.sublabels)
            and same(acc3, acc3b)):
        fail(f"{fam.name} three-pass tile: two runs on one state differ")
    differ = int(((one.labels != three.labels)
                  | (one.sublabels != three.sublabels)).sum())
    bitwise = differ == 0 and same(acc1, acc3)
    ties = 0
    if differ:
        compact = lambda lab: plan.compact_of_slot[lab.long()].to(
            torch.int32)
        ties = near_ties(mismatches, args,
                         (compact(three.labels), three.sublabels),
                         (compact(one.labels), one.sublabels))
        acc3 = fam.stats_from_labels(x, point.valid, compact(one.labels),
                                     one.sublabels, k_c)
    err = stats_err([getattr(acc3, f) for f in fields],
                    [getattr(acc1, f) for f in fields])
    return {"n": n, "d": d, "k": k_c, "k_live": int(model.k_hat),
            "bitwise": bitwise, "differing_points": differ,
            "near_tie_mismatches": ties, "stats_max_abs_err": err,
            "repeat_bitwise": True}


def fit_three_pass(DPMM, cfg, x_np, y_np, gibbs) -> tuple:
    """The fit through ``gibbs.sweep_tile(fused=False)`` (swapped in with
    ``functools.partial``, as the reference's own tests do) against the
    fused fit on the same data and seed, each with its launch counts set
    to 0 just before and read just after, and the sweep's labels of every
    iteration recorded. Returns the report, whose ``problems`` lists each
    failed gate (NMI >= 0.9 for both; the three-pass fit reaches the fused
    fit's K through its own kernels), the three-pass launches and the
    three-pass fit's result."""
    import functools
    from repro_torch.kernels import ops
    orig = gibbs.sweep_tile
    runs = {}
    for name, fused in (("fused", True), ("three_pass", False)):
        seen = []
        step = functools.partial(orig, fused=fused)

        def recorded(*a, _step=step, _seen=seen, **kw):
            point, acc = _step(*a, **kw)
            _seen.append(point.labels.clone())
            return point, acc
        gibbs.sweep_tile = recorded
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = DPMM(cfg).fit(x_np)
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
        finally:
            gibbs.sweep_tile = orig
        runs[name] = (res, launches, seen, wall)
    (rf, lf, sf, _), (rt, lt, st, _) = runs["fused"], runs["three_pass"]
    parted = next((i + 1 for i, (a, b) in enumerate(zip(sf, st))
                   if not torch.equal(a, b)), "none")
    report = {"component": cfg.component, "n": x_np.shape[0],
              "d": x_np.shape[1], "first_iteration_labels_part": parted,
              "final_labels_equal": bool(np.array_equal(rf.labels,
                                                        rt.labels))}
    for name, (res, launches, _, wall) in runs.items():
        report[name] = {
            "k_found": res.k, "nmi": res.nmi(y_np), "wall_s": wall,
            "steady_ms_per_iter": 1e3 * float(np.mean(
                res.iter_times_s[cfg.log_every:])),
            "k_history": res.history["k"].tolist(),
            "peak_bytes": res.peak_bytes, "launches": launches}
    gauss = cfg.component == "gaussian"
    fused_k, step_e, step_f, fold = (
        ("sweep_gauss", "assign_gauss", "sub_assign_gauss",
         "suffstats_labels") if gauss else
        ("sweep_linear", "assign_linear", "sub_assign_linear",
         "moments_labels"))
    problems = [f"{name}: NMI {report[name]['nmi']:.4f} < 0.9"
                for name in runs if report[name]["nmi"] < 0.9]
    if not (lt[fused_k] == 0 and lt[step_e] == lt[step_f] == cfg.iters
            and lt[fold] > 0 and lf[fused_k] == cfg.iters):
        problems.append(f"launches {lt} / {lf}")
    if rt.k != rf.k:
        problems.append(f"K {rt.k} against the fused fit's {rf.k}")
    report["problems"] = problems
    return report, lt, rt


def kernels_d256(res, launches, x_np, cfg, gibbs, sampler, assign,
                 suffstats, loglik, dev) -> dict:
    """``assign_gauss``, ``sub_assign_gauss``, ``suffstats_labels`` and
    ``loglik_gauss`` at the d = 256 fit's final state (its compact slab,
    all its points) against their plain versions, and timed, with the
    bound of that work, the launches per iteration of the fit and the
    phase's peak device memory."""
    torch.cuda.reset_peak_memory_stats(dev)
    x = torch.as_tensor(x_np, device=dev)
    a, k = fit_sweep_args(res.state, x, gibbs, sampler,
                          torch.Generator(device=dev).manual_seed(6))
    n, d = x.shape
    live = int(a[5].sum())
    e_args = a[:6] + (a[11], a[12], a[14])
    lab = assign.assign_gauss_cuda(*e_args)
    torch.cuda.synchronize()
    if not torch.equal(lab, assign.assign_gauss_cuda(*e_args)):
        fail("assign_gauss at d = 256: two launches differ")
    e_ties = assign_ties(assign, True, e_args, lab,
                         assign.assign_gauss_plain(*e_args))
    f_args = gauss_sub_args(a, lab)
    f_check = check_sub_assign(assign, True, f_args)
    s_args = (x, lab, assign.sub_assign_gauss_cuda(*f_args), a[10], k)
    s_k = suffstats.suffstats_labels_cuda(*s_args)
    s_k2 = suffstats.suffstats_labels_cuda(*s_args)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) for u, v in zip(s_k, s_k2)):
        fail("suffstats_labels at d = 256: two launches differ")
    del s_k2
    s_err = stats_err(s_k, suffstats.suffstats_labels_plain(*s_args))
    del s_k
    ll_err = rel_err(loglik.loglik_cuda(*a[:4]),
                     loglik.loglik_plain(*a[:4]), SERVE_RTOL,
                     "loglik_gauss at d = 256")
    work = {"assign_gauss": (2 * n * live * d * (d + 1),
                             4 * n * d + 12 * n + 4 * k * (d * d + d + 4)),
            "sub_assign_gauss": (4 * n * d * (d + 1),
                                 4 * n * d + 16 * n
                                 + 8 * k * (d * d + d + 2)),
            "suffstats_labels": gauss_work(n, d, k, live,
                                           k)["suffstats_labels"],
            "loglik_gauss": (2 * n * k * d * (d + 1),
                             4 * (n * d + k * (d * d + d + 1) + n * k))}
    calls = {
        "assign_gauss": (lambda: assign.assign_gauss_cuda(*e_args),
                         lambda: assign.assign_gauss_plain(*e_args)),
        "sub_assign_gauss": (lambda: assign.sub_assign_gauss_cuda(*f_args),
                             lambda: assign.sub_assign_gauss_plain(*f_args)),
        "suffstats_labels": (
            lambda: suffstats.suffstats_labels_cuda(*s_args),
            lambda: suffstats.suffstats_labels_plain(*s_args)),
        "loglik_gauss": (lambda: loglik.loglik_cuda(*a[:4]),
                         lambda: loglik.loglik_plain(*a[:4]))}
    out = {}
    for name, (kern, plain) in calls.items():
        b, by = bound(*work[name])
        out[name] = {"ms": cuda_ms(kern, 10), "plain_ms": cuda_ms(plain, 1),
                     "bound_ms": b, "bound_by": by,
                     "launches_per_iter": launches[name] / cfg.iters}
    out["assign_gauss"]["near_tie_mismatches"] = e_ties
    out["sub_assign_gauss"]["near_tie_mismatches"] = f_check[
        "near_tie_mismatches"]
    out["suffstats_labels"]["max_abs_err"] = s_err
    out["loglik_gauss"]["max_abs_err"] = ll_err
    return {"n": n, "d": d, "k": k, "k_live": live, "repeat_bitwise": True,
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev)), **out}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="TRACE", default="",
                    help="also profile a second fit; Chrome trace path")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import DPMMConfig
    from repro_torch.core import gibbs, niw, sampler
    from repro_torch.core.family import get_family
    from repro_torch.core.sampler import DPMM
    from repro_torch.data import synthetic
    from repro_torch.data.synthetic import generate_gmm
    from repro_torch.kernels import (assign, build, loglik, matmul, ops,
                                     suffstats, sweep)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = card()
    emit("card", nvidia_smi=gpu, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    secs = build.build()
    emit("build", seconds=time.perf_counter() - t0, per_source=secs,
         ptxas={n: [ln for ln in (build.ptxas_report(n) or "").splitlines()
                    if "registers" in ln or "spill" in ln]
                for n in build.SOURCES})

    # (3) each kernel against its plain version at the fit's widths:
    # sweep at the compact K_c = 32 slots, suffstats at the split/merge
    # fold's 2 * K_c = 64 slots
    k_c = sampler._k_compact(FIT_K, 2, 64, 8)
    args = synthetic_sweep_args(CHECK_N, FIT_D, k_c, dev)
    ops.reset_launch_counts()
    out_k = sweep.sweep_gauss_cuda(*args)
    out_k2 = sweep.sweep_gauss_cuda(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_k2)):
        fail("sweep_gauss: two launches on the same inputs differ")
    out_p = sweep.sweep_gauss_plain(*args)
    ties = near_ties(sweep.label_mismatches, args, out_k, out_p)
    x, valid = args[0], args[10]
    want = suffstats.suffstats_labels_plain(x, out_k[0], out_k[1], valid,
                                            k_c)
    err_sweep = stats_err(out_k[2:], want)
    lab = torch.randint(0, 2 * k_c, (CHECK_N,), device=dev,
                        dtype=torch.int32)
    sub = torch.randint(0, 2, (CHECK_N,), device=dev, dtype=torch.int32)
    s_k = suffstats.suffstats_labels_cuda(x, lab, sub, valid, 2 * k_c)
    s_k2 = suffstats.suffstats_labels_cuda(x, lab, sub, valid, 2 * k_c)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(s_k, s_k2)):
        fail("suffstats_labels: two launches on the same inputs differ")
    err_stats = stats_err(
        s_k, suffstats.suffstats_labels_plain(x, lab, sub, valid, 2 * k_c))
    emit("kernel_check", n=CHECK_N, d=FIT_D,
         sweep_gauss={"k": k_c, "near_tie_mismatches": ties,
                      "max_abs_err": err_sweep, "repeat_bitwise": True},
         suffstats_labels={"k": 2 * k_c, "max_abs_err": err_stats,
                           "repeat_bitwise": True})

    # the linear families' kernels at the multinomial fit's width, the
    # diagonal Gaussian pack (d = 32, d' = 64) and the 20newsgroups width
    gen = torch.Generator(device=dev).manual_seed(3)
    lin_k_c = sampler._k_compact(FIT_K, 2, 64, 8)
    news_np = synthetic.generate_mnmm(NEWS_N, NEWS_D, NEWS_K, seed=0)
    checks = {}
    for name, fam, (xc, yc), k_c in (
            ("multinomial", "multinomial",
             synthetic.generate_mnmm(CHECK_N, 128, FIT_K, seed=1), lin_k_c),
            ("diag_gaussian", "diag_gaussian",
             synthetic.generate_gmm(CHECK_N, FIT_D, FIT_K, seed=1), lin_k_c),
            ("news20", "multinomial", news_np, NEWS_KC)):
        cargs = linear_sweep_args(get_family(fam),
                                  torch.as_tensor(xc, device=dev), yc, k_c,
                                  dev)
        checks[name] = check_linear_kernels(cargs, 2 * k_c, sweep, suffstats,
                                            gen)
    del cargs          # the fits' peak memory is their own
    emit("kernel_check_linear", **checks)

    # the serving path's kernels at one ladder step of SERVE_B rows
    emit("kernel_check_serve", n=SERVE_B, k=SERVE_KC, k_live=SERVE_LIVE,
         rtol=SERVE_RTOL, **check_serve_kernels(
             sweep, suffstats, assign, loglik, matmul, news_np, dev))

    # (5) the main path: DPMM.fit on the card through the kernels
    x_np, y_np = generate_gmm(FIT_N, FIT_D, FIT_K, seed=0)
    cfg = DPMMConfig(**FIT_CFG)
    res, launches = run_fit(DPMM, cfg, x_np, y_np,
                            ("sweep_gauss", "suffstats_labels"), gpu, "fit")

    if opts.profile:
        emit("profile", nvidia_smi=gpu, **profile_fit(x_np, cfg,
                                                      opts.profile))

    # the model side's draws (gamma, normal, cuSOLVER) on the card and on
    # the CPU, from the fit's final state, against their analytic moments
    x = torch.as_tensor(x_np, device=dev)
    st = res.state
    prior = niw.build_prior(cfg, x.mean(dim=0, keepdim=True))
    emit("model_draws", draws=DRAWS, z_max=Z_MAX, clusters=st.active.shape[0],
         d=FIT_D, max_abs_z={where: check_model_draws(
             st.active, st.stats, st.substats, prior, cfg.alpha, where)
             for where in ("cuda", "cpu")})
    del x

    # the linear families' paths: each fit with the counts set to 0 just
    # before it and read just after
    lin = {}
    for comp, gen_name, n_fit, d_fit in LINEAR_FITS:
        xl_np, yl_np = getattr(synthetic, gen_name)(n_fit, d_fit, FIT_K,
                                                    seed=0)
        lcfg = DPMMConfig(component=comp, **FIT_CFG)
        lres, llaunch = run_fit(DPMM, lcfg, xl_np, yl_np,
                                ("sweep_linear", "moments_labels"), gpu,
                                f"fit_{comp}")
        lin[comp] = (lres, llaunch, lcfg, xl_np)
        if opts.profile and comp == "multinomial":
            trace = Path(opts.profile)
            emit("profile_multinomial", nvidia_smi=gpu, **profile_fit(
                xl_np, lcfg, str(trace.with_name(
                    f"{trace.stem}_multinomial{trace.suffix}"))))
    draws = {}
    for comp, (lres, _, lcfg, xl_np) in lin.items():
        fam = get_family(comp)
        st = lres.state
        lprior = fam.build_prior(lcfg, torch.as_tensor(
            xl_np.mean(0, keepdims=True), device=dev))
        draws[comp] = {where: check_linear_draws(
            fam, st.active, st.stats, st.substats, lprior, where)
            for where in ("cuda", "cpu")}
    emit("model_draws_linear", draws=DRAWS, z_max=Z_MAX, max_abs_z=draws)

    # the Gaussian fit at d = 128 (the wide layout of both kernels), and
    # sweep_gauss against its plain version on its final state
    x128_np, y128_np = generate_gmm(D128_N, D128_D, FIT_K, seed=0)
    res128, launch128 = run_fit(DPMM, cfg, x128_np, y128_np,
                                ("sweep_gauss", "suffstats_labels"), gpu,
                                "fit_gaussian_d128")
    x128 = torch.as_tensor(x128_np, device=dev)
    a128, k128 = fit_sweep_args(res128.state, x128, gibbs, sampler,
                                torch.Generator(device=dev).manual_seed(4))
    out_k = sweep.sweep_gauss_cuda(*a128)
    out_p = sweep.sweep_gauss_plain(*a128)
    live128 = int(a128[5].sum())
    ties128 = near_ties(sweep.label_mismatches, a128, out_k, out_p)
    err128 = stats_err(out_k[2:], suffstats.suffstats_labels_plain(
        x128, out_k[0], out_k[1], a128[10], k128))
    # the split/merge fold's stats over 2 K_c clusters at d = 128
    k_sm128 = min(64, 2 * k128)
    lab128 = gibbs.compaction_plan(res128.state.active, k_sm128
                                   ).compact_of_slot[torch.as_tensor(
                                       res128.labels, device=dev).long()
                                   ].to(torch.int32)
    s_args = (x128, lab128, out_k[1], a128[10], k_sm128)
    work128 = gauss_work(D128_N, D128_D, k128, live128, k_sm128)
    d128 = {"sweep_gauss": {
                "ms": cuda_ms(lambda: sweep.sweep_gauss_cuda(*a128), 10),
                "plain_ms": cuda_ms(lambda: sweep.sweep_gauss_plain(*a128),
                                    1),
                "near_tie_mismatches": ties128, "max_abs_err": err128},
            "suffstats_labels": {
                "ms": cuda_ms(lambda: suffstats.suffstats_labels_cuda(
                    *s_args), 10),
                "plain_ms": cuda_ms(lambda: suffstats.suffstats_labels_plain(
                    *s_args), 1),
                "max_abs_err": stats_err(
                    suffstats.suffstats_labels_cuda(*s_args),
                    suffstats.suffstats_labels_plain(*s_args))}}
    for name, r in d128.items():
        r["bound_ms"], r["bound_by"] = bound(*work128[name])
    emit("kernels_d128", n=D128_N, d=D128_D, k_sweep=k128, k_live=live128,
         k_stats=k_sm128, nvidia_smi=gpu, **d128)
    del x128, a128, out_k, out_p, lab128, s_args

    # the three-pass sweep (gibbs.sweep_tile(fused=False)) against the
    # fused one: a multinomial and a Gaussian fit on the same data and
    # seed through both bodies
    three, three_launch, three_fit = {}, {}, {}
    for comp, gen_name, d_fit in THREE_PASS_FITS:
        xt_np, yt_np = getattr(synthetic, gen_name)(THREE_PASS_N, d_fit,
                                                    FIT_K, seed=0)
        three[comp], three_launch[comp], res3 = fit_three_pass(
            DPMM, DPMMConfig(component=comp, **FIT_CFG), xt_np, yt_np,
            gibbs)
        three_fit[comp] = (res3, xt_np)
    emit("fit_three_pass", nvidia_smi=gpu, **three)
    for comp, r in three.items():
        if r["problems"]:
            fail(f"fit_three_pass {comp}: {'; '.join(r['problems'])}")
    del xt_np, yt_np, res3

    # the Gaussian fit past the one-read sweep's d <= 128: every sweep
    # declines to sweep_ref (assign_gauss, sub_assign_gauss and the
    # suffstats_labels fold), and its kernels at the final state
    x256_np, y256_np = generate_gmm(D256_N, D256_D, FIT_K, seed=0)
    res256, launch256 = run_fit(
        DPMM, cfg, x256_np, y256_np,
        ("assign_gauss", "sub_assign_gauss", "suffstats_labels"), gpu,
        "fit_gaussian_d256")
    if not (launch256["sweep_gauss"] == 0 and launch256["assign_gauss"]
            == launch256["sub_assign_gauss"] == cfg.iters):
        fail(f"fit_gaussian_d256: launches {launch256}")
    k256 = kernels_d256(res256, launch256, x256_np, cfg, gibbs, sampler,
                        assign, suffstats, loglik, dev)
    emit("kernels_d256", nvidia_smi=gpu, **k256)

    # serving: each fitted model through DPMMEngine, checkpoint first
    import tempfile
    xq, yq, engines, serve_launch = {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, fit_res, fam_name, x_fit, gen_name in (
                ("gaussian", res, "gaussian", x_np, "generate_gmm"),
                ("multinomial", lin["multinomial"][0], "multinomial",
                 lin["multinomial"][3], "generate_mnmm"),
                ("diag_gaussian", lin["diag_gaussian"][0], "diag_gaussian",
                 lin["diag_gaussian"][3], "generate_gmm"),
                ("gaussian_d256", res256, "gaussian", x256_np,
                 "generate_gmm")):
            # fresh rows of the fit's own mixture: the generators draw the
            # mixture from the seed, so seed 0 at another N
            xq[name], yq[name] = getattr(synthetic, gen_name)(
                SERVE_ROWS, x_fit.shape[1], FIT_K, seed=0)
            report, engines[name], serve_launch[name] = serve_model(
                name, fit_res, fam_name, xq[name], yq[name], x_fit,
                Path(tmp), gpu)
            emit(f"serve_{name}", **report)
    serve_times = time_serve_kernels(engines, xq, assign, loglik, matmul,
                                     dev)

    # (4) time each kernel at the fit's shapes (its final state, all N)
    x = torch.as_tensor(x_np, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    sargs, k_c = fit_sweep_args(res.state, x, gibbs, sampler, gen)
    n_act = int(res.k)
    out_k = sweep.sweep_gauss_cuda(*sargs)
    out_p = sweep.sweep_gauss_plain(*sargs)
    ties_fit = near_ties(sweep.label_mismatches, sargs, out_k,
                         out_p)
    valid = sargs[10]
    err_sweep = stats_err(out_k[2:], suffstats.suffstats_labels_plain(
        x, out_k[0], out_k[1], valid, k_c))
    labels = torch.as_tensor(res.labels, device=dev)
    sub = out_k[1]
    k_sm = min(64, 2 * k_c)
    comp = gibbs.compaction_plan(res.state.active, k_sm)
    lab_c = comp.compact_of_slot[labels.long()].to(torch.int32)
    err_stats = stats_err(
        suffstats.suffstats_labels_cuda(x, lab_c, sub, valid, k_sm),
        suffstats.suffstats_labels_plain(x, lab_c, sub, valid, k_sm))
    # the linear kernels at each linear fit's final state, as that fit's
    # next sweep and split/merge fold would run them; the multinomial
    # fit's (the widest) are kept for the times
    fit_states, fit_args = {}, {}
    for comp, (lres, _, _, xl_np) in lin.items():
        fit_states[comp], fit_args[comp], *operands = check_fit_state(
            get_family(comp), lres, torch.as_tensor(xl_np, device=dev),
            gibbs, sampler, gen, sweep, suffstats)
        if comp == "multinomial":
            llab, lsub, lk_sm = operands
        del operands
    largs = fit_args["multinomial"]
    mlaunch, mcfg = lin["multinomial"][1], lin["multinomial"][2]
    err_lin = max(r["sweep_linear_max_abs_err"] for r in fit_states.values())
    err_mom = max(r["moments_labels_max_abs_err"]
                  for r in fit_states.values())
    news_args = linear_sweep_args(get_family("multinomial"), torch.as_tensor(
        news_np[0], device=dev), news_np[1], NEWS_KC, dev)
    news_lab = sweep.sweep_linear_cuda(*news_args)
    ops.reset_launch_counts()
    lin_times = time_linear(largs, llab, lsub, lk_sm, sweep, suffstats)
    news_times = time_linear(news_args, *news_lab[:2], 2 * NEWS_KC, sweep,
                             suffstats)
    ms_sweep = cuda_ms(lambda: sweep.sweep_gauss_cuda(*sargs), 20)
    plain_sweep = cuda_ms(lambda: sweep.sweep_gauss_plain(*sargs), 3)
    ms_stats = cuda_ms(lambda: suffstats.suffstats_labels_cuda(
        x, lab_c, sub, valid, k_sm), 20)
    plain_stats = cuda_ms(lambda: suffstats.suffstats_labels_plain(
        x, lab_c, sub, valid, k_sm), 3)

    n, d = x.shape
    work = gauss_work(n, d, k_c, n_act, k_sm)
    rows = []
    for name, ms, plain, err, src, repl in (
            ("sweep_gauss", ms_sweep, plain_sweep, err_sweep,
             "src/repro_torch/csrc/sweep_gauss.cu",
             "src/repro/kernels/sweep.py:344"),
            ("suffstats_labels", ms_stats, plain_stats, err_stats,
             "src/repro_torch/csrc/suffstats_labels.cu",
             "src/repro/kernels/suffstats.py:169")):
        bound_ms, bound_by = bound(*work[name])
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name],
            "launches_per_iter": launches[name] / cfg.iters,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
    for name, err, src, repl in (
            ("sweep_linear", err_lin, "src/repro_torch/csrc/sweep_linear.cu",
             "src/repro/kernels/sweep.py:179"),
            ("moments_labels", err_mom,
             "src/repro_torch/csrc/moments_labels.cu",
             "src/repro/kernels/suffstats.py:218")):
        t = lin_times[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": mlaunch[name],
            "launches_per_iter": mlaunch[name] / mcfg.iters,
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    serve_rows = (
        ("loglik_gauss", "src/repro_torch/csrc/loglik_gauss.cu",
         "src/repro/kernels/loglik.py:49"),
        ("assign_gauss", "src/repro_torch/csrc/assign_gauss.cu",
         "src/repro/kernels/assign.py:187"),
        ("assign_linear", "src/repro_torch/csrc/assign_linear.cu",
         "src/repro/kernels/assign.py:130"),
        ("matmul", "src/repro_torch/csrc/matmul.cu",
         "src/repro/kernels/matmul.py:33"))
    for name, src, repl in serve_rows:
        t = serve_times[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": sum(v[name] for v in serve_launch.values()),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    emit("kernel_times", n=n, d=d, k_sweep=k_c, k_live=n_act,
         k_stats=k_sm, near_tie_mismatches=ties_fit,
         linear_fit_states=fit_states,
         timing_launches=ops.launch_counts(),
         detail={r["name"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                             "bound_ms": r["bound_ms"]} for r in rows},
         multinomial_fit_state=lin_times, news20=news_times,
         serve_step=serve_times, nvidia_smi=gpu)

    # the three-pass path at the fits' final states: each step-(f) kernel
    # against its plain version and the one-read sweep's step (f), and the
    # three-pass tile against the one-read tile
    lin_out = sweep.sweep_linear_cuda(*largs)
    diag_args = fit_args["diag_gaussian"]
    diag_out = sweep.sweep_linear_cuda(*diag_args)
    x_mult = torch.as_tensor(lin["multinomial"][3], device=dev)
    tp = {"sub_assign_gauss": check_sub_assign(
              assign, True, gauss_sub_args(sargs, out_k[0]), out_k[1]),
          "sub_assign_linear": {
              "multinomial": check_sub_assign(
                  assign, False, linear_sub_args(largs, lin_out[0]),
                  lin_out[1]),
              "diag_gaussian": check_sub_assign(
                  assign, False, linear_sub_args(diag_args, diag_out[0]),
                  diag_out[1]),
              "news20": check_sub_assign(
                  assign, False, linear_sub_args(news_args, news_lab[0]),
                  news_lab[1])},
          "sweep_tile_gaussian": check_three_pass_tile(
              get_family("gaussian"), res.state, x, sargs,
              sweep.label_mismatches, gibbs),
          "sweep_tile_multinomial": check_three_pass_tile(
              get_family("multinomial"), lin["multinomial"][0].state,
              x_mult, largs, sweep.label_mismatches_linear, gibbs)}
    g_args = gauss_sub_args(sargs, out_k[0])
    l_args = linear_sub_args(largs, lin_out[0])
    kc_l, dp = largs[1].shape[0], largs[0].shape[1]
    tp_work = {"sub_assign_gauss": (4 * n * d * (d + 1),
                                    4 * n * d + 16 * n
                                    + 8 * k_c * (d * d + d + 2)),
               "sub_assign_linear": (4 * n * dp,
                                     4 * n * dp + 16 * n
                                     + 8 * kc_l * (dp + 2))}
    tp_times = {
        "sub_assign_gauss": {
            "ms": cuda_ms(lambda: assign.sub_assign_gauss_cuda(*g_args), 20),
            "plain_ms": cuda_ms(
                lambda: assign.sub_assign_gauss_plain(*g_args), 3)},
        "sub_assign_linear": {
            "ms": cuda_ms(lambda: assign.sub_assign_linear_cuda(*l_args),
                          20),
            "plain_ms": cuda_ms(
                lambda: assign.sub_assign_linear_plain(*l_args), 3)}}
    for name, r in tp_times.items():
        r["bound_ms"], r["bound_by"] = bound(*tp_work[name])
    # the kernels line's step-(f) rows: each kernel checked and timed at
    # the final state of the fit whose launches the row shows (the d = 256
    # fit's from kernels_d256; the three-pass multinomial fit's here)
    res3, x3_np = three_fit["multinomial"]
    a3, _ = fit_linear_args(get_family("multinomial"), res3.state,
                            torch.as_tensor(x3_np, device=dev), gibbs,
                            sampler, gen)
    out3 = sweep.sweep_linear_cuda(*a3)
    l3_args = linear_sub_args(a3, out3[0])
    l3 = check_sub_assign(assign, False, l3_args, out3[1])
    kc3, dp3 = a3[1].shape[0], a3[0].shape[1]
    n3 = a3[0].shape[0]
    l3.update(ms=cuda_ms(lambda: assign.sub_assign_linear_cuda(*l3_args),
                         20),
              plain_ms=cuda_ms(
                  lambda: assign.sub_assign_linear_plain(*l3_args), 3))
    l3["bound_ms"], l3["bound_by"] = bound(
        4 * n3 * dp3, 4 * n3 * dp3 + 16 * n3 + 8 * kc3 * (dp3 + 2))
    tp["sub_assign_linear"]["multinomial_three_pass_fit"] = l3
    emit("kernel_check_three_pass", tie_rtol=TIE_RTOL,
         stats_rtol=STATS_RTOL, times=tp_times, nvidia_smi=gpu, **tp)
    for name, src, repl, t, runs in (
            ("sub_assign_gauss", "src/repro_torch/csrc/sub_assign_gauss.cu",
             "src/repro/kernels/assign.py:327", k256["sub_assign_gauss"],
             launch256),
            ("sub_assign_linear",
             "src/repro_torch/csrc/sub_assign_linear.cu",
             "src/repro/kernels/assign.py:290", l3,
             three_launch["multinomial"])):
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": runs[name],
            "launches_per_iter": runs[name] / cfg.iters,
            "max_abs_err": float(t["near_tie_mismatches"]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    emit("matmul_crossover", nvidia_smi=gpu,
         paper_crossover_dn=640_000, **matmul_crossover(matmul, dev))
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
