"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile TRACE.json]

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card, runs ``DPMM.fit``
on a 1,000,000 x 32 Gaussian mixture with 16 clusters (k_max = 64, 40
iterations) and checks the clustering (NMI >= 0.9) and that every kernel
of the path was launched, holds the fit's model-side draws (Dirichlet,
Beta and NIW posterior, on the card and on the CPU) against their
analytic moments, then times each kernel and its plain version. Each
phase prints one JSON line; any failed check raises, so the script exits
non-zero. The last line is ``{"ok": true, "device": {...}}``.

``--profile TRACE.json`` adds a phase after the fit: the same fit again
under ``torch.profiler``, reported as device-busy time, idle share and the
heaviest device-side events, with the Chrome trace written to TRACE.json.

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
CHECK_N = 131_072
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


def near_ties(sweep, args, out_k, out_p) -> int:
    """Count label mismatches; raise unless each is a near-tie of the two
    logits involved and there are at most MAX_TIE_SHARE of the points."""
    bad, not_ties = sweep.label_mismatches(args, out_k[0], out_k[1],
                                           out_p[0], out_p[1], TIE_RTOL)
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
    from repro_torch.core.sampler import DPMM
    from repro_torch.data.synthetic import generate_gmm
    from repro_torch.kernels import build, ops, suffstats, sweep

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
    ties = near_ties(sweep, args, out_k, out_p)
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

    # (5) the main path: DPMM.fit on the card through the kernels
    x_np, y_np = generate_gmm(FIT_N, FIT_D, FIT_K, seed=0)
    cfg = DPMMConfig(**FIT_CFG)
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
    emit("fit", n=FIT_N, d=FIT_D, k_true=FIT_K, k_found=res.k, nmi=nmi,
         ari=res.ari(y_np), iters=cfg.iters, wall_s=wall,
         steady_ms_per_iter=1e3 * float(np.mean(steady)),
         first_chunk_ms_per_iter=1e3 * float(np.mean(
             res.iter_times_s[:cfg.log_every])),
         peak_bytes=res.peak_bytes, launches=launches,
         launches_per_iter={k: v / cfg.iters for k, v in launches.items()},
         labels_in_inactive_slots=in_inactive,
         k_history=res.history["k"].tolist(), nvidia_smi=gpu)
    if res.labels.shape != (FIT_N,) or not hist_ok:
        fail("fit output has the wrong shape or non-finite history")
    if nmi < 0.9:
        fail(f"fit NMI {nmi:.4f} < 0.9")
    for name, count in launches.items():
        if count == 0:
            fail(f"kernel {name} was never launched by the fit")

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

    # (4) time each kernel at the fit's shapes (its final state, all N)
    gen = torch.Generator(device=dev).manual_seed(1)
    sargs, k_c = fit_sweep_args(res.state, x, gibbs, sampler, gen)
    n_act = int(res.k)
    out_k = sweep.sweep_gauss_cuda(*sargs)
    out_p = sweep.sweep_gauss_plain(*sargs)
    ties_fit = near_ties(sweep, sargs, out_k, out_p)
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
    ops.reset_launch_counts()
    ms_sweep = cuda_ms(lambda: sweep.sweep_gauss_cuda(*sargs), 20)
    plain_sweep = cuda_ms(lambda: sweep.sweep_gauss_plain(*sargs), 3)
    ms_stats = cuda_ms(lambda: suffstats.suffstats_labels_cuda(
        x, lab_c, sub, valid, k_sm), 20)
    plain_stats = cuda_ms(lambda: suffstats.suffstats_labels_plain(
        x, lab_c, sub, valid, k_sm), 3)

    n, d = x.shape
    nsb = -(-n // suffstats.STATS_BLOCK)
    entries = 1 + d + d * d
    # sweep: step (e) over the live slots, step (f) over two sub-clusters,
    # the sxx/sx fold — FMA = 2 FLOP
    sweep_flop = 2 * n * d * d * (n_act + 2) + 2 * n * (d * d + d)
    sweep_bytes = (n * d * 4 + n * (4 + 8) + k_c * (d * d + d + 4) * 4
                   + k_c * 2 * (d * d + d + 2) * 4 + 8 * n
                   + nsb * 2 * k_c * entries * 4)
    stats_flop = 2 * n * (d * d + d)
    stats_bytes = n * (4 * d + 12) + nsb * 2 * k_sm * entries * 4
    rows = []
    for name, ms, plain, flop, nbytes, err, src, repl, count in (
            ("sweep_gauss", ms_sweep, plain_sweep, sweep_flop, sweep_bytes,
             err_sweep, "src/repro_torch/csrc/sweep_gauss.cu",
             "src/repro/kernels/sweep.py:344", launches["sweep_gauss"]),
            ("suffstats_labels", ms_stats, plain_stats, stats_flop,
             stats_bytes, err_stats,
             "src/repro_torch/csrc/suffstats_labels.cu",
             "src/repro/kernels/suffstats.py:169",
             launches["suffstats_labels"])):
        t_ops = flop / PEAK_FP32_FLOP_S * 1e3
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": count, "launches_per_iter": count / cfg.iters,
            "max_abs_err": err, "ms": ms,
            "plain_ms": plain, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None})
    emit("kernel_times", n=n, d=d, k_sweep=k_c, k_live=n_act,
         k_stats=k_sm, near_tie_mismatches=ties_fit,
         timing_launches=ops.launch_counts(),
         detail={r["name"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                             "bound_ms": r["bound_ms"]} for r in rows},
         nvidia_smi=gpu)
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
