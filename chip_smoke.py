"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile TRACE.json] [--mesh-only | --lm-only]

Builds the port's twelve CUDA kernels from ``src/repro_torch/csrc`` and
holds each against its plain PyTorch version on the card (phases
``kernel_check``: sweep_gauss, suffstats_labels; ``kernel_check_linear``:
sweep_linear, moments_labels, at the multinomial fit's width, the diagonal
Gaussian pack and the 20newsgroups width d' = 20,000;
``kernel_check_serve``: loglik_gauss, assign_gauss at d = 32 and 128,
with ragged requests through other slot groups bitwise the whole's and
both kernels' per-launch device times, assign_linear at d' = 128 and
20,000, matmul, at one serving step of 8192 rows; ``kernel_check_wide``: loglik_gauss and assign_gauss past
d = 256, at d = 300 and 512, with ragged rows bitwise the whole's). Then
it runs
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
(``serve_<family>``, ``serve_gaussian_d256``). A d = 384 Gaussian model
built from labelled points of its mixture is served the same way
(``serve_gaussian_wide``). Fits past the one-read sweep's slots and past
d = 256: ``fit_k_large`` fits 100,000 x 16 points with ``k_max=4096,
compact=False`` (every sweep on the 4096-slot slab, past the one-read
kernels' 2048 slots: ``sweep_ref``) and with ``k_max=10000`` (its init
folds past one slot window's 8192: two windows); ``fit_gaussian_wide``
fits 400,000 x 384 points (8 true clusters; ``sweep_ref``, its label
folds in stat windows of at most 1 GiB of partials), each to NMI >= 0.9
with ms/iter and peak device bytes. ``kernel_check_windows`` holds
``suffstats_labels``, ``moments_labels``, ``sub_assign_gauss`` and the
dense oracle against their plain versions past one slot window (K = 8193
and 16,384: a launch a window), past d = 256 (d = 300 and 384: the
Gram tiles, the sub-factors' column panels, the dense panel tile) and at
``fit_k_large``'s shapes (a stat window of 50,176 x 16 points over
10,000 slots; 100,000 x 16 over the 4096-slot slab), and ``assign_linear``
and ``sub_assign_linear`` past the one-read sweep's 2048 slots (K = 4096
and 10,000; step (f) under labels in [-1, K]). ``kernel_times`` also
times the serving kernels at one step, and ``assign_linear`` and
``sub_assign_linear`` alone (``run_ms``) at the 8192-row multinomial and
diagonal-Gaussian serving steps, the three-pass multinomial fit's final
state (200,000 x 128), the multinomial fit's (10^6 x 128) and the
20newsgroups width. ``kernel_check_three_pass`` holds
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
ladder of sizes and at the serving products (8192 and 256 rows, K = 32
and 128, 16 slots).

Every stat fold of every fit runs through ``fold_partials`` (the per-block
partials of every field added to the running accumulator left to right,
all the fields of a fold in one launch); ``fold_check`` holds it bitwise
against the plain loop of adds at the d = 32 fit's final state and times
the one launch beside the three one-field launches a fold took before and
the bound. The tiled (out-of-core) plane: ``fit_tiled`` fits the ``fit``
phase's data and seed from a .npy file through ``HostTiledSource.from_npy``
in 65,536-row tiles, and must give the resident fit's labels, K/score
history and stats bit for bit; ``fit_tiled_multinomial`` does the same
for ``fit_multinomial``; ``fit_tiled_faults`` runs ``fit_tiled`` through
seeded read faults (``FaultInjectingSource``: io, nan, short) and must give
the same labels and list every fault; ``fit_tiled_large`` fits 10^7 x 32
points kept in host memory (NMI >= 0.9, device bytes at most 1.5x
``fit_tiled``'s and under a quarter of x's). Each reports ms/iter, the
device bytes above those at the fit's start, the reference's estimate and
the share of the fit the compute stream waited on tile copies.
``fit_resume`` fits ``fit``'s data and seed for 15 iterations (a
``log_every`` chunk cut in two), writes the state with ``save_model``,
reads it with ``load_model`` and fits 25 more from ``init_state``:
labels, K/score history and every state tensor must equal the
40-iteration ``fit`` bit for bit; then the same on the tiled plane
against ``fit_tiled``.
``fit_resilience``: the ``fit`` config with a checkpoint rotation every
10 iterations, stopped after 20, then ``fit(resume=True)`` to 40, bitwise
the ``fit`` phase's chain on both planes (with the seconds a member
takes); a child process at 200,000 x 32 that SIGKILLs itself after its
second member, resumed bitwise by this process; an inf row that ends in
``DivergenceError`` after ``max_recoveries + 1`` rollbacks, then a small
fit that must pass (the CUDA context survived); a NaN tile let through
(``guard_tiles=False``) into a split/merge pass: one rollback, NMI >=
0.9; guardrails on and off in turns (ms/iter, equal labels).
``fit_multichain``: 4 chains at 10^6 x 32 (chain 2 bitwise the single
fit of key ``fold_in(key, 2)``, ``select_best`` NMI >= 0.9, rhats,
ms/iter and peak bytes against one chain), and 2 chains on the tiled
plane at 200,000 x 32, bitwise the resident 2-chain fit and reading each
tile as often as one chain. ``fit_k_auto``: ``k_max='auto'`` at 10^6 x
32 (the slab after each chunk, K = 16, NMI >= 0.9, a second run bitwise).
``serve_refine``: the 10^6 x 32 Gaussian and 10^6 x 128 multinomial
models served with ``ServeConfig(refine=True)`` (refine_batch 1024):
refinement on answers bitwise as the static engine before any refine; the
first refinement sweep through the kernels against the same sweep on the
sweep kernel's plain version (same model, keys and card: labels equal but
counted near-ties, blended stats within STATS_RTOL); 32,768 rows of the
fit's mixture with every cluster mean moved by one fixed offset (far
enough that the static model mislabels a few of them), queried and
folded (32 sweeps, 32 epochs published, p50 / p99 ms of one sweep,
NMI of ``predict`` and mean log p(x) before and after, the device time of
``sweep_gauss`` / ``sweep_linear`` and ``fold_partials`` a sweep from
``torch.profiler``); on the Gaussian model a batch of 1e30 rows ends in
``refine_rejected`` with the answers bitwise unchanged. ``fit_workers``:
the elastic multi-process fit (``DPMMConfig(workers=N)``: a coordinator
and N worker processes on the one card) of the 10^6 x 32 Gaussian from an
.npy in 65,536-row tiles with N = 1, 2 and 4, each bitwise the
single-process tiled fit of the same configuration (16 iterations, cut
from 40: every pass ships 0.26–0.53 GB of stat partials through sockets);
with 2 workers a worker SIGKILL'd at iteration 12 and a worker hung on its
first read (killed at a 5 s deadline), both bitwise; the 10^6 x 128
multinomial with 2 workers, bitwise; ms/iter against the single-process
fit, bytes of partials a pass, seconds from spawn to READY, the peak
device bytes of the coordinator and of each worker, and the launches of
both sides (the workers report theirs with their results).
``fit_mesh``: one fit over a device mesh (``DPMM(cfg, mesh=)``): the
10^6 x 32 Gaussian on 1, 2 and 4 data shards, shard s on card s mod the
cards present (logical shards on one card): G = 1 bitwise the ``fit``
phase's chain; G = 2 and 4 twice each (bitwise, the chain's digest
printed), their labels against G = 1 counted, NMI >= 0.9; ms/iter, peak
bytes per card, the bytes a cross-shard reduction gathers a pass, each
shard's launches of ``sweep_gauss``, ``suffstats_labels`` and
``fold_partials``; then the tiled fit on 2 shards from an .npy in
65,536-row tiles, bitwise the resident 2-shard chain.
``fit_feature_shard``: the 10^6 x 128 multinomial on a (2 x 2) mesh
with ``shard_features`` (each data shard's features in two slices: the
plain route, ``moments_labels`` a slice) against the (2 x 1) mesh:
labels differing counted, K, NMI >= 0.9, two (2 x 2) runs bitwise.
Every phase but these two fits on one card, however many the machine
holds. ``--mesh-only`` runs just the build, ``fit`` and these two phases
(on several cards a G-shard chain's digest must equal the one-card
run's), and prints no result line.
The LM zoo (no kernel of its own; plain PyTorch): ``lm_smoke`` runs the
four dense-attention archs at smoke size, the card's logits against the
port on the CPU (same weights, same tokens) within 1e-5, decode against
forward and the sliding-window ring within 1e-4; ``serve_lm`` serves
``gemma2-9b`` at full width and depth (random float32 weights drawn on the
card, then a bfloat16 copy) on ``examples/serve_lm.py``'s request: decode
against one forward within 1e-4 at float32, a greedy rerun identical, ms a
step (event and host clocks) beside the bytes bound, tokens/s, peak
bytes; ``lm_embed_cluster`` runs ``examples/cluster_embeddings.py`` at
its own sizes, the card's embeddings against the CPU's within 1e-5, then
the DPGMM fit on the card (K and NMI printed). ``--lm-only`` runs just
the build and these three phases, and prints no result line.
``kernel_check_dense`` holds the dense ``suffstats`` oracle (its entry
point ``ops.suffstats``) against its plain version at the d = 32 and d =
128 fits' final states, a ragged shape, d = 256 and the reference's §4.2
shapes, and against ``suffstats_labels`` on the segments' one-hot, and
times it beside the library route. ``matmul``, the dense oracle,
``sweep_gauss``, ``suffstats_labels``, ``sub_assign_gauss``
(``kernels_d256``, ``kernel_check_three_pass``) and ``sweep_linear`` (the
multinomial fit's state and the 20newsgroups width, ``kernel_times``)
are timed two ways: the median single-call time (``cuda_ms``, host time
included: what one caller sees) and the per-launch device time of a run
of back-to-back calls (``run_ms``, with the host's enqueue time a call).
A call of ``sub_assign_gauss`` is three launches (label histogram,
placement, product) and one of ``sweep_linear`` two ((e) + (f), then the
fold); the launch checks and the kernels line count them all. Each phase
prints one JSON line;
any failed check raises, so the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``.

``--profile TRACE.json`` adds two phases: after the Gaussian fit and after
the multinomial fit, the same fit again under ``torch.profiler``, reported
as device-busy time, idle share and the heaviest device-side events, with
the Chrome traces written to TRACE.json and TRACE_multinomial.json; and
in ``serve_lm`` each dtype's decode step split by kind of op
(``torch.profiler``) and each weight product of the step timed alone.

Needs a CUDA device and the repository's ``src/`` beside this file; it
exits non-zero without either. It imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import signal
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
# Kernels every fit path launches, by family route.
GAUSS_PATH = ("sweep_gauss", "suffstats_labels", "fold_partials")
LINEAR_PATH = ("sweep_linear", "moments_labels", "fold_partials")
# The tiled plane: rows of a tile (64 fold blocks, the reference's
# default; 16 tiles at N = 10^6), the 10^7-point fit (1.28 GB of x in host
# memory) cut to 20 iterations to keep it under a minute, and the seeded
# read faults (no hangs) of fit_tiled_faults.
TILE = 65_536
LARGE_N = 10_000_000
LARGE_CFG = dict(k_max=64, iters=20, burnout=10, log_every=10)
FAULTS = dict(seed=5, p_io=0.05, p_nan=0.05, p_short=0.05)
# The dense suffstats oracle: its soft rows, and the reference's own §4.2
# comparison shapes (N, K, d) (benchmarks/bench_kernels.py).
DENSE_REF_SHAPES = ((2_000, 16, 16), (10_000, 32, 32))
DENSE_D256_N = 100_000
# Past d = 256 (the panel layout of assign_gauss / loglik_gauss): the
# widths held against the plain versions at one serving step, and a served
# d = 384 model built from labelled points of its mixture (fit_gaussian_wide
# fits one).
WIDE_CHECK_DS = (300, 512)
WIDE_SERVE_D, WIDE_SERVE_FIT_N, WIDE_SERVE_K_MAX = 384, 40_000, 32
# The Gaussian fit past d = 256 (every sweep through sweep_ref, whose
# stat and step-(f) kernels take any d): d = 384, 8 true clusters of 50,000
# points on average (tools/split_evidence.py: the NIW evidence splits all
# 28 pairs at 400,000 points; at 16 clusters of 25,000 it merges 38 of 120).
WIDE_FIT_N, WIDE_FIT_D, WIDE_FIT_K = 400_000, 384, 8
# Fits past the one-read sweep's 2048 slots and one stat window's 8192, at
# a small N and d: a 4096-slot dense slab (compact off: every sweep through
# sweep_ref), and k_max = 10,000 (its init folds run two slot windows).
K_LARGE_N, K_LARGE_D = 100_000, 16
K_LARGE_FITS = (("k4096_dense", dict(k_max=4096, compact=False)),
                ("k10000", dict(k_max=10_000)))
# The stat and step-(f) kernels past one slot window and past d = 256
# against their plain versions: (name, N, d, K). The last two are
# fit_k_large's shapes: one stat window of its k_max = 10,000 init fold
# (49 STATS_BLOCKs at d = 16) and its 4096-slot dense slab.
# assign_linear and sub_assign_linear past the one-read sweep's 2048 slots:
# (name, N, d', K)
LINEAR_WINDOW_CASES = (("linear_k4096", 20_000, 128, 4096),
                       ("linear_k10000", 20_000, 64, 10_000))
# the resumed chains: iterations before the save (not a multiple of
# log_every: a chunk is cut in two)
RESUME_AT = 15
# Fault tolerance, multi-chain and k_max='auto' (fit_resilience,
# fit_multichain, fit_k_auto): a rotation member every CKPT_EVERY
# iterations, a stop after RESUME_STOP, the smaller fits (a SIGKILL'd child,
# an inf row, a NaN tile, C = 2 on the tiled plane) at RESIL_N x FIT_D, the
# NaN tile's read call (RESIL_N rows are 4 tiles of TILE: two init passes
# and FIT_CFG's 10 sweeps before it, so it is the first tile of iteration
# 10's split/merge pass), guardrails on / off turns and the chains of the
# resident multi-chain fit.
CKPT_EVERY, RESUME_STOP = 10, 20
RESIL_N = 200_000
NAN_CALL = 4 * (2 + 10) + 4
GUARD_TURNS = 2
MULTI_C = 4
# Online refinement (serve_refine): rows of shifted traffic (the default
# refine_buffer), sweeps profiled for the kernels' device time, and the
# offsets: the Gaussian mixture's points moved by a fixed vector of
# N(0, REFINE_SHIFT^2) entries, the multinomial's by a fixed count vector
# of REFINE_COUNTS trials of one Dirichlet(1) vector: every cluster's mean
# moves by the same offset, far enough that the static model mislabels a
# few rows (NMI of predict below 1 before refinement; 4.0 and 20 moved no
# label).
REFINE_ROWS, REFINE_PROFILED = 32_768, 8
REFINE_SHIFT, REFINE_COUNTS = 8.0, 60
# The elastic multi-process fit (fit_workers): worker counts on the one
# card, the fits' depth (cut from FIT_CFG's 40 iterations: every pass of a
# distributed iteration ships its partials through sockets), the
# iteration whose start SIGKILLs a worker, the hung read's deadline.
WORKER_COUNTS = (1, 2, 4)
WORKER_CFG = dict(k_max=64, iters=16, burnout=10, log_every=10)
WORKER_KILL_AT = 12
WORKER_DEADLINE_S = 5.0
# The mesh (fit_mesh): data shards of the 10^6 x 32 fit, shard s on card
# s mod the cards present (logical shards on one card).
MESH_SHARDS = (1, 2, 4)
# The LM zoo (lm_smoke, serve_lm, lm_embed_cluster): the dense-attention
# archs, the card's logits against the CPU's on the same weights (float32
# sums in another order) and decode against forward (test_zoo.py's bound).
LM_DENSE = ("granite-8b", "starcoder2-7b", "gemma2-9b", "mistral-large-123b")
LM_RTOL, LM_DECODE_RTOL = 1e-5, 1e-4
# serve_lm: gemma2-9b at full width and depth, examples/serve_lm.py's
# request (batch, prompt, steps, cache length); decode against one forward
# over the answer at float32 (TF32 off)
SERVE_LM_ARCH = "gemma2-9b"
SERVE_LM_BATCH, SERVE_LM_PROMPT, SERVE_LM_STEPS = 4, 8, 48
SERVE_LM_CACHE = 256
SERVE_LM_RTOL = 1e-4
# --profile: decode steps of the served model under torch.profiler
SERVE_LM_PROFILE_STEPS = 8
# lm_embed_cluster: examples/cluster_embeddings.py's sizes. The card's
# mean-pooled embeddings are held against the port's on the CPU (same
# weights, same tokens) at LM_RTOL; K and NMI are readings, not gates: the
# reference example's own CPU result is K = 1, NMI = 0.000 (120 points a
# domain at d = 256 are too few for the NIW evidence to split), so its
# floor would gate nothing. The fit's sweeps all take sweep_ref at d = 256.
EMBED_DOMAINS, EMBED_DOCS, EMBED_SEQ, EMBED_BATCH = 6, 120, 64, 32
EMBED_PATH = ("assign_gauss", "sub_assign_gauss", "suffstats_labels",
              "fold_partials")
WINDOW_CASES = (("k8193", 20_000, 3, 8193), ("k16384", 20_000, 3, 16_384),
                ("d300", 20_000, 300, 5), ("d384", 20_000, 384, 5),
                ("fold_k10000", 50_176, K_LARGE_D, 10_000),
                ("slab_k4096", K_LARGE_N, K_LARGE_D, 4096))


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


def run_ms(fn, runs: int) -> tuple:
    """(per-launch device ms, per-call host ms) of ``runs`` back-to-back
    calls, after a warm-up. The host time is the enqueue time of the calls
    by the host clock. For the device time the calls are queued behind a
    spin kernel that outlasts their enqueue, so that the card runs them
    back to back: one event before them, one after, divided by ``runs``.
    ``cuda_ms`` of a call whose host time exceeds its device time reads
    the host time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / runs
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    # 2e6 cycles a ms: above the card's top SM clock, so the spin lasts at
    # least twice the enqueue
    torch.cuda._sleep(int(2e6 * (2 * host_ms * runs + 1)))
    e0.record()
    for _ in range(runs):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / runs, host_ms


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


def run_fit(DPMM, cfg, x_np, y_np, kernels, gpu, phase: str,
            emit_phase: bool = True):
    """``DPMM(cfg).fit`` on the card with every launch count set to 0 just
    before and read just after; emits ``phase`` (or, without
    ``emit_phase``, keeps its fields in ``run_fit.report``) and raises
    unless the output is well formed, NMI >= 0.9 and each of ``kernels``
    launched. Returns the fit's result and its launch counts."""
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
    run_fit.report = dict(
        component=cfg.component, n=n, d=d, k_max=cfg.k_max,
        compact=cfg.compact, k_true=int(y_np.max()) + 1, k_found=res.k,
        nmi=nmi, ari=res.ari(y_np), iters=cfg.iters, wall_s=wall,
        steady_ms_per_iter=1e3 * float(np.mean(steady)),
        first_chunk_ms_per_iter=1e3 * float(np.mean(
            res.iter_times_s[:cfg.log_every])),
        peak_bytes=res.peak_bytes, launches=launches,
        launches_per_iter={k: v / cfg.iters for k, v in launches.items()},
        labels_in_inactive_slots=in_inactive,
        k_history=res.history["k"].tolist(), nvidia_smi=gpu)
    if emit_phase:
        emit(phase, **run_fit.report)
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
        **dict(zip(("device_ms", "host_ms"), run_ms(
            lambda: sweep.sweep_linear_cuda(*args), 20))),
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
    launches bitwise equal. The Gaussian kernels' rows of ragged requests
    (through other slot groups of ``assign.gauss_plan``) are bitwise those
    of the whole request, and both kernels' per-launch device times
    (``run_ms``) at the step are given."""
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
        plans = {}
        for lo, hi in ((0, 1), (5, 305), (1000, 3048)):
            part = (args[0][lo:hi].contiguous(),) + args[1:6] + (
                args[6][lo:hi].contiguous(),) + args[7:]
            if not (torch.equal(loglik.loglik_cuda(*part[:4]), ll[lo:hi])
                    and torch.equal(assign.assign_gauss_cuda(*part),
                                    lab[lo:hi])):
                fail(f"d={d}: the rows of a {hi - lo}-row request differ "
                     "from the whole's")
            plans[hi - lo] = assign.gauss_plan(hi - lo, d, SERVE_KC).groups
        ties = assign_ties(assign, True, args, lab,
                           assign.assign_gauss_plain(*args))
        times = {}
        for name, fn in (("assign_gauss",
                          lambda: assign.assign_gauss_cuda(*args)),
                         ("loglik_gauss",
                          lambda: loglik.loglik_cuda(*args[:4]))):
            times[f"{name}_device_ms"], times[f"{name}_host_ms"] = run_ms(
                fn, 100)
        out[f"gauss_d{d}"] = {
            "plan": assign.gauss_plan(SERVE_B, d, SERVE_KC)._asdict(),
            "ragged_groups": plans,
            "loglik_gauss_max_abs_err": rel_err(
                ll, loglik.loglik_plain(*args[:4]), SERVE_RTOL,
                f"loglik_gauss d={d}"),
            "assign_gauss_near_tie_mismatches": ties, **times}
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


def check_wide_kernels(assign, loglik, dev) -> dict:
    """``loglik_gauss`` and ``assign_gauss`` past d = 256 (the panel
    layout) against their plain versions at one serving step of SERVE_B
    rows (the ``kernel_check_serve`` operands at d in WIDE_CHECK_DS):
    log-likelihoods within SERVE_RTOL, labels exact except float64-proven
    near-ties, repeat launches and the rows of a ragged request bitwise
    equal, and each timed."""
    out = {}
    for d in WIDE_CHECK_DS:
        args = gauss_step_e_args(SERVE_B, d, SERVE_KC, SERVE_LIVE, dev,
                                 seed=d)
        ll = loglik.loglik_cuda(*args[:4])
        lab = assign.assign_gauss_cuda(*args)
        torch.cuda.synchronize()
        if not (torch.equal(ll, loglik.loglik_cuda(*args[:4]))
                and torch.equal(lab, assign.assign_gauss_cuda(*args))):
            fail(f"d={d}: two launches on the same inputs differ")
        lo, hi = 5, 305
        part = (args[0][lo:hi].contiguous(),) + args[1:6] + (
            args[6][lo:hi].contiguous(),) + args[7:]
        if not (torch.equal(loglik.loglik_cuda(*part[:4]), ll[lo:hi])
                and torch.equal(assign.assign_gauss_cuda(*part),
                                lab[lo:hi])):
            fail(f"d={d}: a ragged request's rows differ from the whole's")
        plan = assign.panel_plan(SERVE_B, d, SERVE_KC)
        out[f"gauss_d{d}"] = {
            "plan": plan._asdict(),
            "loglik_gauss_max_abs_err": rel_err(
                ll, loglik.loglik_plain(*args[:4]), SERVE_RTOL,
                f"loglik_gauss d={d}"),
            "assign_gauss_near_tie_mismatches": assign_ties(
                assign, True, args, lab, assign.assign_gauss_plain(*args)),
            "loglik_gauss_ms": cuda_ms(
                lambda: loglik.loglik_cuda(*args[:4]), 20),
            "loglik_plain_ms": cuda_ms(
                lambda: loglik.loglik_plain(*args[:4]), 3),
            "assign_gauss_ms": cuda_ms(
                lambda: assign.assign_gauss_cuda(*args), 20),
            "assign_plain_ms": cuda_ms(
                lambda: assign.assign_gauss_plain(*args), 3)}
    return out


def synthetic_gauss_state(x_np, y_np, k_max: int, dev):
    """A Gaussian ``ModelState`` of the mixture ``x_np`` was drawn from,
    without a fit: the stats of the generator's labels (sub-labels by
    point parity) summed on the card, posterior-mean parameters from the
    fit's default prior (random means, well-conditioned factors), weights
    from the counts, the first 16 of ``k_max`` slots live."""
    import types
    from repro_torch.configs import DPMMConfig
    from repro_torch.core import niw
    from repro_torch.core.state import ModelState
    x = torch.as_tensor(x_np, device=dev)
    n, d = x.shape
    seg = (torch.as_tensor(y_np, device=dev).long() * 2
           + torch.arange(n, device=dev) % 2)
    n2 = torch.zeros(2 * k_max, device=dev).index_add_(
        0, seg, torch.ones(n, device=dev))
    sx2 = torch.zeros(2 * k_max, d, device=dev).index_add_(0, seg, x)
    sxx2 = torch.zeros(2 * k_max, d, d, device=dev)
    for s_ in torch.unique(seg).tolist():
        xs = x[seg == s_]
        sxx2[s_] = xs.T @ xs
    sub = niw.GaussStats(n2.view(k_max, 2), sx2.view(k_max, 2, d),
                         sxx2.view(k_max, 2, d, d))
    stats = niw.GaussStats(sub.n.sum(1), sub.sx.sum(1), sub.sxx.sum(1))
    prior = niw.build_prior(DPMMConfig(), x.mean(dim=0, keepdim=True))
    active = stats.n > 0
    logw = torch.where(active, torch.log(stats.n.clamp(min=1) / n),
                       -1e30).to(torch.float32)
    sublogw = torch.log(sub.n.clamp(min=1)
                        / stats.n.clamp(min=2)[:, None]).to(torch.float32)
    state = ModelState(
        key=torch.zeros(2, dtype=torch.int64, device=dev), it=0,
        active=active, logweights=logw, sub_logweights=sublogw,
        stuck=torch.zeros(k_max, dtype=torch.int32, device=dev),
        params=niw.expected_params(prior, stats),
        subparams=niw.expected_params(prior, sub), stats=stats,
        substats=sub)
    return types.SimpleNamespace(state=state)


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
    xf = torch.as_tensor(x_fit, device=eng.device)
    prior = fam.build_prior(DPMMConfig(component=fam_name),
                            xf.mean(dim=0, keepdim=True))
    nxt = gibbs.sweep_model(res.state, prior, fam, DPMMConfig().alpha)
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


def shifted_traffic(synthetic, gen_name: str, n: int, d: int, seed: int):
    """``n`` rows of the fit's mixture (the generator at ``seed``) with
    every cluster's mean moved by one fixed offset (REFINE_SHIFT,
    REFINE_COUNTS), and their labels."""
    x, y = getattr(synthetic, gen_name)(n, d, FIT_K, seed=seed)
    rng = np.random.default_rng(seed + 1)
    if gen_name == "generate_gmm":
        off = rng.normal(0.0, REFINE_SHIFT, size=d)
    else:
        off = rng.multinomial(REFINE_COUNTS, rng.dirichlet(np.ones(d)))
    return (x + off).astype(np.float32), y


def plain_sweep_family(fam):
    """``fam`` with its one-read sweep on the kernel's plain version (the
    fold stays ``fold_partials``: the same IEEE adds either way)."""
    import dataclasses
    from repro_torch.core import niw
    from repro_torch.kernels import sweep as ksweep
    if fam.name == "gaussian":
        def fused(x, valid, p, sp, logw, sublogw, active, gidx, kz, kzb,
                  slots):
            mu, f, ld, smu, sf, sld = niw.sweep_pack(p, sp)
            lab, sub, *parts = ksweep.sweep_gauss_plain(
                x, mu, f, ld, logw, active, smu, sf, sld, sublogw, valid,
                gidx, kz, kzb, slots)
            return lab, sub, niw.GaussStats(*parts)
    else:
        mod = fam.module

        def fused(x, valid, p, sp, logw, sublogw, active, gidx, kz, kzb,
                  slots):
            feats, w, const, subw, subconst = mod.sweep_pack(x, p, sp)
            lab, sub, n2, sf2 = ksweep.sweep_linear_plain(
                feats, w, const, logw, active, subw, subconst, sublogw,
                valid, gidx, kz, kzb, slots)
            return lab, sub, mod.stats_from_moments(n2, sf2)
    return dataclasses.replace(fam, fused_sweep=fused)


def refine_sweep_args(fam, model, x, valid, gibbs, prng):
    """The one-read sweep kernel's arguments in a refinement sweep of
    ``model`` (after steps (a)-(d)) over the batch ``x``: the dense slab,
    the keys of its ``(key, it)``, the batch row index."""
    keys = gibbs.sweep_keys(model)
    dev = x.device
    kz, kzb = (prng.key_tensor(keys[4], dev), prng.key_tensor(keys[5], dev))
    k = model.active.shape[0]
    act = model.active.to(torch.int32)
    slots = torch.arange(k, device=dev, dtype=torch.int32)
    gidx = torch.arange(x.shape[0], device=dev)
    if fam.name == "gaussian":
        from repro_torch.core import niw
        mu, f, ld, smu, sf, sld = niw.sweep_pack(model.params,
                                                 model.subparams)
        args = (x, mu, f, ld, model.logweights, act, smu, sf, sld,
                model.sub_logweights, valid, gidx, kz, kzb, slots)
    else:
        feats, w, const, subw, subconst = fam.module.sweep_pack(
            x, model.params, model.subparams)
        args = (feats, w, const, model.logweights, act, subw, subconst,
                model.sub_logweights, valid, gidx, kz, kzb, slots)
    return tuple(a.contiguous() for a in args)


def refine_check(fam, eng, xb, gibbs, prng, sweep) -> dict:
    """The engine's first refinement sweep against the plain path on the
    same model and keys: the labels of the kernel and of its plain version
    on the sweep's arguments (mismatches only as counted near-ties), the
    engine's sweep through the kernels bitwise the kernel's labels, and
    its blended stats against the plain path's within STATS_RTOL."""
    import dataclasses
    from repro_torch.configs import DPMMConfig
    alpha = DPMMConfig().alpha
    step, prior = eng._refine_setup(eng._served)
    dev = eng.device
    x = torch.as_tensor(xb, device=dev)
    valid = torch.ones(x.shape[0], device=dev)
    model = eng.model
    post = gibbs.sweep_model(model, prior, fam, alpha)
    args = refine_sweep_args(fam, post, x, valid, gibbs, prng)
    gauss = fam.name == "gaussian"
    kern = sweep.sweep_gauss_cuda if gauss else sweep.sweep_linear_cuda
    plain = sweep.sweep_gauss_plain if gauss else sweep.sweep_linear_plain
    mism = sweep.label_mismatches if gauss else sweep.label_mismatches_linear
    out_k, out_p = kern(*args), plain(*args)
    ties = near_ties(mism, args, out_k, out_p)
    m_k, ok, lab_k = step(model, x, valid, prior)
    decay = eng.cfg.refine_decay
    m_p, lab_p = gibbs.refine_sweep(model, x, valid, prior,
                                    plain_sweep_family(fam), alpha,
                                    decay=decay)
    if not (bool(ok) and torch.equal(lab_k, out_k[0])):
        fail(f"serve_refine {fam.name}: the engine's sweep is not the "
             "kernel's, or unhealthy")
    worst = 0.0
    for group in ("stats", "substats"):
        gk, gp = getattr(m_k, group), getattr(m_p, group)
        for f in dataclasses.fields(gk):
            a, b = getattr(gk, f.name), getattr(gp, f.name)
            if f.name == "n" and ties == 0 and not torch.equal(a, b):
                fail(f"serve_refine {fam.name}: blended counts differ")
            err = (a - b).abs()
            if bool((err > STATS_RTOL * (b.abs() + b.abs().max())).any()):
                fail(f"serve_refine {fam.name}: blended {group}.{f.name} "
                     f"beyond rtol {STATS_RTOL}: {float(err.max())}")
            worst = max(worst, float(err.max()))
    return {"rows": int(x.shape[0]), "slots": int(model.active.shape[0]),
            "near_tie_mismatches": ties, "max_abs_err": worst,
            "labels_equal_plain": bool(torch.equal(lab_k, lab_p)),
            "it_after": int(m_k.it)}


def refine_kernel_ms(step, shadow, batches, prior) -> dict:
    """Device ms of each refinement kernel in one sweep (torch.profiler
    over REFINE_PROFILED sweeps, the kernels' events by name), or
    "not measured" when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = {"sweep_gauss": ("sweep_assign_tiled", "sweep_gauss"),
             "sweep_linear": ("sweep_linear_ef", "sweep_linear_fold"),
             "fold_partials": ("fold_fields_kernel",)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for xb, valid in batches[:REFINE_PROFILED]:
            shadow, ok, _ = step(shadow, xb, valid, prior)
            bool(ok)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    out = {}
    for kernel, keys in names.items():
        us = sum(_device_us(e) for e in events
                 if any(k in e.key for k in keys))
        out[kernel] = (us * 1e-3 / REFINE_PROFILED if events
                       else "not measured")
    out["device_busy_ms"] = (sum(_device_us(e) for e in events) * 1e-3
                             / REFINE_PROFILED if events
                             else "not measured")
    return out


def serve_refine(models, synthetic, gpu) -> tuple:
    """Online refinement on the card (``serve_refine``): each fitted
    model served with ``ServeConfig(refine=True)`` (refine_batch 1024);
    refinement off answers bitwise as the static engine; the first sweep
    against the plain path; REFINE_ROWS shifted rows queried and folded
    (sweeps, epochs published, p50 / p99 ms of one sweep, NMI of predict
    on the shifted rows before and after, the kernels' device time a
    sweep); on the Gaussian model a batch of 1e30 rows (1e30^2 overflows
    its sxx stat) ends in ``refine_rejected`` with the answers bitwise
    unchanged. Every launch count is set to 0 before each
    engine's main path (query, refine) and read after it. Returns the
    report and the launches."""
    from repro_torch.core import gibbs
    from repro_torch.core.family import get_family
    from repro_torch.core.metrics import nmi
    from repro_torch.kernels import ops, prng, sweep
    from repro_torch.serve.dpmm import DPMMEngine, ServeConfig
    report, launches = {}, {}
    for name, (res, gen_name, d) in models.items():
        fam = get_family(name)
        xq, yq = shifted_traffic(synthetic, gen_name, REFINE_ROWS, d, 0)
        static = DPMMEngine(res.state, name)
        eng = DPMMEngine(res.state, name, ServeConfig(refine=True))
        before = eng.query(xq)
        ref = static.query(xq)
        if not all(np.array_equal(getattr(before, f), getattr(ref, f))
                   for f in ("labels", "logprobs", "log_predictive")):
            fail(f"serve_refine {name}: refinement on changed an answer "
                 "before any refine")
        eng._traffic, eng._traffic_rows = [], 0
        k_true = int(yq.max()) + 1
        score = lambda r: nmi(torch.as_tensor(yq), torch.as_tensor(
            r.labels), k_true, eng.k_max)
        nmi_before = score(before)
        lpd_before = float(np.mean(before.log_predictive))
        b = eng.cfg.refine_batch
        check = refine_check(fam, eng, xq[:b], gibbs, prng, sweep)
        # one sweep's time, the engine's step and its one host read
        step, prior = eng._refine_setup(eng._served)
        xt = torch.as_tensor(xq, device=eng.device)
        ones = torch.ones(b, device=eng.device)
        batches = [(xt[i:i + b], ones) for i in range(0, REFINE_ROWS, b)]
        shadow, times = eng.model, []
        for xb, valid in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            shadow, ok, _ = step(shadow, xb, valid, prior)
            healthy = bool(ok)
            times.append(time.perf_counter() - t0)
            if not healthy:
                fail(f"serve_refine {name}: a clean sweep was unhealthy")
        kernel_ms = refine_kernel_ms(step, eng.model, batches, prior)
        # the main path: the traffic through query (buffered), then refine
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng.query(xq)
        out = eng.refine()
        torch.cuda.synchronize()
        refine_s = time.perf_counter() - t0
        launches[name] = ops.launch_counts()
        after = eng.query(xq)
        want = "sweep_gauss" if name == "gaussian" else "sweep_linear"
        for k in (want, "fold_partials"):
            if launches[name][k] == 0:
                fail(f"serve_refine {name}: kernel {k} never launched")
        if not (out["sweeps"] == REFINE_ROWS // b == out["published"]
                and out["rejected"] == 0 and after.model_epoch == out["epoch"]
                and np.isfinite(after.log_predictive).all()):
            fail(f"serve_refine {name}: refine summary {out}")
        report[name] = {
            "rows": REFINE_ROWS, "refine_batch": b, "d": d,
            "k_max": eng.k_max, "first_sweep": check,
            "sweep_ms": {"p50": 1e3 * float(np.percentile(times, 50)),
                         "p99": 1e3 * float(np.percentile(times, 99)),
                         "first": 1e3 * times[0]},
            "kernel_device_ms_per_sweep": kernel_ms,
            "summary": out, "query_and_refine_s": refine_s,
            "epochs_published": out["published"],
            "nmi_predict_before": nmi_before,
            "nmi_predict_after": score(after),
            "mean_log_predictive_before": lpd_before,
            "mean_log_predictive_after": float(np.mean(
                after.log_predictive)),
            "refine_off_bitwise_static": True, "launches": launches[name],
            "poisoned": None, "nvidia_smi": gpu}
        if name != "gaussian":
            continue
        # poison: a batch of 1e30 rows (1e30^2 overflows the sxx stat) is
        # rejected, the answers unchanged
        probe = xq[:SERVE_B]
        held = eng.query(probe)
        bad = eng.refine(x=np.full((b, d), 1e30, np.float32))
        again = eng.query(probe)
        if not (bad == {"sweeps": 0, "rows": 0, "rejected": 1,
                        "published": 0, "epoch": held.model_epoch}
                and eng.events[-1]["kind"] == "refine_rejected"
                and all(np.array_equal(getattr(held, f), getattr(again, f))
                        for f in ("labels", "logprobs", "log_predictive"))):
            fail(f"serve_refine {name}: the poisoned batch was not "
                 f"rejected cleanly: {bad}, {eng.events[-1]}")
        report[name]["poisoned"] = {"summary": bad,
                                    "event": eng.events[-1]["kind"],
                                    "answers_unchanged": True}
    return report, launches


def fit_workers(DPMM, DPMMConfig, HostTiledSource, x_np, y_np, xm_np,
                tmp: Path, gpu) -> tuple:
    """The elastic multi-process fit on the one card (``fit_workers``):
    the 10^6 x 32 Gaussian from an .npy in TILE-row tiles with 1, 2 and 4
    workers, each bitwise the single-process tiled fit of the same
    configuration (WORKER_CFG); with 2 workers a SIGKILL'd worker at
    iteration WORKER_KILL_AT and a worker hung on its first read (deadline
    WORKER_DEADLINE_S), both bitwise; the 10^6 x 128 multinomial with 2
    workers, bitwise. Each fit's launch counts are set to 0 just before it
    and read just after (the coordinator's; the workers' come back with
    their results). Returns the report and the launches summed over the
    fits."""
    import os
    import signal
    from repro_torch.dist import DistHooks
    from repro_torch.kernels import ops
    total: dict = {}
    report: dict = {"workers": {}, "cfg": WORKER_CFG, "tile": TILE}
    problems = []

    def run(cfg, src, name, hooks=None, want=None):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = DPMM(cfg).fit(src, dist_hooks=hooks)
        wall = time.perf_counter() - t0
        coord = ops.launch_counts()
        for k, v in coord.items():
            total[k] = total.get(k, 0) + v
        out = {"wall_s": wall, "k_found": res.k,
               "ms_per_iter": 1e3 * float(np.mean(res.iter_times_s)),
               "steady_ms_per_iter": 1e3 * float(np.mean(
                   res.iter_times_s[cfg.burnout:])),
               "peak_bytes": res.peak_bytes, "start_bytes": res.start_bytes}
        if res.dist is not None:
            for k, v in res.dist["worker_launches"].items():
                total[k] = total.get(k, 0) + v
            out.update(
                ready_s=res.dist["ready_s"],
                pass_bytes=res.dist["pass_bytes"],
                work_items=res.dist["work_items"],
                worker_peak_bytes=res.dist["worker_peak_bytes"],
                respawns=res.dist["respawns"],
                reassignments=res.dist["reassignments"],
                launches_coordinator=coord,
                launches_workers=res.dist["worker_launches"],
                failovers=[e for e in res.recoveries
                           if e["kind"] == "worker_failover"])
            if want is not None:
                out["bitwise_single"] = same_chain(res, want)
                out["state_bitwise"] = state_bits(res.state, want.state)
                if not (all(out["bitwise_single"].values())
                        and out["state_bitwise"]):
                    problems.append(f"{name}: not the single-process chain")
            for k in ("fold_partials",):
                if coord[k] == 0:
                    problems.append(f"{name}: the coordinator never "
                                    f"launched {k}")
        return res, out

    gpath, mpath = tmp / "xw.npy", tmp / "xm.npy"
    np.save(gpath, x_np)
    np.save(mpath, xm_np)
    gcfg = dict(WORKER_CFG, tile_size=TILE)
    single, report["single"] = run(DPMMConfig(**gcfg),
                                   HostTiledSource.from_npy(gpath), "single")
    for w in WORKER_COUNTS:
        _, report["workers"][str(w)] = run(
            DPMMConfig(workers=w, **gcfg), HostTiledSource.from_npy(gpath),
            f"workers={w}", want=single)
        lw = report["workers"][str(w)]["launches_workers"]
        if not (lw["sweep_gauss"] and lw["suffstats_labels"]):
            problems.append(f"workers={w}: the workers' kernels were not "
                            f"launched: {lw}")
    killed = []

    def killer(it, coord):
        if it == WORKER_KILL_AT and not killed:
            pid = coord.worker_pids()[0]
            os.kill(pid, signal.SIGKILL)
            killed.append(pid)

    _, report["sigkill"] = run(
        DPMMConfig(workers=2, **gcfg), HostTiledSource.from_npy(gpath),
        "sigkill", DistHooks(on_iteration=killer), want=single)
    if not (killed and report["sigkill"]["failovers"]):
        problems.append("sigkill: no worker_failover event")
    _, report["hang"] = run(
        DPMMConfig(workers=2, worker_deadline_s=WORKER_DEADLINE_S,
                   max_worker_retries=0, **gcfg),
        HostTiledSource.from_npy(gpath), "hang",
        DistHooks(worker_faults={0: {"schedule": {0: "hang"},
                                     "hang_s": 600.0}}), want=single)
    ev = report["hang"]["failovers"]
    if not (ev and "deadline" in ev[0]["detail"]
            and report["hang"]["reassignments"] >= 1):
        problems.append(f"hang: no deadline failover: {ev}")
    mcfg = dict(gcfg, component="multinomial")
    msingle, report["multinomial_single"] = run(
        DPMMConfig(**mcfg), HostTiledSource.from_npy(mpath),
        "multinomial single")
    _, report["multinomial"] = run(
        DPMMConfig(workers=2, **mcfg), HostTiledSource.from_npy(mpath),
        "multinomial workers=2", want=msingle)
    lw = report["multinomial"]["launches_workers"]
    if not (lw["sweep_linear"] and lw["moments_labels"]):
        problems.append(f"multinomial: the workers' kernels were not "
                        f"launched: {lw}")
    report["nmi_single"] = single.nmi(y_np)
    report["problems"] = problems
    report["nvidia_smi"] = gpu
    return report, total


def chain_digest(res) -> str:
    """sha256 of a fit's labels, histories and final stats and substats:
    equal digests, the same chain."""
    import hashlib
    h = hashlib.sha256(np.ascontiguousarray(res.labels).tobytes())
    for key in sorted(res.history):
        h.update(np.ascontiguousarray(res.history[key]).tobytes())
    for group in ("stats", "substats"):
        st = getattr(res.state, group)
        for f in st.__dataclass_fields__:
            h.update(getattr(st, f).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def mesh_fit(DPMM, cfg, mesh, src, y_np, total: dict) -> tuple:
    """``DPMM(cfg, mesh=mesh).fit(src)`` with the launch counts set to 0
    just before and read just after (added to ``total``): the result and
    its report."""
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = DPMM(cfg, mesh=mesh).fit(src)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    m = res.mesh
    per_pass = m["reduce_bytes"] / m["reductions"] if m["reductions"] else 0
    return res, {
        "mode": res.mode, "wall_s": wall, "k_found": res.k,
        "nmi": res.nmi(y_np),
        "ms_per_iter": 1e3 * float(np.mean(res.iter_times_s)),
        "steady_ms_per_iter": steady_ms(res, cfg),
        "peak_bytes_per_card": m.get("peak_bytes"),
        "start_bytes": res.start_bytes, "reductions": m["reductions"],
        "reduce_bytes": m["reduce_bytes"],
        "reduce_bytes_per_pass": per_pass, "n_local": m["n_local"],
        "devices": m["devices"],
        "shard_launches": [{k: v for k, v in sl.items() if v}
                           for sl in m["shard_launches"]],
        "launches": {k: v for k, v in launches.items() if v},
        "digest": chain_digest(res)}


def fit_mesh(DPMM, DPMMConfig, Mesh, HostTiledSource, x_np, y_np, whole,
             tmp: Path, gpu) -> tuple:
    """The 10^6 x 32 Gaussian fit (FIT_CFG) over a data mesh of 1, 2 and 4
    shards, shard s on card s mod count (``fit_mesh``): G = 1 bitwise the
    ``fit`` phase's chain ``whole``; G = 2 and 4 run twice (bitwise, the
    digest printed), their labels against G = 1 counted, NMI >= 0.9; then
    the tiled fit on 2 shards from an .npy in TILE-row tiles, bitwise the
    resident 2-shard chain. Returns the report and the launches summed
    over the fits."""
    cards = torch.cuda.device_count()
    total: dict = {}
    report: dict = {"cfg": FIT_CFG, "cards": cards, "shards": {}}
    problems = []
    cfg = DPMMConfig(**FIT_CFG)
    mesh = lambda g: Mesh([f"cuda:{s % cards}" for s in range(g)])
    one, rep = mesh_fit(DPMM, cfg, mesh(1), x_np, y_np, total)
    rep["bitwise_fit"] = same_chain(one, whole)
    rep["state_bitwise_fit"] = state_bits(one.state, whole.state)
    if not (all(rep["bitwise_fit"].values()) and rep["state_bitwise_fit"]):
        problems.append("G = 1 is not the fit phase's chain")
    report["shards"]["1"] = rep
    fits = {1: one}
    for g in MESH_SHARDS[1:]:
        a, rep = mesh_fit(DPMM, cfg, mesh(g), x_np, y_np, total)
        b, rep2 = mesh_fit(DPMM, cfg, mesh(g), x_np, y_np, total)
        rep["second_run"] = {k: rep2[k] for k in (
            "steady_ms_per_iter", "ms_per_iter", "wall_s", "digest")}
        rep["bitwise_second_run"] = same_chain(a, b)
        rep["labels_differing_from_g1"] = int((a.labels != one.labels).sum())
        rep["k_history_equal_g1"] = bool(np.array_equal(
            a.history["k"], one.history["k"]))
        rep["score_max_rel_diff_g1"] = float(np.max(
            np.abs(a.history["score"] - one.history["score"])
            / np.maximum(np.abs(one.history["score"]), 1.0)))
        if not (all(rep["bitwise_second_run"].values())
                and state_bits(a.state, b.state)):
            problems.append(f"G = {g}: two runs differ")
        if rep["nmi"] < 0.9:
            problems.append(f"G = {g}: NMI {rep['nmi']:.4f} < 0.9")
        for name in GAUSS_PATH[:2]:
            if not all(sl.get(name) for sl in rep["shard_launches"]):
                problems.append(f"G = {g}: a shard never launched {name}")
        if not rep["launches"].get("fold_partials"):
            problems.append(f"G = {g}: fold_partials never launched")
        report["shards"][str(g)] = rep
        fits[g] = a
    path = tmp / "xmesh.npy"
    np.save(path, x_np)
    tiled, rep = mesh_fit(DPMM, DPMMConfig(tile_size=TILE, **FIT_CFG),
                          mesh(2), HostTiledSource.from_npy(path), y_np,
                          total)
    rep["bitwise_resident"] = same_chain(tiled, fits[2])
    rep["copy_wait_s"], rep["read_s"] = tiled.copy_wait_s, tiled.read_s
    if not all(rep["bitwise_resident"].values()):
        problems.append("tiled 2-shard chain is not the resident one")
    report["tiled_2"] = rep
    report["problems"] = problems
    report["nvidia_smi"] = gpu
    return report, total


def fit_feature_shard(DPMM, DPMMConfig, Mesh, synthetic, gpu) -> tuple:
    """The 10^6 x 128 multinomial (FIT_CFG) on a (2 x 2) mesh with
    ``shard_features`` (each data shard's features in two slices: the
    plain route and ``moments_labels`` a slice) against the (2 x 1) mesh
    (``fit_feature_shard``): labels differing counted, K, NMI >= 0.9, two
    (2 x 2) runs bitwise. Cards as in ``fit_mesh``."""
    cards = torch.cuda.device_count()
    x_np, y_np = synthetic.generate_mnmm(1_000_000, 128, FIT_K, seed=0)
    total: dict = {}
    problems = []
    devs = [f"cuda:{s % cards}" for s in range(4)]
    cfg = dict(FIT_CFG, component="multinomial")
    data, rep21 = mesh_fit(DPMM, DPMMConfig(**cfg), Mesh(devs[:2]), x_np,
                           y_np, total)
    mesh22 = Mesh(np.array(devs, dtype=object).reshape(2, 2),
                  ("data", "model"))
    fcfg = DPMMConfig(shard_features=True, **cfg)
    a, rep22 = mesh_fit(DPMM, fcfg, mesh22, x_np, y_np, total)
    b, rep2 = mesh_fit(DPMM, fcfg, mesh22, x_np, y_np, total)
    rep22["second_run"] = {k: rep2[k] for k in (
        "steady_ms_per_iter", "ms_per_iter", "wall_s", "digest")}
    rep22["bitwise_second_run"] = same_chain(a, b)
    rep22["labels_differing_from_2x1"] = int((a.labels != data.labels).sum())
    rep22["k_history_equal_2x1"] = bool(np.array_equal(
        a.history["k"], data.history["k"]))
    if not (all(rep22["bitwise_second_run"].values())
            and state_bits(a.state, b.state)):
        problems.append("(2 x 2): two runs differ")
    for r, name in ((rep21, "(2 x 1)"), (rep22, "(2 x 2)")):
        if r["nmi"] < 0.9:
            problems.append(f"{name}: NMI {r['nmi']:.4f} < 0.9")
    if not all(sl.get("moments_labels") for sl in rep22["shard_launches"]):
        problems.append("(2 x 2): a shard never launched moments_labels")
    if not all(sl.get("sweep_linear") for sl in rep21["shard_launches"]):
        problems.append("(2 x 1): a shard never launched sweep_linear")
    return {"cfg": cfg, "cards": cards, "mesh_2x1": rep21,
            "mesh_2x2": rep22, "problems": problems,
            "nvidia_smi": gpu}, total


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
        **dict(zip(("device_ms", "host_ms"),
                   run_ms(lambda: loglik.loglik_cuda(*gargs[:4]), 100))),
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
        **dict(zip(("device_ms", "host_ms"),
                   run_ms(lambda: assign.assign_gauss_cuda(*gargs), 100))),
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
        **dict(zip(("device_ms", "host_ms"),
                   run_ms(lambda: assign.assign_linear_cuda(*largs), 100))),
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
        **dict(zip(("device_ms", "host_ms"),
                   run_ms(lambda: matmul.matmul_cuda(a, b), 100))),
        **dict(zip(("library_device_ms", "library_host_ms"),
                   run_ms(lambda: torch.matmul(a, b), 100))),
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
    reference keeps the paper's 640,000), by single-call time (what a
    caller sees) and by per-launch device time (``run_ms``). Also whether
    the library's first 256 rows of an 8192-row product equal a 256-row
    product's, the property the serving ladder needs of a row (the
    kernel's hold by construction)."""
    out = {}
    g = torch.Generator(device=dev).manual_seed(7)
    for d in (32, 128):
        rows, first, first_dev = [], None, None
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
            dev_k, host_k = run_ms(lambda: matmul.matmul_cuda(a, b), 100)
            dev_l, host_l = run_ms(lambda: torch.matmul(a, b), 100)
            rows.append({"n": n, "dn": d * n, "kernel_ms": ms_k,
                         "torch_matmul_ms": ms_l, "kernel_device_ms": dev_k,
                         "torch_matmul_device_ms": dev_l,
                         "kernel_host_ms": host_k,
                         "torch_matmul_host_ms": host_l})
            if first is None and ms_l < ms_k:
                first = d * n
            if first_dev is None and dev_l < dev_k:
                first_dev = d * n
        out[f"d{d}"] = {"rows": rows, "first_dn_library_faster": first,
                        "first_dn_library_faster_device": first_dev,
                        "cublas_rows_batch_invariant": invariant}
    # the serving products at the ladder's top and bottom step (N = 16
    # slots): the diagonal x^2 prec^T (K = 32) and the multinomial x W^T
    # (K = d' = 128)
    serving = {}
    for m, k in ((SERVE_B, 32), (SERVE_B, 128), (256, 32), (256, 128)):
        a = torch.randn(m, k, device=dev, generator=g)
        b = torch.randn(k, 16, device=dev, generator=g)
        r = {"kernel_ms": cuda_ms(lambda: matmul.matmul_cuda(a, b), 50),
             "torch_matmul_ms": cuda_ms(lambda: torch.matmul(a, b), 50)}
        r["kernel_device_ms"], r["kernel_host_ms"] = run_ms(
            lambda: matmul.matmul_cuda(a, b), 100)
        r["torch_matmul_device_ms"], r["torch_matmul_host_ms"] = run_ms(
            lambda: torch.matmul(a, b), 100)
        r["bound_ms"], r["bound_by"] = bound(
            2 * m * k * 16, 4 * (m * k + k * 16 + m * 16))
        serving[f"{m}x{k}x16"] = r
    out["serving"] = serving
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
        res = DPMM(cfg, device="cuda").fit(x_np)
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
    from repro_torch.kernels import ops, sweep
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
    # the sweeps count the kernels of a call (sweep_gauss: the tiled step
    # (e), then (f) + fold, above d = 16; sweep_linear: (e) + (f), then the
    # fold), and so does sub_assign_gauss (histogram, placement, product)
    from repro_torch.kernels import assign
    per_call = (sweep.launches_per_call(report["d"]) if gauss
                else sweep.LINEAR_LAUNCHES)
    f_per_call = assign.SUB_LAUNCHES if gauss else 1
    if not (lt[fused_k] == 0 and lt[step_e] == cfg.iters
            and lt[step_f] == f_per_call * cfg.iters
            and lt[fold] > 0 and lf[fused_k] == per_call * cfg.iters):
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
        out[name]["device_ms"], out[name]["host_ms"] = run_ms(kern, 10)
    out["assign_gauss"]["near_tie_mismatches"] = e_ties
    out["sub_assign_gauss"]["near_tie_mismatches"] = f_check[
        "near_tie_mismatches"]
    out["suffstats_labels"]["max_abs_err"] = s_err
    out["loglik_gauss"]["max_abs_err"] = ll_err
    return {"n": n, "d": d, "k": k, "k_live": live, "repeat_bitwise": True,
            "peak_bytes": int(torch.cuda.max_memory_allocated(dev)), **out}


# ---------------------------------------------------------------------------
# The stat fold, the dense suffstats oracle and the tiled plane
# ---------------------------------------------------------------------------
def fold_check(fold, parts, acc) -> dict:
    """The stat fold on the fit's per-block partials (the three fields of
    one stat fold) from a nonzero accumulator: ``fold_fields_cuda``, all
    three in one launch, as every fit path folds, two launches bitwise
    equal and bitwise the plain loop of adds on the card; timed beside
    each field's own launch (``fold_partials_cuda``: three launches a
    fold, one a field), the loop, ``acc + parts.sum(0)`` (another
    order, so not the same function: shown, not the library yardstick)
    and the bound of the fold's bytes."""
    names = ("n", "sx", "sxx")
    accs = [getattr(acc, n).contiguous() for n in names]
    ps = [getattr(parts, n) for n in names]
    got = fold.fold_fields_cuda(accs, ps)
    again = fold.fold_fields_cuda(accs, ps)
    want = fold.fold_fields_plain(accs, ps)
    torch.cuda.synchronize()
    if not all(torch.equal(u, v) and torch.equal(u, w)
               for u, v, w in zip(got, again, want)):
        fail("fold_fields is not bitwise the loop of adds")
    out = {}
    for name, a, p in zip(names, accs, ps):
        one = fold.fold_partials_cuda(a, p)
        torch.cuda.synchronize()
        if not torch.equal(one, fold.fold_partials_plain(a, p)):
            fail(f"fold_partials ({name}) is not bitwise the loop of adds")
        t = {"blocks": p.shape[0], "elements": a.numel(), "bitwise": True,
             "block_sum_first_differs": not torch.equal(one,
                                                        a + p.sum(dim=0)),
             "max_abs_err": 0.0,
             "ms": cuda_ms(lambda: fold.fold_partials_cuda(a, p), 20),
             "plain_ms": cuda_ms(lambda: fold.fold_partials_plain(a, p), 3),
             "block_sum_first_ms": cuda_ms(lambda: a + p.sum(dim=0), 20)}
        t["device_ms"], t["host_ms"] = run_ms(
            lambda: fold.fold_partials_cuda(a, p), 20)
        t["bound_ms"], t["bound_by"] = bound(
            p.numel(), 4 * (p.numel() + 2 * a.numel()))
        out[name] = t
    elems = sum(p.numel() for p in ps)
    one = {"fields": len(names), "launches_a_call": 1, "bitwise": True,
           "max_abs_err": 0.0,
           "ms": cuda_ms(lambda: fold.fold_fields_cuda(accs, ps), 20),
           "plain_ms": cuda_ms(lambda: fold.fold_fields_plain(accs, ps), 3),
           "per_field_ms_sum": sum(out[n]["ms"] for n in names),
           "per_field_device_ms_sum": sum(out[n]["device_ms"]
                                          for n in names)}
    one["device_ms"], one["host_ms"] = run_ms(
        lambda: fold.fold_fields_cuda(accs, ps), 20)
    one["bound_ms"], one["bound_by"] = bound(
        elems, 4 * (elems + 2 * sum(a.numel() for a in accs)))
    out["one_launch"] = one
    return out


def dense_work(n, k, d):
    """(FLOP, bytes) of the dense suffstats: the symmetric sxx needs
    d (d + 1) / 2 products a point and cluster, so N K d (d + 1) + 2 N K d
    operations (the kernel does all d^2, and is held to the work the
    function needs); x and resp read once, n, sx and the whole sxx written
    once."""
    return (n * k * d * (d + 1) + 2 * n * k * d,
            4 * (n * d + n * k + k + k * d + k * d * d))


def dense_case(suffstats, x, resp, first, one_hot: bool) -> dict:
    """The dense kernel's result ``first`` (from the entry point) on (x,
    resp): a second launch bitwise equal, its plain version within
    STATS_RTOL (counts exact when resp is one-hot), and the times of the
    kernel, the plain version and the library route (``resp.sum(0)``,
    ``resp.T @ x``, the einsum; TF32 off) beside the bound."""
    again = suffstats.suffstats_cuda(x, resp)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail("suffstats: two launches on the same inputs differ")
    want = suffstats.suffstats_plain(x, resp)
    if one_hot:
        err = stats_err(first, want)
    else:
        err = max(rel_err(g, w, STATS_RTOL, "suffstats")
                  for g, w in zip(first, want))
    n, d = x.shape
    k = resp.shape[1]

    def kern():
        return suffstats.suffstats_cuda(x, resp)

    def library():
        return (resp.sum(dim=0), resp.T @ x,
                torch.einsum("nk,nd,ne->kde", resp, x, x))

    out = {"n": n, "k": k, "d": d, "one_hot": one_hot, "max_abs_err": err,
           "repeat_bitwise": True, "ms": cuda_ms(kern, 10),
           "plain_ms": cuda_ms(lambda: suffstats.suffstats_plain(x, resp),
                               3),
           "library_ms": cuda_ms(library, 10)}
    out["device_ms"], out["host_ms"] = run_ms(kern, 10)
    out["library_device_ms"], out["library_host_ms"] = run_ms(library, 10)
    out["bound_ms"], out["bound_by"] = bound(*dense_work(n, k, d))
    return out


def dense_against_labels(suffstats, fam, x, lab, sub, k: int) -> dict:
    """The dense kernel on the one-hot of segments 2 label + sub against
    ``suffstats_labels`` folded (the family's ``stats_from_labels``): n
    exact, sx and sxx within STATS_RTOL. Labels >= k add nothing to
    either."""
    seg = (2 * lab + sub).long().clamp(max=2 * k)
    resp = torch.nn.functional.one_hot(seg, 2 * k + 1)[:, :2 * k].to(
        torch.float32)
    got = suffstats.suffstats_cuda(x, resp)
    st = fam.stats_from_labels(x, torch.ones(x.shape[0], device=x.device),
                               lab, sub, k)
    want = (st.n.reshape(2 * k), st.sx.reshape(2 * k, -1),
            st.sxx.reshape(2 * k, x.shape[1], x.shape[1]))
    return {"segments": 2 * k, "max_abs_err": stats_err(got, want)}


def kernel_check_dense(ops, suffstats, cases) -> tuple:
    """The dense oracle at the fits' states, a ragged shape, d = 256 and
    the reference's §4.2 shapes. ``cases``: name -> (x, resp, one_hot).
    Its path is the entry point ``ops.suffstats``: one call per case with
    the counts set to 0 just before, read just after (0 on every fit
    path); the comparisons and timings come after."""
    ops.reset_launch_counts()
    first = {name: ops.suffstats(x, resp) for name, (x, resp, _) in
             cases.items()}
    torch.cuda.synchronize()
    launches = ops.launch_counts()["suffstats"]
    if launches != len(cases):
        fail(f"kernel_check_dense: {launches} launches for {len(cases)} "
             "calls of ops.suffstats")
    return launches, {name: dense_case(suffstats, x, resp, first[name], oh)
                      for name, (x, resp, oh) in cases.items()}


def window_operands(n, d, k, dev, seed):
    """Operands of the stat and step-(f) kernels: points, labels in
    [-1, k] (outside [0, k) they add nothing, or get sub-label 0),
    sub-labels, a valid mask with zeros, whitening sub-components about
    points of the set, Gumbel counters and key words."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, d, device=dev, generator=g) * 3
    lab = torch.randint(-1, k + 1, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    sub = torch.randint(0, 2, (n,), device=dev, generator=g,
                        dtype=torch.int32)
    valid = (torch.rand(n, device=dev, generator=g) < 0.9).float()
    pick = torch.randint(0, n, (k, 2), device=dev, generator=g)
    smu = x[pick] + 0.5 * torch.randn(k, 2, d, device=dev, generator=g)
    sf = (torch.randn(k, 2, d, d, device=dev, generator=g) * (0.2 / d ** 0.5)
          + torch.eye(d, device=dev))
    sld = torch.randn(k, 2, device=dev, generator=g)
    slw = torch.log_softmax(torch.randn(k, 2, device=dev, generator=g), 1)
    gidx = torch.arange(n, device=dev, dtype=torch.int64) + 9
    kzb = torch.tensor([77, 3_000_000_001], device=dev)
    return x, lab, sub, valid, smu, sf, sld, slw, gidx, kzb


def kernel_check_windows(ops, suffstats, assign, dev) -> dict:
    """The stat and step-(f) kernels past one slot window (K > 8192: a
    launch a window of ``suffstats.slot_windows``, three for
    sub_assign_gauss), past d = 256 (suffstats_labels' Gram tiles,
    sub_assign_gauss's column panels, the dense oracle's panel tile) and at
    fit_k_large's shapes, each against its plain version on WINDOW_CASES: repeat launches bitwise
    equal, stats within STATS_RTOL with counts exact, sub-labels exact but
    for near-ties inside [0, K) and 0 outside; each call's launches (the
    counts set to 0 just before, read just after) and per-launch device
    times."""
    out = {}
    for name, n, d, k in WINDOW_CASES:
        x, lab, sub, valid, smu, sf, sld, slw, gidx, kzb = window_operands(
            n, d, k, dev, seed=k + d)
        inside = (lab >= 0) & (lab < k)
        resp = torch.nn.functional.one_hot(
            lab.long().clamp(0, k - 1), k).float() * inside[:, None].float()
        f_args = (x, smu, sf, sld, slw, lab, gidx, kzb)
        s_args = (x, lab, sub, valid, k)
        calls = {
            "suffstats_labels": (lambda: suffstats.suffstats_labels_cuda(
                *s_args), lambda: suffstats.suffstats_labels_plain(*s_args)),
            "moments_labels": (lambda: suffstats.moments_labels_cuda(
                *s_args), lambda: suffstats.moments_labels_plain(*s_args)),
            "sub_assign_gauss": (lambda: assign.sub_assign_gauss_cuda(
                *f_args), None),
            "suffstats": (lambda: suffstats.suffstats_cuda(x, resp),
                          lambda: suffstats.suffstats_plain(x, resp))}
        wins = len(suffstats.slot_windows(k))
        r = {"n": n, "d": d, "k": k, "slot_windows": wins}
        for kern, (cuda, plain) in calls.items():
            ops.reset_launch_counts()
            got = cuda()
            again = cuda()
            torch.cuda.synchronize()
            launches = ops.launch_counts()[kern]
            want = wins * (assign.SUB_LAUNCHES if kern == "sub_assign_gauss"
                           else 1)
            if launches != 2 * want:
                fail(f"kernel_check_windows {name}: {kern} launched "
                     f"{launches} times in two calls, not {2 * want}")
            if isinstance(got, torch.Tensor):
                same = torch.equal(got, again)
            else:
                same = all(torch.equal(u, v) for u, v in zip(got, again))
            if not same:
                fail(f"kernel_check_windows {name}: {kern}: two launches "
                     "differ")
            t = {"launches_a_call": want, "repeat_bitwise": True}
            if kern == "sub_assign_gauss":
                if int(got[~inside].abs().sum()) != 0:
                    fail(f"kernel_check_windows {name}: a label outside "
                         "[0, K) did not get sub-label 0")
                idx = torch.nonzero(inside).flatten()
                in_args = (x[idx].contiguous(), smu, sf, sld, slw,
                           lab[idx].contiguous(), gidx[idx].contiguous(),
                           kzb)
                t["near_tie_mismatches"] = sub_ties(
                    assign, True, in_args, got[idx],
                    assign.sub_assign_gauss_plain(*in_args))
            else:
                t["max_abs_err"] = stats_err(got, plain())
            del got, again
            t["device_ms"], t["host_ms"] = run_ms(cuda, 5)
            r[kern] = t
        out[name] = r
        del x, lab, sub, valid, smu, sf, resp
        torch.cuda.empty_cache()
    return out


def linear_window_operands(n, dp, k, dev, seed):
    """``sweep_linear`` operands of K slots (about 60 % live), count
    features and log-probability weights, made on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.poisson(torch.full((n, dp), 3.0, device=dev), generator=g)
    logp = lambda *s: torch.log_softmax(
        torch.randn(*s, device=dev, generator=g) * 2, -1)
    act = (torch.rand(k, device=dev, generator=g) < 0.6).to(torch.int32)
    return (feats, logp(k, dp), torch.randn(k, device=dev, generator=g),
            torch.log_softmax(torch.randn(k, device=dev, generator=g), 0),
            act, logp(k, 2, dp), torch.randn(k, 2, device=dev, generator=g),
            torch.log_softmax(torch.randn(k, 2, device=dev, generator=g), 1),
            torch.ones(n, device=dev),
            torch.arange(n, device=dev, dtype=torch.int64) + 11,
            torch.tensor([9, 4_000_000_007], device=dev),
            torch.tensor([3, 5], device=dev),
            torch.randperm(2 * k, device=dev, generator=g)[:k].to(
                torch.int32))


def linear_window_checks(ops, assign, dev) -> dict:
    """``assign_linear`` and ``sub_assign_linear`` past the one-read
    sweep's 2048 slots (LINEAR_WINDOW_CASES: step (e) walks slot windows,
    step (f) keeps nothing K-sized) against their plain versions:
    repeat launches bitwise equal, labels exact but for near-ties,
    sub-labels under labels in [-1, K] exact but for near-ties inside
    [0, K) and 0 outside; a launch a call; per-launch device times."""
    out = {}
    for name, n, dp, k in LINEAR_WINDOW_CASES:
        a = linear_window_operands(n, dp, k, dev, seed=k)
        e_args = a[:5] + (a[9], a[10], a[12])
        lab = ((a[9] * 2654435761) % (k + 2) - 1).to(torch.int32)
        f_args = (a[0], a[5], a[6], a[7], lab, a[9], a[11])
        inside = (lab >= 0) & (lab < k)
        r = {"n": n, "d_feat": dp, "k": k, "k_live": int(a[4].sum())}
        for kern, cuda, args in (
                ("assign_linear", assign.assign_linear_cuda, e_args),
                ("sub_assign_linear", assign.sub_assign_linear_cuda,
                 f_args)):
            ops.reset_launch_counts()
            got, again = cuda(*args), cuda(*args)
            torch.cuda.synchronize()
            if ops.launch_counts()[kern] != 2:
                fail(f"kernel_check_windows {name}: {kern} launched "
                     f"{ops.launch_counts()[kern]} times in two calls")
            if not torch.equal(got, again):
                fail(f"kernel_check_windows {name}: {kern}: two launches "
                     "differ")
            t = {"launches_a_call": 1, "repeat_bitwise": True}
            if kern == "assign_linear":
                t["near_tie_mismatches"] = assign_ties(
                    assign, False, args, got,
                    assign.assign_linear_plain(*args))
            else:
                if int(got[~inside].abs().sum()) != 0:
                    fail(f"kernel_check_windows {name}: a label outside "
                         "[0, K) did not get sub-label 0")
                idx = torch.nonzero(inside).flatten()
                in_args = (a[0][idx].contiguous(), a[5], a[6], a[7],
                           lab[idx].contiguous(), a[9][idx].contiguous(),
                           a[11])
                t["near_tie_mismatches"] = sub_ties(
                    assign, False, in_args, got[idx],
                    assign.sub_assign_linear_plain(*in_args))
            t["device_ms"], t["host_ms"] = run_ms(lambda: cuda(*args), 5)
            r[kern] = t
        out[name] = r
        del a, e_args, f_args
        torch.cuda.empty_cache()
    return out


def linear_step_work(a, step: str):
    """(FLOP, bytes) of ``assign_linear`` ("e": the live slots) or
    ``sub_assign_linear`` ("f") on ``sweep_linear`` operands ``a``."""
    n, dp = a[0].shape
    k = a[1].shape[0]
    if step == "e":
        return (2 * n * int(a[4].sum()) * dp,
                4 * n * dp + 16 * n + 4 * k * (dp + 4) + 16)
    return 4 * n * dp, 4 * n * dp + 20 * n + 8 * k * (dp + 2) + 16


def linear_step_times(assign, states: dict) -> dict:
    """``assign_linear`` and ``sub_assign_linear`` alone on each of
    ``states`` (``sweep_linear`` operands; step (f) under step (e)'s
    labels): single-call (``cuda_ms``), per-launch device and host times
    (``run_ms``) and the bound of each."""
    out = {}
    for name, a in states.items():
        e_args = a[:5] + (a[9], a[10], a[12])
        lab = assign.assign_linear_cuda(*e_args)
        f_args = (a[0], a[5], a[6], a[7], lab, a[9], a[11])
        r = {"n": a[0].shape[0], "d_feat": a[0].shape[1],
             "k": a[1].shape[0], "k_live": int(a[4].sum())}
        for kern, fn, args, step in (
                ("assign_linear", assign.assign_linear_cuda, e_args, "e"),
                ("sub_assign_linear", assign.sub_assign_linear_cuda, f_args,
                 "f")):
            t = {"ms": cuda_ms(lambda: fn(*args), 20)}
            t["device_ms"], t["host_ms"] = run_ms(lambda: fn(*args), 50)
            t["bound_ms"], t["bound_by"] = bound(*linear_step_work(a, step))
            r[kern] = t
        out[name] = r
    return out


def same_resumed(first, rest, whole) -> dict:
    """Which of labels, K/score history (the two halves joined) and every
    tensor of the final state of a resumed chain equal the uninterrupted
    chain's bit for bit."""
    def leaves(st):
        out = {"it": torch.tensor(st.it)}
        for f in st.__dataclass_fields__:
            v = getattr(st, f)
            if isinstance(v, torch.Tensor):
                out[f] = v.cpu()
            elif hasattr(v, "__dataclass_fields__"):
                out.update({f"{f}.{g}": getattr(v, g).cpu()
                            for g in v.__dataclass_fields__})
        return out
    a, b = leaves(rest.state), leaves(whole.state)
    return {"labels": bool(np.array_equal(rest.labels, whole.labels)),
            "history": all(np.array_equal(np.concatenate(
                [first.history[k], rest.history[k]]), whole.history[k])
                for k in whole.history),
            "state": a.keys() == b.keys() and all(
                a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                for k in a)}


def fit_resume(DPMM, checkpoint, cfg, data, y_np, whole, tmp: Path,
               kernels, gpu) -> dict:
    """RESUME_AT iterations of ``cfg`` on ``data``, ``save_model``,
    ``load_model``, then ``cfg.iters - RESUME_AT`` more from ``init_state``
    (the launch counts set to 0 just before the resumed fit, read just
    after): raises unless the chain is ``whole`` (the uninterrupted fit)
    bit for bit, NMI >= 0.9 and each of ``kernels`` launched."""
    from repro_torch.kernels import ops
    first = DPMM(cfg).fit(data, RESUME_AT)
    path = checkpoint.save_model(str(tmp / f"resume_{cfg.component}.npz"),
                                 first.state, cfg.component)
    state, _ = checkpoint.load_model(path)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rest = DPMM(cfg).fit(data, cfg.iters - RESUME_AT, init_state=state)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    same = same_resumed(first, rest, whole)
    report = dict(mode=rest.mode, resumed_at=RESUME_AT, it=rest.state.it,
                  nmi=rest.nmi(y_np), k_found=rest.k, wall_s=wall,
                  bitwise_uninterrupted=same, launches=launches)
    if not all(same.values()):
        fail(f"fit_resume ({rest.mode}): the resumed chain parts from the "
             f"uninterrupted one: {same}")
    if report["nmi"] < 0.9:
        fail(f"fit_resume ({rest.mode}): NMI {report['nmi']:.4f} < 0.9")
    for name in kernels:
        if launches[name] == 0:
            fail(f"fit_resume ({rest.mode}): kernel {name} was never "
                 "launched by the resumed fit")
    return report


def same_chain(a, b) -> dict:
    """Which of labels, K/score history and final stats of two fits are
    bitwise equal."""
    return {"labels": bool(np.array_equal(a.labels, b.labels)),
            "history": all(np.array_equal(a.history[k], b.history[k])
                           for k in a.history),
            "stats": all(torch.equal(getattr(a.state.stats, f),
                                     getattr(b.state.stats, f))
                         and torch.equal(getattr(a.state.substats, f),
                                         getattr(b.state.substats, f))
                         for f in a.state.stats.__dataclass_fields__)}


def run_tiled(DPMM, cfg, src, y_np, kernels, gpu, phase: str,
              resident=None, after=None):
    """``DPMM(cfg).fit(src)`` on the tiled plane with every launch count
    set to 0 just before and read just after; emits ``phase`` (ms/iter,
    the device bytes above those at the fit's start, the estimate, the
    share of the fit the compute stream waited on tile copies) and raises
    unless NMI >= 0.9, each of ``kernels`` launched and, given the
    ``resident`` fit of the same data and seed, labels, history and stats
    are bitwise its. ``after(res, report)`` may add fields to the report
    and returns a list of failed checks."""
    from repro_torch.kernels import ops
    model = DPMM(cfg)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = model.fit(src)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    nmi = res.nmi(y_np)
    steady = res.iter_times_s[cfg.log_every:]
    report = dict(
        component=cfg.component, n=src.n, d=src.d, tiles=-(-src.n //
                                                            res.tile_size),
        tile_size=res.tile_size, mode=res.mode, k_found=res.k, nmi=nmi,
        iters=cfg.iters, wall_s=wall,
        steady_ms_per_iter=1e3 * float(np.mean(steady)),
        peak_bytes=res.peak_bytes, start_bytes=res.start_bytes,
        peak_above_start=res.peak_bytes - res.start_bytes,
        est_peak_bytes=res.est_peak_bytes, copy_wait_s=res.copy_wait_s,
        copy_wait_share=res.copy_wait_s / wall, read_s=res.read_s,
        launches=launches, recoveries=len(res.recoveries),
        k_history=res.history["k"].tolist(), nvidia_smi=gpu)
    if resident is not None:
        report["bitwise_resident"] = same_chain(res, resident)
        report["resident_steady_ms_per_iter"] = 1e3 * float(np.mean(
            resident.iter_times_s[cfg.log_every:]))
        report["resident_peak_above_start"] = (resident.peak_bytes
                                               - resident.start_bytes)
    problems = after(res, report) if after is not None else []
    emit(phase, **report)
    if problems:
        fail(f"{phase}: {'; '.join(problems)}")
    if res.mode != "tiled" or res.labels.shape != (src.n,):
        fail(f"{phase}: not a tiled fit of every point")
    if nmi < 0.9:
        fail(f"{phase}: NMI {nmi:.4f} < 0.9")
    for name in kernels:
        if launches[name] == 0:
            fail(f"{phase}: kernel {name} was never launched by the fit")
    if resident is not None and not all(report["bitwise_resident"].values()):
        fail(f"{phase}: the tiled chain parts from the resident chain: "
             f"{report['bitwise_resident']}")
    return res, report


def state_bits(a, b) -> bool:
    """Every tensor (and ``it``) of two states equal bit for bit."""
    def leaves(st):
        out = {"it": torch.as_tensor(st.it)}
        for f in st.__dataclass_fields__:
            v = getattr(st, f)
            if isinstance(v, torch.Tensor):
                out[f] = v.cpu()
            elif hasattr(v, "__dataclass_fields__"):
                out.update({f"{f}.{g}": getattr(v, g).cpu()
                            for g in v.__dataclass_fields__})
        return out
    la, lb = leaves(a), leaves(b)
    return la.keys() == lb.keys() and all(
        la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]) for k in la)


def steady_ms(res, cfg) -> float:
    return 1e3 * float(np.mean(res.iter_times_s[cfg.log_every:]))


def fit_resilience(DPMM, DPMMConfig, checkpoint, synthetic, sources, cfg,
                   tcfg, x_np, path, whole, whole_t, tmp: Path, gpu) -> dict:
    """The rotation and ``resume=True`` on both planes, a SIGKILL'd child
    resumed, an inf row ending in ``DivergenceError`` with the CUDA context
    alive after it, a NaN tile rolled back, and the guardrails' cost;
    raises on any failed check."""
    import dataclasses
    import subprocess
    import textwrap
    from repro_torch.core.resilience import DivergenceError, model_health
    from repro_torch.data.faults import FaultInjectingSource
    from repro_torch.kernels import ops
    HostTiledSource = sources.HostTiledSource
    out, problems = {}, []

    # (1) a rotation every CKPT_EVERY iterations, a stop after RESUME_STOP,
    # then fit(iters, resume=True): the fit phase's chain bit for bit
    save_s = []
    real_save = checkpoint.save_checkpoint

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        p = real_save(*a, **kw)
        save_s.append(time.perf_counter() - t0)
        return p
    checkpoint.save_checkpoint = timed_save
    try:
        for plane, base, data, ref in (
                ("resident", cfg, lambda: x_np, whole),
                ("tiled", tcfg, lambda: HostTiledSource.from_npy(path),
                 whole_t)):
            pref = str(tmp / f"rotation_{plane}")
            rcfg = dataclasses.replace(base, checkpoint_path=pref,
                                       checkpoint_every=CKPT_EVERY)
            first = DPMM(rcfg).fit(data(), RESUME_STOP)
            members = [it for it, _ in checkpoint.list_checkpoints(pref)]
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rest = DPMM(rcfg).fit(data(), base.iters, resume=True)
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            same = same_resumed(first, rest, ref)
            out[f"rotation_{plane}"] = dict(
                members_after_stop=members, resumed_iters=len(
                    rest.iter_times_s), final_members=[
                    it for it, _ in checkpoint.list_checkpoints(pref)],
                wall_s=wall, bitwise_uninterrupted=same, launches=launches)
            if members != [RESUME_STOP, RESUME_STOP - CKPT_EVERY]:
                problems.append(f"rotation {plane}: members {members}")
            if not all(same.values()):
                problems.append(f"rotation {plane}: resumed chain parts "
                                f"from the fit phase's: {same}")
            if any(launches[k] == 0 for k in GAUSS_PATH):
                problems.append(f"rotation {plane}: launches {launches}")
    finally:
        checkpoint.save_checkpoint = real_save
    out["save_member_s"] = save_s
    out["save_member_median_s"] = float(np.median(save_s))

    # (2) a child fit (no JAX) at RESIL_N x FIT_D SIGKILLs itself right
    # after its second rotation save (kernels already built: it loads them)
    x2_np, y2_np = synthetic.generate_gmm(RESIL_N, FIT_D, FIT_K, seed=0)
    x2_path = tmp / "x_resil.npy"
    np.save(x2_path, x2_np)
    pref = str(tmp / "killed")
    kcfg = DPMMConfig(checkpoint_path=pref, checkpoint_every=CKPT_EVERY,
                      **FIT_CFG)
    child = textwrap.dedent(f"""
        import os, signal, sys
        sys.path.insert(0, {str(SRC)!r})
        import numpy as np
        from repro_torch.configs import DPMMConfig
        from repro_torch.core import checkpoint
        from repro_torch.core.sampler import DPMM
        saves = [0]
        real = checkpoint.save_checkpoint
        def dying_save(*a, **kw):
            p = real(*a, **kw)
            saves[0] += 1
            if saves[0] == 2:
                os.kill(os.getpid(), signal.SIGKILL)
            return p
        checkpoint.save_checkpoint = dying_save
        DPMM(DPMMConfig(**{dataclasses.asdict(kcfg)!r}),
             device="cuda").fit(np.load({str(x2_path)!r}))
        raise SystemExit("the fit survived its SIGKILL")
    """)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True,
                          text=True, timeout=300)
    child_s = time.perf_counter() - t0
    members = [it for it, _ in checkpoint.list_checkpoints(pref)]
    resumed = DPMM(kcfg).fit(x2_np, resume=True)
    whole2 = DPMM(DPMMConfig(**FIT_CFG)).fit(x2_np)
    same = {"labels": bool(np.array_equal(resumed.labels, whole2.labels)),
            "state": state_bits(resumed.state, whole2.state)}
    out["sigkill"] = dict(n=RESIL_N, d=FIT_D, child_rc=proc.returncode,
                          child_s=child_s, members_at_kill=members,
                          resumed_iters=len(resumed.iter_times_s),
                          bitwise_uninterrupted=same,
                          nmi=resumed.nmi(y2_np))
    if proc.returncode != -signal.SIGKILL:
        problems.append(f"sigkill: child rc {proc.returncode}: "
                        f"{proc.stderr[-1500:]}")
    if not members or members[0] != 2 * CKPT_EVERY:
        problems.append(f"sigkill: members {members}")
    if not all(same.values()):
        problems.append(f"sigkill: resumed chain parts: {same}")

    # (3) an inf row: every rollback diverges again, DivergenceError after
    # max_recoveries + 1 events; then a small fit in the same process
    xbad = x2_np.copy()
    xbad[5] = np.inf
    t0 = time.perf_counter()
    try:
        DPMM(DPMMConfig(max_recoveries=2, **FIT_CFG)).fit(xbad)
        events, err = [], "no DivergenceError"
    except DivergenceError as e:
        events, err = e.recoveries, None
    torch.cuda.synchronize()             # a CUDA fault would surface here
    inf_s = time.perf_counter() - t0
    del xbad
    xs_np, ys_np = synthetic.generate_gmm(20_000, 8, 4, seed=5)
    ops.reset_launch_counts()
    small = DPMM(DPMMConfig(k_max=16, iters=20, burnout=5,
                            log_every=10)).fit(xs_np)
    small_launch = ops.launch_counts()
    out["inf_row"] = dict(
        n=RESIL_N, d=FIT_D, max_recoveries=2, seconds=inf_s, error=err,
        events=[{k: e[k] for k in ("kind", "iter", "restored_it",
                                   "rollback")} for e in events],
        next_fit=dict(n=20_000, d=8, nmi=small.nmi(ys_np), k=small.k,
                      launches=small_launch))
    if err or len(events) != 3 or any(
            e["kind"] != "divergence_rollback" for e in events):
        problems.append(f"inf_row: {err} {events}")
    if out["inf_row"]["next_fit"]["nmi"] < 0.9 or any(
            small_launch[k] == 0 for k in GAUSS_PATH):
        problems.append(f"inf_row: the next fit failed "
                        f"{out['inf_row']['next_fit']}")

    # (4) a NaN tile let through (guard_tiles=False) in the split/merge
    # pass of iteration burnout: one rollback, and the fit ends healthy
    faulty = FaultInjectingSource(HostTiledSource(x2_np),
                                  schedule={NAN_CALL: "nan"})
    ncfg = DPMMConfig(tile_size=TILE, guard_tiles=False, **FIT_CFG)
    ops.reset_launch_counts()
    nres = DPMM(ncfg).fit(faulty)
    rolls = [e for e in nres.recoveries
             if e["kind"] == "divergence_rollback"]
    out["nan_tile"] = dict(
        n=RESIL_N, tile_size=nres.tile_size, read_call=NAN_CALL,
        injected=faulty.injected, rollbacks=[
            {k: e[k] for k in ("iter", "restored_it", "rollback")}
            for e in rolls], history_rows=len(nres.history["k"]),
        healthy=bool(model_health(nres.state)), nmi=nres.nmi(y2_np),
        k_found=nres.k, launches=ops.launch_counts())
    if (len(rolls) != 1 or not out["nan_tile"]["healthy"]
            or out["nan_tile"]["nmi"] < 0.9
            or out["nan_tile"]["history_rows"] != ncfg.iters):
        problems.append(f"nan_tile: {out['nan_tile']}")
    del faulty, x2_np

    # (5) guardrails on and off in turns at FIT_N x FIT_D: ms/iter, labels
    turns = {"on": [], "off": []}
    labels = {}
    for _ in range(GUARD_TURNS):
        for side in ("on", "off"):
            r = DPMM(dataclasses.replace(cfg, guardrails=side == "on")
                     ).fit(x_np)
            turns[side].append(steady_ms(r, cfg))
            labels.setdefault(side, r.labels)
            if not np.array_equal(r.labels, whole.labels):
                problems.append(f"guardrails {side}: labels differ from "
                                "the fit phase's")
    out["guardrails_ms_per_iter"] = turns
    out["guardrails_gap_ms"] = float(np.mean(turns["on"])
                                     - np.mean(turns["off"]))
    out["guardrails_spread_ms"] = float(max(
        np.ptp(turns["on"]), np.ptp(turns["off"])))
    out["guardrails_labels_equal"] = bool(np.array_equal(labels["on"],
                                                         labels["off"]))
    out["problems"] = problems
    return out


def fit_multichain(DPMM, DPMMConfig, prng, synthetic, sources, cfg, x_np,
                   y_np, whole, gpu) -> dict:
    """C = MULTI_C chains at FIT_N x FIT_D on the resident plane (chain 2
    against the single-chain fit of key fold_in(key, 2)), and C = 2 on the
    tiled plane at RESIL_N x FIT_D against the resident C = 2 fit, reading
    each tile as often as one chain does."""
    from repro_torch.core import sampler
    from repro_torch.core.state import chain_of
    from repro_torch.kernels import ops
    out, problems = {}, []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m = DPMM(cfg).fit(x_np, n_chains=MULTI_C)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    single2 = DPMM(cfg).fit(x_np, key=prng.fold_in((0, cfg.seed), 2))
    c2 = m.chain(2)
    same2 = {"labels": bool(np.array_equal(c2.labels, single2.labels)),
             "history": all(np.array_equal(c2.history[k], single2.history[k])
                            for k in single2.history),
             "state": state_bits(c2.state, single2.state)}
    best = m.select_best()
    try:
        rhats = m.rhats()
    except ValueError as e:
        rhats = str(e)
    single_ms = steady_ms(whole, cfg)
    out["resident"] = dict(
        n=FIT_N, d=FIT_D, chains=MULTI_C, wall_s=wall,
        steady_ms_per_iter=steady_ms(m, cfg),
        single_chain_steady_ms_per_iter=single_ms,
        ratio_to_chains_x_single=steady_ms(m, cfg) / (MULTI_C * single_ms),
        peak_above_start=m.peak_bytes - m.start_bytes,
        single_peak_above_start=whole.peak_bytes - whole.start_bytes,
        # labels and sub-labels a chain (int32); x and the mask are shared
        point_state_bytes_per_chain=FIT_N * 8, x_bytes=x_np.nbytes,
        # a chain's model state (its rollback anchor is a second copy)
        model_bytes_per_chain=sampler._nbytes(chain_of(m.state, 0)),
        scores=np.asarray(m.score).tolist(), best_chain=int(np.argmax(
            m.score)), best_nmi=best.nmi(y_np), k=m.k,
        k_per_chain=m.history["k"][:, -1].tolist(), rhats=rhats,
        chain2_bitwise_single=same2, launches=launches)
    if not all(same2.values()):
        problems.append(f"resident chain 2 parts from its single fit: {same2}")
    if out["resident"]["best_nmi"] < 0.9:
        problems.append(f"resident select_best NMI "
                        f"{out['resident']['best_nmi']:.4f} < 0.9")
    if any(launches[k] == 0 for k in GAUSS_PATH):
        problems.append(f"resident launches {launches}")

    class Counting(sources.HostTiledSource):
        reads = 0

        def read_block(self, start, stop):
            self.reads += 1
            return super().read_block(start, stop)

    x2_np, y2_np = synthetic.generate_gmm(RESIL_N, FIT_D, FIT_K, seed=0)
    tcfg = DPMMConfig(tile_size=TILE, **FIT_CFG)
    reads = {}
    tiled = {}
    for chains in (1, 2):
        src = Counting(x2_np)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tiled[chains] = DPMM(tcfg).fit(src, n_chains=chains)
        tiled[f"wall_{chains}"] = time.perf_counter() - t0
        tiled[f"launches_{chains}"] = ops.launch_counts()
        reads[chains] = src.reads
    res2 = DPMM(DPMMConfig(**FIT_CFG)).fit(x2_np, n_chains=2)
    t2 = tiled[2]
    same = {"labels": bool(np.array_equal(t2.labels, res2.labels)),
            "history": all(np.array_equal(t2.history[k], res2.history[k])
                           for k in res2.history),
            "state": state_bits(t2.state, res2.state)}
    out["tiled"] = dict(
        n=RESIL_N, d=FIT_D, chains=2, tile_size=t2.tile_size,
        reads_one_chain=reads[1], reads_two_chains=reads[2],
        steady_ms_per_iter=steady_ms(t2, tcfg),
        one_chain_steady_ms_per_iter=steady_ms(tiled[1], tcfg),
        wall_s=tiled["wall_2"], bitwise_resident=same,
        best_nmi=t2.nmi(y2_np), launches=tiled["launches_2"])
    if not all(same.values()):
        problems.append(f"tiled C = 2 parts from the resident: {same}")
    if reads[1] != reads[2]:
        problems.append(f"tiled reads {reads}")
    if any(tiled["launches_2"][k] == 0 for k in GAUSS_PATH):
        problems.append(f"tiled launches {tiled['launches_2']}")
    out["problems"] = problems
    return out


def fit_k_auto(DPMM, DPMMConfig, x_np, y_np, gpu) -> dict:
    """k_max='auto' at FIT_N x FIT_D: the slab after each chunk, K, NMI,
    and a second run bit for bit."""
    from repro_torch.kernels import ops
    acfg = DPMMConfig(**{**FIT_CFG, "k_max": "auto"})
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        r = DPMM(acfg).fit(x_np)
        runs.append((r, time.perf_counter() - t0, ops.launch_counts()))
    (a, wall, launches), (b, _, _) = runs
    same = {"labels": bool(np.array_equal(a.labels, b.labels)),
            "history": all(np.array_equal(a.history[k], b.history[k])
                           for k in a.history),
            "state": state_bits(a.state, b.state),
            "slabs": a.slab_sizes == b.slab_sizes}
    out = dict(n=FIT_N, d=FIT_D, iters=acfg.iters, slab_after_chunk=(
        a.slab_sizes), k_found=a.k, nmi=a.nmi(y_np), wall_s=wall,
        steady_ms_per_iter=steady_ms(a, acfg),
        peak_above_start=a.peak_bytes - a.start_bytes,
        k_history=a.history["k"].tolist(), second_run_bitwise=same,
        launches=launches)
    problems = []
    if a.k != FIT_K or out["nmi"] < 0.9:
        problems.append(f"K {a.k}, NMI {out['nmi']:.4f}")
    if not all(same.values()):
        problems.append(f"second run differs: {same}")
    if a.slab_sizes[0] != 8 or a.state.active.shape[0] <= 8:
        problems.append(f"the slab did not grow: {a.slab_sizes}")
    if any(launches[k] == 0 for k in GAUSS_PATH):
        problems.append(f"launches {launches}")
    out["problems"] = problems
    return out


def mesh_phases(DPMM, DPMMConfig, HostTiledSource, synthetic, x_np, y_np,
                whole, gpu) -> dict:
    """``fit_mesh`` (against the ``fit`` phase's chain ``whole`` on x_np)
    and ``fit_feature_shard``, each emitted; raises on a problem. Returns
    each phase's launches."""
    import tempfile
    from repro_torch.core.distributed import Mesh
    launched_by = {}
    for phase, run in (
            ("fit_mesh", lambda tmp: fit_mesh(
                DPMM, DPMMConfig, Mesh, HostTiledSource, x_np, y_np, whole,
                Path(tmp), gpu)),
            ("fit_feature_shard", lambda tmp: fit_feature_shard(
                DPMM, DPMMConfig, Mesh, synthetic, gpu))):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            report, launched = run(tmp)
        emit(phase, seconds=time.perf_counter() - t0, **report)
        if report["problems"]:
            fail(f"{phase}: {'; '.join(report['problems'])}")
        launched_by[phase] = launched
    return launched_by


def lm_rel(got, want) -> float:
    """max |got - want| / max |want| (tests/test_zoo.py's measure)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


def lm_decode(decode, model, tokens, cache_len: int):
    """Teacher-forced decode of every token: (B, S, V) float32 logits."""
    cache = decode.init_cache(model.cfg, tokens.shape[0], cache_len,
                              model.embed.tok.dtype,
                              device=tokens.device)
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = decode.decode_step(model, cache, tokens[:, t:t + 1],
                                       cache_len=cache_len)
        out.append(lg[:, 0])
    return torch.stack(out, dim=1)


def lm_smoke(dev) -> dict:
    """The four dense archs at smoke size: the card's logits against the
    port on the CPU (same params, same tokens), the card's decode against
    its forward, and the sliding-window ring (window 8, 20 steps)."""
    import copy
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.models import decode, transformer
    report, problems = {}, []
    for arch in LM_DENSE:
        cfg = smoke_config(arch)
        model = transformer.init_params(0, cfg, device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 16),
                             generator=torch.Generator().manual_seed(1))
        cpu_logits, _ = transformer.forward(model, toks)
        card = copy.deepcopy(model).to(dev)
        logits, _ = transformer.forward(card, toks.to(dev))
        dec = lm_decode(decode, card, toks[:, :10].to(dev), 10)
        full10, _ = transformer.forward(card, toks[:, :10].to(dev))
        r = {"card_vs_cpu": lm_rel(logits, cpu_logits),
             "decode_vs_forward": lm_rel(dec, full10),
             "finite": bool(torch.isfinite(logits).all())}
        if not r["finite"] or r["card_vs_cpu"] > LM_RTOL:
            problems.append(f"{arch}: card logits against the CPU "
                            f"{r['card_vs_cpu']:.3g} > {LM_RTOL}")
        if r["decode_vs_forward"] > LM_DECODE_RTOL:
            problems.append(f"{arch}: decode against forward "
                            f"{r['decode_vs_forward']:.3g}")
        report[arch] = r
    cfg = dataclasses.replace(smoke_config("gemma2-9b"), sliding_window=8)
    model = transformer.init_params(0, cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (1, 20), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    full, _ = transformer.forward(model, toks)
    report["ring"] = {"window": 8, "steps": 20,
                      "decode_vs_forward": lm_rel(
                          lm_decode(decode, model, toks, 20), full)}
    if report["ring"]["decode_vs_forward"] > LM_DECODE_RTOL:
        problems.append(f"ring: {report['ring']['decode_vs_forward']:.3g}")
    report["problems"] = problems
    return report


def serve_lm_dtype(decode, engine, transformer, model, cfg, shape, prompts,
                   dtype) -> dict:
    """``Generator.generate`` at one dtype: a warm-up request, a timed one
    (a CUDA event pair around each serve step), a greedy rerun, then the
    teacher-forced decode of the answer against one full forward."""
    gen = engine.Generator(cfg, shape, model, dtype=dtype,
                           device=prompts.device)
    step, marks, host = gen.step, [], []

    def timed(*a, **kw):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        e0.record()
        out = step(*a, **kw)
        e1.record()
        host.append(time.perf_counter() - h0)
        marks.append((e0, e1))
        return out

    gen.generate(prompts, steps=SERVE_LM_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen.step = timed
    t0 = time.perf_counter()
    out = gen.generate(prompts, steps=SERVE_LM_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    gen.step = step
    ms = np.array([a.elapsed_time(b) for a, b in marks])
    again = gen.generate(prompts, steps=SERVE_LM_STEPS)
    peak = torch.cuda.max_memory_allocated()
    dec = lm_decode(decode, model, out, SERVE_LM_CACHE)
    full, _ = transformer.forward(model, out)
    b = prompts.shape[0]
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kv_bytes = sum(2 * b * c * cfg.num_kv_heads * cfg.resolved_head_dim
                   * torch.empty((), dtype=dtype).element_size()
                   for c in (decode._attn_cache_len(
                       k, cfg, SERVE_LM_CACHE, gen.window_override)
                       for k in transformer.layer_kinds(cfg)))
    rep = {"dtype": str(dtype).replace("torch.", ""),
           "steps_timed": int(ms.size),
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)),
           "mean_ms": float(ms.mean()),
           "host_p50_ms": float(np.percentile(host, 50)) * 1e3,
           "tokens_per_s_decode": b * 1e3 / float(np.percentile(ms, 50)),
           "tokens_per_s_wall": b * SERVE_LM_STEPS / wall,
           "generate_wall_s": wall, "peak_bytes": int(peak),
           "param_bytes": int(param_bytes), "kv_cache_bytes": int(kv_bytes),
           "bound_ms": (param_bytes + kv_bytes) / PEAK_BYTES_S * 1e3,
           "bound_by": "bytes",
           "decode_vs_forward": lm_rel(dec, full),
           "greedy_rerun_identical": bool(torch.equal(out, again)),
           "finite": bool(torch.isfinite(full).all()),
           "out_shape": list(out.shape)}
    rep["bound_share"] = rep["bound_ms"] / rep["p50_ms"]
    return rep, out


def lm_op_kind(name: str) -> str:
    """The kind of a device kernel of the decode step, by its name."""
    n = name.lower()
    if any(s in n for s in ("gemm", "gemv", "cublas", "cutlass", "sm90_",
                             "splitk", "xmma", "nvjet")):
        return "matmul"
    if "softmax" in n:
        return "attention_softmax"
    if any(s in n for s in ("reduce", "mean", "norm")):
        return "reductions"
    if any(s in n for s in ("copy", "cat", "index", "scatter", "fill")):
        return "copies_and_indexing"
    return "elementwise"


def serve_lm_profile(decode, model, cfg, dev) -> dict:
    """``--profile``: SERVE_LM_PROFILE_STEPS decode steps of the served
    model (a full cache, token 0) under ``torch.profiler``: the step's
    host-clock ms, its device ms and device ops, both split by kind of op,
    and the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps = SERVE_LM_PROFILE_STEPS
    cache = decode.init_cache(cfg, SERVE_LM_BATCH, SERVE_LM_CACHE,
                              model.embed.tok.dtype, device=dev)
    tok = torch.zeros((SERVE_LM_BATCH, 1), dtype=torch.long, device=dev)
    for _ in range(4):                                  # warm-up
        decode.decode_step(model, cache, tok, cache_len=SERVE_LM_CACHE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        decode.decode_step(model, cache, tok, cache_len=SERVE_LM_CACHE)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            decode.decode_step(model, cache, tok, cache_len=SERVE_LM_CACHE)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    ms, ops = {}, {}
    for e in events:
        kind = lm_op_kind(e.key)
        ms[kind] = ms.get(kind, 0.0) + _device_us(e) * 1e-3 / steps
        ops[kind] = ops.get(kind, 0) + e.count / steps
    heavy = sorted(events, key=_device_us, reverse=True)[:10]
    return {"steps": steps, "host_ms_a_step": host_ms,
            "device_ms_a_step": sum(ms.values()),
            "device_ops_a_step": sum(ops.values()),
            "by_kind_ms_a_step": dict(sorted(ms.items())),
            "by_kind_ops_a_step": dict(sorted(ops.items())),
            "top": [{"name": e.key[:100], "calls_a_step": e.count / steps,
                     "ms_a_step": _device_us(e) * 1e-3 / steps}
                    for e in heavy]}


def lm_product_ms(cfg, dev) -> list:
    """``--profile``: each weight product of a decode step (SERVE_LM_BATCH
    rows against each projection's shape, the port's layout) timed alone
    (``cuda_ms``): float32, bfloat16 with a float32 output and bfloat16,
    each beside the bytes bound of reading its weight once."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (d, cfg.num_heads * hd),
              "wk_wv": (d, cfg.num_kv_heads * hd),
              "wo": (cfg.num_heads * hd, d), "up_gate": (d, cfg.d_ff),
              "down": (cfg.d_ff, d), "unembed_tied": (d, cfg.vocab_size)}
    g = torch.Generator(dev).manual_seed(0)
    out = []
    for name, (k, n) in shapes.items():
        x = torch.randn((SERVE_LM_BATCH, k), device=dev, generator=g)
        if name == "unembed_tied":          # x @ tok.T
            w = torch.randn((n, k), device=dev, generator=g).T
        else:
            w = torch.randn((k, n), device=dev, generator=g)
        xb, wb = x.bfloat16(), w.bfloat16()
        out.append({
            "product": name, "rows": SERVE_LM_BATCH, "k": k, "n": n,
            "f32_ms": cuda_ms(lambda: x @ w, 20),
            "f32_bound_ms": k * n * 4 / PEAK_BYTES_S * 1e3,
            "bf16_out_f32_ms": cuda_ms(
                lambda: torch.mm(xb, wb, out_dtype=torch.float32), 20),
            "bf16_ms": cuda_ms(lambda: xb @ wb, 20),
            "bf16_bound_ms": k * n * 2 / PEAK_BYTES_S * 1e3})
        del x, w, xb, wb
    torch.cuda.empty_cache()
    return out


def serve_lm(dev, gpu, profile: bool) -> dict:
    """gemma2-9b at full width and depth, random float32 weights drawn on
    the card, served as examples/serve_lm.py serves its smoke model
    (batch 4, prompt 8, 48 steps, cache 256); then a bfloat16 copy. With
    ``profile`` each dtype's decode step is also split by kind of op
    (``serve_lm_profile``) and each weight product timed alone
    (``lm_product_ms``)."""
    import dataclasses
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.models import decode, transformer
    from repro_torch.serve import engine
    cfg = get_config(SERVE_LM_ARCH)
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"],
                                seq_len=SERVE_LM_CACHE,
                                global_batch=SERVE_LM_BATCH)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = transformer.init_params(torch.Generator(dev).manual_seed(0),
                                    cfg, torch.float32, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, cfg.vocab_size,
                            (SERVE_LM_BATCH, SERVE_LM_PROMPT), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    report = {"arch": cfg.name, "layers": cfg.num_layers,
              "d_model": cfg.d_model, "heads": cfg.num_heads,
              "kv_heads": cfg.num_kv_heads,
              "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
              "vocab": cfg.vocab_size,
              "kinds": sorted(set(transformer.layer_kinds(cfg))),
              "params": sum(p.numel() for p in model.parameters()),
              "batch": SERVE_LM_BATCH, "prompt": SERVE_LM_PROMPT,
              "steps": SERVE_LM_STEPS, "cache_len": SERVE_LM_CACHE,
              "init_s": init_s, "bytes_before": before,
              "nvidia_smi": gpu, "tf32": torch.backends.cuda.matmul.allow_tf32}
    problems = []
    f32, out32 = serve_lm_dtype(decode, engine, transformer, model, cfg,
                                shape, prompts, torch.float32)
    if profile:
        f32["profile"] = serve_lm_profile(decode, model, cfg, dev)
    model.to(torch.bfloat16)
    torch.cuda.empty_cache()
    bf16, out16 = serve_lm_dtype(decode, engine, transformer, model, cfg,
                                 shape, prompts, torch.bfloat16)
    if profile:
        bf16["profile"] = serve_lm_profile(decode, model, cfg, dev)
    bf16["greedy_ids_equal_f32"] = float(
        (out16 == out32).float().mean().item())
    del model
    torch.cuda.empty_cache()
    if profile:
        report["products"] = lm_product_ms(cfg, dev)
    for r in (f32, bf16):
        if not (r["greedy_rerun_identical"] and r["finite"]):
            problems.append(f"{r['dtype']}: greedy rerun differs or "
                            "non-finite logits")
        if r["out_shape"] != [SERVE_LM_BATCH,
                              SERVE_LM_PROMPT + SERVE_LM_STEPS]:
            problems.append(f"{r['dtype']}: output shape {r['out_shape']}")
    if f32["decode_vs_forward"] > SERVE_LM_RTOL:
        problems.append(f"float32 decode against forward "
                        f"{f32['decode_vs_forward']:.3g} > {SERVE_LM_RTOL}")
    report.update(float32=f32, bfloat16=bf16, problems=problems)
    return report


def domain_corpus(TokenPipeline, vocab, n_domains, docs_per_domain, seq,
                  seed=0):
    """examples/cluster_embeddings.py's corpus: documents from K Markov
    sources, one a domain, shuffled."""
    docs, labels = [], []
    for k in range(n_domains):
        pipe = TokenPipeline(vocab, seed=seed + 1000 * k)
        for _ in range(docs_per_domain):
            docs.append(pipe.sample(seq))
            labels.append(k)
    order = np.random.default_rng(seed).permutation(len(docs))
    return (np.stack(docs)[order],
            np.asarray(labels, np.int32)[order])


def lm_embed_cluster(DPMM, DPMMConfig, dev, gpu) -> tuple:
    """examples/cluster_embeddings.py on the card at its own sizes: a
    smoke-size granite-8b embeds 6 domains x 120 documents of 64 tokens
    (hidden_forward, mean-pooled) and is held against the port on the CPU,
    the embeddings are standardised and the DPGMM fits them (d = 256:
    every sweep through sweep_ref). Returns the report and the fit's
    launches."""
    import copy
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    cfg = smoke_config("granite-8b")
    t0 = time.perf_counter()
    toks, gt = domain_corpus(TokenPipeline, cfg.vocab_size, EMBED_DOMAINS,
                             EMBED_DOCS, EMBED_SEQ)
    corpus_s = time.perf_counter() - t0
    cpu_model = transformer.init_params(0, cfg, device="cpu")
    model = copy.deepcopy(cpu_model).to(dev)

    def embed(m, device):
        out = []
        for i in range(0, toks.shape[0], EMBED_BATCH):
            batch = torch.as_tensor(toks[i:i + EMBED_BATCH],
                                    device=device).long()
            hidden, _ = transformer.hidden_forward(m, batch)
            out.append(hidden.mean(dim=1).cpu())
        return torch.cat(out)

    t0 = time.perf_counter()
    card = embed(model, dev)
    embed_s = time.perf_counter() - t0
    card_vs_cpu = lm_rel(card, embed(cpu_model, "cpu"))
    x = card.numpy()
    x = (x - x.mean(0)) / (x.std(0) + 1e-6)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = DPMM(DPMMConfig(alpha=10.0, iters=80, k_max=32, burnout=5,
                          niw_psi=0.3)).fit(x)
    fit_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    nmi = res.nmi(gt)
    report = {"docs": int(toks.shape[0]), "seq": EMBED_SEQ,
              "embedding_shape": list(x.shape),
              "embeddings_card_vs_cpu": card_vs_cpu, "rtol": LM_RTOL,
              "k_found": res.k, "k_true": EMBED_DOMAINS, "nmi": nmi,
              "reference_example_cpu": {"k": 1, "nmi": 0.0},
              "corpus_s": corpus_s, "embed_s": embed_s, "fit_s": fit_s,
              "launches": launches, "nvidia_smi": gpu}
    problems = []
    if not np.isfinite(x).all() or x.shape != (EMBED_DOMAINS * EMBED_DOCS,
                                               cfg.d_model):
        problems.append(f"embeddings {x.shape} not finite or misshapen")
    if res.labels.shape != (x.shape[0],) or res.k < 1:
        problems.append("fit output misshapen")
    if not card_vs_cpu <= LM_RTOL:
        problems.append(f"card embeddings against the CPU {card_vs_cpu:.3g}"
                        f" > {LM_RTOL}")
    for name in EMBED_PATH:
        if launches[name] == 0:
            problems.append(f"kernel {name} was never launched by the fit")
    report["problems"] = problems
    return report, launches


def lm_phases(DPMM, DPMMConfig, dev, gpu, profile: bool) -> dict:
    """``lm_smoke``, ``serve_lm`` and ``lm_embed_cluster``, each emitted
    and each one's tensors freed before the next; raises on a problem.
    Returns the launches of lm_embed_cluster's fit."""
    import gc
    launched = {}
    for phase in ("lm_smoke", "serve_lm", "lm_embed_cluster"):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if phase == "lm_smoke":
            report = lm_smoke(dev)
        elif phase == "serve_lm":
            report = serve_lm(dev, gpu, profile)
        else:
            report, launched = lm_embed_cluster(DPMM, DPMMConfig, dev, gpu)
        emit(phase, seconds=time.perf_counter() - t0, **report)
        if report["problems"]:
            fail(f"{phase}: {'; '.join(report['problems'])}")
    gc.collect()
    torch.cuda.empty_cache()
    return launched


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="TRACE", default="",
                    help="also profile a second fit; Chrome trace path")
    ap.add_argument("--mesh-only", action="store_true",
                    help="only the build, the fit phase and the mesh "
                         "phases (fit_mesh, fit_feature_shard), on the "
                         "cards present")
    ap.add_argument("--lm-only", action="store_true",
                    help="only the build and the LM phases (lm_smoke, "
                         "serve_lm, lm_embed_cluster)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import DPMMConfig
    from repro_torch.core import checkpoint, gibbs, niw, sampler
    from repro_torch.core.family import get_family
    from repro_torch.core.sampler import DPMM as MeshDPMM
    from repro_torch.data import synthetic
    from repro_torch.data.faults import FaultInjectingSource
    from repro_torch.data.source import HostTiledSource
    from repro_torch.data.synthetic import generate_gmm
    from repro_torch.kernels import (assign, build, fold, loglik, matmul, ops,
                                     suffstats, sweep)

    dev = torch.device("cuda")

    def DPMM(cfg, mesh=None):
        """Every phase but fit_mesh and fit_feature_shard fits on one card,
        however many the machine holds (``DPMM(cfg)`` alone takes them
        all)."""
        if mesh is not None:
            return MeshDPMM(cfg, mesh=mesh)
        return MeshDPMM(cfg, device=dev)

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

    if opts.lm_only:
        lm_phases(DPMM, DPMMConfig, dev, gpu, bool(opts.profile))
        print(gpu)
        return

    if opts.mesh_only:
        x_np, y_np = generate_gmm(FIT_N, FIT_D, FIT_K, seed=0)
        res, _ = run_fit(DPMM, DPMMConfig(**FIT_CFG), x_np, y_np,
                         GAUSS_PATH, gpu, "fit")
        mesh_phases(DPMM, DPMMConfig, HostTiledSource, synthetic, x_np,
                    y_np, res, gpu)
        print(gpu)
        return

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
    # per-launch device and host times at the check's shapes (run_ms)
    check_run = {
        "sweep_gauss": run_ms(lambda: sweep.sweep_gauss_cuda(*args), 20),
        "suffstats_labels": run_ms(lambda: suffstats.suffstats_labels_cuda(
            x, lab, sub, valid, 2 * k_c), 20)}
    emit("kernel_check", n=CHECK_N, d=FIT_D,
         sweep_gauss={"k": k_c, "near_tie_mismatches": ties,
                      "max_abs_err": err_sweep, "repeat_bitwise": True,
                      **dict(zip(("device_ms", "host_ms"),
                                 check_run["sweep_gauss"]))},
         suffstats_labels={"k": 2 * k_c, "max_abs_err": err_stats,
                           "repeat_bitwise": True,
                           **dict(zip(("device_ms", "host_ms"),
                                      check_run["suffstats_labels"]))})

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

    # past d = 256: the panel layout against the plain versions
    t0 = time.perf_counter()
    wide = check_wide_kernels(assign, loglik, dev)
    emit("kernel_check_wide", n=SERVE_B, k=SERVE_KC, k_live=SERVE_LIVE,
         rtol=SERVE_RTOL, seconds=time.perf_counter() - t0, nvidia_smi=gpu,
         **wide)

    # (5) the main path: DPMM.fit on the card through the kernels
    x_np, y_np = generate_gmm(FIT_N, FIT_D, FIT_K, seed=0)
    cfg = DPMMConfig(**FIT_CFG)
    res, launches = run_fit(DPMM, cfg, x_np, y_np, GAUSS_PATH, gpu, "fit")

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

    # the stat fold: the sweep's per-block partials at the fit's final
    # state, from a nonzero accumulator (the final sub-cluster stats)
    fargs, fk_c = fit_sweep_args(res.state, x, gibbs, sampler,
                                 torch.Generator(device=dev).manual_seed(6))
    fout = sweep.sweep_gauss_cuda(*fargs)
    facc = gibbs.compact_gather(gibbs.compaction_plan(res.state.active, fk_c),
                                res.state.substats)
    folds = fold_check(fold, niw.GaussStats(*fout[2:]), facc)
    emit("fold_check", points=FIT_N, d=FIT_D, k=fk_c, nvidia_smi=gpu,
         fields=folds)
    del x, fargs, fout, facc

    # the tiled plane: the fit phase's data and seed from a .npy file in
    # TILE-row tiles, bitwise the resident chain; the same through read
    # faults; then ten times the points, kept in host memory
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "x.npy"
        np.save(path, x_np)
        tcfg = DPMMConfig(tile_size=TILE, **FIT_CFG)
        res_t, rep_t = run_tiled(DPMM, tcfg, HostTiledSource.from_npy(path),
                                 y_np, GAUSS_PATH, gpu, "fit_tiled",
                                 resident=res)
        # a saved chain continues bitwise on both planes
        emit("fit_resume", nvidia_smi=gpu, resident=fit_resume(
            DPMM, checkpoint, cfg, x_np, y_np, res, Path(tmp), GAUSS_PATH,
            gpu), tiled=fit_resume(
            DPMM, checkpoint, tcfg, HostTiledSource.from_npy(path), y_np,
            res_t, Path(tmp), GAUSS_PATH, gpu))
        faulty = FaultInjectingSource(HostTiledSource.from_npy(path),
                                      hang_s=0.0, **FAULTS)

        def fault_checks(r, report):
            faults = [e for e in r.recoveries
                      if e["kind"] == "tile_read_fault"]
            report["injected"] = len(faulty.injected)
            report["injected_kinds"] = sorted({f["kind"]
                                               for f in faulty.injected})
            report["labels_equal_fit_tiled"] = bool(
                np.array_equal(r.labels, res_t.labels))
            problems = []
            if not faulty.injected:
                problems.append("no fault was injected")
            if [e["rows"] for e in faults] != [f["rows"] for f in
                                               faulty.injected]:
                problems.append("recoveries do not list the injected faults")
            if not report["labels_equal_fit_tiled"]:
                problems.append("labels differ from fit_tiled's")
            return problems

        run_tiled(DPMM, DPMMConfig(tile_size=TILE, io_retries=6,
                                   io_backoff_s=0.001, **FIT_CFG),
                  faulty, y_np, GAUSS_PATH, gpu, "fit_tiled_faults",
                  resident=res, after=fault_checks)
        del faulty

        # fault tolerance, several chains and the growable slab
        from repro_torch.data import source as sources
        from repro_torch.kernels import prng
        for phase, run in (
                ("fit_resilience", lambda: fit_resilience(
                    DPMM, DPMMConfig, checkpoint, synthetic, sources, cfg,
                    tcfg, x_np, path, res, res_t, Path(tmp), gpu)),
                ("fit_multichain", lambda: fit_multichain(
                    DPMM, DPMMConfig, prng, synthetic, sources, cfg, x_np,
                    y_np, res, gpu)),
                ("fit_k_auto", lambda: fit_k_auto(DPMM, DPMMConfig, x_np,
                                                  y_np, gpu))):
            t0 = time.perf_counter()
            report = run()
            emit(phase, seconds=time.perf_counter() - t0, nvidia_smi=gpu,
                 **report)
            if report["problems"]:
                fail(f"{phase}: {'; '.join(report['problems'])}")
    t0 = time.perf_counter()
    xbig_np, ybig_np = generate_gmm(LARGE_N, FIT_D, FIT_K, seed=0)
    gen_s = time.perf_counter() - t0

    def large_checks(r, report):
        report["generate_s"] = gen_s
        report["x_bytes"] = xbig_np.nbytes
        report["fit_tiled_peak_above_start"] = rep_t["peak_above_start"]
        problems = []
        if report["peak_above_start"] > 1.5 * rep_t["peak_above_start"]:
            problems.append("device bytes grew with N: above 1.5x "
                            "fit_tiled's")
        if report["peak_above_start"] >= xbig_np.nbytes / 4:
            problems.append("device bytes not under a quarter of x's")
        return problems

    run_tiled(DPMM, DPMMConfig(tile_size=TILE, **LARGE_CFG),
              HostTiledSource(xbig_np), ybig_np, GAUSS_PATH, gpu,
              "fit_tiled_large", after=large_checks)
    del xbig_np, ybig_np

    # the linear families' paths: each fit with the counts set to 0 just
    # before it and read just after
    lin = {}
    for comp, gen_name, n_fit, d_fit in LINEAR_FITS:
        xl_np, yl_np = getattr(synthetic, gen_name)(n_fit, d_fit, FIT_K,
                                                    seed=0)
        lcfg = DPMMConfig(component=comp, **FIT_CFG)
        lres, llaunch = run_fit(DPMM, lcfg, xl_np, yl_np,
                                LINEAR_PATH, gpu, f"fit_{comp}")
        lin[comp] = (lres, llaunch, lcfg, xl_np)
        if comp == "multinomial":
            run_tiled(DPMM, DPMMConfig(component=comp, tile_size=TILE,
                                       **FIT_CFG),
                      HostTiledSource(xl_np), yl_np, LINEAR_PATH, gpu,
                      "fit_tiled_multinomial", resident=lres)
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
    res128, launch128 = run_fit(DPMM, cfg, x128_np, y128_np, GAUSS_PATH,
                                gpu, "fit_gaussian_d128")
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
    d128["sweep_gauss"]["device_ms"], d128["sweep_gauss"]["host_ms"] = (
        run_ms(lambda: sweep.sweep_gauss_cuda(*a128), 10))
    (d128["suffstats_labels"]["device_ms"],
     d128["suffstats_labels"]["host_ms"]) = run_ms(
        lambda: suffstats.suffstats_labels_cuda(*s_args), 10)
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
        ("assign_gauss", "sub_assign_gauss", "suffstats_labels",
         "fold_partials"), gpu, "fit_gaussian_d256")
    if not (launch256["sweep_gauss"] == 0
            and launch256["assign_gauss"] == cfg.iters
            and launch256["sub_assign_gauss"]
            == assign.SUB_LAUNCHES * cfg.iters):
        fail(f"fit_gaussian_d256: launches {launch256}")
    k256 = kernels_d256(res256, launch256, x256_np, cfg, gibbs, sampler,
                        assign, suffstats, loglik, dev)
    emit("kernels_d256", nvidia_smi=gpu, **k256)

    # past the one-read sweep's 2048 slots and one stat window's 8192: a
    # 4096-slot dense slab (sweep_ref every iteration) and k_max = 10,000
    # (the init folds in two slot windows)
    xk_np, yk_np = generate_gmm(K_LARGE_N, K_LARGE_D, FIT_K, seed=0)
    k_large = {}
    for name, extra in K_LARGE_FITS:
        kcfg = DPMMConfig(**{**FIT_CFG, **extra})
        path = (GAUSS_PATH if kcfg.compact else
                ("assign_gauss", "sub_assign_gauss", "suffstats_labels",
                 "fold_partials"))
        _, lk = run_fit(DPMM, kcfg, xk_np, yk_np, path, gpu, "fit_k_large",
                        emit_phase=False)
        k_large[name] = run_fit.report
        if not kcfg.compact and not (
                lk["sweep_gauss"] == 0 and lk["assign_gauss"] == cfg.iters
                and lk["sub_assign_gauss"]
                == assign.SUB_LAUNCHES * cfg.iters):
            fail(f"fit_k_large {name}: launches {lk}")
        if kcfg.k_max > suffstats.MAX_K and lk["suffstats_labels"] < 4:
            fail(f"fit_k_large {name}: the init folds' slot windows were "
                 f"not launched ({lk['suffstats_labels']} launches)")
    emit("fit_k_large", n=K_LARGE_N, d=K_LARGE_D, **k_large)
    del xk_np, yk_np

    # the Gaussian fit past d = 256: sweep_ref every iteration, its label
    # folds in stat windows
    xw_np, yw_np = generate_gmm(WIDE_FIT_N, WIDE_FIT_D, WIDE_FIT_K, seed=0)
    _, launchw = run_fit(
        DPMM, cfg, xw_np, yw_np,
        ("assign_gauss", "sub_assign_gauss", "suffstats_labels",
         "fold_partials"), gpu, "fit_gaussian_wide")
    if not (launchw["sweep_gauss"] == 0
            and launchw["assign_gauss"] == cfg.iters
            and launchw["sub_assign_gauss"]
            == assign.SUB_LAUNCHES * cfg.iters):
        fail(f"fit_gaussian_wide: launches {launchw}")
    del xw_np, yw_np

    # the stat and step-(f) kernels past one slot window and past d = 256
    t0 = time.perf_counter()
    wcheck = kernel_check_windows(ops, suffstats, assign, dev)
    wcheck.update(linear_window_checks(ops, assign, dev))
    emit("kernel_check_windows", stats_rtol=STATS_RTOL, tie_rtol=TIE_RTOL,
         seconds=time.perf_counter() - t0, nvidia_smi=gpu, **wcheck)

    # the dense suffstats oracle through its entry point (ops.suffstats),
    # at the fits' final states (resp the one-hot of the compact labels, or
    # Dirichlet(1) rows), a ragged shape, d = 256 and the reference's
    # §4.2 shapes; and against suffstats_labels on the segments' one-hot
    gd = torch.Generator(device=dev).manual_seed(8)

    def compact32(r, n=None):
        if r.k > 32:
            fail(f"kernel_check_dense: {r.k} live clusters exceed 32 slots")
        lab = torch.as_tensor(r.labels[:n], device=dev).long()
        return gibbs.compaction_plan(r.state.active, 32).compact_of_slot[lab]

    def one_hot(lab, k):
        # a label outside the k slots (a point in an inactive slot past the
        # compact slab: the Threefry top bin) gets an all-zero row
        return torch.nn.functional.one_hot(lab.long().clamp(max=k), k + 1
                                           )[:, :k].to(torch.float32)

    def soft(n, k):
        g = torch._standard_gamma(torch.ones(n, k, device=dev), generator=gd)
        return g / g.sum(dim=1, keepdim=True)

    x = torch.as_tensor(x_np, device=dev)
    lab32 = compact32(res)
    dense_cases = {
        "fit_d32_one_hot": (x, one_hot(lab32, 32), True),
        "fit_d32_soft": (x, soft(FIT_N, 32), False),
        "fit_d128_one_hot": (torch.as_tensor(x128_np, device=dev),
                             one_hot(compact32(res128), 32), True),
        "ragged": (torch.randn(1003, 7, device=dev, generator=gd),
                   soft(1003, 5), False),
        "d256": (torch.as_tensor(x256_np[:DENSE_D256_N], device=dev),
                 one_hot(compact32(res256, DENSE_D256_N), 32), True)}
    for n_r, k_r, d_r in DENSE_REF_SHAPES:
        dense_cases[f"ref_{n_r}x{k_r}x{d_r}"] = (
            torch.randn(n_r, d_r, device=dev, generator=gd),
            one_hot(torch.randint(0, k_r, (n_r,), device=dev, generator=gd),
                    k_r), True)
    dense_launches, dense = kernel_check_dense(ops, suffstats, dense_cases)
    sub32 = torch.randint(0, 2, (FIT_N,), device=dev, generator=gd,
                          dtype=torch.int32)
    emit("kernel_check_dense", stats_rtol=STATS_RTOL,
         entry_point_launches=dense_launches,
         against_suffstats_labels=dense_against_labels(
             suffstats, get_family("gaussian"), x,
             lab32.to(torch.int32), sub32, 32),
         nvidia_smi=gpu, **dense)
    del x, dense_cases, lab32, sub32

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
        # a Gaussian model past d = 256, built from labelled points
        t0 = time.perf_counter()
        xw_np, yw_np = generate_gmm(WIDE_SERVE_FIT_N, WIDE_SERVE_D, FIT_K,
                                    seed=0)
        xq["gaussian_wide"], yq["gaussian_wide"] = generate_gmm(
            SERVE_ROWS, WIDE_SERVE_D, FIT_K, seed=0)
        report, _, serve_launch["gaussian_wide"] = serve_model(
            "gaussian_wide", synthetic_gauss_state(
                xw_np, yw_np, WIDE_SERVE_K_MAX, dev), "gaussian",
            xq["gaussian_wide"], yq["gaussian_wide"], xw_np, Path(tmp), gpu)
        emit("serve_gaussian_wide", fit_points=WIDE_SERVE_FIT_N,
             seconds=time.perf_counter() - t0, **report)
        del xw_np, yw_np, xq["gaussian_wide"], yq["gaussian_wide"]
    serve_times = time_serve_kernels(engines, xq, assign, loglik, matmul,
                                     dev)

    # online refinement of the served Gaussian and multinomial models
    t0 = time.perf_counter()
    refine_rep, refine_launch = serve_refine(
        {"gaussian": (res, "generate_gmm", FIT_D),
         "multinomial": (lin["multinomial"][0], "generate_mnmm", 128)},
        synthetic, gpu)
    emit("serve_refine", seconds=time.perf_counter() - t0, **refine_rep)

    # the elastic multi-process fit: a coordinator and worker processes
    # on the one card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        workers_rep, workers_launch = fit_workers(
            DPMM, DPMMConfig, HostTiledSource, x_np, y_np,
            lin["multinomial"][3], Path(tmp), gpu)
    emit("fit_workers", seconds=time.perf_counter() - t0, **workers_rep)
    if workers_rep["problems"]:
        fail(f"fit_workers: {'; '.join(workers_rep['problems'])}")

    # one fit over a device mesh: data shards, then feature shards
    mesh_launch = mesh_phases(DPMM, DPMMConfig, HostTiledSource, synthetic,
                              x_np, y_np, res, gpu)

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
    run_sweep = run_ms(lambda: sweep.sweep_gauss_cuda(*sargs), 20)
    plain_sweep = cuda_ms(lambda: sweep.sweep_gauss_plain(*sargs), 3)
    ms_stats = cuda_ms(lambda: suffstats.suffstats_labels_cuda(
        x, lab_c, sub, valid, k_sm), 20)
    run_stats = run_ms(lambda: suffstats.suffstats_labels_cuda(
        x, lab_c, sub, valid, k_sm), 20)
    plain_stats = cuda_ms(lambda: suffstats.suffstats_labels_plain(
        x, lab_c, sub, valid, k_sm), 3)

    n, d = x.shape
    work = gauss_work(n, d, k_c, n_act, k_sm)
    rows = []
    for name, ms, run, plain, err, src, repl in (
            ("sweep_gauss", ms_sweep, run_sweep, plain_sweep, err_sweep,
             "src/repro_torch/csrc/sweep_gauss.cu",
             "src/repro/kernels/sweep.py:344"),
            ("suffstats_labels", ms_stats, run_stats, plain_stats, err_stats,
             "src/repro_torch/csrc/suffstats_labels.cu",
             "src/repro/kernels/suffstats.py:169")):
        bound_ms, bound_by = bound(*work[name])
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name],
            "launches_per_iter": launches[name] / cfg.iters,
            "max_abs_err": err, "ms": ms, "device_ms": run[0],
            "host_ms": run[1], "plain_ms": plain,
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
            "library_ms": t["library_ms"],
            **{key: t[key] for key in ("device_ms", "host_ms") if key in t}})
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
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            **{key: t[key] for key in ("device_ms", "host_ms",
                                        "library_device_ms") if key in t},
            **({"d256": {key: k256[name][key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms")}}
               if name in ("assign_gauss", "loglik_gauss") else {})})
    # assign_linear and sub_assign_linear alone at the serving steps, the
    # three-pass multinomial fit's final state, the multinomial fit's and
    # the 20newsgroups width
    res3, x3_np = three_fit["multinomial"]
    a3, _ = fit_linear_args(get_family("multinomial"), res3.state,
                            torch.as_tensor(x3_np, device=dev), gibbs,
                            sampler, gen)
    step_states = {}
    for name, fam, make, d_s in (
            ("serve_multinomial", "multinomial", "generate_mnmm", 128),
            ("serve_diag_gaussian", "diag_gaussian", "generate_gmm",
             FIT_D)):
        xs_np, ys_np = getattr(synthetic, make)(SERVE_B, d_s, SERVE_LIVE,
                                                seed=2)
        step_states[name] = linear_sweep_args(
            get_family(fam), torch.as_tensor(xs_np, device=dev), ys_np,
            SERVE_KC, dev)
    step_states.update(three_pass_multinomial_fit=a3,
                       multinomial_fit=largs, news20=news_args)
    linear_steps = linear_step_times(assign, step_states)
    del step_states
    emit("kernel_times", n=n, d=d, k_sweep=k_c, k_live=n_act,
         k_stats=k_sm, near_tie_mismatches=ties_fit,
         linear_fit_states=fit_states,
         timing_launches=ops.launch_counts(),
         detail={r["name"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                             "bound_ms": r["bound_ms"]} for r in rows},
         multinomial_fit_state=lin_times, news20=news_times,
         serve_step=serve_times, linear_steps=linear_steps, nvidia_smi=gpu)

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
            **dict(zip(("device_ms", "host_ms"), run_ms(
                lambda: assign.sub_assign_gauss_cuda(*g_args), 20))),
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
    out3 = sweep.sweep_linear_cuda(*a3)
    l3_args = linear_sub_args(a3, out3[0])
    l3 = check_sub_assign(assign, False, l3_args, out3[1])
    kc3, dp3 = a3[1].shape[0], a3[0].shape[1]
    n3 = a3[0].shape[0]
    l3.update(ms=cuda_ms(lambda: assign.sub_assign_linear_cuda(*l3_args),
                         20),
              plain_ms=cuda_ms(
                  lambda: assign.sub_assign_linear_plain(*l3_args), 3),
              **dict(zip(("device_ms", "host_ms"), run_ms(
                  lambda: assign.sub_assign_linear_cuda(*l3_args), 50))))
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
            "bound_by": t["bound_by"], "library_ms": None,
            **{key: t[key] for key in ("device_ms", "host_ms") if key in t}})
    # the stat fold (every fit path, every field of a fold in one launch;
    # times at the d = 32 fit's sweep partials) and the dense oracle (its
    # entry point only; times at the d = 32 fit's final state, one-hot)
    fx = folds["one_launch"]
    rows.append({
        "name": "fold_partials", "route": "cuda",
        "source": "src/repro_torch/csrc/fold_partials.cu",
        "replaces": "src/repro/core/family.py:225",
        "launches": launches["fold_partials"],
        "launches_per_iter": launches["fold_partials"] / cfg.iters,
        "max_abs_err": 0.0, "ms": fx["ms"], "plain_ms": fx["plain_ms"],
        "bound_ms": fx["bound_ms"], "bound_by": fx["bound_by"],
        "library_ms": None, "device_ms": fx["device_ms"],
        "host_ms": fx["host_ms"],
        "per_field_ms_sum": fx["per_field_ms_sum"]})
    dx = dense["fit_d32_one_hot"]
    rows.append({
        "name": "suffstats", "route": "cuda",
        "source": "src/repro_torch/csrc/suffstats_dense.cu",
        "replaces": "src/repro/kernels/suffstats.py:127",
        "launches": dense_launches, "launches_fit_paths": launches[
            "suffstats"],
        "max_abs_err": max(r["max_abs_err"] for r in dense.values()),
        "ms": dx["ms"], "plain_ms": dx["plain_ms"],
        "bound_ms": dx["bound_ms"], "bound_by": dx["bound_by"],
        "library_ms": dx["library_ms"], "device_ms": dx["device_ms"],
        "host_ms": dx["host_ms"],
        "library_device_ms": dx["library_device_ms"]})
    # the launches of serve_refine's, fit_workers', fit_mesh's and
    # fit_feature_shard's main paths
    for r in rows:
        r["launches_serve_refine"] = sum(v[r["name"]]
                                         for v in refine_launch.values())
        r["launches_fit_workers"] = workers_launch.get(r["name"], 0)
        for phase, launched in mesh_launch.items():
            r[f"launches_{phase}"] = launched.get(r["name"], 0)
        r["launches"] += (r["launches_serve_refine"]
                          + r["launches_fit_workers"]
                          + sum(launched.get(r["name"], 0)
                                for launched in mesh_launch.values()))
    emit("matmul_crossover", nvidia_smi=gpu,
         paper_crossover_dn=640_000, **matmul_crossover(matmul, dev))
    # the LM zoo (no kernel of its own; lm_embed_cluster's fit launches the
    # Gaussian three-pass kernels)
    lm_launch = lm_phases(DPMM, DPMMConfig, dev, gpu, bool(opts.profile))
    for r in rows:
        r["launches_lm_embed_cluster"] = lm_launch.get(r["name"], 0)
        r["launches"] += r["launches_lm_embed_cluster"]
    torch.cuda.synchronize()
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
