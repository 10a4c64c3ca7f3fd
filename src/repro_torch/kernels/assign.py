"""Steps (e) and (f) alone: labels and sub-labels of a batch of points.

Port of ``repro.kernels.assign.assign_gauss`` and ``assign_linear`` (the
running first-max over K tiles, without step (f) or a stat fold), which
``DPMMEngine.sample`` and the three-pass sweep run through
``ComponentFamily.assign``, and of ``sub_assign_gauss`` and
``sub_assign_linear`` (each point's own cluster's two sub-components),
which the three-pass sweep runs through ``ComponentFamily.sub_assign``::

    assign_gauss:  x (N, d) f32; mu (K, d); chol_prec (K, d, d);
                   logdet_prec, logw (K,); active (K,) int32; gidx (N,)
                   int64 Gumbel counters; key_z (2,) int64 key words;
                   slots (K,) int32 dense slot ids  -> labels (N,) int32
    assign_linear: feats (N, d') f32; w (K, d'); const, logw (K,); the
                   rest as above                    -> labels (N,) int32
    sub_assign_gauss:  x (N, d); sub_mu (K, 2, d); sub_chol_prec
                   (K, 2, d, d); sub_logdet_prec, sublogw (K, 2); labels
                   (N,) int32; gidx (N,) int64; key_zb (2,) int64
                                                    -> sublabels (N,) int32
    sub_assign_linear: feats (N, d'); subw (K, 2, d'); subconst, sublogw
                   (K, 2); labels, gidx, key_zb as above
                                                    -> sublabels (N,) int32

Two versions of each function:

- ``*_cuda``: the hand-written kernels ``csrc/assign_gauss.cu``,
  ``csrc/assign_linear.cu``, ``csrc/sub_assign_gauss.cu`` and
  ``csrc/sub_assign_linear.cu``, whose device code is the one-read sweeps'
  step (e) and step (f) (``csrc/assign_tile.cuh``, ``csrc/te_tile.cuh``,
  and for the linear families ``csrc/linear_tile.cuh``, the one copy of
  their chains); each launch of a call counted in the wrapper's
  ``launches``;
- ``*_plain``: steps (e) and (f) of the sweeps' plain versions
  (``kernels/sweep.py``), the same math in plain PyTorch.

``kernels.ops`` picks between them by the tensor's device.
``assign_gauss`` (and ``loglik_gauss``) run, above d = GAUSS_NARROW_D and
up to 128, the register tile of the one-read sweep's step (e)
(``csrc/te_tile.cuh``) on a grid of point tiles x slot groups that
``gauss_plan`` chooses from the shape alone; at and below it, the narrow
in-block layout; past d = 128, the panel layout, which takes any d:
(X - mu_k) F_k as a register-tiled product over streamed row slabs, on a
grid of point tiles x slot groups that ``panel_plan`` chooses. With
several slot groups an ``assign_gauss`` call is two launches, the groups'
rows folded by the second (``assign_gauss_launches``). ``sub_assign_gauss``
groups the points by label across the batch (three launches a slot
window, ``SUB_LAUNCHES``, over the windows of ``suffstats.slot_windows``),
then stages a label's factors once for a run of its points
(``sub_plan``: a thread a point at d <= 64, a register-tiled product
above, in column panels of 256 past d = 256), and takes any d and K.
``assign_linear`` and ``sub_assign_linear`` run the one-read
``sweep_linear``'s tile with one step switched off, on tiles of points
that fill the card (``linear_assign_plan``, ``linear_sub_plan``), and
take any K (step (e) walks slot windows of LT_WIN; step (f) alone keeps
nothing K-sized: each warp takes a run of consecutive points).
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build, prng
from repro_torch.kernels.launch import check_cuda, launch
from repro_torch.kernels.suffstats import MAX_DP, MAX_K, slot_windows
from repro_torch.kernels.sweep import (LE_BK, LE_BLOCKS, LE_FSTR, LOG_2PI,
                                       NEG_INF, TE_BM,
                                       assign_linear_plain,
                                       sub_assign_linear_plain, te_smem)
from repro_torch.kernels.sweep import MAX_D as WIDE_D
from repro_torch.kernels.sweep import assign_plain as assign_gauss_plain
from repro_torch.kernels.sweep import (
    sub_assign_plain as sub_assign_gauss_plain)


def assign_mismatches(gauss: bool, args, labels_a, labels_b,
                      rtol: float) -> Tuple[int, int]:
    """Compare two step-(e) labellings over the same ``args`` (the
    arguments of ``assign_gauss`` if ``gauss``, else of ``assign_linear``,
    in order): returns (points that differ, those of them that are not
    near-ties). A mismatch is a near-tie when the two labels' logits,
    recomputed in float64, are within ``rtol`` of each other (relative to
    the larger, at least 1)."""
    bad = torch.nonzero(labels_a != labels_b).flatten()
    if bad.numel() == 0:
        return 0, 0
    both = torch.stack([labels_a[bad], labels_b[bad]], 1).long()
    x, p1, p2 = args[0][bad].double(), args[1][both].double(), args[2]
    if gauss:
        d = x.shape[1]
        y = torch.einsum("mkd,mkde->mke", x[:, None, :] - p1,
                         p2[both].double())
        ll = 0.5 * (args[3][both].double() - (y * y).sum(-1)) \
            - 0.5 * d * LOG_2PI
    else:
        ll = (torch.einsum("md,mkd->mk", x, p1)
              + args[2][both].double())
    logw, active, gidx, key_z, slots = args[4:] if gauss else args[3:]
    t = torch.where(active[both] != 0, ll + logw[both].double(), NEG_INF)
    t = t + prng.gumbel(key_z, gidx[bad][:, None],
                        slots.long()[both]).double()
    gap = (t[:, 0] - t[:, 1]).abs() / t.abs().max(1).values.clamp(min=1)
    return int(bad.numel()), int((gap > rtol).sum())


def sub_assign_mismatches(gauss: bool, args, sub_a, sub_b,
                          rtol: float) -> Tuple[int, int]:
    """Compare two step-(f) sub-labellings over the same ``args`` (the
    arguments of ``sub_assign_gauss`` if ``gauss``, else of
    ``sub_assign_linear``, in order): returns (points that differ, those of
    them that are not near-ties). A mismatch is a near-tie when the two
    sub-clusters' logits under the point's own cluster, recomputed in
    float64, are within ``rtol`` of each other (relative to the larger, at
    least 1)."""
    bad = torch.nonzero(sub_a != sub_b).flatten()
    if bad.numel() == 0:
        return 0, 0
    x = args[0][bad].double()
    labels, gidx, key_zb = args[-3:]
    own = labels[bad].long()
    if gauss:
        smu, sf, sld, sublogw = args[1:5]
        y = torch.einsum("msd,msde->mse", x[:, None, :] - smu[own].double(),
                         sf[own].double())
        t = 0.5 * (sld[own].double() - (y * y).sum(-1)) \
            - 0.5 * x.shape[1] * LOG_2PI
    else:
        subw, subconst, sublogw = args[1:4]
        t = (torch.einsum("md,msd->ms", x, subw[own].double())
             + subconst[own].double())
    t = t + sublogw[own].double() + prng.gumbel(
        key_zb, gidx[bad][:, None],
        torch.arange(2, device=x.device)[None, :]).double()
    gap = (t[:, 0] - t[:, 1]).abs() / t.abs().max(1).values.clamp(min=1)
    return int(bad.numel()), int((gap > rtol).sum())


F32, I32, I64 = torch.float32, torch.int32, torch.int64

# The panel layout of csrc/assign_tile.cuh (assign_gauss and loglik_gauss
# past d = 128), whose launch this module chooses (``panel_plan``): columns
# of y a column tile, slabs in the shared ring, the point tiles the
# launchers hold with each one's rows a slab, and the blocks that fill the
# card (132 SMs, two a SM). N, d and K are ints in the kernels.
PANEL_BN, PANEL_STAGES = 128, 3
PANEL_BK = {128: 32, 32: 16}
PANEL_BM = tuple(PANEL_BK)
PANEL_BLOCKS = 2 * 132
PANEL_MAX = 2 ** 31 - 1


class PanelPlan(NamedTuple):
    """The launch of the panel layout: its point tile (template), grid
    (point tiles x slot groups) and dynamic shared bytes."""
    bm: int       # points a block: 128, or 32 where 128 would not fill
    tiles: int    # point tiles, ceil(N / bm)
    per: int      # slots a group, in order
    groups: int   # slot groups, ceil(K / per), none empty
    nct: int      # column tiles of y, PANEL_BN each, zero past d
    smem: int     # dynamic shared bytes a block


@lru_cache(maxsize=256)
def panel_plan(n: int, d: int, k: int) -> PanelPlan:
    """The panel launch for (n, d, k), chosen here only: the launchers take
    it as given and refuse a point tile they do not hold or shared bytes
    other than its layout. The point tile is 128 rows where that with one
    group per slot makes PANEL_BLOCKS blocks, else 32 (a serving step of a
    few hundred rows). With PANEL_BLOCKS point tiles or more, one group
    walks all slots. Else the slots are cut into groups of ``per`` in
    order: a block's time grows with its slots, so the grid takes about
    waves x per, waves of PANEL_BLOCKS blocks, and the plan takes the
    ``per`` that makes that least, the fewest groups among equals (an
    8192-row step of 32 slots takes 4 groups of 8, one wave of 256
    blocks, not 5 of 7 in two waves). Neither choice changes a point's
    bits: the column tile and the order of every sum are fixed."""
    if not (1 <= n <= PANEL_MAX and 1 <= d <= PANEL_MAX
            and 1 <= k <= PANEL_MAX):
        raise ValueError(f"panel layout: N={n}, d={d}, K={k} outside "
                         f"[1, {PANEL_MAX}] (ints in the kernel)")
    bm = PANEL_BM[0] if -(-n // PANEL_BM[0]) * k >= PANEL_BLOCKS \
        else PANEL_BM[1]
    tiles = -(-n // bm)
    best = (k, k)                          # (waves x per, per)
    for groups in range(2, min(k, 65535) + 1) if tiles < PANEL_BLOCKS \
            else ():
        per = -(-k // groups)
        cost = -(-tiles * -(-k // per) // PANEL_BLOCKS) * per
        if cost < best[0]:
            best = (cost, per)
    per = best[1]
    # a stage: the x slab (stride bm + 4), the F slab and the slab's means
    smem = 4 * PANEL_STAGES * PANEL_BK[bm] * (bm + 4 + PANEL_BN + 1)
    return PanelPlan(bm, tiles, per, -(-k // per), -(-d // PANEL_BN), smem)


# The register tile of csrc/te_tile.cuh (assign_gauss and loglik_gauss up
# to d = 128, the one-read sweep's step (e)), whose launch ``gauss_plan``
# chooses: 128-point tiles x slot groups, the blocks that fill the card
# (two an SM of the H100's 132), and the d at and below which the narrow
# in-block layout (a thread a point, csrc/assign_tile.cuh) runs instead.
GAUSS_NARROW_D = 16
TE_BLOCKS = 2 * 132


class GaussPlan(NamedTuple):
    """The launch of ``assign_gauss`` / ``loglik_gauss`` at d <= 128: the
    narrow in-block layout (``dp`` 0: one group, its shared bytes sized by
    the launcher) or the register tile at padded width ``dp`` (32, 64 or
    128) on ``tiles`` x ``groups`` blocks with ``smem`` dynamic shared
    bytes a block."""
    dp: int
    tiles: int    # point tiles, ceil(N / TE_BM)
    groups: int   # slot groups, each a share of the column tiles
    smem: int


def group_share(total: int, groups: int, g: int) -> range:
    """Group g's share of ``total`` column tiles (or slots) of the tile,
    as ``csrc/te_tile.cuh`` cuts them on the card from the live count:
    [g total // groups, (g + 1) total // groups), each item once."""
    return range(g * total // groups, (g + 1) * total // groups)


@lru_cache(maxsize=256)
def gauss_plan(n: int, d: int, k: int) -> GaussPlan:
    """The launch for (n, d <= 128, k), chosen here only, from the shape
    and not from ``active`` (a host read would sync every sample step).
    Above GAUSS_NARROW_D: the tile at d rounded up to 32, 64 or 128, whose
    128-column tiles hold 128 / dp slots; with TE_BLOCKS point tiles or
    more one group takes every column tile. Else the column tiles of all K
    slots (the most the live ones can need) are shared among groups: the
    grid takes about waves x (ceil(tiles / groups) + 1) column tiles' time,
    waves of TE_BLOCKS blocks, the 1 a block's own work (its x tile, the
    live count, the inactive slots' draws), and the plan takes the most
    groups that make that least, so that fewer live slots than K still
    spread over the card (an 8192-row step, 64 point tiles, of 32 slots at
    d = 32: 8 column tiles in 4 groups, 256 blocks in one wave). No choice
    changes a point's bits: the order of every sum is fixed."""
    if not (1 <= n <= PANEL_MAX and 1 <= d <= WIDE_D
            and 1 <= k <= PANEL_MAX):
        raise ValueError(f"gauss_plan: N={n}, d={d}, K={k} outside "
                         f"[1, {PANEL_MAX}], [1, {WIDE_D}], [1, {PANEL_MAX}]"
                         " (ints in the kernel)")
    tiles = -(-n // TE_BM)
    if d <= GAUSS_NARROW_D:
        return GaussPlan(0, tiles, 1, 0)
    dp = next(p for p in (32, 64, 128) if d <= p)
    nct = -(-k // (128 // dp))
    best = (-(-tiles // TE_BLOCKS) * (nct + 1), 1)   # (cost, groups)
    for groups in range(2, min(nct, 65535) + 1) if tiles < TE_BLOCKS \
            else ():
        cost = -(-tiles * groups // TE_BLOCKS) * (-(-nct // groups) + 1)
        if cost <= best[0]:
            best = (cost, groups)
    return GaussPlan(dp, tiles, best[1], te_smem(dp, k))


def assign_gauss_launches(n: int, d: int, k: int) -> int:
    """Kernels one ``assign_gauss_cuda`` call launches: the tile or panel
    of ``gauss_plan`` / ``panel_plan``, then, with several slot groups,
    the fold of their rows; each is counted in ``launches``."""
    plan = gauss_plan(n, d, k) if d <= WIDE_D else panel_plan(n, d, k)
    return 2 if plan.groups > 1 else 1


def _check_launch(name, x, width, k, max_width, what, tensors) -> None:
    """Raise on what a kernel does not take: a tensor off the card, a width
    outside [1, ``max_width``], no slots or points, and any of ``tensors``
    ((name, tensor, dtype, shape) rows, x first) of another device, type,
    shape or layout."""
    n = x.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"{name}_cuda takes CUDA tensors; the plain "
                         "version serves the CPU")
    if not 1 <= width <= max_width:
        why = " (an int in the kernel)" if max_width == PANEL_MAX else ""
        raise ValueError(f"{name}: {what}={width} outside [1, {max_width}]"
                         f"{why}")
    if k < 1 or n == 0:
        raise ValueError(f"{name}: needs K >= 1 slots and points, got "
                         f"K={k}, N={n}")
    for arg, t, dtype, shape in (("x", x, F32, (n, width)),) + tensors:
        check_cuda(arg, t, dtype, shape, x.device)


def _step_e_rows(n, k, logw, active, gidx, key_z, slots):
    return (("logw", logw, F32, (k,)), ("active", active, I32, (k,)),
            ("gidx", gidx, I64, (n,)), ("key_z", key_z, I64, (2,)),
            ("slots", slots, I32, (k,)))


def _step_f_rows(n, k, sublogw, labels, gidx, key_zb):
    return (("sublogw", sublogw, F32, (k, 2)), ("labels", labels, I32, (n,)),
            ("gidx", gidx, I64, (n,)), ("key_zb", key_zb, I64, (2,)))


def assign_gauss_cuda(x, mu, chol_prec, logdet_prec, logw, active, gidx,
                      key_z, slots) -> torch.Tensor:
    """One call of ``csrc/assign_gauss.cu`` on the current stream: the
    narrow layout or the tile of ``gauss_plan`` for d <= 128, else the
    panel layout of ``panel_plan``, and with several slot groups the fold
    of their rows (``assign_gauss_launches``)."""
    n, d = x.shape
    k = mu.shape[0]
    _check_launch("assign_gauss", x, d, k, PANEL_MAX, "d", (
        ("mu", mu, F32, (k, d)), ("chol_prec", chol_prec, F32, (k, d, d)),
        ("logdet_prec", logdet_prec, F32, (k,)))
        + _step_e_rows(n, k, logw, active, gidx, key_z, slots))
    labels = torch.empty((n,), device=x.device, dtype=torch.int32)
    head = (x.data_ptr(), n, d, mu.data_ptr(), chol_prec.data_ptr(),
            logdet_prec.data_ptr(), logw.data_ptr(), active.data_ptr(),
            slots.data_ptr(), k, gidx.data_ptr(), key_z.data_ptr())
    if d <= WIDE_D:
        plan = gauss_plan(n, d, k)
        fn = build.c_function("assign_gauss", "assign_gauss_launch",
                              "piippppppipp" + "iiippp")
        route = (plan.dp, plan.groups, plan.smem)
    else:
        plan = panel_plan(n, d, k)
        fn = build.c_function("assign_gauss", "assign_gauss_panel_launch",
                              "piippppppipp" + "iiiippp")
        route = (plan.bm, plan.per, plan.groups, plan.smem)
    # each group's running max (floats) and label (ints), n a group
    scratch = (torch.empty((2 * plan.groups * n,), device=x.device,
                           dtype=torch.float32)
               if plan.groups > 1 else None)
    launch(fn, x.device, *head, *route,
           0 if scratch is None else scratch.data_ptr(), labels.data_ptr())
    assign_gauss_cuda.launches += 2 if plan.groups > 1 else 1
    return labels


assign_gauss_cuda.launches = 0


# csrc/linear_tile.cuh run alone, step (e) by csrc/assign_linear.cu and
# step (f) by csrc/sub_assign_linear.cu: the point tiles (largest first:
# the one-read sweep's 128 and 64 and, alone, 32), the chunk ring of each
# step-(e) tile, the slots a step-(e) window. A plan takes the largest
# tile that makes LE_BLOCKS blocks (two an SM of the H100's 132); step
# (f)'s warp route takes tiles of 256 points (a run of 32 a warp) where
# they make LF_BM256_BLOCKS, four waves of its four blocks an SM
# (tools/ablate_linear.py, an H100 80GB HBM3 at 700 W; PERF.md §6): at
# 2e5 x 128 the 782 tiles of 256 left a second wave half empty (0.0458
# against 0.0435 ms on tiles of 128), at 10^6 x 32 diagonal they won
# (0.1420 against 0.1522).
LT_BM = (128, 64, 32)
LF_BM256_BLOCKS = 8 * LE_BLOCKS
LT_STAGES = {128: 2, 64: 4, 32: 4}
LT_WIN = 2048
# Step (f) alone a thread a (point, sub-cluster) up to this d', a warp a
# run of points above (tools/ablate_linear.py, an H100 80GB HBM3 at
# 700 W; PERF.md §6): at 10^6 points the thread route took 0.1325 against
# the warp's 0.1397 ms at d' = 32; at d' = 64 the warp 0.1420, the
# thread route 0.275 (timed against an earlier warp layout).
LF_THREAD_DP = 32


class LinearStepPlan(NamedTuple):
    """A launch of ``csrc/linear_tile.cuh``'s step (e) or step (f) alone:
    ``grid`` tiles of ``bm`` points, ``smem`` dynamic shared bytes a block
    (step (e): a ring of ``stages`` feature chunks); step (f) a thread a
    (point, sub-cluster) if ``f_thread``, else a warp a run of
    consecutive points."""
    bm: int
    stages: int
    grid: int
    smem: int
    f_thread: bool


def lt_smem(step_e: bool, step_f: bool, bm: int, stages: int,
            k: int) -> int:
    """Shared bytes of ``linear_tile`` (``lt_smem_words``): with step (e)
    the chunk ring, a packed best a point (two words) and a slot window's
    order, flags and scan totals; a Gumbel counter a point; with step (f)
    a label, a sorted place (beside step (e)) and two sums a point."""
    words = bm * (5 if step_f else 1)
    if step_e:
        words += (stages * (bm + LE_BK) * LE_FSTR + 2 * bm
                  + 2 * min(k, LT_WIN) + 1 + 32)
    return 4 * words


def linear_windows(k: int) -> Tuple[range, ...]:
    """The slot windows step (e) walks in a block, as the device code cuts
    them: [k0, k0 + min(LT_WIN, k - k0)), every slot in one."""
    return tuple(range(k0, min(k, k0 + LT_WIN))
                 for k0 in range(0, k, LT_WIN))


def _lt_check(name: str, n: int, dp: int, k: int) -> None:
    if not (1 <= n <= PANEL_MAX and 1 <= dp <= MAX_DP
            and 1 <= k <= PANEL_MAX):
        raise ValueError(f"{name}: N={n}, d'={dp}, K={k} outside "
                         f"[1, {PANEL_MAX}], [1, {MAX_DP}], [1, {PANEL_MAX}] "
                         "(ints in the kernel)")


def _lt_tile(n: int, tiles: Tuple[int, ...]) -> int:
    """The largest of ``tiles`` that makes LE_BLOCKS blocks, else the
    smallest."""
    return next((b for b in tiles if -(-n // b) >= LE_BLOCKS), tiles[-1])


@lru_cache(maxsize=256)
def linear_assign_plan(n: int, dp: int, k: int) -> LinearStepPlan:
    """``assign_linear``'s launch for (n, d', k), chosen here only: the
    launcher refuses any other. The one-read sweep's step (e) on a tile
    that fills the card (an 8192-row serving step: 256 tiles of 32
    points): slot groups that merged their keys (and a second launch to
    read the labels) lost to the small tile at the serving steps
    (PERF.md §6). Shared memory does not grow past LT_WIN slots, so any
    K runs."""
    _lt_check("assign_linear", n, dp, k)
    bm = _lt_tile(n, LT_BM)
    st = LT_STAGES[bm]
    return LinearStepPlan(bm, st, -(-n // bm),
                          lt_smem(True, False, bm, st, k), False)


@lru_cache(maxsize=256)
def linear_sub_plan(n: int, dp: int, k: int) -> LinearStepPlan:
    """``sub_assign_linear``'s launch for (n, d', k), chosen here only:
    the one-read sweep's step (f), a thread a (point, sub-cluster) up to
    d' = LF_THREAD_DP, a warp a run of consecutive points above, on the
    largest tile of LT_BM that fills the card, or on the warp route 256
    points where that makes LF_BM256_BLOCKS tiles; its shared memory is
    five words a point at any K."""
    _lt_check("sub_assign_linear", n, dp, k)
    f_thread = dp <= LF_THREAD_DP
    bm = (256 if not f_thread and -(-n // 256) >= LF_BM256_BLOCKS
          else _lt_tile(n, LT_BM))
    return LinearStepPlan(bm, 1, -(-n // bm),
                          lt_smem(False, True, bm, 1, k), f_thread)


def assign_linear_cuda(feats, w, const, logw, active, gidx, key_z,
                       slots) -> torch.Tensor:
    """One launch of ``csrc/assign_linear.cu`` on the current stream, on
    ``linear_assign_plan``'s grid."""
    n, dp = feats.shape
    k = w.shape[0]
    _check_launch("assign_linear", feats, dp, k, MAX_DP, "d'", (
        ("w", w, F32, (k, dp)), ("const", const, F32, (k,)))
        + _step_e_rows(n, k, logw, active, gidx, key_z, slots))
    plan = linear_assign_plan(n, dp, k)
    labels = torch.empty((n,), device=feats.device, dtype=torch.int32)
    fn = build.c_function("assign_linear", "assign_linear_launch",
                          "piipppppipp" + "ii" + "pp")
    launch(fn, feats.device, feats.data_ptr(), n, dp, w.data_ptr(),
           const.data_ptr(), logw.data_ptr(), active.data_ptr(),
           slots.data_ptr(), k, gidx.data_ptr(), key_z.data_ptr(), plan.bm,
           plan.smem, labels.data_ptr())
    assign_linear_cuda.launches += 1
    return labels


assign_linear_cuda.launches = 0


# csrc/sub_assign_gauss.cu: kernels a call (the label histogram, the
# placement by label, the product), points an item of the narrow layout (a
# thread a point, d <= 64) and of the tiled one (8 a warp), and the tiled
# layout's ring: factor rows a slab, columns a tile, x-slab row stride,
# stages.
SUB_LAUNCHES = 3
SUB_NARROW_D = 64
SUB_NARROW_PER, SUB_TILED_PER = 256, 64
SUB_BK, SUB_COLS, SUB_XS, SUB_STAGES = 16, 256, 64 + 4, 3


class SubPlan(NamedTuple):
    """The launches of ``csrc/sub_assign_gauss.cu`` for one slot window:
    the histogram and the placement (blocks of 1024 points; the placement
    with ``sort_smem`` shared bytes: offsets, items, counts, first slots,
    the scan's warp totals), then the product at padded width ``dp`` (4..64
    narrow, 128 or 256 tiled; 256 past d = 256 too, in ceil(d / 256) column
    panels), ``per`` points an item, on a ``grid`` of blocks (at least the
    items, one label's run each) with ``smem`` dynamic shared bytes."""
    dp: int
    per: int
    grid: int
    smem: int
    sort_smem: int


@lru_cache(maxsize=256)
def sub_plan(n: int, d: int, k: int) -> SubPlan:
    """``sub_assign_gauss``'s layout for (n, d) and a slot window of k
    slots, chosen here only: the launcher refuses any other. Up to d = 64
    a thread takes a point against the label's two factors staged whole
    (sub_tile.cuh, the one-read sweep's step (f)); above, the two factors
    are streamed in row slabs through a register-tiled product of 64
    points, whose shared bytes do not grow with d (both sub-factors side by
    side in a 256-column tile at d <= 128, one a pass above, in column
    panels of 256 past d = 256). The grid bounds the items: a label of c
    points has ceil(c / per), so at most ceil(n / per) + min(k, n)."""
    if not (1 <= n < 2 ** 31 and 1 <= d < 2 ** 31 and 1 <= k <= MAX_K):
        raise ValueError(f"sub_assign_gauss: N={n}, d={d}, K={k} outside "
                         f"[1, 2^31), [1, 2^31), [1, {MAX_K}]")
    dp = next((p for p in (4, 8, 16, 32, 64, 128) if d <= p), 256)
    if dp <= SUB_NARROW_D:
        per = SUB_NARROW_PER
        # the staged tile: two factors, two means, and four ints a slot
        smem = 4 * (2 * dp * dp + 2 * dp + 8)
    else:
        per = SUB_TILED_PER
        nx = 2 if dp == 128 else 1
        smem = 4 * SUB_STAGES * (SUB_BK * SUB_COLS + nx * SUB_BK * SUB_XS
                                 + nx * SUB_BK)
    return SubPlan(dp, per, -(-n // per) + min(k, n), smem,
                   4 * (3 * k + 2 + 32))


def sub_col(dp: int, lane: int, k: int) -> int:
    """The tiled layout's column in register ``k`` of thread (lane)
    ``lane``, as a place in a 256-float slab row (``csrc/sub_assign_gauss.cu``
    sub_col): at dp = 256 lane l holds columns l + 32 k (the parent warp
    layout's lane l); at dp = 128 the row is [F_0 row | F_1 row] and lane
    16 s + 4 j + h holds columns 4 j + 16 t + q of sub-factor s for
    t = 2 h + k // 4, q = k % 4 (a quarter of the parent's lane j's
    chain)."""
    if dp == 256:
        return lane + 32 * k
    s, j, h = lane // 16, (lane // 4) % 4, lane % 4
    return s * 128 + 4 * j + 16 * (2 * h + k // 4) + k % 4


def sub_assign_gauss_cuda(x, sub_mu, sub_chol_prec, sub_logdet_prec,
                          sublogw, labels, gidx, key_zb) -> torch.Tensor:
    """One call of ``csrc/sub_assign_gauss.cu`` on the current stream: for
    each slot window (``slot_windows``), the label histogram, the
    placement by label and the product of ``sub_plan``, each counted in
    ``launches``."""
    n, d = x.shape
    k = sub_mu.shape[0]
    _check_launch("sub_assign_gauss", x, d, k, PANEL_MAX, "d", (
        ("sub_mu", sub_mu, F32, (k, 2, d)),
        ("sub_chol_prec", sub_chol_prec, F32, (k, 2, d, d)),
        ("sub_logdet_prec", sub_logdet_prec, F32, (k, 2)))
        + _step_f_rows(n, k, sublogw, labels, gidx, key_zb))
    wins = slot_windows(k)
    plans = [sub_plan(n, d, w) for _, w in wins]
    sublabels = torch.empty((n,), device=x.device, dtype=torch.int32)
    # a window's label counts and placement cursors (the launcher zeroes
    # them), offsets, items and the point ids by label, reused window
    # after window on the stream
    w_max = max(w for _, w in wins)
    scratch = torch.empty((4 * w_max + 2 + n,), device=x.device,
                          dtype=torch.int32)
    fn = build.c_function("sub_assign_gauss", "sub_assign_gauss_launch",
                          "piipiiipppppp" + "iiiii" + "ppp")
    for (k0, w), plan in zip(wins, plans):
        launch(fn, x.device, x.data_ptr(), n, d, labels.data_ptr(), k, k0,
               w, sub_mu.data_ptr(), sub_chol_prec.data_ptr(),
               sub_logdet_prec.data_ptr(), sublogw.data_ptr(),
               gidx.data_ptr(), key_zb.data_ptr(), plan.dp, plan.per,
               plan.grid, plan.smem, plan.sort_smem, scratch.data_ptr(),
               sublabels.data_ptr())
        sub_assign_gauss_cuda.launches += SUB_LAUNCHES
    return sublabels


sub_assign_gauss_cuda.launches = 0


def sub_assign_linear_cuda(feats, subw, subconst, sublogw, labels, gidx,
                           key_zb) -> torch.Tensor:
    """One launch of ``csrc/sub_assign_linear.cu`` on the current stream,
    on ``linear_sub_plan``'s grid."""
    n, dp = feats.shape
    k = subw.shape[0]
    _check_launch("sub_assign_linear", feats, dp, k, MAX_DP, "d'", (
        ("subw", subw, F32, (k, 2, dp)), ("subconst", subconst, F32, (k, 2)))
        + _step_f_rows(n, k, sublogw, labels, gidx, key_zb))
    plan = linear_sub_plan(n, dp, k)
    sublabels = torch.empty((n,), device=feats.device, dtype=torch.int32)
    fn = build.c_function("sub_assign_linear", "sub_assign_linear_launch",
                          "piipippppp" + "iii" + "pp")
    launch(fn, feats.device, feats.data_ptr(), n, dp, labels.data_ptr(), k,
           subw.data_ptr(), subconst.data_ptr(), sublogw.data_ptr(),
           gidx.data_ptr(), key_zb.data_ptr(), plan.bm, int(plan.f_thread),
           plan.smem, sublabels.data_ptr())
    sub_assign_linear_cuda.launches += 1
    return sublabels


sub_assign_linear_cuda.launches = 0
