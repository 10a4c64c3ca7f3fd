"""One-read fused Gibbs sweeps: steps (e) + (f) of the restricted sampler
and the sub-cluster statistic fold in one pass over the points.

``sweep_gauss`` (full-covariance Gaussian) is the port of
``repro.kernels.sweep.sweep_gauss``:

    x (N, d); mu (K, d); chol_prec (K, d, d); logdet_prec, logw (K,);
    active (K,) int32; sub_mu (K, 2, d); sub_chol_prec (K, 2, d, d);
    sub_logdet_prec, sublogw (K, 2); valid (N,) float32; gidx (N,) int64
    global point indices; key_z, key_zb (2,) int64 key words; slots (K,)
    int32 dense slot ids (the Gumbel counters of step e)
    -> labels, sublabels (N,) int32; n2 (nsb, K, 2); sx2 (nsb, K, 2, d);
       sxx2 (nsb, K, 2, d, d) per-STATS_BLOCK stat partials.

Two versions of one function:

- ``sweep_gauss_cuda``: the hand-written kernels ``csrc/sweep_gauss.cu``
  for CUDA tensors (``launches_per_call(d)`` launches a call, each counted
  in ``sweep_gauss_cuda.launches``);
- ``sweep_gauss_plain``: the same math in plain PyTorch, chunked per
  STATS_BLOCK so the (N, K, d) whitened differences never exist whole.

``sweep_linear`` (multinomial, poisson, diag_gaussian) is the port of
``repro.kernels.sweep.sweep_linear``: each family packs its likelihood as
``feats @ w.T + const`` (``core/<family>.py``, ``sweep_pack``)::

    feats (N, d') f32; w (K, d'); const, logw (K,); active (K,) int32;
    subw (K, 2, d'); subconst, sublogw (K, 2); valid, gidx, key_z,
    key_zb, slots as above
    -> labels, sublabels (N,) int32; n2 (nsb, K, 2); sf2 (nsb, K, 2, d')
       per-STATS_BLOCK partials of n and sum feats.

with ``sweep_linear_cuda`` (``csrc/sweep_linear.cu``) and
``sweep_linear_plain`` beside it. ``kernels.ops`` picks between the two
versions of each by the tensor's device.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build, prng
from repro_torch.kernels.launch import check_cuda, launch
from repro_torch.kernels.suffstats import (CHUNK_FLOATS, INT_MAX, MAX_DP,
                                           STATS_BLOCK, block_moments,
                                           block_partials, n_blocks)

# Inactive-cluster mask of step (e), as in the reference kernels.
NEG_INF = -1e30
LOG_2PI = 1.8378770664093453
# The kernel keeps a point's d-vectors in one thread's registers up to
# d = 64 and spreads them over four lanes up to 128, the reference kernel's
# own ceiling. Wider d declines to the three-pass ``sweep_ref``
# (``core/family.py``), whose kernels go on to ``suffstats.MAX_D``.
MAX_D = 128
MAX_K = 2048
# Step (e) of ``csrc/sweep_gauss.cu`` as a register-tiled product
# (``sweep_assign_tiled``, a launch of its own) above d = 16: points a block,
# threads, ring stages; ``sweep_plan`` holds its layout. The tiled product
# pads d to at least 32, the in-block step (e) to 4, 8 or 16: at 10^6 points
# and 17 live slots the sweep takes 0.69 / 1.06 ms in-block against 1.94 /
# 2.08 tiled at d = 8 / 16, while at d = 32 the in-block step (e) alone
# (assign_gauss, the same device code) takes 3.14 against the tiled 1.69
# (PERF.md §6: tools/time_kernels.py --kernels sweep on an H100 80GB HBM3
# at 700 W).
TE_MIN_D = 17
TE_BM = 128
TE_THREADS = 256
TE_STAGES = 3

SweepOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]
LinearOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pick_cluster(ll, logw, active, gidx, key_z, slots) -> torch.Tensor:
    """Step (e) from (m, K) log-likelihoods: first argmax of
    ll + log w (masked to -1e30 on inactive slots) + Gumbel noise."""
    t = ll + logw[None, :]
    t = torch.where(active[None, :] != 0, t, NEG_INF)
    t = t + prng.gumbel(key_z, gidx[:, None], slots.to(torch.int64)[None, :])
    return torch.argmax(t, dim=1).to(torch.int32)


def pick_subcluster(ll2, sublogw_own, gidx, key_zb) -> torch.Tensor:
    """Step (f) from (m, 2) own-cluster log-likelihoods."""
    t = ll2 + sublogw_own
    cid = torch.arange(2, device=ll2.device, dtype=torch.int64)
    t = t + prng.gumbel(key_zb, gidx[:, None], cid[None, :])
    return torch.argmax(t, dim=1).to(torch.int32)


def assign_plain(x, mu, chol_prec, logdet_prec, logw, active, gidx, key_z,
                 slots) -> torch.Tensor:
    """Step (e) for all of ``x`` at once: (N,) first-argmax labels."""
    d = x.shape[1]
    diff = x[:, None, :] - mu[None, :, :]                  # (m, K, d)
    y = torch.einsum("mkd,kde->mke", diff, chol_prec)
    maha = (y * y).sum(dim=-1)
    t = 0.5 * (logdet_prec[None, :] - maha) - 0.5 * d * LOG_2PI
    return pick_cluster(t, logw, active, gidx, key_z, slots)


def sub_assign_plain(x, sub_mu, sub_chol_prec, sub_logdet_prec, sublogw,
                     labels, gidx, key_zb) -> torch.Tensor:
    """Step (f): (N,) sub-labels under each point's own cluster, in chunks
    of points whose gathered (m, 2, d, d) factors hold at most
    CHUNK_FLOATS (a point's two factors are 512 KiB at d = 256)."""
    n, d = x.shape
    out = torch.empty((n,), device=x.device, dtype=torch.int32)
    step = max(1, CHUNK_FLOATS // (2 * d * d + 4 * d))
    for a in range(0, n, step):
        sl = slice(a, a + step)
        lab = labels[sl].to(torch.int64)
        diff = x[sl, None, :] - sub_mu[lab]                # (m, 2, d)
        y = torch.einsum("msd,msde->mse", diff, sub_chol_prec[lab])
        maha = (y * y).sum(dim=-1)
        t = 0.5 * (sub_logdet_prec[lab] - maha) - 0.5 * d * LOG_2PI
        out[sl] = pick_subcluster(t, sublogw[lab], gidx[sl], key_zb)
    return out


def sweep_gauss_plain(x, mu, chol_prec, logdet_prec, logw, active, sub_mu,
                      sub_chol_prec, sub_logdet_prec, sublogw, valid, gidx,
                      key_z, key_zb, slots) -> SweepOut:
    n, d = x.shape
    k = mu.shape[0]
    nsb = n_blocks(n)
    labels = torch.empty((n,), device=x.device, dtype=torch.int32)
    sublabels = torch.empty_like(labels)
    n2 = x.new_empty((nsb, k, 2))
    sx2 = x.new_empty((nsb, k, 2, d))
    sxx2 = x.new_empty((nsb, k, 2, d, d))
    per_point = max(2 * k * d, 4 * d * d, 2 * k + d + 2 * d * d)
    step = max(1, CHUNK_FLOATS // (STATS_BLOCK * per_point))
    for b0 in range(0, nsb, step):
        b1 = min(nsb, b0 + step)
        sl = slice(b0 * STATS_BLOCK, b1 * STATS_BLOCK)
        xb, gb = x[sl], gidx[sl]
        lab = assign_plain(xb, mu, chol_prec, logdet_prec, logw, active, gb,
                           key_z, slots)
        sub = sub_assign_plain(xb, sub_mu, sub_chol_prec, sub_logdet_prec,
                               sublogw, lab, gb, key_zb)
        labels[sl], sublabels[sl] = lab, sub
        n2[b0:b1], sx2[b0:b1], sxx2[b0:b1] = block_partials(
            xb, lab, sub, valid[sl], k)
    return labels, sublabels, n2, sx2, sxx2


def label_mismatches(args, labels_a, sublabels_a, labels_b, sublabels_b,
                     rtol: float) -> Tuple[int, int]:
    """Compare two sweeps' labels over the same ``args`` (the sweep's
    arguments, in order): returns (points that differ, those of them that
    are not near-ties). A label mismatch is a near-tie when the step-(e)
    logits of the two labels, recomputed in float64, are within ``rtol`` of
    each other (relative to the larger, at least 1); a sub-label mismatch
    when the two step-(f) logits under cluster ``labels_b`` are."""
    x, mu, f, ld, lw, act, smu, sf, sld, slw, _, gidx, kz, kzb, slots = args
    bad = torch.nonzero((labels_a != labels_b)
                        | (sublabels_a != sublabels_b)).flatten()
    if bad.numel() == 0:
        return 0, 0
    xb, gb = x[bad].double(), gidx[bad]
    d = x.shape[1]

    def logits(mu_, f_, ld_, lw_, key, cid):
        y = torch.einsum("mkd,mkde->mke", xb[:, None, :] - mu_.double(),
                         f_.double())
        t = 0.5 * (ld_.double() - (y * y).sum(-1)) - 0.5 * d * LOG_2PI
        return t + lw_.double() + prng.gumbel(key, gb[:, None],
                                              cid).double()

    both = torch.stack([labels_a[bad], labels_b[bad]], 1).long()
    t = logits(mu[both], f[both], ld[both], lw[both], kz,
               slots.long()[both])
    t = torch.where(act[both] != 0, t, NEG_INF)
    own = labels_b[bad].long()
    t2 = logits(smu[own], sf[own], sld[own], slw[own], kzb,
                torch.arange(2, device=x.device)[None, :])
    return _count_ties(t, t2, labels_a[bad] != labels_b[bad], rtol)


def _count_ties(t, t2, label_differs, rtol: float) -> Tuple[int, int]:
    """(mismatches, those that are not near-ties) from the float64 logit
    pairs of step (e) ``t`` and step (f) ``t2`` of each mismatch."""
    gap_e = (t[:, 0] - t[:, 1]).abs() / t.abs().max(1).values.clamp(min=1)
    gap_f = (t2[:, 0] - t2[:, 1]).abs() / t2.abs().max(1).values.clamp(
        min=1)
    tie = torch.where(label_differs, gap_e <= rtol, gap_f <= rtol)
    return int(t.shape[0]), int((~tie).sum())


def launches_per_call(d: int) -> int:
    """Kernels one ``sweep_gauss_cuda`` call launches: the tiled step (e)
    and the (f) + fold kernel above d = 16, one fused kernel at and below
    it."""
    return 2 if d >= TE_MIN_D else 1


class SweepPlan(NamedTuple):
    """The launches of ``csrc/sweep_gauss.cu``: step (e) in the (f) + fold
    block (``dp`` 0) or tiled, with padded width ``dp`` (32, 64 or 128),
    ``grid_e`` blocks of TE_BM points and ``smem_e`` shared bytes; then
    ``nsb`` (f) + fold blocks, one a STATS_BLOCK."""
    dp: int
    grid_e: int
    smem_e: int
    nsb: int


def te_layout(dp: int) -> Tuple[int, int, int, int]:
    """(slots a 128-column tile, slot stride of a slab row, rows a slab,
    floats a ring stage) of ``sweep_assign_tiled<dp>`` (``TiledE``)."""
    sp = 128 // dp
    fs = 48 if dp == 32 else dp
    bk = 16 if dp == 128 else 32
    stage = -(-(bk * sp * fs + sp * (bk + 1)) // 4) * 4
    return sp, fs, bk, stage


@lru_cache(maxsize=256)
def sweep_plan(n: int, d: int, k: int) -> SweepPlan:
    """The sweep's launches for (n, d, k), chosen here only: the launcher
    refuses a route or shared size other than this. Above d = 16 step (e)
    runs tiled (d rounded up to 32, 64 or 128; its shared memory holds the
    tile's x, the ring, the per-point partials, the scan's 32 ints and two
    K-int slot lists); at and below it, in the (f) + fold block. N runs in
    an int in the kernels."""
    if not (1 <= n <= INT_MAX and 1 <= d <= MAX_D and 1 <= k <= MAX_K):
        raise ValueError(f"sweep_gauss: N={n}, d={d}, K={k} outside "
                         f"[1, 2^31), [1, {MAX_D}], [1, {MAX_K}]")
    if d < TE_MIN_D:
        return SweepPlan(0, 0, 0, n_blocks(n))
    dp = 32 if d <= 32 else 64 if d <= 64 else 128
    sp, _, _, stage = te_layout(dp)
    smem = 4 * (dp * (TE_BM + 4) + TE_STAGES * stage + 2 * (sp + 2) * TE_BM
                + 32 + 2 * k)
    return SweepPlan(dp, -(-n // TE_BM), smem, n_blocks(n))


def sweep_gauss_cuda(x, mu, chol_prec, logdet_prec, logw, active, sub_mu,
                     sub_chol_prec, sub_logdet_prec, sublogw, valid, gidx,
                     key_z, key_zb, slots) -> SweepOut:
    """One call of ``csrc/sweep_gauss.cu`` on the current stream: above
    d = 16 the tiled step (e) launch, then the (f) + fold launch."""
    n, d = x.shape
    k = mu.shape[0]
    if x.device.type != "cuda":
        raise ValueError("sweep_gauss_cuda takes CUDA tensors; the plain "
                         "version serves the CPU")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"sweep_gauss: d={d} outside [1, {MAX_D}] "
                         "(ROADMAP.md §3)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sweep_gauss: K={k} outside [1, {MAX_K}]")
    if n == 0:
        raise ValueError("sweep_gauss: no points")
    plan = sweep_plan(n, d, k)
    dev = x.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    for name, t, dtype, shape in (
            ("x", x, f32, (n, d)), ("mu", mu, f32, (k, d)),
            ("chol_prec", chol_prec, f32, (k, d, d)),
            ("logdet_prec", logdet_prec, f32, (k,)), ("logw", logw, f32, (k,)),
            ("active", active, i32, (k,)), ("sub_mu", sub_mu, f32, (k, 2, d)),
            ("sub_chol_prec", sub_chol_prec, f32, (k, 2, d, d)),
            ("sub_logdet_prec", sub_logdet_prec, f32, (k, 2)),
            ("sublogw", sublogw, f32, (k, 2)), ("valid", valid, f32, (n,)),
            ("gidx", gidx, i64, (n,)), ("key_z", key_z, i64, (2,)),
            ("key_zb", key_zb, i64, (2,)), ("slots", slots, i32, (k,))):
        check_cuda(name, t, dtype, shape, dev)
    nsb = plan.nsb
    labels = torch.empty((n,), device=dev, dtype=i32)
    sublabels = torch.empty((n,), device=dev, dtype=i32)
    n2 = torch.empty((nsb, k, 2), device=dev, dtype=f32)
    sx2 = torch.empty((nsb, k, 2, d), device=dev, dtype=f32)
    sxx2 = torch.empty((nsb, k, 2, d, d), device=dev, dtype=f32)
    fn = build.c_function("sweep_gauss", "sweep_gauss_launch",
                          "piippppppi" + "p" * 8 + "ii" + "p" * 6)
    launch(fn, dev, x.data_ptr(), n, d, mu.data_ptr(), chol_prec.data_ptr(),
           logdet_prec.data_ptr(), logw.data_ptr(), active.data_ptr(),
           slots.data_ptr(), k, sub_mu.data_ptr(), sub_chol_prec.data_ptr(),
           sub_logdet_prec.data_ptr(), sublogw.data_ptr(), valid.data_ptr(),
           gidx.data_ptr(), key_z.data_ptr(), key_zb.data_ptr(), plan.dp,
           plan.smem_e, labels.data_ptr(), sublabels.data_ptr(), n2.data_ptr(),
           sx2.data_ptr(), sxx2.data_ptr())
    sweep_gauss_cuda.launches += launches_per_call(d)
    return labels, sublabels, n2, sx2, sxx2


sweep_gauss_cuda.launches = 0


# ---------------------------------------------------------------------------
# Linear-likelihood families: loglik = feats @ w.T + const
# ---------------------------------------------------------------------------
def assign_linear_plain(feats, w, const, logw, active, gidx, key_z,
                        slots) -> torch.Tensor:
    """Step (e): (N,) first-argmax labels, in the reference's op order."""
    return pick_cluster(feats @ w.T + const[None, :], logw, active, gidx,
                        key_z, slots)


def sub_assign_linear_plain(feats, subw, subconst, sublogw, labels, gidx,
                            key_zb) -> torch.Tensor:
    """Step (f): (N,) sub-labels under each point's own cluster."""
    lab = labels.to(torch.int64)
    ll = torch.stack([(feats * subw[lab, s]).sum(dim=-1) for s in (0, 1)],
                     dim=1) + subconst[lab]
    return pick_subcluster(ll, sublogw[lab], gidx, key_zb)


def sweep_linear_plain(feats, w, const, logw, active, subw, subconst,
                       sublogw, valid, gidx, key_z, key_zb,
                       slots) -> LinearOut:
    n, dp = feats.shape
    k = w.shape[0]
    nsb = n_blocks(n)
    labels = torch.empty((n,), device=feats.device, dtype=torch.int32)
    sublabels = torch.empty_like(labels)
    n2 = feats.new_empty((nsb, k, 2))
    sf2 = feats.new_empty((nsb, k, 2, dp))
    per_point = 3 * dp + 4 * k
    step = max(1, CHUNK_FLOATS // (STATS_BLOCK * per_point))
    for b0 in range(0, nsb, step):
        b1 = min(nsb, b0 + step)
        sl = slice(b0 * STATS_BLOCK, b1 * STATS_BLOCK)
        fb, gb = feats[sl], gidx[sl]
        lab = assign_linear_plain(fb, w, const, logw, active, gb, key_z,
                                  slots)
        sub = sub_assign_linear_plain(fb, subw, subconst, sublogw, lab, gb,
                                      key_zb)
        labels[sl], sublabels[sl] = lab, sub
        n2[b0:b1], sf2[b0:b1] = block_moments(fb, lab, sub, valid[sl], k)
    return labels, sublabels, n2, sf2


def label_mismatches_linear(args, labels_a, sublabels_a, labels_b,
                            sublabels_b, rtol: float) -> Tuple[int, int]:
    """``label_mismatches`` for ``sweep_linear``'s arguments: the two
    step-(e) logits, or the two step-(f) logits under cluster
    ``labels_b``, re-scored in float64."""
    (feats, w, const, logw, act, subw, subconst, sublogw, _, gidx, kz, kzb,
     slots) = args
    bad = torch.nonzero((labels_a != labels_b)
                        | (sublabels_a != sublabels_b)).flatten()
    if bad.numel() == 0:
        return 0, 0
    fb, gb = feats[bad].double(), gidx[bad]
    both = torch.stack([labels_a[bad], labels_b[bad]], 1).long()
    t = (torch.einsum("md,mkd->mk", fb, w[both].double())
         + const[both].double() + logw[both].double())
    t = torch.where(act[both] != 0, t, NEG_INF)
    t = t + prng.gumbel(kz, gb[:, None], slots.long()[both]).double()
    own = labels_b[bad].long()
    t2 = (torch.einsum("md,msd->ms", fb, subw[own].double())
          + subconst[own].double() + sublogw[own].double())
    t2 = t2 + prng.gumbel(kzb, gb[:, None],
                          torch.arange(2, device=feats.device)[None, :]
                          ).double()
    return _count_ties(t, t2, labels_a[bad] != labels_b[bad], rtol)


def sweep_linear_cuda(feats, w, const, logw, active, subw, subconst,
                      sublogw, valid, gidx, key_z, key_zb,
                      slots) -> LinearOut:
    """One launch of ``csrc/sweep_linear.cu`` on the current stream."""
    n, dp = feats.shape
    k = w.shape[0]
    if feats.device.type != "cuda":
        raise ValueError("sweep_linear_cuda takes CUDA tensors; the plain "
                         "version serves the CPU")
    if not 1 <= dp <= MAX_DP:
        raise ValueError(f"sweep_linear: d'={dp} outside [1, {MAX_DP}]")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sweep_linear: K={k} outside [1, {MAX_K}] (the "
                         "segment offsets live in shared memory)")
    if n == 0:
        raise ValueError("sweep_linear: no points")
    dev = feats.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    for name, t, dtype, shape in (
            ("feats", feats, f32, (n, dp)), ("w", w, f32, (k, dp)),
            ("const", const, f32, (k,)), ("logw", logw, f32, (k,)),
            ("active", active, i32, (k,)), ("subw", subw, f32, (k, 2, dp)),
            ("subconst", subconst, f32, (k, 2)),
            ("sublogw", sublogw, f32, (k, 2)), ("valid", valid, f32, (n,)),
            ("gidx", gidx, i64, (n,)), ("key_z", key_z, i64, (2,)),
            ("key_zb", key_zb, i64, (2,)), ("slots", slots, i32, (k,))):
        check_cuda(name, t, dtype, shape, dev)
    nsb = n_blocks(n)
    labels = torch.empty((n,), device=dev, dtype=i32)
    sublabels = torch.empty((n,), device=dev, dtype=i32)
    n2 = torch.empty((nsb, k, 2), device=dev, dtype=f32)
    sf2 = torch.empty((nsb, k, 2, dp), device=dev, dtype=f32)
    fn = build.c_function("sweep_linear", "sweep_linear_launch",
                          "piipppppi" + "p" * 12)
    launch(fn, dev, feats.data_ptr(), n, dp, w.data_ptr(), const.data_ptr(),
           logw.data_ptr(), active.data_ptr(), slots.data_ptr(), k,
           subw.data_ptr(), subconst.data_ptr(), sublogw.data_ptr(),
           valid.data_ptr(), gidx.data_ptr(), key_z.data_ptr(),
           key_zb.data_ptr(), labels.data_ptr(), sublabels.data_ptr(),
           n2.data_ptr(), sf2.data_ptr())
    sweep_linear_cuda.launches += 1
    return labels, sublabels, n2, sf2


sweep_linear_cuda.launches = 0
