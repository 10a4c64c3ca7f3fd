"""One-read fused Gibbs sweep for the full-covariance Gaussian family.

Port of ``repro.kernels.sweep.sweep_gauss``: steps (e) + (f) of the
restricted sampler and the sub-cluster statistic fold in one pass over x.

    x (N, d); mu (K, d); chol_prec (K, d, d); logdet_prec, logw (K,);
    active (K,) int32; sub_mu (K, 2, d); sub_chol_prec (K, 2, d, d);
    sub_logdet_prec, sublogw (K, 2); valid (N,) float32; gidx (N,) int64
    global point indices; key_z, key_zb (2,) int64 key words; slots (K,)
    int32 dense slot ids (the Gumbel counters of step e)
    -> labels, sublabels (N,) int32; n2 (nsb, K, 2); sx2 (nsb, K, 2, d);
       sxx2 (nsb, K, 2, d, d) per-STATS_BLOCK stat partials.

Two versions of one function:

- ``sweep_gauss_cuda``: the hand-written kernel ``csrc/sweep_gauss.cu``
  for CUDA tensors (one launch per call, counted in
  ``sweep_gauss_cuda.launches``);
- ``sweep_gauss_plain``: the same math in plain PyTorch, chunked per
  STATS_BLOCK so the (N, K, d) whitened differences never exist whole.

``kernels.ops.sweep_gauss`` picks between them by the tensor's device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, prng
from repro_torch.kernels.suffstats import (CHUNK_FLOATS, STATS_BLOCK,
                                           _check_cuda, block_partials,
                                           n_blocks)

# Inactive-cluster mask of step (e), as in the reference kernels.
NEG_INF = -1e30
LOG_2PI = 1.8378770664093453
# The kernel's register arrays hold one d-vector per point: d <= 64.
MAX_D = 64
MAX_K = 2048

SweepOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor]


def assign_plain(x, mu, chol_prec, logdet_prec, logw, active, gidx, key_z,
                 slots) -> torch.Tensor:
    """Step (e) for all of ``x`` at once: (N,) first-argmax labels."""
    d = x.shape[1]
    diff = x[:, None, :] - mu[None, :, :]                  # (m, K, d)
    y = torch.einsum("mkd,kde->mke", diff, chol_prec)
    maha = (y * y).sum(dim=-1)
    t = 0.5 * (logdet_prec[None, :] - maha) - 0.5 * d * LOG_2PI
    t = t + logw[None, :]
    t = torch.where(active[None, :] != 0, t, NEG_INF)
    t = t + prng.gumbel(key_z, gidx[:, None], slots.to(torch.int64)[None, :])
    return torch.argmax(t, dim=1).to(torch.int32)


def sub_assign_plain(x, sub_mu, sub_chol_prec, sub_logdet_prec, sublogw,
                     labels, gidx, key_zb) -> torch.Tensor:
    """Step (f): (N,) sub-labels under each point's own cluster."""
    d = x.shape[1]
    lab = labels.to(torch.int64)
    diff = x[:, None, :] - sub_mu[lab]                     # (m, 2, d)
    y = torch.einsum("msd,msde->mse", diff, sub_chol_prec[lab])
    maha = (y * y).sum(dim=-1)
    t = 0.5 * (sub_logdet_prec[lab] - maha) - 0.5 * d * LOG_2PI
    t = t + sublogw[lab]
    cid = torch.arange(2, device=x.device, dtype=torch.int64)
    t = t + prng.gumbel(key_zb, gidx[:, None], cid[None, :])
    return torch.argmax(t, dim=1).to(torch.int32)


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
    gap_e = (t[:, 0] - t[:, 1]).abs() / t.abs().max(1).values.clamp(min=1)
    gap_f = (t2[:, 0] - t2[:, 1]).abs() / t2.abs().max(1).values.clamp(
        min=1)
    tie = torch.where(labels_a[bad] != labels_b[bad], gap_e <= rtol,
                      gap_f <= rtol)
    return int(bad.numel()), int((~tie).sum())


def sweep_gauss_cuda(x, mu, chol_prec, logdet_prec, logw, active, sub_mu,
                     sub_chol_prec, sub_logdet_prec, sublogw, valid, gidx,
                     key_z, key_zb, slots) -> SweepOut:
    """One launch of ``csrc/sweep_gauss.cu`` on the current stream."""
    n, d = x.shape
    k = mu.shape[0]
    if x.device.type != "cuda":
        raise ValueError("sweep_gauss_cuda takes CUDA tensors; the plain "
                         "version serves the CPU")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"sweep_gauss: d={d} outside [1, {MAX_D}] (the "
                         "kernel keeps a d-vector per point in registers)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"sweep_gauss: K={k} outside [1, {MAX_K}]")
    if n == 0:
        raise ValueError("sweep_gauss: no points")
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
        _check_cuda(name, t, dtype, shape, dev)
    nsb = n_blocks(n)
    labels = torch.empty((n,), device=dev, dtype=i32)
    sublabels = torch.empty((n,), device=dev, dtype=i32)
    n2 = torch.empty((nsb, k, 2), device=dev, dtype=f32)
    sx2 = torch.empty((nsb, k, 2, d), device=dev, dtype=f32)
    sxx2 = torch.empty((nsb, k, 2, d, d), device=dev, dtype=f32)
    fn = build.c_function("sweep_gauss", "sweep_gauss_launch",
                          "piippppppi" + "p" * 14)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn(x.data_ptr(), n, d, mu.data_ptr(), chol_prec.data_ptr(),
           logdet_prec.data_ptr(), logw.data_ptr(), active.data_ptr(),
           slots.data_ptr(), k, sub_mu.data_ptr(), sub_chol_prec.data_ptr(),
           sub_logdet_prec.data_ptr(), sublogw.data_ptr(), valid.data_ptr(),
           gidx.data_ptr(), key_z.data_ptr(), key_zb.data_ptr(),
           labels.data_ptr(), sublabels.data_ptr(), n2.data_ptr(),
           sx2.data_ptr(), sxx2.data_ptr(), stream)
    sweep_gauss_cuda.launches += 1
    return labels, sublabels, n2, sx2, sxx2


sweep_gauss_cuda.launches = 0
