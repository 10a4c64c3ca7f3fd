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
  step (e) and step (f) (``csrc/assign_tile.cuh``); one launch per call,
  counted in the wrapper's ``launches``;
- ``*_plain``: steps (e) and (f) of the sweeps' plain versions
  (``kernels/sweep.py``), the same math in plain PyTorch.

``kernels.ops`` picks between them by the tensor's device. The Gaussian
kernels take d up to ``MAX_D`` = 256, past the one-read sweep's 128: a
factor is staged in 64-column panels for step (e), and read from L2 by one
warp per point for step (f).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, prng
from repro_torch.kernels.suffstats import MAX_D, MAX_DP, _check_cuda
from repro_torch.kernels.sweep import (LOG_2PI, NEG_INF, assign_linear_plain,
                                       sub_assign_linear_plain)
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
        raise ValueError(f"{name}: {what}={width} outside [1, {max_width}]"
                         " (ROADMAP.md §3)")
    if k < 1 or n == 0:
        raise ValueError(f"{name}: needs K >= 1 slots and points, got "
                         f"K={k}, N={n}")
    for arg, t, dtype, shape in (("x", x, F32, (n, width)),) + tensors:
        _check_cuda(arg, t, dtype, shape, x.device)


def _step_e_rows(n, k, logw, active, gidx, key_z, slots):
    return (("logw", logw, F32, (k,)), ("active", active, I32, (k,)),
            ("gidx", gidx, I64, (n,)), ("key_z", key_z, I64, (2,)),
            ("slots", slots, I32, (k,)))


def _step_f_rows(n, k, sublogw, labels, gidx, key_zb):
    return (("sublogw", sublogw, F32, (k, 2)), ("labels", labels, I32, (n,)),
            ("gidx", gidx, I64, (n,)), ("key_zb", key_zb, I64, (2,)))


def assign_gauss_cuda(x, mu, chol_prec, logdet_prec, logw, active, gidx,
                      key_z, slots) -> torch.Tensor:
    """One launch of ``csrc/assign_gauss.cu`` on the current stream."""
    n, d = x.shape
    k = mu.shape[0]
    _check_launch("assign_gauss", x, d, k, MAX_D, "d", (
        ("mu", mu, F32, (k, d)), ("chol_prec", chol_prec, F32, (k, d, d)),
        ("logdet_prec", logdet_prec, F32, (k,)))
        + _step_e_rows(n, k, logw, active, gidx, key_z, slots))
    labels = torch.empty((n,), device=x.device, dtype=torch.int32)
    fn = build.c_function("assign_gauss", "assign_gauss_launch",
                          "piippppppipppp")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(x.data_ptr(), n, d, mu.data_ptr(), chol_prec.data_ptr(),
           logdet_prec.data_ptr(), logw.data_ptr(), active.data_ptr(),
           slots.data_ptr(), k, gidx.data_ptr(), key_z.data_ptr(),
           labels.data_ptr(), stream)
    assign_gauss_cuda.launches += 1
    return labels


assign_gauss_cuda.launches = 0


def assign_linear_cuda(feats, w, const, logw, active, gidx, key_z,
                       slots) -> torch.Tensor:
    """One launch of ``csrc/assign_linear.cu`` on the current stream."""
    n, dp = feats.shape
    k = w.shape[0]
    _check_launch("assign_linear", feats, dp, k, MAX_DP, "d'", (
        ("w", w, F32, (k, dp)), ("const", const, F32, (k,)))
        + _step_e_rows(n, k, logw, active, gidx, key_z, slots))
    labels = torch.empty((n,), device=feats.device, dtype=torch.int32)
    fn = build.c_function("assign_linear", "assign_linear_launch",
                          "piipppppipppp")
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        fn(feats.data_ptr(), n, dp, w.data_ptr(), const.data_ptr(),
           logw.data_ptr(), active.data_ptr(), slots.data_ptr(), k,
           gidx.data_ptr(), key_z.data_ptr(), labels.data_ptr(), stream)
    assign_linear_cuda.launches += 1
    return labels


assign_linear_cuda.launches = 0


def sub_assign_gauss_cuda(x, sub_mu, sub_chol_prec, sub_logdet_prec,
                          sublogw, labels, gidx, key_zb) -> torch.Tensor:
    """One launch of ``csrc/sub_assign_gauss.cu`` on the current stream."""
    n, d = x.shape
    k = sub_mu.shape[0]
    _check_launch("sub_assign_gauss", x, d, k, MAX_D, "d", (
        ("sub_mu", sub_mu, F32, (k, 2, d)),
        ("sub_chol_prec", sub_chol_prec, F32, (k, 2, d, d)),
        ("sub_logdet_prec", sub_logdet_prec, F32, (k, 2)))
        + _step_f_rows(n, k, sublogw, labels, gidx, key_zb))
    sublabels = torch.empty((n,), device=x.device, dtype=torch.int32)
    fn = build.c_function("sub_assign_gauss", "sub_assign_gauss_launch",
                          "piipipppppppp")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(x.data_ptr(), n, d, labels.data_ptr(), k, sub_mu.data_ptr(),
           sub_chol_prec.data_ptr(), sub_logdet_prec.data_ptr(),
           sublogw.data_ptr(), gidx.data_ptr(), key_zb.data_ptr(),
           sublabels.data_ptr(), stream)
    sub_assign_gauss_cuda.launches += 1
    return sublabels


sub_assign_gauss_cuda.launches = 0


def sub_assign_linear_cuda(feats, subw, subconst, sublogw, labels, gidx,
                           key_zb) -> torch.Tensor:
    """One launch of ``csrc/sub_assign_linear.cu`` on the current stream."""
    n, dp = feats.shape
    k = subw.shape[0]
    _check_launch("sub_assign_linear", feats, dp, k, MAX_DP, "d'", (
        ("subw", subw, F32, (k, 2, dp)), ("subconst", subconst, F32, (k, 2)))
        + _step_f_rows(n, k, sublogw, labels, gidx, key_zb))
    sublabels = torch.empty((n,), device=feats.device, dtype=torch.int32)
    fn = build.c_function("sub_assign_linear", "sub_assign_linear_launch",
                          "piipippppppp")
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        fn(feats.data_ptr(), n, dp, labels.data_ptr(), k, subw.data_ptr(),
           subconst.data_ptr(), sublogw.data_ptr(), gidx.data_ptr(),
           key_zb.data_ptr(), sublabels.data_ptr(), stream)
    sub_assign_linear_cuda.launches += 1
    return sublabels


sub_assign_linear_cuda.launches = 0
