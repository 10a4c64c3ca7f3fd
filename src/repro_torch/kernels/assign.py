"""Step (e) alone: labels of a batch of points under a model.

Port of ``repro.kernels.assign.assign_gauss`` and ``assign_linear`` (the
running first-max over K tiles, without step (f) or a stat fold), which
``DPMMEngine.sample`` runs through ``ComponentFamily.assign``::

    assign_gauss:  x (N, d) f32; mu (K, d); chol_prec (K, d, d);
                   logdet_prec, logw (K,); active (K,) int32; gidx (N,)
                   int64 Gumbel counters; key_z (2,) int64 key words;
                   slots (K,) int32 dense slot ids  -> labels (N,) int32
    assign_linear: feats (N, d') f32; w (K, d'); const, logw (K,); the
                   rest as above                    -> labels (N,) int32

Two versions of each function:

- ``assign_gauss_cuda`` / ``assign_linear_cuda``: the hand-written kernels
  ``csrc/assign_gauss.cu`` / ``csrc/assign_linear.cu``, whose device code
  is the one-read sweeps' step (e) (``csrc/assign_tile.cuh``); one launch
  per call, counted in the wrapper's ``launches``;
- ``assign_gauss_plain`` / ``assign_linear_plain``: step (e) of the sweeps'
  plain versions (``kernels/sweep.py``), the same math in plain PyTorch.

``kernels.ops`` picks between them by the tensor's device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, prng
from repro_torch.kernels.suffstats import MAX_DP, _check_cuda
from repro_torch.kernels.sweep import (LOG_2PI, MAX_D, NEG_INF,
                                       assign_linear_plain)
from repro_torch.kernels.sweep import assign_plain as assign_gauss_plain


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


def _check_step_e(name, x, width, k, logw, active, gidx, key_z, slots,
                  max_width, what):
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
    dev = x.device
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    for arg, t, dtype, shape in (
            ("x", x, f32, (n, width)), ("logw", logw, f32, (k,)),
            ("active", active, i32, (k,)), ("gidx", gidx, i64, (n,)),
            ("key_z", key_z, i64, (2,)), ("slots", slots, i32, (k,))):
        _check_cuda(arg, t, dtype, shape, dev)


def assign_gauss_cuda(x, mu, chol_prec, logdet_prec, logw, active, gidx,
                      key_z, slots) -> torch.Tensor:
    """One launch of ``csrc/assign_gauss.cu`` on the current stream."""
    n, d = x.shape
    k = mu.shape[0]
    _check_step_e("assign_gauss", x, d, k, logw, active, gidx, key_z, slots,
                  MAX_D, "d")
    for arg, t, shape in (("mu", mu, (k, d)),
                          ("chol_prec", chol_prec, (k, d, d)),
                          ("logdet_prec", logdet_prec, (k,))):
        _check_cuda(arg, t, torch.float32, shape, x.device)
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
    _check_step_e("assign_linear", feats, dp, k, logw, active, gidx, key_z,
                  slots, MAX_DP, "d'")
    _check_cuda("w", w, torch.float32, (k, dp), feats.device)
    _check_cuda("const", const, torch.float32, (k,), feats.device)
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
