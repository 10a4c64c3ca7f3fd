"""Dense Gaussian log-likelihoods of a batch of points under every cluster.

Port of ``repro.kernels.loglik.loglik`` (the serving query's likelihood):

    x (N, d) f32; mu (K, d); chol_prec (K, d, d) F with Sigma^-1 = F F^T;
    logdet_prec (K,)
    -> (N, K) f32: 0.5 (logdet_k - |F_k^T (x_i - mu_k)|^2) - 0.5 d log 2 pi

Two versions of one function:

- ``loglik_cuda``: the hand-written kernel ``csrc/loglik_gauss.cu`` (the
  register tile of the one-read sweep's step (e), ``csrc/te_tile.cuh``,
  up to d = 128 on the grid ``assign.gauss_plan`` chooses, the narrow
  in-block layout at and below ``assign.GAUSS_NARROW_D``, the panel layout
  of ``assign_gauss`` past d = 128 on the grid of ``assign.panel_plan``,
  any d); one launch per call, counted in ``loglik_cuda.launches``;
- ``loglik_plain``: the same math in plain PyTorch, in the reference's op
  order.

``kernels.ops.loglik_gauss`` picks between them by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.assign import (PANEL_MAX, WIDE_D, gauss_plan,
                                        panel_plan)
from repro_torch.kernels.launch import check_cuda, launch

LOG_2PI = 1.8378770664093453


def loglik_plain(x, mu, chol_prec, logdet_prec) -> torch.Tensor:
    d = x.shape[1]
    diff = x[:, None, :] - mu[None, :, :]                  # (N, K, d)
    y = torch.einsum("nkd,kde->nke", diff, chol_prec)
    maha = (y * y).sum(dim=-1)
    return 0.5 * (logdet_prec[None, :] - maha) - 0.5 * d * LOG_2PI


def loglik_cuda(x, mu, chol_prec, logdet_prec) -> torch.Tensor:
    """One launch of ``csrc/loglik_gauss.cu`` on the current stream."""
    n, d = x.shape
    k = mu.shape[0]
    if x.device.type != "cuda":
        raise ValueError("loglik_cuda takes CUDA tensors; the plain version "
                         "serves the CPU")
    if not 1 <= d <= PANEL_MAX:
        raise ValueError(f"loglik_gauss: d={d} outside [1, {PANEL_MAX}] "
                         "(an int in the kernel)")
    if k < 1 or n == 0:
        raise ValueError(f"loglik_gauss: needs K >= 1 slots and points, got "
                         f"K={k}, N={n}")
    for arg, t, shape in (("x", x, (n, d)), ("mu", mu, (k, d)),
                          ("chol_prec", chol_prec, (k, d, d)),
                          ("logdet_prec", logdet_prec, (k,))):
        check_cuda(arg, t, torch.float32, shape, x.device)
    out = torch.empty((n, k), device=x.device, dtype=torch.float32)
    head = (x.data_ptr(), n, d, mu.data_ptr(), chol_prec.data_ptr(),
            logdet_prec.data_ptr(), k)
    if d <= WIDE_D:
        plan = gauss_plan(n, d, k)
        fn = build.c_function("loglik_gauss", "loglik_gauss_launch",
                              "piipppiiiipp")
        launch(fn, x.device, *head, plan.dp, plan.groups, plan.smem,
               out.data_ptr())
    else:
        plan = panel_plan(n, d, k)
        fn = build.c_function("loglik_gauss", "loglik_gauss_panel_launch",
                              "piipppiiiiipp")
        launch(fn, x.device, *head, plan.bm, plan.per, plan.groups,
               plan.smem, out.data_ptr())
    loglik_cuda.launches += 1
    return out


loglik_cuda.launches = 0
