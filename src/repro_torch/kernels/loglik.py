"""Dense Gaussian log-likelihoods of a batch of points under every cluster.

Port of ``repro.kernels.loglik.loglik`` (the serving query's likelihood):

    x (N, d) f32; mu (K, d); chol_prec (K, d, d) F with Sigma^-1 = F F^T;
    logdet_prec (K,)
    -> (N, K) f32: 0.5 (logdet_k - |F_k^T (x_i - mu_k)|^2) - 0.5 d log 2 pi

Two versions of one function:

- ``loglik_cuda``: the hand-written kernel ``csrc/loglik_gauss.cu`` (the
  whitening device code of the sweeps' step (e)); one launch per call,
  counted in ``loglik_cuda.launches``;
- ``loglik_plain``: the same math in plain PyTorch, in the reference's op
  order.

``kernels.ops.loglik_gauss`` picks between them by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.suffstats import MAX_D, _check_cuda

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
    if not 1 <= d <= MAX_D:
        raise ValueError(f"loglik_gauss: d={d} outside [1, {MAX_D}] "
                         "(ROADMAP.md §3)")
    if k < 1 or n == 0:
        raise ValueError(f"loglik_gauss: needs K >= 1 slots and points, got "
                         f"K={k}, N={n}")
    for arg, t, shape in (("x", x, (n, d)), ("mu", mu, (k, d)),
                          ("chol_prec", chol_prec, (k, d, d)),
                          ("logdet_prec", logdet_prec, (k,))):
        _check_cuda(arg, t, torch.float32, shape, x.device)
    out = torch.empty((n, k), device=x.device, dtype=torch.float32)
    fn = build.c_function("loglik_gauss", "loglik_gauss_launch", "piipppipp")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        fn(x.data_ptr(), n, d, mu.data_ptr(), chol_prec.data_ptr(),
           logdet_prec.data_ptr(), k, out.data_ptr(), stream)
    loglik_cuda.launches += 1
    return out


loglik_cuda.launches = 0
