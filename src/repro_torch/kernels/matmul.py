"""Blocked fp32 matrix product, the paper's "Kernel #1".

Port of ``repro.kernels.matmul.matmul``: (M, K) @ (K, N) -> (M, N) f32.
It serves the diagonal-Gaussian likelihood through ``ops.matmul_auto``,
which keeps the reference's d N size test: below ``MATMUL_CROSSOVER``
elements of the left operand this kernel runs, above it ``torch.matmul``
(as ``repro.kernels.ref.matmul`` does in the reference).

Two versions of one function:

- ``matmul_cuda``: the hand-written kernel ``csrc/matmul.cu`` (shared-memory
  tiles, fp32 FMA in k order, no TF32); one launch per call, counted in
  ``matmul_cuda.launches``;
- ``matmul_plain``: ``a @ b``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.suffstats import _check_cuda

# The paper's crossover (Quadro RTX 4000), kept as the reference keeps it;
# PERF.md has the one measured on the H100.
MATMUL_CROSSOVER = 640_000


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/matmul.cu`` on the current stream."""
    m, k = a.shape
    k2, n = b.shape
    if a.device.type != "cuda":
        raise ValueError("matmul_cuda takes CUDA tensors; the plain version "
                         "serves the CPU")
    if k != k2 or 0 in (m, k, n):
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not multiply")
    _check_cuda("a", a, torch.float32, (m, k), a.device)
    _check_cuda("b", b, torch.float32, (k, n), a.device)
    out = torch.empty((m, n), device=a.device, dtype=torch.float32)
    fn = build.c_function("matmul", "matmul_launch", "pppiiip")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, stream)
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
