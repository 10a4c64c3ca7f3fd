"""Blocked fp32 matrix product, the paper's "Kernel #1".

Port of ``repro.kernels.matmul.matmul``: (M, K) @ (K, N) -> (M, N) f32.
It serves the diagonal-Gaussian likelihood through ``ops.matmul_auto``,
which keeps the reference's d N size test: below ``MATMUL_CROSSOVER``
elements of the left operand this kernel runs, above it ``torch.matmul``
(as ``repro.kernels.ref.matmul`` does in the reference).

Two versions of one function:

- ``matmul_cuda``: the hand-written kernel ``csrc/matmul.cu`` (a column
  tile of ``matmul_bn(N)``, cp.async slabs, fp32 FMA in k order, no TF32);
  one launch per call, counted in ``matmul_cuda.launches``;
- ``matmul_plain``: ``a @ b``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import check_cuda, launch

# The paper's crossover (Quadro RTX 4000), kept as the reference keeps it;
# PERF.md has the one measured on the H100.
MATMUL_CROSSOVER = 640_000


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def matmul_bn(n: int) -> int:
    """Column tile of ``csrc/matmul.cu`` for N columns, chosen here only
    (the launcher takes any of its three templates and derives the grid
    from it): the least of 16, 32 and 64 that holds N (a slab's slots),
    else 64, whose ceil(N / 64) tiles cover N."""
    return 16 if n <= 16 else 32 if n <= 32 else 64


def matmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/matmul.cu`` on the current stream."""
    m, k = a.shape
    k2, n = b.shape
    dev = a.device
    if dev.type != "cuda":
        raise ValueError("matmul_cuda takes CUDA tensors; the plain version "
                         "serves the CPU")
    if k != k2 or 0 in (m, k, n):
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not multiply")
    check_cuda("a", a, torch.float32, (m, k), dev)
    check_cuda("b", b, torch.float32, (k, n), dev)
    out = a.new_empty((m, n))
    fn = build.c_function("matmul", "matmul_launch", "pppiiiip")
    launch(fn, dev, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
           matmul_bn(n))
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
