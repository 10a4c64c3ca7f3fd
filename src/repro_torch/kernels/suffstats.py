"""Label-indexed sub-cluster statistics per STATS_BLOCK of points.

Port of ``repro.kernels.suffstats.suffstats_labels``. For x (N, d), int32
labels / sublabels (N,) and the valid mask (N,), it returns for every
block b of ``STATS_BLOCK`` consecutive points the partials

    n2  (nsb, k, 2)        sum of valid over the block's points in segment
    sx2 (nsb, k, 2, d)     sum of valid * x
    sxx2 (nsb, k, 2, d, d) sum of (valid * x) x^T

over segments 2 * label + sublabel; points whose label is outside [0, k)
add nothing. The caller folds the nsb partials (``core.family``).

Two versions of one function:

- ``suffstats_labels_cuda``: the hand-written kernel
  ``csrc/suffstats_labels.cu`` for a CUDA tensor (one launch per call,
  counted in ``suffstats_labels_cuda.launches``);
- ``suffstats_labels_plain``: the same math in plain PyTorch, chunked per
  STATS_BLOCK so no (N, 2k) one-hot exists whole. The CPU path and the
  tests use it; on the card only the comparison in ``chip_smoke.py`` does.

``kernels.ops.suffstats_labels`` picks between them by the tensor's device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

STATS_BLOCK = 1024
# Floats of temporaries one chunk of the plain version may hold.
CHUNK_FLOATS = 1 << 24
MAX_K = 8192
# The kernel indexes a block's 2k d^2 sxx entries with an int.
MAX_D = 64

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def n_blocks(n: int) -> int:
    return -(-n // STATS_BLOCK)


def _pad_blocks(a: torch.Tensor, nb: int) -> torch.Tensor:
    """(m, ...) -> (nb, STATS_BLOCK, ...), zero rows past m."""
    pad = nb * STATS_BLOCK - a.shape[0]
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return a.reshape((nb, STATS_BLOCK) + a.shape[1:])


def block_partials(x: torch.Tensor, labels: torch.Tensor,
                   sublabels: torch.Tensor, valid: torch.Tensor,
                   k: int) -> Partials:
    """Partials of ``ceil(m / STATS_BLOCK)`` blocks of m points, as one
    batch: a (nb, STATS_BLOCK, 2k) weighted one-hot times x and times the
    flattened per-point outer products."""
    d = x.shape[1]
    nb = n_blocks(x.shape[0])
    inside = (labels >= 0) & (labels < k) & (sublabels >= 0) & (sublabels <= 1)
    seg = torch.where(inside, labels * 2 + sublabels, -1)
    cols = torch.arange(2 * k, device=x.device)
    r = ((seg[:, None] == cols[None, :]).to(x.dtype)
         * valid.to(x.dtype)[:, None])                    # (m, 2k)
    r = _pad_blocks(r, nb).transpose(1, 2)                 # (nb, 2k, SB)
    xb = _pad_blocks(x, nb)                                # (nb, SB, d)
    outer = _pad_blocks((x[:, :, None] * x[:, None, :]).reshape(-1, d * d),
                        nb)
    n2 = r.sum(dim=2).reshape(nb, k, 2)
    sx2 = torch.bmm(r, xb).reshape(nb, k, 2, d)
    sxx2 = torch.bmm(r, outer).reshape(nb, k, 2, d, d)
    return n2, sx2, sxx2


def suffstats_labels_plain(x: torch.Tensor, labels: torch.Tensor,
                           sublabels: torch.Tensor, valid: torch.Tensor,
                           k: int) -> Partials:
    n, d = x.shape
    nsb = n_blocks(n)
    n2 = x.new_empty((nsb, k, 2))
    sx2 = x.new_empty((nsb, k, 2, d))
    sxx2 = x.new_empty((nsb, k, 2, d, d))
    per_block = STATS_BLOCK * (2 * k + d + 2 * d * d)
    step = max(1, CHUNK_FLOATS // per_block)
    for b0 in range(0, nsb, step):
        b1 = min(nsb, b0 + step)
        sl = slice(b0 * STATS_BLOCK, b1 * STATS_BLOCK)
        n2[b0:b1], sx2[b0:b1], sxx2[b0:b1] = block_partials(
            x[sl], labels[sl], sublabels[sl], valid[sl], k)
    return n2, sx2, sxx2


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def suffstats_labels_cuda(x: torch.Tensor, labels: torch.Tensor,
                          sublabels: torch.Tensor, valid: torch.Tensor,
                          k: int) -> Partials:
    """One launch of ``csrc/suffstats_labels.cu`` on the current stream."""
    n, d = x.shape
    if x.device.type != "cuda":
        raise ValueError("suffstats_labels_cuda takes CUDA tensors; the "
                         "plain version serves the CPU")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"suffstats_labels: k={k} outside [1, {MAX_K}]")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"suffstats_labels: d={d} outside [1, {MAX_D}]")
    if n == 0:
        raise ValueError("suffstats_labels: no points")
    dev = x.device
    _check_cuda("x", x, torch.float32, (n, d), dev)
    _check_cuda("labels", labels, torch.int32, (n,), dev)
    _check_cuda("sublabels", sublabels, torch.int32, (n,), dev)
    _check_cuda("valid", valid, torch.float32, (n,), dev)
    nsb = n_blocks(n)
    n2 = torch.empty((nsb, k, 2), device=dev, dtype=torch.float32)
    sx2 = torch.empty((nsb, k, 2, d), device=dev, dtype=torch.float32)
    sxx2 = torch.empty((nsb, k, 2, d, d), device=dev, dtype=torch.float32)
    fn = build.c_function("suffstats_labels", "suffstats_labels_launch",
                          "piipppipppp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn(x.data_ptr(), n, d, labels.data_ptr(), sublabels.data_ptr(),
           valid.data_ptr(), k, n2.data_ptr(), sx2.data_ptr(),
           sxx2.data_ptr(), stream)
    suffstats_labels_cuda.launches += 1
    return n2, sx2, sxx2


suffstats_labels_cuda.launches = 0
