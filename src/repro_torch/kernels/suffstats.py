"""Label-indexed sub-cluster statistics per STATS_BLOCK of points.

Port of ``repro.kernels.suffstats.suffstats_labels`` and
``moments_labels``. For points (N, d), int32 labels / sublabels (N,) and
the valid mask (N,), they return for every block b of ``STATS_BLOCK``
consecutive points the partials

    n2  (nsb, k, 2)        sum of valid over the block's points in segment
    sx2 (nsb, k, 2, d)     sum of valid * x
    sxx2 (nsb, k, 2, d, d) sum of (valid * x) x^T   (suffstats_labels only)

over segments 2 * label + sublabel; points whose label is outside [0, k)
add nothing. ``moments_labels`` is the first-moment half, for the linear
families: its per-point features are x (multinomial, poisson) or the
stacked [x, x^2] (diag_gaussian), of any width d'. The caller folds the
nsb partials (``core.family``, ``core.labelstats``).

Two versions of each function:

- ``suffstats_labels_cuda`` / ``moments_labels_cuda``: the hand-written
  kernels ``csrc/suffstats_labels.cu`` / ``csrc/moments_labels.cu`` for a
  CUDA tensor (one launch per call, counted in the wrapper's
  ``launches``);
- ``suffstats_labels_plain`` / ``moments_labels_plain``: the same math in
  plain PyTorch, chunked per STATS_BLOCK so no (N, 2k) one-hot exists
  whole. The CPU path and the tests use them; on the card only the
  comparison in ``chip_smoke.py`` does.

``kernels.ops`` picks between them by the tensor's device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build

STATS_BLOCK = 1024
# Floats of temporaries one chunk of the plain version may hold.
CHUNK_FLOATS = 1 << 24
MAX_K = 8192
# The Gaussian kernels' widest d (suffstats_labels here, assign_gauss,
# sub_assign_gauss, loglik_gauss): the reference kernels stop at 128 and
# leave wider d to its jnp route, the port's kernels go on to 256 (a
# factor staged in column panels or read from L2). suffstats_labels
# indexes a block's 2k d^2 sxx entries with an int: 2^30 at k = MAX_K.
MAX_D = 256
# moments_labels: a block's 2k d' partial entries stay below 2^31 for
# k <= MAX_K (its per-chunk entry index is an int; d' rows use 64-bit
# offsets), and d' covers the 20newsgroups vocabulary with room.
MAX_DP = 1 << 16

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def n_blocks(n: int) -> int:
    return -(-n // STATS_BLOCK)


def _pad_blocks(a: torch.Tensor, nb: int) -> torch.Tensor:
    """(m, ...) -> (nb, STATS_BLOCK, ...), zero rows past m."""
    pad = nb * STATS_BLOCK - a.shape[0]
    if pad:
        a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return a.reshape((nb, STATS_BLOCK) + a.shape[1:])


def _segment_onehot(labels: torch.Tensor, sublabels: torch.Tensor,
                    valid: torch.Tensor, k: int, nb: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """(nb, 2k, STATS_BLOCK) valid-weighted one-hot over segments
    2 * label + sublabel; out-of-range labels give an all-zero column."""
    inside = (labels >= 0) & (labels < k) & (sublabels >= 0) & (sublabels <= 1)
    seg = torch.where(inside, labels * 2 + sublabels, -1)
    cols = torch.arange(2 * k, device=labels.device)
    r = ((seg[:, None] == cols[None, :]).to(dtype)
         * valid.to(dtype)[:, None])                      # (m, 2k)
    return _pad_blocks(r, nb).transpose(1, 2)


def block_moments(feats: torch.Tensor, labels: torch.Tensor,
                  sublabels: torch.Tensor, valid: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n / first-moment partials of ``ceil(m / STATS_BLOCK)`` blocks of m
    points, as one batch: the weighted one-hot times the features."""
    nb = n_blocks(feats.shape[0])
    r = _segment_onehot(labels, sublabels, valid, k, nb, feats.dtype)
    n2 = r.sum(dim=2).reshape(nb, k, 2)
    sf2 = torch.bmm(r, _pad_blocks(feats, nb)).reshape(nb, k, 2, -1)
    return n2, sf2


def block_partials(x: torch.Tensor, labels: torch.Tensor,
                   sublabels: torch.Tensor, valid: torch.Tensor,
                   k: int) -> Partials:
    """Partials of ``ceil(m / STATS_BLOCK)`` blocks of m points, as one
    batch: a (nb, STATS_BLOCK, 2k) weighted one-hot times x and times the
    flattened per-point outer products."""
    d = x.shape[1]
    nb = n_blocks(x.shape[0])
    r = _segment_onehot(labels, sublabels, valid, k, nb, x.dtype)
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


def moments_labels_plain(feats: torch.Tensor, labels: torch.Tensor,
                         sublabels: torch.Tensor, valid: torch.Tensor,
                         k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    n, dp = feats.shape
    nsb = n_blocks(n)
    n2 = feats.new_empty((nsb, k, 2))
    sf2 = feats.new_empty((nsb, k, 2, dp))
    step = max(1, CHUNK_FLOATS // (STATS_BLOCK * (2 * k + dp)))
    for b0 in range(0, nsb, step):
        b1 = min(nsb, b0 + step)
        sl = slice(b0 * STATS_BLOCK, b1 * STATS_BLOCK)
        n2[b0:b1], sf2[b0:b1] = block_moments(
            feats[sl], labels[sl], sublabels[sl], valid[sl], k)
    return n2, sf2


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
        raise ValueError(f"suffstats_labels: d={d} outside [1, {MAX_D}] "
                         "(ROADMAP.md §3)")
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


def moments_labels_cuda(feats: torch.Tensor, labels: torch.Tensor,
                        sublabels: torch.Tensor, valid: torch.Tensor,
                        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/moments_labels.cu`` on the current stream."""
    n, dp = feats.shape
    if feats.device.type != "cuda":
        raise ValueError("moments_labels_cuda takes CUDA tensors; the "
                         "plain version serves the CPU")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"moments_labels: k={k} outside [1, {MAX_K}] (the "
                         "segment offsets live in shared memory)")
    if not 1 <= dp <= MAX_DP:
        raise ValueError(f"moments_labels: d'={dp} outside [1, {MAX_DP}]")
    if n == 0:
        raise ValueError("moments_labels: no points")
    dev = feats.device
    _check_cuda("feats", feats, torch.float32, (n, dp), dev)
    _check_cuda("labels", labels, torch.int32, (n,), dev)
    _check_cuda("sublabels", sublabels, torch.int32, (n,), dev)
    _check_cuda("valid", valid, torch.float32, (n,), dev)
    nsb = n_blocks(n)
    n2 = torch.empty((nsb, k, 2), device=dev, dtype=torch.float32)
    sf2 = torch.empty((nsb, k, 2, dp), device=dev, dtype=torch.float32)
    fn = build.c_function("moments_labels", "moments_labels_launch",
                          "piipppippp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn(feats.data_ptr(), n, dp, labels.data_ptr(), sublabels.data_ptr(),
           valid.data_ptr(), k, n2.data_ptr(), sf2.data_ptr(), stream)
    moments_labels_cuda.launches += 1
    return n2, sf2


moments_labels_cuda.launches = 0
