"""Cluster statistics: label-indexed per STATS_BLOCK of points, and the
dense-responsibility oracle.

Port of ``repro.kernels.suffstats.suffstats_labels``, ``moments_labels``
and ``suffstats``. For points (N, d), int32 labels / sublabels (N,) and
the valid mask (N,), they return for every block b of ``STATS_BLOCK``
consecutive points the partials

    n2  (nsb, k, 2)        sum of valid over the block's points in segment
    sx2 (nsb, k, 2, d)     sum of valid * x
    sxx2 (nsb, k, 2, d, d) sum of (valid * x) x^T   (suffstats_labels only)

over segments 2 * label + sublabel; points whose label is outside [0, k)
add nothing. ``moments_labels`` is the first-moment half, for the linear
families: its per-point features are x (multinomial, poisson) or the
stacked [x, x^2] (diag_gaussian), of any width d'. The caller folds the
nsb partials (``core.labelstats.fold_stats``).

``suffstats`` is the dense oracle: x (N, d) and responsibilities resp
(N, K), both float32, give n (K,) = sum_i r_ik, sx (K, d) = resp^T x and
sxx (K, d, d) = sum_i (r_ik x_i) x_i^T. No sampler path calls it; it is
the paper's §4.2 kernel comparison and the tests' yardstick.

Two versions of each function:

- ``suffstats_labels_cuda`` / ``moments_labels_cuda``: the hand-written
  kernels ``csrc/suffstats_labels.cu`` / ``csrc/moments_labels.cu`` for a
  CUDA tensor (one launch per call, counted in the wrapper's
  ``launches``);
- ``suffstats_labels_plain`` / ``moments_labels_plain``: the same math in
  plain PyTorch, chunked per STATS_BLOCK so no (N, 2k) one-hot exists
  whole. The CPU path and the tests use them; on the card only the
  comparison in ``chip_smoke.py`` does.

and ``suffstats_cuda`` (``csrc/suffstats_dense.cu``) beside
``suffstats_plain`` (the reference's jnp route: a sum, a product and an
einsum, over chunks of points).

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
# csrc/suffstats_dense.cu: threads a block, points staged a step
DENSE_THREADS, DENSE_P = 256, 32

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def n_blocks(n: int) -> int:
    return -(-n // STATS_BLOCK)


def _segment_rows(labels: torch.Tensor, sublabels: torch.Tensor,
                  valid: torch.Tensor, k: int) -> torch.Tensor:
    """(m,) row of each point in the (nb * 2k + 1)-row partial table: its
    block's segment 2 * label + sublabel, or the last (dropped) row for an
    invalid point or an out-of-range label."""
    m = labels.shape[0]
    inside = ((labels >= 0) & (labels < k) & (sublabels >= 0)
              & (sublabels <= 1) & (valid != 0))
    blk = torch.arange(m, device=labels.device) // STATS_BLOCK
    rows = blk * (2 * k) + labels.long() * 2 + sublabels.long()
    return torch.where(inside, rows, n_blocks(m) * 2 * k)


def _segment_sums(rows: torch.Tensor, vals: torch.Tensor,
                  nrows: int) -> torch.Tensor:
    """Per-row sums of ``vals`` ((m, ...)) by ``rows``, each row's points
    added in point order (``index_add_`` runs over the points in order on
    the CPU), so a block's sums do not depend on k, on how many blocks
    share a call, or on the tile the block came in."""
    out = vals.new_zeros((nrows + 1,) + tuple(vals.shape[1:]))
    return out.index_add_(0, rows, vals)[:nrows]


def block_moments(feats: torch.Tensor, labels: torch.Tensor,
                  sublabels: torch.Tensor, valid: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """n / first-moment partials of ``ceil(m / STATS_BLOCK)`` blocks of m
    points, as one batch of segment sums."""
    nb = n_blocks(feats.shape[0])
    rows = _segment_rows(labels, sublabels, valid, k)
    w = valid.to(feats.dtype)
    n2 = _segment_sums(rows, w, nb * 2 * k).reshape(nb, k, 2)
    sf2 = _segment_sums(rows, w[:, None] * feats, nb * 2 * k)
    return n2, sf2.reshape(nb, k, 2, -1)


def block_partials(x: torch.Tensor, labels: torch.Tensor,
                   sublabels: torch.Tensor, valid: torch.Tensor,
                   k: int) -> Partials:
    """Partials of ``ceil(m / STATS_BLOCK)`` blocks of m points, as one
    batch of segment sums of the weights, the weighted points and their
    flattened outer products (w x) x^T."""
    d = x.shape[1]
    n2, sx2 = block_moments(x, labels, sublabels, valid, k)
    nb = n2.shape[0]
    rows = _segment_rows(labels, sublabels, valid, k)
    wx = valid.to(x.dtype)[:, None] * x
    outer = (wx[:, :, None] * x[:, None, :]).reshape(-1, d * d)
    sxx2 = _segment_sums(rows, outer, nb * 2 * k).reshape(nb, k, 2, d, d)
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


def dense_chunks(n: int, d: int, k: int) -> int:
    """Point chunks of ``csrc/suffstats_dense.cu`` for (n, d, k): enough
    thread blocks of DENSE_THREADS (k, 4 x 4 tile) items for about two
    waves of 132 SMs, each chunk about DENSE_P points or more. It depends
    on the shape only, so two launches fold the same chunks."""
    dq = -(-d // 4)
    gx = -(-(k * dq * dq) // DENSE_THREADS)
    return max(1, min(-(-2 * 132 * 4 // gx), n // DENSE_P))


def suffstats_plain(x: torch.Tensor, resp: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n, sx, sxx of ``resp``-weighted points, as the reference's
    ``kernels/ref.suffstats``: a sum, ``resp^T x`` and an einsum, over
    chunks of points whose (m, K, d) temporary holds CHUNK_FLOATS, added
    in order."""
    n, d = x.shape
    k = resp.shape[1]
    cnt = x.new_zeros((k,))
    sx = x.new_zeros((k, d))
    sxx = x.new_zeros((k, d, d))
    step = max(1, CHUNK_FLOATS // max(1, k * d))
    for a in range(0, n, step):
        xs, rs = x[a:a + step], resp[a:a + step]
        cnt = cnt + rs.sum(dim=0)
        sx = sx + rs.T @ xs
        sxx = sxx + torch.einsum("nk,nd,ne->kde", rs, xs, xs)
    return cnt, sx, sxx


def suffstats_cuda(x: torch.Tensor, resp: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One call of ``csrc/suffstats_dense.cu`` on the current stream (the
    chunk kernel and its left-to-right fold), counted once in
    ``suffstats_cuda.launches``."""
    if x.device.type != "cuda":
        raise ValueError("suffstats_cuda takes CUDA tensors; the plain "
                         "version serves the CPU")
    if x.ndim != 2 or resp.ndim != 2 or resp.shape[0] != x.shape[0]:
        raise ValueError(f"suffstats: x {tuple(x.shape)} and resp "
                         f"{tuple(resp.shape)} are not (N, d) and (N, K)")
    n, d = x.shape
    k = resp.shape[1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"suffstats: d={d} outside [1, {MAX_D}] "
                         "(ROADMAP.md §3)")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"suffstats: K={k} outside [1, {MAX_K}]")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"suffstats: N={n} outside [1, 2^31)")
    dev = x.device
    _check_cuda("x", x, torch.float32, (n, d), dev)
    _check_cuda("resp", resp, torch.float32, (n, k), dev)
    nc = dense_chunks(n, d, k)
    m = k * (1 + d + d * d)
    part = torch.empty((nc, m), device=dev, dtype=torch.float32)
    out = torch.empty((m,), device=dev, dtype=torch.float32)
    fn = build.c_function("suffstats_dense", "suffstats_dense_launch",
                          "ppiiiippp")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        fn(x.data_ptr(), resp.data_ptr(), n, d, k, nc, part.data_ptr(),
           out.data_ptr(), stream)
    suffstats_cuda.launches += 1
    return (out[:k], out[k:k + k * d].view(k, d),
            out[k + k * d:].view(k, d, d))


suffstats_cuda.launches = 0
