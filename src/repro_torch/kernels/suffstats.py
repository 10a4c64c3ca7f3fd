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

from functools import lru_cache
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import check_cuda, launch

STATS_BLOCK = 1024
# Floats of temporaries one chunk of the plain version may hold.
CHUNK_FLOATS = 1 << 24
MAX_K = 8192
# The widest d of the Gaussian fit's stat and step-(f) kernels
# (suffstats_labels here, the dense oracle, sub_assign_gauss): the
# reference kernels stop at 128 and leave wider d to its jnp route, these
# go on to 256 (sub_assign_gauss reads a point's factors from L2).
# suffstats_labels indexes a block's 2k d^2 sxx entries with an int: 2^30
# at k = MAX_K. assign_gauss and loglik_gauss take any d (assign.py
# PANEL_MAX).
MAX_D = 256
# moments_labels: a block's 2k d' partial entries stay below 2^31 for
# k <= MAX_K (its per-chunk entry index is an int; d' rows use 64-bit
# offsets), and d' covers the 20newsgroups vocabulary with room.
MAX_DP = 1 << 16
# csrc/suffstats_dense.cu, whose tile this module chooses (``dense_plan``):
# Gram elements a block (256 threads, 8 x 8 each), points a slab, slabs in
# the shared ring, column tiles; blocks the card runs at once (132 SMs, two
# a SM), the fewest slabs a chunk, and a Hopper block's dynamic shared
# bytes
DENSE_TILE, DENSE_P, DENSE_STAGES = 16384, 32, 3
DENSE_BN = (16, 32, 64, 128)
DENSE_SLOTS = 132 * 2
DENSE_MIN_SLABS = 2
SMEM_LIMIT = 232_448

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
    check_cuda("x", x, torch.float32, (n, d), dev)
    check_cuda("labels", labels, torch.int32, (n,), dev)
    check_cuda("sublabels", sublabels, torch.int32, (n,), dev)
    check_cuda("valid", valid, torch.float32, (n,), dev)
    nsb = n_blocks(n)
    n2 = torch.empty((nsb, k, 2), device=dev, dtype=torch.float32)
    sx2 = torch.empty((nsb, k, 2, d), device=dev, dtype=torch.float32)
    sxx2 = torch.empty((nsb, k, 2, d, d), device=dev, dtype=torch.float32)
    fn = build.c_function("suffstats_labels", "suffstats_labels_launch",
                          "piipppipppp")
    launch(fn, dev, x.data_ptr(), n, d, labels.data_ptr(),
           sublabels.data_ptr(), valid.data_ptr(), k, n2.data_ptr(),
           sx2.data_ptr(), sxx2.data_ptr())
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
    check_cuda("feats", feats, torch.float32, (n, dp), dev)
    check_cuda("labels", labels, torch.int32, (n,), dev)
    check_cuda("sublabels", sublabels, torch.int32, (n,), dev)
    check_cuda("valid", valid, torch.float32, (n,), dev)
    nsb = n_blocks(n)
    n2 = torch.empty((nsb, k, 2), device=dev, dtype=torch.float32)
    sf2 = torch.empty((nsb, k, 2, dp), device=dev, dtype=torch.float32)
    fn = build.c_function("moments_labels", "moments_labels_launch",
                          "piipppippp")
    launch(fn, dev, feats.data_ptr(), n, dp, labels.data_ptr(),
           sublabels.data_ptr(), valid.data_ptr(), k, n2.data_ptr(),
           sf2.data_ptr())
    moments_labels_cuda.launches += 1
    return n2, sf2


moments_labels_cuda.launches = 0


class DensePlan(NamedTuple):
    """The launch of ``csrc/suffstats_dense.cu``: its template (bn, width),
    grid (gx blocks a chunk, nc chunks of ``chunk`` points) and dynamic
    shared bytes."""
    bn: int      # Gram columns a block
    width: int   # rows a cluster and staged floats a point: a multiple of bn
    gx: int      # blocks a point chunk
    chunk: int   # points a chunk, whole slabs
    nc: int      # point chunks, none empty
    smem: int    # dynamic shared bytes a block


def dense_chunks(n: int, gx: int) -> Tuple[int, int]:
    """(points a chunk, chunks) for N points and ``gx`` blocks a chunk. The
    target count: at least two waves of DENSE_SLOTS blocks, the count in
    [c, 2c] that wastes the least of the last wave (the smallest of
    equals), one chunk when ``gx`` alone makes two waves. Each chunk is
    whole slabs, at least DENSE_MIN_SLABS (a chunk's partial is K (1 + d +
    d^2) floats to write and fold, whatever its points), so the count may
    come out lower. A function of the shape only, so two launches fold the
    same chunks."""
    if gx >= 2 * DENSE_SLOTS:
        target = 1
    else:
        lo = -(-2 * DENSE_SLOTS // gx)
        target = max(range(lo, 2 * lo + 1), key=lambda c: (
            gx * c / (-(-gx * c // DENSE_SLOTS) * DENSE_SLOTS), -c))
    slabs = -(-n // DENSE_P)
    # a chunk's points are an int in the kernel: below 2^31
    per = min(max(DENSE_MIN_SLABS, -(-slabs // target)),
              (2 ** 31 - 1) // DENSE_P)
    return per * DENSE_P, -(-slabs // per)


@lru_cache(maxsize=256)
def dense_plan(n: int, d: int, k: int) -> DensePlan:
    """The dense kernel's launch for (n, d, k), chosen here only: the
    launcher takes it as given and refuses only a template it does not
    hold or shared bytes other than that template's layout. Column tile
    bn from d (the least of DENSE_BN that holds d, else 128 and ceil(d /
    128) tiles); each cluster ``width`` rows, so a block of DENSE_TILE //
    bn rows holds whole clusters (d <= 64) or one 128 x 128 tile of one
    (d > 64); the chunks; and the shared bytes: a ring of DENSE_STAGES
    slabs of DENSE_P points, each a row of ``width`` x floats and one r
    value a cluster of the block, and the slab's a-side factors, DENSE_P
    floats a block row."""
    bn = next((b for b in DENSE_BN if b >= d), DENSE_BN[-1])
    bm = DENSE_TILE // bn
    nbt = -(-d // bn)
    width = nbt * bn
    ncl = max(1, bm // width)
    gx = -(-(k * width) // bm) * nbt
    smem = 4 * (DENSE_STAGES * DENSE_P * (width + ncl) + DENSE_P * bm)
    return DensePlan(bn, width, gx, *dense_chunks(n, gx), smem)


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
    check_cuda("x", x, torch.float32, (n, d), dev)
    check_cuda("resp", resp, torch.float32, (n, k), dev)
    plan = dense_plan(n, d, k)
    m = k * (1 + d + d * d)
    part = torch.empty((plan.nc, m), device=dev, dtype=torch.float32)
    out = torch.empty((m,), device=dev, dtype=torch.float32)
    fn = build.c_function("suffstats_dense", "suffstats_dense_launch",
                          "ppiiiiiiiippp")
    launch(fn, dev, x.data_ptr(), resp.data_ptr(), n, d, k, plan.bn,
           plan.width, plan.chunk, plan.nc, plan.smem, part.data_ptr(),
           out.data_ptr())
    suffstats_cuda.launches += 1
    return (out[:k], out[k:k + k * d].view(k, d),
            out[k + k * d:].view(k, d, d))


suffstats_cuda.launches = 0
