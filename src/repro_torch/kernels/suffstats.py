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
  CUDA tensor (one launch per slot window of ``slot_windows``: one up to
  MAX_K slots, each counted in the wrapper's ``launches``);
- ``suffstats_labels_plain`` / ``moments_labels_plain``: the same math in
  plain PyTorch, chunked per STATS_BLOCK so no (N, 2k) one-hot exists
  whole. The CPU path and the tests use them; on the card only the
  comparison in ``chip_smoke.py`` does.

and ``suffstats_cuda`` (``csrc/suffstats_dense.cu``, one call per slot
window of responsibility columns) beside ``suffstats_plain`` (the
reference's jnp route: a sum, a product and an einsum, over chunks of
points).

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
# Slots one launch of the stat and step-(f) kernels takes (suffstats_labels,
# moments_labels, sub_assign_gauss, the dense oracle): a window's segment
# offsets, sort cursors and label counts live in shared memory. A call
# over more slots runs the windows of ``slot_windows`` one after another,
# each writing its own slots' rows, so any K is taken.
MAX_K = 8192
# moments_labels: a window's 2 MAX_K d' partial entries stay below 2^31
# (its per-chunk entry index is an int; d' rows use 64-bit offsets), and
# d' covers the 20newsgroups vocabulary with room.
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
# The segment fold of csrc/block_stats.cuh (suffstats_labels, sweep_gauss),
# whose tile this module chooses (``stats_plan``): threads a block, Gram
# tile edges (8 x 8 entries a thread, (edge / 8)^2 threads a team), and the
# shared ints of the sort's scan beside its cursor.
STATS_THREADS = 256
GRAM_EDGES = (8, 16, 32, 64, 128)
SCAN_INTS = 32
# For 64 < d <= 128, or below a full wave, up to STATS_SPLITS blocks share
# a STATS_BLOCK (each takes every splits-th (segment, tile) item) so that
# the grid fills about STATS_WAVES waves of two blocks on each of the
# H100's 132 SMs. Past d = 128, where one block's four tiles of a segment
# reuse its rows from L1 (three splits took 6.14 against 5.45 ms at
# 4e5 x 256 on the H100), only below one wave (a stat window of a wide
# fit: 31 STATS_BLOCKs at d = 256 over 64 slots), and to one wave.
STATS_SPLITS = 4
STATS_WAVES = 4
STATS_SLOTS = 2 * 132
INT_MAX = 2 ** 31 - 1

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def n_blocks(n: int) -> int:
    return -(-n // STATS_BLOCK)


def slot_windows(k: int) -> Tuple[Tuple[int, int], ...]:
    """Slot windows (k0, W) of a call over k slots: ceil(k / MAX_K)
    consecutive windows of near-equal width W <= MAX_K covering [0, k),
    each slot in exactly one. A function of k only."""
    nw = -(-k // MAX_K)
    bounds = [k * i // nw for i in range(nw + 1)]
    return tuple((a, b - a) for a, b in zip(bounds, bounds[1:]))


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
    """``csrc/suffstats_labels.cu`` on the current stream: one launch per
    slot window (``slot_windows``), each writing its slots' rows of the
    partials."""
    n, d = x.shape
    if x.device.type != "cuda":
        raise ValueError("suffstats_labels_cuda takes CUDA tensors; the "
                         "plain version serves the CPU")
    if k < 1 or d < 1:
        raise ValueError(f"suffstats_labels: needs k >= 1 and d >= 1, got "
                         f"k={k}, d={d}")
    if n == 0:
        raise ValueError("suffstats_labels: no points")
    wins = slot_windows(k)
    plans = [stats_plan(n, d, w) for _, w in wins]
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
                          "piipppiiiiiipppp")
    for (k0, w), plan in zip(wins, plans):
        launch(fn, dev, x.data_ptr(), n, d, labels.data_ptr(),
               sublabels.data_ptr(), valid.data_ptr(), k, k0, w, plan.edge,
               plan.smem, plan.splits, n2.data_ptr(), sx2.data_ptr(),
               sxx2.data_ptr())
        suffstats_labels_cuda.launches += 1
    return n2, sx2, sxx2


suffstats_labels_cuda.launches = 0


def moments_labels_cuda(feats: torch.Tensor, labels: torch.Tensor,
                        sublabels: torch.Tensor, valid: torch.Tensor,
                        k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csrc/moments_labels.cu`` on the current stream: one launch per
    slot window (``slot_windows``), each writing its slots' rows of the
    partials."""
    n, dp = feats.shape
    if feats.device.type != "cuda":
        raise ValueError("moments_labels_cuda takes CUDA tensors; the "
                         "plain version serves the CPU")
    if k < 1:
        raise ValueError(f"moments_labels: needs k >= 1, got k={k}")
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
                          "piipppiiippp")
    for k0, w in slot_windows(k):
        launch(fn, dev, feats.data_ptr(), n, dp, labels.data_ptr(),
               sublabels.data_ptr(), valid.data_ptr(), k, k0, w,
               n2.data_ptr(), sf2.data_ptr())
        moments_labels_cuda.launches += 1
    return n2, sf2


moments_labels_cuda.launches = 0


class StatsPlan(NamedTuple):
    """The launch of ``csrc/suffstats_labels.cu``: its Gram tile (template
    edge, tiles a side of a segment, teams a block), grid and dynamic shared
    bytes."""
    edge: int    # Gram tile edge: the least of GRAM_EDGES holding d, or 128
    tiles: int   # tiles a side of a segment's d x d sxx: ceil(d / edge)
    teams: int   # teams of (edge / 8)^2 threads a block, one tile each
    nsb: int     # STATS_BLOCKs of points
    smem: int    # dynamic shared bytes a block
    splits: int  # blocks a STATS_BLOCK (grid nsb x splits)


@lru_cache(maxsize=256)
def stats_plan(n: int, d: int, k: int) -> StatsPlan:
    """The segment fold's launch for (n, d) and a slot window of k slots,
    chosen here only: the launcher takes it as given and refuses an edge
    other than its own rule or shared bytes other than its layout. The
    edge is the least of GRAM_EDGES that holds d, so at d <= 64 several
    teams share a block (256 at d <= 8, 16 at d = 32) and above it one
    team of 256 threads walks ceil(d / 128)^2 tiles of 128 x 128 a
    segment. Shared memory: the points' segments, ids and weights
    (STATS_BLOCK each), the S + 1 offsets, the sort's S cursors and its
    scan's warp totals (S = 2k). For 64 < d <= 128, or where the
    STATS_BLOCKs are fewer than two an SM, a STATS_BLOCK's (segment,
    tile) items are shared by up to STATS_SPLITS blocks, each sorting the
    block itself, so that a grid of few STATS_BLOCKs (2e5 points at
    d = 128: 196; a stat window of a wide fit) still fills the card (past
    d = 128 to one wave only); no output's bits depend on it. N, the window's (segment, tile) items and the blocks' offsets
    into the partials are ints or 64-bit in the kernel: N and the items
    below 2^31 are taken."""
    tiles = -(-d // GRAM_EDGES[-1])
    if not (1 <= n <= INT_MAX and d >= 1 and 1 <= k <= MAX_K
            and 2 * k * tiles * tiles <= INT_MAX):
        raise ValueError(f"suffstats_labels: N={n}, d={d}, k={k} outside "
                         f"[1, 2^31), d >= 1, [1, {MAX_K}] with 2k "
                         "ceil(d / 128)^2 < 2^31")
    edge = next((e for e in GRAM_EDGES if e >= d), GRAM_EDGES[-1])
    teams = STATS_THREADS // (edge // 8) ** 2
    s = 2 * k
    smem = 4 * (3 * STATS_BLOCK + s + 1 + s + SCAN_INTS)
    nsb = n_blocks(n)
    if nsb >= STATS_SLOTS and (d <= 64 or d > 128):
        splits = 1
    else:
        waves = 1 if d > 128 else STATS_WAVES
        splits = min(STATS_SPLITS, -(-waves * STATS_SLOTS // nsb))
    return StatsPlan(edge, -(-d // edge), teams, nsb, smem, splits)


class DensePlan(NamedTuple):
    """The launch of ``csrc/suffstats_dense.cu`` for one slot window: its
    template (bn, width; past d = 256 the panel tile (128, 256), ``panel``
    set), grid (gx blocks a chunk, nc chunks of ``chunk`` points) and
    dynamic shared bytes."""
    bn: int      # Gram columns a block
    width: int   # rows a cluster and staged floats a point: a multiple of bn
    gx: int      # blocks a point chunk
    chunk: int   # points a chunk, whole slabs
    nc: int      # point chunks, none empty
    smem: int    # dynamic shared bytes a block
    panel: bool = False  # d > 256: two 128-column panels staged a block


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
    """The dense kernel's launch for (n, d) and a slot window of k
    clusters, chosen here only: the launcher takes it as given and refuses
    only a template it does not hold or shared bytes other than that
    template's layout. Column tile bn from d (the least of DENSE_BN that
    holds d, else 128 and ceil(d / 128) tiles); each cluster ``width``
    rows, so a block of DENSE_TILE // bn rows holds whole clusters (d <=
    64) or one 128 x 128 tile of one (d > 64); the chunks; and the shared
    bytes: a ring of DENSE_STAGES slabs of DENSE_P points, each a row of
    ``width`` x floats and one r value a cluster of the block, and the
    slab's a-side factors, DENSE_P floats a block row. Past d = 256 a
    staged row of the whole cluster would pass a block's shared memory:
    the panel tile stages the block's two 128-column panels (width 256,
    the d <= 256 layout) on a grid of k ceil(d / 128)^2 tiles."""
    bn = next((b for b in DENSE_BN if b >= d), DENSE_BN[-1])
    bm = DENSE_TILE // bn
    nbt = -(-d // bn)
    panel = d > 2 * DENSE_BN[-1]
    width = 2 * bn if panel else nbt * bn
    ncl = max(1, bm // width)
    gx = -(-(k * nbt * bn) // bm) * nbt
    smem = 4 * (DENSE_STAGES * DENSE_P * (width + ncl) + DENSE_P * bm)
    return DensePlan(bn, width, gx, *dense_chunks(n, gx), smem, panel)


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
    """``csrc/suffstats_dense.cu`` on the current stream (the chunk kernel
    and its left-to-right fold), one call per slot window of
    responsibility columns (``slot_windows``), each counted once in
    ``suffstats_cuda.launches``."""
    if x.device.type != "cuda":
        raise ValueError("suffstats_cuda takes CUDA tensors; the plain "
                         "version serves the CPU")
    if x.ndim != 2 or resp.ndim != 2 or resp.shape[0] != x.shape[0]:
        raise ValueError(f"suffstats: x {tuple(x.shape)} and resp "
                         f"{tuple(resp.shape)} are not (N, d) and (N, K)")
    n, d = x.shape
    k = resp.shape[1]
    if d < 1 or k < 1:
        raise ValueError(f"suffstats: needs d >= 1 and K >= 1, got d={d}, "
                         f"K={k}")
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"suffstats: N={n} outside [1, 2^31)")
    dev = x.device
    check_cuda("x", x, torch.float32, (n, d), dev)
    check_cuda("resp", resp, torch.float32, (n, k), dev)
    wins = slot_windows(k)
    plans = [dense_plan(n, d, w) for _, w in wins]
    out = torch.empty((k * (1 + d + d * d),), device=dev,
                      dtype=torch.float32)
    fn = build.c_function("suffstats_dense", "suffstats_dense_launch",
                          "ppiiiiiiiiiippp")
    for (k0, w), plan in zip(wins, plans):
        part = torch.empty((plan.nc, w * (1 + d + d * d)), device=dev,
                           dtype=torch.float32)
        launch(fn, dev, x.data_ptr(), resp.data_ptr(), n, d, k, k0, w,
               plan.bn, plan.width, plan.chunk, plan.nc, plan.smem,
               part.data_ptr(), out.data_ptr())
        suffstats_cuda.launches += 1
    return (out[:k], out[k:k + k * d].view(k, d),
            out[k + k * d:].view(k, d, d))


suffstats_cuda.launches = 0
