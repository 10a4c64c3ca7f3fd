"""Shape-only choices of the dense ``suffstats`` kernel, the ``matmul``
kernel, the panel layout of ``assign_gauss`` / ``loglik_gauss`` past
d = 128, the segment fold of ``suffstats_labels`` / ``sweep_gauss``, the
tiled step (e) of ``sweep_gauss``, the label grouping and product of
``sub_assign_gauss`` and the two launches of ``sweep_linear``
(``kernels/suffstats.py`` ``dense_plan`` and ``stats_plan``,
``kernels/matmul.py`` ``matmul_bn``, ``kernels/assign.py`` ``panel_plan``
and ``sub_plan``, ``kernels/sweep.py`` ``sweep_plan`` and
``linear_plan``), checked on the CPU: the kernels themselves run only on
the card (``tests/test_torch_cuda.py``), and their launchers take these
choices as given, refusing a tile they do not hold."""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import assign as assign_mod
from repro_torch.kernels.assign import (GAUSS_NARROW_D, PANEL_BK, PANEL_BM,
                                        PANEL_BN, PANEL_STAGES, SUB_BK,
                                        SUB_COLS, SUB_LAUNCHES, SUB_NARROW_D,
                                        SUB_STAGES, SUB_XS, TE_BLOCKS,
                                        assign_gauss_launches, gauss_plan,
                                        group_share, panel_plan, sub_col,
                                        sub_plan)
from repro_torch.kernels.matmul import matmul_bn
from repro_torch.kernels.suffstats import (DENSE_BN, DENSE_MIN_SLABS,
                                           DENSE_P, DENSE_STAGES, DENSE_TILE,
                                           GRAM_EDGES, MAX_K,
                                           SCAN_INTS, SMEM_LIMIT,
                                           STATS_BLOCK, STATS_SPLITS,
                                           STATS_THREADS,
                                           dense_plan, stats_plan)
from repro_torch.kernels.sweep import MAX_D as SWEEP_MAX_D
from repro_torch.kernels.sweep import MAX_K as SWEEP_MAX_K
from repro_torch.kernels.sweep import (LE_BK, LE_BLOCKS, LE_BM, LE_FSTR,
                                       LE_STAGES, LE_THREADS,
                                       LINEAR_LAUNCHES, TE_BM, TE_LIST,
                                       TE_MIN_D, TE_STAGES, TE_THREADS,
                                       launches_per_call, linear_plan,
                                       sweep_plan, te_layout)
from repro_torch.kernels.suffstats import MAX_DP

# widths the plans' shared-memory checks walk: past d = 256 the stat and
# step-(f) kernels take any d (panels of columns), and their shared bytes
# must not grow with it
PLAN_DS = range(1, 1025)


@pytest.mark.parametrize("d", [1, 4, 16, 17, 32, 33, 63, 64, 65, 128, 129,
                               255, 256])
def test_dense_tile_covers_every_cluster_row_and_column(d):
    for k in (1, 5, 32, 300, MAX_K):
        p = dense_plan(10_000, d, k)
        assert p.bn in DENSE_BN
        bm, nbt = DENSE_TILE // p.bn, p.width // p.bn
        # the five tiles the launcher holds
        assert (p.bn, p.width) in ((16, 16), (32, 32), (64, 64), (128, 128),
                                   (128, 256))
        assert p.width == nbt * p.bn >= d > p.width - p.bn
        assert (p.gx // nbt) * bm >= k * p.width
        if d <= 64:
            # several clusters' whole d x d a block
            assert nbt == 1 and bm % p.width == 0
        else:
            # one cluster's 128 x 128 tile: x staged ceil(d / 128)^2 times
            # a cluster
            assert p.bn == bm == 128
            assert p.gx == k * nbt ** 2 == k * (-(-d // 128)) ** 2


def test_dense_shared_memory_fits_a_hopper_block():
    """At most SMEM_LIMIT bytes for every 1 <= d <= 1024 and 1 <= K <= 8192
    (the bytes depend on d alone), two blocks' worth (with 1 KiB each
    reserved, of the SM's 228 KiB) above d = 16."""
    worst = 0
    for d in PLAN_DS:
        by_k = {dense_plan(1, d, k).smem for k in (1, 2, 5, 16, 64, 65, 300,
                                                   MAX_K)}
        assert len(by_k) == 1
        smem = by_k.pop()
        assert smem <= SMEM_LIMIT
        if d > 16:
            assert 2 * (smem + 1024) <= 228 * 1024
        worst = max(worst, smem)
    assert worst == 4 * (DENSE_STAGES * DENSE_P * (16 + 64)
                         + DENSE_P * DENSE_TILE // 16)


@pytest.mark.parametrize("n,d,k", [(1_000_000, 32, 32), (200_000, 128, 32),
                                   (100_000, 256, 32), (1003, 7, 5),
                                   (2000, 16, 16), (10_000, 32, 32),
                                   (1, 256, MAX_K), (2 ** 31 - 1, 1, 1),
                                   (2 ** 31 - 1, 64, 2112)])
def test_dense_chunks_are_a_function_of_the_shape(n, d, k):
    p = dense_plan(n, d, k)
    assert dense_plan(n, d, k) == p
    assert 1 <= p.nc <= 65535 and p.gx * p.nc < 2 ** 31
    # whole slabs, at least DENSE_MIN_SLABS, covering N with none empty
    # (the launcher refuses any other)
    assert p.chunk % DENSE_P == 0 and p.chunk >= DENSE_MIN_SLABS * DENSE_P
    assert (p.nc - 1) * p.chunk < n <= p.nc * p.chunk
    # a chunk's points, its first point and its slab count are ints in the
    # kernel; its end, p.nc * p.chunk, may pass 2^31 - 1 (the kernel takes
    # it in 64 bits and clamps it to n)
    assert p.chunk + DENSE_P - 1 < 2 ** 31 and (p.nc - 1) * p.chunk < 2 ** 31
    ends = [min(c * p.chunk + p.chunk, n) - c * p.chunk for c in range(p.nc)]
    assert sum(ends) == n and min(ends) > 0


def test_dense_chunks_fill_two_waves_at_the_smoke_shapes():
    """132 SMs, two blocks each: at least two waves where N allows, the
    last wave at least 90 % full."""
    for n, d, k in ((1_000_000, 32, 32), (200_000, 128, 32),
                    (100_000, 256, 32)):
        p = dense_plan(n, d, k)
        blocks = p.gx * p.nc
        waves = -(-blocks // 264)
        assert waves >= 2 and blocks / (waves * 264) >= 0.9


def test_matmul_column_tile_covers_n():
    tiles = (16, 32, 64)       # the launcher refuses any other
    for n in range(1, 300):
        bn = matmul_bn(n)
        assert bn in tiles
        assert -(-n // bn) * bn >= n
        if n <= 64:
            # one column tile, the least that holds N
            assert bn >= n and all(b < n for b in tiles if b < bn)


@pytest.mark.parametrize("d", [129, 160, 256, 257, 512, 1000])
@pytest.mark.parametrize("n", [1, 256, 8192, 400_000])
def test_panel_plan_covers_every_point_column_and_slot(n, d):
    for k in (1, 3, 8, 32, 33, 300):
        p = panel_plan(n, d, k)
        assert panel_plan(n, d, k) == p
        # the two point tiles the launchers hold, covering every row
        assert p.bm in PANEL_BM and p.tiles == -(-n // p.bm)
        assert (p.tiles - 1) * p.bm < n <= p.tiles * p.bm
        # column tiles cover d, the last one partly (zero past d)
        assert (p.nct - 1) * PANEL_BN < d <= p.nct * PANEL_BN
        # groups of per slots cover [0, K) once, in order, none empty
        groups = [range(g * p.per, min(k, (g + 1) * p.per))
                  for g in range(p.groups)]
        assert [s for r in groups for s in r] == list(range(k))
        assert all(len(r) > 0 for r in groups) and p.groups <= 65535
        # the shared ring: a slab of x (transposed, stride bm + 4), one of
        # F and the slab's means a stage, the same bytes at every d
        assert p.smem == 4 * PANEL_STAGES * PANEL_BK[p.bm] * (
            p.bm + 4 + PANEL_BN + 1)
        assert 2 * (p.smem + 1024) <= 228 * 1024
        if n == 8192:
            # a serving step's grid fills the 132 SMs
            assert p.tiles * p.groups >= 132
        if n >= 256 and k >= 32:
            assert p.tiles * p.groups >= 132


def test_panel_plan_refuses_counts_past_an_int():
    with pytest.raises(ValueError, match="ints in the kernel"):
        panel_plan(2 ** 31, 300, 4)
    with pytest.raises(ValueError, match="ints in the kernel"):
        panel_plan(10, 300, 0)


@pytest.mark.parametrize("d", [1, 3, 4, 8, 9, 16, 17, 31, 32, 33, 63, 64,
                               65, 100, 127, 128, 129, 200, 255, 256])
def test_stats_plan_covers_every_segment_row_and_column(d):
    """The segment fold's Gram teams (``stats_plan``): (edge / 8)^2 threads
    a team, 8 x 8 entries a thread at rows and columns 4 t + i and
    edge / 2 + 4 t + i of each of tiles x tiles edge-sized tiles, cover a
    segment's d x d sxx once, and the block's teams use all its threads."""
    for n in (1, 1023, 1025, 1_000_000):
        for k in (1, 2, 17, 64, 300, MAX_K):
            p = stats_plan(n, d, k)
            assert stats_plan(n, d, k) == p
            assert p.edge in GRAM_EDGES and p.nsb == -(-n // STATS_BLOCK)
            assert (p.nsb - 1) * STATS_BLOCK < n <= p.nsb * STATS_BLOCK
            tw = p.edge // 8
            assert p.teams * tw * tw == STATS_THREADS
            if d <= 64:
                assert p.tiles == 1 and p.edge >= d > p.edge // 2 - (
                    p.edge == 8) * 8
            else:
                assert p.edge == 128 and p.tiles == -(-d // 128)
            seen = {}
            for ta in range(p.tiles):
                for tb in range(p.tiles):
                    for ty in range(tw):
                        for tx in range(tw):
                            for i in range(8):
                                for j in range(8):
                                    a = ta * p.edge + 4 * ty + i % 4 + (
                                        i // 4) * (p.edge // 2)
                                    b = tb * p.edge + 4 * tx + j % 4 + (
                                        j // 4) * (p.edge // 2)
                                    if a < d and b < d:
                                        seen[a, b] = seen.get((a, b), 0) + 1
            assert len(seen) == d * d and set(seen.values()) == {1}
            # the blocks sharing a STATS_BLOCK take its (segment, tile)
            # items part mod splits, their teams in turn: each item once
            assert 1 <= p.splits <= STATS_SPLITS
            assert p.splits == 1 or (64 < d <= 128 or p.nsb < 264)
            if d > 128:
                # past d = 128 to one wave of 264 blocks only
                assert p.splits == min(4, -(-264 // p.nsb)) or (
                    p.nsb >= 264 and p.splits == 1)
            items = 2 * min(k, 17) * p.tiles ** 2
            taken = sorted(it for part in range(p.splits)
                           for team in range(p.teams)
                           for it in range(part + p.splits * team, items,
                                           p.splits * p.teams))
            assert taken == list(range(items))


def test_stats_plan_shared_memory_fits_a_hopper_block():
    """The fold's shared bytes: the block's segments, ids and weights and
    the 2k + 1 offsets, 2k cursors and the scan's warp totals; at most
    SMEM_LIMIT for every k the wrapper takes, whatever d and N, and two
    blocks' worth at the fits' k <= 1024."""
    for k in (1, 2, 17, 64, 300, 1024, 4096, MAX_K):
        by_shape = {stats_plan(n, d, k).smem for n in (1, 4097, 10 ** 6)
                    for d in PLAN_DS}
        assert len(by_shape) == 1
        smem = by_shape.pop()
        assert smem == 4 * (3 * STATS_BLOCK + 4 * k + 1 + SCAN_INTS)
        assert smem <= SMEM_LIMIT
        if k <= 1024:
            assert 2 * (smem + 1024) <= 228 * 1024


def test_stats_plan_refuses_counts_past_an_int():
    stats_plan(2 ** 31 - 1, 256, MAX_K)
    stats_plan(10, 1024, MAX_K)
    # a window's (segment, tile) items are an int in the kernel
    for n, d, k in ((2 ** 31, 32, 4), (0, 32, 4), (10, 0, 4),
                    (10, 50_000, MAX_K), (10, 32, 0), (10, 32, MAX_K + 1)):
        with pytest.raises(ValueError, match="suffstats_labels"):
            stats_plan(n, d, k)


GAUSS_PLAN_K = (1, 2, 5, 17, 32, 64, 300, 2049, 4097)


@pytest.mark.parametrize("d", [17, 32, 33, 64, 65, 128])
@pytest.mark.parametrize("n", [1, 256, 300, 8192, 100_003, 1_000_000])
def test_gauss_plan_gives_every_live_column_tile_one_group(n, d):
    """Above the narrow switch, ``assign_gauss`` / ``loglik_gauss`` run the
    register tile on TE_BM-point tiles x slot groups (``gauss_plan``). The
    card cuts the column tiles of the live slots among the groups from the
    live count it reads itself, and the slots' inactive draws by slot: for
    any live count <= K every column tile and every slot has exactly one
    group. A call launches the tile, and the fold with several groups."""
    for k in GAUSS_PLAN_K:
        p = gauss_plan(n, d, k)
        assert gauss_plan(n, d, k) == p
        assert p.dp == (32 if d <= 32 else 64 if d <= 64 else 128)
        sp = 128 // p.dp
        assert (p.tiles - 1) * TE_BM < n <= p.tiles * TE_BM
        assert 1 <= p.groups <= min(65535, -(-k // sp))
        for live in sorted({0, 1, k // 3, k // 2, k - 1, k}):
            nt = -(-live // sp)
            got = [t for g in range(p.groups)
                   for t in group_share(nt, p.groups, g)]
            assert got == list(range(nt))
        got = [s for g in range(p.groups) for s in group_share(k, p.groups,
                                                               g)]
        assert got == list(range(k))
        assert assign_gauss_launches(n, d, k) == (2 if p.groups > 1 else 1)


@pytest.mark.parametrize("d", [17, 32, 33, 64, 65, 128])
def test_gauss_plan_fills_the_card_at_the_serving_steps(d):
    """An 8192-row step has 64 point tiles; its slot groups take the grid
    to two blocks an SM of the 132 to within one group of point tiles
    (another group would start a second wave), wherever the column tiles
    allow. At the fits' states the point tiles fill the card alone: one
    group, one launch."""
    for k in (2, 5, 17, 32, 64, 300, 4097):
        p = gauss_plan(8192, d, k)
        nct = -(-k // (128 // p.dp))
        assert (p.tiles * p.groups > TE_BLOCKS - p.tiles
                or p.groups == nct), (k, p)
        assert p.tiles * p.groups <= TE_BLOCKS or p.groups <= nct
    for n, dd, k in ((1_000_000, 32, 64), (200_000, 128, 32),
                     (100_003, 33, 64), (33_792, 17, 4097)):
        assert gauss_plan(n, dd, k).groups == 1
        assert assign_gauss_launches(n, dd, k) == 1


def test_gauss_plan_shared_memory_fits_a_hopper_block():
    """The tile's shared bytes (x tile, ring, partials, warp counts, a list
    of at most TE_LIST live slots) stop growing at K = TE_LIST and fit two
    blocks an SM for every K the route takes."""
    for dp, d in ((32, 17), (64, 64), (128, 128)):
        sp, _, _, stage = te_layout(dp)
        fixed = 4 * (dp * (TE_BM + 4) + TE_STAGES * stage
                     + 2 * (sp + 2) * TE_BM + 32)
        for k in (1, 64, TE_LIST, TE_LIST + 1, 4097, 2 ** 31 - 1):
            p = gauss_plan(1, d, k)
            assert p.smem == fixed + 4 * min(k, TE_LIST)
            assert p.smem <= SMEM_LIMIT
            assert 2 * (p.smem + 1024) <= 228 * 1024


def test_gauss_plan_refuses_counts_past_an_int():
    gauss_plan(2 ** 31 - 1, 128, 2 ** 31 - 1)
    for n, d, k in ((2 ** 31, 32, 4), (0, 32, 4), (10, 0, 4),
                    (10, 129, 4), (10, 32, 0), (10, 32, 2 ** 31)):
        with pytest.raises(ValueError, match="ints in the kernel"):
            gauss_plan(n, d, k)


@pytest.mark.parametrize("switch", [GAUSS_NARROW_D, 0])
def test_gauss_plan_narrow_switch_both_sides(monkeypatch, switch):
    """At and below GAUSS_NARROW_D the narrow in-block layout (dp 0, one
    group, shared bytes sized by the launcher, one launch); above it the
    tile at d padded to 32. With the switch at 0 (the tile at every d, as
    the timing tool forces it) d = 1 takes the tile too."""
    monkeypatch.setattr(assign_mod, "GAUSS_NARROW_D", switch)
    gauss_plan.cache_clear()
    try:
        for n in (1, 8192, 1_000_000):
            for k in (1, 32, 4097):
                for d in range(1, 18):
                    p = gauss_plan(n, d, k)
                    if d <= switch:
                        assert p == (0, -(-n // TE_BM), 1, 0)
                        assert assign_gauss_launches(n, d, k) == 1
                    else:
                        assert p.dp == 32 and p.smem > 0
    finally:
        gauss_plan.cache_clear()


def _group_fold_labels(t, active, sp, groups):
    """The labels csrc/te_tile.cuh and fold_groups draw from logits t
    (N x K float32; an inactive slot's -1e30 or +inf): per group, each of
    the SP slot columns of its column tiles keeps a strict-`>` running max
    over its live slots in order from (-1e30, slot 0), two threads walk the
    group's share of the inactive slots (by parity), the block merges
    those partials by (max, least slot), and the fold merges the groups'
    rows the same way."""
    n, k = t.shape
    neg = np.float32(-1e30)
    live = [j for j in range(k) if active[j]]
    nt = -(-len(live) // sp)

    def walk(slots):
        b = np.full(n, neg, np.float32)
        lab = np.zeros(n, np.int64)
        for kk in slots:
            up = t[:, kk] > b
            b, lab = np.where(up, t[:, kk], b), np.where(up, kk, lab)
        return b, lab

    def merge(parts):
        b = np.full(n, neg, np.float32)
        lab = np.zeros(n, np.int64)
        for v, lv in parts:
            up = (v > b) | ((v == b) & (lv < lab))
            b, lab = np.where(up, v, b), np.where(up, lv, lab)
        return b, lab

    rows = []
    for g in range(groups):
        tiles = group_share(nt, groups, g)
        parts = [walk([live[tl * sp + s] for tl in tiles
                       if tl * sp + s < len(live)]) for s in range(sp)]
        share = group_share(k, groups, g)
        parts += [walk([kk for kk in share[h::2] if not active[kk]])
                  for h in (0, 1)]
        rows.append(merge(parts))
    return merge(rows)[1]


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("groups", [1, 2, 3, 5, 8])
def test_group_fold_is_the_first_argmax_in_slot_order(sp, groups):
    """The tile walks the live slots first and the inactive ones after,
    which is not slot order, so its partials and the groups' rows merge by
    (max, least slot): the first argmax over all slots in order, as one
    walk gives. Ties at -1e30 (inactive slots) go to the least slot, ties
    of live logits too, and a +inf top-bin draw wins (the first of two)."""
    rng = np.random.default_rng(sp * 10 + groups)
    n = 400
    for k in (1, 2, 5, 17, 33):
        for share in (0.0, 0.3, 0.7, 1.0):
            active = rng.random(k) < share
            t = rng.normal(size=(n, k)).astype(np.float32) * 3
            # exact ties between live slots
            t[:, k // 2] = t[:, 0] if k > 2 else t[:, k // 2]
            t[:, ~active] = np.float32(-1e30)
            inactive = np.flatnonzero(~active)
            if inactive.size:
                hit = rng.random((n, inactive.size)) < 0.02
                t[:, inactive] = np.where(hit, np.float32(np.inf),
                                          t[:, inactive])
            want = np.argmax(t, axis=1)
            got = _group_fold_labels(t, active, sp, groups)
            assert np.array_equal(got, want), (k, share)


def _te_threads(dp):
    """(tx, ty, slot s, place u) of each thread of sweep_assign_tiled<dp>."""
    tps = dp // 8
    return [(t % 16, t // 16, (t % 16) // tps, (t % 16) % tps)
            for t in range(TE_THREADS)]


@pytest.mark.parametrize("dp", [32, 64, 128])
def test_sweep_plan_tile_covers_every_point_slot_and_column(dp):
    """The tiled step (e)'s 8 x 8 register tiles cover the tile's TE_BM
    points x (128 / dp slots x dp columns) once; each (point, slot) has one
    owner thread; and the |y|^2 hops visit a slot's columns in the parent
    layout's order: c = 0..dp-1 (narrow), or 4 j + 16 t + q, t = 0..7, per
    lane j (wide)."""
    sp, fs, bk, _ = te_layout(dp)
    tps = dp // 8
    assert sp * tps == 16 and dp % bk == 0 and sp * fs <= 192
    seen, owners = {}, {}
    for tx, ty, s, u in _te_threads(dp):
        rows = [4 * ty + i for i in range(4)] + [
            TE_BM // 2 + 4 * ty + i for i in range(4)]
        cols = [4 * u + q for q in range(4)] + [
            dp // 2 + 4 * u + q for q in range(4)]
        for p in rows:
            for c in cols:
                seen[p, s, c] = seen.get((p, s, c), 0) + 1
        own = [i for i in range(8) if i % tps == u] if tps <= 8 else (
            [u] if u < 8 else [])
        for i in own:
            owners[rows[i], s] = owners.get((rows[i], s), 0) + 1
        # slab-row bytes of the thread's two float4 reads start on 16 bytes
        assert (s * fs + 4 * u) % 4 == 0
    assert len(seen) == TE_BM * sp * dp and set(seen.values()) == {1}
    assert len(owners) == TE_BM * sp and set(owners.values()) == {1}
    if dp < 128:
        # hop b: thread u = b % tps adds its half b // tps, columns 4b..4b+3
        order = []
        for b in range(2 * tps):
            u, h = b % tps, b // tps
            order += [4 * u + q + h * dp // 2 for q in range(4)]
        assert order == list(range(dp))
    else:
        # hop t of lane class j: thread j + 4 (t % 4), half t // 4
        for j in range(4):
            order = []
            for t in range(8):
                tx, h = j + 4 * (t % 4), t // 4
                order += [4 * tx + q + h * 64 for q in range(4)]
            assert order == [4 * j + 16 * t + q for t in range(8)
                             for q in range(4)]


def test_sweep_plan_routes_and_shared_memory():
    """d <= 16 keeps step (e) in the (f) + fold block (one launch a call);
    above, the tiled launch (two a call) covers every point with TE_BM-point blocks, and its shared
    bytes (the x tile, the ring, the partials, the warp counts and a list
    of at most TE_LIST live slots) fit a Hopper block for every d and K
    the wrapper takes, two blocks an SM."""
    for d in range(1, SWEEP_MAX_D + 1):
        for k in (1, 2, 17, 64, 300, SWEEP_MAX_K):
            for n in (1, 127, 128, 129, 4097, 1_000_000):
                p = sweep_plan(n, d, k)
                assert sweep_plan(n, d, k) == p
                assert p.nsb == -(-n // STATS_BLOCK)
                assert launches_per_call(d) == (2 if p.dp else 1)
                if d < TE_MIN_D:
                    assert p == (0, 0, 0, p.nsb)
                    continue
                assert p.dp == (32 if d <= 32 else 64 if d <= 64 else 128)
                assert (p.grid_e - 1) * TE_BM < n <= p.grid_e * TE_BM
                sp, fs, bk, stage = te_layout(p.dp)
                assert stage % 4 == 0 and stage >= bk * sp * fs + sp * (bk + 1)
                assert p.smem_e == 4 * (p.dp * (TE_BM + 4) + TE_STAGES * stage
                                        + 2 * (sp + 2) * TE_BM + 32
                                        + min(k, TE_LIST))
                assert p.smem_e <= SMEM_LIMIT
                assert 2 * (p.smem_e + 1024) <= 228 * 1024


def test_sweep_plan_refuses_counts_past_an_int():
    sweep_plan(2 ** 31 - 1, 128, SWEEP_MAX_K)
    for n, d, k in ((2 ** 31, 32, 4), (0, 32, 4), (10, 0, 4), (10, 129, 4),
                    (10, 32, 0), (10, 32, SWEEP_MAX_K + 1)):
        with pytest.raises(ValueError, match="sweep_gauss"):
            sweep_plan(n, d, k)


def _sub_items(labels, k, per):
    """The items of ``sub_assign_gauss``'s product as its count and place
    kernels leave them: (label, point ids) runs of at most ``per`` points,
    ceil(count / per) a label, labels in order."""
    inside = (labels >= 0) & (labels < k)
    counts = np.bincount(labels[inside], minlength=k)
    order = np.argsort(np.where(inside, labels, k), kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)])
    items = []
    for lab in range(k):
        for a in range(start[lab], start[lab + 1], per):
            items.append((lab, order[a:min(a + per, start[lab + 1])]))
    return items


@pytest.mark.parametrize("d", [1, 4, 5, 33, 64, 65, 128, 129, 200, 256])
def test_sub_plan_gives_every_point_one_owner(d):
    """Every point with a label in [0, K) lies in exactly one item of its
    own label and is one thread's (narrow) or one warp lane's (tiled);
    labels outside get sub-label 0 from the histogram kernel alone; the
    grid covers the items; the sort kernels cover every point once."""
    rng = np.random.default_rng(d)
    for n, k in ((1, 1), (1023, 300), (1025, 2), (4097, 17), (5000, 1)):
        labels = rng.integers(-1, k + 1, n)
        p = sub_plan(n, d, k)
        items = _sub_items(labels, k, p.per)
        assert len(items) <= p.grid
        owners = np.zeros(n, int)
        for lab, pts in items:
            assert 1 <= len(pts) <= p.per and (labels[pts] == lab).all()
            owners[pts] += 1
        inside = (labels >= 0) & (labels < k)
        assert (owners[inside] == 1).all() and (owners[~inside] == 0).all()
        # narrow: thread t of 256 takes point t of the item; tiled: lane
        # i < 8 of warp w (of 8) takes point 8 w + i
        assert p.per == (256 if d <= SUB_NARROW_D else 8 * 8)


@pytest.mark.parametrize("dp", [128, 256])
def test_sub_tiled_layout_keeps_the_parent_column_order(dp):
    """The tiled product's 32 lanes x 8 registers own each column of the
    pass's sub-factors (both at dp = 128, in a [F_0 | F_1] row) once, and
    a thread's registers are a run of one parent lane's |y|^2 chain, whose
    hops follow that lane's column order: at dp = 256 lane l's columns
    l + 32 t, t = 0..7, then the xor butterfly over lanes 1, 2, 4, 8, 16,
    which are the parent's lanes; at dp = 128 lane j's columns
    4 j + 16 t + q, t = 0..7, q = 0..3, through the four threads
    16 s + 4 j + h (h = 0..3) in order, then xor 4 and 8 over j, the
    parent's xor 1 and 2. At dp = 128 a thread's registers 0..3 and 4..7
    are two 16-byte runs of the row."""
    owned = [sub_col(dp, lane, k) for lane in range(32) for k in range(8)]
    assert sorted(owned) == list(range(SUB_COLS))
    chains = {}
    for lane in range(32):
        cols = [sub_col(dp, lane, k) for k in range(8)]
        if dp == 256:
            # the parent's lane l and its chain, in order
            assert cols == [lane + 32 * t for t in range(8)]
            continue
        s, j, h = lane // 16, (lane // 4) % 4, lane % 4
        for k0 in (0, 4):
            assert cols[k0] % 4 == 0
            assert cols[k0:k0 + 4] == [cols[k0] + q for q in range(4)]
        for k, c in enumerate(cols):
            assert c // 128 == s
            chains.setdefault((s, j), []).append((8 * h + k, c % 128))
    for (s, j), steps in chains.items():
        assert [c for _, c in sorted(steps)] == [
            4 * j + 16 * t + q for t in range(8) for q in range(4)]
    # the butterflies: the partner lanes' parent lanes
    for lane in range(32):
        if dp == 256:
            continue                   # lane l is the parent's lane l
        j = (lane // 4) % 4
        for off, poff in ((4, 1), (8, 2)):
            assert ((lane ^ off) // 4) % 4 == j ^ poff
            assert (lane ^ off) // 16 == lane // 16
            assert (lane ^ off) % 4 == lane % 4


def test_sub_plan_shared_memory_fits_a_hopper_block():
    """The product's shared bytes depend on d alone and fit a Hopper block
    for every d <= 1024 (two blocks an SM where tiled: past d = 256 the
    d = 256 layout, in column panels); the placement's fit for every
    window of K <= 8192; three launches a window."""
    assert SUB_LAUNCHES == 3
    for d in PLAN_DS:
        by_k = set()
        for k in (1, 17, 300, 2048, MAX_K):
            p = sub_plan(4097, d, k)
            by_k.add(p.smem)
            assert p.sort_smem == 4 * (3 * k + 34) <= SMEM_LIMIT
            assert p.dp >= min(d, 256) and (p.dp // 2 < d or p.dp == 4)
        assert len(by_k) == 1
        smem = by_k.pop()
        assert smem <= SMEM_LIMIT
        if d > SUB_NARROW_D:
            nx = 2 if d <= 128 else 1
            assert smem == 4 * SUB_STAGES * (SUB_BK * SUB_COLS
                                              + nx * SUB_BK * (SUB_XS + 1))
            assert 2 * (smem + 1024) <= 228 * 1024


def test_sub_plan_refuses_counts_past_an_int():
    sub_plan(2 ** 31 - 1, 256, MAX_K)
    sub_plan(10, 1024, MAX_K)
    for n, d, k in ((2 ** 31, 32, 4), (0, 32, 4), (10, 0, 4),
                    (10, 2 ** 31, 4), (10, 32, 0), (10, 32, MAX_K + 1)):
        with pytest.raises(ValueError, match="sub_assign_gauss"):
            sub_plan(n, d, k)


@pytest.mark.parametrize("n", [1, 1023, 1025, 11_314, 67_584, 100_003,
                               1_000_000])
def test_linear_plan_gives_every_point_slot_and_feature_one_owner(n):
    """Steps (e) + (f) take tiles of bm points (the largest of LE_BM that
    still gives LE_BLOCKS blocks, so 11,314 points fill the card); in a
    tile, thread (tx, ty) owns points ty + 32 i and chunk slots tx + 8 j,
    so every (point, active slot) pair has one owner over the chunks of
    LE_BK active slots; the fold's grid owns every (STATS_BLOCK, feature
    chunk) once."""
    for dp in (1, 3, 128, 129, 20_000):
        for k, na in ((1, 1), (17, 11), (64, 16), (300, 180), (2048, 2048)):
            p = linear_plan(n, dp, k)
            assert p.bm in LE_BM and p.bm % 32 == 0
            assert (p.grid_e - 1) * p.bm < n <= p.grid_e * p.bm
            bigger = [b for b in LE_BM if b > p.bm]
            assert all(-(-n // b) < LE_BLOCKS for b in bigger)
            if p.bm > LE_BM[-1]:
                assert p.grid_e >= LE_BLOCKS
            if n >= 11_314:
                assert p.grid_e >= 132
            owners = np.zeros((p.bm, na), int)
            for a0 in range(0, na, LE_BK):
                nac = min(LE_BK, na - a0)
                for t in range(LE_THREADS):
                    tx, ty = t % 8, t // 8
                    for i in range(p.bm // 32):
                        for j in range(8):
                            if tx + 8 * j < nac:
                                owners[ty + 32 * i, a0 + tx + 8 * j] += 1
            assert (owners == 1).all()
            assert p.nsb == -(-n // STATS_BLOCK)
            # the fold's feature chunks: chunk c owns [c fc, (c + 1) fc)
            chunks = -(-dp // p.fc)
            owned = np.zeros(dp, int)
            for c in range(chunks):
                owned[c * p.fc:min(dp, (c + 1) * p.fc)] += 1
            assert (owned == 1).all()
    assert LINEAR_LAUNCHES == 2


def test_linear_plan_shared_memory_fits_a_hopper_block():
    """Both launches' shared bytes fit a Hopper block for every K <= 2048
    and d' <= 65,536 (neither depends on d'); steps (e) + (f) two blocks an
    SM at the fits' K <= 64."""
    for n in (1, 11_314, 1_000_000):
        for k in (1, 2, 17, 64, 300, SWEEP_MAX_K):
            by_dp = {linear_plan(n, dp, k)[:3] + linear_plan(n, dp, k)[4:]
                     for dp in (1, 4, 129, 20_000, MAX_DP)}
            assert len(by_dp) == 1
            # step (f) a thread a (point, sub-cluster) up to d' = 64
            assert [linear_plan(n, dp, k).f_thread
                    for dp in (1, 64, 65, 20_000)] == [True, True, False,
                                                        False]
            p = linear_plan(n, 128, k)
            stages = LE_STAGES[p.bm]
            assert p.smem_e == 4 * (stages * (p.bm + LE_BK) * LE_FSTR
                                    + 2 * k + 33 + 7 * p.bm) <= SMEM_LIMIT
            # the ring holds a chunk's BM x (LE_BK + 1) logits
            assert stages * (p.bm + LE_BK) * LE_FSTR >= p.bm * (LE_BK + 1)
            assert p.smem_f == 4 * (3 * STATS_BLOCK + 6 * k + 33) \
                <= SMEM_LIMIT
            if k <= 64:
                # three blocks an SM at 128 points, two at 64
                blocks = 3 if p.bm == 128 else 2
                assert blocks * (p.smem_e + 1024) <= 228 * 1024


def test_linear_plan_refuses_counts_past_an_int():
    linear_plan(2 ** 31 - 1, MAX_DP, SWEEP_MAX_K)
    for n, dp, k in ((2 ** 31, 32, 4), (0, 32, 4), (10, 0, 4),
                     (10, MAX_DP + 1, 4), (10, 32, 0),
                     (10, 32, SWEEP_MAX_K + 1)):
        with pytest.raises(ValueError, match="sweep_linear"):
            linear_plan(n, dp, k)


def test_linear_lane_tree_stack_is_the_shuffle_down_tree():
    """Step (f) a thread a (point, sub-cluster) (``linear_plan`` f_thread)
    walks the 32 lane chains in bit-reversed leaf order and folds each
    finished pair on a five-deep stack (``csrc/linear_tile.cuh``
    lane_tree_sum); that gives lane 0 of the first version's shuffle-down
    tree (offsets 16, 8, 4, 2, 1), add for add."""
    lanes = [("v", i) for i in range(32)]
    for off in (16, 8, 4, 2, 1):
        lanes = [(lanes[i], lanes[i + off]) if i + off < 32 else lanes[i]
                 for i in range(32)]
    tree = lanes[0]
    stack = [None] * 5
    v = None
    for i in range(32):
        leaf = int(format(i, "05b")[::-1], 2)
        v = ("v", leaf)
        for lvl in range(5):
            if (i >> lvl) & 1 == 0:
                stack[lvl] = v
                break
            v = (stack[lvl], v)
    assert v == tree


@pytest.mark.parametrize("n", [1, 31, 33, 8192, 11_314, 33_793, 200_000,
                               1_000_000])
def test_linear_step_plans_give_every_point_and_slot_one_owner(n):
    """``assign_linear`` and ``sub_assign_linear`` run the sweep's tile on
    tiles of bm points (the largest of LT_BM that gives LE_BLOCKS blocks,
    else the smallest; step (f)'s warp route 256 where that gives
    LF_BM256_BLOCKS), every point in one tile; step (e) walks slot
    windows of at most LT_WIN, every slot in one, so every (point, slot)
    pair has one owner."""
    for plan in (assign_mod.linear_assign_plan,
                 assign_mod.linear_sub_plan):
        for dp in (1, 32, 33, 64, 65, 20_000):
            p = plan(n, dp, 17)
            assert (p.grid - 1) * p.bm < n <= p.grid * p.bm
            wide = (plan is assign_mod.linear_sub_plan and not p.f_thread
                    and -(-n // 256) >= assign_mod.LF_BM256_BLOCKS)
            assert (p.bm == 256) == wide
            if not wide:
                assert p.bm in assign_mod.LT_BM
                assert all(-(-n // b) < LE_BLOCKS
                           for b in assign_mod.LT_BM if b > p.bm)
            if n >= 8192:
                assert p.grid >= 256
    for k in (1, 17, 2048, 2049, 4096, 10_000):
        wins = assign_mod.linear_windows(k)
        assert [s for w in wins for s in w] == list(range(k))
        assert all(len(w) <= assign_mod.LT_WIN for w in wins)


def test_linear_step_plans_shared_memory_fits_a_hopper_block():
    """Shared bytes fit a Hopper block at K up to 10,000 and d' up to
    65,536: step (e)'s lists stop at one slot window, step (f) holds five
    words a point; neither grows with d'. The ring holds a chunk's logits,
    and the tiles of 32 points run three blocks an SM."""
    for n in (1, 8192, 11_314, 1_000_000):
        for k in (1, 17, 2048, 2049, 4096, 10_000):
            for plan, dps in (
                    (assign_mod.linear_assign_plan,
                     (1, 4, 129, 20_000, MAX_DP)),
                    (assign_mod.linear_sub_plan, (1, 4, 32)),
                    (assign_mod.linear_sub_plan, (33, 129, 20_000, MAX_DP))):
                assert len({plan(n, dp, k) for dp in dps}) == 1
            e = assign_mod.linear_assign_plan(n, 128, k)
            f = assign_mod.linear_sub_plan(n, 128, k)
            assert e.stages == assign_mod.LT_STAGES[e.bm]
            assert e.smem == 4 * (e.stages * (e.bm + LE_BK) * LE_FSTR
                                  + 3 * e.bm + 2 * min(k, 2048) + 33)
            assert e.smem <= SMEM_LIMIT and f.smem == 20 * f.bm
            assert e.stages * (e.bm + LE_BK) * LE_FSTR >= e.bm * (LE_BK + 1)
            assert 3 * (e.smem + 1024) <= 228 * 1024
            assert [assign_mod.linear_sub_plan(n, dp, k).f_thread
                    for dp in (1, 32, 33, 20_000)] == [True, True, False,
                                                        False]
            # the one-read sweep's bytes are the same function's
            if k <= SWEEP_MAX_K:
                sw = linear_plan(n, 128, k)
                assert sw.smem_e == assign_mod.lt_smem(
                    True, True, sw.bm, LE_STAGES[sw.bm], k)


def test_linear_step_plans_refuse_counts_past_an_int():
    for plan in (assign_mod.linear_assign_plan,
                 assign_mod.linear_sub_plan):
        plan(2 ** 31 - 1, MAX_DP, 2 ** 31 - 1)
        for n, dp, k in ((2 ** 31, 32, 4), (0, 32, 4), (10, 0, 4),
                         (10, MAX_DP + 1, 4), (10, 32, 0),
                         (10, 32, 2 ** 31)):
            with pytest.raises(ValueError, match="assign_linear"):
                plan(n, dp, k)


def _c_signature(src: str, symbol: str) -> str:
    """One letter a parameter of ``extern "C" int symbol(...)`` in ``src``:
    ``p`` a pointer, ``i`` an int, ``l`` a 64-bit int."""
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert m, symbol
    out = ""
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        out += ("p" if "*" in param else "l" if "long long" in param
                else "i" if param.startswith("int ") else "?")
    return out


def test_wrapper_signatures_are_the_launchers():
    """Every ``build.c_function`` of the kernel wrappers gives the
    launcher's own parameters, one letter each, the stream the last: a
    wrong letter would hand a pointer over as a 32-bit int."""
    kernels = Path(assign_mod.__file__).parent
    csrc = kernels.parent / "csrc"
    calls = []
    for py in sorted(kernels.glob("*.py")):
        text = py.read_text()
        for m in re.finditer(r'c_function\(\s*"(\w+)",\s*"(\w+)",'
                             r'([^)]*)\)', text):
            # the signature: string literals joined by + and *
            sig = eval(m.group(3).strip(), {"__builtins__": {}})
            calls.append((m.group(1), m.group(2), sig))
    assert len(calls) == 14
    for name, symbol, sig in calls:
        want = _c_signature((csrc / f"{name}.cu").read_text(), symbol)
        assert sig == want, (name, symbol, sig, want)
