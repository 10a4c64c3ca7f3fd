"""Shape-only choices of the dense ``suffstats`` kernel, the ``matmul``
kernel, the panel layout of ``assign_gauss`` / ``loglik_gauss`` past
d = 128, the segment fold of ``suffstats_labels`` / ``sweep_gauss`` and
the tiled step (e) of ``sweep_gauss`` (``kernels/suffstats.py``
``dense_plan`` and ``stats_plan``, ``kernels/matmul.py`` ``matmul_bn``,
``kernels/assign.py`` ``panel_plan``, ``kernels/sweep.py``
``sweep_plan``), checked on the CPU: the kernels themselves run only on the
card (``tests/test_torch_cuda.py``), and their launchers take these
choices as given, refusing a tile they do not hold."""
import pytest

from repro_torch.kernels.assign import (PANEL_BK, PANEL_BM, PANEL_BN,
                                        PANEL_STAGES, panel_plan)
from repro_torch.kernels.matmul import matmul_bn
from repro_torch.kernels.suffstats import (DENSE_BN, DENSE_MIN_SLABS,
                                           DENSE_P, DENSE_STAGES, DENSE_TILE,
                                           GRAM_EDGES, MAX_D, MAX_K,
                                           SCAN_INTS, SMEM_LIMIT,
                                           STATS_BLOCK, STATS_SPLITS,
                                           STATS_THREADS,
                                           dense_plan, stats_plan)
from repro_torch.kernels.sweep import MAX_D as SWEEP_MAX_D
from repro_torch.kernels.sweep import MAX_K as SWEEP_MAX_K
from repro_torch.kernels.sweep import (TE_BM, TE_MIN_D, TE_STAGES,
                                       TE_THREADS, launches_per_call,
                                       sweep_plan, te_layout)


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
    """At most SMEM_LIMIT bytes for every 1 <= d <= 256 and 1 <= K <= 8192
    (the bytes depend on d alone), two blocks' worth (with 1 KiB each
    reserved, of the SM's 228 KiB) above d = 16."""
    worst = 0
    for d in range(1, MAX_D + 1):
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
            assert p.splits == 1 or (d <= 128 and (d > 64 or p.nsb < 264))
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
                    for d in range(1, MAX_D + 1)}
        assert len(by_shape) == 1
        smem = by_shape.pop()
        assert smem == 4 * (3 * STATS_BLOCK + 4 * k + 1 + SCAN_INTS)
        assert smem <= SMEM_LIMIT
        if k <= 1024:
            assert 2 * (smem + 1024) <= 228 * 1024


def test_stats_plan_refuses_counts_past_an_int():
    stats_plan(2 ** 31 - 1, 256, MAX_K)
    for n, d, k in ((2 ** 31, 32, 4), (0, 32, 4), (10, 0, 4), (10, 257, 4),
                    (10, 32, 0), (10, 32, MAX_K + 1)):
        with pytest.raises(ValueError, match="suffstats_labels"):
            stats_plan(n, d, k)


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
    bytes (the x tile, the ring, the partials, two K-int lists) fit a
    Hopper block for every d and K the wrapper takes, two blocks an SM at
    the fits' K <= 64."""
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
                                        + 2 * (sp + 2) * TE_BM + 32 + 2 * k)
                assert p.smem_e <= SMEM_LIMIT
                if k <= 64:
                    assert 2 * (p.smem_e + 1024) <= 228 * 1024


def test_sweep_plan_refuses_counts_past_an_int():
    sweep_plan(2 ** 31 - 1, 128, SWEEP_MAX_K)
    for n, d, k in ((2 ** 31, 32, 4), (0, 32, 4), (10, 0, 4), (10, 129, 4),
                    (10, 32, 0), (10, 32, SWEEP_MAX_K + 1)):
        with pytest.raises(ValueError, match="sweep_gauss"):
            sweep_plan(n, d, k)
