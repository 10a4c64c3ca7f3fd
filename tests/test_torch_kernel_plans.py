"""Shape-only choices of the dense ``suffstats`` kernel, the ``matmul``
kernel and the panel layout of ``assign_gauss`` / ``loglik_gauss`` past
d = 128 (``kernels/suffstats.py`` ``dense_plan``, ``kernels/matmul.py``
``matmul_bn``, ``kernels/assign.py`` ``panel_plan``), checked on the CPU: the kernels themselves run only on the
card (``tests/test_torch_cuda.py``), and their launchers take these
choices as given, refusing a tile they do not hold."""
import pytest

from repro_torch.kernels.assign import (PANEL_BK, PANEL_BM, PANEL_BN,
                                        PANEL_STAGES, panel_plan)
from repro_torch.kernels.matmul import matmul_bn
from repro_torch.kernels.suffstats import (DENSE_BN, DENSE_MIN_SLABS,
                                           DENSE_P, DENSE_STAGES, DENSE_TILE,
                                           MAX_D, MAX_K, SMEM_LIMIT,
                                           dense_plan)


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
