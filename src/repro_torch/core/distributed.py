"""Point layout of the streamed data plane.

Port of ``repro.core.distributed.tile_plan`` for one data shard (one
device, one process), and of ``repro.dist.coordinator.shard_ranges``, the
row ranges of a multi-process fit's workers (``repro_torch.dist``). The
rest of the reference module (meshes, sharded points and features,
collectives across cards) is queued in ROADMAP.md §1 item 6.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.kernels.suffstats import STATS_BLOCK

# Rows of a tile when ``DPMMConfig.tile_size`` is None: 64 fold blocks.
DEFAULT_TILE_BLOCKS = 64


def tile_plan(n: int, tile_size: Optional[int]
              ) -> Tuple[int, List[Tuple[int, int]]]:
    """``(n_local, [(offset, length), ...])`` for ``n`` points on one
    shard: tiles at STATS_BLOCK-aligned offsets, ``tile_size`` rounded up
    to the alignment (``None``: DEFAULT_TILE_BLOCKS blocks) and cut to
    ``n``; only the last tile may be ragged. The alignment keeps the stat
    fold's float additions the same at every tile size, so tiled chains
    are the resident chain bit for bit."""
    if tile_size is None:
        tile_size = DEFAULT_TILE_BLOCKS * STATS_BLOCK
    tile = -(-tile_size // STATS_BLOCK) * STATS_BLOCK
    tile = min(tile, n)
    return n, [(off, min(tile, n - off)) for off in range(0, n, tile)]


def shard_ranges(n: int, workers: int, stats_block: int = STATS_BLOCK
                 ) -> List[Tuple[int, int, int]]:
    """Static contiguous row ranges, one per worker slot, cut on the
    stat-block grid so every block is computed whole by exactly one
    worker: ``[(lo, hi, preferred_slot), ...]`` sorted by ``lo`` (the
    global fold order), covering ``[0, n)``. Slots past the blocks get no
    range and serve as failover capacity."""
    nb = -(-n // stats_block)
    per = -(-nb // workers)
    ranges = []
    for w in range(workers):
        lo = min(w * per * stats_block, n)
        hi = min((w + 1) * per * stats_block, n)
        if lo < hi:
            ranges.append((lo, hi, w))
    return ranges
