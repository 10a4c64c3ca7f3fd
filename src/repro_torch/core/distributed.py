"""Point layout of the streamed data plane.

Port of ``repro.core.distributed.tile_plan`` for one data shard (one
device, one process). The rest of that module (meshes, sharded points,
collectives) waits for the multi-GPU slice (ROADMAP.md §1 item 11).
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
