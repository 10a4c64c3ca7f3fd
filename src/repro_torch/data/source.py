"""DataSource: where points live, decoupled from how the sampler sees them.

The port's copy of ``repro.data.source`` (numpy only; the port never
imports the JAX package). Its ``DPMM.fit`` streams a ``HostTiledSource``
through pinned host buffers and a side CUDA stream in place of the
reference's double-buffered ``jax.device_put``.

The paper's scaling claim (§4.3-4.5) is that only O(K·T) sufficient
statistics need to be globally visible per step — the points themselves
never have to fit in accelerator memory. A ``DataSource`` is the sampler's
window onto the points:

 - ``ResidentSource`` — the whole (N, d) float32 array, zero-copy when the
   input already is one. The fast path: ``DPMM.fit`` copies it to the
   device once and runs every iteration there.
 - ``HostTiledSource`` — host-RAM or disk (np.memmap) backed points served
   as contiguous float32 row blocks. ``DPMM.fit`` streams them tile by
   tile; device memory is O(K_max + tile_size), so N is bounded by host
   storage, not device memory.

Both serve rows through the same ``read_block`` contract (rows past N are
zero padding, the padded layout of a sharded plane) and compute the prior's column mean with the same streamed
float64 pass — so resident and tiled fits see bitwise-identical inputs
everywhere and produce bitwise-identical chains.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

# Row-block size for host-side streaming passes (column mean). Fixed so the
# float64 partial-sum order — and the resulting prior — is identical no
# matter which source type serves the data.
_MEAN_BLOCK = 65_536


class DataSource:
    """Protocol: (n, d) float32 points served as contiguous row blocks."""

    n: int
    d: int

    def read_block(self, start: int, stop: int) -> np.ndarray:
        """(stop - start, d) float32 rows; rows at index >= n are zeros
        (the padded tail of the sharded layout)."""
        raise NotImplementedError

    def resident(self) -> Optional[np.ndarray]:
        """The full (n, d) float32 array if cheaply available (already in
        host RAM), else None — the fit then streams tiles."""
        return None

    def column_mean(self) -> np.ndarray:
        """(d,) float32 column mean — the prior's data-dependent part
        (e.g. the NIW/NIG location). Streamed in fixed blocks with float64
        partial sums so every source type produces the same bits."""
        if getattr(self, "_column_mean", None) is None:
            total = np.zeros((self.d,), np.float64)
            for start in range(0, self.n, _MEAN_BLOCK):
                block = self.read_block(start, min(start + _MEAN_BLOCK,
                                                   self.n))
                total += block.astype(np.float64).sum(axis=0)
            self._column_mean = (total / max(self.n, 1)).astype(np.float32)
        return self._column_mean


class ResidentSource(DataSource):
    """Points already materialized in host RAM; the zero-copy fast path."""

    def __init__(self, x: np.ndarray):
        x = np.asarray(x)
        if x.ndim != 2:
            raise ValueError(f"expected (N, d) points, got shape {x.shape}")
        self._x = x.astype(np.float32, copy=False)
        self.n, self.d = self._x.shape

    def resident(self) -> np.ndarray:
        return self._x

    def read_block(self, start: int, stop: int) -> np.ndarray:
        return _padded_rows(self._x, start, stop)


class HostTiledSource(DataSource):
    """Host/disk-backed points streamed tile-by-tile (out-of-core plane).

    ``x`` may be any 2-D array-like that supports row slicing without
    loading everything — typically an ``np.memmap`` (see ``from_npy``) —
    or a plain ndarray kept host-side on purpose (e.g. to bound device
    memory, or to test tiled-vs-resident parity).
    """

    def __init__(self, x):
        if getattr(x, "ndim", None) != 2:
            raise ValueError("HostTiledSource expects a 2-D row-sliceable "
                             f"array, got {type(x).__name__}")
        self._x = x
        self.n, self.d = int(x.shape[0]), int(x.shape[1])

    @classmethod
    def from_npy(cls, path: str) -> "HostTiledSource":
        """Memory-map an .npy file: N is bounded by disk, not RAM."""
        return cls(np.load(path, mmap_mode="r"))

    def read_block(self, start: int, stop: int) -> np.ndarray:
        return _padded_rows(self._x, start, stop)


def _padded_rows(x, start: int, stop: int) -> np.ndarray:
    """Rows [start, stop) of the zero-padded layout, cast to float32."""
    n = x.shape[0]
    lo, hi = min(start, n), min(stop, n)
    block = np.asarray(x[lo:hi], dtype=np.float32)
    if stop > n:
        block = np.concatenate(
            [block, np.zeros((stop - start - (hi - lo), x.shape[1]),
                             np.float32)], axis=0)
    return block


def as_source(x: Union[np.ndarray, DataSource]) -> DataSource:
    """np.ndarray -> ResidentSource; DataSource instances pass through."""
    if isinstance(x, DataSource):
        return x
    return ResidentSource(np.asarray(x))
