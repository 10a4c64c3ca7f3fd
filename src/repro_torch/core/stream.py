"""Tile transfer of the streamed (out-of-core) fit.

The port's counterpart of the reference tiled fit's double-buffered
``jax.device_put`` (``repro.core.sampler.DPMM._fit_tiled``: ``stream``,
``put_x_tile``, ``write_back``). ``TileStream.run`` walks a tile plan
once, calling a pass function on each tile on the device, and keeps the
host's label arrays up to date.

On a CUDA device it double-buffers: tile i + 1 is read from the source
(through ``read_block_checked``) into a pinned host buffer and copied to
the card on a side stream while tile i computes on the current stream.
Three hazards, each guarded by an event per buffer slot:

- a pinned buffer is refilled only after its previous copy to the card
  has finished (``_copied``, waited on by the host);
- a device buffer is overwritten only after the kernels that read the
  previous tile in it have run (``_freed``, waited on by the side stream);
- a tile's labels are written back to the host arrays only after the
  kernels that made them and their copy to pinned memory have finished
  (``_returned``, waited on by the host one tile later, so the wait
  overlaps the next tile's compute).

``wait_s`` sums the device time the compute stream stood waiting for a
tile's copy (CUDA events around the wait); ``read_s`` the host time in
the source's reads (with their finite-value guard) and, on the card, in
staging the rows and labels in pinned memory. On the CPU the tiles are
plain tensors over the read rows, one at a time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.resilience import RetryPolicy, read_block_checked


@dataclasses.dataclass
class Tile:
    """One tile on the device: rows ``off`` to ``off + length``. ``labels``
    and ``sublabels`` are the host arrays' rows when the pass asked for
    them, else None."""
    off: int
    length: int
    x: torch.Tensor
    labels: Optional[torch.Tensor]
    sublabels: Optional[torch.Tensor]


# pass_fn(tile, acc) -> ((labels, sublabels) of the tile or None, acc)
PassFn = Callable[[Tile, object], Tuple[Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]],
                                        object]]


class TileStream:
    """Streams ``source``'s rows in ``tiles`` ((offset, length) pairs) to
    ``device`` for any number of passes."""

    def __init__(self, source, tiles: Sequence[Tuple[int, int]], device,
                 policy: RetryPolicy, on_event: Callable[[dict], None]):
        self.source, self.tiles = source, list(tiles)
        self.device = torch.device(device)
        self.policy, self.on_event = policy, on_event
        self.cuda = self.device.type == "cuda"
        self.wait_s = 0.0
        self.read_s = 0.0
        if not self.cuda:
            return
        rows, d = max(length for _, length in self.tiles), source.d
        pinned = lambda shape, dt: torch.empty(shape, dtype=dt,
                                               pin_memory=True)
        on_dev = lambda shape, dt: torch.empty(shape, dtype=dt,
                                               device=self.device)
        f32, i32 = torch.float32, torch.int32
        self._host_x = [pinned((rows, d), f32) for _ in range(2)]
        self._host_lab = [pinned((2, rows), i32) for _ in range(2)]
        self._host_out = [pinned((2, rows), i32) for _ in range(2)]
        self._dev_x = [on_dev((rows, d), f32) for _ in range(2)]
        self._dev_lab = [on_dev((2, rows), i32) for _ in range(2)]
        self._copy_stream = torch.cuda.Stream(self.device)
        self._copied = [torch.cuda.Event() for _ in range(2)]
        self._freed = [torch.cuda.Event() for _ in range(2)]
        self._returned = [torch.cuda.Event() for _ in range(2)]

    def _load(self, i: int, labels_h, sublabels_h) -> Optional[Tile]:
        """Read tile i and start its copy to the device (CUDA: into slot
        i % 2, on the side stream). On the CPU returns the tile."""
        off, length = self.tiles[i]
        t0 = time.perf_counter()
        rows = read_block_checked(self.source, off, off + length,
                                  self.policy, on_event=self.on_event)
        if not self.cuda:
            self.read_s += time.perf_counter() - t0
            lab = sub = None
            if labels_h is not None:
                lab = torch.from_numpy(labels_h[off:off + length].copy())
                sub = torch.from_numpy(sublabels_h[off:off + length].copy())
            if not rows.flags.writeable:          # a memory-mapped source's rows
                rows = rows.copy()
            return Tile(off, length, torch.from_numpy(rows), lab, sub)
        s = i % 2
        t1 = time.perf_counter()
        self._copied[s].synchronize()         # the pinned buffers are free
        t2 = time.perf_counter()
        self._host_x[s][:length].numpy()[...] = rows
        if labels_h is not None:
            host_lab = self._host_lab[s].numpy()
            host_lab[0, :length] = labels_h[off:off + length]
            host_lab[1, :length] = sublabels_h[off:off + length]
        self.read_s += (t1 - t0) + (time.perf_counter() - t2)
        cs = self._copy_stream
        cs.wait_event(self._freed[s])         # the device buffers are free
        with torch.cuda.stream(cs):
            self._dev_x[s][:length].copy_(self._host_x[s][:length],
                                          non_blocking=True)
            if labels_h is not None:
                self._dev_lab[s][:, :length].copy_(
                    self._host_lab[s][:, :length], non_blocking=True)
        self._copied[s].record(cs)
        return None

    def _take(self, i: int, with_labels: bool) -> Tuple[Tile, tuple]:
        """Tile i on the current stream, after its copy; returns the tile
        and the timing events around the wait."""
        off, length = self.tiles[i]
        s = i % 2
        main = torch.cuda.current_stream(self.device)
        w0 = torch.cuda.Event(enable_timing=True)
        w1 = torch.cuda.Event(enable_timing=True)
        w0.record(main)
        main.wait_event(self._copied[s])
        w1.record(main)
        lab = sub = None
        if with_labels:
            lab = self._dev_lab[s][0, :length]
            sub = self._dev_lab[s][1, :length]
        return Tile(off, length, self._dev_x[s][:length], lab, sub), (w0, w1)

    def run(self, pass_fn: PassFn, acc, labels_h: np.ndarray,
            sublabels_h: np.ndarray, labels_in: bool):
        """One pass over every tile: ``pass_fn(tile, acc)`` on each in
        order, the tile's labels uploaded when ``labels_in``, the labels it
        returns written back into ``labels_h`` / ``sublabels_h``. Returns
        the final ``acc``."""
        lab_src = (labels_h, sublabels_h) if labels_in else (None, None)
        if not self.cuda:
            for i in range(len(self.tiles)):
                tile = self._load(i, *lab_src)
                out, acc = pass_fn(tile, acc)
                if out is not None:
                    sl = slice(tile.off, tile.off + tile.length)
                    labels_h[sl] = out[0].numpy()
                    sublabels_h[sl] = out[1].numpy()
            return acc
        main = torch.cuda.current_stream(self.device)
        waits: List[tuple] = []
        pending = None                  # (slot, off, length) to write back
        self._load(0, *lab_src)
        for i, (off, length) in enumerate(self.tiles):
            s = i % 2
            tile, w = self._take(i, labels_in)
            waits.append(w)
            out, acc = pass_fn(tile, acc)
            self._freed[s].record(main)
            if out is not None:
                self._host_out[s][0, :length].copy_(out[0], non_blocking=True)
                self._host_out[s][1, :length].copy_(out[1], non_blocking=True)
                self._returned[s].record(main)
            if i + 1 < len(self.tiles):
                self._load(i + 1, *lab_src)   # overlaps tile i's kernels
            if pending is not None:
                self._write_back(pending, labels_h, sublabels_h)
            pending = (s, off, length) if out is not None else None
        if pending is not None:
            self._write_back(pending, labels_h, sublabels_h)
        waits[-1][1].synchronize()
        self.wait_s += 1e-3 * sum(a.elapsed_time(b) for a, b in waits)
        return acc

    def _write_back(self, pending, labels_h, sublabels_h) -> None:
        s, off, length = pending
        self._returned[s].synchronize()
        out = self._host_out[s].numpy()
        labels_h[off:off + length] = out[0, :length]
        sublabels_h[off:off + length] = out[1, :length]
