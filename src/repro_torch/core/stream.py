"""Tile transfer of the streamed (out-of-core) fit.

The port's counterpart of the reference tiled fit's double-buffered
``jax.device_put`` (``repro.core.sampler.DPMM._fit_tiled``: ``stream``,
``put_x_tile``, ``write_back``). ``TileStream.run`` walks a tile plan
once, calling a pass function on each tile on the device, and keeps the
host's label arrays up to date. A fit of C chains (``chains``) reads and
uploads each tile once a pass for all of them: the host label arrays are
(C, n), a tile carries (C, length) labels, and the pass function returns
one (labels, sublabels) pair a chain.

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

Each slot's pinned and device label buffers hold all C chains' labels and
sub-labels of a tile (2 C rows, laid out per tile), and each event covers
all of them: a slot is refilled only after every chain's copy has landed.

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
    and ``sublabels`` ((C, length), a row a chain) are the host arrays'
    rows when the pass asked for them, else None."""
    off: int
    length: int
    x: torch.Tensor
    labels: Optional[torch.Tensor]
    sublabels: Optional[torch.Tensor]


# pass_fn(tile, acc) -> ([(labels, sublabels) of each chain] or None, acc)
PassFn = Callable[[Tile, object],
                  Tuple[Optional[List[Tuple[torch.Tensor, torch.Tensor]]],
                        object]]


class TileStream:
    """Streams ``source``'s rows in ``tiles`` ((offset, length) pairs) to
    ``device`` for any number of passes, with the labels of ``chains``
    chains."""

    def __init__(self, source, tiles: Sequence[Tuple[int, int]], device,
                 policy: RetryPolicy, on_event: Callable[[dict], None],
                 chains: int = 1):
        self.source, self.tiles = source, list(tiles)
        self.chains = chains
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
        lab = 2 * chains * rows
        self._host_lab = [pinned((lab,), i32) for _ in range(2)]
        self._host_out = [pinned((lab,), i32) for _ in range(2)]
        self._dev_x = [on_dev((rows, d), f32) for _ in range(2)]
        self._dev_lab = [on_dev((lab,), i32) for _ in range(2)]
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
                lab = torch.from_numpy(labels_h[:, off:off + length].copy())
                sub = torch.from_numpy(
                    sublabels_h[:, off:off + length].copy())
            if not rows.flags.writeable:          # a memory-mapped source's rows
                rows = rows.copy()
            return Tile(off, length, torch.from_numpy(rows), lab, sub)
        s = i % 2
        t1 = time.perf_counter()
        self._copied[s].synchronize()         # the pinned buffers are free
        t2 = time.perf_counter()
        self._host_x[s][:length].numpy()[...] = rows
        c, m = self.chains, 2 * self.chains * length
        if labels_h is not None:
            host_lab = self._host_lab[s][:m].numpy().reshape(2 * c, length)
            host_lab[:c] = labels_h[:, off:off + length]
            host_lab[c:] = sublabels_h[:, off:off + length]
        self.read_s += (t1 - t0) + (time.perf_counter() - t2)
        cs = self._copy_stream
        cs.wait_event(self._freed[s])         # the device buffers are free
        with torch.cuda.stream(cs):
            self._dev_x[s][:length].copy_(self._host_x[s][:length],
                                          non_blocking=True)
            if labels_h is not None:
                self._dev_lab[s][:m].copy_(self._host_lab[s][:m],
                                           non_blocking=True)
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
            c = self.chains
            rows = self._dev_lab[s][:2 * c * length].view(2 * c, length)
            lab, sub = rows[:c], rows[c:]
        return Tile(off, length, self._dev_x[s][:length], lab, sub), (w0, w1)

    def run(self, pass_fn: PassFn, acc, labels_h: np.ndarray,
            sublabels_h: np.ndarray, labels_in: bool):
        """One pass over every tile: ``pass_fn(tile, acc)`` on each in
        order, the tile's labels uploaded when ``labels_in``, the labels it
        returns written back into ``labels_h`` / ``sublabels_h`` ((C, n)
        arrays). Returns the final ``acc``."""
        lab_src = (labels_h, sublabels_h) if labels_in else (None, None)
        if not self.cuda:
            for i in range(len(self.tiles)):
                tile = self._load(i, *lab_src)
                out, acc = pass_fn(tile, acc)
                if out is not None:
                    sl = slice(tile.off, tile.off + tile.length)
                    for c, (lab, sub) in enumerate(out):
                        labels_h[c, sl] = lab.numpy()
                        sublabels_h[c, sl] = sub.numpy()
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
            if out is not None:
                c = self.chains
                rows = self._host_out[s][:2 * c * length].view(2 * c, length)
                for j, (lab, sub) in enumerate(out):
                    rows[j].copy_(lab, non_blocking=True)
                    rows[c + j].copy_(sub, non_blocking=True)
                self._returned[s].record(main)
            # after the copies out: a chain's returned labels may be a view
            # of the tile's uploaded ones
            self._freed[s].record(main)
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
        c = self.chains
        out = self._host_out[s][:2 * c * length].numpy().reshape(2 * c,
                                                                 length)
        labels_h[:, off:off + length] = out[:c]
        sublabels_h[:, off:off + length] = out[c:]
