"""Left-to-right fold of per-STATS_BLOCK statistic partials.

The port's counterpart of the reference's partial fold
(``repro.core.family``: the ``lax.scan`` of adds over the megakernels'
partials, and ``fold_blocked``'s per-block adds): for an accumulator
``acc`` of any shape S and partials (nb, *S),

    out = (((acc + parts[0]) + parts[1]) + ...) + parts[nb - 1]

in block order, so a tiled fit, whose accumulator carries the sum from
one tile to the next, gives the resident fit's bits at every
STATS_BLOCK-aligned tile size. A reduction over the block axis followed by
one add (``acc + parts.sum(0)``) rounds differently.

Two versions of one function:

- ``fold_partials_cuda``: the hand-written kernel ``csrc/fold_partials.cu``
  (one thread per element, blocks in order); one launch per call, counted
  in ``fold_partials_cuda.launches``;
- ``fold_partials_plain``: the same adds as a loop over the blocks. Float
  addition is exact IEEE rounding on both, so the two give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import launch


def fold_partials_plain(acc: torch.Tensor,
                        parts: torch.Tensor) -> torch.Tensor:
    out = acc.clone()
    for p in parts:
        out = out + p
    return out


def fold_partials_cuda(acc: torch.Tensor,
                       parts: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/fold_partials.cu`` on the current stream."""
    if acc.device.type != "cuda":
        raise ValueError("fold_partials_cuda takes CUDA tensors; the plain "
                         "version serves the CPU")
    if parts.device != acc.device:
        raise ValueError(f"parts is on {parts.device}, expected "
                         f"{acc.device}")
    if acc.dtype != torch.float32 or parts.dtype != torch.float32:
        raise TypeError(f"fold_partials takes float32, got {acc.dtype} and "
                        f"{parts.dtype}")
    if tuple(parts.shape[1:]) != tuple(acc.shape) or parts.ndim < 1:
        raise ValueError(f"fold_partials: partials {tuple(parts.shape)} do "
                         f"not lead an accumulator {tuple(acc.shape)}")
    if not (acc.is_contiguous() and parts.is_contiguous()):
        raise ValueError("fold_partials: acc and parts must be contiguous")
    out = torch.empty_like(acc)
    if acc.numel() == 0:
        return out
    fn = build.c_function("fold_partials", "fold_partials_launch", "pplipp")
    launch(fn, acc.device, acc.data_ptr(), parts.data_ptr(), acc.numel(),
           parts.shape[0], out.data_ptr())
    fold_partials_cuda.launches += 1
    return out


fold_partials_cuda.launches = 0
