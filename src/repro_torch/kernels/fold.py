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

Two versions of one function, over every field of a stat fold at once:

- ``fold_fields_cuda``: the hand-written kernel ``csrc/fold_partials.cu``,
  one launch for all the fields (up to ``MAX_FIELDS``), counted in
  ``fold_fields_cuda.launches``; ``fold_partials_cuda`` is its one-field
  call;
- ``fold_fields_plain``: ``fold_partials_plain``, the same adds as a loop
  over the blocks, field by field. Float addition is exact IEEE rounding
  on both, so the two give the same bits.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import launch

# fields of one launch (csrc/fold_partials.cu FOLD_MAX_ROWS) and the int64
# words of a field's row of the launch's table
MAX_FIELDS = 4
ROW_WORDS = 7


def fold_partials_plain(acc: torch.Tensor,
                        parts: torch.Tensor) -> torch.Tensor:
    out = acc.clone()
    for p in parts:
        out = out + p
    return out


def fold_fields_plain(accs: Sequence[torch.Tensor],
                      parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [fold_partials_plain(a, p) for a, p in zip(accs, parts)]


def row_layout(parts: torch.Tensor) -> Optional[Tuple[int, int, int]]:
    """(block stride, row length, row stride) in floats of partials
    (nb, *S) whose element j of block b lies at b bstride + (j / len)
    rstride + j % len, or None when their strides are not of that form
    (the kernel then reads a contiguous copy). A contiguous tensor is one
    row; a last-axis slice of a wider one (the diagonal Gaussian's sx and
    sxx halves of one moment array) is rows of its width."""
    m = math.prod(parts.shape[1:])
    if parts.is_contiguous():
        return m, m, m
    if parts.ndim < 3 or parts.stride(-1) != 1:
        return None
    for i in range(1, parts.ndim - 2):
        if parts.stride(i) != parts.stride(i + 1) * parts.shape[i + 1]:
            return None
    return parts.stride(0), parts.shape[-1], parts.stride(-2)


def fold_fields_cuda(accs: Sequence[torch.Tensor],
                     parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One launch of ``csrc/fold_partials.cu`` on the current stream: each
    ``accs[f]`` plus its (nb, *accs[f].shape) ``parts[f]``, every field's
    partials leading with the same nb blocks."""
    if not 1 <= len(accs) == len(parts) <= MAX_FIELDS:
        raise ValueError(f"fold_fields: 1 to {MAX_FIELDS} fields, got "
                         f"{len(accs)} accumulators, {len(parts)} partials")
    dev = accs[0].device
    if dev.type != "cuda":
        raise ValueError("fold_fields_cuda takes CUDA tensors; the plain "
                         "version serves the CPU")
    nb = parts[0].shape[0] if parts[0].ndim else -1
    outs, rows, keep = [], [], []
    for acc, p in zip(accs, parts):
        if acc.device != dev or p.device != dev:
            raise ValueError(f"fold_fields: tensors on {acc.device} and "
                             f"{p.device}, expected {dev}")
        if acc.dtype != torch.float32 or p.dtype != torch.float32:
            raise TypeError(f"fold_partials takes float32, got {acc.dtype} "
                            f"and {p.dtype}")
        if p.ndim < 1 or p.shape[0] != nb or tuple(p.shape[1:]) != tuple(
                acc.shape):
            raise ValueError(f"fold_partials: partials {tuple(p.shape)} do "
                             f"not lead an accumulator {tuple(acc.shape)} "
                             f"with {nb} blocks")
        if not acc.is_contiguous():
            raise ValueError("fold_partials: acc must be contiguous")
        out = torch.empty_like(acc)
        outs.append(out)
        if acc.numel() == 0:
            continue
        layout = row_layout(p)
        if layout is None:
            p = p.contiguous()
            layout = row_layout(p)
        keep.append(p)
        rows.extend((acc.data_ptr(), p.data_ptr(), out.data_ptr(),
                     acc.numel()) + layout)
    if not rows:
        return outs
    table = (ctypes.c_longlong * len(rows))(*rows)
    fn = build.c_function("fold_partials", "fold_fields_launch", "piip")
    launch(fn, dev, ctypes.addressof(table), len(rows) // ROW_WORDS, nb)
    fold_fields_cuda.launches += 1
    return outs


fold_fields_cuda.launches = 0


def fold_partials_cuda(acc: torch.Tensor,
                       parts: torch.Tensor) -> torch.Tensor:
    """One field: a one-row launch of ``fold_fields_cuda``."""
    return fold_fields_cuda([acc], [parts])[0]
