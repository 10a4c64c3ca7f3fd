"""Label-indexed first moments, and the left-to-right stat fold.

Port of ``repro.core.labelstats``. Every linear family's sufficient
statistics are first moments of a per-point feature map (multinomial and
poisson: x; diag_gaussian: [x, x^2]) summed over segments
2 * label + sublabel. ``moments_from_labels`` runs ``ops.moments_labels``
(the ``moments_labels`` kernel on the card, its plain version on the CPU)
and returns its per-STATS_BLOCK partials; each family unpacks them with
its ``stats_from_moments``.

``fold_stats`` adds per-STATS_BLOCK partials of any family's stats into a
running accumulator, block by block in point order, as the reference's
``fold_blocked`` and the ``lax.scan`` after its megakernels do
(``repro/core/family.py``). Every stat fold of the port goes through it, so
a tiled fit continues the resident fit's sums tile by tile, bit for bit.

``window_rows`` cuts the points of a stat fold into STATS_BLOCK-aligned
windows whose partials fit ``WINDOW_BYTES``: the family's sweep and label
fold (``core/family.py``) run their kernels window by window and fold each
window's partials before the next, as the reference's ``fold_blocked``
folds one block at a time inside its ``lax.scan``. Every stat element is
still the accumulator plus the blocks' partials in point order, so the
windows change no bit; they bound the partials' memory (a 4e5 x 256
Gaussian fold held 6.6 GB of them at once).
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.suffstats import STATS_BLOCK

# Bytes of per-STATS_BLOCK partials (every field, 2k slots) a stat window
# may hold; a window holds at least one block whatever its bytes. The
# plan reads the shape only: the windows, and so the launches, do not
# depend on the data or on the card's free memory.
WINDOW_BYTES = 1 << 30


def window_rows(n: int, k: int, slot_floats: int) -> List[Tuple[int, int]]:
    """Point windows [a, b) of a stat fold over n points and k clusters
    whose partials take ``slot_floats`` floats a (block, sub-cluster slot):
    consecutive, STATS_BLOCK-aligned, covering [0, n), each of as many
    whole blocks as WINDOW_BYTES holds and at least one ([(0, 0)] for no
    points)."""
    per_block = 4 * 2 * k * slot_floats
    step = max(1, WINDOW_BYTES // per_block) * STATS_BLOCK
    return [(a, min(n, a + step)) for a in range(0, max(n, 1), step)]


def fold_stats(acc: Any, parts: Any) -> Any:
    """``acc`` (a stats dataclass) plus ``parts`` (the same dataclass, every
    field leading with the block axis), left to right: every field in one
    ``ops.fold_fields`` (one launch on the card)."""
    names = [f.name for f in dataclasses.fields(acc)]
    outs = ops.fold_fields([getattr(acc, n) for n in names],
                           [getattr(parts, n) for n in names])
    return type(acc)(**dict(zip(names, outs)))


def moments_from_labels(feats: torch.Tensor, valid: torch.Tensor,
                        labels: torch.Tensor, sublabels: torch.Tensor,
                        k_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (N, d') -> per-STATS_BLOCK partials (n (nsb, k_max, 2),
    sf (nsb, k_max, 2, d'))."""
    return ops.moments_labels(feats, labels.to(torch.int32),
                              sublabels.to(torch.int32), valid, k_max)
