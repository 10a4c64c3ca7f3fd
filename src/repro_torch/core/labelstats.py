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
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.state import tree_map2
from repro_torch.kernels import ops


def fold_stats(acc: Any, parts: Any) -> Any:
    """``acc`` (a stats dataclass) plus ``parts`` (the same dataclass, every
    field leading with the block axis), left to right: one
    ``ops.fold_partials`` per field."""
    return tree_map2(ops.fold_partials, acc, parts)


def moments_from_labels(feats: torch.Tensor, valid: torch.Tensor,
                        labels: torch.Tensor, sublabels: torch.Tensor,
                        k_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (N, d') -> per-STATS_BLOCK partials (n (nsb, k_max, 2),
    sf (nsb, k_max, 2, d'))."""
    return ops.moments_labels(feats, labels.to(torch.int32),
                              sublabels.to(torch.int32), valid, k_max)
