"""Label-indexed first moments, the stat fold of the linear families.

Port of ``repro.core.labelstats``. Every linear family's sufficient
statistics are first moments of a per-point feature map (multinomial and
poisson: x; diag_gaussian: [x, x^2]) summed over segments
2 * label + sublabel. ``moments_from_labels`` runs ``ops.moments_labels``
(the ``moments_labels`` kernel on the card, its plain version on the CPU)
and folds its per-STATS_BLOCK partials; each family unpacks the result
with its ``stats_from_moments``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops


def fold_partials(a: torch.Tensor) -> torch.Tensor:
    """(nsb, ...) per-STATS_BLOCK partials -> (...): one reduction over the
    block axis, in a fixed order for a given shape and device."""
    return a.sum(dim=0)


def moments_from_labels(feats: torch.Tensor, valid: torch.Tensor,
                        labels: torch.Tensor, sublabels: torch.Tensor,
                        k_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (N, d') -> (n (k_max, 2), sf (k_max, 2, d'))."""
    n2, sf2 = ops.moments_labels(feats, labels.to(torch.int32),
                                 sublabels.to(torch.int32), valid, k_max)
    return fold_partials(n2), fold_partials(sf2)
