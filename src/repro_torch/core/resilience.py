"""Health check of a model state before it goes live.

Port of ``repro.core.resilience.model_health`` (the rest of that module —
tile-read retry and rollback — is not ported yet: ROADMAP.md §1 item 9).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import ModelState


def model_health(model: ModelState) -> torch.Tensor:
    """0-d bool tensor: is ``model`` numerically sane? All O(K) checks on
    the active slots only (inactive slots never receive points): every
    sufficient-statistic leaf of ``stats`` and ``substats`` is finite,
    ``logweights`` are finite, and every count ``n`` is non-negative."""
    active = model.active
    ok = torch.ones((), dtype=torch.bool, device=active.device)
    for tree in (model.stats, model.substats):
        for f in dataclasses.fields(tree):
            leaf = getattr(tree, f.name)
            if not leaf.is_floating_point():
                continue
            mask = active.reshape(active.shape
                                  + (1,) * (leaf.ndim - active.ndim))
            ok = ok & torch.isfinite(torch.where(mask, leaf, 0.0)).all()
    ok = ok & torch.isfinite(torch.where(active, model.logweights, 0.0)).all()
    return ok & (torch.where(active, model.stats.n, 0.0) >= 0.0).all()
