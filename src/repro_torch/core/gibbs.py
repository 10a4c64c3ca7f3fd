"""Restricted Gibbs sweep (paper §4.1 steps a-f).

Port of ``repro.core.gibbs`` for one process and one chain:

- ``sweep_model``: steps (a)-(d), the O(K) weight and parameter draws
  from the current sufficient statistics;
- ``sweep_tile``: steps (e)/(f) and the stat fold over the points, in one
  read of x (``ComponentFamily.sweep``), or with ``fused=False`` in three
  passes (``ComponentFamily.sweep_ref``: ``assign``, ``sub_assign``, the
  label-stat fold), the reference's parity oracle: both give the same
  labels and stats;
- ``sweep``: both, with the active-set compaction around the tile.

Per-point noise is the counter-based Threefry keyed on (key words, global
point index, dense slot id) (``kernels/prng.py``); the key words of an
iteration are drawn from the fit's generator. Model-side draws (gamma,
normal) come from the same generator, or are passed in by a test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.state import ModelState, PointState, tree_map
from repro_torch.kernels import prng
from repro_torch.kernels.sweep import NEG_INF


def global_indices(n: int, device) -> torch.Tensor:
    """(n,) int64 global point indices of the resident points."""
    return torch.arange(n, dtype=torch.int64, device=device)


def sample_weights(generator: Optional[torch.Generator],
                   active: torch.Tensor, nk: torch.Tensor, alpha: float,
                   gammas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step (a): (pi_1..pi_K, pi~) ~ Dir(N_1..N_K, alpha); returns log pi
    (-1e30 on inactive slots). ``gammas`` ((K+1,)) replaces the gamma
    draws."""
    k = active.shape[0]
    conc = torch.where(active, torch.clamp(nk, min=1e-2), 1.0)
    conc = torch.cat([conc, conc.new_full((1,), alpha)])
    g = (torch._standard_gamma(conc, generator=generator)
         if gammas is None else gammas)
    g = torch.clamp(g, min=1e-30)
    keep = torch.cat([active, active.new_ones((1,))])
    total = torch.where(keep, g, 0.0).sum()
    logpi = torch.log(g[:k]) - torch.log(total)
    return torch.where(active, logpi, NEG_INF)


def sample_subweights(generator: Optional[torch.Generator],
                      active: torch.Tensor, nkl: torch.Tensor,
                      nkr: torch.Tensor, alpha: float,
                      gammas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step (b): (pi_kl, pi_kr) ~ Dir(N_kl + a/2, N_kr + a/2) per cluster;
    ``gammas`` ((K, 2)) replaces the gamma draws."""
    conc = torch.stack([nkl + alpha / 2.0, nkr + alpha / 2.0], dim=-1)
    ga = (torch._standard_gamma(conc, generator=generator)
          if gammas is None else gammas)
    ga = torch.clamp(ga, min=1e-30)
    logw = torch.log(ga) - torch.log(ga.sum(dim=-1, keepdim=True))
    return torch.where(active[:, None], logw, math.log(0.5))


# ---------------------------------------------------------------------------
# Active-set compaction: per-point work O(K_active), not O(k_max)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CompactionPlan:
    """``slot_of_compact`` (k_c,): dense slot of each compact row, active
    slots first in ascending slot order, then inactive pad slots.
    ``compact_of_slot`` (k_max,): the inverse map."""
    slot_of_compact: torch.Tensor
    compact_of_slot: torch.Tensor


def compaction_plan(active: torch.Tensor, k_c: int) -> CompactionPlan:
    """``k_c`` must be >= the number of active slots for the compact
    sweep to be exact; the caller checks it on the host."""
    order = torch.argsort((~active).to(torch.int32), stable=True)
    return CompactionPlan(slot_of_compact=order[:k_c],
                          compact_of_slot=torch.argsort(order))


def compact_gather(plan: CompactionPlan, tree: Any) -> Any:
    """Gather the compact rows of a (k_max, ...)-leading tensor or
    dataclass of tensors."""
    take = lambda a: a.index_select(0, plan.slot_of_compact)
    return take(tree) if isinstance(tree, torch.Tensor) else tree_map(
        take, tree)


def compact_scatter(plan: CompactionPlan, k_max: int, tree: Any) -> Any:
    """Scatter compact rows back onto a zero dense slab: slots outside the
    plan get zeros, which is what the dense sweep gives inactive slots."""
    def put(a):
        out = a.new_zeros((k_max,) + tuple(a.shape[1:]))
        out[plan.slot_of_compact] = a
        return out
    return tree_map(put, tree)


def empty_substats(family, k_max: int, d: int, device):
    """Zero (k_max, 2) sub-cluster stats accumulator."""
    return family.empty_stats((k_max, 2), d, device)


def finalize_substats(substats):
    """Cluster stats are the fold of the sub-cluster stats over l/r."""
    return tree_map(lambda a: a.sum(dim=1), substats), substats


def compute_stats(family, x, valid, labels, sublabels, k_max: int):
    """(stats, substats) of a labelling, through ``suffstats_labels``."""
    return finalize_substats(family.stats_from_labels(
        x, valid, labels, sublabels, k_max))


# ---------------------------------------------------------------------------
# The sweep: model-side and tile-side halves
# ---------------------------------------------------------------------------
def sweep_model(model: ModelState, prior, family, alpha: float,
                generator: Optional[torch.Generator]) -> ModelState:
    """Steps (a)-(d): weights, sub-weights, parameters, sub-parameters —
    drawn from ``generator`` in that order."""
    logw = sample_weights(generator, model.active, model.stats.n, alpha)
    sublogw = sample_subweights(generator, model.active,
                                model.substats.n[:, 0],
                                model.substats.n[:, 1], alpha)
    params = family.sample_posterior(prior, model.stats, generator)
    subparams = family.sample_posterior(prior, model.substats, generator)
    return model.replace(logweights=logw, sub_logweights=sublogw,
                         params=params, subparams=subparams)


def sweep_tile(model: ModelState, x: torch.Tensor, point: PointState,
               gidx: torch.Tensor, acc, family, key_z: torch.Tensor,
               key_zb: torch.Tensor, plan: Optional[CompactionPlan] = None,
               fused: bool = True) -> Tuple[PointState, Any]:
    """Steps (e)/(f) + stat fold for one tile, reading x once.

    ``fused=False`` runs the three-pass body instead
    (``ComponentFamily.sweep_ref``): step (e) over the existing clusters,
    step (f) under each point's own cluster, then the stat fold, each a
    pass over x. Both bodies draw the same counter-based noise and fold
    the same per-STATS_BLOCK partials, so they give the same labels and
    stats (on the card: the same device code, bit for bit).

    With ``plan`` the tile runs on the gathered K_active-row slab, with
    the dense slot ids as Gumbel counters, so the noise is the dense
    slab's; ``acc`` is then compact-shaped and the caller scatters the
    stats back. Returned labels are always dense slot ids.
    """
    if plan is None:
        k_eff = model.active.shape[0]
        params, subparams = model.params, model.subparams
        logw, sublogw = model.logweights, model.sub_logweights
        active, slots = model.active, None
    else:
        k_eff = plan.slot_of_compact.shape[0]
        params = compact_gather(plan, model.params)
        subparams = compact_gather(plan, model.subparams)
        logw = compact_gather(plan, model.logweights)
        sublogw = compact_gather(plan, model.sub_logweights)
        active = compact_gather(plan, model.active)
        slots = plan.slot_of_compact
    body = family.sweep if fused else family.sweep_ref
    labels, sublabels, acc = body(
        x, point.valid, params, subparams, logw, sublogw, active, gidx,
        key_z, key_zb, k_eff, acc, slots=slots)
    if plan is not None:
        labels = plan.slot_of_compact[labels.long()].to(torch.int32)
    return dataclasses.replace(point, labels=labels,
                               sublabels=sublabels), acc


def sweep(model: ModelState, point: PointState, x: torch.Tensor, prior,
          family, alpha: float, generator: Optional[torch.Generator], *,
          k_compact: Optional[int] = None
          ) -> Tuple[ModelState, PointState]:
    """One restricted Gibbs sweep (steps a-f) over the resident points.

    Draws the iteration's two key words, then steps (a)-(d), from
    ``generator``. ``k_compact``: run the tile on a compact slab of this
    many rows when the live cluster count fits in it — a host check of
    ``k_hat`` once per iteration (the reference does it on the device
    with ``lax.cond``) — else on the dense slab.
    """
    key_z = prng.key_words(generator, x.device)
    key_zb = prng.key_words(generator, x.device)
    model = sweep_model(model, prior, family, alpha, generator)
    gidx = global_indices(x.shape[0], x.device)
    k_max = model.active.shape[0]
    plan = None
    if (k_compact is not None and k_compact < k_max
            and int(model.k_hat) <= k_compact):
        plan = compaction_plan(model.active, k_compact)
    k_eff = k_max if plan is None else k_compact
    acc = empty_substats(family, k_eff, x.shape[1], x.device)
    point, acc = sweep_tile(model, x, point, gidx, acc, family, key_z,
                            key_zb, plan=plan)
    stats, substats = finalize_substats(acc)
    if plan is not None:
        stats = compact_scatter(plan, k_max, stats)
        substats = compact_scatter(plan, k_max, substats)
    return model.replace(stats=stats, substats=substats), point
