"""Restricted Gibbs sweep (paper §4.1 steps a-f).

Port of ``repro.core.gibbs`` for one process and one chain:

- ``sweep_model``: steps (a)-(d), the O(K) weight and parameter draws
  from the current sufficient statistics;
- ``sweep_tile``: steps (e)/(f) and the stat fold over the points, in one
  read of x (``ComponentFamily.sweep``), or with ``fused=False`` in three
  passes (``ComponentFamily.sweep_ref``: ``assign``, ``sub_assign``, the
  label-stat fold), the reference's parity oracle: both give the same
  labels and stats;
- a fit (``sampler._step_models``, both planes, every data shard of a
  mesh) runs them in halves: ``sweep_begin`` (the key words and steps
  (a)-(d)), ``sweep_compaction``, then ``sweep_tile`` on every tile of
  every shard with a running accumulator, the shards' reduction, then
  ``sweep_end``;
- ``refine_sweep``: the serving layer's online refinement
  (``serve/dpmm.py``): steps (a)-(d) on the model, then ``refine_tile``,
  one ``sweep_tile`` over a batch of fresh points on the dense slab whose
  stats are blended into the model's as ``decay * old + batch``.

All randomness of an iteration derives from ``(model.key, model.it)`` as
the reference derives it (``sweep_keys``): six keys ``split(fold_in(key,
it), 6)``, k_w, k_sw, k_p, k_sp, k_z, k_zb. Per-point noise is the
counter-based Threefry keyed on (k_z or k_zb, global point index, dense
slot id) (``kernels/prng.py``), so for the same ``ModelState`` and x the
point-side draws are the reference's bit for bit. Steps (a)-(d) draw from
four ``torch.Generator``s, one a key, seeded from k_w, k_sw, k_p and k_sp
(``prng.generator``); a test may pass the gamma draws in instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core.state import (ModelState, PointState, tree_map,
                                    tree_map2)
from repro_torch.kernels import prng
from repro_torch.kernels.sweep import NEG_INF


def global_indices(n: int, device, offset: int = 0) -> torch.Tensor:
    """(n,) int64 global point indices of the points ``offset`` to
    ``offset + n``: over a mesh, ``offset`` is the data shard's base
    ``s * n_local`` (``distributed.shard_points``' padded layout) plus
    the tile's offset in the shard, as the reference's ``global_indices``
    adds ``axis_index * n_local``."""
    return torch.arange(offset, offset + n, dtype=torch.int64, device=device)


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


# ---------------------------------------------------------------------------
# The sweep: model-side and tile-side halves
# ---------------------------------------------------------------------------
def sweep_keys(model: ModelState) -> List[prng.Words]:
    """The six per-sweep keys' words, derived from (key, it) only as the
    reference derives them: k_w, k_sw, k_p, k_sp, k_z, k_zb of
    ``split(fold_in(key, it), 6)``."""
    return prng.split(prng.fold_in(model.key, model.it), 6)


def sweep_model(model: ModelState, prior, family,
                alpha: float) -> ModelState:
    """Steps (a)-(d): weights, sub-weights, parameters, sub-parameters,
    each drawn from a generator of its own seeded from k_w, k_sw, k_p and
    k_sp (``sweep_keys``)."""
    dev = model.active.device
    gen = [prng.generator(k, dev) for k in sweep_keys(model)[:4]]
    logw = sample_weights(gen[0], model.active, model.stats.n, alpha)
    sublogw = sample_subweights(gen[1], model.active,
                                model.substats.n[:, 0],
                                model.substats.n[:, 1], alpha)
    params = family.sample_posterior(prior, model.stats, gen[2])
    subparams = family.sample_posterior(prior, model.substats, gen[3])
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


def sweep_begin(model: ModelState, prior, family, alpha: float
                ) -> Tuple[ModelState, torch.Tensor, torch.Tensor]:
    """Steps (a)-(d), and the key words of steps (e) and (f) (k_z, k_zb
    of ``sweep_keys``) as the kernels read them."""
    dev = model.active.device
    keys = sweep_keys(model)
    return (sweep_model(model, prior, family, alpha),
            prng.key_tensor(keys[4], dev), prng.key_tensor(keys[5], dev))


def sweep_compaction(model: ModelState, k_compact: Optional[int]
                     ) -> Optional[CompactionPlan]:
    """The compact slab of ``k_compact`` rows when the live cluster count
    fits in it — a host check of ``k_hat`` (the reference does it on the
    device with ``lax.cond``) — else None: the dense slab."""
    if (k_compact is not None and k_compact < model.active.shape[0]
            and int(model.k_hat) <= k_compact):
        return compaction_plan(model.active, k_compact)
    return None


def sweep_acc(model: ModelState, family, plan: Optional[CompactionPlan],
              d: int):
    """The zero accumulator of a sweep's tiles on ``plan``'s slab."""
    k_eff = (model.active.shape[0] if plan is None
             else plan.slot_of_compact.shape[0])
    return empty_substats(family, k_eff, d, model.active.device)


def sweep_end(model: ModelState, acc, plan: Optional[CompactionPlan]
              ) -> ModelState:
    """The swept stats: cluster stats from the folded sub-cluster stats,
    scattered back to the dense slab after a compact sweep."""
    stats, substats = finalize_substats(acc)
    if plan is not None:
        k_max = model.active.shape[0]
        stats = compact_scatter(plan, k_max, stats)
        substats = compact_scatter(plan, k_max, substats)
    return model.replace(stats=stats, substats=substats)


def refine_tile(model: ModelState, x: torch.Tensor, valid: torch.Tensor,
                family, decay: float) -> Tuple[ModelState, torch.Tensor]:
    """Steps (e)/(f) of an online refinement sweep on a batch, after
    steps (a)-(d) (``sweep_model``) made ``model``: one ``sweep_tile``
    over the whole ``k_max`` slab, inactive slots included, with the batch
    row index ``0..B-1`` as the global index and the keys of ``(key, it)``
    as a fit iteration derives them. ``valid`` (B,) masks padded rows out
    of the fold. The batch's stats are blended into the model's leaf by
    leaf as ``decay * old + batch`` in float32; ``it`` advances by one and
    the active set stays as it is. Returns ``(model, labels)``, the labels
    dense slot ids."""
    dev = x.device
    keys = sweep_keys(model)
    k_max = model.active.shape[0]
    point = PointState(labels=None, sublabels=None,
                       valid=valid.to(torch.float32))
    point, acc = sweep_tile(
        model, x, point, global_indices(x.shape[0], dev),
        empty_substats(family, k_max, x.shape[1], dev), family,
        prng.key_tensor(keys[4], dev), prng.key_tensor(keys[5], dev))
    stats, substats = finalize_substats(acc)
    w = torch.tensor(decay, dtype=torch.float32)
    blend = lambda old, new: tree_map2(
        lambda o, b: (w * o + b).to(o.dtype), old, new)
    return model.replace(stats=blend(model.stats, stats),
                         substats=blend(model.substats, substats),
                         it=model.it + 1), point.labels


def refine_sweep(model: ModelState, x: torch.Tensor, valid: torch.Tensor,
                 prior, family, alpha: float, *, decay: float
                 ) -> Tuple[ModelState, torch.Tensor]:
    """One online micro-batch sweep (the reference's ``refine_sweep``):
    steps (a)-(d) under the model's stats, then ``refine_tile`` on the
    batch, so the posterior tracks an exponentially weighted window of
    traffic (effective mass ~ batch / (1 - decay)). No split or merge:
    refinement tracks drift within the served clusters; a swap installs
    new structure. Returns ``(model, labels)``."""
    return refine_tile(sweep_model(model, prior, family, alpha), x, valid,
                       family, decay)
