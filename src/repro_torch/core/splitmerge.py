"""Metropolis-Hastings split/merge moves (paper §2.3, §4.1).

Port of ``repro.core.splitmerge``. ``plan_split_merge`` does the O(K)
decision math (split proposals with a prefix-sum slot allocator, all-pairs
merge proposals, scored over the live pairs and thinned to a disjoint
matching, stuck-cluster resets and the hyperplane geometry);
``split_merge_tile`` applies the plan to the points (relabels, hyperplane
sub-label re-init) as whole-tile tensor ops and folds the consistency
stats with one ``suffstats_labels`` call.

The move's uniform and normal draws derive from its key as the
reference's do: ``move_key`` is ``fold_in(key, -(it + 1))``, split into
k_s, k_m, k_b; the split uniforms come from a generator seeded from k_s,
the merge uniforms from k_m, the split hyperplanes from k_b and the reset
hyperplanes from ``fold_in(k_b, 1)`` (``draw_split_merge``). A test can
pass other draws in (``SplitMergeDraws``), the JAX package's for one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.family import fold_blocked
from repro_torch.core.state import PointState, tree_map, tree_map2
from repro_torch.kernels import prng


@dataclasses.dataclass
class SplitDecision:
    accept: torch.Tensor       # (K,) bool: cluster k splits
    dest: torch.Tensor         # (K,) int64: slot of the r-half of k
    new_active: torch.Tensor   # (K,) bool


@dataclasses.dataclass
class MergeDecision:
    merged: torch.Tensor       # (K,) bool: cluster takes part in a merge
    into: torch.Tensor         # (K,) int64: destination (identity if not)
    side: torch.Tensor         # (K,) int64: 0 kept, 1 absorbed
    new_active: torch.Tensor   # (K,) bool


@dataclasses.dataclass
class SplitMergePlan:
    split: SplitDecision
    merge: MergeDecision
    means_split: torch.Tensor  # (K, d) cluster means after splits
    means_merge: torch.Tensor  # (K, d) cluster means after merges
    vecs_split: torch.Tensor   # (K, d) hyperplane normals, split re-init
    vecs_reset: torch.Tensor   # (K, d) hyperplane normals, stuck reset
    reset: torch.Tensor        # (K,) bool: re-draw sub-labels
    stuck: torch.Tensor        # (K,) int32 updated stuck counters


@dataclasses.dataclass
class SplitMergeDraws:
    """The random numbers of one move: uniforms of the split (K,) and
    merge (K(K-1)/2,) acceptances, unit hyperplane normals (K, d) x 2."""
    u_split: torch.Tensor
    u_merge: torch.Tensor
    vecs_split: torch.Tensor
    vecs_reset: torch.Tensor


def _lgamma_floor(v: torch.Tensor) -> torch.Tensor:
    return torch.lgamma(torch.clamp(v, min=1e-6))


def log_hastings_split(prior, family, stats, substats, alpha: float):
    """log H_split per cluster (paper eq. 12 / 20)."""
    logm_c = family.log_marginal(prior, stats)
    logm_sub = family.log_marginal(prior, substats)
    return (float(np.log(alpha))
            + _lgamma_floor(substats.n[..., 0]) + logm_sub[..., 0]
            + _lgamma_floor(substats.n[..., 1]) + logm_sub[..., 1]
            - _lgamma_floor(stats.n) - logm_c)


def propose_splits(u: torch.Tensor, active, stats, substats, prior, family,
                   alpha: float) -> SplitDecision:
    """Split decisions given the acceptance uniforms ``u`` (K,)."""
    k_max = active.shape[0]
    ar = torch.arange(k_max, device=active.device)
    log_h = log_hastings_split(prior, family, stats, substats, alpha)
    valid = (active & (substats.n[:, 0] >= 1.0)
             & (substats.n[:, 1] >= 1.0))
    accept = valid & (torch.log(u) < log_h)
    # prefix-sum slot allocation over the free slots
    priority = torch.where(~active, ar, k_max + ar)
    free_order = torch.argsort(priority, stable=True)
    rank = torch.cumsum(accept.to(torch.int64), 0) - 1
    num_free = (~active).sum()
    accept = accept & (rank < num_free)       # K_max ceiling: reject
    dest = free_order[torch.clamp(rank, 0, k_max - 1)]
    dest = torch.where(accept, dest, ar)
    born = torch.zeros(k_max, dtype=torch.int64, device=active.device)
    born.index_add_(0, dest, accept.to(torch.int64))
    return SplitDecision(accept=accept, dest=dest,
                         new_active=active | (born > 0))


def apply_split_to_stats(stats, substats, dec: SplitDecision):
    """stats[k] <- substats[k, l]; stats[dest[k]] <- substats[k, r]."""
    def upd(full, sub):
        shape = (-1,) + (1,) * (full.ndim - 1)
        acc = dec.accept.reshape(shape)
        kept = torch.where(acc, sub[:, 0], full)
        # each destination gets at most one nonzero term, the rest +0.0,
        # so the scatter-add is exact in any order
        moved = torch.zeros_like(full).index_add_(
            0, dec.dest, torch.where(acc, sub[:, 1], 0.0))
        born = torch.zeros(full.shape[0], dtype=torch.int64,
                           device=full.device).index_add_(
            0, dec.dest, dec.accept.to(torch.int64))
        return torch.where((born > 0).reshape(shape), moved, kept)
    return tree_map2(upd, stats, substats)


def log_hastings_merge(prior, family, stats_a, stats_b, alpha: float):
    """log H_merge for pairs (paper eq. 21)."""
    n1, n2 = stats_a.n, stats_b.n
    merged = family.add_stats(stats_a, stats_b)
    logm_1 = family.log_marginal(prior, stats_a)
    logm_2 = family.log_marginal(prior, stats_b)
    logm_m = family.log_marginal(prior, merged)
    a = torch.tensor(alpha, dtype=n1.dtype, device=n1.device)
    return (_lgamma_floor(n1 + n2) - torch.log(a)
            - _lgamma_floor(n1) - _lgamma_floor(n2)
            + logm_m - logm_1 - logm_2
            + torch.lgamma(a) - torch.lgamma(a + n1 + n2)
            + torch.lgamma(a / 2 + n1) + torch.lgamma(a / 2 + n2)
            - 2.0 * torch.lgamma(a / 2))


# Merge proposals score only the pairs i < j of two live clusters, the
# only verdicts that can pass (an inactive pair is never accepted), in
# batches of at most MERGE_PAIR_BYTES of merged stats: all K(K - 1)/2
# pairs' merged stats would not fit the card (55 GB at K = 10,000 and
# d = 16; the reference maps its scoring over chunks of 256 pairs). Each
# pair keeps its uniform and its place in the row-major pair order, so
# the thinning is the reference's walk.
MERGE_PAIR_BYTES = 1 << 28


def _live_pairs(active: torch.Tensor):
    """(i, j, pair id) of the pairs i < j of active slots, in the
    row-major order of ``torch.triu_indices(K, K, 1)``."""
    k_max = active.shape[0]
    live = torch.nonzero(active).flatten()
    a, b = torch.triu_indices(live.shape[0], live.shape[0], 1,
                              device=active.device)
    iu, ju = live[a], live[b]
    pid = iu * (2 * k_max - iu - 1) // 2 + (ju - iu - 1)
    return iu, ju, pid


def propose_merges(u: torch.Tensor, active, stats, prior, family,
                   alpha: float) -> MergeDecision:
    """All-pairs merge proposals (paper §4.1) given the acceptance
    uniforms ``u`` (one per pair i < j, row-major), thinned to a disjoint
    matching by descending log H — no three clusters merge in one move.

    The thinning is a sequential greedy walk; it runs on the host over the
    accepted pairs only (one device-to-host copy of the pair verdicts).
    Only the live clusters' pairs are scored, in batches of at most
    MERGE_PAIR_BYTES of merged stats.
    """
    k_max = active.shape[0]
    dev = active.device
    take = lambda i: tree_map(lambda s: s[i], stats)
    iu, ju, pid = _live_pairs(active)
    d = getattr(stats, family.mean_field).shape[-1]
    step = max(1, MERGE_PAIR_BYTES // (4 * family.slot_floats(d)))
    log_h = torch.cat([log_hastings_merge(
        prior, family, take(iu[a:a + step]), take(ju[a:a + step]), alpha)
        for a in range(0, iu.shape[0], step)] or [u.new_empty((0,))])
    accept = torch.log(u[pid]) < log_h

    acc_np = accept.cpu().numpy()
    keep_np = np.zeros(acc_np.shape, bool)
    cand = np.nonzero(acc_np)[0]
    if cand.size:
        lh = log_h.cpu().numpy()[cand]
        order = cand[np.argsort(-lh, kind="stable")]
        taken = np.zeros(k_max, bool)
        iu_np, ju_np = iu.cpu().numpy(), ju.cpu().numpy()
        for p in order:
            a, b = iu_np[p], ju_np[p]
            if not taken[a] and not taken[b]:
                taken[a] = taken[b] = True
                keep_np[p] = True
    keep = torch.as_tensor(keep_np, device=dev)
    keep_i = keep.to(torch.int64)
    delta = torch.zeros(k_max, dtype=torch.int64, device=dev).index_add_(
        0, ju, torch.where(keep, iu - ju, 0))
    into = torch.arange(k_max, device=dev) + delta
    in_i = torch.zeros(k_max, dtype=torch.int64, device=dev).index_add_(
        0, iu, keep_i)
    in_j = torch.zeros(k_max, dtype=torch.int64, device=dev).index_add_(
        0, ju, keep_i)
    return MergeDecision(merged=(in_i + in_j) > 0, into=into,
                         side=(in_j > 0).to(torch.int64),
                         new_active=active & ~(in_j > 0))


def apply_merge_to_stats(stats, dec: MergeDecision):
    """stats[into[b]] += stats[b]; stats[b] <- 0 for absorbed b."""
    def upd(s):
        shape = (-1,) + (1,) * (s.ndim - 1)
        absorbed = (dec.side == 1).reshape(shape)
        contrib = torch.where(absorbed, s, 0.0)
        # one nonzero term per destination: exact in any order
        moved = torch.zeros_like(s).index_add_(0, dec.into, contrib)
        return torch.where(absorbed, 0.0, s + moved)
    return tree_map(upd, stats)


def hyperplane_vecs(generator: Optional[torch.Generator], k_max: int, d: int,
                    device) -> torch.Tensor:
    """(K, d) random unit normals."""
    v = torch.randn((k_max, d), generator=generator, device=device)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def hyperplane_bits(x, labels, means, v) -> torch.Tensor:
    """Sub-label init by a random hyperplane through each cluster mean."""
    lab = labels.long()
    proj = ((x - means[lab]) * v[lab]).sum(dim=-1)
    return (proj > 0).to(torch.int32)


def relabel_after_split(labels, sublabels, dec: SplitDecision, new_bits):
    lab = labels.long()
    was_split = dec.accept[lab]
    z = torch.where(was_split & (sublabels == 1), dec.dest[lab], lab)
    zb = torch.where(was_split, new_bits, sublabels)
    return z.to(torch.int32), zb.to(torch.int32)


def relabel_after_merge(labels, sublabels, dec: MergeDecision):
    lab = labels.long()
    zb = torch.where(dec.merged[lab], dec.side[lab], sublabels.long())
    return dec.into[lab].to(torch.int32), zb.to(torch.int32)


def move_key(model) -> prng.Words:
    """The iteration's split/merge key: ``fold_in(key, -(it + 1))``, a
    stream disjoint from the sweep's ``fold_in(key, it)``."""
    return prng.fold_in(model.key, -(model.it + 1))


def draw_split_merge(key, k_max: int, d: int, device) -> SplitMergeDraws:
    """The move's random numbers from its key's three sub-keys (k_s, k_m,
    k_b of ``split(key, 3)``), each draw from a generator of its own.
    Uniforms lie in [1e-12, 1), as the reference's."""
    k_s, k_m, k_b = prng.split(key, 3)

    def uniform(k, n):
        u = torch.rand((n,), generator=prng.generator(k, device),
                       device=device)
        return torch.clamp(u, min=1e-12)
    vecs = lambda k: hyperplane_vecs(prng.generator(k, device), k_max, d,
                                     device)
    return SplitMergeDraws(
        u_split=uniform(k_s, k_max),
        u_merge=uniform(k_m, k_max * (k_max - 1) // 2),
        vecs_split=vecs(k_b), vecs_reset=vecs(prng.fold_in(k_b, 1)))


def plan_split_merge(draws: SplitMergeDraws, model, prior, family,
                     alpha: float, subreset_every: int) -> SplitMergePlan:
    """All split/merge decision math, O(K), from the move's draws."""
    dec_s = propose_splits(draws.u_split, model.active, model.stats,
                           model.substats, prior, family, alpha)
    stats1 = apply_split_to_stats(model.stats, model.substats, dec_s)
    dec_m = propose_merges(draws.u_merge, dec_s.new_active, stats1, prior,
                           family, alpha)
    # clusters whose split keeps being rejected re-draw their sub-labels
    stuck = torch.where(dec_s.accept | dec_m.merged | ~model.active,
                        0, model.stuck + 1)
    reset = stuck >= subreset_every
    stuck = torch.where(reset, 0, stuck).to(torch.int32)
    stats2 = apply_merge_to_stats(stats1, dec_m)
    return SplitMergePlan(
        split=dec_s, merge=dec_m,
        means_split=family.cluster_means(stats1),
        means_merge=family.cluster_means(stats2),
        vecs_split=draws.vecs_split, vecs_reset=draws.vecs_reset,
        reset=reset, stuck=stuck)


def apply_plan(plan: SplitMergePlan, x, labels, sublabels
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relabels and both hyperplane sub-label re-inits of one planned
    move, as whole-tile tensor ops."""
    lab = labels.long()
    labels_mid = torch.where(plan.split.accept[lab] & (sublabels == 1),
                             plan.split.dest[lab], lab)
    bits = hyperplane_bits(x, labels_mid, plan.means_split, plan.vecs_split)
    labels1, sublabels1 = relabel_after_split(labels, sublabels, plan.split,
                                              bits)
    labels2, sublabels2 = relabel_after_merge(labels1, sublabels1,
                                              plan.merge)
    bits2 = hyperplane_bits(x, labels2, plan.means_merge, plan.vecs_reset)
    sublabels2 = torch.where(plan.reset[labels2.long()], bits2, sublabels2)
    return labels2, sublabels2.to(torch.int32)


def split_merge_tile(plan: SplitMergePlan, x, point: PointState, acc,
                     family, compaction=None) -> Tuple[PointState, object]:
    """Apply a planned move to the points and fold the consistency stats
    (paper §4.4). With ``compaction`` (built from the post-move active
    set) the fold runs on a compact ``acc``; returned labels stay dense
    slot ids.

    It always has the three-pass shape: relabel the whole tile, then fold
    its stats once (``fold_blocked``), so it needs no counterpart of the
    reference's ``fused`` flag; ``gibbs.sweep_tile(fused=False)`` alone
    selects the three-pass sweep."""
    if compaction is None:
        k_stat, label_map = plan.reset.shape[0], None
    else:
        k_stat = compaction.slot_of_compact.shape[0]
        label_map = compaction.compact_of_slot

    def body(xb, vb, lb, sb):
        return apply_plan(plan, xb, lb, sb)

    labels2, sublabels2, acc = fold_blocked(
        family, k_stat, body, x, point.valid,
        (point.labels, point.sublabels), acc, label_map=label_map)
    return dataclasses.replace(point, labels=labels2,
                               sublabels=sublabels2), acc
