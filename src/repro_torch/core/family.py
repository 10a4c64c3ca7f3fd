"""ComponentFamily: what the sampler needs from an observation model.

Port of ``repro.core.family`` for the ``gaussian`` family (full-covariance
NIW). The sampler (``core/gibbs.py``, ``core/splitmerge.py``,
``core/sampler.py``) reaches the likelihood only through this interface:

- conjugate math (``core/niw.py``);
- ``sweep``: steps (e) + (f) + the sub-cluster stat fold in one pass over
  the points, through ``kernels.ops.sweep_gauss`` (the CUDA kernel on the
  card, its plain version on the CPU);
- ``stats_from_labels``: label-indexed sub-cluster stats through
  ``kernels.ops.suffstats_labels``;
- ``assign`` / ``sub_assign``: steps (e) and (f) alone, the plain path.

Only ``gaussian`` is ported; the linear families come later (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core import niw
from repro_torch.kernels import ops
from repro_torch.kernels.sweep import assign_plain, sub_assign_plain


def fold_blocked(family: "ComponentFamily", k_max: int, body,
                 x: torch.Tensor, valid: torch.Tensor, extras: Tuple,
                 acc: niw.GaussStats, label_map=None):
    """Run the per-point ``body`` over the whole tile, then fold its
    labels' sub-cluster stats into ``acc`` with one ``suffstats_labels``
    call (per-STATS_BLOCK partials, one fixed-order reduction).

    ``body(x, valid, *extras) -> (labels, sublabels)``. ``label_map``
    ((k_dense,) int) re-indexes labels for the stat fold only — the
    compaction of split/merge folds dense-slot labels into a compact
    ``acc``; the returned labels stay in ``body``'s space.
    """
    labels, sublabels = body(x, valid, *extras)
    stat_lab = labels if label_map is None else label_map[labels.long()]
    part = family.stats_from_labels(x, valid, stat_lab.to(torch.int32),
                                    sublabels, k_max)
    return labels, sublabels, niw.add_stats(acc, part)


@dataclasses.dataclass(frozen=True)
class ComponentFamily:
    """One observation model behind the sampler's interface."""
    name: str
    build_prior: Callable[..., Any]
    empty_stats: Callable[..., Any]
    add_stats: Callable[..., Any]
    log_marginal: Callable[..., torch.Tensor]
    sample_posterior: Callable[..., Any]
    expected_params: Callable[..., Any]

    def sweep(self, x, valid, params, subparams, logw, sublogw, active,
              gidx, key_z, key_zb, k_max: int, acc, slots=None):
        """Steps (e) + (f) + stat fold with x read once. ``params`` etc.
        may be a compact slab; ``slots`` ((K,) int) then carries the dense
        slot ids, the Gumbel counters of step (e). Returns ``(labels,
        sublabels, acc')`` with labels in the slab's positions."""
        if slots is None:
            slots = torch.arange(k_max, device=x.device)
        mu, f, ld, smu, sf, sld = niw.sweep_pack(params, subparams)
        labels, sublabels, n2, sx2, sxx2 = ops.sweep_gauss(
            x, mu, f, ld, logw, active.to(torch.int32), smu, sf, sld,
            sublogw, valid, gidx, key_z, key_zb, slots.to(torch.int32))
        return labels, sublabels, niw.add_stats(
            acc, niw.stats_from_partials(n2, sx2, sxx2))

    def stats_from_labels(self, x, valid, labels, sublabels,
                          k_max: int) -> niw.GaussStats:
        """(k_max, 2) sub-cluster stats straight from int labels."""
        return niw.stats_from_labels(x, valid, labels, sublabels, k_max)

    def assign(self, x, params, logw, active, gidx, key_z,
               slots=None) -> torch.Tensor:
        """Step (e) alone, plain path: (N,) labels."""
        if slots is None:
            slots = torch.arange(logw.shape[0], device=x.device)
        return assign_plain(x, params.mu, params.chol_prec,
                            params.logdet_prec, logw, active, gidx, key_z,
                            slots)

    def sub_assign(self, x, subparams, sublogw, labels, gidx,
                   key_zb) -> torch.Tensor:
        """Step (f) alone, plain path: (N,) sub-labels."""
        return sub_assign_plain(x, subparams.mu, subparams.chol_prec,
                                subparams.logdet_prec, sublogw, labels,
                                gidx, key_zb)

    def cluster_means(self, stats) -> torch.Tensor:
        """(*B, d) empirical cluster means."""
        return stats.sx / torch.clamp(stats.n[..., None], min=1.0)


GAUSSIAN = ComponentFamily(
    name="gaussian", build_prior=niw.build_prior,
    empty_stats=niw.empty_stats, add_stats=niw.add_stats,
    log_marginal=niw.log_marginal, sample_posterior=niw.sample_posterior,
    expected_params=niw.expected_params)

_REGISTRY = {"gaussian": GAUSSIAN}


def get_family(name: str) -> ComponentFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"component family {name!r} is not ported to repro_torch yet: "
            "only 'gaussian' is. The linear families (multinomial, poisson, "
            "diag_gaussian) are queued in ROADMAP.md.") from None

