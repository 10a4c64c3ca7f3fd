"""ComponentFamily: what the sampler needs from an observation model.

Port of ``repro.core.family`` for its four families: ``gaussian``
(full-covariance NIW, ``core/niw.py``), ``multinomial``, ``poisson`` and
``diag_gaussian`` (``core/<family>.py``). The sampler (``core/gibbs.py``,
``core/splitmerge.py``, ``core/sampler.py``) reaches the likelihood only
through this interface:

- conjugate math: ``build_prior``, ``empty_stats``, ``add_stats``,
  ``log_marginal``, ``sample_posterior``, ``expected_params``;
- ``sweep``: steps (e) + (f) + the sub-cluster stat fold in one pass over
  the points. The gaussian family runs ``kernels.ops.sweep_gauss``; the
  three linear families pack their likelihood as ``feats @ w.T + const``
  (their ``sweep_pack``) and run ``kernels.ops.sweep_linear`` — the CUDA
  kernels on the card, their plain versions on the CPU;
- ``sweep_ref``: the same three steps as three passes over the points
  (``assign``, ``sub_assign``, ``stats_from_labels``). ``sweep`` runs it
  whenever the family's fused sweep declines: the gaussian one declines
  for d > ``kernels/sweep.py`` ``MAX_D`` (128), as the reference's
  ``ops.sweep_gauss_pallas`` returns None outside its envelope; the
  linear ones take every d' their kernels take. Like ``matmul_auto``'s
  size rule below, the rule reads the shape only, is decided before any
  launch and is the same on the CPU and on the card; it never catches a
  kernel's failure;
- ``stats_from_labels``: label-indexed sub-cluster stats
  (``ops.suffstats_labels`` for gaussian, ``ops.moments_labels`` through
  ``core/labelstats.py`` for the linear families);
- ``assign``: step (e) alone (``DPMMEngine.sample``, ``sweep_ref``):
  ``ops.assign_gauss`` for gaussian, the module's ``assign_pack`` and
  ``ops.assign_linear`` for the linear families;
- ``sub_assign``: step (f) alone (``sweep_ref``): ``ops.sub_assign_gauss``
  for gaussian, ``assign_pack`` of the sub-parameters and
  ``ops.sub_assign_linear`` for the linear families;
- ``loglik``: (N, K) log-likelihoods (``DPMMEngine.query``), on the
  reference's fast route: ``ops.loglik_gauss`` for gaussian,
  ``diag_gaussian.loglik`` with ``ops.matmul_auto`` for diag_gaussian; the
  module's ``loglik`` for multinomial and poisson, its one product through
  ``ops.matmul`` (the blocked kernel at every size: cuBLAS's rows change
  with the batch size, the kernel's do not, and a served point's answer
  must not depend on the request it came in);
- ``cluster_means``: the first-moment field over the counts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import diag_gaussian, multinomial, niw, poisson
from repro_torch.core.labelstats import fold_partials
from repro_torch.kernels import ops
from repro_torch.kernels.sweep import MAX_D as SWEEP_GAUSS_MAX_D


def fold_blocked(family: "ComponentFamily", k_max: int, body,
                 x: torch.Tensor, valid: torch.Tensor, extras: Tuple,
                 acc, label_map=None):
    """Run the per-point ``body`` over the whole tile, then fold its
    labels' sub-cluster stats into ``acc`` with one ``stats_from_labels``
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
    return labels, sublabels, family.add_stats(acc, part)


def _gauss_sweep(x, valid, params, subparams, logw, sublogw, active, gidx,
                 key_z, key_zb, slots):
    mu, f, ld, smu, sf, sld = niw.sweep_pack(params, subparams)
    labels, sublabels, n2, sx2, sxx2 = ops.sweep_gauss(
        x, mu, f, ld, logw, active, smu, sf, sld, sublogw, valid, gidx,
        key_z, key_zb, slots)
    return labels, sublabels, niw.stats_from_partials(n2, sx2, sxx2)


def _linear_sweep(mod):
    """The fused sweep of a linear family: its ``sweep_pack`` builds the
    shared feature block once, ``sweep_linear`` runs steps (e) + (f) and
    the first-moment fold, and ``stats_from_moments`` unpacks the folded
    partials into the family's stats."""
    def sweep(x, valid, params, subparams, logw, sublogw, active, gidx,
              key_z, key_zb, slots):
        feats, w, const, subw, subconst = mod.sweep_pack(x, params,
                                                         subparams)
        labels, sublabels, n2, sf2 = ops.sweep_linear(
            feats, w, const, logw, active, subw, subconst, sublogw, valid,
            gidx, key_z, key_zb, slots)
        return labels, sublabels, mod.stats_from_moments(
            fold_partials(n2), fold_partials(sf2))
    return sweep


def _gauss_assign(x, params, logw, active, gidx, key_z, slots):
    return ops.assign_gauss(x, params.mu, params.chol_prec,
                            params.logdet_prec, logw, active, gidx, key_z,
                            slots)


def _linear_assign(mod):
    """Step (e) of a linear family: ``assign_pack`` gives (feats, w,
    const), ``assign_linear`` the first-max labels."""
    def assign(x, params, logw, active, gidx, key_z, slots):
        feats, w, const = mod.assign_pack(x, params)
        return ops.assign_linear(feats, w, const, logw, active, gidx, key_z,
                                 slots)
    return assign


def _gauss_sub_assign(x, subparams, sublogw, labels, gidx, key_zb):
    return ops.sub_assign_gauss(x, subparams.mu, subparams.chol_prec,
                                subparams.logdet_prec, sublogw, labels, gidx,
                                key_zb)


def _linear_sub_assign(mod):
    """Step (f) of a linear family: ``assign_pack`` of the (K, 2)
    sub-parameters gives (feats, subw, subconst), ``sub_assign_linear``
    the first-max sub-labels."""
    def sub_assign(x, subparams, sublogw, labels, gidx, key_zb):
        feats, w, const = mod.assign_pack(x, subparams)
        return ops.sub_assign_linear(feats, w, const, sublogw, labels, gidx,
                                     key_zb)
    return sub_assign


def _gauss_loglik(x, params):
    return ops.loglik_gauss(x, params.mu, params.chol_prec,
                            params.logdet_prec)


def _diag_loglik(x, params):
    return diag_gaussian.loglik(x, params, matmul=ops.matmul_auto)


def _product_loglik(mod):
    return lambda x, params: mod.loglik(x, params, matmul=ops.matmul)


@dataclasses.dataclass(frozen=True)
class ComponentFamily:
    """One observation model behind the sampler's interface."""
    name: str
    # the conjugate-math module: core/niw.py or core/<name>.py
    module: Any
    build_prior: Callable[..., Any]
    empty_stats: Callable[..., Any]
    add_stats: Callable[..., Any]
    log_marginal: Callable[..., torch.Tensor]
    sample_posterior: Callable[..., Any]
    expected_params: Callable[..., Any]
    params_cls: type
    stats_cls: type
    # (x, valid, params, subparams, logw, sublogw, active, gidx, key_z,
    #  key_zb, slots) -> (labels, sublabels, (k, 2) sub-cluster stats)
    fused_sweep: Callable[..., Tuple]
    # (x, valid, labels, sublabels, k_max) -> (k_max, 2) stats
    labels_stats: Callable[..., Any]
    # (x, params, logw, active, gidx, key_z, slots) -> (N,) labels
    assign_step: Callable[..., torch.Tensor]
    # (x, subparams, sublogw, labels, gidx, key_zb) -> (N,) sub-labels
    sub_assign_step: Callable[..., torch.Tensor]
    # (x, params) -> (N, K) log-likelihoods
    loglik_fn: Callable[..., torch.Tensor]
    # stats field holding the first moment (sum x) — cluster means read it
    mean_field: str = "sx"
    # widest d the fused sweep takes (None: every d); wider runs sweep_ref
    fused_max_d: Optional[int] = None

    def sweep(self, x, valid, params, subparams, logw, sublogw, active,
              gidx, key_z, key_zb, k_max: int, acc, slots=None):
        """Steps (e) + (f) + stat fold with x read once, or through
        ``sweep_ref`` when the fused sweep declines x's width. ``params``
        etc. may be a compact slab; ``slots`` ((K,) int) then carries the
        dense slot ids, the Gumbel counters of step (e). Returns
        ``(labels, sublabels, acc')`` with labels in the slab's
        positions."""
        if self.fused_max_d is not None and x.shape[1] > self.fused_max_d:
            return self.sweep_ref(x, valid, params, subparams, logw,
                                  sublogw, active, gidx, key_z, key_zb,
                                  k_max, acc, slots=slots)
        if slots is None:
            slots = torch.arange(k_max, device=x.device)
        labels, sublabels, part = self.fused_sweep(
            x, valid, params, subparams, logw, sublogw,
            active.to(torch.int32), gidx, key_z, key_zb,
            slots.to(torch.int32))
        return labels, sublabels, self.add_stats(acc, part)

    def sweep_ref(self, x, valid, params, subparams, logw, sublogw, active,
                  gidx, key_z, key_zb, k_max: int, acc, slots=None):
        """Steps (e), (f) and the stat fold as three passes over x:
        ``assign``, ``sub_assign``, then ``fold_blocked`` with
        ``stats_from_labels``; the same arguments and result as
        ``sweep``."""
        def body(xb, vb, gb):
            lab = self.assign(xb, params, logw, active, gb, key_z, slots)
            return lab, self.sub_assign(xb, subparams, sublogw, lab, gb,
                                        key_zb)

        return fold_blocked(self, k_max, body, x, valid, (gidx,), acc)

    def stats_from_labels(self, x, valid, labels, sublabels, k_max: int):
        """(k_max, 2) sub-cluster stats straight from int labels."""
        return self.labels_stats(x, valid, labels, sublabels, k_max)

    def assign(self, x, params, logw, active, gidx, key_z,
               slots=None) -> torch.Tensor:
        """Step (e) alone: (N,) labels in the slab's positions. ``slots``
        ((K,) int, default ``arange(K)``) are the dense slot ids, the
        Gumbel counters."""
        if slots is None:
            slots = torch.arange(logw.shape[0], device=x.device)
        return self.assign_step(x, params, logw, active.to(torch.int32),
                                gidx, key_z, slots.to(torch.int32))

    def sub_assign(self, x, subparams, sublogw, labels, gidx,
                   key_zb) -> torch.Tensor:
        """Step (f) alone: (N,) sub-labels under each point's own cluster
        ``labels`` (positions of the (K, 2) ``subparams`` slab)."""
        return self.sub_assign_step(x, subparams, sublogw,
                                    labels.to(torch.int32), gidx, key_zb)

    def loglik(self, x, params) -> torch.Tensor:
        """(N, K) log-likelihoods on the reference's fast route."""
        return self.loglik_fn(x, params)

    def cluster_means(self, stats) -> torch.Tensor:
        """(*B, d) empirical cluster means from the first-moment field."""
        first = getattr(stats, self.mean_field)
        return first / torch.clamp(stats.n[..., None], min=1.0)


def _module_family(mod, name: str, params_cls, stats_cls,
                   **kw) -> ComponentFamily:
    return ComponentFamily(
        name=name, module=mod, build_prior=mod.build_prior, empty_stats=mod.empty_stats,
        add_stats=mod.add_stats, log_marginal=mod.log_marginal,
        sample_posterior=mod.sample_posterior,
        expected_params=mod.expected_params, params_cls=params_cls,
        stats_cls=stats_cls, labels_stats=mod.stats_from_labels, **kw)


def _linear_family(mod, name: str, params_cls, stats_cls,
                   mean_field: str, loglik_fn=None) -> ComponentFamily:
    return _module_family(mod, name, params_cls, stats_cls,
                          fused_sweep=_linear_sweep(mod),
                          assign_step=_linear_assign(mod),
                          sub_assign_step=_linear_sub_assign(mod),
                          loglik_fn=loglik_fn or _product_loglik(mod),
                          mean_field=mean_field)


GAUSSIAN = _module_family(niw, "gaussian", niw.GaussParams, niw.GaussStats,
                          fused_sweep=_gauss_sweep,
                          assign_step=_gauss_assign,
                          sub_assign_step=_gauss_sub_assign,
                          loglik_fn=_gauss_loglik,
                          fused_max_d=SWEEP_GAUSS_MAX_D)
MULTINOMIAL = _linear_family(multinomial, "multinomial",
                             multinomial.MultParams, multinomial.MultStats,
                             mean_field="counts")
POISSON = _linear_family(poisson, "poisson", poisson.PoisParams,
                         poisson.PoisStats, mean_field="sx")
DIAG_GAUSSIAN = _linear_family(diag_gaussian, "diag_gaussian",
                               diag_gaussian.DiagParams,
                               diag_gaussian.DiagStats, mean_field="sx",
                               loglik_fn=_diag_loglik)

_REGISTRY = {f.name: f for f in (GAUSSIAN, MULTINOMIAL, POISSON,
                                 DIAG_GAUSSIAN)}


def available_families() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_family(name: str) -> ComponentFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown component family {name!r}; registered: "
                         f"{', '.join(available_families())}") from None
