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
  whenever the family's fused sweep declines: above the one-read
  kernels' ``kernels/sweep.py`` ``MAX_K`` (2048) slots for every family,
  as the reference's K-block-tiled sweep takes any K, and the gaussian
  one for d > ``kernels/sweep.py`` ``MAX_D`` (128), as the reference's
  ``ops.sweep_gauss_pallas`` returns None outside its envelope; the
  linear ones take every d' their kernels take. Like ``matmul_auto``'s
  size rule below, the rule reads the shape only, is decided before any
  launch and is the same on the CPU and on the card; it never catches a
  kernel's failure;
- ``stats_from_labels``: label-indexed sub-cluster stats
  (``ops.suffstats_labels`` for gaussian, ``ops.moments_labels`` through
  ``core/labelstats.py`` for the linear families), folded into a running
  accumulator. Every stat fold (``sweep``, ``fold_blocked``) adds the
  kernels' per-STATS_BLOCK partials to the accumulator left to right in
  point order (``labelstats.fold_stats``, every field in one launch), as
  the reference does, so the sums continue across tiles and a tiled fit
  is the resident fit bit for bit. Both folds run their kernels on the
  point windows of ``labelstats.window_rows`` (partials of at most
  ``labelstats.WINDOW_BYTES`` at once), window after window. Given
  ``acc=None``, ``sweep``, ``sweep_ref`` and ``fold_blocked`` return the
  kernels' per-block partials unfolded instead (``label_partials``): a
  worker of a multi-process fit ships them, and the coordinator folds them
  in global block order (``repro_torch.dist``);
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
- ``cluster_means``: the first-moment field over the counts;
- feature sharding (``DPMMConfig.shard_features`` on a mesh with a
  ``model`` axis), for the families the reference marks
  ``feature_shardable`` (multinomial, poisson, diag_gaussian: likelihood
  and stats are sums over features): given x as ``FeatureShards``,
  ``sweep`` takes the plain route, as the reference keeps its kernels off
  under a feature axis: step (e) sums the slices' partial log-likelihoods
  (``loglik`` of ``slice_params`` on each slice, ``torch.matmul``) in
  model shard order, then adds the Gumbel noise and takes the first max
  (``loglik_sharded``), step (f) the same over the own cluster's two
  sub-clusters, and ``stats_from_labels`` folds each slice's stats on its
  device (``moments_labels``); ``gather_feature_stats`` joins the slices'
  ``feature_stat_fields`` along features.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import diag_gaussian, multinomial, niw, poisson
from repro_torch.core.distributed import FeatureShards, to_device
from repro_torch.core.labelstats import cat_partials, fold_stats, window_rows
from repro_torch.kernels import ops
from repro_torch.kernels.sweep import MAX_D as SWEEP_GAUSS_MAX_D
from repro_torch.kernels.sweep import MAX_K as SWEEP_MAX_K
from repro_torch.kernels.sweep import pick_cluster, pick_subcluster


def fold_blocked(family: "ComponentFamily", k_max: int, body,
                 x: torch.Tensor, valid: torch.Tensor, extras: Tuple,
                 acc, label_map=None):
    """Run the per-point ``body`` over the whole tile, then fold its
    labels' sub-cluster stats into ``acc`` with one ``stats_from_labels``
    call (its per-STATS_BLOCK partials added to ``acc`` left to right).

    ``body(x, valid, *extras) -> (labels, sublabels)``. ``label_map``
    ((k_dense,) int) re-indexes labels for the stat fold only — the
    compaction of split/merge folds dense-slot labels into a compact
    ``acc``; the returned labels stay in ``body``'s space. ``acc=None``
    returns the per-STATS_BLOCK partials instead of folding them.
    """
    labels, sublabels = body(x, valid, *extras)
    stat_lab = (labels if label_map is None else label_map[labels.long()]
                ).to(torch.int32)
    if acc is None:
        return labels, sublabels, family.label_partials(
            x, valid, stat_lab, sublabels, k_max)
    return labels, sublabels, family.stats_from_labels(
        x, valid, stat_lab, sublabels, k_max, acc=acc)


def _gauss_sweep(x, valid, params, subparams, logw, sublogw, active, gidx,
                 key_z, key_zb, slots):
    mu, f, ld, smu, sf, sld = niw.sweep_pack(params, subparams)
    labels, sublabels, n2, sx2, sxx2 = ops.sweep_gauss(
        x, mu, f, ld, logw, active, smu, sf, sld, sublogw, valid, gidx,
        key_z, key_zb, slots)
    return labels, sublabels, niw.GaussStats(n2, sx2, sxx2)


def _linear_sweep(mod):
    """The fused sweep of a linear family: its ``sweep_pack`` builds the
    shared feature block once, ``sweep_linear`` runs steps (e) + (f) and
    the first-moment partials, and ``stats_from_moments`` unpacks the
    per-block partials into the family's stats."""
    def sweep(x, valid, params, subparams, logw, sublogw, active, gidx,
              key_z, key_zb, slots):
        feats, w, const, subw, subconst = mod.sweep_pack(x, params,
                                                         subparams)
        labels, sublabels, n2, sf2 = ops.sweep_linear(
            feats, w, const, logw, active, subw, subconst, sublogw, valid,
            gidx, key_z, key_zb, slots)
        return labels, sublabels, mod.stats_from_moments(n2, sf2)
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
    #  key_zb, slots) -> (labels, sublabels, (nsb, k, 2) per-STATS_BLOCK
    #  sub-cluster stat partials)
    fused_sweep: Callable[..., Tuple]
    # (x, valid, labels, sublabels, k_max) -> (nsb, k_max, 2) partials
    labels_partials: Callable[..., Any]
    # (x, params, logw, active, gidx, key_z, slots) -> (N,) labels
    assign_step: Callable[..., torch.Tensor]
    # (x, subparams, sublogw, labels, gidx, key_zb) -> (N,) sub-labels
    sub_assign_step: Callable[..., torch.Tensor]
    # (x, params) -> (N, K) log-likelihoods
    loglik_fn: Callable[..., torch.Tensor]
    # d -> floats of a (block, sub-cluster slot)'s stat partials, every
    # field: the stat windows' measure (labelstats.window_rows)
    slot_floats: Callable[[int], int] = lambda d: 1 + d
    # stats field holding the first moment (sum x) — cluster means read it
    mean_field: str = "sx"
    # widest d the fused sweep takes (None: every d); wider runs sweep_ref
    fused_max_d: Optional[int] = None
    # feature sharding: likelihood and stats are sums over features; the
    # stats fields sliced along features; (params, start, n) -> the params
    # of features start .. start + n
    feature_shardable: bool = False
    feature_stat_fields: Tuple[str, ...] = ()
    slice_params: Optional[Callable[[Any, int, int], Any]] = None

    def sweep(self, x, valid, params, subparams, logw, sublogw, active,
              gidx, key_z, key_zb, k_max: int, acc, slots=None):
        """Steps (e) + (f) + stat fold with x read once, or through
        ``sweep_ref`` when the fused sweep declines x's width or the slab's
        K. ``params`` etc. may be a compact slab; ``slots`` ((K,) int) then
        carries the dense slot ids, the Gumbel counters of step (e). The
        fused sweep runs on the stat windows (``window_rows``), each
        window's partials folded before the next. Returns
        ``(labels, sublabels, acc')`` with labels in the slab's
        positions; with ``acc=None`` the third item is the per-block
        partials of every window, unfolded."""
        if isinstance(x, FeatureShards):
            return self.sweep_sharded(x, valid, params, subparams, logw,
                                      sublogw, active, gidx, key_z, key_zb,
                                      k_max, acc, slots=slots)
        if ((self.fused_max_d is not None and x.shape[1] > self.fused_max_d)
                or logw.shape[0] > SWEEP_MAX_K):
            return self.sweep_ref(x, valid, params, subparams, logw,
                                  sublogw, active, gidx, key_z, key_zb,
                                  k_max, acc, slots=slots)
        if slots is None:
            slots = torch.arange(k_max, device=x.device)
        active, slots = active.to(torch.int32), slots.to(torch.int32)
        labels, sublabels, kept = [], [], []
        for a, b in self.windows(x, k_max):
            lab, sub, parts = self.fused_sweep(
                x[a:b], valid[a:b], params, subparams, logw, sublogw, active,
                gidx[a:b], key_z, key_zb, slots)
            if acc is None:
                kept.append(parts)
            else:
                acc = fold_stats(acc, parts)
            del parts          # folding: one window's partials at a time
            labels.append(lab)
            sublabels.append(sub)
        out = cat_partials(kept) if acc is None else acc
        if len(labels) == 1:
            return labels[0], sublabels[0], out
        return torch.cat(labels), torch.cat(sublabels), out

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

    def sweep_sharded(self, x: FeatureShards, valid, params, subparams,
                      logw, sublogw, active, gidx, key_z, key_zb,
                      k_max: int, acc, slots=None):
        """``sweep`` with x's features split over the model axis, on the
        plain route (the reference's ``sweep_ref`` under ``feat_axis``):
        step (e) from ``loglik_sharded``, step (f) from the slices' summed
        own-cluster log-likelihoods, then each slice's stat fold;
        ``acc`` is the list of the slices' accumulators."""
        self._require_shardable()
        if slots is None:
            slots = torch.arange(k_max, device=x.device)

        def body(xb, vb, gb):
            lab = pick_cluster(self.loglik_sharded(xb, params), logw,
                               active, gb, key_z, slots)
            own = xb.psum(lambda xs, a, b, lb: _own_linear_loglik(
                self.module, xs, to_device(
                    self.slice_params(subparams, a, b - a), xs.device), lb),
                lab.long())
            return lab, pick_subcluster(own, sublogw[lab.long()], gb,
                                        key_zb)

        return fold_blocked(self, k_max, body, x, valid, (gidx,), acc)

    def loglik_sharded(self, x: FeatureShards, params) -> torch.Tensor:
        """(N, K) log-likelihoods of feature-sharded points: each slice's
        ``loglik`` under its slice of the params (``slice_params``),
        summed in model shard order (the reference's psum over
        ``model``)."""
        self._require_shardable()
        return x.psum(lambda xs, a, b: self.module.loglik(xs, to_device(
            self.slice_params(params, a, b - a), xs.device)))

    def gather_feature_stats(self, parts, device):
        """One stats object from the slices' ``parts`` (in model shard
        order) on ``device``: the feature-sliced fields joined along
        features, the rest (the counts) taken from the first slice."""
        self._require_shardable()
        out = {}
        for f in dataclasses.fields(parts[0]):
            vals = [to_device(getattr(p, f.name), device) for p in parts]
            out[f.name] = (torch.cat(vals, dim=-1)
                           if f.name in self.feature_stat_fields else vals[0])
        return type(parts[0])(**out)

    def _require_shardable(self) -> None:
        if not self.feature_shardable:
            raise ValueError(
                f"component family {self.name!r} is not feature-separable "
                "(the full-covariance Gaussian's Mahalanobis term couples "
                "the features), so shard_features does not apply to it; "
                f"the shardable ones: {', '.join(shardable_families())}")

    def stats_from_labels(self, x, valid, labels, sublabels, k_max: int,
                          acc=None):
        """(k_max, 2) sub-cluster stats straight from int labels, added to
        ``acc`` (zeros by default) block by block in point order, the
        partials made and folded window by window (``window_rows``). For
        ``FeatureShards`` every slice's stats on its device: ``acc`` and
        the result are the slices' list."""
        if isinstance(x, FeatureShards):
            if acc is None:
                acc = [None] * len(x.slices)
            return [self.stats_from_labels(
                xs, *[to_device(t, xs.device)
                      for t in (valid, labels, sublabels)], k_max, acc=a)
                for xs, a in zip(x.slices, acc)]
        if acc is None:
            acc = self.empty_stats((k_max, 2), x.shape[1], x.device)
        for a, b in self.windows(x, k_max):
            acc = fold_stats(acc, self.labels_partials(
                x[a:b], valid[a:b], labels[a:b], sublabels[a:b], k_max))
        return acc

    def label_partials(self, x, valid, labels, sublabels, k_max: int):
        """The per-STATS_BLOCK sub-cluster stat partials of a labelling,
        unfolded (every field leading with the block axis), made window by
        window as ``stats_from_labels`` makes them."""
        return cat_partials([
            self.labels_partials(x[a:b], valid[a:b], labels[a:b],
                                 sublabels[a:b], k_max)
            for a, b in self.windows(x, k_max)])

    def windows(self, x, k_max: int):
        """The stat windows of a fold of x's points over ``k_max``
        clusters (``labelstats.window_rows``)."""
        return window_rows(x.shape[0], k_max, self.slot_floats(x.shape[1]))

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


def _own_linear_loglik(mod, x, subparams, labels) -> torch.Tensor:
    """(N, 2) log-likelihoods of each point under its own cluster's two
    sub-clusters, from the family's linear pack (``assign_pack``)."""
    feats, w, const = mod.assign_pack(x, subparams)
    return torch.stack([(feats * w[labels, s]).sum(dim=-1)
                        for s in (0, 1)], dim=1) + const[labels]


def _module_family(mod, name: str, params_cls, stats_cls,
                   **kw) -> ComponentFamily:
    return ComponentFamily(
        name=name, module=mod, build_prior=mod.build_prior, empty_stats=mod.empty_stats,
        add_stats=mod.add_stats, log_marginal=mod.log_marginal,
        sample_posterior=mod.sample_posterior,
        expected_params=mod.expected_params, params_cls=params_cls,
        stats_cls=stats_cls, labels_partials=mod.partials_from_labels, **kw)


def _linear_family(mod, name: str, params_cls, stats_cls,
                   mean_field: str, loglik_fn=None, **kw) -> ComponentFamily:
    return _module_family(mod, name, params_cls, stats_cls,
                          fused_sweep=_linear_sweep(mod),
                          assign_step=_linear_assign(mod),
                          sub_assign_step=_linear_sub_assign(mod),
                          loglik_fn=loglik_fn or _product_loglik(mod),
                          mean_field=mean_field, **kw)


GAUSSIAN = _module_family(niw, "gaussian", niw.GaussParams, niw.GaussStats,
                          fused_sweep=_gauss_sweep,
                          assign_step=_gauss_assign,
                          sub_assign_step=_gauss_sub_assign,
                          loglik_fn=_gauss_loglik,
                          slot_floats=lambda d: 1 + d + d * d,
                          fused_max_d=SWEEP_GAUSS_MAX_D)
MULTINOMIAL = _linear_family(multinomial, "multinomial",
                             multinomial.MultParams, multinomial.MultStats,
                             mean_field="counts", feature_shardable=True,
                             feature_stat_fields=("counts",),
                             slice_params=multinomial.slice_params)
POISSON = _linear_family(poisson, "poisson", poisson.PoisParams,
                         poisson.PoisStats, mean_field="sx",
                         feature_shardable=True, feature_stat_fields=("sx",),
                         slice_params=poisson.slice_params)
DIAG_GAUSSIAN = _linear_family(diag_gaussian, "diag_gaussian",
                               diag_gaussian.DiagParams,
                               diag_gaussian.DiagStats, mean_field="sx",
                               loglik_fn=_diag_loglik,
                               slot_floats=lambda d: 1 + 2 * d,
                               feature_shardable=True,
                               feature_stat_fields=("sx", "sxx"),
                               slice_params=diag_gaussian.slice_params)

_REGISTRY = {f.name: f for f in (GAUSSIAN, MULTINOMIAL, POISSON,
                                 DIAG_GAUSSIAN)}


def available_families() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def shardable_families() -> Tuple[str, ...]:
    return tuple(sorted(n for n, f in _REGISTRY.items()
                        if f.feature_shardable))


def get_family(name: str) -> ComponentFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown component family {name!r}; registered: "
                         f"{', '.join(available_families())}") from None
