"""The port's DPMM sampler: ``DPMM.fit`` on resident points, one chain.

Port of the resident plane of ``repro.core.sampler``. Per iteration
(paper §4.1):

    restricted Gibbs sweep (gibbs.sweep)  ->  after ``burnout``:
    split/merge plan + apply + consistency stat fold (_split_merge)

The points live on the device for the whole fit. On a CUDA device the
sweep and every stat fold run through the hand-written kernels
(``kernels/ops.py``); on the CPU through their plain versions. ``DPMM``
runs on the card unless the caller passes ``device="cpu"``.

All model-side randomness (gamma, normal, uniform draws and each
iteration's Gumbel key words) comes from one ``torch.Generator`` seeded
with ``cfg.seed``, in a fixed order, so a seed reproduces a chain on a
given device. The history row of every iteration stays on the device and
is copied to the host once per ``log_every`` chunk; the compaction check
and the merge matching read a few O(K) values on the host each iteration.

Example::

    >>> from repro_torch.configs import DPMMConfig
    >>> from repro_torch.core.sampler import DPMM
    >>> result = DPMM(DPMMConfig(iters=100)).fit(x)   # on "cuda"
    >>> result.k, result.nmi(true_labels)
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DPMMConfig
from repro_torch.core import gibbs, splitmerge
from repro_torch.core.family import ComponentFamily, get_family
from repro_torch.core.metrics import ari, nmi
from repro_torch.core.state import ModelState, PointState

_HIST_KEYS = ("k", "max_cluster", "min_cluster", "score")


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without a CUDA device it raises: the port
    never carries on on the CPU unless asked to with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def chain_score(model: ModelState, prior, family, alpha: float
                ) -> torch.Tensor:
    """Collapsed log posterior of the clustering (up to a constant): the
    CRP EPPF plus the active clusters' marginal likelihoods."""
    logm = family.log_marginal(prior, model.stats)
    act = model.active
    occ = torch.where(act, torch.clamp(model.stats.n, min=1.0), 1.0)
    return (torch.where(act, logm, 0.0).sum()
            + act.sum().to(torch.float32) * math.log(alpha)
            + torch.where(act, torch.lgamma(occ), 0.0).sum())


def _summaries(model: ModelState, prior, family, alpha: float) -> dict:
    s = model.summarize()
    s["score"] = chain_score(model, prior, family, alpha)
    return s


def _ceil_pow2(v: int) -> int:
    return 1 << max(0, (int(v) - 1).bit_length())


def _k_compact(k_hat: int, headroom: int, k_slab: int,
               k_block: int) -> Optional[int]:
    """Compact-slab size covering ``headroom * k_hat`` live clusters,
    rounded up to a power of two; ``None`` when it would not beat the
    dense slab."""
    kc = max(k_block, _ceil_pow2(headroom * max(1, k_hat)))
    return None if kc >= k_slab else kc


def _init_labels(gidx: torch.Tensor, init_clusters: int) -> torch.Tensor:
    return (gidx % init_clusters).to(torch.int32)


def _init_model(key, stats, substats, *, prior, family, cfg,
                k_max: int) -> ModelState:
    dev = stats.n.device
    active = torch.arange(k_max, device=dev) < cfg.init_clusters
    logw = torch.where(active, -math.log(float(cfg.init_clusters)),
                       gibbs.NEG_INF).to(torch.float32)
    return ModelState(
        key=key, it=0, active=active, logweights=logw,
        sub_logweights=torch.full((k_max, 2), math.log(0.5),
                                  dtype=torch.float32, device=dev),
        stuck=torch.zeros((k_max,), dtype=torch.int32, device=dev),
        params=family.expected_params(prior, stats),
        subparams=family.expected_params(prior, substats),
        stats=stats, substats=substats)


def _init_local(generator, key, x, valid, *, prior, family, cfg,
                k_max: int) -> Tuple[ModelState, PointState]:
    """Initial state: round-robin labels, then hyperplane sub-labels
    around the initial cluster means."""
    gidx = gibbs.global_indices(x.shape[0], x.device)
    labels = _init_labels(gidx, cfg.init_clusters)
    stats0, _ = gibbs.compute_stats(family, x, valid, labels,
                                    torch.zeros_like(labels), k_max)
    means0 = family.cluster_means(stats0)
    v0 = splitmerge.hyperplane_vecs(generator, k_max, x.shape[1], x.device)
    sublabels = splitmerge.hyperplane_bits(x, labels, means0, v0)
    stats, substats = gibbs.compute_stats(family, x, valid, labels,
                                          sublabels, k_max)
    return (_init_model(key, stats, substats, prior=prior, family=family,
                        cfg=cfg, k_max=k_max),
            PointState(labels=labels, sublabels=sublabels, valid=valid))


def _split_merge(model: ModelState, point: PointState, x, *, prior, family,
                 cfg, k_max: int, generator, k_compact=None
                 ) -> Tuple[ModelState, PointState]:
    """Plan (O(K)), apply to the points, fold the consistency stats.

    With ``k_compact`` the fold runs on a compact slab of
    ``min(k_max, 2 * k_compact)`` rows when the post-move live count fits
    (a host check), and scatters back to the dense slab."""
    draws = splitmerge.draw_split_merge(generator, k_max, x.shape[1],
                                        x.device)
    plan = splitmerge.plan_split_merge(draws, model, prior, family,
                                       cfg.alpha, cfg.subreset_every)
    comp = None
    k_c_sm = None if k_compact is None else min(k_max, 2 * k_compact)
    if (k_c_sm is not None and k_c_sm < k_max
            and int(plan.merge.new_active.sum()) <= k_c_sm):
        comp = gibbs.compaction_plan(plan.merge.new_active, k_c_sm)
    k_eff = k_max if comp is None else k_c_sm
    acc = gibbs.empty_substats(family, k_eff, x.shape[1], x.device)
    point, acc = splitmerge.split_merge_tile(plan, x, point, acc, family,
                                             compaction=comp)
    stats, substats = gibbs.finalize_substats(acc)
    if comp is not None:
        stats = gibbs.compact_scatter(comp, k_max, stats)
        substats = gibbs.compact_scatter(comp, k_max, substats)
    return (model.replace(active=plan.merge.new_active, stuck=plan.stuck,
                          stats=stats, substats=substats), point)


def dpmm_step(model: ModelState, point: PointState, x, *, prior, family,
              cfg, k_max: int, generator, k_compact=None
              ) -> Tuple[ModelState, PointState]:
    """One full iteration."""
    model, point = gibbs.sweep(model, point, x, prior, family, cfg.alpha,
                               generator, k_compact=k_compact)
    if model.it >= cfg.burnout:
        model, point = _split_merge(model, point, x, prior=prior,
                                    family=family, cfg=cfg, k_max=k_max,
                                    generator=generator,
                                    k_compact=k_compact)
    return model.replace(it=model.it + 1), point


@dataclasses.dataclass
class FitResult:
    """Result of ``DPMM.fit``."""
    state: ModelState            # final model-side state (on the device)
    labels: np.ndarray           # (N,) cluster slot of every point
    k: int
    history: Dict[str, np.ndarray]   # per-iteration k/max/min/score
    iter_times_s: List[float]
    device: str
    peak_bytes: Optional[int] = None  # torch.cuda.max_memory_allocated

    def _against(self, metric, true_labels, n_true: Optional[int]):
        true = torch.as_tensor(np.asarray(true_labels, np.int64))
        return metric(true, torch.as_tensor(self.labels),
                      n_true or int(true.max()) + 1,
                      int(self.state.active.shape[0]))

    def nmi(self, true_labels: np.ndarray,
            n_true: Optional[int] = None) -> float:
        return self._against(nmi, true_labels, n_true)

    def ari(self, true_labels: np.ndarray,
            n_true: Optional[int] = None) -> float:
        return self._against(ari, true_labels, n_true)


class DPMM:
    """Sub-cluster split/merge DPMM sampler on one device."""

    def __init__(self, cfg: DPMMConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.family: ComponentFamily = get_family(cfg.component)

    def fit(self, x, iters: Optional[int] = None,
            verbose: bool = False) -> FitResult:
        """Fit to ``x``, an (N, d) numpy array or tensor, on
        ``self.device``."""
        cfg, family, dev = self.cfg, self.family, self.device
        iters = cfg.iters if iters is None else iters
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        x = x.to(device=dev, dtype=torch.float32).contiguous()
        if x.ndim != 2 or x.shape[0] == 0:
            raise ValueError(f"expected (N, d) points, got {tuple(x.shape)}")
        n = x.shape[0]
        k_max = cfg.k_max
        valid = torch.ones((n,), dtype=torch.float32, device=dev)
        col_mean = (x.to(torch.float64).sum(dim=0) / n).to(torch.float32)
        prior = family.build_prior(cfg, col_mean[None, :])
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        # the key words of jax.random.key(seed), kept for interchange
        key = torch.tensor([0, cfg.seed & 0xFFFFFFFF], dtype=torch.int64,
                           device=dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model, point = _init_local(generator, key, x, valid, prior=prior,
                                   family=family, cfg=cfg, k_max=k_max)
        step = dict(prior=prior, family=family, cfg=cfg, k_max=k_max,
                    generator=generator)
        hist_chunks: List[Dict[str, np.ndarray]] = []
        times: List[float] = []
        k0, done = cfg.init_clusters, 0
        while done < iters:
            length = min(cfg.log_every, iters - done)
            k_c = (_k_compact(k0, 2, k_max, cfg.k_block)
                   if cfg.compact else None)
            t0 = time.perf_counter()
            rows = []
            for _ in range(length):
                model, point = dpmm_step(model, point, x, k_compact=k_c,
                                         **step)
                rows.append(_summaries(model, prior, family, cfg.alpha))
            table = torch.stack([torch.stack([r[k].to(torch.float32)
                                              for k in _HIST_KEYS])
                                 for r in rows]).cpu().numpy()  # one sync
            hist = {k: table[:, j] for j, k in enumerate(_HIST_KEYS)}
            dt = time.perf_counter() - t0
            times.extend([dt / length] * length)
            hist_chunks.append(hist)
            k0 = int(hist["k"][-1])
            done += length
            if verbose:
                print(f"iter {done:4d}  K={k0}  "
                      f"{dt / length * 1e3:.1f} ms/iter")
        history = {k: (np.concatenate([h[k] for h in hist_chunks])
                       if hist_chunks else np.zeros((0,), np.float32))
                   for k in _HIST_KEYS}
        history["k"] = history["k"].astype(np.int32)
        return FitResult(
            state=model, labels=point.labels.cpu().numpy(),
            k=int(model.k_hat), history=history, iter_times_s=times,
            device=str(dev),
            peak_bytes=(int(torch.cuda.max_memory_allocated(dev))
                        if dev.type == "cuda" else None))
