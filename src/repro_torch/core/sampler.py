"""The port's DPMM sampler: ``DPMM.fit``, one chain, on two data planes.

Port of the resident and tiled planes of ``repro.core.sampler``. Per
iteration (paper §4.1):

    restricted Gibbs sweep (gibbs.sweep)  ->  after ``burnout``:
    split/merge plan + apply + consistency stat fold (_split_merge)

``fit`` takes an (N, d) array, a tensor or a ``DataSource``
(``data/source.py``). Without ``cfg.tile_size`` and with the points in
host memory (``source.resident()``) they live on the device for the whole
fit (the resident plane). Otherwise they stream from the source in
STATS_BLOCK-aligned tiles (``core/distributed.tile_plan``), every pass of
an iteration a pass over the tiles (``core/stream.TileStream``: pinned
buffers and a side CUDA stream), under a model state that stays on the
device: device memory is O(k_max + tile_size), and N is bounded by host
storage. Labels live in host arrays, each tile's uploaded and written back.
The stat folds continue left to right from tile to tile
(``labelstats.fold_stats``), so a tiled chain is the resident chain of the
same seed, bit for bit, at every tile size. Both planes build the prior
from ``source.column_mean()``, the reference's float64 pass.

On a CUDA device the sweep and every stat fold run through the
hand-written kernels (``kernels/ops.py``); on the CPU through their plain
versions. ``DPMM`` runs on the card unless the caller passes
``device="cpu"``.

All model-side randomness (gamma, normal, uniform draws and each
iteration's Gumbel key words) comes from one ``torch.Generator`` seeded
with ``cfg.seed``, in a fixed order, so a seed reproduces a chain on a
given device. The resident plane copies the history rows to the host once
per ``log_every`` chunk; the compaction check and the merge matching read
a few O(K) values on the host each iteration. The tiled plane reads the
history row, and so the live count its compaction is sized by, every
iteration, as the reference's tiled plane does.

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
from repro_torch.core.distributed import tile_plan
from repro_torch.core.family import ComponentFamily, get_family
from repro_torch.core.metrics import ari, nmi
from repro_torch.core.resilience import RetryPolicy
from repro_torch.core.state import ModelState, PointState
from repro_torch.core.stream import TileStream
from repro_torch.data.source import DataSource, as_source

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


def _split_merge_begin(model: ModelState, d: int, *, prior, family, cfg,
                       k_max: int, generator, k_compact: Optional[int]):
    """Plan a move (O(K)) and size its stat fold: with ``k_compact`` a
    compact slab of ``min(k_max, 2 * k_compact)`` rows when the post-move
    live count fits (a host check), else the dense slab. Returns the plan,
    the compaction (or None) and the zero accumulator of the move's
    tiles."""
    dev = model.active.device
    k_c_sm = None if k_compact is None else min(k_max, 2 * k_compact)
    draws = splitmerge.draw_split_merge(generator, k_max, d, dev)
    plan = splitmerge.plan_split_merge(draws, model, prior, family,
                                       cfg.alpha, cfg.subreset_every)
    comp = None
    if (k_c_sm is not None and k_c_sm < k_max
            and int(plan.merge.new_active.sum()) <= k_c_sm):
        comp = gibbs.compaction_plan(plan.merge.new_active, k_c_sm)
    k_eff = k_max if comp is None else k_c_sm
    return plan, comp, gibbs.empty_substats(family, k_eff, d, dev)


def _split_merge_end(model: ModelState, plan, comp, acc,
                     k_max: int) -> ModelState:
    """The moved model: its new active set and the folded stats."""
    stats, substats = gibbs.finalize_substats(acc)
    if comp is not None:
        stats = gibbs.compact_scatter(comp, k_max, stats)
        substats = gibbs.compact_scatter(comp, k_max, substats)
    return model.replace(active=plan.merge.new_active, stuck=plan.stuck,
                         stats=stats, substats=substats)


def _split_merge(model: ModelState, point: PointState, x, *, prior, family,
                 cfg, k_max: int, generator, k_compact=None
                 ) -> Tuple[ModelState, PointState]:
    """Plan (O(K)), apply to the points, fold the consistency stats, on
    the slab ``_split_merge_begin`` sizes from ``k_compact``."""
    plan, comp, acc = _split_merge_begin(
        model, x.shape[1], prior=prior, family=family, cfg=cfg,
        k_max=k_max, generator=generator, k_compact=k_compact)
    point, acc = splitmerge.split_merge_tile(plan, x, point, acc, family,
                                             compaction=comp)
    return _split_merge_end(model, plan, comp, acc, k_max), point


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
    # torch.cuda.memory_allocated when the fit began (the caller's tensors)
    start_bytes: Optional[int] = None
    mode: str = "resident"       # the data plane: "resident" or "tiled"
    tile_size: Optional[int] = None   # rows of a tile (tiled)
    # the reference's estimate of the tiled plane's device bytes: two
    # model states, the accumulator and two tile buffers
    est_peak_bytes: Optional[int] = None
    # tile-read faults and retries (core/resilience.read_block_checked)
    recoveries: List[dict] = dataclasses.field(default_factory=list)
    copy_wait_s: Optional[float] = None   # device time waiting on copies
    read_s: Optional[float] = None        # host time reading, staging tiles

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


def _nbytes(tree) -> int:
    """Bytes of every tensor in a tensor or a (nested) dataclass."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if dataclasses.is_dataclass(tree):
        return sum(_nbytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def _history(rows: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """Per-iteration summaries -> host arrays, in one copy."""
    if not rows:
        return {k: np.zeros((0,), np.float32) for k in _HIST_KEYS}
    table = torch.stack([torch.stack([r[k].to(torch.float32)
                                      for k in _HIST_KEYS])
                         for r in rows]).cpu().numpy()
    return {k: table[:, j] for j, k in enumerate(_HIST_KEYS)}


class DPMM:
    """Sub-cluster split/merge DPMM sampler on one device."""

    def __init__(self, cfg: DPMMConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.family: ComponentFamily = get_family(cfg.component)

    def fit(self, x, iters: Optional[int] = None,
            verbose: bool = False) -> FitResult:
        """Fit to ``x`` on ``self.device``: an (N, d) numpy array or
        tensor, or a ``DataSource``. It streams in tiles when
        ``cfg.tile_size`` is set or the source is not resident, as the
        reference's ``fit`` dispatches."""
        iters = self.cfg.iters if iters is None else iters
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        source = as_source(x)
        if source.n == 0:
            raise ValueError("expected (N, d) points, got N = 0")
        if self.cfg.tile_size is None and source.resident() is not None:
            return self._fit_resident(source, iters, verbose)
        return self._fit_tiled(source, iters, verbose)

    def _setup(self, source: DataSource):
        """The prior from the source's column mean, the fit's generator,
        its key words and the device bytes at the start."""
        cfg, dev = self.cfg, self.device
        col_mean = torch.from_numpy(source.column_mean()).to(dev)
        prior = self.family.build_prior(cfg, col_mean[None, :])
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        # the key words of jax.random.key(seed), kept for interchange
        key = torch.tensor([0, cfg.seed & 0xFFFFFFFF], dtype=torch.int64,
                           device=dev)
        start = None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            start = int(torch.cuda.memory_allocated(dev))
        return prior, generator, key, start

    def _peak(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.max_memory_allocated(self.device))

    def _fit_resident(self, source: DataSource, iters: int,
                      verbose: bool) -> FitResult:
        cfg, family, dev = self.cfg, self.family, self.device
        x = torch.from_numpy(np.ascontiguousarray(source.resident()))
        x = x.to(device=dev, dtype=torch.float32)
        n = x.shape[0]
        k_max = cfg.k_max
        prior, generator, key, start = self._setup(source)
        valid = torch.ones((n,), dtype=torch.float32, device=dev)
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
            hist = _history(rows)                      # one sync
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
            device=str(dev), peak_bytes=self._peak(), start_bytes=start)

    def _tiled_step(self, model: ModelState, run, k_c: Optional[int],
                    ones: torch.Tensor, prior, generator,
                    d: int) -> ModelState:
        """One iteration over the tiles: the sweep pass, then after
        ``burnout`` the split/merge pass; ``run(pass_fn, acc, labels_in)``
        streams one pass."""
        cfg, family, dev = self.cfg, self.family, self.device
        k_max = cfg.k_max
        model, key_z, key_zb = gibbs.sweep_begin(model, prior, family,
                                                 cfg.alpha, generator)
        comp = gibbs.sweep_compaction(model, k_c)

        def sweep_pass(t, acc):
            point = PointState(labels=None, sublabels=None,
                               valid=ones[:t.length])
            point, acc = gibbs.sweep_tile(
                model, t.x, point, gibbs.global_indices(t.length, dev,
                                                        t.off),
                acc, family, key_z, key_zb, plan=comp)
            return (point.labels, point.sublabels), acc

        acc = run(sweep_pass, gibbs.sweep_acc(model, family, comp, d), False)
        model = gibbs.sweep_end(model, acc, comp)
        if model.it >= cfg.burnout:
            plan, sm_comp, acc = _split_merge_begin(
                model, d, prior=prior, family=family, cfg=cfg, k_max=k_max,
                generator=generator, k_compact=k_c)

            def sm_pass(t, acc):
                point = PointState(labels=t.labels, sublabels=t.sublabels,
                                   valid=ones[:t.length])
                point, acc = splitmerge.split_merge_tile(
                    plan, t.x, point, acc, family, compaction=sm_comp)
                return (point.labels, point.sublabels), acc

            acc = run(sm_pass, acc, True)
            model = _split_merge_end(model, plan, sm_comp, acc, k_max)
        return model.replace(it=model.it + 1)

    def _fit_tiled(self, source: DataSource, iters: int,
                   verbose: bool) -> FitResult:
        """The streamed plane (``repro.core.sampler.DPMM._fit_tiled`` for
        one chain on one device): two init passes, then per iteration a
        sweep pass and, after ``burnout``, a split/merge pass over the
        tiles (``_tiled_step``). The compact slabs follow the resident
        plane's rule (from the live count at each ``log_every`` chunk's
        start, headroom 2), not the reference tiled plane's per-iteration
        headroom 1: the Threefry top bin (ROADMAP.md §3) lets an inactive
        slot's +inf noise win only where the slot is in the slab, so the
        slab is part of the chain, and the same rule keeps the two planes'
        chains equal. Guardrail rollback, auto-checkpointing and
        ``resume`` are not ported (ROADMAP.md §1 item 9)."""
        cfg, family, dev = self.cfg, self.family, self.device
        n, d = source.n, source.d
        if n >= 2 ** 32:
            raise ValueError(
                f"N={n} exceeds the uint32 global point-index space: the "
                "counter-based draws would wrap and silently corrupt the "
                "chain")
        n_local, tiles = tile_plan(n, cfg.tile_size)
        k_max = cfg.k_max
        prior, generator, key, start = self._setup(source)
        events: List[dict] = []
        stream = TileStream(source, tiles, dev,
                            RetryPolicy(max_retries=cfg.io_retries,
                                        backoff_s=cfg.io_backoff_s,
                                        guard_nonfinite=cfg.guard_tiles),
                            events.append)
        labels_h = np.zeros((n_local,), np.int32)
        sublabels_h = np.zeros((n_local,), np.int32)
        ones = torch.ones((tiles[0][1],), dtype=torch.float32, device=dev)
        run = lambda fn, acc, labels_in: stream.run(fn, acc, labels_h,
                                                    sublabels_h, labels_in)

        def init1(t, acc):
            gidx = gibbs.global_indices(t.length, dev, t.off)
            labels = _init_labels(gidx, cfg.init_clusters)
            zeros = torch.zeros_like(labels)
            return (labels, zeros), family.stats_from_labels(
                t.x, ones[:t.length], labels, zeros, k_max, acc=acc)

        acc = run(init1, gibbs.empty_substats(family, k_max, d, dev), False)
        stats0, _ = gibbs.finalize_substats(acc)
        means0 = family.cluster_means(stats0)
        v0 = splitmerge.hyperplane_vecs(generator, k_max, d, dev)

        def init2(t, acc):
            sub = splitmerge.hyperplane_bits(t.x, t.labels, means0, v0)
            return (t.labels, sub), family.stats_from_labels(
                t.x, ones[:t.length], t.labels, sub, k_max, acc=acc)

        acc = run(init2, gibbs.empty_substats(family, k_max, d, dev), True)
        model = _init_model(key, *gibbs.finalize_substats(acc), prior=prior,
                            family=family, cfg=cfg, k_max=k_max)
        est_peak = (2 * _nbytes(model)
                    + _nbytes(gibbs.empty_substats(family, k_max, d, dev))
                    + 2 * tiles[0][1] * (4 * d + 8))

        rows: List[Dict[str, torch.Tensor]] = []
        times: List[float] = []
        k0, done = cfg.init_clusters, 0
        while done < iters:
            length = min(cfg.log_every, iters - done)
            k_c = (_k_compact(k0, 2, k_max, cfg.k_block)
                   if cfg.compact else None)
            for _ in range(length):
                t0 = time.perf_counter()
                model = self._tiled_step(model, run, k_c, ones, prior,
                                         generator, d)
                rows.append(_summaries(model, prior, family, cfg.alpha))
                times.append(time.perf_counter() - t0)
            k0 = int(rows[-1]["k"])
            done += length
            if verbose:
                print(f"iter {done:4d}  K={k0}  "
                      f"{np.mean(times[-length:]) * 1e3:.1f} ms/iter")
        history = _history(rows)
        history["k"] = history["k"].astype(np.int32)
        return FitResult(
            state=model, labels=labels_h[:n].copy(), k=int(model.k_hat),
            history=history, iter_times_s=times, device=str(dev),
            peak_bytes=self._peak(), start_bytes=start, mode="tiled",
            tile_size=tiles[0][1], est_peak_bytes=int(est_peak),
            recoveries=events,
            copy_wait_s=stream.wait_s if stream.cuda else None,
            read_s=stream.read_s)
