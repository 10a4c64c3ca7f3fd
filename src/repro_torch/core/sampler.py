"""The port's DPMM sampler: ``DPMM.fit`` on three drivers.

Port of ``repro.core.sampler``: the resident and tiled planes here, and
with ``cfg.workers`` the elastic multi-process driver
(``repro_torch.dist.coordinator.fit_distributed``: a coordinator keeps the
model, worker processes stream row ranges of x, and the chain is the
tiled plane's bit for bit). Per iteration (paper §4.1):

    restricted Gibbs sweep (gibbs.sweep_begin .. sweep_end)  ->  after
    ``burnout``: split/merge plan + apply + consistency stat fold
    (_split_merge_begin .. _split_merge_end), in ``_step_models``

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
``device="cpu"`` (or a mesh of CPU devices).

**The mesh** (``core/distributed.py``; the reference's ``shard_map``): a
fit runs over ``DPMM.mesh``, by default every visible card. x is padded
to a multiple of the G data shards (zero rows, ``valid = 0``) and shard s
holds rows ``[s n_local, (s + 1) n_local)``, resident on its device or
streamed from the source in its own tiles; the global point index of a
row, and so its draws, is its row in that layout. The model side runs
once, on the mesh's first (lead) device: steps (a)-(d), the split/merge
plan, the keys, the compaction checks. Each pass copies what the tile
bodies read to every other device (``to_device``), runs each shard's
bodies on its device with an accumulator of its own, and ends in one
reduction: the shards' (K, 2, T) sums copied to the lead and folded there
in shard order from zero (``reduce_stats``, one ``fold_partials``
launch). At G = 1 there is no reduction: the fit is the one-device fit
bit for bit. A G-shard chain's bits depend on G, not on the cards that
hold the shards, and per mesh the tiled chain is the resident one. With
``cfg.shard_features`` and a ``model`` axis the feature-separable
families also split x's features (``FeatureShards``, the plain route of
``ComponentFamily.sweep_sharded``). Both planes run their passes through
the same ``_step_models`` (``ResidentPasses``, ``StreamPasses``).

All randomness derives from ``(state.key, state.it)`` as the reference
derives it: the sweep's six keys ``split(fold_in(key, it), 6)``
(``gibbs.sweep_keys``), the move's ``fold_in(key, -(it + 1))``
(``splitmerge.move_key``) and the initial hyperplanes' ``fold_in(key,
1)``; each gamma, normal or uniform draw comes from a ``torch.Generator``
seeded from its key (``prng.generator``), so a key reproduces a chain on a
given device, and ``fit(init_state=...)`` continues a saved chain bit for
bit (on the same device, from a save at any iteration). ``key`` defaults
to ``jax.random.key(cfg.seed)``'s words. The resident plane copies the
history rows to the host once per ``log_every`` chunk; the compaction
check and the merge matching read a few O(K) values on the host each
iteration. Both planes size the compact slab each iteration from the
state's live count, with headroom 2 (``_slab``), where the reference
sizes it once a chunk (resident) or each iteration with headroom 1
(tiled): the slab is part of the chain (the Threefry top bin, ROADMAP.md
§3), so the two planes' chains agree bit for bit only with one rule, and
a resumed chain only with one that reads nothing but the state.

**Fault tolerance** (``_Recovery``), as the reference's: with
``cfg.guardrails`` the model's health (``resilience.model_health``) is read
in the same host copy as each chunk's (resident) or iteration's (tiled)
history rows; on a bad verdict the fit goes back to a deep copy of the
last healthy state (``state.clone_model``), its key advanced by
``fold_in(key, 2^30 + 1337 + n)`` for the n-th rollback, and the failed
chunk or iteration leaves no rows; past ``cfg.max_recoveries`` it raises
``DivergenceError``. The check only reads, so a clean chain is bit for bit
the one without it. With ``cfg.checkpoint_path`` and
``cfg.checkpoint_every`` a rotation member is saved once that many
iterations have passed since the last save (resident: at chunk
boundaries; tiled: after each iteration), and at the end;
``fit(resume=True)`` continues from the newest member that verifies.

**Multi-chain fits** (``fit(n_chains=C)``): one loop per chain, no
batching across chains (the reference rejects vmap-style batching: it
reassociates the float sums). Chain c starts from key ``fold_in(key, c)``.
The resident plane holds x on the device(s) once and every chain's labels,
and runs each pass chain after chain; the tiled plane reads and uploads
each tile once a pass for all chains (``TileStream`` with (C, n) host
labels), each chain folding its own accumulator left to right.
Each chain sizes its compact slab from its own live count, unlike the
reference's maximum over chains: the slab is part of the chain (the
Threefry top bin), and the per-chain rule is what keeps chain c bit for bit
the single-chain fit with key ``fold_in(key, c)`` on both planes.
``FitResult`` then holds the multi-chain state layout
(``state.stack_chains``), (C, N) labels and (C, iters) histories, with
``chain(c)``, ``select_best()``, ``rhat`` and ``rhats``.

**``k_max='auto'``** (resident only): the slab starts at
``min(k_max_cap, max(8, 2 * init_clusters))`` slots and doubles at a chunk
boundary while twice the live count of the chunk's last row (the largest
over chains) exceeds it, up to ``k_max_cap`` (``state.grow_model``); a
rollback undoes growth made after its anchor, and a resumed fit starts
from its checkpoint's slab.

Example::

    >>> from repro_torch.configs import DPMMConfig
    >>> from repro_torch.core.sampler import DPMM
    >>> result = DPMM(DPMMConfig(iters=100)).fit(x)   # every card
    >>> result.k, result.nmi(true_labels)
    >>> from repro_torch.core.distributed import Mesh
    >>> mesh = Mesh(["cuda:0"] * 2)                    # two logical shards
    >>> DPMM(DPMMConfig(iters=100), mesh=mesh).fit(x).mesh["reductions"]
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import DPMMConfig
from repro_torch.core import checkpoint, gibbs, splitmerge
from repro_torch.core.distributed import (FeatureShards, Mesh, Shard,
                                          feature_cols, make_data_mesh,
                                          reduce_counts, reduce_stats,
                                          replicated, shard_points,
                                          tile_plan)
from repro_torch.core.family import ComponentFamily, get_family
from repro_torch.core.metrics import ari, nmi
from repro_torch.core.resilience import (DivergenceError, RetryPolicy,
                                         model_health)
from repro_torch.core.state import (ModelState, PointState, chain_of,
                                    clone_model, grow_model, stack_chains,
                                    tree_map)
from repro_torch.core.stream import TileStream, run_streams
from repro_torch.data.source import DataSource, as_source
from repro_torch.kernels import ops, prng

_HIST_KEYS = ("k", "max_cluster", "min_cluster", "score")

# Rollback key stream: fold_in values >= 2**30 are disjoint from both
# per-iteration streams (the sweep folds it in, the move -(it + 1)).
_RECOVERY_FOLD = (1 << 30) + 1337


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


def resolve_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` with every device resolved (``resolve_device``; a card
    named by its index). A device that is not there raises: no shard
    falls back to another device."""
    devs = []
    for dev in mesh.devices.reshape(-1):
        dev = resolve_device(dev)
        if dev.type == "cuda":
            idx = (torch.cuda.current_device() if dev.index is None
                   else dev.index)
            if idx >= torch.cuda.device_count():
                raise ValueError(f"the mesh names {dev}, but "
                                 f"{torch.cuda.device_count()} CUDA "
                                 "device(s) are visible")
            dev = torch.device("cuda", idx)
        devs.append(dev)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(mesh.devices.shape), mesh.axis_names)


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


def _slab(k_hat: int, cfg: DPMMConfig, k_max: int) -> Optional[int]:
    """The compact slab of an iteration (None: dense), from the live count
    ``k_hat`` of the state it starts from."""
    if not cfg.compact:
        return None
    return _k_compact(k_hat, 2, k_max, cfg.k_block)


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


def _init_vecs(key, k_max: int, d: int, device) -> torch.Tensor:
    """The initial hyperplanes, from ``fold_in(key, 1)``."""
    return splitmerge.hyperplane_vecs(
        prng.generator(prng.fold_in(key, 1), device), k_max, d, device)


def _init_models(passes, keys: List[torch.Tensor], prior, family, cfg,
                 d: int) -> List[ModelState]:
    """The initial states over the passes' points (slab ``passes.k_max``),
    in two passes: round-robin labels and their stats (the same for every
    chain, folded once), then each chain's hyperplane sub-labels around
    the initial cluster means, and their stats."""
    dev, k_max = passes.lead, passes.k_max
    (acc,) = passes.run("init1", [()],
                        [gibbs.empty_substats(family, k_max, d, dev)], False)
    stats0, _ = gibbs.finalize_substats(acc)
    means0 = family.cluster_means(stats0)
    accs = passes.run("init2", [(means0, _init_vecs(key, k_max, d, dev))
                                for key in keys],
                      [gibbs.empty_substats(family, k_max, d, dev)
                       for _ in keys], True)
    return [_init_model(key, *gibbs.finalize_substats(acc), prior=prior,
                        family=family, cfg=cfg, k_max=k_max)
            for key, acc in zip(keys, accs)]


def _init_local(key, x, valid, *, prior, family, cfg,
                k_max: int) -> Tuple[ModelState, PointState]:
    """Initial state of one chain over the points ``x`` on ``x.device``
    (one shard): round-robin labels, then hyperplane sub-labels around
    the initial cluster means."""
    passes = ResidentPasses(
        family, cfg, x.device,
        [Shard(x=x, valid=valid, base=0, labels=[None], sublabels=[None])],
        n_chains=1, k_max=k_max, n=x.shape[0])
    (model,) = _init_models(passes, [key], prior, family, cfg, x.shape[1])
    return model, passes.point(0)


def _split_merge_begin(model: ModelState, d: int, *, prior, family, cfg,
                       k_max: int, k_compact: Optional[int]):
    """Plan a move (O(K)) and size its stat fold: with ``k_compact`` a
    compact slab of ``min(k_max, 2 * k_compact)`` rows when the post-move
    live count fits (a host check), else the dense slab. Returns the plan,
    the compaction (or None) and the zero accumulator of the move's
    tiles."""
    dev = model.active.device
    k_c_sm = None if k_compact is None else min(k_max, 2 * k_compact)
    draws = splitmerge.draw_split_merge(splitmerge.move_key(model), k_max,
                                        d, dev)
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


def _step_models(models: List[ModelState], passes,
                 slabs: List[Optional[int]], prior, family, cfg,
                 d: int) -> List[ModelState]:
    """One iteration of every chain (both planes): steps (a)-(d) on the
    lead device, the sweep pass, then after ``burnout`` the split/merge
    plan and its pass (``passes.run``: every chain on every shard, each
    pass ending in its reduction), on the slab ``passes.k_max`` and the
    compact slabs ``slabs`` (``_slab``)."""
    k_max = passes.k_max
    begun = [gibbs.sweep_begin(m, prior, family, cfg.alpha) for m in models]
    comps = [gibbs.sweep_compaction(m, k_c)
             for (m, _, _), k_c in zip(begun, slabs)]
    accs = passes.run(
        "sweep", [(m, kz, kzb, comp)
                  for (m, kz, kzb), comp in zip(begun, comps)],
        [gibbs.sweep_acc(m, family, comp, d)
         for (m, _, _), comp in zip(begun, comps)], False)
    models = [gibbs.sweep_end(m, acc, comp)
              for (m, _, _), acc, comp in zip(begun, accs, comps)]
    if models[0].it >= cfg.burnout:
        moves = [_split_merge_begin(m, d, prior=prior, family=family,
                                    cfg=cfg, k_max=k_max, k_compact=k_c)
                 for m, k_c in zip(models, slabs)]
        accs = passes.run("sm", [(plan, comp) for plan, comp, _ in moves],
                          [acc for _, _, acc in moves], True)
        models = [_split_merge_end(m, plan, comp, acc, k_max)
                  for m, (plan, comp, _), acc in zip(models, moves, accs)]
    return [m.replace(it=m.it + 1) for m in models]


def _resume_state(state: ModelState, family, dev: torch.device
                  ) -> ModelState:
    """A copy of the single-chain ``state`` on ``dev`` (its key words on
    the host) for a fit to continue its chain; raises unless it holds
    ``family``'s params."""
    if not isinstance(state.params, family.params_cls):
        raise ValueError(f"init_state holds {type(state.params).__name__}, "
                         f"not the '{family.name}' family's params")
    put = lambda t: t.detach().to(dev, copy=True)
    return state.replace(
        key=torch.tensor(prng.words_of(state.key), dtype=torch.int64),
        it=int(state.it), active=put(state.active),
        logweights=put(state.logweights),
        sub_logweights=put(state.sub_logweights), stuck=put(state.stuck),
        params=tree_map(put, state.params),
        subparams=tree_map(put, state.subparams),
        stats=tree_map(put, state.stats),
        substats=tree_map(put, state.substats))


def _key_tensor(words) -> torch.Tensor:
    return torch.tensor(prng.words_of(words), dtype=torch.int64)


def _chain_keys(key, n_chains: int) -> List[torch.Tensor]:
    """Chain c's base key: ``fold_in(key, c)``, the key an independent
    single-chain fit of chain c gets (``jax.random.fold_in``'s key data)."""
    return [_key_tensor(prng.fold_in(key, c)) for c in range(n_chains)]


def _recovery_rekey(model: ModelState, n_rollback: int) -> ModelState:
    """The key of a chain after its n-th divergence rollback:
    ``fold_in(key, 2^30 + 1337 + n)`` (the reference's ``_recovery_rekey``):
    replaying the (key, it) stream that just diverged would diverge
    again."""
    return model.replace(key=_key_tensor(
        prng.fold_in(model.key, _RECOVERY_FOLD + n_rollback)))


class _Recovery:
    """A fit's auto-checkpointing and divergence rollback bookkeeping (both
    planes). ``events`` becomes ``FitResult.recoveries``; the tiled plane's
    tile-read events land in it too, in the order they happen."""

    def __init__(self, cfg: DPMMConfig, family_name: str, it_base: int,
                 multi: bool):
        self.cfg = cfg
        self.events: List[dict] = []
        self.n_rollbacks = 0
        self._family = family_name
        self._multi = multi
        self.last_saved = it_base

    def maybe_checkpoint(self, models: Sequence[ModelState], it_abs: int,
                         force: bool = False) -> None:
        """Save a rotation member once ``checkpoint_every`` iterations have
        passed since the last save; ``force`` saves the final state unless
        its iteration is saved already."""
        cfg = self.cfg
        if not (cfg.checkpoint_path and cfg.checkpoint_every):
            return
        due = it_abs - self.last_saved >= cfg.checkpoint_every
        if (force and it_abs > self.last_saved) or due:
            state = stack_chains(models) if self._multi else models[0]
            checkpoint.save_checkpoint(cfg.checkpoint_path, state,
                                       self._family, it_abs,
                                       keep=cfg.checkpoint_keep)
            self.last_saved = it_abs

    def rollback(self, it_abs: int, restored_it: int, detail: str) -> None:
        """Record a divergence rollback; raise once the budget is spent,
        with the event log."""
        self.n_rollbacks += 1
        self.events.append({"kind": "divergence_rollback",
                            "iter": int(it_abs),
                            "restored_it": int(restored_it),
                            "rollback": self.n_rollbacks,
                            "detail": detail})
        if self.n_rollbacks > self.cfg.max_recoveries:
            raise DivergenceError(
                f"chain state went non-finite/degenerate at iteration "
                f"{it_abs} and rollback did not recover it within "
                f"max_recoveries={self.cfg.max_recoveries} attempts — "
                "the divergence is persistent (non-finite input data, or "
                "a numerically hostile configuration). See .recoveries "
                "for the event log.", self.events)


@dataclasses.dataclass
class FitResult:
    """Result of ``DPMM.fit``. With ``n_chains=1`` every field is the one
    chain's; with C > 1 ``state`` has the multi-chain layout
    (``state.stack_chains``), ``labels`` is (C, N), each history (C,
    iters), ``score`` (C,), ``k`` the best-scoring chain's count and
    ``nmi`` / ``ari`` score the best chain; ``chain(c)``, ``select_best()``
    and ``rhat(key)`` are the cross-chain views."""
    state: ModelState            # final model-side state (on the device)
    labels: np.ndarray           # (N,) cluster slot of every point
    k: int
    history: Dict[str, np.ndarray]   # per-iteration k/max/min/score
    iter_times_s: List[float]
    device: str
    peak_bytes: Optional[int] = None  # torch.cuda.max_memory_allocated
    # torch.cuda.memory_allocated when the fit began (the caller's tensors)
    start_bytes: Optional[int] = None
    # the driver: "resident", "tiled" or "distributed" (cfg.workers)
    mode: str = "resident"
    tile_size: Optional[int] = None   # rows of a tile (tiled)
    # the reference's estimate of the tiled plane's device bytes: two
    # model states a chain, the accumulators and two tile buffers
    est_peak_bytes: Optional[int] = None
    # tile-read faults and retries (core/resilience.read_block_checked) and
    # divergence rollbacks, in the order they happened
    recoveries: List[dict] = dataclasses.field(default_factory=list)
    copy_wait_s: Optional[float] = None   # device time waiting on copies
    read_s: Optional[float] = None        # host time reading, staging tiles
    n_chains: int = 1
    # final chain_score: a float (one chain) or (C,)
    score: Any = None
    # the slot capacity of each chunk (resident), k_max='auto''s growth
    slab_sizes: List[int] = dataclasses.field(default_factory=list)
    # cfg.workers: worker count, shard ranges, respawns, reassignments,
    # spawn-to-READY seconds, partial bytes a pass, workers' peak device
    # bytes and kernel launches (dist/coordinator.py)
    dist: Optional[dict] = None
    # the mesh: data and model shards, their devices, rows a shard, the
    # cross-shard reductions and the bytes they gathered, each shard's
    # kernel launches and each card's peak device bytes
    mesh: Optional[dict] = None

    def chain(self, c: int) -> "FitResult":
        """Chain ``c`` as a single-chain result (views, bit for bit)."""
        if self.n_chains == 1:
            if c != 0:
                raise IndexError(f"single-chain result has no chain {c}")
            return self
        if not 0 <= c < self.n_chains:
            raise IndexError(f"no chain {c} of {self.n_chains}")
        state = chain_of(self.state, c)
        return dataclasses.replace(
            self, state=state, labels=self.labels[c],
            k=int(state.k_hat), n_chains=1,
            history={k: v[c] for k, v in self.history.items()},
            score=float(np.asarray(self.score)[c]))

    def select_best(self) -> "FitResult":
        """The chain with the highest final ``score`` (``chain_score``)."""
        if self.n_chains == 1:
            return self
        return self.chain(int(np.argmax(np.asarray(self.score))))

    def rhat(self, key: str = "score") -> float:
        """Split-R-hat (Gelman et al.) over the chains' history traces of
        ``key`` ('score' or 'k'): near 1 when the chains agree."""
        if self.n_chains < 2:
            raise ValueError("rhat needs n_chains >= 2")
        trace = np.asarray(self.history[key], np.float64)   # (C, T)
        half = trace.shape[1] // 2
        if half < 2:
            raise ValueError("rhat needs >= 4 recorded iterations")
        x = np.concatenate([trace[:, :half], trace[:, half:2 * half]])
        n = x.shape[1]
        w = x.var(axis=1, ddof=1).mean()
        b = n * x.mean(axis=1).var(ddof=1)
        if w <= 0.0:
            return 1.0 if b <= 0.0 else float("inf")
        return float(np.sqrt(((n - 1) / n * w + b / n) / w))

    def rhats(self) -> Dict[str, float]:
        return {key: self.rhat(key) for key in ("k", "score")}

    def _against(self, metric, true_labels, n_true: Optional[int]):
        if self.n_chains > 1:
            return self.select_best()._against(metric, true_labels, n_true)
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


def _verdict(models: Sequence[ModelState]) -> torch.Tensor:
    """One health verdict for every chain, on the device."""
    return torch.stack([model_health(m) for m in models]).all()


def _host_rows(rows: List[List[Dict[str, torch.Tensor]]],
               verdict: Optional[torch.Tensor]) -> Tuple[np.ndarray, bool]:
    """Per-chain lists of per-iteration summaries -> a (C, L, 4) host
    table, and the health verdict (True without one), in one copy."""
    table = torch.stack([torch.stack([torch.stack(
        [r[k].to(torch.float32) for k in _HIST_KEYS]) for r in chain])
        for chain in rows])
    flat = table.reshape(-1)
    if verdict is not None:
        flat = torch.cat([flat, verdict.to(torch.float32).reshape(1)])
    host = flat.cpu().numpy()
    healthy = verdict is None or bool(host[-1])
    return host[:table.numel()].reshape(table.shape), healthy


def _history(tables: List[np.ndarray], n_chains: int,
             multi: bool) -> Dict[str, np.ndarray]:
    """The chunks' (C, L, 4) tables -> per-key (C, T) histories ((T,) for
    one chain), ``k`` as int32."""
    table = (np.concatenate(tables, axis=1) if tables
             else np.zeros((n_chains, 0, len(_HIST_KEYS)), np.float32))
    history = {k: np.ascontiguousarray(table[:, :, j])
               for j, k in enumerate(_HIST_KEYS)}
    history["k"] = history["k"].astype(np.int32)
    return history if multi else {k: v[0] for k, v in history.items()}


class DPMM:
    """Sub-cluster split/merge DPMM sampler over a mesh of devices.

    ``mesh`` (``core/distributed.Mesh``): the data shards (and with
    ``cfg.shard_features`` the model shards) of every fit; the model side
    runs on its first device. ``device`` instead: a one-shard mesh on
    it. Neither: ``make_data_mesh()``, every visible card, as the
    reference's ``DPMM(cfg)`` takes every local device."""

    def __init__(self, cfg: DPMMConfig, device=None,
                 mesh: Optional[Mesh] = None):
        if device is not None and mesh is not None:
            raise ValueError("pass device or mesh, not both: a device is "
                             "a one-shard mesh")
        if mesh is None:
            mesh = (make_data_mesh() if device is None
                    else Mesh([resolve_device(device)]))
        self.cfg = cfg
        self.mesh = resolve_mesh(mesh)
        self.device = self.mesh.lead
        self.family: ComponentFamily = get_family(cfg.component)

    @property
    def feature_sharded(self) -> bool:
        """Whether fits split x's features over the mesh's ``model`` axis:
        ``cfg.shard_features`` on a feature-separable family (a Gaussian
        keeps its features whole, as the reference's does)."""
        return (self.cfg.shard_features and self.family.feature_shardable
                and "model" in self.mesh.axis_names)

    def fit(self, x, iters: Optional[int] = None, verbose: bool = False,
            *, n_chains: int = 1, key=None,
            init_state: Optional[ModelState] = None,
            resume: bool = False, dist_hooks=None) -> FitResult:
        """Fit to ``x`` over ``self.mesh``: an (N, d) numpy array or
        tensor, or a ``DataSource``. It streams in tiles when
        ``cfg.tile_size`` is set or the source is not resident, as the
        reference's ``fit`` dispatches.

        ``n_chains=C`` runs C chains, chain c bit for bit the single-chain
        fit with key ``fold_in(key, c)`` (module docstring). ``key`` (two
        uint32 words) overrides the key data of
        ``jax.random.key(cfg.seed)``. ``init_state`` (a ``ModelState``,
        e.g. ``checkpoint.load_model``'s, from either package; (C, K) for
        C chains) resumes its chain: the fit runs ``iters`` MORE iterations
        from it, on copies of its tensors, under the state's own key (so
        passing ``key`` as well is refused). Every draw derives from
        ``(state.key, state.it)``, every sweep recomputes the labels from
        the model and the compact slab is sized from the state each
        iteration, so k iterations, a save and a load, then j more give
        the (k + j)-iteration chain bit for bit at any k.

        ``resume=True`` continues from the newest rotation member under
        ``cfg.checkpoint_path`` that verifies (corrupt members are passed
        over), and ``iters`` is then the TOTAL target: only ``iters -
        it_checkpoint`` iterations run. With no member yet it is a fresh
        fit. It refuses ``init_state``.

        With ``cfg.workers`` the fit runs on the coordinator (on the
        mesh's lead device; the mesh is otherwise ignored, as the
        reference's ``_fit_distributed`` ignores its mesh) and worker
        processes (``repro_torch.dist``), one chain only; ``dist_hooks``
        (a ``repro_torch.dist.DistHooks``) injects worker faults or runs a
        hook each iteration."""
        cfg = self.cfg
        iters = cfg.iters if iters is None else iters
        if n_chains < 1:
            raise ValueError(f"n_chains must be >= 1, got {n_chains}")
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        source = as_source(x)
        if source.n == 0:
            raise ValueError("expected (N, d) points, got N = 0")
        if init_state is not None and key is not None:
            raise ValueError(
                "pass key or init_state, not both: a resumed chain "
                "runs under init_state.key")
        if resume:
            init_state, iters = self._resume(init_state, iters)
        states = None
        if init_state is not None:
            k_chk = (init_state.active.shape[-1] if cfg.k_max == "auto"
                     else cfg.k_max)
            want = (n_chains, k_chk) if n_chains > 1 else (k_chk,)
            got = tuple(init_state.active.shape)
            if got != want:
                raise ValueError(
                    f"init_state.active has shape {got}, expected {want} "
                    f"for n_chains={n_chains}, k_max={cfg.k_max}: "
                    "checkpoint/config/chain-count mismatch")
            states = [_resume_state(
                chain_of(init_state, c) if n_chains > 1 else init_state,
                self.family, self.device) for c in range(n_chains)]
        seed = cfg.seed
        key = _key_tensor((seed >> 32, seed) if key is None else key)
        keys = _chain_keys(key, n_chains) if n_chains > 1 else [key]
        if cfg.workers:
            if n_chains != 1:
                raise ValueError(
                    "cfg.workers does not compose with n_chains > 1 yet: "
                    "chain batching rides the tile bodies, which the "
                    "distributed driver runs per worker shard. Run one "
                    "distributed fit per chain key instead.")
            # imported here: single-process fits never touch the socket
            # and subprocess machinery
            from repro_torch.dist.coordinator import fit_distributed
            return fit_distributed(self, source, iters, verbose, keys,
                                   states, hooks=dist_hooks)
        if cfg.tile_size is None and source.resident() is not None:
            return self._fit_resident(source, iters, verbose, keys, states)
        if cfg.k_max == "auto":
            raise ValueError(
                "k_max='auto' requires the resident data plane: the tiled "
                "fit has no chunk boundary to grow the slab at. Pass an "
                "integer k_max for tiled/out-of-core fits.")
        return self._fit_tiled(source, iters, verbose, keys, states)

    def _resume(self, init_state, iters: int):
        """``fit(resume=True)``: the newest verifying rotation member and
        the iterations left to run, or ``(None, iters)`` with no member."""
        cfg = self.cfg
        if init_state is not None:
            raise ValueError(
                "pass either resume=True (load from cfg.checkpoint_path) "
                "or init_state, not both")
        if not cfg.checkpoint_path:
            raise ValueError(
                "fit(resume=True) needs cfg.checkpoint_path — the rotation "
                "prefix auto-checkpointing saved to")
        try:
            loaded, fam, _, it_ckpt = checkpoint.latest_valid(
                cfg.checkpoint_path, device=self.device)
        except checkpoint.CheckpointNotFound:
            return None, iters          # nothing saved yet: a fresh fit
        if fam.name != self.family.name:
            raise ValueError(
                f"checkpoint at {cfg.checkpoint_path} holds a "
                f"'{fam.name}' model but cfg.component is "
                f"'{self.family.name}'")
        return loaded, max(0, iters - it_ckpt)

    def _setup(self, source: DataSource):
        """The prior from the source's column mean and the device bytes at
        the start (on every card of the mesh, their peaks reset)."""
        cfg, dev = self.cfg, self.device
        col_mean = torch.from_numpy(source.column_mean()).to(dev)
        prior = self.family.build_prior(cfg, col_mean[None, :])
        start = None
        if dev.type == "cuda":
            for card in self._cards():
                torch.cuda.reset_peak_memory_stats(card)
            start = int(torch.cuda.memory_allocated(dev))
        self._reduce0 = reduce_counts()
        return prior, start

    def _cards(self) -> List[torch.device]:
        return list(dict.fromkeys(self.mesh.devices.reshape(-1)))

    def _peak(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.max_memory_allocated(self.device))

    def _mesh_report(self, passes) -> dict:
        """``FitResult.mesh``: the shards, the reductions and bytes since
        ``_setup``, each shard's launches and each card's peak bytes."""
        now = reduce_counts()
        out = dict(passes.shard_report(),
                   reductions=now["reductions"] - self._reduce0["reductions"],
                   reduce_bytes=now["bytes"] - self._reduce0["bytes"])
        if self.device.type == "cuda":
            out["peak_bytes"] = {
                str(c): int(torch.cuda.max_memory_allocated(c))
                for c in self._cards()}
        return out

    def _result(self, models: List[ModelState], labels: np.ndarray,
                history: Dict[str, np.ndarray], multi: bool,
                **fields) -> FitResult:
        """A ``FitResult``; for C > 1 the multi-chain layout and the best
        chain's ``k``."""
        if not multi:
            score = (float(history["score"][-1]) if history["score"].size
                     else None)
            return FitResult(state=models[0], labels=labels,
                             k=int(models[0].k_hat), history=history,
                             device=str(self.device), score=score,
                             peak_bytes=self._peak(), **fields)
        score = (np.asarray(history["score"][:, -1])
                 if history["score"].size
                 else np.zeros((len(models),), np.float32))
        best = int(np.argmax(score))
        return FitResult(state=stack_chains(models), labels=labels,
                         k=int(models[best].k_hat), history=history,
                         device=str(self.device), n_chains=len(models),
                         score=score, peak_bytes=self._peak(), **fields)

    def _index_space(self, rows: int) -> None:
        if rows >= 2 ** 32:
            raise ValueError(
                f"N padded to {rows} rows over the mesh exceeds the uint32 "
                "global point-index space: the counter-based draws would "
                "wrap and silently corrupt the chain")

    def _fit_resident(self, source: DataSource, iters: int, verbose: bool,
                      keys: List[torch.Tensor],
                      init_states: Optional[List[ModelState]]) -> FitResult:
        """The resident plane: each data shard's rows on its device(s) for
        the whole fit (``shard_points``), every pass of an iteration a
        tile body on each shard, whole, and the pass's one reduction
        (``ResidentPasses``); the history rows reach the host once a
        ``log_every`` chunk."""
        cfg, family = self.cfg, self.family
        x_np = source.resident()
        n, d = x_np.shape
        multi = len(keys) > 1
        auto = cfg.k_max == "auto"
        if init_states is not None:
            k_slab = int(init_states[0].active.shape[0])
        elif auto:
            k_slab = min(cfg.k_max_cap, max(8, 2 * cfg.init_clusters))
        else:
            k_slab = cfg.k_max
        k_cap = cfg.k_max_cap if auto else k_slab
        prior, start = self._setup(source)
        xs, vs = shard_points(self.mesh, x_np, self.feature_sharded)
        n_local = vs[0].shape[0]
        self._index_space(len(vs) * n_local)
        passes = ResidentPasses(
            family, cfg, self.device,
            [Shard(x=xt, valid=vt, base=s * n_local,
                   labels=[None] * len(keys), sublabels=[None] * len(keys))
             for s, (xt, vt) in enumerate(zip(xs, vs))],
            n_chains=len(keys), k_max=k_slab, n=n)
        del xs, vs
        if init_states is None:
            models = _init_models(passes, keys, prior, family, cfg, d)
            it_base, k0 = 0, cfg.init_clusters
        else:
            models = init_states       # every sweep recomputes the labels
            it_base = int(models[0].it)
            k0 = max(int(m.k_hat) for m in models)
        rec = _Recovery(cfg, family.name, it_base, multi)
        # the rollback anchor: deep copies at the last healthy boundary
        anchor = (([clone_model(m) for m in models], 0, k_slab)
                  if cfg.guardrails else None)
        tables: List[np.ndarray] = []
        times: List[float] = []
        slabs: List[int] = []
        done = 0
        while done < iters:
            length = min(cfg.log_every, iters - done)
            if auto and 2 * k0 > k_slab and k_slab < k_cap:
                while 2 * k0 > k_slab and k_slab < k_cap:
                    k_slab = min(k_cap, 2 * k_slab)
                models = [grow_model(m, k_slab) for m in models]
            passes.k_max = k_slab
            t0 = time.perf_counter()
            rows: List[List[Dict[str, torch.Tensor]]] = [[] for _ in models]
            for _ in range(length):
                models = _step_models(
                    models, passes,
                    [_slab(int(m.k_hat), cfg, k_slab) for m in models],
                    prior, family, cfg, d)
                for c, m in enumerate(models):
                    rows[c].append(_summaries(m, prior, family, cfg.alpha))
            table, healthy = _host_rows(                # one sync
                rows, _verdict(models) if cfg.guardrails else None)
            dt = time.perf_counter() - t0
            if not healthy:
                snap, snap_done, k_slab = anchor
                rec.rollback(it_base + done + length, it_base + snap_done,
                             "non-finite/degenerate model state after "
                             "resident chunk")
                models = [_recovery_rekey(clone_model(m), rec.n_rollbacks)
                          for m in snap]
                done = snap_done
                k0 = max(int(m.k_hat) for m in snap)
                continue                   # the failed chunk leaves no rows
            times.extend([dt / length] * length)
            tables.append(table)
            slabs.append(k_slab)
            k0 = int(table[:, -1, 0].max())
            done += length
            if cfg.guardrails:
                anchor = ([clone_model(m) for m in models], done, k_slab)
            rec.maybe_checkpoint(models, it_base + done)
            if verbose:
                ks = table[:, -1, 0].astype(int).tolist()
                print(f"iter {it_base + done:4d}  "
                      f"K={ks if multi else ks[0]}  "
                      f"{dt / length * 1e3:.1f} ms/iter")
        rec.maybe_checkpoint(models, it_base + done, force=True)
        labels = passes.labels()
        return self._result(
            models, labels if multi else labels[0],
            _history(tables, len(models), multi), multi,
            iter_times_s=times, start_bytes=start, recoveries=rec.events,
            slab_sizes=slabs, mesh=self._mesh_report(passes))

    def _fit_tiled(self, source: DataSource, iters: int, verbose: bool,
                   keys: List[torch.Tensor],
                   init_states: Optional[List[ModelState]],
                   open_passes=None) -> FitResult:
        """The streamed plane (``repro.core.sampler.DPMM._fit_tiled``):
        two init passes, then per iteration a sweep pass and, after
        ``burnout``, a split/merge pass over the rows (``_step_models``),
        every chain on each tile read, every data shard of the mesh
        streaming tile t of its rows before tile t + 1 of any
        (``StreamPasses``). The compact slabs
        follow the resident plane's rule (``_slab``: from the live count
        at each iteration's start, headroom 2, the count read with the
        previous iteration's history row), not the reference tiled plane's
        headroom 1: the Threefry top bin (ROADMAP.md §3) lets an inactive
        slot's +inf noise win only where the slot is in the slab, so the
        slab is part of the chain, and the same rule keeps the two planes'
        chains equal. The guardrails' verdict rides each iteration's
        history row; a rollback leaves the host label arrays as they are
        (every sweep recomputes the labels).

        The passes run on ``open_passes(events)``'s runner, by default
        ``StreamPasses`` (the tiles in this process); the multi-process
        driver (``repro_torch.dist.coordinator``) passes its workers'."""
        cfg, family, dev = self.cfg, self.family, self.device
        n, d = source.n, source.d
        k_max = cfg.k_max
        multi = len(keys) > 1
        n_chains = len(keys)
        if open_passes is None:
            grid = self.mesh.grid()
            self._index_space(grid.shape[0]
                              * tile_plan(n, grid.shape[0], None)[0])
            open_passes = lambda events: StreamPasses(
                self, source, events, n_chains, grid, self.feature_sharded)
        else:
            self._index_space(n)
        prior, start = self._setup(source)
        rec = _Recovery(cfg, family.name, 0, multi)
        passes = open_passes(rec.events)
        tables: List[np.ndarray] = []
        times: List[float] = []
        it = 0
        try:
            if init_states is None:
                models = _init_models(passes, keys, prior, family, cfg, d)
                ks = [cfg.init_clusters] * n_chains
            else:
                models = init_states   # every sweep recomputes the labels
                ks = [int(m.k_hat) for m in models]
            it0 = int(models[0].it)
            rec.last_saved = it0
            acc_bytes = _nbytes(gibbs.empty_substats(family, k_max, d, dev))
            est_peak = (2 * sum(_nbytes(m) for m in models)
                        + n_chains * acc_bytes
                        + passes.buffer_bytes(acc_bytes))
            anchor = (([clone_model(m) for m in models], 0, list(ks))
                      if cfg.guardrails else None)
            while it < iters:
                t0 = time.perf_counter()
                models = _step_models(
                    models, passes, [_slab(k, cfg, k_max) for k in ks],
                    prior, family, cfg, d)
                table, healthy = _host_rows(            # one sync
                    [[_summaries(m, prior, family, cfg.alpha)]
                     for m in models],
                    _verdict(models) if cfg.guardrails else None)
                if not healthy:
                    snap, snap_it, snap_ks = anchor
                    rec.rollback(it0 + it + 1, it0 + snap_it,
                                 "non-finite/degenerate model state after "
                                 "tiled iteration")
                    models = [_recovery_rekey(clone_model(m),
                                              rec.n_rollbacks)
                              for m in snap]
                    it, ks = snap_it, list(snap_ks)
                    continue               # the failed iteration: no rows
                ks = [int(v) for v in table[:, -1, 0]]
                tables.append(table)
                times.append(time.perf_counter() - t0)
                it += 1
                if cfg.guardrails:
                    anchor = ([clone_model(m) for m in models], it, list(ks))
                rec.maybe_checkpoint(models, it0 + it)
                if verbose and (it % cfg.log_every == 0 or it == iters):
                    span = times[-(it % cfg.log_every or cfg.log_every):]
                    print(f"iter {it0 + it:4d}  K={ks if multi else ks[0]}  "
                          f"{np.mean(span) * 1e3:.1f} ms/iter")
            rec.maybe_checkpoint(models, it0 + it, force=True)
        finally:
            passes.close()
        labels = passes.labels()
        return self._result(
            models, labels if multi else labels[0],
            _history(tables, n_chains, multi), multi, iter_times_s=times,
            start_bytes=start, tile_size=passes.tile,
            est_peak_bytes=int(est_peak), recoveries=rec.events,
            mesh=(self._mesh_report(passes)
                  if isinstance(passes, StreamPasses) else None),
            **passes.report())


def tile_body(phase: str, args: tuple, x, off: int,
              valid: torch.Tensor, labels, sublabels, acc, family,
              cfg: DPMMConfig, k_max: Optional[int] = None):
    """One chain's body of a pass on the rows ``off .. off + len(x)`` of
    the padded layout (a tile, or a resident shard whole: ``off`` is the
    global index of its first row): ``(labels, sublabels, acc')``. ``x``
    is a tensor, or a feature-sharded shard's ``FeatureShards`` (``acc``
    then the list of its slices' accumulators). The phases and their
    ``args``:

    - ``init1`` ``()``: round-robin labels, zero sub-labels;
    - ``init2`` ``(means0, v0)``: hyperplane sub-labels of ``labels``
      around the initial means;
    - ``sweep`` ``(model, key_z, key_zb, comp)``: steps (e)/(f) under the
      model after steps (a)-(d) (``gibbs.sweep_tile``), on the compact slab
      of ``comp`` when it is not None;
    - ``sm`` ``(plan, comp)``: the planned move on ``labels`` /
      ``sublabels`` (``splitmerge.split_merge_tile``).

    Each folds the rows' sub-cluster stats into ``acc`` (the init phases
    on ``k_max`` slots, default ``cfg.k_max``); ``acc=None`` returns the
    kernels' per-STATS_BLOCK partials unfolded instead (a worker process
    ships them and its coordinator folds them in global block order)."""
    k_max = cfg.k_max if k_max is None else k_max
    if phase == "sweep":
        model, key_z, key_zb, comp = args
        point = PointState(labels=None, sublabels=None, valid=valid)
        gidx = gibbs.global_indices(x.shape[0], x.device, off)
        point, acc = gibbs.sweep_tile(model, x, point, gidx, acc, family,
                                      key_z, key_zb, plan=comp)
        return point.labels, point.sublabels, acc
    if phase == "sm":
        plan, comp = args
        point = PointState(labels=labels, sublabels=sublabels, valid=valid)
        point, acc = splitmerge.split_merge_tile(plan, x, point, acc, family,
                                                 compaction=comp)
        return point.labels, point.sublabels, acc
    if phase == "init1":
        labels = _init_labels(gibbs.global_indices(x.shape[0], x.device, off),
                              cfg.init_clusters)
        sublabels = torch.zeros_like(labels)
    elif phase == "init2":
        means0, v0 = args
        sublabels = splitmerge.hyperplane_bits(x, labels, means0, v0)
    else:
        raise ValueError(f"unknown tiled pass {phase!r}")
    if acc is None:
        return labels, sublabels, family.label_partials(
            x, valid, labels, sublabels, k_max)
    return labels, sublabels, family.stats_from_labels(
        x, valid, labels, sublabels, k_max, acc=acc)


class _ShardPasses:
    """What both in-process planes share. A pass runs every chain's
    ``tile_body`` on each data shard, the model side's arguments copied to
    each shard's device once (``distributed.replicated``; a shard on the
    lead device uses the lead's tensors), each shard folding an
    accumulator of its own from zero; the pass ends in its one ordered
    reduction (``distributed.reduce_stats``) on the lead device. Each
    shard's kernel launches are counted apart (``ops.launch_counts``
    around its bodies)."""

    def __init__(self, family, cfg: DPMMConfig, lead: torch.device,
                 n_chains: int, k_max: int, n: int, n_shards: int):
        self.family, self.cfg, self.lead = family, cfg, lead
        self.chains, self.k_max, self.n = n_chains, k_max, n
        self.launches = [dict.fromkeys(ops.launch_counts(), 0)
                         for _ in range(n_shards)]

    def _zeros(self, acc, devs, cols):
        """A shard's zero accumulator of ``acc``'s slab on its device
        ``devs[0]``, or with feature columns ``cols`` one a slice, on the
        slice's device."""
        k = acc.n.shape[0]
        if cols is None:
            return gibbs.empty_substats(self.family, k, self.d, devs[0])
        return [gibbs.empty_substats(self.family, k, b - a, dev)
                for dev, (a, b) in zip(devs, cols)]

    def _counted(self, s: int, body):
        before = ops.launch_counts()
        out = body()
        for k, v in ops.launch_counts().items():
            self.launches[s][k] += v - before[k]
        return out

    def _reduce(self, per_shard: List[Any]) -> Any:
        return reduce_stats(self.family, per_shard, self.lead)


def _placement(x) -> Tuple[List[torch.device], Optional[list]]:
    """A resident shard's devices and feature columns (None: whole)."""
    if isinstance(x, FeatureShards):
        return [xs.device for xs in x.slices], x.cols
    return [x.device], None


class ResidentPasses(_ShardPasses):
    """The resident plane's passes: ``shards`` (``distributed.Shard``)
    hold their rows on their devices for the whole fit and every chain's
    labels; a pass runs each shard whole as one tile."""

    def __init__(self, family, cfg: DPMMConfig, lead: torch.device,
                 shards: List[Shard], n_chains: int, k_max: int, n: int):
        super().__init__(family, cfg, lead, n_chains, k_max, n, len(shards))
        self.shards = shards
        self.d = shards[0].x.shape[1]

    def run(self, phase: str, chain_args: List[tuple], accs: list,
            labels_in: bool) -> list:
        """One pass of ``phase``: chain c's body with ``chain_args[c]`` on
        every shard, then the reduction; one entry for all chains
        (``init1``) labels every chain alike. ``accs`` give the slabs.
        Returns the reduced accs."""
        reps = replicated([sh.device for sh in self.shards], chain_args)
        out = []
        for c, acc in enumerate(accs):
            per_shard = []
            for s, sh in enumerate(self.shards):
                lab, sub, sacc = self._counted(s, lambda: tile_body(
                    phase, reps[sh.device][c], sh.x, sh.base, sh.valid,
                    sh.labels[c] if labels_in else None,
                    sh.sublabels[c] if labels_in else None,
                    self._zeros(acc, *_placement(sh.x)), self.family,
                    self.cfg, k_max=self.k_max))
                for cc in (range(self.chains) if len(accs) == 1 else (c,)):
                    sh.labels[cc], sh.sublabels[cc] = lab, sub
                per_shard.append(sacc)
            out.append(self._reduce(per_shard))
        return out

    def point(self, c: int) -> PointState:
        """Chain c's point state of a one-shard plane."""
        (sh,) = self.shards
        return PointState(labels=sh.labels[c], sublabels=sh.sublabels[c],
                          valid=sh.valid)

    def labels(self) -> np.ndarray:
        """(C, N) labels on the host, the padding cut off."""
        rows = [np.concatenate([
            (np.zeros(sh.valid.shape[0], np.int32) if sh.labels[c] is None
             else sh.labels[c].cpu().numpy()) for sh in self.shards])
            for c in range(self.chains)]
        return np.stack(rows)[:, :self.n]

    def shard_report(self) -> dict:
        devs = [[str(xs.device) for xs in sh.x.slices]
                if isinstance(sh.x, FeatureShards) else [str(sh.device)]
                for sh in self.shards]
        return dict(data_shards=len(self.shards), model_shards=len(devs[0]),
                    devices=devs, n_local=int(self.shards[0].valid.shape[0]),
                    shard_launches=self.launches)


class StreamPasses(_ShardPasses):
    """The tiled plane's passes in this process: one ``TileStream`` a data
    shard of ``grid`` (``Mesh.grid``), on its first device, reading its
    rows ``[s n_local, (s + 1) n_local)`` of the padded layout (rows past
    N read as zeros, ``valid = 0``), the shards' streams walked in
    lockstep (``run_streams``); each tile is read and uploaded once a pass
    for every chain. With ``feature_sharded`` a tile's features are cut
    into the model shards' slices on the shard's devices. The host label
    arrays are (C, G n_local)."""

    def __init__(self, dpmm: DPMM, source: DataSource, events: List[dict],
                 n_chains: int, grid: np.ndarray, feature_sharded: bool):
        cfg = dpmm.cfg
        n_local, tiles = tile_plan(source.n, grid.shape[0], cfg.tile_size)
        super().__init__(dpmm.family, cfg, dpmm.device, n_chains, cfg.k_max,
                         source.n, grid.shape[0])
        self.grid = grid if feature_sharded else grid[:, :1]
        self.feature_sharded = feature_sharded
        self.tile, self.d, self.n_local = tiles[0][1], source.d, n_local
        policy = RetryPolicy(max_retries=cfg.io_retries,
                             backoff_s=cfg.io_backoff_s,
                             guard_nonfinite=cfg.guard_tiles)
        self.streams = [
            TileStream(source, [(s * n_local + off, length)
                                for off, length in tiles],
                       devs[0], policy, events.append, chains=n_chains)
            for s, devs in enumerate(self.grid)]
        rows = grid.shape[0] * n_local
        self.labels_h = np.zeros((n_chains, rows), np.int32)
        self.sublabels_h = np.zeros((n_chains, rows), np.int32)
        self.ones = {dev: torch.ones((self.tile,), dtype=torch.float32,
                                     device=dev)
                     for dev in dict.fromkeys(self.grid[:, 0])}

    def _valid(self, t, dev) -> torch.Tensor:
        """The tile's mask: 1 on the rows of x, 0 on the padding."""
        if t.off + t.length <= self.n:
            return self.ones[dev][:t.length]
        rows = torch.arange(t.off, t.off + t.length, device=dev)
        return (rows < self.n).to(torch.float32)

    def run(self, phase: str, chain_args: List[tuple], accs: list,
            labels_in: bool) -> list:
        """One pass of ``phase`` over every tile of every shard: chain c's
        ``tile_body`` with ``chain_args[c]`` folding into the shard's
        accumulator of ``accs[c]``'s slab, then the reduction; one entry
        for all chains (``init1``) labels every chain alike. Returns the
        reduced accs."""
        reps = replicated(self.grid[:, 0], chain_args)

        def shard_fn(s):
            devs = self.grid[s]

            def pass_fn(t, shard_accs):
                x = (FeatureShards.split(t.x, devs) if self.feature_sharded
                     else t.x)
                valid = self._valid(t, devs[0])
                outs, new = [], []
                for c, (args, acc) in enumerate(zip(reps[devs[0]],
                                                    shard_accs)):
                    lab, sub, acc = self._counted(s, lambda: tile_body(
                        phase, args, x, t.off, valid,
                        t.labels[c] if labels_in else None,
                        t.sublabels[c] if labels_in else None, acc,
                        self.family, self.cfg, k_max=self.k_max))
                    outs.append((lab, sub))
                    new.append(acc)
                return outs * (self.chains // len(outs)), new
            return pass_fn

        g = len(self.streams)
        cols = (feature_cols(self.d, self.grid.shape[1])
                if self.feature_sharded else None)
        zeros = [[self._zeros(acc, self.grid[s], cols) for acc in accs]
                 for s in range(g)]
        per_shard = run_streams(self.streams, [shard_fn(s) for s in range(g)],
                                zeros, self.labels_h, self.sublabels_h,
                                labels_in)
        return [self._reduce([per_shard[s][c] for s in range(g)])
                for c in range(len(accs))]

    def buffer_bytes(self, acc_bytes: int) -> int:
        """The reference's estimate of the two tile buffers' bytes, every
        shard's."""
        return (2 * len(self.streams) * self.tile
                * (4 * self.d + 8 * self.chains))

    def labels(self) -> np.ndarray:
        return self.labels_h[:, :self.n].copy()

    def report(self) -> dict:
        cuda = self.streams[0].cuda
        return dict(mode="tiled",
                    copy_wait_s=(sum(st.wait_s for st in self.streams)
                                 if cuda else None),
                    read_s=sum(st.read_s for st in self.streams))

    def shard_report(self) -> dict:
        return dict(data_shards=len(self.streams),
                    model_shards=self.grid.shape[1],
                    devices=[[str(d) for d in devs] for devs in self.grid],
                    n_local=self.n_local, shard_launches=self.launches)

    def close(self) -> None:
        pass

