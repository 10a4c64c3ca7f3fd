"""The port's DPMM sampler: ``DPMM.fit`` on two data planes.

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
The resident plane holds x on the device once and a ``PointState`` a
chain, and runs each iteration chain after chain; the tiled plane reads
and uploads each tile once a pass for all chains (``TileStream`` with (C,
n) host labels), each chain folding its own accumulator left to right.
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
    >>> result = DPMM(DPMMConfig(iters=100)).fit(x)   # on "cuda"
    >>> result.k, result.nmi(true_labels)
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
from repro_torch.core.distributed import tile_plan
from repro_torch.core.family import ComponentFamily, get_family
from repro_torch.core.metrics import ari, nmi
from repro_torch.core.resilience import (DivergenceError, RetryPolicy,
                                         model_health)
from repro_torch.core.state import (ModelState, PointState, chain_of,
                                    clone_model, grow_model, stack_chains,
                                    tree_map)
from repro_torch.core.stream import TileStream
from repro_torch.data.source import DataSource, as_source
from repro_torch.kernels import prng

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


def _init_local(key, x, valid, *, prior, family, cfg,
                k_max: int) -> Tuple[ModelState, PointState]:
    """Initial state: round-robin labels, then hyperplane sub-labels
    around the initial cluster means."""
    gidx = gibbs.global_indices(x.shape[0], x.device)
    labels = _init_labels(gidx, cfg.init_clusters)
    stats0, _ = gibbs.compute_stats(family, x, valid, labels,
                                    torch.zeros_like(labels), k_max)
    means0 = family.cluster_means(stats0)
    v0 = _init_vecs(key, k_max, x.shape[1], x.device)
    sublabels = splitmerge.hyperplane_bits(x, labels, means0, v0)
    stats, substats = gibbs.compute_stats(family, x, valid, labels,
                                          sublabels, k_max)
    return (_init_model(key, stats, substats, prior=prior, family=family,
                        cfg=cfg, k_max=k_max),
            PointState(labels=labels, sublabels=sublabels, valid=valid))


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


def _split_merge(model: ModelState, point: PointState, x, *, prior, family,
                 cfg, k_max: int, k_compact=None
                 ) -> Tuple[ModelState, PointState]:
    """Plan (O(K)), apply to the points, fold the consistency stats, on
    the slab ``_split_merge_begin`` sizes from ``k_compact``."""
    plan, comp, acc = _split_merge_begin(
        model, x.shape[1], prior=prior, family=family, cfg=cfg,
        k_max=k_max, k_compact=k_compact)
    point, acc = splitmerge.split_merge_tile(plan, x, point, acc, family,
                                             compaction=comp)
    return _split_merge_end(model, plan, comp, acc, k_max), point


def dpmm_step(model: ModelState, point: PointState, x, *, prior, family,
              cfg, k_max: int, k_compact=None
              ) -> Tuple[ModelState, PointState]:
    """One full iteration."""
    model, point = gibbs.sweep(model, point, x, prior, family, cfg.alpha,
                               k_compact=k_compact)
    if model.it >= cfg.burnout:
        model, point = _split_merge(model, point, x, prior=prior,
                                    family=family, cfg=cfg, k_max=k_max,
                                    k_compact=k_compact)
    return model.replace(it=model.it + 1), point


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
    mode: str = "resident"       # the data plane: "resident" or "tiled"
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
    """Sub-cluster split/merge DPMM sampler on one device."""

    def __init__(self, cfg: DPMMConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.family: ComponentFamily = get_family(cfg.component)

    def fit(self, x, iters: Optional[int] = None, verbose: bool = False,
            *, n_chains: int = 1, key=None,
            init_state: Optional[ModelState] = None,
            resume: bool = False) -> FitResult:
        """Fit to ``x`` on ``self.device``: an (N, d) numpy array or
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
        fit. It refuses ``init_state``."""
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
        the start."""
        cfg, dev = self.cfg, self.device
        col_mean = torch.from_numpy(source.column_mean()).to(dev)
        prior = self.family.build_prior(cfg, col_mean[None, :])
        start = None
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            start = int(torch.cuda.memory_allocated(dev))
        return prior, start

    def _peak(self) -> Optional[int]:
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.max_memory_allocated(self.device))

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

    def _fit_resident(self, source: DataSource, iters: int, verbose: bool,
                      keys: List[torch.Tensor],
                      init_states: Optional[List[ModelState]]) -> FitResult:
        cfg, family, dev = self.cfg, self.family, self.device
        x = torch.from_numpy(np.ascontiguousarray(source.resident()))
        x = x.to(device=dev, dtype=torch.float32)
        n = x.shape[0]
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
        valid = torch.ones((n,), dtype=torch.float32, device=dev)

        def fresh_point() -> PointState:
            # every sweep recomputes the labels from the model
            zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
            return PointState(labels=zeros, sublabels=zeros.clone(),
                              valid=valid)

        if init_states is None:
            pairs = [_init_local(k, x, valid, prior=prior, family=family,
                                 cfg=cfg, k_max=k_slab) for k in keys]
            models = [m for m, _ in pairs]
            points = [p for _, p in pairs]
            it_base, k0 = 0, cfg.init_clusters
        else:
            models = init_states
            points = [fresh_point() for _ in models]
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
            step = dict(prior=prior, family=family, cfg=cfg, k_max=k_slab)
            t0 = time.perf_counter()
            rows: List[List[Dict[str, torch.Tensor]]] = [[] for _ in models]
            for _ in range(length):
                for c, (m, p) in enumerate(zip(models, points)):
                    models[c], points[c] = dpmm_step(
                        m, p, x, k_compact=_slab(int(m.k_hat), cfg, k_slab),
                        **step)
                    rows[c].append(_summaries(models[c], prior, family,
                                              cfg.alpha))
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
                points = [fresh_point() for _ in models]
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
        labels = np.stack([p.labels.cpu().numpy() for p in points])
        return self._result(
            models, labels if multi else labels[0],
            _history(tables, len(models), multi), multi,
            iter_times_s=times, start_bytes=start, recoveries=rec.events,
            slab_sizes=slabs)

    def _tiled_step(self, models: List[ModelState], run,
                    slabs: List[Optional[int]], ones: torch.Tensor, prior,
                    d: int) -> List[ModelState]:
        """One iteration of every chain over the tiles: the sweep pass,
        then after ``burnout`` the split/merge pass, each tile read once a
        pass for all chains; ``run(pass_fn, accs, labels_in)`` streams one
        pass."""
        cfg, family, dev = self.cfg, self.family, self.device
        k_max = cfg.k_max
        begun = [gibbs.sweep_begin(m, prior, family, cfg.alpha)
                 for m in models]
        comps = [gibbs.sweep_compaction(m, k_c)
                 for (m, _, _), k_c in zip(begun, slabs)]

        def sweep_pass(t, accs):
            point = PointState(labels=None, sublabels=None,
                               valid=ones[:t.length])
            gidx = gibbs.global_indices(t.length, dev, t.off)
            outs, new = [], []
            for (m, key_z, key_zb), comp, acc in zip(begun, comps, accs):
                p, acc = gibbs.sweep_tile(m, t.x, point, gidx, acc, family,
                                          key_z, key_zb, plan=comp)
                outs.append((p.labels, p.sublabels))
                new.append(acc)
            return outs, new

        accs = run(sweep_pass, [gibbs.sweep_acc(m, family, comp, d)
                                for (m, _, _), comp in zip(begun, comps)],
                   False)
        models = [gibbs.sweep_end(m, acc, comp)
                  for (m, _, _), acc, comp in zip(begun, accs, comps)]
        if models[0].it >= cfg.burnout:
            moves = [_split_merge_begin(m, d, prior=prior, family=family,
                                        cfg=cfg, k_max=k_max, k_compact=k_c)
                     for m, k_c in zip(models, slabs)]

            def sm_pass(t, accs):
                outs, new = [], []
                for c, ((plan, comp, _), acc) in enumerate(zip(moves,
                                                               accs)):
                    point = PointState(labels=t.labels[c],
                                       sublabels=t.sublabels[c],
                                       valid=ones[:t.length])
                    point, acc = splitmerge.split_merge_tile(
                        plan, t.x, point, acc, family, compaction=comp)
                    outs.append((point.labels, point.sublabels))
                    new.append(acc)
                return outs, new

            accs = run(sm_pass, [acc for _, _, acc in moves], True)
            models = [_split_merge_end(m, plan, comp, acc, k_max)
                      for m, (plan, comp, _), acc in zip(models, moves, accs)]
        return [m.replace(it=m.it + 1) for m in models]

    def _tiled_init(self, run, ones: torch.Tensor, keys: List[torch.Tensor],
                    prior, d: int) -> List[ModelState]:
        """The initial states over the tiles, in two passes: round-robin
        labels and their stats (the same for every chain, folded once),
        then each chain's hyperplane sub-labels around the initial cluster
        means (``_init_local``'s, tile by tile)."""
        cfg, family, dev = self.cfg, self.family, self.device
        k_max = cfg.k_max

        def init1(t, acc):
            gidx = gibbs.global_indices(t.length, dev, t.off)
            labels = _init_labels(gidx, cfg.init_clusters)
            zeros = torch.zeros_like(labels)
            return [(labels, zeros)] * len(keys), family.stats_from_labels(
                t.x, ones[:t.length], labels, zeros, k_max, acc=acc)

        acc = run(init1, gibbs.empty_substats(family, k_max, d, dev), False)
        stats0, _ = gibbs.finalize_substats(acc)
        means0 = family.cluster_means(stats0)
        vecs = [_init_vecs(key, k_max, d, dev) for key in keys]

        def init2(t, accs):
            outs, new = [], []
            for c, (v0, acc) in enumerate(zip(vecs, accs)):
                lab = t.labels[c]
                sub = splitmerge.hyperplane_bits(t.x, lab, means0, v0)
                outs.append((lab, sub))
                new.append(family.stats_from_labels(
                    t.x, ones[:t.length], lab, sub, k_max, acc=acc))
            return outs, new

        accs = run(init2, [gibbs.empty_substats(family, k_max, d, dev)
                           for _ in keys], True)
        return [_init_model(key, *gibbs.finalize_substats(acc), prior=prior,
                            family=family, cfg=cfg, k_max=k_max)
                for key, acc in zip(keys, accs)]

    def _fit_tiled(self, source: DataSource, iters: int, verbose: bool,
                   keys: List[torch.Tensor],
                   init_states: Optional[List[ModelState]]) -> FitResult:
        """The streamed plane (``repro.core.sampler.DPMM._fit_tiled`` on
        one device): two init passes, then per iteration a sweep pass and,
        after ``burnout``, a split/merge pass over the tiles
        (``_tiled_step``), every chain on each tile read. The compact slabs
        follow the resident plane's rule (``_slab``: from the live count
        at each iteration's start, headroom 2, the count read with the
        previous iteration's history row), not the reference tiled plane's
        headroom 1: the Threefry top bin (ROADMAP.md §3) lets an inactive
        slot's +inf noise win only where the slot is in the slab, so the
        slab is part of the chain, and the same rule keeps the two planes'
        chains equal. The guardrails' verdict rides each iteration's
        history row; a rollback leaves the host label arrays as they are
        (every sweep recomputes the labels)."""
        cfg, family, dev = self.cfg, self.family, self.device
        n, d = source.n, source.d
        if n >= 2 ** 32:
            raise ValueError(
                f"N={n} exceeds the uint32 global point-index space: the "
                "counter-based draws would wrap and silently corrupt the "
                "chain")
        n_local, tiles = tile_plan(n, cfg.tile_size)
        k_max = cfg.k_max
        multi = len(keys) > 1
        n_chains = len(keys)
        prior, start = self._setup(source)
        rec = _Recovery(cfg, family.name, 0, multi)
        stream = TileStream(source, tiles, dev,
                            RetryPolicy(max_retries=cfg.io_retries,
                                        backoff_s=cfg.io_backoff_s,
                                        guard_nonfinite=cfg.guard_tiles),
                            rec.events.append, chains=n_chains)
        labels_h = np.zeros((n_chains, n_local), np.int32)
        sublabels_h = np.zeros((n_chains, n_local), np.int32)
        ones = torch.ones((tiles[0][1],), dtype=torch.float32, device=dev)
        run = lambda fn, acc, labels_in: stream.run(fn, acc, labels_h,
                                                    sublabels_h, labels_in)

        if init_states is None:
            models = self._tiled_init(run, ones, keys, prior, d)
            ks = [cfg.init_clusters] * n_chains
        else:
            models = init_states       # every sweep recomputes the labels
            ks = [int(m.k_hat) for m in models]
        it0 = int(models[0].it)
        rec.last_saved = it0
        est_peak = (2 * sum(_nbytes(m) for m in models)
                    + n_chains * _nbytes(gibbs.empty_substats(
                        family, k_max, d, dev))
                    + 2 * tiles[0][1] * (4 * d + 8 * n_chains))

        anchor = (([clone_model(m) for m in models], 0, list(ks))
                  if cfg.guardrails else None)
        tables: List[np.ndarray] = []
        times: List[float] = []
        it = 0
        while it < iters:
            t0 = time.perf_counter()
            models = self._tiled_step(
                models, run, [_slab(k, cfg, k_max) for k in ks], ones, prior,
                d)
            table, healthy = _host_rows(                # one sync
                [[_summaries(m, prior, family, cfg.alpha)] for m in models],
                _verdict(models) if cfg.guardrails else None)
            if not healthy:
                snap, snap_it, snap_ks = anchor
                rec.rollback(it0 + it + 1, it0 + snap_it,
                             "non-finite/degenerate model state after "
                             "tiled iteration")
                models = [_recovery_rekey(clone_model(m), rec.n_rollbacks)
                          for m in snap]
                it, ks = snap_it, list(snap_ks)
                continue                   # the failed iteration: no rows
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
        labels = labels_h[:, :n].copy()
        return self._result(
            models, labels if multi else labels[0],
            _history(tables, n_chains, multi), multi, iter_times_s=times,
            start_bytes=start, mode="tiled", tile_size=tiles[0][1],
            est_peak_bytes=int(est_peak), recoveries=rec.events,
            copy_wait_s=stream.wait_s if stream.cuda else None,
            read_s=stream.read_s)
