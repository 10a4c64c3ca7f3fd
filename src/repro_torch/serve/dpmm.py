"""Live DPMM serving: ladder dispatch and hot swap, on the card.

Port of ``repro.serve.dpmm``. A ``DPMMEngine`` wraps a fitted
``ModelState`` (``DPMM.fit(...).state``, or a checkpoint of either
package, ``core/checkpoint.py``) and answers batched queries:

- ``predict(x)``: hard cluster assignment, argmax_k p(k | x);
- ``predict_logprobs(x)``: log p(k | x) over the K_max slots (inactive
  slots are -1e30);
- ``log_predictive(x)``: log p(x) under the mixture;
- ``sample(x)``: a posterior draw of the assignment, the sampler's step (e)
  (``ComponentFamily.assign``, the ``assign_gauss`` / ``assign_linear``
  kernels) with Gumbel counters on the request row index.

``query(x)`` gives all of them as one :class:`ServeResult`, whose
``to_json()`` is the reference's wire schema field for field
(``launch/serve_dpmm.py`` writes exactly it).

**Ladder.** ``ServeConfig.batch_sizes`` (default 256/2048/8192) are the
step sizes; a request routes to the smallest covering step, a longer one
takes largest-size chunks first and then one covering tail step
(``plan_route``); each step's rows are padded with zeros to the step
size. A point's answers do not depend on the step it ran in: the
likelihood kernels compute every row on its own, and the row-wise
log-sum-exp adds its terms in a fixed pairwise order, so a ragged request
gets the bits of the same rows in a larger one. The steps run eagerly
(the reference compiles each ahead of time; capturing them as CUDA graphs
is queued in ROADMAP.md). On the card the query's likelihood runs
``loglik_gauss`` (gaussian) or the ``matmul`` kernel under
``matmul_auto``'s size test (diag_gaussian); multinomial and poisson take
their module's one product.

**Compact operands.** At snapshot build the weights are renormalised over
the active slots (so p(k | x) sums to 1 and log p(x) is a density) and
the params are gathered to a compact slab of K_c rows, K_active rounded up
to a power of two (``gibbs.compaction_plan``: active slots first,
ascending, then inactive pad slots). Labels map back through the slot ids,
and the (N, K_max) log-probabilities are the compact ones scattered into a
-1e30 background.

**Hot swap.** ``swap(path)`` loads a checkpoint (a file or a rotation
prefix), runs ``resilience.model_health`` (``cfg.guardrails``), builds and
warms the new snapshot off the serving path, then flips one reference; a
query reads that reference once, so it is answered by one model end to
end. An unhealthy model raises :class:`PublishRejected` and the old one
keeps serving.

The sample key stream comes from ``torch.Generator().manual_seed(
cfg.seed)``: each ``sample`` draws two uint32 key words from it, unless
``seed`` (a generator of its own) or ``key_words`` (raw words, e.g. the
JAX package's ``key_data``) pins them. Online refinement
(``cfg.refine``) is not ported (ROADMAP.md §1 item 10).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import checkpoint as _checkpoint
from repro_torch.core import gibbs
from repro_torch.core.family import ComponentFamily, get_family
from repro_torch.core.resilience import model_health
from repro_torch.core.sampler import resolve_device
from repro_torch.core.state import ModelState, tree_map
from repro_torch.kernels.sweep import NEG_INF


class InvalidQueryError(ValueError):
    """A query batch failed validation: wrong rank or width, or non-finite
    values (a NaN row would make NaN scores for that row)."""


class PublishRejected(RuntimeError):
    """A model swap failed the ``model_health`` gate and was not made
    live; the engine keeps serving the previous model (the event is also
    logged in ``engine.events``)."""


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Knobs of :class:`DPMMEngine`, checked at construction.

    ``batch_sizes``: the ascending ladder of step sizes; each request
    routes to the smallest covering step. ``checkpoint_prefix``: the
    default source of ``engine.swap()`` (``from_checkpoint`` sets it).
    ``guardrails``: run ``model_health`` before a swap goes live.
    ``refine*``: the reference's online refinement, not ported:
    ``refine=True`` raises.
    """
    batch_sizes: Tuple[int, ...] = (256, 2048, 8192)
    validate_queries: bool = True
    seed: int = 0
    checkpoint_prefix: Optional[str] = None
    guardrails: bool = True
    refine: bool = False
    refine_batch: int = 1024
    refine_buffer: int = 32768
    refine_decay: float = 0.9
    refine_publish_every: int = 1
    refine_cfg: Optional[object] = None

    def __post_init__(self):
        sizes = tuple(self.batch_sizes)
        if not sizes:
            raise ValueError("ServeConfig.batch_sizes must name at least "
                             "one step size")
        for b in sizes:
            if isinstance(b, bool) or not isinstance(b, int) or b < 1:
                raise ValueError(
                    f"ServeConfig.batch_sizes entries must be positive "
                    f"ints, got {b!r}")
        if list(sizes) != sorted(set(sizes)):
            raise ValueError(
                f"ServeConfig.batch_sizes must be strictly ascending "
                f"(the routing walks smallest-covering-first), got {sizes}")
        object.__setattr__(self, "batch_sizes", sizes)

        def positive(name, value):
            if (isinstance(value, bool) or not isinstance(value, int)
                    or value <= 0):
                raise ValueError(f"ServeConfig.{name} must be a positive "
                                 f"int, got {value!r}")
        positive("refine_batch", self.refine_batch)
        positive("refine_buffer", self.refine_buffer)
        positive("refine_publish_every", self.refine_publish_every)
        if self.refine_buffer < self.refine_batch:
            raise ValueError(
                f"ServeConfig.refine_buffer ({self.refine_buffer}) must "
                f"hold at least one refine_batch ({self.refine_batch})")
        if not (0.0 <= float(self.refine_decay) < 1.0):
            raise ValueError(
                f"ServeConfig.refine_decay must be in [0, 1) — 1.0 would "
                f"grow stats without bound; got {self.refine_decay!r}")
        if (self.checkpoint_prefix is not None
                and not isinstance(self.checkpoint_prefix, str)):
            raise ValueError(
                f"ServeConfig.checkpoint_prefix must be a path string or "
                f"None, got {type(self.checkpoint_prefix).__name__}")
        if self.refine:
            raise NotImplementedError(
                "ServeConfig(refine=True): online refinement "
                "(gibbs.refine_sweep) is not ported yet (ROADMAP.md §1 item "
                "10, queue entry 'refine')")


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One request's answers. ``model_epoch`` bumps on every swap;
    ``sampled_labels`` is filled only by ``query(..., sample=True)``."""
    labels: np.ndarray          # (N,) int32 hard assignment
    logprobs: np.ndarray        # (N, K_max) float32 log p(k | x)
    log_predictive: np.ndarray  # (N,) float32 log p(x)
    sampled_labels: Optional[np.ndarray]  # (N,) int32, or None
    family: str
    k_max: int
    model_epoch: int

    @property
    def n(self) -> int:
        return int(self.labels.shape[0])

    def cluster_counts(self) -> Dict[int, int]:
        counts = np.bincount(self.labels, minlength=self.k_max)
        return {int(k): int(counts[k]) for k in np.flatnonzero(counts)}

    def to_json(self, include_logprobs: bool = False) -> dict:
        """The reference's wire schema; ``logprobs`` is opt-in (N K_max
        floats)."""
        out = {
            "n": self.n,
            "family": self.family,
            "k_max": self.k_max,
            "model_epoch": self.model_epoch,
            "labels": self.labels.tolist(),
            "log_predictive": self.log_predictive.tolist(),
            "sampled_labels": (None if self.sampled_labels is None
                               else self.sampled_labels.tolist()),
            "cluster_counts": {str(k): v
                               for k, v in self.cluster_counts().items()},
        }
        if include_logprobs:
            out["logprobs"] = self.logprobs.tolist()
        return out


class _Operands(NamedTuple):
    """The compact model every step reads."""
    params: object            # family params, compact (K_c, ...) slab
    logw: torch.Tensor        # (K_c,) renormalised log weights
    active: torch.Tensor      # (K_c,) bool
    slots: torch.Tensor       # (K_c,) int64 dense slot id of each row


def _logsumexp_rows(t: torch.Tensor) -> torch.Tensor:
    """log sum_k exp t_ik over the last axis, the terms added in a fixed
    pairwise order (halving a power-of-two width), so a row's value does
    not depend on how many rows came with it."""
    m = t.amax(dim=-1, keepdim=True)
    e = torch.exp(t - m)
    width = 1 << max(0, (e.shape[-1] - 1).bit_length())
    if width != e.shape[-1]:
        e = torch.cat([e, e.new_zeros(e.shape[:-1]
                                      + (width - e.shape[-1],))], dim=-1)
    while e.shape[-1] > 1:
        half = e.shape[-1] // 2
        e = e[..., :half] + e[..., half:]
    return torch.log(e[..., 0]) + m[..., 0]


def _query_step(family: ComponentFamily, k_max: int, x: torch.Tensor,
               ops: _Operands) -> Dict[str, torch.Tensor]:
    """Labels, (N, K_max) log p(k | x) and log p(x) of one ladder step."""
    ll = family.loglik(x, ops.params)
    logits = torch.where(ops.active[None, :], ll + ops.logw[None, :],
                         NEG_INF)
    logpred = _logsumexp_rows(logits)
    logprobs = torch.full((x.shape[0], k_max), NEG_INF, device=x.device)
    logprobs[:, ops.slots] = logits - logpred[:, None]
    return {"labels": ops.slots[torch.argmax(logits, dim=-1)].to(torch.int32),
            "logprobs": logprobs, "log_predictive": logpred}


def _sample_step(family: ComponentFamily, x: torch.Tensor, ops: _Operands,
                key_words: torch.Tensor, offset: int) -> torch.Tensor:
    """Step (e) of the sweep on one ladder step: argmax_k [loglik + log pi
    + Gumbel], counters on the request row index ``offset + i`` and the
    dense slot id, so a draw does not depend on how the request was
    split."""
    gidx = offset + torch.arange(x.shape[0], dtype=torch.int64,
                                 device=x.device)
    z = family.assign(x, ops.params, ops.logw, ops.active, gidx, key_words,
                      ops.slots)
    return ops.slots[z.long()].to(torch.int32)


class _Served(NamedTuple):
    """Everything a query needs, one object per model generation, so a
    swap flips a single reference."""
    model: ModelState
    family: ComponentFamily
    epoch: int
    k_max: int
    d: int
    k_active: int
    slots_np: np.ndarray        # (K_c,) dense slot ids, active first
    logweights: torch.Tensor    # (K_max,) renormalised dense log weights
    ops: _Operands
    source: str


def _ceil_pow2(v: int) -> int:
    return 1 << max(0, (int(v) - 1).bit_length())


def _on_device(model: ModelState, dev: torch.device) -> ModelState:
    move = lambda t: t.to(dev)
    return model.replace(
        key=move(model.key), active=move(model.active),
        logweights=move(model.logweights),
        sub_logweights=move(model.sub_logweights), stuck=move(model.stuck),
        params=tree_map(move, model.params),
        subparams=tree_map(move, model.subparams),
        stats=tree_map(move, model.stats),
        substats=tree_map(move, model.substats))


def _build_served(model: ModelState, family: ComponentFamily,
                  cfg: ServeConfig, epoch: int, source: str,
                  dev: torch.device) -> _Served:
    """Gather the compact operands and warm every ladder step once, off
    the serving path (engine build, swap)."""
    if model.active.ndim != 1:
        raise ValueError(
            f"DPMMEngine expects a single-chain ModelState; got active "
            f"shape {tuple(model.active.shape)}")
    model = _on_device(model, dev)
    k_max = int(model.active.shape[0])
    d = int(family.cluster_means(model.stats).shape[-1])
    active = model.active
    logw = torch.where(active, model.logweights, NEG_INF)
    # renormalise over the active slots: p(k) sums to 1 for the
    # predictive density (the sampler's weights carry the alpha slot's
    # mass, which the restricted sweep never uses)
    logw = logw - torch.logsumexp(
        torch.where(active, logw, float("-inf")), dim=0)
    k_active = max(1, int(active.sum()))
    k_c = min(k_max, _ceil_pow2(k_active))
    plan = gibbs.compaction_plan(active, k_c)
    slots = plan.slot_of_compact
    ops = _Operands(params=gibbs.compact_gather(plan, model.params),
                    logw=logw[slots].contiguous(),
                    active=active[slots].contiguous(), slots=slots)
    words = torch.zeros((2,), dtype=torch.int64, device=dev)
    for b in cfg.batch_sizes:
        x0 = torch.zeros((b, d), device=dev)
        _query_step(family, k_max, x0, ops)
        _sample_step(family, x0, ops, words, 0)
    return _Served(model=model, family=family, epoch=epoch, k_max=k_max,
                   d=d, k_active=k_active, slots_np=slots.cpu().numpy(),
                   logweights=logw, ops=ops, source=source)


class DPMMEngine:
    """Live query engine over a fitted single-chain ``ModelState``, on
    ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, model: ModelState,
                 family: Union[str, ComponentFamily],
                 cfg: Optional[ServeConfig] = None, device=None):
        self.cfg = cfg if cfg is not None else ServeConfig()
        self.device = resolve_device(device)
        fam = get_family(family) if isinstance(family, str) else family
        self._swap_lock = threading.Lock()    # serialises swaps
        self._key_lock = threading.Lock()
        self._keys = torch.Generator().manual_seed(self.cfg.seed)
        self.events: List[dict] = []
        self._served = _build_served(model, fam, self.cfg, epoch=0,
                                     source="<memory>", dev=self.device)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[ServeConfig] = None,
                        device=None) -> "DPMMEngine":
        """Build the engine from a checkpoint file or rotation prefix (its
        newest member that verifies). ``path`` becomes
        ``cfg.checkpoint_prefix`` unless that is set, so a bare
        ``swap()`` re-reads it."""
        cfg = cfg if cfg is not None else ServeConfig()
        dev = resolve_device(device)
        model, family, resolved, _ = _checkpoint.resolve_model(path, dev)
        if cfg.checkpoint_prefix is None:
            cfg = dataclasses.replace(cfg, checkpoint_prefix=path)
        eng = cls(model, family, cfg, device=dev)
        eng._served = eng._served._replace(source=resolved)
        return eng

    # -- introspection ----------------------------------------------------
    @property
    def model(self) -> ModelState:
        return self._served.model

    @property
    def family(self) -> ComponentFamily:
        return self._served.family

    @property
    def epoch(self) -> int:
        """Served model generation; bumps on every swap."""
        return self._served.epoch

    @property
    def k_max(self) -> int:
        return self._served.k_max

    @property
    def k_active(self) -> int:
        return self._served.k_active

    @property
    def d(self) -> int:
        return self._served.d

    @property
    def slots(self) -> np.ndarray:
        return self._served.slots_np

    @property
    def logweights(self) -> torch.Tensor:
        return self._served.logweights

    @property
    def batch_sizes(self) -> Tuple[int, ...]:
        return self.cfg.batch_sizes

    @property
    def batch_size(self) -> int:
        """The largest ladder step."""
        return self.cfg.batch_sizes[-1]

    @property
    def validate_queries(self) -> bool:
        return self.cfg.validate_queries

    # -- routing ----------------------------------------------------------
    def plan_route(self, n: int) -> List[Tuple[int, int, int]]:
        """``(start, used, batch_size)`` segments of an n-row request: one
        step at the smallest covering size when n fits the largest step,
        else largest-size chunks and one covering tail step."""
        sizes = self.cfg.batch_sizes
        big = sizes[-1]
        segs: List[Tuple[int, int, int]] = []
        start = 0
        while n - start > big:
            segs.append((start, big, big))
            start += big
        if n - start > 0:
            rem = n - start
            segs.append((start, rem, next(b for b in sizes if b >= rem)))
        return segs

    # -- query path -------------------------------------------------------
    def _validated(self, x, d: int) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != d:
            raise InvalidQueryError(f"queries must be (N, {d}), got "
                                    f"{x.shape}")
        if self.cfg.validate_queries and not np.isfinite(x).all():
            bad = np.flatnonzero(~np.isfinite(x).all(axis=1))
            raise InvalidQueryError(
                f"queries contain non-finite values in {bad.size} row(s), "
                f"first at row {int(bad[0])} — NaN/Inf inputs would "
                "produce NaN scores for those rows (pass "
                "ServeConfig(validate_queries=False) to skip this check)")
        return x

    def _steps(self, x: np.ndarray):
        """(start, used, padded step input on the device) per segment."""
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        for start, used, b in self.plan_route(x.shape[0]):
            chunk = xt[start:start + used]
            if used < b:
                chunk = torch.cat([chunk, chunk.new_zeros(
                    (b - used, x.shape[1]))])
            yield start, used, chunk

    def query(self, x, sample: bool = False, seed: Optional[int] = None,
              key_words: Optional[Sequence[int]] = None) -> ServeResult:
        """All answers for (N, d) queries; N = 0 gives empty answers.
        ``sample=True`` also draws ``sampled_labels`` (see
        :meth:`sample`)."""
        served = self._served              # ONE snapshot for the request
        x = self._validated(x, served.d)
        outs: Dict[str, list] = {"labels": [], "logprobs": [],
                                 "log_predictive": []}
        for _, used, xb in self._steps(x):
            out = _query_step(served.family, served.k_max, xb, served.ops)
            for k, v in out.items():
                outs[k].append(v[:used])
        if outs["labels"]:
            res = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
        else:
            res = {"labels": np.zeros((0,), np.int32),
                   "logprobs": np.zeros((0, served.k_max), np.float32),
                   "log_predictive": np.zeros((0,), np.float32)}
        return ServeResult(
            sampled_labels=(self._sample(served, x, seed, key_words)
                            if sample else None),
            family=served.family.name, k_max=served.k_max,
            model_epoch=served.epoch, **res)

    def predict(self, x) -> np.ndarray:
        return self.query(x).labels

    def predict_logprobs(self, x) -> np.ndarray:
        return self.query(x).logprobs

    def log_predictive(self, x) -> np.ndarray:
        return self.query(x).log_predictive

    def sample(self, x, seed: Optional[int] = None,
               key_words: Optional[Sequence[int]] = None) -> np.ndarray:
        """A posterior draw of the assignment (not the argmax): the Gibbs
        sweep's Gumbel-argmax step over the served components. Each call
        draws fresh key words from the engine's generator unless ``seed``
        or ``key_words`` (two uint32 words) pins them."""
        served = self._served
        x = self._validated(x, served.d)
        return self._sample(served, x, seed, key_words)

    def _sample(self, served: _Served, x: np.ndarray, seed: Optional[int],
                key_words: Optional[Sequence[int]]) -> np.ndarray:
        if key_words is not None:
            words = torch.as_tensor(np.asarray(key_words, np.int64))
        elif seed is not None:
            words = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                                  generator=torch.Generator().manual_seed(
                                      seed))
        else:
            with self._key_lock:
                words = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                                      generator=self._keys)
        words = words.reshape(2).to(self.device)
        parts = [_sample_step(served.family, xb, served.ops, words,
                             start)[:used]
                 for start, used, xb in self._steps(x)]
        if not parts:
            return np.zeros((0,), np.int32)
        return torch.cat(parts).cpu().numpy()

    # -- hot model swap ---------------------------------------------------
    def swap(self, path: Optional[str] = None) -> int:
        """Load a checkpoint (file or rotation prefix; default
        ``cfg.checkpoint_prefix``), health-check it, build and warm its
        snapshot off the serving path, then flip. Returns the new epoch;
        raises :class:`PublishRejected` if ``cfg.guardrails`` and the
        model is unhealthy (the old model keeps serving)."""
        path = path if path is not None else self.cfg.checkpoint_prefix
        if path is None:
            raise ValueError(
                "swap() needs a checkpoint path: pass one or set "
                "ServeConfig.checkpoint_prefix (from_checkpoint sets it)")
        model, family, resolved, it = _checkpoint.resolve_model(
            path, self.device)
        return self._publish(model, family, source=resolved,
                             kind="model_swap", it=it)

    def _publish(self, model: ModelState, family: ComponentFamily,
                 source: str, kind: str, it: Optional[int] = None) -> int:
        """The one path a new model takes to production: health gate,
        off-path warm-up, one reference flip, an audit event."""
        if self.cfg.guardrails and not bool(model_health(model)):
            self.events.append({
                "kind": f"{kind}_rejected", "source": source,
                "detail": "model_health gate failed (non-finite "
                          "stats/weights or degenerate cluster)"})
            raise PublishRejected(
                f"{kind} from {source!r} rejected: model_health gate "
                "failed — the previous model keeps serving")
        with self._swap_lock:
            nxt = _build_served(model, family, self.cfg,
                                epoch=self._served.epoch + 1, source=source,
                                dev=self.device)
            self._served = nxt             # the flip
            self.events.append({"kind": kind, "epoch": nxt.epoch,
                                "source": source,
                                "it": (None if it is None else int(it))})
            return nxt.epoch
