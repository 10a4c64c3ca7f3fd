"""DPMM sampler state: the O(K) model side and the O(N) point side.

Port of ``repro.core.state``. Every per-cluster tensor is ``(K_max, ...)``
with an ``active`` mask; sub-cluster tensors carry an extra axis of size 2
(the l/r sub-clusters of paper §2.3).

- ``ModelState``: weights, component parameters and sufficient statistics,
  the key words and the iteration counter — everything O(K).
- ``PointState``: labels, sub-labels and the padding mask — everything
  O(N).

``model_state_from_numpy`` / ``model_state_to_numpy`` carry a model state
of any family between this package and the JAX one as plain numpy arrays,
so both can compute from the same parameters.

A multi-chain state (``fit(n_chains=C)``'s result, a multi-chain
checkpoint) has the reference's layout: every leaf leads with a chain axis
((C, K, ...)), ``key`` is (C, 2) and ``it`` a (C,) int64 tensor on the
host. ``stack_chains`` builds it from C single-chain states and
``chain_of`` takes chain c back out; the fits run one single-chain state
per chain. ``clone_model`` is a deep copy (a rollback anchor) and
``grow_model`` pads the slot axis (``k_max='auto'``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels.sweep import NEG_INF


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """Apply ``fn`` to every tensor field of a params/stats dataclass."""
    return type(tree)(**{f.name: fn(getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


def tree_map2(fn, a: Any, b: Any) -> Any:
    return type(a)(**{f.name: fn(getattr(a, f.name), getattr(b, f.name))
                      for f in dataclasses.fields(a)})


@dataclasses.dataclass
class ModelState:
    """O(K_max) model-side state of one chain."""
    key: torch.Tensor             # (2,) int64: the key's two uint32 words
    it: Any                       # iterations done: int ((C,) tensor for
    #                               a multi-chain state)
    active: torch.Tensor          # (K,) bool
    logweights: torch.Tensor      # (K,) log pi_k (-1e30 when inactive)
    sub_logweights: torch.Tensor  # (K, 2)
    stuck: torch.Tensor           # (K,) int32 sweeps since a split
    params: Any                   # the family's params, batch (K,)
    subparams: Any                # batch (K, 2)
    stats: Any                    # the family's stats, batch (K,)
    substats: Any                 # batch (K, 2)

    @property
    def k_hat(self) -> torch.Tensor:
        return self.active.sum()

    def summarize(self) -> Dict[str, torch.Tensor]:
        """Per-step scalar diagnostics, left on the device."""
        return {
            "k": self.k_hat,
            "max_cluster": torch.where(self.active, self.stats.n,
                                       0.0).max(),
            "min_cluster": torch.where(self.active, self.stats.n,
                                       float("inf")).min(),
        }

    def replace(self, **kw) -> "ModelState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class PointState:
    """O(N) per-point state."""
    labels: torch.Tensor          # (N,) int32
    sublabels: torch.Tensor       # (N,) int32 in {0, 1}
    valid: torch.Tensor           # (N,) float32 padding mask


_GROUPS = ("params", "subparams", "stats", "substats")
_SLOT_LEAVES = ("active", "logweights", "sub_logweights", "stuck")


def _map_slots(model: ModelState, fn) -> ModelState:
    """``fn`` applied to every O(K) tensor of ``model`` (``fn(name,
    tensor)``; the groups' leaves are named by their group)."""
    kw = {name: fn(name, getattr(model, name)) for name in _SLOT_LEAVES}
    for group in _GROUPS:
        kw[group] = tree_map(lambda t, g=group: fn(g, t),
                             getattr(model, group))
    return model.replace(**kw)


def clone_model(model: ModelState) -> ModelState:
    """A deep copy: no tensor of the copy is one that a later iteration of
    ``model``'s chain may write in place."""
    it = model.it.clone() if isinstance(model.it, torch.Tensor) else model.it
    return _map_slots(model, lambda _, t: t.clone()).replace(
        key=model.key.clone(), it=it)


def stack_chains(models) -> ModelState:
    """C single-chain states -> one multi-chain state (every leaf with a
    leading chain axis, ``key`` (C, 2), ``it`` (C,) on the host)."""
    models = list(models)
    kw = {name: torch.stack([getattr(m, name) for m in models])
          for name in _SLOT_LEAVES}
    for group in _GROUPS:
        trees = [getattr(m, group) for m in models]
        kw[group] = type(trees[0])(**{
            f.name: torch.stack([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(trees[0])})
    return ModelState(
        key=torch.stack([m.key.to("cpu", torch.int64) for m in models]),
        it=torch.tensor([int(m.it) for m in models], dtype=torch.int64),
        **kw)


def chain_of(model: ModelState, c: int) -> ModelState:
    """Chain ``c`` of a multi-chain state as a single-chain state (views
    of its tensors)."""
    return _map_slots(model, lambda _, t: t[c]).replace(
        key=model.key[c], it=int(model.it[c]))


def grow_model(model: ModelState, new_k: int) -> ModelState:
    """Pad every O(K) leaf of ``model`` to ``new_k`` slots, as a dense
    chain's inactive slots look: inactive, ``NEG_INF`` log-weights,
    sub-weights of log 1/2, zero ``stuck`` and zero params and stats (the
    next sweep draws the params from the stats). Single-chain (K, ...)
    and multi-chain (C, K, ...) layouts; refuses to shrink."""
    k_axis = model.active.ndim - 1
    old_k = model.active.shape[k_axis]
    if new_k < old_k:
        raise ValueError(f"grow_model: cannot shrink {old_k} -> {new_k}")
    if new_k == old_k:
        return model
    fill = {"active": False, "logweights": NEG_INF,
            "sub_logweights": math.log(0.5)}

    def pad(name, t):
        shape = list(t.shape)
        shape[k_axis] = new_k - old_k
        return torch.cat([t, torch.full(shape, fill.get(name, 0),
                                        dtype=t.dtype, device=t.device)],
                         dim=k_axis)
    return _map_slots(model, pad)


def _field(tree: Any, name: str) -> Any:
    if isinstance(tree, Mapping):
        return tree[name]
    return getattr(tree, name)


def model_state_from_numpy(tree: Any, device, family) -> ModelState:
    """Build a ``ModelState`` on ``device`` from numpy arrays.

    ``tree`` is the JAX ``ModelState`` with numpy leaves, or nested dicts
    with the same field names (``model_state_to_numpy``'s output). Its
    ``key`` is the key's two raw uint32 words (``jax.random.key_data``).
    ``params``/``subparams`` and ``stats``/``substats`` carry the fields of
    ``family``'s (a ``ComponentFamily``) params and stats classes:
    ``mu``/``chol_prec``/``logdet_prec``, ``logtheta``, ``log_rate`` or
    ``mu``/``log_prec``; ``n`` with ``sx``/``sxx``, ``counts`` or ``sx``.
    A multi-chain tree ((C, K) ``active``) gives a multi-chain state.
    """
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    def build(cls, tree):
        return cls(**{f.name: t(_field(tree, f.name))
                      for f in dataclasses.fields(cls)})

    multi = np.ndim(_field(tree, "active")) == 2
    key = np.asarray(_field(tree, "key")).astype(np.int64)
    it = np.asarray(_field(tree, "it"))
    if multi:
        key, it = (torch.as_tensor(key.reshape(-1, 2)),
                   torch.as_tensor(it.astype(np.int64)))
    else:
        key, it = t(key.reshape(-1)[:2], torch.int64), int(it)
    return ModelState(
        key=key, it=it,
        active=t(_field(tree, "active"), torch.bool),
        logweights=t(_field(tree, "logweights")),
        sub_logweights=t(_field(tree, "sub_logweights")),
        stuck=t(_field(tree, "stuck"), torch.int32),
        params=build(family.params_cls, _field(tree, "params")),
        subparams=build(family.params_cls, _field(tree, "subparams")),
        stats=build(family.stats_cls, _field(tree, "stats")),
        substats=build(family.stats_cls, _field(tree, "substats")))


def model_state_to_numpy(model: ModelState) -> Dict[str, Any]:
    """The inverse of ``model_state_from_numpy``: nested dicts of numpy
    arrays (key words as uint32)."""
    def arrs(tree):
        return {f.name: getattr(tree, f.name).cpu().numpy()
                for f in dataclasses.fields(tree)}
    return {
        "key": model.key.cpu().numpy().astype(np.uint32),
        "it": np.asarray(model.it, np.int32),
        "active": model.active.cpu().numpy(),
        "logweights": model.logweights.cpu().numpy(),
        "sub_logweights": model.sub_logweights.cpu().numpy(),
        "stuck": model.stuck.cpu().numpy(),
        "params": arrs(model.params), "subparams": arrs(model.subparams),
        "stats": arrs(model.stats), "substats": arrs(model.substats),
    }
