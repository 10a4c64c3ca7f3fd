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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch


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
    it: int                       # iterations done
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
    """
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a)).to(device=device, dtype=dtype)

    def build(cls, tree):
        return cls(**{f.name: t(_field(tree, f.name))
                      for f in dataclasses.fields(cls)})

    key = np.asarray(_field(tree, "key")).reshape(-1)[:2].astype(np.int64)
    return ModelState(
        key=t(key, torch.int64), it=int(np.asarray(_field(tree, "it"))),
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
        "it": np.int32(model.it),
        "active": model.active.cpu().numpy(),
        "logweights": model.logweights.cpu().numpy(),
        "sub_logweights": model.sub_logweights.cpu().numpy(),
        "stuck": model.stuck.cpu().numpy(),
        "params": arrs(model.params), "subparams": arrs(model.subparams),
        "stats": arrs(model.stats), "substats": arrs(model.substats),
    }
