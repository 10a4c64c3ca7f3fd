"""Device meshes, sharded points and the point layout of both planes.

Port of ``repro.core.distributed`` (the paper's §4.3): points, labels and
sub-labels live on their data shard ("the data never moves"), per-cluster
state is replicated, and a stat pass ends in ONE reduction of the shards'
(K, 2, T) sub-cluster sums. The reference runs its fit under ``shard_map``
over a ``jax.sharding.Mesh``; the port runs one process and one host
thread over a ``Mesh`` of ``torch.device``s:

- ``Mesh``: devices shaped by named axes, ``("data",)`` or ``("data",
  "model")``. A device may repeat: shards on one card are logical shards,
  the counterpart of the reference tests' virtual CPU devices. Not
  ``torch.distributed``'s ``DeviceMesh``, which needs a process a card
  (``repro_torch.dist`` runs processes);
- ``make_data_mesh``: a data mesh over every visible card;
- ``pad_to_multiple`` / ``shard_points``: N padded with zero rows of
  ``valid = 0`` to a multiple of the data shards, shard s holding rows
  ``[s n_local, (s + 1) n_local)`` on its device, and with
  ``shard_features`` its features split over the ``model`` axis in
  contiguous slices (``FeatureShards``);
- ``tile_plan``: the per-shard tiles of the streamed plane;
- ``to_device`` / ``replicated``: the model side's copies on the shards'
  devices (made once a pass; a shard on the lead device reuses the
  lead's tensors);
- ``reduce_stats``: the shards' stat sums copied to the lead device and
  folded there in shard order from zero (``labelstats.fold_stats``: one
  ``fold_partials`` launch), feature slices joined first; its count of
  reductions and bytes is ``reduce_counts``. One shard: no reduction.

``shard_ranges`` is ``repro.dist.coordinator.shard_ranges``, the row ranges
of a multi-process fit's workers (``repro_torch.dist``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.suffstats import STATS_BLOCK

# Rows of a tile when ``DPMMConfig.tile_size`` is None: 64 fold blocks.
DEFAULT_TILE_BLOCKS = 64

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an array of ``torch.device`` with one axis per name of
    ``axis_names``; ``shape`` maps each name to its size. A device may
    appear more than once (logical shards)."""
    devices: Any
    axis_names: Tuple[str, ...] = ("data",)

    def __post_init__(self):
        arr = np.asarray(self.devices, dtype=object)
        out = np.empty(arr.shape, dtype=object)
        for i, dev in enumerate(arr.reshape(-1)):
            out.reshape(-1)[i] = torch.device(dev)
        names = tuple(self.axis_names)
        if out.ndim != len(names) or len(set(names)) != len(names):
            raise ValueError(f"a mesh of shape {out.shape} needs one "
                             f"distinct axis name a dimension, got {names}")
        if out.size == 0:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in out.reshape(-1)}) != 1:
            raise ValueError("a mesh holds devices of one type")
        object.__setattr__(self, "devices", out)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The first device: the model side runs there."""
        return self.devices.reshape(-1)[0]

    def grid(self) -> np.ndarray:
        """(data shards, model shards) devices: the data axes linearized
        in order (the reference's ``axis_index`` over them), ``model``
        last."""
        order = [i for i, a in enumerate(self.axis_names) if a != MODEL_AXIS]
        order += [i for i, a in enumerate(self.axis_names) if a == MODEL_AXIS]
        devs = self.devices.transpose(order)
        return devs.reshape(n_data_shards(self), -1)


def make_data_mesh(num_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over all (or the first ``num_devices``) visible cards,
    axis ``data``. Raises without a card: the port never carries on on
    the CPU unless asked to (a ``Mesh`` of CPU devices, ``device="cpu"``)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "make_data_mesh: no CUDA device is visible; pass device='cpu' "
            "(or a Mesh of CPU devices) to run the plain PyTorch path")
    devs = [torch.device("cuda", i) for i in range(count)][:num_devices]
    return Mesh(np.array(devs, dtype=object), ("data",))


def data_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """Axes that partition points: every axis except ``model``."""
    return tuple(a for a in mesh.axis_names if a != MODEL_AXIS)


def n_data_shards(mesh: Mesh) -> int:
    """Number of shards the data axes partition points into."""
    return int(np.prod([mesh.shape[a] for a in data_axes_of(mesh)],
                       dtype=np.int64))


def tile_plan(n: int, n_shards: int, tile_size: Optional[int]
              ) -> Tuple[int, List[Tuple[int, int]]]:
    """``(n_local, [(offset, length), ...])``: every data shard holds
    ``n_local = ceil(n / n_shards)`` rows (``shard_points``'s padded
    layout, so global point indices, and so chains, match across planes),
    cut into tiles at STATS_BLOCK-aligned offsets of the shard; only its
    last tile may be ragged. ``tile_size`` is rounded up to the alignment
    (``None``: DEFAULT_TILE_BLOCKS blocks) and cut to ``n_local``. The
    alignment keeps the stat fold's float additions the same at every tile
    size, so tiled chains are the resident chain bit for bit."""
    n_local = -(-n // n_shards)
    if tile_size is None:
        tile_size = DEFAULT_TILE_BLOCKS * STATS_BLOCK
    tile = -(-tile_size // STATS_BLOCK) * STATS_BLOCK
    tile = min(tile, n_local)
    return n_local, [(off, min(tile, n_local - off))
                     for off in range(0, n_local, tile)]


def pad_to_multiple(x: np.ndarray, multiple: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad axis 0 with zero rows to a multiple; returns (padded, valid)."""
    n = x.shape[0]
    target = int(math.ceil(n / multiple) * multiple)
    valid = np.zeros((target,), np.float32)
    valid[:n] = 1.0
    if target == n:
        return x, valid
    pad = np.zeros((target - n,) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], axis=0), valid


def feature_cols(d: int, m: int) -> List[Tuple[int, int]]:
    """The model shards' contiguous feature ranges: d split m ways."""
    if d % m:
        raise ValueError(f"shard_features: d = {d} does not split over "
                         f"{m} model shards")
    dl = d // m
    return [(j * dl, (j + 1) * dl) for j in range(m)]


class FeatureShards:
    """One data shard's rows with their features split over the model
    axis: slice j (contiguous, columns ``cols[j]``) on its device.
    ``shape`` and ``device`` are the whole's and the first slice's: the
    point-side results (labels, sums over features) live there."""

    def __init__(self, slices: Sequence[torch.Tensor],
                 cols: Sequence[Tuple[int, int]]):
        self.slices, self.cols = list(slices), list(cols)
        self.device = self.slices[0].device
        self.shape = (self.slices[0].shape[0], self.cols[-1][1])

    @classmethod
    def split(cls, x: torch.Tensor, devices: Sequence[torch.device]
              ) -> "FeatureShards":
        """x's features cut into contiguous slices, slice j on
        ``devices[j]``."""
        cols = feature_cols(x.shape[1], len(devices))
        return cls([x[:, a:b].contiguous().to(dev)
                    for (a, b), dev in zip(cols, devices)], cols)

    def psum(self, fn, *point_args) -> torch.Tensor:
        """``fn(slice, c0, c1, *point_args)`` on every slice, on the
        slice's device (``point_args`` copied there), summed in model
        shard order on ``device``: the reference's psum over ``model``."""
        total = None
        for xs, (a, b) in zip(self.slices, self.cols):
            part = fn(xs, a, b, *[to_device(t, xs.device) for t in point_args])
            part = part.to(self.device)
            total = part if total is None else total + part
        return total


def _moves(t: torch.Tensor, dev: torch.device) -> bool:
    """A tensor goes to ``dev`` when it lies on another device of dev's
    type; host-side words (the model key on a card's mesh) stay."""
    return t.device != dev and t.device.type == dev.type


def to_device(tree: Any, dev: torch.device) -> Any:
    """``tree`` (a tensor, a dataclass, tuple or list of them, or a plain
    value) with its tensors on ``dev``; tensors already there are kept."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev) if _moves(tree, dev) else tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: to_device(getattr(tree, f.name), dev)
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(t, dev) for t in tree)
    return tree


def replicated(mesh, tree: Any) -> Dict[torch.device, Any]:
    """``tree`` on every device of ``mesh`` (a ``Mesh`` or a sequence of
    devices), one copy a distinct device; a device that holds the tree
    already gets its tensors, uncopied."""
    devices = mesh.devices.reshape(-1) if isinstance(mesh, Mesh) else mesh
    out: Dict[torch.device, Any] = {}
    for dev in devices:
        if dev not in out:
            out[dev] = to_device(tree, dev)
    return out


@dataclasses.dataclass
class Shard:
    """A data shard of the resident plane: rows ``base .. base + n_local``
    of the padded layout on ``device`` (``x`` a tensor, or its feature
    slices), their ``valid`` mask, and every chain's labels."""
    x: Any
    valid: torch.Tensor
    base: int
    labels: List[Optional[torch.Tensor]]
    sublabels: List[Optional[torch.Tensor]]

    @property
    def device(self) -> torch.device:
        return self.x.device


def shard_points(mesh: Mesh, x: np.ndarray, shard_features: bool = False
                 ) -> Tuple[List[Any], List[torch.Tensor]]:
    """Place (N, d) points on the mesh's data shards: ``(xs, valids)``, a
    float32 tensor (or with ``shard_features`` and a ``model`` axis, its
    ``FeatureShards``) and a (n_local,) mask a shard, on the shard's
    first device. Without feature sharding a ``model`` axis holds no
    copy: the shard runs on its first device."""
    grid = mesh.grid()
    x_p, valid = pad_to_multiple(np.asarray(x, np.float32), grid.shape[0])
    n_local = x_p.shape[0] // grid.shape[0]
    xs, vs = [], []
    for s, devs in enumerate(grid):
        rows = torch.from_numpy(
            np.ascontiguousarray(x_p[s * n_local:(s + 1) * n_local]))
        if shard_features and grid.shape[1] > 1:
            xs.append(FeatureShards.split(rows, list(devs)))
        else:
            xs.append(rows.to(devs[0]))
        vs.append(torch.from_numpy(
            valid[s * n_local:(s + 1) * n_local].copy()).to(devs[0]))
    return xs, vs


_REDUCE = {"reductions": 0, "bytes": 0}


def reduce_counts() -> Dict[str, int]:
    """Cross-shard reductions and the bytes of shard stats they gathered
    since the counts were last reset."""
    return dict(_REDUCE)


def reset_reduce_counts() -> None:
    _REDUCE.update(reductions=0, bytes=0)


def _nbytes(family, st: Any) -> int:
    """Bytes a shard's stats (or its slices' list) bring to the
    reduction: every field once, a slice's feature fields each."""
    slices = st if isinstance(st, list) else [st]
    total = 0
    for f in dataclasses.fields(slices[0]):
        shared = isinstance(st, list) and (
            f.name not in family.feature_stat_fields)
        for sl in slices[:1] if shared else slices:
            t = getattr(sl, f.name)
            total += t.numel() * t.element_size()
    return total


def reduce_stats(family, shard_stats: List[Any], lead: torch.device) -> Any:
    """The one cross-shard reduction of a stat pass. ``shard_stats[s]``
    is shard s's folded (K, 2, ...) sub-cluster stats, or with feature
    sharding the list of its slices' (joined along features on the lead,
    ``family.gather_feature_stats``). The shards' sums are copied to
    ``lead`` and folded there in shard order from zero, every field in
    one ``fold_stats`` launch: a G-shard chain's bits depend on G, not on
    the cards holding the shards. One shard (and one slice) is returned
    as it is."""
    from repro_torch.core.labelstats import fold_stats
    if len(shard_stats) == 1 and not isinstance(shard_stats[0], list):
        return shard_stats[0]
    full = [family.gather_feature_stats(st, lead) if isinstance(st, list)
            else to_device(st, lead) for st in shard_stats]
    _REDUCE["reductions"] += 1
    _REDUCE["bytes"] += sum(_nbytes(family, st) for st in shard_stats)
    if len(full) == 1:
        return full[0]
    names = [f.name for f in dataclasses.fields(full[0])]
    parts = type(full[0])(**{n: torch.stack([getattr(s, n) for s in full])
                             for n in names})
    zero = type(full[0])(**{n: torch.zeros_like(getattr(full[0], n))
                            for n in names})
    return fold_stats(zero, parts)


def shard_ranges(n: int, workers: int, stats_block: int = STATS_BLOCK
                 ) -> List[Tuple[int, int, int]]:
    """Static contiguous row ranges, one per worker slot, cut on the
    stat-block grid so every block is computed whole by exactly one
    worker: ``[(lo, hi, preferred_slot), ...]`` sorted by ``lo`` (the
    global fold order), covering ``[0, n)``. Slots past the blocks get no
    range and serve as failover capacity."""
    nb = -(-n // stats_block)
    per = -(-nb // workers)
    ranges = []
    for w in range(workers):
        lo = min(w * per * stats_block, n)
        hi = min((w + 1) * per * stats_block, n)
        if lo < hi:
            ranges.append((lo, hi, w))
    return ranges
