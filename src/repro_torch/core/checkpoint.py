"""ModelState checkpoints: atomic, checksummed npz, format v2.

Port of ``repro.core.checkpoint`` (numpy and the standard library only),
bit-compatible with it both ways: a model fitted by the JAX package is
served by this package from the file the JAX package wrote, and a file
written here loads there. The format is a plain ``np.savez`` archive:

- ``leaf_0000`` ... one entry per leaf of the reference's ``ModelState``
  pytree in its flatten order: the fields ``key`` (the key's two raw uint32
  words), ``it`` (int32), ``active`` (bool), ``logweights``,
  ``sub_logweights``, ``stuck`` (int32), then the fields of ``params``,
  ``subparams``, ``stats`` and ``substats`` in the order of the family's
  NamedTuples (``LEAF_FIELDS``);
- ``__version__`` (int64 2), ``__family__``, ``__impl__`` (the PRNG's name,
  ``threefry2x32``) and ``__crc__``: the CRC32 of every leaf's bytes, in
  the sorted order of the leaf names.

``save_model`` writes to a temp file in the same directory, fsyncs it and
``os.replace``s it into place, so a crash never leaves a half-written file
under the final name. ``load_model`` re-checks every CRC and raises
:class:`CheckpointCorrupt` on any truncation, bit flip or layout mismatch.
``save_checkpoint`` / ``latest_valid`` keep a rotation of
``{prefix}-{it:08d}.npz`` members and return the newest one that verifies;
``resolve_model`` takes either a file or such a prefix.

The port holds one chain: a multi-chain checkpoint (a leading chain axis)
is refused with ``NotImplementedError``.
"""
from __future__ import annotations

import glob
import os
import re
import struct
import zipfile
import zlib
from typing import Dict, List, Tuple, Union

import numpy as np

from repro_torch.core.family import ComponentFamily, get_family
from repro_torch.core.state import (ModelState, model_state_from_numpy,
                                    model_state_to_numpy)

FORMAT_VERSION = 2
KEY_IMPL = "threefry2x32"
_META = ("__version__", "__family__", "__impl__", "__crc__")
# The reference ModelState's fields before its four per-family groups,
# with the dtype each leaf is stored in.
MODEL_FIELDS = (("key", np.uint32), ("it", np.int32), ("active", np.bool_),
                ("logweights", np.float32), ("sub_logweights", np.float32),
                ("stuck", np.int32))
GROUPS = ("params", "subparams", "stats", "substats")
# Each family's params and stats fields in the order of the reference's
# NamedTuples (repro.core.<family>): the leaves' flatten order.
LEAF_FIELDS = {
    "gaussian": (("mu", "chol_prec", "logdet_prec"), ("n", "sx", "sxx")),
    "multinomial": (("logtheta",), ("n", "counts")),
    "poisson": (("log_rate",), ("n", "sx")),
    "diag_gaussian": (("mu", "log_prec"), ("n", "sx", "sxx")),
}
# errors np.load / zipfile raise on truncated or garbled archives
_READ_ERRORS = (OSError, EOFError, ValueError, KeyError,
                zipfile.BadZipFile, struct.error)


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file exists but fails verification: unreadable npz,
    CRC mismatch, missing or extra leaves, or leaf shapes that do not fit
    the family's layout."""


class CheckpointNotFound(FileNotFoundError):
    """No checkpoint (or no valid one in a rotation) at the path."""


def normalize_path(path: str) -> str:
    """``np.savez`` appends ``.npz`` to a bare path; both spellings name
    the same file."""
    return path if path.endswith(".npz") else path + ".npz"


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _leaf_names(family: str) -> List[Tuple[str, ...]]:
    """(group, field) paths of every leaf, in flatten order."""
    params, stats = LEAF_FIELDS[family]
    paths = [(name,) for name, _ in MODEL_FIELDS]
    for group, fields in zip(GROUPS, (params, params, stats, stats)):
        paths += [(group, f) for f in fields]
    return paths


def _entries(model: ModelState, family: str) -> Dict[str, np.ndarray]:
    tree = model_state_to_numpy(model)
    dtypes = dict(MODEL_FIELDS)
    arrs = {}
    for i, path in enumerate(_leaf_names(family)):
        leaf = tree[path[0]] if len(path) == 1 else tree[path[0]][path[1]]
        arrs[f"leaf_{i:04d}"] = np.asarray(
            leaf, dtypes.get(path[0], np.float32))
    crcs = np.asarray([_crc(arrs[k]) for k in sorted(arrs)], np.uint32)
    return dict(__version__=np.int64(FORMAT_VERSION),
                __family__=np.str_(family), __impl__=np.str_(KEY_IMPL),
                __crc__=crcs, **arrs)


def save_model(path: str, model: ModelState,
               family: Union[str, ComponentFamily]) -> str:
    """Write ``model`` to ``path`` (``.npz`` appended if missing)
    atomically; returns the final path."""
    name = family if isinstance(family, str) else family.name
    get_family(name)                     # fail early on an unknown family
    entries = _entries(model, name)
    final = normalize_path(path)
    tmp = f"{final}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **entries)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(final) or ".")
    return final


def _fsync_dir(dirname: str) -> None:
    """Best-effort directory fsync so the rename itself is durable."""
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _check_shapes(tree: dict, where: str) -> None:
    """Every leaf must lead with the (K,) axis of ``active`` (the
    sub-cluster groups with (K, 2)); a multi-chain file is refused."""
    active = tree["active"]
    if active.ndim == 2:
        raise NotImplementedError(
            f"{where}: a multi-chain checkpoint (active {active.shape}); "
            "the port holds one chain (ROADMAP.md §1, multi-chain)")
    if active.ndim != 1:
        raise CheckpointCorrupt(f"{where}: 'active' has shape "
                                f"{active.shape}, expected (K,)")
    k = active.shape
    want = {"it": (), "key": (2,), "logweights": k, "stuck": k,
            "sub_logweights": k + (2,)}
    for name, shape in want.items():
        got = tree[name].shape
        if got != shape:
            raise CheckpointCorrupt(f"{where}: leaf {name!r} has shape "
                                    f"{got}, expected {shape}")
    for group in GROUPS:
        lead = k + ((2,) if group.startswith("sub") else ())
        for name, leaf in tree[group].items():
            if leaf.shape[:len(lead)] != lead:
                raise CheckpointCorrupt(
                    f"{where}: leaf {group}.{name} has shape {leaf.shape}, "
                    f"expected leading dims {lead} to match active {k}")


def _read_model(path: str) -> Tuple[dict, ComponentFamily]:
    """Read and verify ``path``: the model as nested dicts of numpy arrays
    (``model_state_from_numpy``'s input) and its family."""
    where = path
    if not os.path.exists(path) and os.path.exists(normalize_path(path)):
        path = normalize_path(path)
    if not os.path.exists(path):
        raise CheckpointNotFound(
            f"no checkpoint at {where!r} (or {normalize_path(where)!r})")
    try:
        with np.load(path, allow_pickle=False) as z:
            version = int(z["__version__"])
            if version > FORMAT_VERSION:
                raise CheckpointCorrupt(
                    f"{path}: checkpoint format v{version} is newer than "
                    f"this code (v{FORMAT_VERSION})")
            name = str(z["__family__"])
            if name not in LEAF_FIELDS:
                raise CheckpointCorrupt(f"{path}: unknown family {name!r}")
            paths = _leaf_names(name)
            names = sorted(k for k in z.files if k not in _META)
            if names != [f"leaf_{i:04d}" for i in range(len(paths))]:
                raise CheckpointCorrupt(
                    f"{path}: checkpoint has {len(names)} leaves but family "
                    f"{name!r} expects {len(paths)}")
            arrs = [z[k] for k in names]
            if version >= 2:
                crcs = np.asarray(z["__crc__"])
                if crcs.shape != (len(names),):
                    raise CheckpointCorrupt(
                        f"{path}: __crc__ has shape {crcs.shape}, expected "
                        f"({len(names)},)")
                for leaf, arr, want in zip(names, arrs, crcs):
                    got = _crc(arr)
                    if got != int(want):
                        raise CheckpointCorrupt(
                            f"{path}: CRC mismatch on {leaf}: stored "
                            f"{int(want):#010x}, recomputed {got:#010x} — "
                            "the file was truncated or bit-flipped on disk")
    except CheckpointCorrupt:
        raise
    except _READ_ERRORS as e:
        raise CheckpointCorrupt(f"{path}: unreadable checkpoint archive "
                                f"({type(e).__name__}: {e})") from e
    tree: dict = {group: {} for group in GROUPS}
    for p, arr in zip(paths, arrs):
        if len(p) == 1:
            tree[p[0]] = arr
        else:
            tree[p[0]][p[1]] = arr
    _check_shapes(tree, path)
    return tree, get_family(name)


def load_model(path: str, device="cuda") -> Tuple[ModelState,
                                                   ComponentFamily]:
    """Read, verify and place a checkpoint on ``device``: ``(model,
    family)``, the leaves bit for bit."""
    tree, family = _read_model(path)
    return model_state_from_numpy(tree, device, family), family


# ---------------------------------------------------------------------------
# Rotation: {prefix}-{it:08d}.npz members, newest valid first
# ---------------------------------------------------------------------------
_ROT_RE = re.compile(r"-(\d{8})\.npz$")


def checkpoint_member(prefix: str, it: int) -> str:
    return f"{prefix}-{int(it):08d}.npz"


def list_checkpoints(prefix: str) -> List[Tuple[int, str]]:
    """All rotation members under ``prefix``, newest (highest it) first."""
    out = []
    for p in glob.glob(glob.escape(prefix) + "-" + "[0-9]" * 8 + ".npz"):
        m = _ROT_RE.search(p)
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out, reverse=True)


def save_checkpoint(prefix: str, model: ModelState,
                    family: Union[str, ComponentFamily], it: int,
                    keep: int = 3) -> str:
    """Write member ``{prefix}-{it:08d}.npz`` atomically, then prune all
    but the newest ``keep`` members."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    path = save_model(checkpoint_member(prefix, it), model, family)
    for _, old in list_checkpoints(prefix)[keep:]:
        try:
            os.unlink(old)
        except OSError:
            pass
    return path


def latest_valid(prefix: str, device="cuda"
                 ) -> Tuple[ModelState, ComponentFamily, str, int]:
    """The newest rotation member that verifies: ``(model, family, path,
    it)``; corrupt members are skipped."""
    corrupt = []
    for it, path in list_checkpoints(prefix):
        try:
            model, family = load_model(path, device)
        except CheckpointCorrupt as e:
            corrupt.append(str(e))
            continue
        return model, family, path, it
    if corrupt:
        raise CheckpointNotFound(
            f"no valid checkpoint under prefix {prefix!r}: all "
            f"{len(corrupt)} member(s) failed verification — "
            + "; ".join(corrupt))
    raise CheckpointNotFound(
        f"no checkpoint members matching {prefix!r}-########.npz")


def resolve_model(path: str, device="cuda"
                  ) -> Tuple[ModelState, ComponentFamily, str, int]:
    """A model from ``path``, a checkpoint file or a rotation prefix (its
    newest member that verifies): ``(model, family, resolved_path, it)``.
    A named file that fails verification raises :class:`CheckpointCorrupt`.
    """
    try:
        model, family = load_model(path, device)
    except CheckpointNotFound:
        if not list_checkpoints(path):
            raise
        return latest_valid(path, device)
    resolved = path if os.path.exists(path) else normalize_path(path)
    return model, family, resolved, int(model.it)
