"""The port's checkpoint format against the JAX package's, both ways.

A model state made from a numpy seed is written by one package and read
by the other, for all four families: every leaf must come back with the
same bits and dtype. Also: a flipped byte raises ``CheckpointCorrupt``,
and a rotation whose newest member is torn resolves to the one before.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import checkpoint as jckpt
from repro.core import diag_gaussian as jdiag
from repro.core import multinomial as jmult
from repro.core import niw as jniw
from repro.core import poisson as jpois
from repro.core.state import ModelState as JModelState
from repro_torch.core import checkpoint
from repro_torch.core.state import model_state_to_numpy

K, D = 6, 3
FAMILIES = ("gaussian", "multinomial", "poisson", "diag_gaussian")
_CLASSES = {"gaussian": (jniw.GaussParams, jniw.GaussStats),
            "multinomial": (jmult.MultParams, jmult.MultStats),
            "poisson": (jpois.PoisParams, jpois.PoisStats),
            "diag_gaussian": (jdiag.DiagParams, jdiag.DiagStats)}


def _leaf(rng, name, lead):
    """A random float32 leaf of the field ``name`` with leading dims."""
    trail = {"chol_prec": (D, D), "sxx": (D, D), "n": (),
             "logdet_prec": ()}.get(name, (D,))
    return rng.normal(size=lead + trail).astype(np.float32)


def _tree(family: str, seed: int = 0) -> dict:
    """A model state as nested dicts of numpy arrays, the reference's
    dtypes (the sxx of diag_gaussian is per feature)."""
    rng = np.random.default_rng(seed)
    pcls, scls = _CLASSES[family]
    diag = family == "diag_gaussian"

    def group(cls, lead):
        return {f: (_leaf(rng, "sx", lead) if diag and f == "sxx"
                    else _leaf(rng, f, lead)) for f in cls._fields}
    active = rng.random(K) < 0.6
    return {"key": np.array([7, 0xC0FFEE], np.uint32),
            "it": np.int32(41), "active": active,
            "logweights": np.where(active, -1.5, -1e30).astype(np.float32),
            "sub_logweights": rng.normal(size=(K, 2)).astype(np.float32),
            "stuck": rng.integers(0, 9, K).astype(np.int32),
            "params": group(pcls, (K,)), "subparams": group(pcls, (K, 2)),
            "stats": group(scls, (K,)), "substats": group(scls, (K, 2))}


def _jax_model(family: str, tree: dict) -> JModelState:
    pcls, scls = _CLASSES[family]
    j = lambda d, cls: cls(**{k: jnp.asarray(v) for k, v in d.items()})
    return JModelState(
        key=jax.random.wrap_key_data(jnp.asarray(tree["key"])),
        it=jnp.asarray(tree["it"]), active=jnp.asarray(tree["active"]),
        logweights=jnp.asarray(tree["logweights"]),
        sub_logweights=jnp.asarray(tree["sub_logweights"]),
        stuck=jnp.asarray(tree["stuck"]),
        params=j(tree["params"], pcls), subparams=j(tree["subparams"], pcls),
        stats=j(tree["stats"], scls), substats=j(tree["substats"], scls))


def _flat(tree: dict):
    out = []
    for k in ("key", "it", "active", "logweights", "sub_logweights",
              "stuck"):
        out.append((k, np.asarray(tree[k])))
    for g in ("params", "subparams", "stats", "substats"):
        out += [(f"{g}.{f}", np.asarray(v)) for f, v in tree[g].items()]
    return out


def _same_bits(got: dict, want: dict):
    for (name, a), (_, b) in zip(_flat(got), _flat(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_checkpoint_loads_into_the_port_bit_for_bit(tmp_path, family):
    tree = _tree(family, seed=len(family))
    path = jckpt.save_model(str(tmp_path / "m"), _jax_model(family, tree),
                            family)
    model, fam = checkpoint.load_model(path, "cpu")
    assert fam.name == family and model.it == 41
    _same_bits(model_state_to_numpy(model), tree)


@pytest.mark.parametrize("family", FAMILIES)
def test_port_checkpoint_loads_into_jax_bit_for_bit(tmp_path, family):
    tree = _tree(family, seed=3 + len(family))
    model, _ = checkpoint.load_model(jckpt.save_model(
        str(tmp_path / "a"), _jax_model(family, tree), family), "cpu")
    path = checkpoint.save_model(str(tmp_path / "b"), model, family)
    assert path.endswith("b.npz") and not [
        p for p in os.listdir(tmp_path) if ".tmp-" in p]
    jmodel, jfam = jckpt.load_model(path)
    assert jfam.name == family
    raw = jmodel._replace(key=jax.random.key_data(jmodel.key))
    got = {"key": np.asarray(raw.key), "it": np.asarray(raw.it),
           "active": np.asarray(raw.active),
           "logweights": np.asarray(raw.logweights),
           "sub_logweights": np.asarray(raw.sub_logweights),
           "stuck": np.asarray(raw.stuck)}
    for g in ("params", "subparams", "stats", "substats"):
        got[g] = {f: np.asarray(v) for f, v in
                  getattr(raw, g)._asdict().items()}
    _same_bits(got, tree)
    # and the two archives hold the same entries, byte for byte
    with np.load(path) as a, np.load(str(tmp_path / "a.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_a_flipped_byte_raises_checkpoint_corrupt(tmp_path):
    tree = _tree("gaussian")
    model, _ = checkpoint.load_model(jckpt.save_model(
        str(tmp_path / "m"), _jax_model("gaussian", tree), "gaussian"),
        "cpu")
    path = checkpoint.save_model(str(tmp_path / "p"), model, "gaussian")
    raw = bytearray(open(path, "rb").read())
    at = raw.find(tree["params"]["chol_prec"].tobytes())
    assert at > 0
    raw[at + 5] ^= 0x10
    open(path, "wb").write(bytes(raw))
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load_model(path, "cpu")
    with pytest.raises(checkpoint.CheckpointNotFound):
        checkpoint.load_model(str(tmp_path / "missing"), "cpu")


def test_rotation_with_a_torn_newest_member_resolves_to_the_one_before(
        tmp_path):
    prefix = str(tmp_path / "run")
    models = []
    for it, seed in ((10, 1), (20, 2), (30, 3)):
        tree = _tree("poisson", seed)
        m, _ = checkpoint.load_model(jckpt.save_model(
            str(tmp_path / f"src{it}"), _jax_model("poisson", tree),
            "poisson"), "cpu")
        models.append(tree)
        checkpoint.save_checkpoint(prefix, m, "poisson", it, keep=2)
    assert [it for it, _ in checkpoint.list_checkpoints(prefix)] == [30, 20]
    newest = checkpoint.checkpoint_member(prefix, 30)
    data = open(newest, "rb").read()
    open(newest, "wb").write(data[:len(data) // 2])      # torn write
    model, fam, path, it = checkpoint.resolve_model(prefix, "cpu")
    assert (fam.name, it) == ("poisson", 20)
    assert path == checkpoint.checkpoint_member(prefix, 20)
    _same_bits(model_state_to_numpy(model), models[1])
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.resolve_model(newest, "cpu")
