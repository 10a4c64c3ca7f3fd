"""A chain's state is its ``ModelState``: fitting k iterations, saving,
loading and fitting the rest from ``init_state`` gives the uninterrupted
fit bit for bit (labels, history, every state tensor), resident and
tiled, for a Gaussian and a multinomial family, with k a multiple of
``log_every`` or not; ``fit(key=...)`` picks the chain.

Small on purpose (N = 2000, d = 3, 16 slots, ``log_every`` 2, burnout 2,
so the moves run in both halves; a least compact slab of 2 slots, so the
slab changes size as K grows): the whole file takes a few seconds on the
CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import DPMMConfig
from repro_torch.core import checkpoint, gibbs
from repro_torch.core.sampler import DPMM
from repro_torch.data.synthetic import generate_gmm, generate_mnmm

N, D, K_TRUE = 2000, 3, 4
FIT = dict(k_max=16, log_every=2, burnout=2, k_block=2)
TILE = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _data(comp: str) -> np.ndarray:
    make = generate_gmm if comp == "gaussian" else generate_mnmm
    return make(N, D, K_TRUE, seed=3)[0]


def _fit(comp: str, x, plane: str, iters: int, **kw):
    cfg = DPMMConfig(component=comp,
                     tile_size=TILE if plane == "tiled" else None, **FIT)
    res = DPMM(cfg, device="cpu").fit(x, iters, **kw)
    assert res.mode == plane
    return res


def _leaves(state):
    """Every tensor of a ModelState, by name."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{g.name}": getattr(v, g.name)
                        for g in dataclasses.fields(v)})
        elif isinstance(v, torch.Tensor):
            out[f.name] = v
    return out


def _assert_same_state(a, b) -> None:
    assert a.it == b.it
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        assert torch.equal(la[name].cpu(), lb[name].cpu()), name


@pytest.mark.parametrize("plane", ["resident", "tiled"])
@pytest.mark.parametrize("comp", ["gaussian", "multinomial"])
def test_resumed_chain_is_the_uninterrupted_chain(comp, plane, tmp_path,
                                                  monkeypatch):
    _resume_is_bitwise(comp, plane, 4, tmp_path, monkeypatch)


@pytest.mark.parametrize("plane", ["resident", "tiled"])
@pytest.mark.parametrize("comp", ["gaussian", "multinomial"])
def test_chain_saved_inside_a_chunk_resumes_bitwise(comp, plane, tmp_path,
                                                    monkeypatch):
    """Saved after 3 iterations, inside a ``log_every`` chunk of 2."""
    _resume_is_bitwise(comp, plane, 3, tmp_path, monkeypatch)


def _resume_is_bitwise(comp, plane, saved_at, tmp_path, monkeypatch):
    """``saved_at`` iterations, a save and a load, the rest of 8: the
    8-iteration chain bit for bit."""
    # each sweep's compact slab by iteration: the chain depends on it (the
    # Threefry top bin), so a resumed chain must size it as the whole does
    slabs = []
    compaction = gibbs.sweep_compaction
    monkeypatch.setattr(gibbs, "sweep_compaction", lambda model, k_c: (
        slabs.append((model.it, k_c)), compaction(model, k_c))[1])
    x = _data(comp)
    whole = _fit(comp, x, plane, 8)
    whole_slabs = dict(slabs)
    first = _fit(comp, x, plane, saved_at)
    path = checkpoint.save_model(str(tmp_path / "model.npz"), first.state,
                                 comp)
    state, fam = checkpoint.load_model(path, device="cpu")
    assert fam.name == comp and state.it == saved_at
    before = {k: v.clone() for k, v in _leaves(state).items()}
    slabs.clear()
    rest = _fit(comp, x, plane, 8 - saved_at, init_state=state)
    assert dict(slabs) == {it: whole_slabs[it] for it in range(saved_at, 8)}
    # the fit ran on copies: the loaded state is untouched
    for name, v in _leaves(state).items():
        assert torch.equal(v, before[name]), name
    assert rest.state.it == whole.state.it == 8
    np.testing.assert_array_equal(rest.labels, whole.labels)
    for key, h in whole.history.items():
        np.testing.assert_array_equal(
            np.concatenate([first.history[key], rest.history[key]]), h)
    _assert_same_state(rest.state, whole.state)
    # splits or merges ran in the resumed half, so it tested the moves
    assert len(set(whole.history["k"].tolist())) > 1


def test_fit_key_reproduces_its_chain_and_picks_it():
    x = _data("gaussian")
    default = _fit("gaussian", x, "resident", 4)
    assert default.state.key.tolist() == [0, DPMMConfig().seed]
    same = _fit("gaussian", x, "resident", 4,
                key=np.array([0, DPMMConfig().seed], np.uint32))
    _assert_same_state(same.state, default.state)
    a = _fit("gaussian", x, "resident", 4, key=[5, 6])
    b = _fit("gaussian", x, "resident", 4, key=(5, 6))
    assert a.state.key.tolist() == [5, 6]
    _assert_same_state(a.state, b.state)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert not torch.equal(a.state.logweights, default.state.logweights)


def test_init_state_of_another_shape_or_family_is_refused():
    x = _data("gaussian")
    res = _fit("gaussian", x, "resident", 2)
    with pytest.raises(ValueError, match="key or init_state"):
        DPMM(DPMMConfig(**FIT), device="cpu").fit(x, 1, key=[0, 1],
                                                  init_state=res.state)
    with pytest.raises(ValueError, match="k_max"):
        DPMM(DPMMConfig(k_max=8), device="cpu").fit(x, 1,
                                                    init_state=res.state)
    with pytest.raises(ValueError, match="multinomial"):
        DPMM(DPMMConfig(component="multinomial", **FIT),
             device="cpu").fit(_data("multinomial"), 1, init_state=res.state)
