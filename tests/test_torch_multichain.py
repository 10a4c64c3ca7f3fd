"""Multi-chain fits and ``k_max='auto'`` of the port, against the JAX
package where it has the same function.

- chain c of ``n_chains=3`` is bit for bit the single-chain fit with key
  ``fold_in(key, c)``, on the resident plane and on the tiled plane with a
  partial last tile, and the tiled plane reads each tile once a pass
  whatever the number of chains;
- ``FitResult.chain``, ``select_best``, ``nmi``, and ``rhat`` / ``rhats``
  equal to the reference ``FitResult``'s on the same history arrays;
- a multi-chain checkpoint moves both ways between the packages with
  equal leaves, and a multi-chain save, load and resume is bitwise;
- ``grow_model`` equals the reference's leaf for leaf in both layouts;
- an ``'auto'`` fit grows past 8 slots and finds the clusters, bit for bit
  again on a second run, and refuses a streamed source.

Small on purpose (N <= 2000, d <= 4, <= 16 slots, <= 16 iterations, one
torch thread, ``device="cpu"``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import checkpoint as jckpt
from repro.core import niw as jniw
from repro.core import sampler as jsampler
from repro.core import state as jstate
from repro_torch.configs import DPMMConfig
from repro_torch.core import checkpoint, state
from repro_torch.core.niw import GaussParams, GaussStats
from repro_torch.core.resilience import model_health
from repro_torch.core.sampler import DPMM, FitResult
from repro_torch.data.source import HostTiledSource
from repro_torch.data.synthetic import generate_gmm
from repro_torch.kernels import prng

N, D, C = 2000, 3, 3
TILE = 1024                      # tiles of 1024 and 976 rows
FIT = dict(k_max=16, iters=10, burnout=3, log_every=4, k_block=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data():
    return generate_gmm(N, D, 4, seed=3, sep=10.0)


@pytest.fixture(scope="module")
def multi(data):
    return DPMM(DPMMConfig(**FIT), device="cpu").fit(data[0], n_chains=C)


def _fit(x, iters=None, **kw):
    cfg = {**FIT, **kw.pop("cfg", {})}
    return DPMM(DPMMConfig(**cfg), device="cpu").fit(x, iters, **kw)


def _leaves(st):
    out = {"key": st.key, "it": torch.as_tensor(st.it)}
    for name in ("active", "logweights", "sub_logweights", "stuck"):
        out[name] = getattr(st, name)
    for group in ("params", "subparams", "stats", "substats"):
        tree = getattr(st, group)
        out.update({f"{group}.{f}": getattr(tree, f)
                    for f in tree.__dataclass_fields__})
    return out


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for name in la:
        assert la[name].dtype == lb[name].dtype, name
        assert torch.equal(la[name].cpu(), lb[name].cpu()), name


def _assert_same_chain(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    for key in b.history:
        np.testing.assert_array_equal(a.history[key], b.history[key])
    _assert_same_state(a.state, b.state)


@pytest.mark.parametrize("plane", ["resident", "tiled"])
def test_chain_c_is_the_single_chain_fit_of_its_key(plane, data, multi):
    x = data[0]
    if plane == "tiled":
        multi = _fit(HostTiledSource(x), n_chains=C,
                     cfg=dict(tile_size=TILE))
        assert multi.mode == "tiled"
    assert multi.labels.shape == (C, N)
    assert multi.history["k"].shape == (C, FIT["iters"])
    assert tuple(multi.state.active.shape) == (C, FIT["k_max"])
    assert multi.state.key.shape == (C, 2) and multi.state.it.tolist() == \
        [FIT["iters"]] * C
    for c in range(C):
        single = _fit(x, key=prng.fold_in((0, 0), c))
        _assert_same_chain(multi.chain(c), single)
    # the chains differ, so the per-chain keys reached them
    assert not np.array_equal(multi.labels[0], multi.labels[1])


class _CountingSource(HostTiledSource):
    def __init__(self, x):
        super().__init__(x)
        self.reads = 0

    def read_block(self, start, stop):
        self.reads += 1
        return super().read_block(start, stop)


def test_tiled_plane_reads_each_tile_once_a_pass_for_all_chains(data):
    counts = {}
    for chains in (1, C):
        src = _CountingSource(data[0])
        _fit(src, 5, n_chains=chains, cfg=dict(tile_size=TILE))
        counts[chains] = src.reads
    # two init passes, five sweeps and two moves, two tiles each, and the
    # column mean's one read
    assert counts[1] == counts[C] == 2 * (2 + 5 + 2) + 1


def test_views_and_the_best_chain(data, multi):
    assert multi.n_chains == C and multi.score.shape == (C,)
    best = multi.select_best()
    assert best.n_chains == 1 and best.select_best() is best
    assert best.score == float(np.max(multi.score))
    assert best.k == multi.k == int(best.state.active.sum())
    assert multi.nmi(data[1]) == best.nmi(data[1]) > 0.9
    assert multi.ari(data[1]) == best.ari(data[1])
    c1 = multi.chain(1)
    np.testing.assert_array_equal(c1.labels, multi.labels[1])
    assert c1.history["score"][-1] == c1.score == multi.score[1]
    with pytest.raises(IndexError):
        best.chain(2)
    with pytest.raises(IndexError):
        multi.chain(C)
    with pytest.raises(ValueError):
        best.rhat("score")
    assert set(multi.rhats()) == {"k", "score"}
    # one health verdict for all the chains of a multi-chain state
    assert bool(model_health(multi.state))
    sick = multi.state.stats.n.clone()
    sick[2, int(torch.nonzero(multi.state.active[2])[0])] = float("nan")
    assert not bool(model_health(multi.state.replace(
        stats=dataclasses.replace(multi.state.stats, n=sick))))


@pytest.mark.parametrize("trace", ["spread", "flat", "short"])
def test_rhat_equals_the_reference(trace):
    rng = np.random.default_rng(1)
    t = {"spread": 12, "flat": 12, "short": 3}[trace]
    hist = {"k": rng.integers(3, 7, (4, t)).astype(np.int32),
            "score": rng.normal(-100, 5, (4, t)).astype(np.float32)}
    if trace == "flat":
        hist["k"][:] = 5
    port = FitResult(state=None, labels=None, k=0, history=hist,
                     iter_times_s=[], device="cpu", n_chains=4)
    ref = jsampler.FitResult(state=None, labels=None, k=0, history=hist,
                             iter_times_s=[], n_chains=4)
    for key in ("k", "score"):
        if trace == "short":
            for r in (port, ref):
                with pytest.raises(ValueError, match="4 recorded"):
                    r.rhat(key)
        else:
            assert port.rhat(key) == ref.rhat(key)
    if trace != "short":
        assert port.rhats() == ref.rhats()


def _gauss_tree(rng, chains, k, d):
    """A multi-chain Gaussian state as nested dicts of numpy arrays."""
    lead = (chains, k)

    def leaf(shape):
        return rng.normal(size=shape).astype(np.float32)

    def params(extra):
        return {"mu": leaf(lead + extra + (d,)),
                "chol_prec": leaf(lead + extra + (d, d)),
                "logdet_prec": leaf(lead + extra)}

    def stats(extra):
        return {"n": leaf(lead + extra), "sx": leaf(lead + extra + (d,)),
                "sxx": leaf(lead + extra + (d, d))}
    active = rng.random(lead) < 0.6
    return {"key": rng.integers(0, 2 ** 32, (chains, 2), dtype=np.uint32),
            "it": np.full((chains,), 9, np.int32), "active": active,
            "logweights": np.where(active, -1.5, -1e30).astype(np.float32),
            "sub_logweights": leaf(lead + (2,)),
            "stuck": rng.integers(0, 9, lead).astype(np.int32),
            "params": params(()), "subparams": params((2,)),
            "stats": stats(()), "substats": stats((2,))}


def _jax_state(tree):
    j = lambda d, cls: cls(**{f: jnp.asarray(d[f]) for f in cls._fields})
    key = jnp.asarray(tree["key"])
    return jstate.ModelState(
        key=jax.random.wrap_key_data(key), it=jnp.asarray(tree["it"]),
        active=jnp.asarray(tree["active"]),
        logweights=jnp.asarray(tree["logweights"]),
        sub_logweights=jnp.asarray(tree["sub_logweights"]),
        stuck=jnp.asarray(tree["stuck"]),
        params=j(tree["params"], jniw.GaussParams),
        subparams=j(tree["subparams"], jniw.GaussParams),
        stats=j(tree["stats"], jniw.GaussStats),
        substats=j(tree["substats"], jniw.GaussStats))


def _jax_leaves(st):
    raw = st._replace(key=jax.random.key_data(st.key))
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(raw)]


def _port_leaves(st):
    """The port state's leaves in the reference's flatten order."""
    tree = state.model_state_to_numpy(st)
    out = [np.asarray(tree[k]) for k in ("key", "it", "active", "logweights",
                                         "sub_logweights", "stuck")]
    for group, fields in (("params", GaussParams), ("subparams",
                                                    GaussParams),
                          ("stats", GaussStats), ("substats", GaussStats)):
        out += [tree[group][f.name] for f in dataclasses.fields(fields)]
    return out


def test_multichain_checkpoint_moves_both_ways(tmp_path):
    tree = _gauss_tree(np.random.default_rng(2), 2, 6, D)
    fam = DPMM(DPMMConfig(), device="cpu").family
    port = state.model_state_from_numpy(tree, "cpu", fam)
    assert tuple(port.key.shape) == (2, 2) and port.it.tolist() == [9, 9]
    path = checkpoint.save_checkpoint(str(tmp_path / "port"), port,
                                      "gaussian", 9)
    got, jfam = jckpt.load_model(path)
    assert jfam.name == "gaussian"
    for a, b in zip(_jax_leaves(got), _port_leaves(port)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jpath = jckpt.save_model(str(tmp_path / "jax"), _jax_state(tree),
                             "gaussian")
    back, _, _, it = checkpoint.resolve_model(jpath, device="cpu")
    assert it == 9
    for a, b in zip(_port_leaves(back), _jax_leaves(_jax_state(tree))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_multichain_save_load_and_resume_are_bitwise(data, tmp_path):
    x = data[0]
    pref = str(tmp_path / "mc")
    cfg = dict(checkpoint_path=pref, checkpoint_every=4)
    first = _fit(x, 8, n_chains=2, cfg=cfg)
    state8, _ = checkpoint.load_model(checkpoint.list_checkpoints(pref)[0][1],
                                      device="cpu")
    _assert_same_state(state8, first.state)
    whole = _fit(x, 12, n_chains=2)
    resumed = _fit(x, 12, n_chains=2, resume=True, cfg=cfg)
    np.testing.assert_array_equal(resumed.labels, whole.labels)
    _assert_same_state(resumed.state, whole.state)
    rest = _fit(x, 4, n_chains=2, init_state=state8)
    _assert_same_state(rest.state, whole.state)
    for key in whole.history:
        np.testing.assert_array_equal(
            np.concatenate([first.history[key], rest.history[key]], axis=1),
            whole.history[key])


@pytest.mark.parametrize("chains", [None, 2])
def test_grow_model_equals_the_reference(chains):
    tree = _gauss_tree(np.random.default_rng(3), chains or 1, 5, D)
    if chains is None:
        tree = {k: ({f: v[0] for f, v in t.items()} if isinstance(t, dict)
                    else t[0]) for k, t in tree.items()}
    fam = DPMM(DPMMConfig(), device="cpu").family
    port = state.grow_model(state.model_state_from_numpy(tree, "cpu", fam),
                            12)
    ref = jstate.grow_model(_jax_state(tree), 12)
    for a, b in zip(_port_leaves(port), _jax_leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="shrink"):
        state.grow_model(port, 4)


def test_auto_slab_grows_finds_the_clusters_and_repeats(tmp_path):
    x, gt = generate_gmm(N, 4, 6, seed=0, sep=10.0)
    cfg = DPMMConfig(alpha=10.0, iters=16, k_max="auto", k_max_cap=64,
                     burnout=5, log_every=4)
    a = DPMM(cfg, device="cpu").fit(x)
    # six live clusters after the second chunk: 2 * 6 > 8 slots
    assert a.slab_sizes == [8, 8, 16, 16]
    assert a.state.active.shape[0] == 16 and a.k == 6 and a.nmi(gt) > 0.9
    b = DPMM(cfg, device="cpu").fit(x)
    assert a.slab_sizes == b.slab_sizes
    np.testing.assert_array_equal(a.labels, b.labels)
    _assert_same_state(a.state, b.state)
    # a resumed 'auto' fit starts from its checkpoint's slab
    rot = dataclasses.replace(cfg, checkpoint_path=str(tmp_path / "a"),
                              checkpoint_every=8)
    assert DPMM(rot, device="cpu").fit(x, 8).slab_sizes == [8, 8]
    resumed = DPMM(rot, device="cpu").fit(x, resume=True)
    assert resumed.slab_sizes == [16, 16]
    np.testing.assert_array_equal(resumed.labels, a.labels)
    _assert_same_state(resumed.state, a.state)
    with pytest.raises(ValueError, match="resident"):
        DPMM(DPMMConfig(k_max="auto", iters=2),
             device="cpu").fit(HostTiledSource(x))
