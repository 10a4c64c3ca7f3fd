"""Online refinement of a served model: the port against the JAX package.

``gibbs.refine_sweep`` (steps (a)-(d), then ``refine_tile``: one sweep
tile over the batch on the dense slab, its stats blended as ``decay * old
+ batch``) is held against the JAX package's ``refine_sweep`` on a model
both packages load from one checkpoint, for the gaussian and multinomial
families. Steps (a)-(d) draw from each package's own generators, so the
JAX side's post-(a)-(d) model is carried across with
``model_state_from_numpy`` and the port's ``refine_tile`` runs from it.
Rules: labels equal except counted mismatches (at most 1 % of the batch,
each a near-tie of the two logits within 1e-4 on the gaussian family);
given the same labels, the blended counts within 1e-6 relative and sx /
sxx (or count vectors) within rtol 1e-5, atol 1e-3 (float32 sums in
another order); ``it`` advanced by one; rows with ``valid=0`` change no
stat. ``_traffic_prior`` of the carried model equals the reference's
within 1e-5. Then the engine: refinement off is chain-neutral, publishing
goes through the swap path with epochs and events, a poisoned batch gives
the reference's summary and ``refine_rejected`` event and leaves the
served answers bitwise as they were, the traffic buffer is bounded, and a
``refine_cfg`` of another family is refused with the reference's message.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.configs import DPMMConfig as JConfig
from repro.core import checkpoint as jcheckpoint
from repro.core import gibbs as jgibbs
from repro.core.family import get_family as jget_family
from repro.core.state import PointState as JPointState
from repro.serve import dpmm as jserve
from repro_torch.configs import DPMMConfig
from repro_torch.core import checkpoint, gibbs, state
from repro_torch.core.family import get_family
from repro_torch.core.sampler import DPMM
from repro_torch.core.state import tree_map2
from repro_torch.data import synthetic
from repro_torch.kernels import loglik, prng
from repro_torch.serve import dpmm as tserve

FITS = {"gaussian": ("generate_gmm", 3), "multinomial": ("generate_mnmm", 8)}
B, DECAY, ALPHA = 256, 0.9, 10.0
USED = B - 56                  # the parity batch: 56 padded rows
TIE_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """family -> (checkpoint path, fresh rows of the mixture)."""
    root = tmp_path_factory.mktemp("refine")
    out = {}
    for family, (gen, d) in FITS.items():
        make = getattr(synthetic, gen)
        x, _ = make(1500, d, 3, seed=0)
        res = DPMM(DPMMConfig(component=family, k_max=16, iters=12,
                              burnout=3), device="cpu").fit(x)
        path = checkpoint.save_model(str(root / family), res.state, family)
        q, _ = make(600, d, 3, seed=1)
        out[family] = (path, np.asarray(q, np.float32))
    return out


def _batch(q, used):
    x = np.zeros((B, q.shape[1]), np.float32)
    x[:used] = q[:used]
    valid = np.zeros((B,), np.float32)
    valid[:used] = 1.0
    return x, valid


@pytest.fixture(autouse=True, scope="module")
def jax_refines(fitted):
    """family -> a future of (the JAX package's engine on the checkpoint,
    refining in batches of B rows; its refine step on the short batch,
    ``_jax_refine``). Built on two threads from the module's start: the
    JAX compiles (once per family) run two at a time, and while the
    port-only tests do; the tests that need them come last."""
    def build(family):
        path, q = fitted[family]
        jeng = jserve.DPMMEngine.from_checkpoint(
            path, jserve.ServeConfig(batch_sizes=(B,), refine=True,
                                     refine_batch=B))
        return jeng, _jax_refine(jeng, *_batch(q, USED))
    with ThreadPoolExecutor(2) as pool:
        yield {family: pool.submit(build, family) for family in FITS}


@pytest.fixture(scope="module")
def jax_engines(jax_refines):
    """family -> the JAX package's engine (``jax_refines``), waited for."""
    return {family: f.result()[0] for family, f in jax_refines.items()}


def _jax_refine(jeng, x, valid):
    """The JAX engine's refine step (``refine_sweep`` and its health
    verdict) on the served model, and the post-(a)-(d) model (numpy
    leaves, key as raw words)."""
    step, prior = jeng._refine_setup(jeng._served)
    jm = jeng.model
    m2, _, labels = step(jm, jnp.asarray(x), jnp.asarray(valid), prior)
    # steps (a)-(d) replaced weights and params and left the stats to the
    # tile: the post-(a)-(d) model is the result's with the old stats
    post = m2._replace(stats=jm.stats, substats=jm.substats, it=jm.it)
    as_np = jax.tree.map(np.asarray, post._replace(
        key=jax.random.key_data(post.key)))
    return jm, post, as_np, m2, np.asarray(labels)


def _jax_sublabels(family, post, x, valid):
    """The sub-labels of the JAX refine sweep's tile (the sweep tile under
    the post-(a)-(d) model)."""
    fam = jget_family(family)
    point = JPointState(labels=jnp.zeros((B,), jnp.int32),
                        sublabels=jnp.zeros((B,), jnp.int32),
                        valid=jnp.asarray(valid))
    acc = jgibbs.empty_substats(fam, post.active.shape[0], x.shape[1])
    point, _ = jgibbs.sweep_tile(post, jnp.asarray(x), point,
                                 jnp.arange(B, dtype=jnp.uint32), acc, fam)
    return np.asarray(point.sublabels)


def _fields(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)}


def _near_ties(fam, post, x, rows, a, b) -> None:
    """Raise unless each row's two labels' float64 logits (likelihood,
    log weight, the sweep's Gumbel noise) lie within TIE_RTOL."""
    p64 = type(post.params)(**{k: v.double()
                               for k, v in _fields(post.params).items()})
    xr = torch.as_tensor(x[rows]).double()
    ll = (loglik.loglik_plain(xr, p64.mu, p64.chol_prec, p64.logdet_prec)
          if fam.name == "gaussian" else fam.module.loglik(xr, p64))
    k_z = prng.key_tensor(gibbs.sweep_keys(post)[4], "cpu")
    slots = torch.arange(post.active.shape[0])
    t = (ll + post.logweights.double()[None, :]
         + prng.gumbel(k_z, torch.as_tensor(rows)[:, None],
                       slots[None, :]).double()).numpy()
    i = np.arange(len(rows))
    ta, tb = t[i, a[rows]], t[i, b[rows]]
    gap = np.abs(ta - tb) / np.maximum(1.0, np.maximum(np.abs(ta),
                                                       np.abs(tb)))
    assert (gap <= TIE_RTOL).all(), gap


@pytest.mark.parametrize("family", list(FITS))
def test_padded_rows_change_no_stat(fitted, family):
    path, q = fitted[family]
    fam = get_family(family)
    model, _ = checkpoint.load_model(path, "cpu")
    used = 100
    x, valid = _batch(q, used)
    garbage = x.copy()
    garbage[used:] = q[used:B]         # other rows in the padded tail
    a, la = gibbs.refine_tile(model, torch.as_tensor(x),
                              torch.as_tensor(valid), fam, DECAY)
    b, lb = gibbs.refine_tile(model, torch.as_tensor(garbage),
                              torch.as_tensor(valid), fam, DECAY)
    for sa, sb in ((a.stats, b.stats), (a.substats, b.substats)):
        for name, t in _fields(sa).items():
            assert torch.equal(t, getattr(sb, name)), name
    assert torch.equal(la[:used], lb[:used])
    # decay = 0 with every row padded: the stats are the zero batch's
    z, _ = gibbs.refine_tile(model, torch.as_tensor(x),
                             torch.zeros((B,)), fam, 0.0)
    assert float(z.stats.n.abs().sum()) == 0.0


@pytest.mark.parametrize("family", list(FITS))
def test_traffic_prior_is_the_reference_prior(fitted, family):
    path, _ = fitted[family]
    jm, _ = jcheckpoint.load_model(path)
    want = jserve._traffic_prior(jget_family(family),
                                 JConfig(component=family), jm)
    fam = get_family(family)
    model, _ = checkpoint.load_model(path, "cpu")
    got = tserve._traffic_prior(fam, DPMMConfig(component=family), model)
    got_leaves = [getattr(got, f.name) for f in dataclasses.fields(got)]
    for g, w in zip(got_leaves, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_refine_sweep_runs_steps_a_to_d_first(fitted):
    """The whole sweep: (a)-(d) under the model's own keys, then the tile;
    the same (key, it) gives the same bits, the next it other ones."""
    path, q = fitted["gaussian"]
    fam = get_family("gaussian")
    model, _ = checkpoint.load_model(path, "cpu")
    prior = tserve._traffic_prior(fam, DPMMConfig(), model)
    x, valid = (torch.as_tensor(a) for a in _batch(q, B))
    a, la = gibbs.refine_sweep(model, x, valid, prior, fam, ALPHA,
                               decay=DECAY)
    b, lb = gibbs.refine_sweep(model, x, valid, prior, fam, ALPHA,
                               decay=DECAY)
    assert torch.equal(la, lb) and torch.equal(a.stats.sxx, b.stats.sxx)
    post = gibbs.sweep_model(model, prior, fam, ALPHA)
    c, lc = gibbs.refine_tile(post, x, valid, fam, DECAY)
    assert torch.equal(la, lc) and torch.equal(a.params.mu, c.params.mu)
    assert a.it == model.it + 1
    assert set(np.unique(la.numpy())) <= set(
        np.flatnonzero(model.active.numpy()))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def _same_bits(r1, r2):
    return (np.array_equal(r1.labels, r2.labels)
            and np.array_equal(r1.logprobs, r2.logprobs)
            and np.array_equal(r1.log_predictive, r2.log_predictive))


def _engine(path, **kw):
    cfg = tserve.ServeConfig(batch_sizes=(64, 256), **kw)
    return tserve.DPMMEngine.from_checkpoint(path, cfg, device="cpu")


def test_refinement_disabled_is_chain_neutral(fitted):
    path, q = fitted["gaussian"]
    plain, armed = _engine(path), _engine(path, refine=True)
    assert _same_bits(plain.query(q), armed.query(q))
    assert _same_bits(plain.query(q), armed.query(q))
    assert np.array_equal(plain.sample(q[:64], seed=3),
                          armed.sample(q[:64], seed=3))
    with pytest.raises(ValueError, match="refine=True"):
        plain.refine()


def test_refinement_publishes_through_the_swap_path(fitted):
    path, q = fitted["gaussian"]
    eng = _engine(path, refine=True, refine_batch=256)
    r0 = eng.query(q[:512])            # also buffers the traffic
    out = eng.refine()
    assert out == {"sweeps": 2, "rows": 512, "rejected": 0, "published": 2,
                   "epoch": 2}
    assert [e["kind"] for e in eng.events] == ["refine_publish"] * 2
    assert [e["epoch"] for e in eng.events] == [1, 2]
    assert eng.events[-1]["it"] == int(checkpoint.load_model(
        path, "cpu")[0].it) + 2
    r1 = eng.query(q[:512])
    assert r1.model_epoch == r0.model_epoch + 2
    assert not np.array_equal(r0.logprobs, r1.logprobs)
    np.testing.assert_allclose(np.exp(r1.logprobs).sum(axis=1), 1.0,
                               rtol=1e-4)
    assert set(np.unique(r1.labels)) <= set(eng.slots.tolist())
    # r1 buffered its own traffic; after it a refine is a no-op
    assert eng.refine()["sweeps"] == 2
    assert eng.refine()["sweeps"] == 0


def test_poisoned_batch_is_rejected_as_the_reference_rejects_it(
        fitted, jax_engines):
    path, q = fitted["gaussian"]
    d = q.shape[1]
    poison = np.full((B, d), 1e30, np.float32)
    outs, events = [], []
    jeng = jax_engines["gaussian"]
    teng = _engine(path, refine=True, refine_batch=B)
    before = teng.query(q[:64])
    for eng in (jeng, teng):
        outs.append(eng.refine(x=poison))
        events.append(eng.events[-1])
    assert outs[0] == outs[1] == {"sweeps": 0, "rows": 0, "rejected": 1,
                                  "published": 0, "epoch": 0}
    assert events[0] == events[1]
    assert events[1]["kind"] == "refine_rejected"
    after = teng.query(q[:64])
    assert _same_bits(before, after) and after.model_epoch == 0
    # and the engine refines cleanly afterwards
    assert teng.refine(x=q[:64])["published"] == 1


def test_refine_buffer_is_bounded(fitted):
    path, q = fitted["gaussian"]
    eng = _engine(path, refine=True, refine_batch=64, refine_buffer=128)
    for i in range(8):
        eng.query(q[i * 64:(i + 1) * 64])
    assert eng._traffic_rows == 128
    eng.query(q[:200])                 # one request past the bound: cut
    assert eng._traffic_rows == 128
    np.testing.assert_array_equal(eng._traffic[0], q[72:200])
    out = eng.refine(publish=False)
    assert out["rows"] == 128 and out["sweeps"] == 2
    assert out["published"] == 0 and eng.epoch == 0


def test_refine_cfg_of_another_family_is_refused(fitted):
    path, q = fitted["gaussian"]
    eng = _engine(path, refine=True, refine_batch=64,
                  refine_cfg=DPMMConfig(component="multinomial"))
    with pytest.raises(ValueError, match="does not match the served"):
        eng.refine(x=q[:64])


@pytest.mark.parametrize("family", list(FITS))
def test_refine_tile_matches_the_jax_refine_sweep(fitted, jax_refines,
                                                 family):
    path, q = fitted[family]
    used = USED                         # a short batch: 56 padded rows
    x, valid = _batch(q, used)
    _, (jm, jpost, post_np, jm2, lab_j) = jax_refines[family].result()
    fam = get_family(family)
    post = state.model_state_from_numpy(post_np, "cpu", fam)
    m2, lab_t = gibbs.refine_tile(post, torch.as_tensor(x),
                                  torch.as_tensor(valid), fam, DECAY)
    assert m2.it == int(jm.it) + 1 == int(jm2.it)
    assert torch.equal(m2.active, post.active)
    lab_t = lab_t.numpy()
    bad = np.flatnonzero(lab_t[:used] != lab_j[:used])
    assert bad.size <= 0.01 * used
    if bad.size:
        _near_ties(fam, post, x, bad, lab_t, lab_j)
        # the blend of the JAX labelling's stats, from the port's fold
        k_max = post.active.shape[0]
        sub_j = _jax_sublabels(family, jpost, x, valid)
        batch = gibbs.finalize_substats(fam.stats_from_labels(
            torch.as_tensor(x), torch.as_tensor(valid),
            torch.as_tensor(lab_j), torch.as_tensor(sub_j), k_max))
        blend = lambda o, b: tree_map2(lambda u, v: DECAY * u + v, o, b)
        m2 = m2.replace(stats=blend(post.stats, batch[0]),
                        substats=blend(post.substats, batch[1]))
    for got, want in ((m2.stats, jm2.stats), (m2.substats, jm2.substats)):
        for name, t in _fields(got).items():
            w = np.asarray(getattr(want, name))
            if name == "n":
                np.testing.assert_allclose(t.numpy(), w, rtol=1e-6)
            else:
                np.testing.assert_allclose(t.numpy(), w, rtol=1e-5,
                                           atol=1e-3)
