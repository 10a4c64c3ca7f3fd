"""One Gibbs tile and one split/merge tile of the port against the JAX
package, from one model state carried across with
``model_state_from_numpy``.

The JAX side runs its plain reference path (``use_pallas=False``; the
kernels are held against it in test_torch_kernels.py). Labels must be
equal except counted near-ties (sweep: the two logits within 1e-4;
split/merge: a hyperplane projection within 1e-4 of 0), at most 0.1 % of
the points; given equal labels, counts are exact and sx / sxx within
rtol 1e-5, atol 1e-3 (sums of up to 3,000 points in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gibbs as jgibbs
from repro.core import niw as jniw
from repro.core import splitmerge as jsm
from repro.core.family import get_family
from repro.core.state import ModelState as JModelState
from repro.core.state import PointState as JPointState
from repro.kernels import prng as jprng
from repro_torch.configs import DPMMConfig
from repro_torch.core import gibbs, sampler, splitmerge, state
from repro_torch.core.family import GAUSSIAN
from repro_torch.core.niw import GaussStats
from repro_torch.data.synthetic import generate_gmm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


N, D, K_MAX, K_C = 3000, 2, 16, 8
JFAM = get_family("gaussian")


@pytest.fixture(scope="module")
def setup():
    """Initial state built by the port's ``_init_local``, handed to JAX as
    a ``repro`` ModelState, and carried back with
    ``model_state_from_numpy``."""
    x, _ = generate_gmm(N, D, 4, seed=1)
    cfg = DPMMConfig(init_clusters=2, k_max=K_MAX)
    xt = torch.as_tensor(x)
    valid = torch.ones(N)
    prior = GAUSSIAN.build_prior(cfg, xt.mean(0, keepdim=True))
    model0, point = sampler._init_local(
        torch.Generator().manual_seed(0), torch.tensor([0, 7]), xt, valid,
        prior=prior, family=GAUSSIAN, cfg=cfg, k_max=K_MAX)
    tree = state.model_state_to_numpy(model0)
    jp = lambda p: jniw.GaussParams(**{k: jnp.asarray(v)
                                       for k, v in p.items()})
    js = lambda p: jniw.GaussStats(**{k: jnp.asarray(v)
                                      for k, v in p.items()})
    jmodel = JModelState(
        key=jax.random.wrap_key_data(jnp.asarray(tree["key"])),
        it=jnp.int32(tree["it"]), active=jnp.asarray(tree["active"]),
        logweights=jnp.asarray(tree["logweights"]),
        sub_logweights=jnp.asarray(tree["sub_logweights"]),
        stuck=jnp.asarray(tree["stuck"]), params=jp(tree["params"]),
        subparams=jp(tree["subparams"]), stats=js(tree["stats"]),
        substats=js(tree["substats"]))
    jpoint = JPointState(labels=jnp.asarray(point.labels.numpy()),
                         sublabels=jnp.asarray(point.sublabels.numpy()),
                         valid=jnp.ones(N, jnp.float32))
    jprior = jniw.NIWPrior(*(jnp.asarray(v.numpy()) for v in (
        prior.m, prior.psi, prior.kappa, prior.nu)))
    # the JAX state as numpy leaves, key as its raw words, back to torch
    as_np = jax.tree.map(np.asarray, jmodel._replace(
        key=jax.random.key_data(jmodel.key)))
    model = state.model_state_from_numpy(as_np, "cpu", GAUSSIAN)
    jplan, draws = _jax_plan(jmodel, jprior, jax.random.key(0))
    return dict(x=x, xt=xt, cfg=cfg, prior=prior, jprior=jprior,
                model=model, point=point, jmodel=jmodel, jpoint=jpoint,
                jplan=jplan, draws=draws)


def test_state_carried_across_is_the_same_state(setup):
    m, jm = setup["model"], setup["jmodel"]
    assert m.it == 0 and m.active.dtype == torch.bool
    np.testing.assert_array_equal(m.key.numpy(),
                                  np.asarray(jax.random.key_data(jm.key)))
    np.testing.assert_array_equal(m.params.chol_prec.numpy(),
                                  np.asarray(jm.params.chol_prec))
    back = state.model_state_to_numpy(m)
    again = state.model_state_from_numpy(back, "cpu", GAUSSIAN)
    assert torch.equal(again.substats.sxx, m.substats.sxx)
    assert torch.equal(again.stuck, m.stuck)


def _stats_close(t: GaussStats, j) -> None:
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
    np.testing.assert_allclose(t.sx.numpy(), np.asarray(j.sx), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(t.sxx.numpy(), np.asarray(j.sxx), rtol=1e-5,
                               atol=1e-3)


def test_sweep_tile_matches_jax(setup):
    x, jm, jpt = setup["x"], setup["jmodel"], setup["jpoint"]

    @jax.jit
    def ref(jm, jpt):
        plan = jgibbs.compaction_plan(jm.active, K_C)
        acc = jgibbs.empty_substats(JFAM, K_C, D)
        gidx = jnp.arange(N, dtype=jnp.uint32)
        *_, k_z, k_zb = jgibbs.sweep_keys(jm)
        pt, acc = jgibbs.sweep_tile(jm, jnp.asarray(x), jpt, gidx, acc,
                                    JFAM, use_pallas=False, plan=plan)
        return pt, acc, jprng.key_words(k_z), jprng.key_words(k_zb)

    jpt2, jacc, kz, kzb = ref(jm, jpt)
    model = setup["model"]
    plan = gibbs.compaction_plan(model.active, K_C)
    words = lambda k: torch.as_tensor(np.asarray(k).astype(np.int64))
    pt2, acc = gibbs.sweep_tile(
        model, setup["xt"], setup["point"], gibbs.global_indices(N, "cpu"),
        gibbs.empty_substats(GAUSSIAN, K_C, D, "cpu"), GAUSSIAN, words(kz),
        words(kzb), plan=plan)
    lab_j, sub_j = np.asarray(jpt2.labels), np.asarray(jpt2.sublabels)
    bad = np.nonzero((pt2.labels.numpy() != lab_j)
                     | (pt2.sublabels.numpy() != sub_j))[0]
    assert bad.size <= 0.001 * N
    if bad.size:       # stats of the same labelling, from the port's fold
        acc = GAUSSIAN.stats_from_labels(
            setup["xt"], pt2.valid,
            plan.compact_of_slot[torch.as_tensor(lab_j).long()],
            torch.tensor(sub_j), K_C)
    _stats_close(acc, jacc)
    assert set(np.unique(lab_j)) <= set(np.nonzero(np.asarray(
        jm.active))[0])


def _jax_plan(jm, jprior, key):
    @jax.jit
    def run(jm, key):
        plan = jsm.plan_split_merge(key, jm, jprior, JFAM, 10.0, 10)
        k_s, k_m, k_b = jax.random.split(key, 3)
        k_max, d = plan.means_split.shape
        p = k_max * (k_max - 1) // 2
        draws = (jax.random.uniform(jax.random.fold_in(k_s, 0), (k_max,),
                                    minval=1e-12),
                 jax.random.uniform(k_m, (p,), minval=1e-12))
        return plan, draws
    return run(jm, key)


def _plan_to_torch(plan) -> splitmerge.SplitMergePlan:
    t = lambda v: torch.tensor(np.asarray(v))
    s, m = plan.split, plan.merge
    return splitmerge.SplitMergePlan(
        split=splitmerge.SplitDecision(t(s.accept), t(s.dest).long(),
                                       t(s.new_active)),
        merge=splitmerge.MergeDecision(t(m.merged), t(m.into).long(),
                                       t(m.side).long(), t(m.new_active)),
        means_split=t(plan.means_split), means_merge=t(plan.means_merge),
        vecs_split=t(plan.vecs_split), vecs_reset=t(plan.vecs_reset),
        reset=t(plan.reset), stuck=t(plan.stuck))


def test_plan_split_merge_matches_jax_with_its_draws(setup):
    jplan, (u_s, u_m) = setup["jplan"], setup["draws"]
    assert bool(np.asarray(jplan.split.accept).any())
    t = lambda v: torch.tensor(np.asarray(v))
    draws = splitmerge.SplitMergeDraws(t(u_s), t(u_m), t(jplan.vecs_split),
                                       t(jplan.vecs_reset))
    plan = splitmerge.plan_split_merge(draws, setup["model"],
                                       setup["prior"], GAUSSIAN, 10.0, 10)
    want = _plan_to_torch(jplan)
    for a, b in ((plan.split.accept, want.split.accept),
                 (plan.split.dest, want.split.dest),
                 (plan.split.new_active, want.split.new_active),
                 (plan.merge.merged, want.merge.merged),
                 (plan.merge.into, want.merge.into),
                 (plan.merge.side, want.merge.side),
                 (plan.merge.new_active, want.merge.new_active),
                 (plan.reset, want.reset), (plan.stuck, want.stuck)):
        assert torch.equal(a, b)
    for a, b in ((plan.means_split, want.means_split),
                 (plan.means_merge, want.means_merge)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_split_merge_tile_matches_jax_with_its_plan(setup):
    x, jpt, jplan = setup["x"], setup["jpoint"], setup["jplan"]

    @jax.jit
    def ref(jplan, jpt):
        comp = jgibbs.compaction_plan(jplan.merge.new_active, K_C)
        acc = jgibbs.empty_substats(JFAM, K_C, D)
        return jsm.split_merge_tile(jplan, jnp.asarray(x), jpt, acc, JFAM,
                                    use_pallas=False, compaction=comp)

    jpt2, jacc = ref(jplan, jpt)
    plan = _plan_to_torch(jplan)
    comp = gibbs.compaction_plan(plan.merge.new_active, K_C)
    pt2, acc = splitmerge.split_merge_tile(
        plan, setup["xt"], setup["point"],
        gibbs.empty_substats(GAUSSIAN, K_C, D, "cpu"), GAUSSIAN,
        compaction=comp)
    lab_j, sub_j = np.asarray(jpt2.labels), np.asarray(jpt2.sublabels)
    np.testing.assert_array_equal(pt2.labels.numpy(), lab_j)
    bad = np.nonzero(pt2.sublabels.numpy() != sub_j)[0]
    assert bad.size <= 0.001 * N
    for i in bad:      # a sign flip of a projection within 1e-4 of 0
        lab = int(lab_j[i])
        for means, v in ((plan.means_split, plan.vecs_split),
                         (plan.means_merge, plan.vecs_reset)):
            proj = float(((setup["xt"][i] - means[lab]) * v[lab]).sum())
            if abs(proj) < 1e-4:
                break
        else:
            raise AssertionError(f"point {i}: sub-label mismatch, no tie")
    if bad.size:
        acc = GAUSSIAN.stats_from_labels(
            setup["xt"], pt2.valid,
            comp.compact_of_slot[torch.as_tensor(lab_j).long()],
            torch.tensor(sub_j), K_C)
    _stats_close(acc, jacc)
    # the move really moved points: accepted splits relabel
    assert not np.array_equal(lab_j, setup["point"].labels.numpy())
