"""One Gibbs tile and one split/merge move of the multinomial family
against the JAX package, from one model state carried across with
``model_state_from_numpy``: the generic layers (the family's sweep pack,
``fold_blocked`` with the compaction map, ``cluster_means`` over
``counts``, the Dirichlet-multinomial Hastings ratios) on a linear family.

The JAX side runs its plain reference path (``use_pallas=False``).
Labels must be equal except counted mismatches (at most 0.1 % of the
points); given equal labels, counts are exact and summed count vectors
within rtol 1e-5, atol 1e-3. The plan's decisions must be equal and its
cluster means within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gibbs as jgibbs
from repro.core import multinomial as jmult
from repro.core import splitmerge as jsm
from repro.core.family import get_family
from repro.core.state import ModelState as JModelState
from repro.core.state import PointState as JPointState
from repro.kernels import prng as jprng
from repro_torch.configs import DPMMConfig
from repro_torch.core import gibbs, sampler, splitmerge, state
from repro_torch.core.family import MULTINOMIAL
from repro_torch.data.synthetic import generate_mnmm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


N, D, K_MAX, K_C = 3000, 12, 16, 8
JFAM = get_family("multinomial")


@pytest.fixture(scope="module")
def setup():
    x, _ = generate_mnmm(N, D, 4, seed=1)
    cfg = DPMMConfig(component="multinomial", init_clusters=2, k_max=K_MAX)
    xt = torch.as_tensor(x)
    prior = MULTINOMIAL.build_prior(cfg, xt.mean(0, keepdim=True))
    model0, point = sampler._init_local(
        torch.tensor([0, 7]), xt,
        torch.ones(N), prior=prior, family=MULTINOMIAL, cfg=cfg,
        k_max=K_MAX)
    tree = state.model_state_to_numpy(model0)
    jmodel = JModelState(
        key=jax.random.wrap_key_data(jnp.asarray(tree["key"])),
        it=jnp.int32(tree["it"]), active=jnp.asarray(tree["active"]),
        logweights=jnp.asarray(tree["logweights"]),
        sub_logweights=jnp.asarray(tree["sub_logweights"]),
        stuck=jnp.asarray(tree["stuck"]),
        params=jmult.MultParams(jnp.asarray(tree["params"]["logtheta"])),
        subparams=jmult.MultParams(
            jnp.asarray(tree["subparams"]["logtheta"])),
        stats=jmult.MultStats(**{k: jnp.asarray(v)
                                 for k, v in tree["stats"].items()}),
        substats=jmult.MultStats(**{k: jnp.asarray(v)
                                    for k, v in tree["substats"].items()}))
    jpoint = JPointState(labels=jnp.asarray(point.labels.numpy()),
                         sublabels=jnp.asarray(point.sublabels.numpy()),
                         valid=jnp.ones(N, jnp.float32))
    jprior = jmult.default_prior(D, cfg.dir_alpha)
    as_np = jax.tree.map(np.asarray, jmodel._replace(
        key=jax.random.key_data(jmodel.key)))
    model = state.model_state_from_numpy(as_np, "cpu", MULTINOMIAL)
    return dict(x=x, xt=xt, prior=prior, jprior=jprior, model=model,
                point=point, jmodel=jmodel, jpoint=jpoint)


def _stats_close(t, j) -> None:
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
    np.testing.assert_allclose(t.counts.numpy(), np.asarray(j.counts),
                               rtol=1e-5, atol=1e-3)


def test_sweep_tile_matches_jax(setup):
    x, jm, jpt = setup["x"], setup["jmodel"], setup["jpoint"]

    @jax.jit
    def ref(jm, jpt):
        plan = jgibbs.compaction_plan(jm.active, K_C)
        acc = jgibbs.empty_substats(JFAM, K_C, D)
        *_, k_z, k_zb = jgibbs.sweep_keys(jm)
        pt, acc = jgibbs.sweep_tile(jm, jnp.asarray(x), jpt,
                                    jnp.arange(N, dtype=jnp.uint32), acc,
                                    JFAM, use_pallas=False, plan=plan)
        return pt, acc, jprng.key_words(k_z), jprng.key_words(k_zb)

    jpt2, jacc, kz, kzb = ref(jm, jpt)
    model = setup["model"]
    plan = gibbs.compaction_plan(model.active, K_C)
    words = lambda k: torch.as_tensor(np.asarray(k).astype(np.int64))
    pt2, acc = gibbs.sweep_tile(
        model, setup["xt"], setup["point"], gibbs.global_indices(N, "cpu"),
        gibbs.empty_substats(MULTINOMIAL, K_C, D, "cpu"), MULTINOMIAL,
        words(kz), words(kzb), plan=plan)
    lab_j, sub_j = np.asarray(jpt2.labels), np.asarray(jpt2.sublabels)
    bad = np.nonzero((pt2.labels.numpy() != lab_j)
                     | (pt2.sublabels.numpy() != sub_j))[0]
    assert bad.size <= 0.001 * N
    if bad.size:       # stats of the same labelling, from the port's fold
        acc = MULTINOMIAL.stats_from_labels(
            setup["xt"], pt2.valid,
            plan.compact_of_slot[torch.as_tensor(lab_j).long()],
            torch.tensor(sub_j), K_C)
    _stats_close(acc, jacc)


def test_split_merge_move_matches_jax_with_its_draws(setup):
    jm, jpt, x = setup["jmodel"], setup["jpoint"], setup["x"]

    @jax.jit
    def ref(jm, jpt, key):
        plan = jsm.plan_split_merge(key, jm, setup["jprior"], JFAM, 10.0, 10)
        k_s, k_m, _ = jax.random.split(key, 3)
        u = (jax.random.uniform(jax.random.fold_in(k_s, 0), (K_MAX,),
                                minval=1e-12),
             jax.random.uniform(k_m, (K_MAX * (K_MAX - 1) // 2,),
                                minval=1e-12))
        comp = jgibbs.compaction_plan(plan.merge.new_active, K_C)
        pt, acc = jsm.split_merge_tile(
            plan, jnp.asarray(x), jpt, jgibbs.empty_substats(JFAM, K_C, D),
            JFAM, use_pallas=False, compaction=comp)
        return plan, u, pt, acc

    jplan, (u_s, u_m), jpt2, jacc = ref(jm, jpt, jax.random.key(0))
    assert bool(np.asarray(jplan.split.accept).any())
    t = lambda v: torch.tensor(np.asarray(v))
    draws = splitmerge.SplitMergeDraws(t(u_s), t(u_m), t(jplan.vecs_split),
                                       t(jplan.vecs_reset))
    plan = splitmerge.plan_split_merge(draws, setup["model"],
                                       setup["prior"], MULTINOMIAL, 10.0, 10)
    for a, b in ((plan.split.accept, jplan.split.accept),
                 (plan.split.dest, jplan.split.dest),
                 (plan.merge.into, jplan.merge.into),
                 (plan.merge.new_active, jplan.merge.new_active),
                 (plan.reset, jplan.reset), (plan.stuck, jplan.stuck)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((plan.means_split, jplan.means_split),
                 (plan.means_merge, jplan.means_merge)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    comp = gibbs.compaction_plan(plan.merge.new_active, K_C)
    pt2, acc = splitmerge.split_merge_tile(
        plan, setup["xt"], setup["point"],
        gibbs.empty_substats(MULTINOMIAL, K_C, D, "cpu"), MULTINOMIAL,
        compaction=comp)
    lab_j, sub_j = np.asarray(jpt2.labels), np.asarray(jpt2.sublabels)
    np.testing.assert_array_equal(pt2.labels.numpy(), lab_j)
    assert (pt2.sublabels.numpy() != sub_j).sum() <= 0.001 * N
    if not np.array_equal(pt2.sublabels.numpy(), sub_j):
        acc = MULTINOMIAL.stats_from_labels(
            setup["xt"], pt2.valid,
            comp.compact_of_slot[torch.as_tensor(lab_j).long()],
            torch.tensor(sub_j), K_C)
    _stats_close(acc, jacc)
