"""The three-pass sweep of the port (``gibbs.sweep_tile(fused=False)``,
``ComponentFamily.sweep_ref``) and the plain versions of its step-(f)
kernels against the JAX package.

The JAX side runs as its own tests run it: ``sub_assign_gauss`` /
``sub_assign_linear`` and ``sweep_tile(fused=False, use_pallas=True)`` in
Pallas interpret mode, and at d = 130 ``family.sweep`` with
``use_pallas=True``, which declines its megakernel and runs the Pallas
step (e) and the jnp step (f) and stats above ``MAX_KERNEL_D``. The port
gets the same numpy inputs, or the same model state carried across with
``model_state_from_numpy``. Rules:

- labels and sub-labels equal, except mismatches that are near-ties (the
  two logits involved, re-scored in float64, within 1e-4 of the larger)
  and at most 0.1 % of the points;
- given equal labels, counts exact and the other stats within rtol 1e-5,
  atol 1e-3 (float32 sums of up to 1,024 points in another order);
- the port's three-pass and one-read tiles on the CPU: the same labels and
  the same stats within that tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gibbs as jgibbs
from repro.core import multinomial as jmult
from repro.core import niw as jniw
from repro.core.family import get_family as jget_family
from repro.core.state import ModelState as JModelState
from repro.core.state import PointState as JPointState
from repro.kernels import assign as jassign
from repro.kernels import prng as jprng
from repro_torch.configs import DPMMConfig
from repro_torch.core import gibbs, niw, sampler, state
from repro_torch.core.family import GAUSSIAN, MULTINOMIAL
from repro_torch.core.niw import GaussParams, GaussStats
from repro_torch.data.synthetic import generate_gmm, generate_mnmm
from repro_torch.kernels import assign, sweep

TIE_RTOL = 1e-4
N, K = 1100, 6          # two STATS_BLOCKs, ragged
K_MAX, K_C = 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _sub_inputs(gauss: bool, d: int, seed: int):
    """Step-(f) operands in the reference's argument order, as numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    labels = rng.integers(0, K, N).astype(np.int32)
    sublogw = np.log(rng.dirichlet(np.ones(2), size=K)).astype(f32)
    gidx = (np.arange(N) + 3000).astype(np.uint32)
    key_zb = np.array([0xFFFFFFFF, 3], np.uint32)
    if gauss:
        params = ((rng.normal(size=(N, d)) * 3).astype(f32),
                  (rng.normal(size=(K, 2, d)) * 3).astype(f32),
                  (np.tril(rng.normal(size=(K, 2, d, d)) * 0.3)
                   + np.eye(d)).astype(f32),
                  rng.normal(size=(K, 2)).astype(f32))
    else:
        params = (rng.poisson(3.0, size=(N, d)).astype(f32),
                  np.log(rng.dirichlet(np.full(d, 0.5), size=(K, 2))
                         + 1e-30).astype(f32),
                  rng.normal(size=(K, 2)).astype(f32))
    return params + (sublogw, labels, gidx, key_zb)


def _to_torch(a):
    *floats, labels, gidx, key = a
    i64 = lambda v: torch.as_tensor(v.astype(np.int64))
    return (tuple(torch.as_tensor(v) for v in floats)
            + (torch.as_tensor(labels), i64(gidx), i64(key)))


@pytest.mark.parametrize("gauss,d", [(True, 3), (True, 8), (False, 5),
                                     (False, 8)])
def test_sub_assign_plain_matches_jax_kernel(gauss, d):
    a = _sub_inputs(gauss, d, seed=d)
    jfn = jassign.sub_assign_gauss if gauss else jassign.sub_assign_linear
    want = torch.as_tensor(np.array(jfn(*(jnp.asarray(v) for v in a),
                                          interpret=True)))
    args = _to_torch(a)
    plain = (assign.sub_assign_gauss_plain if gauss
             else assign.sub_assign_linear_plain)
    got = plain(*args)
    assert got.dtype == torch.int32 and got.shape == (N,)
    bad, not_ties = assign.sub_assign_mismatches(gauss, args, got, want,
                                                 TIE_RTOL)
    assert not_ties == 0 and bad <= 0.001 * N, (bad, not_ties)
    assert 0.2 < float(got.float().mean()) < 0.8    # both sub-clusters won


def test_sub_assign_mismatches_proves_near_ties_in_float64():
    args = _to_torch(_sub_inputs(True, 3, seed=1))
    got = assign.sub_assign_gauss_plain(*args)
    assert assign.sub_assign_mismatches(True, args, got, got, TIE_RTOL) \
        == (0, 0)
    flip = got.clone()
    flip[:3] = 1 - flip[:3]
    x, smu, sf, sld, slw, lab, gidx, kzb = args
    own = lab[:3].long()
    y = torch.einsum("msd,msde->mse",
                     x[:3, None, :].double() - smu[own].double(),
                     sf[own].double())
    t = (0.5 * (sld[own].double() - (y * y).sum(-1)) - 1.5 * sweep.LOG_2PI
         + slw[own].double() + sweep.prng.gumbel(
             kzb, gidx[:3, None], torch.arange(2)[None, :]).double())
    gaps = (t[:, 0] - t[:, 1]).abs() / t.abs().max(1).values.clamp(min=1)
    assert assign.sub_assign_mismatches(True, args, flip, got,
                                        float(gaps.min()) / 2) == (3, 3)
    assert assign.sub_assign_mismatches(True, args, flip, got,
                                        float(gaps.max()) * 2) == (3, 0)


# ---------------------------------------------------------------------------
# One three-pass tile from one carried-across state
# ---------------------------------------------------------------------------
_JCLS = {"gaussian": (jniw.GaussParams, jniw.GaussStats),
         "multinomial": (jmult.MultParams, jmult.MultStats)}


def _state(fam, x):
    """The port's initial state, handed to JAX as a ``repro`` ModelState
    and carried back with ``model_state_from_numpy``."""
    cfg = DPMMConfig(component=fam.name, init_clusters=2, k_max=K_MAX)
    xt = torch.as_tensor(x)
    prior = fam.build_prior(cfg, xt.mean(0, keepdim=True))
    model0, point = sampler._init_local(
        torch.tensor([0, 7]), xt,
        torch.ones(x.shape[0]), prior=prior, family=fam, cfg=cfg,
        k_max=K_MAX)
    tree = state.model_state_to_numpy(model0)
    pcls, scls = _JCLS[fam.name]
    leaves = lambda cls, t: cls(**{k: jnp.asarray(v) for k, v in t.items()})
    jmodel = JModelState(
        key=jax.random.wrap_key_data(jnp.asarray(tree["key"])),
        it=jnp.int32(tree["it"]), active=jnp.asarray(tree["active"]),
        logweights=jnp.asarray(tree["logweights"]),
        sub_logweights=jnp.asarray(tree["sub_logweights"]),
        stuck=jnp.asarray(tree["stuck"]),
        params=leaves(pcls, tree["params"]),
        subparams=leaves(pcls, tree["subparams"]),
        stats=leaves(scls, tree["stats"]),
        substats=leaves(scls, tree["substats"]))
    jpoint = JPointState(labels=jnp.asarray(point.labels.numpy()),
                         sublabels=jnp.asarray(point.sublabels.numpy()),
                         valid=jnp.ones(x.shape[0], jnp.float32))
    as_np = jax.tree.map(np.asarray, jmodel._replace(
        key=jax.random.key_data(jmodel.key)))
    return (state.model_state_from_numpy(as_np, "cpu", fam), point, jmodel,
            jpoint)


def _stats_close(t, j, fields) -> None:
    np.testing.assert_array_equal(t.n.numpy(), np.asarray(j.n))
    for f in fields:
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("name", ["gaussian", "multinomial"])
def test_three_pass_tile_matches_jax_and_the_one_read_tile(name):
    fam = {"gaussian": GAUSSIAN, "multinomial": MULTINOMIAL}[name]
    jfam = jget_family(name)
    if name == "gaussian":
        x, _ = generate_gmm(N, 3, 4, seed=1)
        fields = ("sx", "sxx")
    else:
        x, _ = generate_mnmm(N, 12, 4, seed=1)
        fields = ("counts",)
    model, point, jm, jpt = _state(fam, x)
    d = x.shape[1]

    @jax.jit
    def ref(jm, jpt):
        plan = jgibbs.compaction_plan(jm.active, K_C)
        acc = jgibbs.empty_substats(jfam, K_C, d)
        *_, k_z, k_zb = jgibbs.sweep_keys(jm)
        pt, acc = jgibbs.sweep_tile(jm, jnp.asarray(x), jpt,
                                    jnp.arange(N, dtype=jnp.uint32), acc,
                                    jfam, use_pallas=True, fused=False,
                                    plan=plan)
        return pt, acc, jprng.key_words(k_z), jprng.key_words(k_zb)

    jpt2, jacc, kz, kzb = ref(jm, jpt)
    words = lambda k: torch.as_tensor(np.asarray(k).astype(np.int64))
    plan = gibbs.compaction_plan(model.active, K_C)
    xt = torch.as_tensor(x)

    def tile(fused):
        return gibbs.sweep_tile(
            model, xt, point, gibbs.global_indices(N, "cpu"),
            gibbs.empty_substats(fam, K_C, d, "cpu"), fam, words(kz),
            words(kzb), plan=plan, fused=fused)

    three, acc3 = tile(False)
    one, acc1 = tile(True)
    # the one-read and the three-pass tile of the port: the same chain
    assert torch.equal(three.labels, one.labels)
    assert torch.equal(three.sublabels, one.sublabels)
    _stats_close(acc3, acc1, fields)
    # against the JAX package's three-pass tile, near-ties proven
    take = lambda t: gibbs.compact_gather(plan, t)
    p, sp = take(model.params), take(model.subparams)
    if name == "gaussian":
        args = (xt,) + niw.sweep_pack(p, sp)
        args = args[:4] + (take(model.logweights),
                           take(model.active).to(torch.int32)) + args[4:]
        args += (take(model.sub_logweights),)
        mismatches = sweep.label_mismatches
    else:
        feats, w, const, subw, subconst = fam.module.sweep_pack(xt, p, sp)
        args = (feats, w, const, take(model.logweights),
                take(model.active).to(torch.int32), subw, subconst,
                take(model.sub_logweights))
        mismatches = sweep.label_mismatches_linear
    args += (torch.ones(N), gibbs.global_indices(N, "cpu"), words(kz),
             words(kzb), plan.slot_of_compact.to(torch.int32))
    compact = lambda lab: plan.compact_of_slot[lab.long()].to(torch.int32)
    lab_j = torch.as_tensor(np.array(jpt2.labels))
    sub_j = torch.as_tensor(np.array(jpt2.sublabels))
    bad, not_ties = mismatches(args, compact(three.labels), three.sublabels,
                               compact(lab_j), sub_j, TIE_RTOL)
    assert not_ties == 0 and bad <= 0.001 * N, (bad, not_ties)
    if bad:            # stats of JAX's labelling, from the port's fold
        acc3 = fam.stats_from_labels(xt, three.valid, compact(lab_j), sub_j,
                                     K_C)
    _stats_close(acc3, jacc, fields)


def _refuse(*args):
    raise AssertionError("the fused sweep ran")


def test_gaussian_sweep_past_d128_takes_sweep_ref_and_matches_jax():
    d, k, n = 130, 4, 600
    rng = np.random.default_rng(130)
    f32 = np.float32
    x = (rng.normal(size=(n, d)) * 2).astype(f32)
    mu = (rng.normal(size=(k, d)) * 2).astype(f32)
    chol = (np.tril(rng.normal(size=(k, d, d)) * 0.05)
            + np.eye(d)).astype(f32)
    ld = rng.normal(size=k).astype(f32)
    smu = (mu[:, None, :] + rng.normal(size=(k, 2, d))).astype(f32)
    schol = (np.tril(rng.normal(size=(k, 2, d, d)) * 0.05)
             + np.eye(d)).astype(f32)
    sld = rng.normal(size=(k, 2)).astype(f32)
    logw = np.log(rng.dirichlet(np.ones(k))).astype(f32)
    sublogw = np.log(rng.dirichlet(np.ones(2), size=k)).astype(f32)
    active = np.array([1, 1, 0, 1], bool)
    gidx = np.arange(n, dtype=np.uint32)
    kz = np.array([5, 0xDEADBEEF], np.uint32)
    kzb = np.array([7, 11], np.uint32)
    slots = np.array([0, 3, 5, 6], np.uint32)

    j = jnp.asarray
    jfam = jget_family("gaussian")

    @jax.jit
    def ref(x, mu, chol, ld, smu, schol, sld, logw, sublogw, active, gidx,
            kz, kzb, slots):
        return jfam.sweep(
            x, jnp.ones(n, f32), jniw.GaussParams(mu, chol, ld),
            jniw.GaussParams(smu, schol, sld), logw, sublogw, active, gidx,
            kz, kzb, k, jniw.empty_stats((k, 2), d), use_pallas=True,
            slots=slots)

    lab_j, sub_j, acc_j = ref(*(j(v) for v in (
        x, mu, chol, ld, smu, schol, sld, logw, sublogw, active, gidx, kz,
        kzb, slots)))

    t = torch.as_tensor
    i64 = lambda v: t(v.astype(np.int64))
    # the fused sweep refuses to run: the rule reads the shape only
    fam = dataclasses.replace(GAUSSIAN, fused_sweep=_refuse)
    targs = (t(x), torch.ones(n), GaussParams(t(mu), t(chol), t(ld)),
             GaussParams(t(smu), t(schol), t(sld)), t(logw), t(sublogw),
             t(active), i64(gidx), i64(kz), i64(kzb), k)
    acc0 = lambda: gibbs.empty_substats(GAUSSIAN, k, d, "cpu")
    lab, sub, acc = fam.sweep(*targs, acc0(), slots=i64(slots))
    ref = GAUSSIAN.sweep_ref(*targs, acc0(), slots=i64(slots))
    assert torch.equal(lab, ref[0]) and torch.equal(sub, ref[1])
    with pytest.raises(AssertionError, match="fused sweep ran"):
        fam.sweep(t(x[:, :128]), *targs[1:], acc0())

    sargs = (t(x), t(mu), t(chol), t(ld), t(logw),
             t(active.astype(np.int32)), t(smu), t(schol), t(sld),
             t(sublogw), torch.ones(n), i64(gidx), i64(kz), i64(kzb),
             t(slots.astype(np.int32)))
    bad, not_ties = sweep.label_mismatches(
        sargs, lab, sub, t(np.array(lab_j)), t(np.array(sub_j)),
        TIE_RTOL)
    assert not_ties == 0 and bad <= 0.001 * n, (bad, not_ties)
    assert active[lab.numpy()].all()
    if bad:            # stats of JAX's labelling, from the port's fold
        acc = GAUSSIAN.stats_from_labels(t(x), torch.ones(n),
                                         t(np.array(lab_j)),
                                         t(np.array(sub_j)), k)
    _stats_close(acc, acc_j, ("sx", "sxx"))
    assert isinstance(acc, GaussStats) and acc.sxx.shape == (k, 2, d, d)
