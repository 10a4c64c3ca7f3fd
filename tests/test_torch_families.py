"""The linear families' conjugate math, packs and label statistics against
the JAX package, and the model-state interchange of all four families.

For each of multinomial, poisson and diag_gaussian, the same numpy points
and labels go through ``repro.core.<family>`` and
``repro_torch.core.<family>``. ``sample_posterior`` gets the JAX
package's own ``jax.random.gamma`` / ``normal`` draws, injected.

Tolerances: counts exact; first moments rtol 1e-5, atol 1e-3 (float32
sums of up to 600 points in another order); closed forms, packs and
sampled parameters rtol/atol 1e-4 (float32 algebra and ``lgamma`` in two
libraries, on values up to ~1e4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.core import diag_gaussian as jdiag
from repro.core import multinomial as jmult
from repro.core import niw as jniw
from repro.core import poisson as jpois
from repro.core.state import ModelState as JModelState
from repro_torch.configs import DPMMConfig
from repro_torch.core import diag_gaussian, multinomial, poisson, state
from repro_torch.core.family import get_family
from repro_torch.data.synthetic import (generate_gmm, generate_mnmm,
                                        generate_pmm)

K = 5
FAMILIES = {
    "multinomial": (jmult, multinomial, lambda: generate_mnmm(600, 12, 3)),
    "poisson": (jpois, poisson, lambda: generate_pmm(600, 6, 3)),
    "diag_gaussian": (jdiag, diag_gaussian, lambda: generate_gmm(600, 4, 3)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


def close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _fields_close(t, j, tol=1e-4):
    for name, jv in j._asdict().items():
        close(getattr(t, name), jv, tol)


def _setup(name):
    """Points, labels that leave slot K-1 empty, both priors and both
    (K, 2) sub-cluster stats."""
    jmod, tmod, data = FAMILIES[name]
    x, y = data()
    rng = np.random.default_rng(7)
    lab = (y % (K - 1)).astype(np.int32)
    sub = rng.integers(0, 2, x.shape[0]).astype(np.int32)
    valid = np.ones(x.shape[0], np.float32)
    valid[-20:] = 0.0
    cfg = DPMMConfig(dir_alpha=0.7, gamma_a0=1.5, gamma_b0=0.5)
    xm = x.mean(0, keepdims=True)
    jprior = jmod.build_prior(cfg, jnp.asarray(xm))
    tprior = tmod.build_prior(cfg, torch.as_tensor(xm))
    jst = jmod.stats_from_labels(jnp.asarray(x), jnp.asarray(valid),
                                 jnp.asarray(lab), jnp.asarray(sub), K)
    tst = tmod.stats_from_labels(torch.as_tensor(x), torch.as_tensor(valid),
                                 torch.as_tensor(lab), torch.as_tensor(sub),
                                 K)
    return x, jmod, tmod, jprior, tprior, jst, tst


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_stats_from_labels_and_prior_match_jax(name):
    _, _, _, jprior, tprior, jst, tst = _setup(name)
    np.testing.assert_array_equal(tst.n.numpy(), np.asarray(jst.n))
    for field in jst._fields[1:]:
        np.testing.assert_allclose(getattr(tst, field).numpy(),
                                   np.asarray(getattr(jst, field)),
                                   rtol=1e-5, atol=1e-3)
    assert float(tst.n[K - 1].sum()) == 0.0         # an empty cluster
    for field, jv in jprior._asdict().items():
        tv = getattr(tprior, field)
        if isinstance(tv, int):
            assert tv == jv
        else:
            close(tv, jv, 1e-6)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_closed_forms_packs_and_loglik_match_jax(name):
    x, jmod, tmod, jprior, tprior, jst, tst = _setup(name)
    # both sides compute from the same (JAX-folded) statistics
    tst = type(tst)(**{f: torch.tensor(np.asarray(v))
                       for f, v in jst._asdict().items()})
    close(tmod.log_marginal(tprior, tst), jmod.log_marginal(jprior, jst))
    tp = tmod.expected_params(tprior, tst)
    jp = jmod.expected_params(jprior, jst)
    _fields_close(tp, jp)
    if name == "diag_gaussian":
        for t, j in zip(tmod.posterior(tprior, tst),
                        jmod.posterior(jprior, jst)):
            close(t, j)
    cluster = lambda p: type(p)(*(v[:, 0] for v in p))
    tcl = type(tp)(**{f: getattr(tp, f)[:, 0] for f in jp._fields})
    xt, xj = torch.as_tensor(x[:50]), jnp.asarray(x[:50])
    close(tmod.loglik(xt, tp), jmod.loglik(xj, jp))
    for t, j in zip(tmod.assign_pack(xt, tcl),
                    jmod.assign_pack(xj, cluster(jp))):
        close(t, j)
    for t, j in zip(tmod.sweep_pack(xt, tcl, tp),
                    jmod.sweep_pack(xj, cluster(jp), jp)):
        close(t, j)


def _jax_draws(name, key, jprior, jst):
    """The reference's sample_posterior and the draws it makes."""
    if name == "multinomial":
        g = jax.random.gamma(key, jprior.alpha0 + jst.counts)
        return jmult.sample_posterior(key, jprior, jst), dict(gammas=g)
    if name == "poisson":
        g = jax.random.gamma(key, jprior.a0 + jst.sx)
        return jpois.sample_posterior(key, jprior, jst), dict(gammas=g)
    _, _, a_n, b_n = jdiag.posterior(jprior, jst)
    k_t, k_m = jax.random.split(key)
    g = jax.random.gamma(k_t, jnp.broadcast_to(a_n[..., None], b_n.shape))
    z = jax.random.normal(k_m, b_n.shape)
    return jdiag.sample_posterior(key, jprior, jst), dict(gammas=g, z=z)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sample_posterior_with_jax_draws(name):
    _, jmod, tmod, jprior, tprior, jst, _ = _setup(name)
    tst = type(tmod.empty_stats((1,), 1, "cpu"))(
        **{f: torch.tensor(np.asarray(v)) for f, v in jst._asdict().items()})
    jp, draws = _jax_draws(name, jax.random.key(3), jprior, jst)
    tp = tmod.sample_posterior(tprior, tst, **{
        k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
    _fields_close(tp, jp)
    # from a generator: seeded, finite, and the Gamma clamp holds
    a = tmod.sample_posterior(tprior, tst, torch.Generator().manual_seed(4))
    b = tmod.sample_posterior(tprior, tst, torch.Generator().manual_seed(4))
    for f in jp._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert torch.isfinite(getattr(a, f)).all()


def _jax_model_state(name, rng):
    """A reference ModelState of family ``name`` with random leaves."""
    d = 3
    f32 = lambda *s: jnp.asarray(rng.normal(size=s).astype(np.float32))
    if name == "gaussian":
        par = lambda *b: jniw.GaussParams(f32(*b, d), f32(*b, d, d), f32(*b))
        st = lambda *b: jniw.GaussStats(f32(*b), f32(*b, d), f32(*b, d, d))
    elif name == "multinomial":
        par = lambda *b: jmult.MultParams(f32(*b, d))
        st = lambda *b: jmult.MultStats(f32(*b), f32(*b, d))
    elif name == "poisson":
        par = lambda *b: jpois.PoisParams(f32(*b, d))
        st = lambda *b: jpois.PoisStats(f32(*b), f32(*b, d))
    else:
        par = lambda *b: jdiag.DiagParams(f32(*b, d), f32(*b, d))
        st = lambda *b: jdiag.DiagStats(f32(*b), f32(*b, d), f32(*b, d))
    return JModelState(
        key=jax.random.key(11), it=jnp.int32(4),
        active=jnp.asarray(rng.random(K) < 0.5), logweights=f32(K),
        sub_logweights=f32(K, 2),
        stuck=jnp.asarray(rng.integers(0, 9, K).astype(np.int32)),
        params=par(K), subparams=par(K, 2), stats=st(K), substats=st(K, 2))


@pytest.mark.parametrize("name", ["gaussian", *sorted(FAMILIES)])
def test_model_state_from_numpy_round_trip(name):
    jm = _jax_model_state(name, np.random.default_rng(len(name)))
    as_np = jax.tree.map(np.asarray,
                         jm._replace(key=jax.random.key_data(jm.key)))
    m = state.model_state_from_numpy(as_np, "cpu", get_family(name))
    assert m.it == 4 and m.stuck.dtype == torch.int32
    np.testing.assert_array_equal(m.key.numpy(), as_np.key)
    for part in ("params", "subparams", "stats", "substats"):
        jtree, ttree = getattr(as_np, part), getattr(m, part)
        assert type(ttree) is (get_family(name).params_cls if "params" in
                               part else get_family(name).stats_cls)
        for field, v in jtree._asdict().items():
            np.testing.assert_array_equal(getattr(ttree, field).numpy(), v)
    back = state.model_state_to_numpy(m)
    again = state.model_state_from_numpy(back, "cpu", get_family(name))
    for part in ("params", "substats"):
        for field in getattr(as_np, part)._fields:
            assert torch.equal(getattr(getattr(again, part), field),
                               getattr(getattr(m, part), field))
