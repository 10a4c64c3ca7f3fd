"""The port's conjugate NIW math and weight draws against the JAX
package, with JAX's random draws injected into the port.

Tolerances: rtol/atol 1e-4 for closed-form posterior quantities and
log marginals (float32 algebra in two libraries), 5e-4 for the sampled
parameters, which pass through a Cholesky factor, a triangular solve and
a dense solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits
from jax.scipy.special import multigammaln as j_multigammaln

from repro.core import gibbs as jgibbs
from repro.core import niw as jniw
from repro_torch.configs import DPMMConfig
from repro_torch.core import gibbs, niw


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, torch's and numpy's BLAS's: the suite runs
    several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1, user_api="blas"):
        yield
    torch.set_num_threads(old)


def _stats(d: int, batch, seed: int):
    """Stats of real point sets, so Psi_n is well conditioned."""
    rng = np.random.default_rng(seed)
    n = rng.integers(0, 60, size=batch).astype(np.float32)
    n.reshape(-1)[0] = 0.0                    # an empty cluster
    sx = np.zeros(batch + (d,), np.float32)
    sxx = np.zeros(batch + (d, d), np.float32)
    for idx in np.ndindex(*batch):
        pts = rng.normal(size=(int(n[idx]), d)) * 2 + rng.normal(size=d) * 5
        sx[idx] = pts.sum(0)
        sxx[idx] = pts.T @ pts
    return n, sx, sxx


def _both(d, batch, seed):
    cfg = DPMMConfig()
    xm = np.random.default_rng(seed).normal(size=(1, d)).astype(np.float32)
    jprior = jniw.build_prior(cfg, jnp.asarray(xm))
    tprior = niw.build_prior(cfg, torch.as_tensor(xm))
    n, sx, sxx = _stats(d, batch, seed)
    js = jniw.GaussStats(jnp.asarray(n), jnp.asarray(sx), jnp.asarray(sxx))
    ts = niw.GaussStats(torch.as_tensor(n), torch.as_tensor(sx),
                        torch.as_tensor(sxx))
    return jprior, tprior, js, ts


@jax.jit
def _jax_closed_form(prior, stats):
    return (jniw.posterior(prior, stats), jniw.log_marginal(prior, stats),
            jniw.expected_params(prior, stats))


@jax.jit
def _jax_sample(key, prior, stats):
    """jniw.sample_posterior and the draws it makes, reproduced."""
    d = prior.m.shape[-1]
    batch = stats.n.shape
    k_a, k_b, k_mu = jax.random.split(key, 3)
    _, _, _, nu_n = jniw.posterior(prior, stats)
    df = jnp.maximum(nu_n[..., None] - jnp.arange(d, dtype=jnp.float32),
                     1e-3)
    chi = 2.0 * jax.random.gamma(k_a, 0.5 * df)
    normals = jax.random.normal(k_b, batch + (d, d))
    z = jax.random.normal(k_mu, batch + (d,))
    return jniw.sample_posterior(key, prior, stats), (chi, normals, z)


def close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("d,batch", [(2, (6,)), (5, (4, 2)), (8, (3,))])
def test_posterior_log_marginal_expected_params(d, batch):
    jprior, tprior, js, ts = _both(d, batch, seed=d)
    jpost, jlm, je = _jax_closed_form(jprior, js)
    for t, j in zip(niw.posterior(tprior, ts), jpost):
        close(t, j)
    close(niw.log_marginal(tprior, ts), jlm)
    te = niw.expected_params(tprior, ts)
    close(te.mu, je.mu)
    close(te.chol_prec, je.chol_prec)
    close(te.logdet_prec, je.logdet_prec)


@pytest.mark.parametrize("d,batch", [(2, (6,)), (4, (3, 2))])
def test_sample_posterior_with_jax_draws(d, batch):
    jprior, tprior, js, ts = _both(d, batch, seed=10 + d)
    jp, (chi, normals, z) = _jax_sample(jax.random.key(d), jprior, js)
    t = lambda v: torch.tensor(np.asarray(v))
    tp = niw.sample_posterior(tprior, ts, chi=t(chi), normals=t(normals),
                              z=t(z))
    close(tp.chol_prec, jp.chol_prec, 5e-4)
    close(tp.logdet_prec, jp.logdet_prec, 5e-4)
    close(tp.mu, jp.mu, 5e-4)


def test_sample_posterior_draws_from_the_generator():
    _, tprior, _, ts = _both(3, (5,), seed=1)
    a = niw.sample_posterior(tprior, ts, torch.Generator().manual_seed(4))
    b = niw.sample_posterior(tprior, ts, torch.Generator().manual_seed(4))
    c = niw.sample_posterior(tprior, ts, torch.Generator().manual_seed(5))
    assert torch.equal(a.chol_prec, b.chol_prec) and torch.equal(a.mu, b.mu)
    assert not torch.equal(a.mu, c.mu)
    assert torch.isfinite(a.chol_prec).all() and a.mu.shape == (5, 3)


@pytest.mark.parametrize("d", [1, 3, 32])
def test_multigammaln_matches_jax(d):
    a = np.linspace(0.5 * d + 0.1, 0.5 * d + 400, 50).astype(np.float32)
    close(niw.multigammaln(torch.as_tensor(a), d),
          j_multigammaln(jnp.asarray(a), d), 1e-5)


@pytest.mark.parametrize("alpha", [0.5, 10.0])
def test_sample_weights_with_jax_gammas(alpha):
    rng = np.random.default_rng(2)
    k = 9
    active = rng.random(k) < 0.6
    active[0] = True
    nk = rng.integers(0, 500, k).astype(np.float32)
    @jax.jit
    def ref(key, active, nk):
        conc = jnp.where(active, jnp.maximum(nk, 1e-2), 1.0)
        g = jax.random.gamma(key, jnp.concatenate(
            [conc, jnp.array([alpha], jnp.float32)]))
        return jgibbs.sample_weights(key, active, nk, alpha), g

    jw, g = ref(jax.random.key(3), jnp.asarray(active), jnp.asarray(nk))
    tw = gibbs.sample_weights(None, torch.as_tensor(active),
                              torch.as_tensor(nk), alpha,
                              gammas=torch.tensor(np.asarray(g)))
    close(tw, jw, 1e-5)
    assert (tw.numpy()[~active] == -1e30).all()


def test_sample_subweights_with_jax_gammas():
    rng = np.random.default_rng(4)
    k, alpha = 7, 10.0
    active = rng.random(k) < 0.5
    nkl = rng.integers(0, 90, k).astype(np.float32)
    nkr = rng.integers(0, 90, k).astype(np.float32)
    @jax.jit
    def ref(key, active, nkl, nkr):
        g = jax.random.gamma(key, jnp.stack(
            [nkl + alpha / 2.0, nkr + alpha / 2.0], axis=-1))
        return jgibbs.sample_subweights(key, active, nkl, nkr, alpha), g

    jw, g = ref(jax.random.key(5), jnp.asarray(active), jnp.asarray(nkl),
                jnp.asarray(nkr))
    tw = gibbs.sample_subweights(None, torch.as_tensor(active),
                                 torch.as_tensor(nkl), torch.as_tensor(nkr),
                                 alpha, gammas=torch.tensor(np.asarray(g)))
    close(tw, jw, 1e-5)


def test_weight_draws_from_the_generator_are_normalized():
    active = torch.tensor([True, True, False, True])
    nk = torch.tensor([10.0, 300.0, 0.0, 5.0])
    lw = gibbs.sample_weights(torch.Generator().manual_seed(0), active, nk,
                              10.0)
    assert float(torch.exp(lw[active]).sum()) < 1.0       # alpha slot mass
    sw = gibbs.sample_subweights(torch.Generator().manual_seed(0), active,
                                 nk, nk + 1, 10.0)
    np.testing.assert_allclose(torch.exp(sw).sum(-1).numpy(), 1.0,
                               rtol=1e-5)
