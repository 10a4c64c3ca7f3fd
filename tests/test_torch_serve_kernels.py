"""The plain versions of the serving path's four kernels against the JAX
kernels, and the families' routes to them.

``repro.kernels.assign.assign_gauss`` / ``assign_linear``,
``repro.kernels.loglik.loglik`` and ``repro.kernels.matmul.matmul`` run in
Pallas interpret mode, as the JAX package's own tests run them on the CPU;
the port's ``assign_gauss_plain``, ``assign_linear_plain``,
``loglik_plain`` and ``matmul_plain`` get the same numpy inputs. Rules:
labels equal and the Threefry bits of the Gumbel noise exact (the
float32 logs of the two libraries may differ in the last bits);
log-likelihoods and products
within rtol 1e-5, atol 1e-4 (float32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import assign as jassign
from repro.kernels import loglik as jloglik
from repro.kernels import matmul as jmatmul
from repro.kernels import prng as jprng
from repro_torch.core import diag_gaussian, multinomial, poisson
from repro_torch.core.family import get_family
from repro_torch.core.niw import GaussParams
from repro_torch.kernels import assign, loglik, matmul, ops, prng

N = 1000            # ragged across the JAX kernels' 128-row blocks
K = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _gauss(d: int, seed: int, n: int = N, k: int = K):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    active = (rng.random(k) < 0.7).astype(np.int32)
    active[0] = 1
    return dict(
        x=(rng.normal(size=(n, d)) * 3).astype(f32),
        mu=(rng.normal(size=(k, d)) * 3).astype(f32),
        chol=(np.tril(rng.normal(size=(k, d, d)) * 0.3)
              + np.eye(d)).astype(f32),
        logdet=rng.normal(size=(k,)).astype(f32),
        logw=np.log(rng.dirichlet(np.ones(k))).astype(f32),
        active=active,
        # a ragged request's rows: counters offset + row, as a ladder step
        gidx=(np.arange(n) + 8192).astype(np.uint32),
        key=np.array([17, 0xDEADBEEF], np.uint32),
        slots=np.sort(rng.choice(3 * k, k, replace=False)).astype(np.uint32))


def _t(v, dtype=torch.float32):
    return torch.as_tensor(np.asarray(v)).to(dtype)


def _step_e_tail(a):
    """(logw, active, gidx, key, slots) as the port's wrappers take them."""
    return (_t(a["logw"]), _t(a["active"], torch.int32),
            _t(a["gidx"].astype(np.int64), torch.int64),
            _t(a["key"].astype(np.int64), torch.int64),
            _t(a["slots"].astype(np.int32), torch.int32))


def _jax_tail(a):
    return (jnp.asarray(a["logw"]), jnp.asarray(a["active"]),
            jnp.asarray(a["gidx"]), jnp.asarray(a["key"]),
            jnp.asarray(a["slots"]))


@pytest.mark.parametrize("d", [1, 5, 8])
def test_assign_gauss_plain_equals_the_jax_kernel(d):
    a = _gauss(d, seed=d)
    want = np.asarray(jassign.assign_gauss(
        *(jnp.asarray(a[k]) for k in ("x", "mu", "chol", "logdet")),
        *_jax_tail(a), interpret=True))
    got = assign.assign_gauss_plain(
        *(_t(a[k]) for k in ("x", "mu", "chol", "logdet")), *_step_e_tail(a))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and set(np.unique(want)) <= set(
        np.flatnonzero(a["active"]))


def _linear(dp: int, seed: int):
    rng = np.random.default_rng(seed)
    a = _gauss(2, seed)
    a["feats"] = rng.poisson(3.0, size=(N, dp)).astype(np.float32)
    a["w"] = np.log(rng.dirichlet(np.ones(dp), size=K)).astype(np.float32)
    a["const"] = rng.normal(size=(K,)).astype(np.float32)
    return a


@pytest.mark.parametrize("dp", [1, 3, 8])
def test_assign_linear_plain_equals_the_jax_kernel(dp):
    a = _linear(dp, seed=dp)
    want = np.asarray(jassign.assign_linear(
        *(jnp.asarray(a[k]) for k in ("feats", "w", "const")),
        *_jax_tail(a), interpret=True))
    got = assign.assign_linear_plain(
        *(_t(a[k]) for k in ("feats", "w", "const")), *_step_e_tail(a))
    np.testing.assert_array_equal(got.numpy(), want)


def test_serving_noise_bits_equal_jax():
    a = _gauss(2, seed=0)
    key = jnp.asarray(a["key"])
    c0 = jnp.asarray(a["gidx"])[:, None]
    c1 = jnp.asarray(a["slots"])[None, :]
    tkey = _t(a["key"].astype(np.int64), torch.int64)
    t0 = _t(a["gidx"].astype(np.int64), torch.int64)[:, None]
    t1 = _t(a["slots"].astype(np.int64), torch.int64)[None, :]
    bits = np.asarray(jprng.threefry2x32(key[0], key[1], c0, c1)[0])
    tbits = prng.threefry2x32(tkey[0], tkey[1], t0, t1)[0]
    np.testing.assert_array_equal(tbits.numpy(), bits.astype(np.int64))
    np.testing.assert_array_equal(prng.uniform01(tbits).numpy(),
                                  np.asarray(jprng.uniform01(bits)))
    np.testing.assert_allclose(prng.gumbel(tkey, t0, t1).numpy(),
                               np.asarray(jprng.gumbel(key, c0, c1)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,k", [(1, 3), (4, 9), (8, 16)])
def test_loglik_plain_matches_the_jax_kernel(d, k):
    a = _gauss(d, seed=10 + d)
    args = [a["x"], a["mu"][:k], a["chol"][:k], a["logdet"][:k]]
    want = np.asarray(jloglik.loglik(*(jnp.asarray(v) for v in args),
                                     interpret=True))
    got = loglik.loglik_plain(*(_t(v) for v in args)).numpy()
    assert got.shape == want.shape == (N, k)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [130, 300])
def test_wide_gauss_plain_versions_match_the_jax_functions(d):
    """Past the one-read sweep's d = 128 the card serves any d through the
    panel layout, held there against these plain versions; the reference
    takes any d too (its loglik through ``ref.loglik`` past its VMEM
    guard). 64 points, 3 slots."""
    a = _gauss(d, seed=20 + d, n=64, k=3)
    head = ("x", "mu", "chol", "logdet")
    want = np.asarray(jassign.assign_gauss(
        *(jnp.asarray(a[v]) for v in head), *_jax_tail(a), interpret=True))
    got = assign.assign_gauss_plain(*(_t(a[v]) for v in head),
                                    *_step_e_tail(a))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jloglik.loglik(*(jnp.asarray(a[v]) for v in head),
                                     interpret=True))
    got = loglik.loglik_plain(*(_t(a[v]) for v in head)).numpy()
    assert got.shape == want.shape == (64, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(2048, 8, 16), (300, 7, 13), (1, 1, 1)])
def test_matmul_plain_matches_the_jax_kernel(m, k, n):
    rng = np.random.default_rng(m)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(jmatmul.matmul(jnp.asarray(a), jnp.asarray(b),
                                     interpret=True))
    got = matmul.matmul_plain(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ops.matmul_auto(_t(a), _t(b)).numpy(),
                                  got)


def _recording(monkeypatch, name):
    calls = []
    real = getattr(ops, name)

    def wrapper(*args, **kw):
        calls.append(name)
        return real(*args, **kw)
    monkeypatch.setattr(ops, name, wrapper)
    return calls


@pytest.mark.parametrize("family", ["gaussian", "multinomial", "poisson",
                                    "diag_gaussian"])
def test_family_assign_and_loglik_route_through_ops(monkeypatch, family):
    a = _gauss(4, seed=3)
    x = torch.as_tensor(np.abs(np.round(a["x"])))
    tail = _step_e_tail(a)
    fam = get_family(family)
    rng = np.random.default_rng(5)
    if family == "gaussian":
        params = GaussParams(_t(a["mu"]), _t(a["chol"]), _t(a["logdet"]))
        plain_ll = loglik.loglik_plain(x, params.mu, params.chol_prec,
                                       params.logdet_prec)
        step_e = "assign_gauss"
    else:
        mod = {"multinomial": multinomial, "poisson": poisson,
               "diag_gaussian": diag_gaussian}[family]
        params = fam.params_cls(*(_t(rng.normal(size=(K, 4)) * 0.3)
                                  for _ in range(
                                      len(fam.params_cls.__dataclass_fields__))))
        feats, w, const = mod.assign_pack(x, params)
        plain_ll = feats @ w.T + const[None, :]
        step_e = "assign_linear"
    assign_calls = _recording(monkeypatch, step_e)
    ll_calls = _recording(monkeypatch, {"gaussian": "loglik_gauss",
                                        "diag_gaussian": "matmul_auto"}
                          .get(family, "matmul"))
    labels = fam.assign(x, params, *tail)
    ll = fam.loglik(x, params)
    assert assign_calls == [step_e]
    want = (assign.assign_gauss_plain(x, params.mu, params.chol_prec,
                                      params.logdet_prec, *tail)
            if family == "gaussian" else
            assign.assign_linear_plain(*mod.assign_pack(x, params), *tail))
    assert torch.equal(labels, want)
    np.testing.assert_allclose(ll.numpy(), plain_ll.numpy(), rtol=1e-5,
                               atol=1e-4)
    # gaussian through loglik_gauss, diag_gaussian's two products through
    # matmul_auto, the other two families' one product through matmul
    assert len(ll_calls) == {"diag_gaussian": 2}.get(family, 1)
