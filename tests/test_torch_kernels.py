"""The plain versions of the port's two kernels against the JAX kernels.

``repro.kernels.sweep.sweep_gauss`` and ``repro.kernels.suffstats.
suffstats_labels`` run in Pallas interpret mode, as the JAX package's own
tests run them on the CPU; the port's ``sweep_gauss_plain`` and
``suffstats_labels_plain`` get the same numpy inputs. Rules:

- labels and sub-labels equal, except mismatches that are near-ties (the
  two logits involved within 1e-4) and at most 0.1 % of the points;
- given equal labels, n exact and sx / sxx within rtol 1e-5, atol 1e-4
  (the same float32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import suffstats as jsuff
from repro.kernels import sweep as jsweep
from repro_torch.core.family import GAUSSIAN
from repro_torch.core.niw import GaussParams
from repro_torch.kernels import ops, prng
from repro_torch.kernels import suffstats as tsuff
from repro_torch.kernels import sweep as tsweep

N = 2500            # ragged across STATS_BLOCK boundaries (1024, 2048)
K = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.normal(size=(N, d)) * 3).astype(f32)
    mu = (rng.normal(size=(K, d)) * 3).astype(f32)
    chol = (np.tril(rng.normal(size=(K, d, d)) * 0.3)
            + np.eye(d)).astype(f32)
    logdet = rng.normal(size=(K,)).astype(f32)
    logw = np.log(rng.dirichlet(np.ones(K))).astype(f32)
    active = (rng.random(K) < 0.7).astype(np.int32)
    active[0] = 1
    sub_mu = (rng.normal(size=(K, 2, d)) * 3).astype(f32)
    sub_chol = (np.tril(rng.normal(size=(K, 2, d, d)) * 0.3)
                + np.eye(d)).astype(f32)
    sub_logdet = rng.normal(size=(K, 2)).astype(f32)
    sublogw = np.log(rng.dirichlet(np.ones(2), size=K)).astype(f32)
    valid = np.ones(N, f32)
    valid[-37:] = 0.0
    gidx = (np.arange(N) + 5000).astype(np.uint32)
    key_z = np.array([17, 0xDEADBEEF], np.uint32)
    key_zb = np.array([0xFFFFFFFF, 3], np.uint32)
    # a compaction map: the slab's rows are dense slots of a 3K slab
    slots = np.sort(rng.choice(3 * K, K, replace=False)).astype(np.uint32)
    return dict(x=x, mu=mu, chol=chol, logdet=logdet, logw=logw,
                active=active, sub_mu=sub_mu, sub_chol=sub_chol,
                sub_logdet=sub_logdet, sublogw=sublogw, valid=valid,
                gidx=gidx, key_z=key_z, key_zb=key_zb, slots=slots)


def _jax_sweep(a):
    out = jsweep.sweep_gauss(
        *(jnp.asarray(a[k]) for k in (
            "x", "mu", "chol", "logdet", "logw", "active", "sub_mu",
            "sub_chol", "sub_logdet", "sublogw", "valid", "gidx", "key_z",
            "key_zb", "slots")), interpret=True)
    return [np.asarray(o) for o in out]


def _torch_args(a):
    t = lambda v, dt=torch.float32: torch.as_tensor(v).to(dt)
    i64 = torch.int64
    return (t(a["x"]), t(a["mu"]), t(a["chol"]), t(a["logdet"]),
            t(a["logw"]), t(a["active"], torch.int32), t(a["sub_mu"]),
            t(a["sub_chol"]), t(a["sub_logdet"]), t(a["sublogw"]),
            t(a["valid"]), t(a["gidx"].astype(np.int64), i64),
            t(a["key_z"].astype(np.int64), i64),
            t(a["key_zb"].astype(np.int64), i64),
            t(a["slots"].astype(np.int32), torch.int32))


def _logits(a, rows, cands, sub: bool):
    """float64 logits of candidates ``cands`` (m, 2) for points ``rows``:
    step (e) over clusters, or step (f) over the own cluster's two
    sub-clusters (``cands`` then holds the own cluster twice)."""
    x = a["x"][rows].astype(np.float64)
    if sub:
        mu, f = a["sub_mu"][cands[:, 0]], a["sub_chol"][cands[:, 0]]
        ld, lw = a["sub_logdet"][cands[:, 0]], a["sublogw"][cands[:, 0]]
        key, cid = a["key_zb"], np.array([[0, 1]])
    else:
        mu, f = a["mu"][cands], a["chol"][cands]
        ld, lw = a["logdet"][cands], a["logw"][cands]
        key, cid = a["key_z"], a["slots"][cands]
    y = np.einsum("msd,msde->mse", x[:, None, :] - mu, f)
    t = 0.5 * (ld - (y * y).sum(-1)) + lw
    if not sub:
        t = np.where(a["active"][cands] != 0, t, -1e30)
    g = prng.gumbel(torch.as_tensor(key.astype(np.int64)),
                    torch.as_tensor(a["gidx"][rows].astype(np.int64))[:, None],
                    torch.as_tensor(np.broadcast_to(cid, cands.shape)
                                    .astype(np.int64)))
    return t + g.double().numpy()


def assert_labels_match(a, lab_t, sub_t, lab_j, sub_j):
    """Equal, except counted near-ties (<= 0.1 % of the points)."""
    bad = np.nonzero((lab_t != lab_j) | (sub_t != sub_j))[0]
    assert bad.size <= 0.001 * lab_t.size, bad.size
    for i in bad:
        if lab_t[i] != lab_j[i]:
            t = _logits(a, [i], np.array([[lab_t[i], lab_j[i]]]), False)
        else:
            t = _logits(a, [i], np.array([[lab_j[i], lab_j[i]]]), True)
        assert abs(t[0, 0] - t[0, 1]) < 1e-4, (i, t)
    return bad.size


def assert_stats_close(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [2, 8])
def test_sweep_gauss_plain_matches_jax_kernel(d):
    a = _inputs(d, seed=d)
    lab_j, sub_j, n_j, sx_j, sxx_j = _jax_sweep(a)
    lab_t, sub_t, n_t, sx_t, sxx_t = tsweep.sweep_gauss_plain(*_torch_args(a))
    assert lab_t.dtype == torch.int32 and n_t.shape == n_j.shape == (3, K, 2)
    assert sxx_t.shape == sxx_j.shape == (3, K, 2, d, d)
    assert_labels_match(a, lab_t.numpy(), sub_t.numpy(), lab_j, sub_j)
    # inactive slots never win
    assert a["active"][lab_t.numpy()].all()
    # stats of JAX's labelling through the port's fold: the port's stat
    # arithmetic without label noise
    args = _torch_args(a)
    want = (n_j, sx_j, sxx_j)
    from_j = tsuff.suffstats_labels_plain(
        args[0], torch.tensor(lab_j), torch.tensor(sub_j), args[10], K)
    assert_stats_close([v.numpy() for v in from_j], want)
    if np.array_equal(lab_t.numpy(), lab_j) and np.array_equal(
            sub_t.numpy(), sub_j):
        assert_stats_close([n_t.numpy(), sx_t.numpy(), sxx_t.numpy()], want)


@pytest.mark.parametrize("d", [2, 8])
def test_suffstats_labels_plain_matches_jax_kernel(d):
    rng = np.random.default_rng(10 + d)
    x = (rng.normal(size=(N, d)) * 4).astype(np.float32)
    lab = rng.integers(0, K, N).astype(np.int32)
    sub = rng.integers(0, 2, N).astype(np.int32)
    valid = (rng.random(N) < 0.95).astype(np.float32)
    nj, sxj, sxxj = (np.asarray(v) for v in jsuff.suffstats_labels(
        jnp.asarray(x), jnp.asarray(lab), jnp.asarray(sub),
        jnp.asarray(valid), K, interpret=True))
    parts = tsuff.suffstats_labels_plain(
        torch.as_tensor(x), torch.as_tensor(lab), torch.as_tensor(sub),
        torch.as_tensor(valid), K)
    assert [tuple(p.shape) for p in parts] == [
        (3, K, 2), (3, K, 2, d), (3, K, 2, d, d)]
    assert_stats_close([p.sum(0).numpy() for p in parts], (nj, sxj, sxxj))


def test_suffstats_labels_plain_partials_are_per_stats_block():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(N, 3)).astype(np.float32))
    lab = torch.as_tensor(rng.integers(0, 4, N).astype(np.int32))
    sub = torch.as_tensor(rng.integers(0, 2, N).astype(np.int32))
    valid = torch.ones(N)
    n2, sx2, _ = tsuff.suffstats_labels_plain(x, lab, sub, valid, 4)
    for b, (lo, hi) in enumerate([(0, 1024), (1024, 2048), (2048, N)]):
        one, _, _ = tsuff.suffstats_labels_plain(
            x[lo:hi], lab[lo:hi], sub[lo:hi], valid[lo:hi], 4)
        assert torch.equal(one[0], n2[b])
    assert float(n2.sum()) == N
    # labels outside [0, k) and sub-labels outside {0, 1} add nothing
    lab2 = lab.clone()
    lab2[:10] = 7
    sub2 = sub.clone()
    sub2[10:20] = 2
    n2b, _, _ = tsuff.suffstats_labels_plain(x, lab2, sub2, valid, 4)
    assert float(n2b.sum()) == N - 20


def test_ops_route_cpu_tensors_to_the_plain_versions():
    a = _torch_args(_inputs(2))
    ops.reset_launch_counts()
    lab, sub, n2, sx2, sxx2 = ops.sweep_gauss(*a)
    ref = tsweep.sweep_gauss_plain(*a)
    assert all(torch.equal(u, v) for u, v in
               zip((lab, sub, n2, sx2, sxx2), ref))
    parts = ops.suffstats_labels(a[0], lab, sub, a[10], K)
    assert torch.equal(parts[2], sxx2)
    assert ops.launch_counts() == {
        "sweep_gauss": 0, "suffstats_labels": 0, "sweep_linear": 0,
        "moments_labels": 0, "loglik_gauss": 0, "assign_gauss": 0,
        "assign_linear": 0, "matmul": 0, "sub_assign_gauss": 0,
        "sub_assign_linear": 0}


def test_ops_refuse_other_devices_and_cuda_wrappers_refuse_cpu():
    a = _torch_args(_inputs(2))
    meta = tuple(v.to("meta") for v in a)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.sweep_gauss(*meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsweep.sweep_gauss_cuda(*a)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsuff.suffstats_labels_cuda(a[0], a[5][:1].expand(N).contiguous(),
                                    a[5][:1].expand(N).contiguous(), a[10],
                                    K)


def test_family_assign_and_sub_assign_are_the_sweep_steps():
    x, mu, f, ld, lw, act, smu, sf, sld, slw, valid, gidx, kz, kzb, slots = (
        _torch_args(_inputs(8, seed=4)))
    lab, sub, *_ = tsweep.sweep_gauss_plain(
        x, mu, f, ld, lw, act, smu, sf, sld, slw, valid, gidx, kz, kzb, slots)
    assert torch.equal(GAUSSIAN.assign(x, GaussParams(mu, f, ld), lw, act,
                                       gidx, kz, slots), lab)
    assert torch.equal(GAUSSIAN.sub_assign(x, GaussParams(smu, sf, sld), slw,
                                           lab, gidx, kzb), sub)


def test_label_mismatches_proves_near_ties_as_the_float64_logits_do():
    a = _inputs(8, seed=5)
    args = _torch_args(a)
    lab, sub, *_ = tsweep.sweep_gauss_plain(*args)
    assert tsweep.label_mismatches(args, lab, sub, lab, sub, 1e-4) == (0, 0)
    live = np.nonzero(a["active"])[0]
    other = int(live[live != int(lab[0])][0])
    lab2, sub2 = lab.clone(), sub.clone()
    lab2[0] = other                    # a label mismatch at point 0
    sub2[1] = 1 - sub2[1]              # a sub-label mismatch at point 1
    t_e = _logits(a, [0], np.array([[other, int(lab[0])]]), False)[0]
    own = int(lab[1])
    t_f = _logits(a, [1], np.array([[own, own]]), True)[0]
    gaps = [abs(t[0] - t[1]) / max(1.0, abs(t).max()) for t in (t_e, t_f)]
    assert tsweep.label_mismatches(args, lab2, sub2, lab, sub,
                                   min(gaps) / 2) == (2, 2)
    assert tsweep.label_mismatches(args, lab2, sub2, lab, sub,
                                   max(gaps) * 2) == (2, 0)
