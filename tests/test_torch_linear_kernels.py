"""The plain versions of the linear families' two kernels against the JAX
kernels.

``repro.kernels.sweep.sweep_linear`` and ``repro.kernels.suffstats.
moments_labels`` run in Pallas interpret mode, as the JAX package's own
tests run them on the CPU; the port's ``sweep_linear_plain`` and
``moments_labels_plain`` get the same numpy inputs: 2 * STATS_BLOCK + 37
points of count features, a compact slab of 12 rows whose slots are dense
ids of a 36-slot slab, some of them inactive. Rules:

- labels and sub-labels equal, except mismatches that are near-ties (the
  two logits involved, re-scored in float64, within 1e-4 of the larger)
  and at most 0.1 % of the points;
- given equal labels, n exact and the first moments within rtol 1e-5,
  atol 1e-3 (float32 sums of up to 1,024 counts in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from repro.kernels import suffstats as jsuff
from repro.kernels import sweep as jsweep
from repro_torch.core import multinomial
from repro_torch.core.family import MULTINOMIAL
from repro_torch.core.multinomial import MultParams
from repro_torch.kernels import ops
from repro_torch.kernels import suffstats as tsuff
from repro_torch.kernels import sweep as tsweep

N = 2 * 1024 + 37
K = 12
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


def _inputs(dp: int, seed: int = 0):
    """Sweep operands in the reference's argument order, as numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    feats = rng.poisson(3.0, size=(N, dp)).astype(f32)
    w = np.log(rng.dirichlet(np.full(dp, 0.5), size=K) + 1e-30).astype(f32)
    const = rng.normal(size=K).astype(f32)
    logw = np.log(rng.dirichlet(np.ones(K))).astype(f32)
    active = (rng.random(K) < 0.7).astype(np.int32)
    active[0] = 1
    subw = np.log(rng.dirichlet(np.full(dp, 0.5), size=(K, 2))
                  + 1e-30).astype(f32)
    subconst = rng.normal(size=(K, 2)).astype(f32)
    sublogw = np.log(rng.dirichlet(np.ones(2), size=K)).astype(f32)
    valid = np.ones(N, f32)
    valid[-37:] = 0.0
    gidx = (np.arange(N) + 5000).astype(np.uint32)
    key_z = np.array([17, 0xDEADBEEF], np.uint32)
    key_zb = np.array([0xFFFFFFFF, 3], np.uint32)
    slots = np.sort(rng.choice(3 * K, K, replace=False)).astype(np.uint32)
    return (feats, w, const, logw, active, subw, subconst, sublogw, valid,
            gidx, key_z, key_zb, slots)


def _torch_args(a):
    (feats, w, const, logw, active, subw, subconst, sublogw, valid, gidx,
     key_z, key_zb, slots) = a
    t = torch.as_tensor
    i64 = lambda v: torch.as_tensor(v.astype(np.int64))
    return (t(feats), t(w), t(const), t(logw), t(active), t(subw),
            t(subconst), t(sublogw), t(valid), i64(gidx), i64(key_z),
            i64(key_zb), torch.as_tensor(slots.astype(np.int32)))


def _assert_moments_close(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dp", [8, 40])
def test_sweep_linear_plain_matches_jax_kernel(dp):
    a = _inputs(dp, seed=dp)
    lab_j, sub_j, n_j, sf_j = (np.array(o) for o in jsweep.sweep_linear(
        *(jnp.asarray(v) for v in a), interpret=True))
    args = _torch_args(a)
    lab_t, sub_t, n_t, sf_t = tsweep.sweep_linear_plain(*args)
    assert lab_t.dtype == torch.int32 and n_t.shape == n_j.shape == (3, K, 2)
    assert sf_t.shape == sf_j.shape == (3, K, 2, dp)
    bad, not_ties = tsweep.label_mismatches_linear(
        args, lab_t, sub_t, torch.as_tensor(lab_j), torch.as_tensor(sub_j),
        TIE_RTOL)
    assert not_ties == 0 and bad <= 0.001 * N, (bad, not_ties)
    assert a[4][lab_t.numpy()].all()           # inactive slots never win
    # JAX's labelling through the port's fold: the stat arithmetic alone
    from_j = tsuff.moments_labels_plain(args[0], torch.as_tensor(lab_j),
                                        torch.as_tensor(sub_j), args[8], K)
    _assert_moments_close([v.numpy() for v in from_j], (n_j, sf_j))
    if bad == 0:
        _assert_moments_close([n_t.numpy(), sf_t.numpy()], (n_j, sf_j))


@pytest.mark.parametrize("dp", [8, 40])
def test_moments_labels_plain_matches_jax_kernel(dp):
    rng = np.random.default_rng(20 + dp)
    feats = rng.poisson(4.0, size=(N, dp)).astype(np.float32)
    lab = rng.integers(-1, K + 1, N).astype(np.int32)   # some out of range
    sub = rng.integers(0, 2, N).astype(np.int32)
    valid = (rng.random(N) < 0.95).astype(np.float32)
    want = [np.array(v) for v in jsuff.moments_labels(
        jnp.asarray(feats), jnp.asarray(lab), jnp.asarray(sub),
        jnp.asarray(valid), K, interpret=True)]
    n2, sf2 = tsuff.moments_labels_plain(
        torch.as_tensor(feats), torch.as_tensor(lab), torch.as_tensor(sub),
        torch.as_tensor(valid), K)
    assert n2.shape == (3, K, 2) and sf2.shape == (3, K, 2, dp)
    _assert_moments_close([n2.sum(0).numpy(), sf2.sum(0).numpy()], want)
    # partials are per STATS_BLOCK of points
    for b, (lo, hi) in enumerate([(0, 1024), (1024, 2048), (2048, N)]):
        one, _ = tsuff.moments_labels_plain(
            torch.as_tensor(feats[lo:hi]), torch.as_tensor(lab[lo:hi]),
            torch.as_tensor(sub[lo:hi]), torch.as_tensor(valid[lo:hi]), K)
        assert torch.equal(one[0], n2[b])


def test_ops_route_linear_cpu_tensors_to_the_plain_versions():
    args = _torch_args(_inputs(8, seed=3))
    ops.reset_launch_counts()
    out = ops.sweep_linear(*args)
    assert all(torch.equal(u, v) for u, v in
               zip(out, tsweep.sweep_linear_plain(*args)))
    mom = ops.moments_labels(args[0], out[0], out[1], args[8], K)
    assert all(torch.equal(u, v) for u, v in zip(mom, out[2:]))
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsweep.sweep_linear_cuda(*args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsuff.moments_labels_cuda(args[0], out[0], out[1], args[8], K)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.moments_labels(args[0].to("meta"), out[0], out[1], args[8], K)


def test_linear_family_assign_and_sub_assign_are_the_sweep_steps():
    feats, w, _, logw, act, subw, _, sublogw, valid, gidx, kz, kzb, slots = (
        _torch_args(_inputs(40, seed=4)))
    zero, zero2 = torch.zeros(K), torch.zeros(K, 2)
    lab, sub, *_ = tsweep.sweep_linear_plain(
        feats, w, zero, logw, act, subw, zero2, sublogw, valid, gidx, kz,
        kzb, slots)
    p, sp = MultParams(w), MultParams(subw)
    assert torch.equal(tsweep.pick_cluster(
        multinomial.loglik(feats, p), logw, act, gidx, kz, slots), lab)
    assert torch.equal(tsweep.sub_assign_linear_plain(
        *multinomial.assign_pack(feats, sp), sublogw, lab, gidx, kzb), sub)
    assert torch.equal(MULTINOMIAL.assign(feats, p, logw, act, gidx, kz,
                                          slots), lab)
    assert torch.equal(tsweep.assign_linear_plain(
        *multinomial.assign_pack(feats, p), logw, act, gidx, kz, slots), lab)
    assert torch.equal(MULTINOMIAL.sub_assign(feats, sp, sublogw, lab, gidx,
                                              kzb), sub)


def test_label_mismatches_linear_proves_near_ties_in_float64():
    a = _inputs(8, seed=5)
    args = _torch_args(a)
    lab, sub, *_ = tsweep.sweep_linear_plain(*args)
    assert tsweep.label_mismatches_linear(args, lab, sub, lab, sub,
                                          TIE_RTOL) == (0, 0)
    live = np.nonzero(a[4])[0]
    other = int(live[live != int(lab[0])][0])
    lab2, sub2 = lab.clone(), sub.clone()
    lab2[0] = other                    # a label mismatch at point 0
    sub2[1] = 1 - sub2[1]              # a sub-label mismatch at point 1
    f64 = lambda v: np.asarray(v, np.float64)
    g = lambda key, c0, c1: tsweep.prng.gumbel(
        torch.as_tensor(key.astype(np.int64)), torch.tensor(int(c0)),
        torch.tensor(int(c1))).double().item()
    t_e = [f64(a[0][0]) @ f64(a[1][c]) + a[2][c] + a[3][c]
           + g(a[10], a[9][0], a[12][c]) for c in (other, int(lab[0]))]
    own = int(lab[1])
    t_f = [f64(a[0][1]) @ f64(a[5][own, s]) + a[6][own, s] + a[7][own, s]
           + g(a[11], a[9][1], s) for s in (0, 1)]
    gaps = [abs(t[0] - t[1]) / max(1.0, abs(t[0]), abs(t[1]))
            for t in (t_e, t_f)]
    assert tsweep.label_mismatches_linear(args, lab2, sub2, lab, sub,
                                          min(gaps) / 2) == (2, 2)
    assert tsweep.label_mismatches_linear(args, lab2, sub2, lab, sub,
                                          max(gaps) * 2) == (2, 0)
