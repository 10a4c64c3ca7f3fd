"""The port's CUDA kernels (sweep_gauss, suffstats_labels, sweep_linear,
moments_labels, loglik_gauss, assign_gauss, assign_linear, matmul,
sub_assign_gauss, sub_assign_linear) against their plain versions, and the
three-pass sweep against the one-read sweep, on the card.

Marked ``cuda``; each test skips (from a fixture, at run time) where no
CUDA device is available. Run on a GPU machine with
``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.

Rules: labels equal except mismatches proven to be near-ties (the two
logits within 1e-4, relative; at most 0.1 % of the points), stats partials within rtol 1e-4 of each array's scale (long
float32 sums in another order), counts exact; a repeat launch on the same
inputs gives identical bits (no float atomics); log-likelihoods and
products within rtol 1e-5 of each array's scale (fp32 sums in another
order). The three-pass sweep runs the one-read sweep's device code for
steps (e), (f) and the fold, so on the card the two give the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import DPMMConfig
from repro_torch.core import gibbs
from repro_torch.core.sampler import DPMM
from repro_torch.core.state import PointState
from repro_torch.data.synthetic import generate_gmm, generate_mnmm
from repro_torch.core.family import get_family
from repro_torch.core.multinomial import MultParams
from repro_torch.core.niw import GaussParams
from repro_torch.kernels import assign, loglik, matmul, ops, suffstats, sweep


pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _args(n, d, k, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) * 3
    a = (x, torch.randn(k, d, generator=g) * 3,
         torch.randn(k, d, d, generator=g) * 0.2 + torch.eye(d),
         torch.randn(k, generator=g),
         torch.log_softmax(torch.randn(k, generator=g), 0),
         (torch.arange(k) % 3 != 2).to(torch.int32),
         torch.randn(k, 2, d, generator=g) * 3,
         torch.randn(k, 2, d, d, generator=g) * 0.2 + torch.eye(d),
         torch.randn(k, 2, generator=g),
         torch.log_softmax(torch.randn(k, 2, generator=g), 1),
         (torch.rand(n, generator=g) < 0.98).float(),
         torch.arange(n, dtype=torch.int64) + 77,
         torch.tensor([5, 4000000000]), torch.tensor([1, 2]),
         torch.randperm(3 * k, generator=g)[:k].to(torch.int32))
    return tuple(v.to(dev).contiguous() for v in a)


def _close(got, want):
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert bool(((g - w).abs() <= 1e-4 * (w.abs() + w.abs().max()))
                    .all())


@pytest.mark.parametrize("n,d,k", [(2500, 2, 8), (5000, 8, 16),
                                   (3000, 20, 5), (2100, 64, 3),
                                   (2100, 65, 3), (1500, 96, 4),
                                   (1200, 128, 5)])
def test_sweep_gauss_kernel_matches_plain(dev, n, d, k):
    a = _args(n, d, k, dev, seed=d)
    before = sweep.sweep_gauss_cuda.launches
    got = ops.sweep_gauss(*a)
    again = ops.sweep_gauss(*a)
    assert sweep.sweep_gauss_cuda.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = sweep.sweep_gauss_plain(*a)
    mism, not_ties = sweep.label_mismatches(a, got[0], got[1], want[0],
                                            want[1], rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    _close(got[2:], suffstats.suffstats_labels_plain(a[0], got[0], got[1],
                                                     a[10], k))


@pytest.mark.parametrize("n,d,k", [(2500, 2, 8), (4096, 32, 64),
                                   (2100, 65, 5), (2500, 96, 8),
                                   (2048, 128, 16), (2100, 129, 5),
                                   (1500, 200, 4), (2048, 256, 8)])
def test_suffstats_labels_kernel_matches_plain(dev, n, d, k):
    g = torch.Generator().manual_seed(n)
    x = (torch.randn(n, d, generator=g) * 4).to(dev)
    lab = torch.randint(-1, k + 1, (n,), generator=g).to(dev, torch.int32)
    sub = torch.randint(0, 2, (n,), generator=g).to(dev, torch.int32)
    valid = (torch.rand(n, generator=g) < 0.9).float().to(dev)
    got = ops.suffstats_labels(x, lab, sub, valid, k)
    again = ops.suffstats_labels(x, lab, sub, valid, k)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _close(got, suffstats.suffstats_labels_plain(x, lab, sub, valid, k))


def _linear_args(n, dp, k, dev, seed=0):
    """sweep_linear operands: count features, log-probability weights."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.poisson(torch.full((n, dp), 3.0), generator=g)
    logp = lambda *s: torch.log_softmax(torch.randn(*s, generator=g) * 2, -1)
    a = (feats, logp(k, dp), torch.randn(k, generator=g),
         torch.log_softmax(torch.randn(k, generator=g), 0),
         (torch.arange(k) % 3 != 2).to(torch.int32), logp(k, 2, dp),
         torch.randn(k, 2, generator=g),
         torch.log_softmax(torch.randn(k, 2, generator=g), 1),
         (torch.rand(n, generator=g) < 0.98).float(),
         torch.arange(n, dtype=torch.int64) + 77,
         torch.tensor([5, 4000000000]), torch.tensor([1, 2]),
         torch.randperm(3 * k, generator=g)[:k].to(torch.int32))
    return tuple(v.to(dev).contiguous() for v in a)


@pytest.mark.parametrize("n,dp,k", [(2500, 8, 8), (5000, 128, 32),
                                    (3000, 33, 70), (2100, 20_000, 5)])
def test_sweep_linear_kernel_matches_plain(dev, n, dp, k):
    a = _linear_args(n, dp, k, dev, seed=dp)
    before = sweep.sweep_linear_cuda.launches
    got = ops.sweep_linear(*a)
    again = ops.sweep_linear(*a)
    assert sweep.sweep_linear_cuda.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = sweep.sweep_linear_plain(*a)
    mism, not_ties = sweep.label_mismatches_linear(
        a, got[0], got[1], want[0], want[1], rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    _close(got[2:], suffstats.moments_labels_plain(a[0], got[0], got[1],
                                                   a[8], k))


@pytest.mark.parametrize("n,dp,k", [(2500, 8, 8), (4096, 300, 64),
                                    (3000, 20_000, 3)])
def test_moments_labels_kernel_matches_plain(dev, n, dp, k):
    g = torch.Generator().manual_seed(n)
    feats = torch.poisson(torch.full((n, dp), 2.0), generator=g).to(dev)
    lab = torch.randint(-1, k + 1, (n,), generator=g).to(dev, torch.int32)
    sub = torch.randint(0, 2, (n,), generator=g).to(dev, torch.int32)
    valid = (torch.rand(n, generator=g) < 0.9).float().to(dev)
    got = ops.moments_labels(feats, lab, sub, valid, k)
    again = ops.moments_labels(feats, lab, sub, valid, k)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _close(got, suffstats.moments_labels_plain(feats, lab, sub, valid, k))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    a = list(_args(2048, 4, 4, dev))
    bad = list(a)
    bad[0] = a[0].double()
    with pytest.raises(TypeError):
        sweep.sweep_gauss_cuda(*bad)
    bad = list(a)
    bad[0] = torch.randn(2048, 129, device=dev)
    with pytest.raises(ValueError, match="d=129"):
        sweep.sweep_gauss_cuda(*bad)
    # the other Gaussian kernels stop at 256, with the ROADMAP hint
    wide = torch.randn(2048, 257, device=dev)
    with pytest.raises(ValueError, match=r"d=257 .*ROADMAP.md §3"):
        suffstats.suffstats_labels_cuda(wide, a[5][:1].repeat(2048),
                                        a[5][:1].repeat(2048), a[10], 4)
    zeros = lambda *s: torch.zeros(s, device=dev)
    with pytest.raises(ValueError, match=r"d=257 .*ROADMAP.md §3"):
        loglik.loglik_cuda(wide, zeros(4, 257), zeros(4, 257, 257),
                           zeros(4))
    with pytest.raises(ValueError, match=r"d=257 .*ROADMAP.md §3"):
        assign.assign_gauss_cuda(wide, zeros(4, 257), zeros(4, 257, 257),
                                 *a[3:6], a[11], a[12], a[14])
    with pytest.raises(ValueError, match=r"d=257 .*ROADMAP.md §3"):
        assign.sub_assign_gauss_cuda(wide, zeros(4, 2, 257),
                                     zeros(4, 2, 257, 257), a[8], a[9],
                                     a[5][:1].repeat(2048), a[11], a[13])
    with pytest.raises(ValueError, match="contiguous"):
        suffstats.suffstats_labels_cuda(
            a[0].t().contiguous().t(), a[5][:1].repeat(2048),
            a[5][:1].repeat(2048), a[10], 4)


def test_fit_on_the_card_runs_through_both_kernels(dev):
    x, y = generate_gmm(20_000, 4, 4, seed=0)
    ops.reset_launch_counts()
    r = DPMM(DPMMConfig(iters=25, burnout=5)).fit(x)
    counts = ops.launch_counts()
    assert counts["sweep_gauss"] == 25 and counts["suffstats_labels"] > 0
    assert r.device.startswith("cuda") and r.peak_bytes > 0
    assert r.nmi(y) > 0.9


def test_linear_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    a = list(_linear_args(1024, 4, 4, dev))
    wide = torch.zeros(4, suffstats.MAX_DP + 1, device=dev)
    with pytest.raises(ValueError, match="d'=65537"):
        suffstats.moments_labels_cuda(wide, a[4], a[4], a[8][:4], 2)
    bad = list(a)
    bad[1] = a[1].double()
    with pytest.raises(TypeError):
        sweep.sweep_linear_cuda(*bad)
    with pytest.raises(ValueError, match="K=2049"):
        sweep.sweep_linear_cuda(a[0], *(torch.zeros((2049,) + t.shape[1:],
                                                    device=dev, dtype=t.dtype)
                                        for t in a[1:8]), *a[8:12],
                                torch.zeros(2049, device=dev,
                                            dtype=torch.int32))


def test_multinomial_fit_on_the_card_runs_through_both_kernels(dev):
    x, y = generate_mnmm(20_000, 32, 4, seed=0)
    ops.reset_launch_counts()
    r = DPMM(DPMMConfig(component="multinomial", iters=25,
                        burnout=5)).fit(x)
    counts = ops.launch_counts()
    assert counts["sweep_linear"] == 25 and counts["moments_labels"] > 0
    assert counts["sweep_gauss"] == counts["suffstats_labels"] == 0
    assert r.nmi(y) > 0.9


def _assign_args(n, d, k, dev, seed=0):
    """assign_gauss operands: the sweep's step-(e) operands."""
    a = _args(n, d, k, dev, seed)
    return a[:6] + (a[11], a[12], a[14])


@pytest.mark.parametrize("n,d,k", [(3000, 2, 8), (5000, 32, 16),
                                   (2100, 64, 3), (1700, 65, 4),
                                   (1500, 96, 5), (1300, 128, 9),
                                   (1100, 129, 5), (700, 200, 6),
                                   (600, 256, 7)])
def test_assign_gauss_kernel_matches_plain(dev, n, d, k):
    a = _assign_args(n, d, k, dev, seed=d)
    before = assign.assign_gauss_cuda.launches
    got = ops.assign_gauss(*a)
    assert torch.equal(got, ops.assign_gauss(*a))
    assert assign.assign_gauss_cuda.launches == before + 2
    mism, not_ties = assign.assign_mismatches(
        True, a, got, assign.assign_gauss_plain(*a), rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    # the sweep's step (e) is the same device code: the same labels
    if d <= sweep.MAX_D:
        assert torch.equal(got, sweep.sweep_gauss_cuda(*_args(n, d, k, dev,
                                                              seed=d))[0])


@pytest.mark.parametrize("n,dp,k", [(2500, 8, 8), (5000, 128, 32),
                                    (3000, 33, 70), (700, 20_000, 5)])
def test_assign_linear_kernel_matches_plain(dev, n, dp, k):
    la = _linear_args(n, dp, k, dev, seed=dp)
    a = la[:5] + la[9:11] + (la[12],)
    got = ops.assign_linear(*a)
    assert torch.equal(got, ops.assign_linear(*a))
    mism, not_ties = assign.assign_mismatches(
        False, a, got, assign.assign_linear_plain(*a), rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    assert torch.equal(got, sweep.sweep_linear_cuda(*la)[0])


def _rel_close(got, want, rtol=1e-5):
    assert got.shape == want.shape
    assert bool(((got - want).abs()
                 <= rtol * (want.abs() + want.abs().max())).all())


@pytest.mark.parametrize("n,d,k", [(1000, 3, 7), (8192, 32, 16),
                                   (700, 64, 33), (513, 65, 4),
                                   (900, 96, 6), (1000, 128, 16),
                                   (700, 129, 5), (500, 200, 3),
                                   (600, 256, 6)])
def test_loglik_gauss_kernel_matches_plain(dev, n, d, k):
    x, mu, f, ld = _args(n, d, k, dev, seed=d)[:4]
    got = ops.loglik_gauss(x, mu, f, ld)
    assert torch.equal(got, ops.loglik_gauss(x, mu, f, ld))
    _rel_close(got, loglik.loglik_plain(x, mu, f, ld))
    # a row's bits do not depend on the batch it came in
    assert torch.equal(ops.loglik_gauss(x[5:300].contiguous(), mu, f, ld),
                       got[5:300])


@pytest.mark.parametrize("m,k,n", [(8192, 32, 32), (300, 33, 17),
                                   (1, 1, 1), (4097, 128, 65)])
def test_matmul_kernel_matches_plain(dev, m, k, n):
    g = torch.Generator().manual_seed(m + n)
    a = torch.randn(m, k, generator=g).to(dev)
    b = torch.randn(k, n, generator=g).to(dev)
    got = ops.matmul(a, b)
    assert torch.equal(got, ops.matmul(a, b))
    _rel_close(got, matmul.matmul_plain(a, b))
    assert torch.equal(ops.matmul(a[:m // 2 + 1].contiguous(), b),
                       got[:m // 2 + 1])


def test_family_assign_and_loglik_launch_the_kernels(dev):
    a = _args(2048, 6, 8, dev)
    p = GaussParams(a[1], a[2], a[3])
    ops.reset_launch_counts()
    gauss = get_family("gaussian")
    gauss.assign(a[0], p, a[4], a[5], a[11], a[12], a[14])
    gauss.loglik(a[0], p)
    diag = get_family("diag_gaussian")
    zeros = torch.zeros(2048, dtype=torch.int32, device=dev)
    stats = diag.stats_from_labels(a[0], a[10], zeros, zeros, 8)
    dp = diag.expected_params(diag.build_prior(DPMMConfig(), a[0][:1]),
                              diag.stats_cls(*(t.sum(1) for t in (
                                  stats.n, stats.sx, stats.sxx))))
    diag.loglik(a[0], dp)
    diag.assign(a[0], dp, a[4], a[5], a[11], a[12], a[14])
    counts = ops.launch_counts()
    assert counts["assign_gauss"] == counts["loglik_gauss"] == 1
    assert counts["matmul"] == 2 and counts["assign_linear"] == 1
    get_family("multinomial").loglik(a[0].abs(), get_family(
        "multinomial").params_cls(dp.mu))
    assert ops.launch_counts()["matmul"] == 3
    lab = torch.zeros(2048, dtype=torch.int32, device=dev)
    gauss.sub_assign(a[0], GaussParams(a[6], a[7], a[8]), a[9], lab, a[11],
                     a[13])
    mult = get_family("multinomial")
    mult.sub_assign(a[0].abs(), MultParams(a[6].abs()), a[9], lab, a[11],
                    a[13])
    counts = ops.launch_counts()
    assert counts["sub_assign_gauss"] == counts["sub_assign_linear"] == 1


@pytest.mark.parametrize("n,d,k", [(3000, 4, 8), (5000, 32, 16),
                                   (1300, 128, 9), (1100, 129, 5),
                                   (900, 200, 6), (700, 256, 7)])
def test_sub_assign_gauss_kernel_matches_plain(dev, n, d, k):
    a = _args(n, d, k, dev, seed=d)
    if d <= sweep.MAX_D:
        sw = sweep.sweep_gauss_cuda(*a)
        labels = sw[0]
    else:
        g = torch.Generator().manual_seed(d)
        labels = torch.randint(0, k, (n,), generator=g).to(dev, torch.int32)
    args = (a[0], a[6], a[7], a[8], a[9], labels, a[11], a[13])
    before = assign.sub_assign_gauss_cuda.launches
    got = ops.sub_assign_gauss(*args)
    assert torch.equal(got, ops.sub_assign_gauss(*args))
    assert assign.sub_assign_gauss_cuda.launches == before + 2
    mism, not_ties = assign.sub_assign_mismatches(
        True, args, got, assign.sub_assign_gauss_plain(*args), rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    assert 0 < int(got.sum()) < n
    # the sweep's step (f) is the same device code: the same sub-labels
    if d <= sweep.MAX_D:
        assert torch.equal(got, sw[1])


@pytest.mark.parametrize("n,dp,k", [(2500, 8, 8), (5000, 128, 32),
                                    (700, 20_000, 5)])
def test_sub_assign_linear_kernel_matches_plain(dev, n, dp, k):
    la = _linear_args(n, dp, k, dev, seed=dp)
    sw = sweep.sweep_linear_cuda(*la)
    args = (la[0], la[5], la[6], la[7], sw[0], la[9], la[11])
    before = assign.sub_assign_linear_cuda.launches
    got = ops.sub_assign_linear(*args)
    assert torch.equal(got, ops.sub_assign_linear(*args))
    assert assign.sub_assign_linear_cuda.launches == before + 2
    mism, not_ties = assign.sub_assign_mismatches(
        False, args, got, assign.sub_assign_linear_plain(*args), rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    # the sweep's step (f) is the same device code: the same sub-labels
    assert torch.equal(got, sw[1])


@pytest.mark.parametrize("component,gen,d", [
    ("gaussian", generate_gmm, 6), ("multinomial", generate_mnmm, 24)])
def test_three_pass_sweep_tile_is_the_one_read_tile_on_the_card(
        dev, component, gen, d):
    x_np, _ = gen(12_000, d, 4, seed=3)
    r = DPMM(DPMMConfig(component=component, iters=12, burnout=4)).fit(x_np)
    model, fam = r.state, get_family(component)
    x = torch.as_tensor(x_np, device=dev)
    n = x.shape[0]
    point = PointState(
        labels=torch.as_tensor(r.labels, device=dev),
        sublabels=torch.zeros(n, dtype=torch.int32, device=dev),
        valid=torch.ones(n, device=dev))
    key_z = torch.tensor([123, 4000000001], device=dev)
    key_zb = torch.tensor([77, 5], device=dev)
    gidx = gibbs.global_indices(n, dev)
    k_max = model.active.shape[0]
    for plan in (None, gibbs.compaction_plan(model.active, 8)):
        k_eff = k_max if plan is None else 8

        def tile(fused):
            return gibbs.sweep_tile(
                model, x, point, gidx,
                gibbs.empty_substats(fam, k_eff, d, dev), fam, key_z,
                key_zb, plan=plan, fused=fused)

        ops.reset_launch_counts()
        three, acc3 = tile(False)
        counts = ops.launch_counts()
        one, acc1 = tile(True)
        assert torch.equal(three.labels, one.labels)
        assert torch.equal(three.sublabels, one.sublabels)
        assert all(torch.equal(getattr(acc3, f), getattr(acc1, f))
                   for f in vars(acc1))
        step_e, step_f, fold, fused = (
            ("assign_gauss", "sub_assign_gauss", "suffstats_labels",
             "sweep_gauss") if component == "gaussian" else
            ("assign_linear", "sub_assign_linear", "moments_labels",
             "sweep_linear"))
        assert counts[step_e] == counts[step_f] == counts[fold] == 1
        assert counts[fused] == 0


def test_gaussian_fit_past_d128_runs_the_three_pass_kernels(dev):
    # 10,000 points a cluster: at d = 160 the NIW evidence favours
    # splitting every pair of true clusters, which it does not at 4,000 a
    # cluster (tools/split_evidence.py)
    x, y = generate_gmm(40_000, 160, 4, seed=0)
    ops.reset_launch_counts()
    r = DPMM(DPMMConfig(iters=30, burnout=5)).fit(x)
    counts = ops.launch_counts()
    assert counts["sweep_gauss"] == 0
    assert counts["assign_gauss"] == counts["sub_assign_gauss"] == 30
    assert counts["suffstats_labels"] > 30
    assert r.nmi(y) > 0.9, (r.nmi(y), r.history["k"])
