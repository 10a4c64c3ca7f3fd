"""The port's CUDA kernels (sweep_gauss, suffstats_labels, sweep_linear,
moments_labels, loglik_gauss, assign_gauss, assign_linear, matmul,
sub_assign_gauss, sub_assign_linear, fold_partials, suffstats) against
their plain versions, the three-pass sweep against the one-read sweep,
and a tiled fit against the resident fit, on the card.

Marked ``cuda``; each test skips (from a fixture, at run time) where no
CUDA device is available. Run on a GPU machine with
``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.

Rules: labels equal except mismatches proven to be near-ties (the two
logits within 1e-4, relative; at most 0.1 % of the points), stats partials within rtol 1e-4 of each array's scale (long
float32 sums in another order), counts exact; a repeat launch on the same
inputs gives identical bits (no float atomics); log-likelihoods and
products within rtol 1e-5 of each array's scale (fp32 sums in another
order). The three-pass sweep runs the one-read sweep's device code for
steps (e), (f) and the fold, so on the card the two give the same bits
(the linear families: one tile, ``csrc/linear_tile.cuh``, with a switch
for each step). A chain resumed from a saved state is the uninterrupted
chain bit for bit. Every fit names its card (``device=dev``): one shard
however many cards the machine holds. The mesh's twins: 2 logical shards
on one card hold the cross-mesh contract against 1 (labels and every
history but score equal) and repeat bitwise, tiled is resident on a
2-shard mesh, a (2 x 2) multinomial with ``shard_features`` repeats
bitwise, and on two cards a 2-shard chain is the one-card chain.
``fold_partials`` is bitwise its plain loop of adds (the same IEEE adds in
the same order); the dense ``suffstats`` kernel sums in another order than
its plain version (rtol 1e-4 of each array's scale, counts within it too:
the responsibilities are fractions). The LM zoo's dense-attention archs at
smoke size: the card's forward and decode logits are the CPU's within 1e-5
of the logits' scale (TF32 off), and greedy generation gives the CPU's ids.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import DPMMConfig
from repro_torch.core import checkpoint, gibbs
from repro_torch.core.sampler import DPMM
from repro_torch.core.state import PointState
from repro_torch.data.synthetic import (generate_gmm, generate_mnmm,
                                         generate_pmm)
from repro_torch.core.family import get_family
from repro_torch.core.multinomial import MultParams
from repro_torch.core.niw import GaussParams
from repro_torch.data.source import HostTiledSource
from repro_torch.kernels import (assign, fold, loglik, matmul, ops, suffstats,
                                 sweep)


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
    # two calls, each counting the kernels it launched
    assert sweep.sweep_gauss_cuda.launches == (
        before + 2 * sweep.launches_per_call(d))
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


def _edge(a, kind, seed):
    """Sweep operands ``a`` (``_args``) made an edge case of the fold:
    "empty" (every point invalid: every segment empty), "one_segment" (one
    live slot and a far second sub-cluster: the block is one segment) or
    "valid_zeros" (half the points invalid)."""
    a = list(a)
    n, k = a[0].shape[0], a[1].shape[0]
    g = torch.Generator().manual_seed(seed)
    if kind == "empty":
        a[10] = torch.zeros_like(a[10])
    elif kind == "valid_zeros":
        a[10] = (torch.rand(n, generator=g) < 0.5).float().to(a[10].device)
    elif kind == "one_segment":
        act = torch.zeros_like(a[5])
        act[k // 2] = 1
        a[5] = act
        a[6] = a[6].clone()
        a[6][:, 1] += 1e3
    return tuple(a)


def _sweep_check(a, n, k):
    got = ops.sweep_gauss(*a)
    again = ops.sweep_gauss(*a)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = sweep.sweep_gauss_plain(*a)
    mism, not_ties = sweep.label_mismatches(a, got[0], got[1], want[0],
                                            want[1], rtol=1e-4)
    assert not_ties == 0 and mism <= max(1, 1e-3 * n), (mism, not_ties)
    _close(got[2:], suffstats.suffstats_labels_plain(a[0], got[0], got[1],
                                                     a[10], k))
    return got


@pytest.mark.parametrize("kind", ["empty", "one_segment", "valid_zeros"])
@pytest.mark.parametrize("d", [1, 31, 33, 65, 128])
def test_sweep_gauss_kernel_edge_cases(dev, d, kind):
    """The fold's edge cases and both step-(e) routes (in the block at
    d <= 16, tiled above) against the plain version, and a repeat launch
    bitwise; one segment: every label the live slot, every sub-label 0."""
    n, k = 4097, 17
    got = _sweep_check(_edge(_args(n, d, k, dev, seed=d), kind, d), n, k)
    if kind == "one_segment":
        assert bool((got[0] == k // 2).all()) and bool((got[1] == 0).all())
    if kind == "empty":
        assert all(not bool(t.any()) for t in got[2:])


@pytest.mark.parametrize("n,k", [(1, 1), (1023, 300), (1025, 2),
                                 (4097, 64)])
@pytest.mark.parametrize("d", [3, 4, 32, 63, 100])
def test_sweep_gauss_kernel_grid(dev, n, d, k):
    _sweep_check(_args(n, d, k, dev, seed=n + d), n, k)


@pytest.mark.parametrize("kind", ["empty", "one_segment", "valid_zeros",
                                  "ragged"])
@pytest.mark.parametrize("d", [1, 33, 128, 129, 256])
def test_suffstats_labels_kernel_edge_cases(dev, d, kind):
    """Empty segments only, one segment holding every point, valid-mask
    zeros, and a ragged N with K = 300 (most segments empty), against the
    plain version and a repeat launch bitwise."""
    n, k = (1025, 300) if kind == "ragged" else (4097, 17)
    g = torch.Generator().manual_seed(d)
    x = (torch.randn(n, d, generator=g) * 3).to(dev)
    lab = torch.randint(-1, k + 1, (n,), generator=g).to(dev, torch.int32)
    sub = torch.randint(0, 2, (n,), generator=g).to(dev, torch.int32)
    valid = torch.ones(n, device=dev)
    if kind == "empty":
        valid.zero_()
    elif kind == "valid_zeros":
        valid = (torch.rand(n, generator=g) < 0.5).float().to(dev)
    elif kind == "one_segment":
        lab.fill_(k // 2)
        sub.fill_(1)
    got = ops.suffstats_labels(x, lab, sub, valid, k)
    again = ops.suffstats_labels(x, lab, sub, valid, k)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _close(got, suffstats.suffstats_labels_plain(x, lab, sub, valid, k))
    if kind == "empty":
        assert all(not bool(t.any()) for t in got)


@pytest.mark.parametrize("kind", ["one_label", "distinct", "mixed"])
@pytest.mark.parametrize("d", [1, 31, 33, 65, 128, 129, 200, 256])
def test_sub_assign_gauss_kernel_edge_cases(dev, d, kind):
    """Every label one, all distinct (K = N), and random with -1 and K mixed
    in (those get sub-label 0), at N in {1, 1023, 1025, 4097}, against the
    plain version on the labels inside [0, K) (near-ties only) and a repeat
    launch bitwise."""
    for n in (1, 1023, 1025, 4097):
        k = n if kind == "distinct" else 17
        g = torch.Generator(device=dev).manual_seed(d * 10_000 + n)
        x = torch.randn(n, d, device=dev, generator=g) * 3
        smu = torch.randn(k, 2, d, device=dev, generator=g) * 3
        sf = (torch.randn(k, 2, d, d, device=dev, generator=g) * 0.2
              + torch.eye(d, device=dev))
        sld = torch.randn(k, 2, device=dev, generator=g)
        slw = torch.log_softmax(torch.randn(k, 2, device=dev, generator=g),
                                1)
        if kind == "one_label":
            lab = torch.full((n,), k // 2, device=dev, dtype=torch.int32)
        elif kind == "distinct":
            lab = torch.randperm(n, device=dev, generator=g).to(torch.int32)
        else:
            lab = torch.randint(-1, k + 1, (n,), device=dev, generator=g,
                                dtype=torch.int32)
        gidx = torch.arange(n, device=dev) + 5
        kzb = torch.tensor([9, 3_000_000_019], device=dev)
        args = (x, smu, sf, sld, slw, lab, gidx, kzb)
        got = ops.sub_assign_gauss(*args)
        assert torch.equal(got, ops.sub_assign_gauss(*args))
        inside = (lab >= 0) & (lab < k)
        assert not bool(got[~inside].any())
        sel = torch.nonzero(inside).flatten()
        if sel.numel() == 0:
            continue
        part = (x[sel], smu, sf, sld, slw, lab[sel], gidx[sel], kzb)
        mism, not_ties = assign.sub_assign_mismatches(
            True, part, got[sel], assign.sub_assign_gauss_plain(*part),
            rtol=1e-4)
        assert not_ties == 0 and mism <= max(1, 1e-3 * n), (mism, not_ties)


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
    # steps (e) + (f), then the fold: two kernels a call
    assert sweep.sweep_linear_cuda.launches == (
        before + 2 * sweep.LINEAR_LAUNCHES)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    want = sweep.sweep_linear_plain(*a)
    mism, not_ties = sweep.label_mismatches_linear(
        a, got[0], got[1], want[0], want[1], rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    _close(got[2:], suffstats.moments_labels_plain(a[0], got[0], got[1],
                                                   a[8], k))


@pytest.mark.parametrize("kind", ["grid", "empty", "one_segment",
                                  "valid_zeros"])
@pytest.mark.parametrize("dp", [1, 3, 128, 129, 20_000])
def test_sweep_linear_kernel_edge_cases(dev, dp, kind):
    """Blocks all invalid, blocks of one segment (one live slot, the second
    sub-cluster far off) and half-invalid blocks, at (N, K) in (1, 1),
    (1025, 300) and (11,314, 2048), on the scalar (odd d') and 16-byte
    (d' % 4 == 0) paths: against the plain version (labels exact but
    near-ties, partials within rtol) and a repeat launch bitwise."""
    for n, k in ((1, 1), (1025, 300), (11_314, 2048)):
        a = list(_linear_args(n, dp, k, dev, seed=n + dp))
        if kind == "empty":
            a[8] = torch.zeros(n, device=dev)
        elif kind == "valid_zeros":
            a[8] = (torch.arange(n, device=dev) % 2).float()
        elif kind == "one_segment":
            a[4] = torch.zeros(k, device=dev, dtype=torch.int32)
            a[4][k // 2] = 1
            a[6] = a[6].clone()
            a[6][:, 1] -= 1e4
        got = ops.sweep_linear(*a)
        again = ops.sweep_linear(*a)
        assert all(torch.equal(u, v) for u, v in zip(got, again))
        want = sweep.sweep_linear_plain(*a)
        mism, not_ties = sweep.label_mismatches_linear(
            a, got[0], got[1], want[0], want[1], rtol=1e-4)
        assert not_ties == 0 and mism <= max(1, 1e-3 * n), (mism, not_ties)
        _close(got[2:], suffstats.moments_labels_plain(a[0], got[0], got[1],
                                                       a[8], k))
        if kind == "one_segment":
            # but points whose draw for an inactive slot is in the Threefry
            # top bin (+inf; about one in 11,314 x 2047 draws / 2^24)
            assert int((got[0] != k // 2).sum()) <= 3
        if kind == "empty":
            assert not any(bool(t.any()) for t in got[2:])
        del got, again, want


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
    # the stat, step-(f) and served kernels take d = 257 (and any d): the
    # Gram tiles, sub-factor panels and panel layout past d = 256
    wide = torch.randn(2048, 257, device=dev)
    stats = suffstats.suffstats_labels_cuda(wide, a[5][:1].repeat(2048),
                                            a[5][:1].repeat(2048), a[10], 4)
    assert stats[2].shape == (2, 4, 2, 257, 257)
    zeros = lambda *s: torch.zeros(s, device=dev)
    assert loglik.loglik_cuda(wide, zeros(4, 257), zeros(4, 257, 257),
                              zeros(4)).shape == (2048, 4)
    assert assign.assign_gauss_cuda(wide, zeros(4, 257), zeros(4, 257, 257),
                                    *a[3:6], a[11], a[12], a[14]
                                    ).shape == (2048,)
    assert assign.sub_assign_gauss_cuda(
        wide, zeros(4, 2, 257), zeros(4, 2, 257, 257), a[8], a[9],
        a[5][:1].repeat(2048), a[11], a[13]).shape == (2048,)
    with pytest.raises(ValueError, match="d=0"):
        suffstats.suffstats_labels_cuda(wide[:, :0], a[5][:1].repeat(2048),
                                        a[5][:1].repeat(2048), a[10], 4)
    with pytest.raises(ValueError, match="contiguous"):
        suffstats.suffstats_labels_cuda(
            a[0].t().contiguous().t(), a[5][:1].repeat(2048),
            a[5][:1].repeat(2048), a[10], 4)


def test_fit_on_the_card_runs_through_both_kernels(dev):
    x, y = generate_gmm(20_000, 4, 4, seed=0)
    ops.reset_launch_counts()
    r = DPMM(DPMMConfig(iters=25, burnout=5), device=dev).fit(x)
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
                        burnout=5), device=dev).fit(x)
    counts = ops.launch_counts()
    assert counts["sweep_linear"] == 25 * sweep.LINEAR_LAUNCHES
    assert counts["moments_labels"] > 0
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
                                   (600, 256, 7), (700, 160, 6),
                                   (600, 257, 5), (500, 300, 7),
                                   (400, 512, 4), (8192, 32, 32),
                                   (8192, 128, 32), (300, 17, 5),
                                   (2000, 33, 4097)])
def test_assign_gauss_kernel_matches_plain(dev, n, d, k):
    a = _assign_args(n, d, k, dev, seed=d)
    before = assign.assign_gauss_cuda.launches
    got = ops.assign_gauss(*a)
    assert torch.equal(got, ops.assign_gauss(*a))
    # a call launches the tile (or panel), then the groups' fold if any
    assert assign.assign_gauss_cuda.launches == (
        before + 2 * assign.assign_gauss_launches(n, d, k))
    mism, not_ties = assign.assign_mismatches(
        True, a, got, assign.assign_gauss_plain(*a), rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    # the sweep's step (e) is the same device code: the same labels
    if d <= sweep.MAX_D and k <= sweep.MAX_K:
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
                                   (600, 256, 6), (700, 160, 6),
                                   (600, 257, 5), (500, 300, 7),
                                   (400, 512, 4), (8192, 32, 32),
                                   (8192, 128, 32), (300, 17, 5),
                                   (2000, 33, 4097)])
def test_loglik_gauss_kernel_matches_plain(dev, n, d, k):
    x, mu, f, ld = _args(n, d, k, dev, seed=d)[:4]
    got = ops.loglik_gauss(x, mu, f, ld)
    assert torch.equal(got, ops.loglik_gauss(x, mu, f, ld))
    _rel_close(got, loglik.loglik_plain(x, mu, f, ld))
    # a row's bits do not depend on the batch it came in
    assert torch.equal(ops.loglik_gauss(x[5:300].contiguous(), mu, f, ld),
                       got[5:300])


def test_panel_rows_do_not_depend_on_the_request(dev):
    """d = 300 through the panel layout: a grid of slot groups (folded in
    slot order) at 8192 rows, 32-point tiles at a few hundred rows. Repeat
    launches give the same bits, and each row's label and log-likelihoods
    are those of the same row in any other request."""
    n, d, k = 8192, 300, 32
    a = _assign_args(n, d, k, dev, seed=3)
    assert assign.panel_plan(n, d, k).groups > 1
    assert assign.panel_plan(300, d, k).bm == 32
    got = assign.assign_gauss_cuda(*a)
    assert torch.equal(got, assign.assign_gauss_cuda(*a))
    mism, not_ties = assign.assign_mismatches(
        True, a, got, assign.assign_gauss_plain(*a), rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    ll = loglik.loglik_cuda(*a[:4])
    assert torch.equal(ll, loglik.loglik_cuda(*a[:4]))
    for lo, hi in ((0, 1), (5, 305), (1000, 3048), (100, 8192)):
        part = (a[0][lo:hi].contiguous(),) + a[1:6] + (
            a[6][lo:hi].contiguous(),) + a[7:]
        assert torch.equal(assign.assign_gauss_cuda(*part), got[lo:hi])
        assert torch.equal(loglik.loglik_cuda(*part[:4]), ll[lo:hi])


def _rows_of_requests(a, got, ll, spans):
    """Each span's request (rows lo:hi) gives the whole request's labels
    and log-likelihood rows there, bit for bit."""
    for lo, hi in spans:
        part = (a[0][lo:hi].contiguous(),) + a[1:6] + (
            a[6][lo:hi].contiguous(),) + a[7:]
        assert torch.equal(assign.assign_gauss_cuda(*part), got[lo:hi])
        if ll is not None:
            assert torch.equal(loglik.loglik_cuda(*part[:4]), ll[lo:hi])


@pytest.mark.parametrize("d", [17, 32, 128])
def test_tile_rows_do_not_depend_on_the_request(dev, d):
    """16 < d <= 128 through the register tile (csrc/te_tile.cuh): a grid
    of slot groups at 8192 rows (their rows folded by (max, least slot))
    and at a few hundred, one group at 40,000. Repeat launches give the
    same bits, labels agree with the plain version but for near-ties, and
    each row's label and log-likelihoods are those of the same row in any
    other request."""
    n, k = 8192, 32
    a = _assign_args(n, d, k, dev, seed=4)
    assert assign.gauss_plan(n, d, k).groups > 1
    assert assign.gauss_plan(300, d, k).groups > assign.gauss_plan(
        n, d, k).groups
    got = assign.assign_gauss_cuda(*a)
    assert torch.equal(got, assign.assign_gauss_cuda(*a))
    mism, not_ties = assign.assign_mismatches(
        True, a, got, assign.assign_gauss_plain(*a), rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    ll = loglik.loglik_cuda(*a[:4])
    assert torch.equal(ll, loglik.loglik_cuda(*a[:4]))
    _rows_of_requests(a, got, ll, ((0, 1), (5, 305), (1000, 3048),
                                   (100, 8192)))
    big = _assign_args(40_000, d, k, dev, seed=5)
    assert assign.gauss_plan(40_000, d, k).groups == 1
    _rows_of_requests(big, assign.assign_gauss_cuda(*big),
                      loglik.loglik_cuda(*big[:4]),
                      ((0, 300), (20_000, 28_192), (39_000, 40_000)))


@pytest.mark.parametrize("n,d", [(5000, 1), (8192, 8), (300, 16)])
def test_narrow_and_tile_routes_give_the_same_bits(dev, n, d):
    """At and below the switch (``assign.GAUSS_NARROW_D``) the tile can
    run too, at d padded to 32 (zero rows and columns add exact zeros):
    both routes give the same labels and log-likelihood rows, bit for
    bit, so the switch is a choice of speed alone."""
    a = _assign_args(n, d, 17, dev, seed=d)
    assert assign.gauss_plan(n, d, 17).dp == 0
    want = (assign.assign_gauss_cuda(*a), loglik.loglik_cuda(*a[:4]))
    keep = assign.GAUSS_NARROW_D
    assign.GAUSS_NARROW_D = 0
    assign.gauss_plan.cache_clear()
    try:
        assert assign.gauss_plan(n, d, 17).dp == 32
        got = (assign.assign_gauss_cuda(*a), loglik.loglik_cuda(*a[:4]))
    finally:
        assign.GAUSS_NARROW_D = keep
        assign.gauss_plan.cache_clear()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tile_lists_many_live_slots_in_chunks(dev):
    """K = 4097 slots, about 90 % live, at 40,000 rows: one group, whose
    block lists its live slots TE_LIST at a time (two chunks). Its labels
    are those of the same rows in small requests (many groups, one chunk
    each) and agree with the plain version on them."""
    n, d, k = 40_000, 32, 4097
    g = torch.Generator().manual_seed(9)
    a = list(_assign_args(n, d, k, dev, seed=9))
    a[5] = (torch.rand(k, generator=g) < 0.9).to(torch.int32).to(dev)
    a = tuple(a)
    assert int(a[5].sum()) > sweep.TE_LIST
    assert assign.gauss_plan(n, d, k).groups == 1
    got = assign.assign_gauss_cuda(*a)
    spans = ((0, 300), (20_000, 20_700), (39_000, 40_000))
    _rows_of_requests(a, got, None, spans)
    for lo, hi in spans:
        part = (a[0][lo:hi].contiguous(),) + a[1:6] + (
            a[6][lo:hi].contiguous(),) + a[7:]
        mism, not_ties = assign.assign_mismatches(
            True, part, got[lo:hi], assign.assign_gauss_plain(*part),
            rtol=1e-4)
        assert not_ties == 0 and mism <= 1e-3 * (hi - lo), (mism, not_ties)


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
    # sub_assign_gauss: the label histogram, the placement, the product
    assert counts["sub_assign_gauss"] == assign.SUB_LAUNCHES
    assert counts["sub_assign_linear"] == 1


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
    assert assign.sub_assign_gauss_cuda.launches == (
        before + 2 * assign.SUB_LAUNCHES)
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


@pytest.mark.parametrize("k", [1, 17, 2048, 2049, 4096, 10_000])
@pytest.mark.parametrize("dp", [1, 3, 24, 64, 65, 128, 129, 20_000])
def test_linear_steps_alone_are_the_sweeps_steps(dev, dp, k):
    """``assign_linear`` and ``sub_assign_linear`` run the one-read sweep's
    tile with one step switched off: against their plain versions (labels
    exact but near-ties, at most 1 % of the points: with up to 10,000
    slots and sums of 20,000 features the top two logits often lie within
    the rounding of the plain version's other order; step (f) under labels
    in [-1, K], 0 outside [0, K)), a repeat launch bitwise, one launch a
    call, and where the sweep takes K, the sweep's labels and sub-labels
    bit for bit."""
    n = 300 if dp == 20_000 else 3000
    la = _linear_args(n, dp, k, dev, seed=dp + k)
    e_args = la[:5] + la[9:11] + (la[12],)
    before = assign.assign_linear_cuda.launches
    lab = ops.assign_linear(*e_args)
    assert torch.equal(lab, ops.assign_linear(*e_args))
    assert assign.assign_linear_cuda.launches == before + 2
    mism, not_ties = assign.assign_mismatches(
        False, e_args, lab, assign.assign_linear_plain(*e_args), rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-2 * n, (mism, not_ties)
    outside = ((torch.arange(n, device=dev) * 2654435761) % (k + 2)
               - 1).to(torch.int32)
    f_args = (la[0], la[5], la[6], la[7], outside, la[9], la[11])
    before = assign.sub_assign_linear_cuda.launches
    sub = ops.sub_assign_linear(*f_args)
    assert torch.equal(sub, ops.sub_assign_linear(*f_args))
    assert assign.sub_assign_linear_cuda.launches == before + 2
    inside = (outside >= 0) & (outside < k)
    assert int(sub[~inside].sum()) == 0
    idx = torch.nonzero(inside).flatten()
    part = (la[0][idx].contiguous(), la[5], la[6], la[7],
            outside[idx].contiguous(), la[9][idx].contiguous(), la[11])
    mism, not_ties = assign.sub_assign_mismatches(
        False, part, sub[idx], assign.sub_assign_linear_plain(*part),
        rtol=1e-4)
    assert not_ties == 0 and mism <= 1e-2 * n, (mism, not_ties)
    if k <= sweep.MAX_K:
        sw = sweep.sweep_linear_cuda(*la)
        assert torch.equal(lab, sw[0])
        assert torch.equal(ops.sub_assign_linear(
            la[0], la[5], la[6], la[7], sw[0], la[9], la[11]), sw[1])


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("component,gen", [("gaussian", generate_gmm),
                                           ("multinomial", generate_mnmm)])
def test_resume_on_the_card_is_the_uninterrupted_chain(dev, tmp_path,
                                                       component, gen,
                                                       tiled):
    """5 iterations (not a multiple of ``log_every``), ``save_model``,
    ``load_model``, 7 more from ``init_state``: the 12-iteration chain bit
    for bit on the card."""
    x, _ = gen(20_000, 8, 4, seed=5)
    cfg = DPMMConfig(component=component, iters=12, burnout=4, log_every=4,
                     tile_size=4096 if tiled else None)
    whole = DPMM(cfg, device=dev).fit(x)
    first = DPMM(cfg, device=dev).fit(x, 5)
    path = checkpoint.save_model(str(tmp_path / "model.npz"), first.state,
                                 component)
    state, _ = checkpoint.load_model(path)
    rest = DPMM(cfg, device=dev).fit(x, 7, init_state=state)
    assert rest.mode == ("tiled" if tiled else "resident")
    assert rest.state.it == whole.state.it == 12
    np.testing.assert_array_equal(rest.labels, whole.labels)
    for key, h in whole.history.items():
        np.testing.assert_array_equal(
            np.concatenate([first.history[key], rest.history[key]]), h)
    for group in ("params", "subparams", "stats", "substats"):
        a, b = getattr(rest.state, group), getattr(whole.state, group)
        for f in a.__dataclass_fields__:
            assert torch.equal(getattr(a, f), getattr(b, f)), (group, f)
    for f in ("key", "active", "logweights", "sub_logweights", "stuck"):
        assert torch.equal(getattr(rest.state, f), getattr(whole.state, f))


@pytest.mark.parametrize("component,gen,d", [
    ("gaussian", generate_gmm, 6), ("gaussian", generate_gmm, 32),
    ("gaussian", generate_gmm, 65), ("gaussian", generate_gmm, 128),
    ("gaussian", generate_gmm, 200), ("multinomial", generate_mnmm, 24),
    ("multinomial", generate_mnmm, 129), ("poisson", generate_pmm, 129)])
def test_three_pass_sweep_tile_is_the_one_read_tile_on_the_card(
        dev, component, gen, d):
    """The three-pass tile (assign, sub_assign, the label fold) equals the
    one-read tile bit for bit; past the one-read sweep's d = 128 both run
    ``sweep_ref``, and the three-pass sub-labels are held against the
    plain step (f) on the tile's own labels instead (near-ties only)."""
    x_np, _ = gen(12_000, d, 4, seed=3)
    r = DPMM(DPMMConfig(component=component, iters=12, burnout=4),
             device=dev).fit(x_np)
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
        # assign_gauss: the tile, then the fold of its slot groups' rows
        # when the tile's N makes several (assign_gauss_launches)
        assert counts[step_e] == (
            assign.assign_gauss_launches(n, d, k_eff)
            if component == "gaussian" else 1)
        assert counts[fold] == 1
        assert counts[step_f] == (assign.SUB_LAUNCHES
                                  if component == "gaussian" else 1)
        assert counts[fused] == 0
        if plan is None and component == "gaussian" and d > sweep.MAX_D:
            sp = model.subparams
            args = (x, sp.mu, sp.chol_prec, sp.logdet_prec,
                    model.sub_logweights, three.labels, gidx, key_zb)
            mism, not_ties = assign.sub_assign_mismatches(
                True, args, three.sublabels,
                assign.sub_assign_gauss_plain(*args), rtol=1e-4)
            assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)


def test_gaussian_fit_past_d128_runs_the_three_pass_kernels(dev):
    # 10,000 points a cluster: at d = 160 the NIW evidence favours
    # splitting every pair of true clusters, which it does not at 4,000 a
    # cluster (tools/split_evidence.py)
    x, y = generate_gmm(40_000, 160, 4, seed=0)
    ops.reset_launch_counts()
    r = DPMM(DPMMConfig(iters=30, burnout=5), device=dev).fit(x)
    counts = ops.launch_counts()
    assert counts["sweep_gauss"] == 0
    assert counts["assign_gauss"] == 30
    assert counts["sub_assign_gauss"] == 30 * assign.SUB_LAUNCHES
    assert counts["suffstats_labels"] > 30
    assert r.nmi(y) > 0.9, (r.nmi(y), r.history["k"])


@pytest.mark.parametrize("nb,shape", [(977, (64,)), (977, (32, 2, 32)),
                                      (3, (5, 2, 7, 7)), (0, (4,)),
                                      (40, (70_001,)),
                                      # past FOLD_WIDE_M: 256-wide tiles
                                      (63, (2, 2, 512, 512)),
                                      (31, (1_048_579,))])
def test_fold_partials_kernel_is_the_loop_bitwise(dev, nb, shape):
    g = torch.Generator().manual_seed(nb)
    acc = (torch.randn(shape, generator=g) * 1e5).to(dev)
    parts = (torch.randn((nb,) + shape, generator=g) * 1e5).to(dev)
    got = fold.fold_partials_cuda(acc, parts)
    again = fold.fold_partials_cuda(acc, parts)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, fold.fold_partials_plain(acc, parts))
    with pytest.raises(ValueError, match="do not lead"):
        fold.fold_partials_cuda(acc, parts[..., :1].contiguous())


@pytest.mark.parametrize("n,k,d", [(1003, 5, 7), (20_000, 32, 32),
                                   (5000, 16, 16), (3000, 4, 128),
                                   (2000, 3, 256), (70, 300, 2)])
def test_dense_suffstats_kernel_matches_plain(dev, n, k, d):
    g = torch.Generator().manual_seed(d)
    x = (torch.randn(n, d, generator=g) * 3).to(dev)
    gam = torch._standard_gamma(torch.ones(n, k), generator=g)
    resp = (gam / gam.sum(dim=1, keepdim=True)).to(dev)
    resp[::7] = torch.nn.functional.one_hot(
        torch.randint(0, k, (resp[::7].shape[0],), generator=g), k
    ).float().to(dev)
    got = suffstats.suffstats_cuda(x, resp)
    again = suffstats.suffstats_cuda(x, resp)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = suffstats.suffstats_plain(x, resp)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert bool(((a - b).abs() <= 1e-4 * (b.abs() + b.abs().max()))
                    .all())
    with pytest.raises(ValueError, match="d=0"):
        suffstats.suffstats_cuda(torch.zeros(4, 0, device=dev),
                                 torch.zeros(4, 2, device=dev))


@pytest.mark.parametrize("k", [1, 5, 32, 300])
@pytest.mark.parametrize("d", [1, 3, 63, 64, 129, 256])
def test_dense_suffstats_kernel_tiles(dev, d, k):
    """Every tile of the dense kernel (column tiles of 16 to 128, several
    clusters a block or a cluster over 2 x 2 tiles, a last block of fewer
    clusters) on N = 677, not a multiple of the 32-point slab, over several
    chunks: repeat bitwise, within 1e-4 of the plain version, counts exact
    on one-hot rows; where d % 4 == 0, x one float off 16-byte alignment
    (the 4-byte copies) gives the 16-byte copies' bits."""
    n = 677
    g = torch.Generator().manual_seed(1000 * d + k)
    x = (torch.randn(n, d, generator=g) * 3).to(dev)
    hot = torch.nn.functional.one_hot(torch.randint(0, k, (n,), generator=g),
                                      k).float().to(dev)
    gam = torch._standard_gamma(torch.ones(n, k), generator=g)
    soft = (gam / gam.sum(dim=1, keepdim=True)).to(dev)
    for resp, one_hot in ((hot, True), (soft, False)):
        got = suffstats.suffstats_cuda(x, resp)
        again = suffstats.suffstats_cuda(x, resp)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = suffstats.suffstats_plain(x, resp)
        if one_hot:
            assert torch.equal(got[0], want[0])
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert bool(((a - b).abs() <= 1e-4 * (b.abs() + b.abs().max()))
                        .all())
        if d % 4 == 0:
            xu = torch.empty(n * d + 1, device=dev)[1:].view(n, d)
            xu.copy_(x)
            assert all(torch.equal(a, b) for a, b in
                       zip(suffstats.suffstats_cuda(xu, resp), got))


def test_dense_suffstats_kernel_counts_the_last_chunk_near_2_31(dev):
    """N = 2^31 - 1 points at d = K = 1: the chunks' ends pass 2^31 - 1
    (whole slabs), and the last chunk's points still count. x is 0 but for
    its first and last point, so sx and sxx are exact."""
    n = 2 ** 31 - 1
    p = suffstats.dense_plan(n, 1, 1)
    assert p.nc * p.chunk >= 2 ** 31
    x = torch.zeros((n, 1), device=dev)
    x[0], x[-1] = 1.0, 2.0
    resp = torch.ones((n, 1), device=dev)
    _, sx, sxx = suffstats.suffstats_cuda(x, resp)
    assert sx.item() == 3.0 and sxx.item() == 5.0
    del x, resp
    torch.cuda.empty_cache()


@pytest.mark.parametrize("m", [1, 255, 8192])
@pytest.mark.parametrize("kd", [1, 32, 128, 300])
@pytest.mark.parametrize("n", [1, 16, 17, 33, 64])
def test_matmul_kernel_tiles(dev, m, kd, n):
    """Every column tile of the product (BN = 16, 32, 64), one to many K
    slabs, a ragged last K slab and row block: repeat bitwise, within 1e-5
    of the plain version."""
    g = torch.Generator().manual_seed(7 * m + 3 * kd + n)
    a = torch.randn(m, kd, generator=g).to(dev)
    b = torch.randn(kd, n, generator=g).to(dev)
    got = matmul.matmul_cuda(a, b)
    assert torch.equal(got, matmul.matmul_cuda(a, b))
    _rel_close(got, matmul.matmul_plain(a, b))


@pytest.mark.parametrize("kd", [1, 32, 128, 300])
@pytest.mark.parametrize("n", [1, 16, 17, 33, 64])
def test_matmul_rows_do_not_depend_on_the_batch(dev, kd, n):
    """Rows 0-255 of an 8192-row product are a 256-row product's, bit for
    bit (the serving ladder's property), and A one float off 16-byte
    alignment (the 4-byte copies) gives the same bits."""
    g = torch.Generator().manual_seed(kd + 100 * n)
    a = torch.randn(8192, kd, generator=g).to(dev)
    b = torch.randn(kd, n, generator=g).to(dev)
    full = matmul.matmul_cuda(a, b)
    assert torch.equal(matmul.matmul_cuda(a[:256].contiguous(), b),
                       full[:256])
    au = torch.empty(8192 * kd + 1, device=dev)[1:].view(8192, kd)
    au.copy_(a)
    assert torch.equal(matmul.matmul_cuda(au, b), full)


@pytest.mark.parametrize("component,gen,d", [("gaussian", generate_gmm, 4),
                                             ("multinomial", generate_mnmm,
                                              32)])
def test_tiled_fit_on_the_card_is_the_resident_fit(dev, component, gen, d):
    x, y = gen(20_000, d, 4, seed=0)
    cfg = dict(component=component, iters=25, burnout=5)
    res = DPMM(DPMMConfig(**cfg), device=dev).fit(x)
    ops.reset_launch_counts()
    tiled = DPMM(DPMMConfig(tile_size=4096, **cfg), device=dev).fit(
        HostTiledSource(x))
    assert ops.launch_counts()["fold_partials"] > 0
    assert tiled.mode == "tiled" and tiled.copy_wait_s >= 0.0
    np.testing.assert_array_equal(tiled.labels, res.labels)
    for key in res.history:
        np.testing.assert_array_equal(tiled.history[key], res.history[key])
    for name in res.state.stats.__dataclass_fields__:
        assert torch.equal(getattr(tiled.state.stats, name),
                           getattr(res.state.stats, name))
    assert tiled.nmi(y) > 0.9


def _stat_operands(n, d, k, dev, seed):
    """Points, labels in [-1, k] (outside [0, k) they add nothing or get
    sub-label 0), sub-labels, a valid mask with zeros, and sub-components
    whose factors whiten (``sub_assign_gauss``'s operands)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) * 3
    lab = torch.randint(-1, k + 1, (n,), generator=g, dtype=torch.int32)
    sub = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    valid = (torch.rand(n, generator=g) < 0.9).float()
    smu = x[torch.randint(0, n, (k, 2), generator=g)] + 0.5 * torch.randn(
        k, 2, d, generator=g)
    sf = (torch.randn(k, 2, d, d, generator=g) * (0.2 / d ** 0.5)
          + torch.eye(d))
    sld = torch.randn(k, 2, generator=g)
    slw = torch.log_softmax(torch.randn(k, 2, generator=g), 1)
    gidx = torch.arange(n, dtype=torch.int64) + 9
    kzb = torch.tensor([77, 3_000_000_001])
    return tuple(t.to(dev).contiguous() for t in (
        x, lab, sub, valid, smu, sf, sld, slw, gidx, kzb))


def _check_stat_kernels(dev, n, d, k, seed):
    """suffstats_labels, moments_labels, sub_assign_gauss and the dense
    oracle on (n, d, k) against their plain versions: one launch (three
    for sub_assign_gauss) a slot window, repeat bitwise, stats within
    rtol 1e-4 and counts exact, sub-labels equal but for near-ties inside
    [0, k) and 0 outside."""
    x, lab, sub, valid, smu, sf, sld, slw, gidx, kzb = _stat_operands(
        n, d, k, dev, seed)
    wins = len(suffstats.slot_windows(k))
    before = ops.launch_counts()
    got = suffstats.suffstats_labels_cuda(x, lab, sub, valid, k)
    again = suffstats.suffstats_labels_cuda(x, lab, sub, valid, k)
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _close(got, suffstats.suffstats_labels_plain(x, lab, sub, valid, k))
    del got, again
    mom = suffstats.moments_labels_cuda(x, lab, sub, valid, k)
    assert all(torch.equal(u, v) for u, v in zip(
        mom, suffstats.moments_labels_cuda(x, lab, sub, valid, k)))
    _close(mom, suffstats.moments_labels_plain(x, lab, sub, valid, k))
    del mom
    f_args = (x, smu, sf, sld, slw, lab, gidx, kzb)
    zb = assign.sub_assign_gauss_cuda(*f_args)
    assert torch.equal(zb, assign.sub_assign_gauss_cuda(*f_args))
    inside = (lab >= 0) & (lab < k)
    assert int(zb[~inside].abs().sum()) == 0
    idx = torch.nonzero(inside).flatten()
    in_args = (x[idx].contiguous(), smu, sf, sld, slw,
               lab[idx].contiguous(), gidx[idx].contiguous(), kzb)
    mism, not_ties = assign.sub_assign_mismatches(
        True, in_args, zb[idx], assign.sub_assign_gauss_plain(*in_args),
        1e-4)
    assert not_ties == 0 and mism <= 1e-3 * n, (mism, not_ties)
    resp = torch.nn.functional.one_hot(lab.long().clamp(0, k - 1),
                                       k).float() * inside[:, None].float()
    dense = suffstats.suffstats_cuda(x, resp)
    assert all(torch.equal(u, v) for u, v in zip(
        dense, suffstats.suffstats_cuda(x, resp)))
    want = suffstats.suffstats_plain(x, resp)
    assert torch.equal(dense[0], want[0])
    for u, v in zip(dense[1:], want[1:]):
        _rel_close(u, v, 1e-4)
    after = ops.launch_counts()
    assert after["suffstats_labels"] - before["suffstats_labels"] == 2 * wins
    assert after["moments_labels"] - before["moments_labels"] == 2 * wins
    assert (after["sub_assign_gauss"] - before["sub_assign_gauss"]
            == 2 * wins * assign.SUB_LAUNCHES)
    assert after["suffstats"] - before["suffstats"] == 2 * wins


@pytest.mark.parametrize("k", [8193, 16384])
def test_stat_kernels_take_slot_windows_past_8192(dev, k):
    _check_stat_kernels(dev, 3000, 3, k, seed=k)


@pytest.mark.parametrize("d", [257, 300, 384])
def test_stat_kernels_take_d_past_256(dev, d):
    """The Gram tiles of suffstats_labels (ceil(d / 128)^2 a segment),
    sub_assign_gauss's column panels and the dense oracle's panel tile."""
    _check_stat_kernels(dev, 1500, d, 5, seed=d)


@pytest.mark.parametrize("component,gen,d", [
    ("gaussian", generate_gmm, 8), ("gaussian", generate_gmm, 40),
    ("gaussian", generate_gmm, 200), ("multinomial", generate_mnmm, 32),
    ("diag_gaussian", generate_gmm, 8)])
def test_windowed_folds_are_the_unwindowed_folds_bitwise(dev, monkeypatch,
                                                         component, gen, d):
    """With the stat windows' budget down to one block (so the last window
    is a ragged block of its own, where the one-read kernels pick other
    point tiles), the family's sweep (one-read below d = 128, three-pass
    above) and label fold give their one-window results bit for bit."""
    from repro_torch.core import labelstats
    from repro_torch.core.state import tree_map
    fam = get_family(component)
    n, k = 5 * 1024 + 333, 6
    x_np, y = gen(n, d, 4, seed=1)
    x = torch.as_tensor(x_np, device=dev)
    valid = torch.ones(n, device=dev)
    lab = torch.as_tensor(y, device=dev).to(torch.int32)
    sub = (torch.arange(n, device=dev) % 2).to(torch.int32)
    prior = fam.build_prior(DPMMConfig(component=component),
                            x.mean(dim=0, keepdim=True))
    sub_stats = fam.stats_from_labels(x, valid, lab, sub, k)
    stats = tree_map(lambda a: a.sum(dim=1), sub_stats)
    live = stats.n > 0
    packed = lambda p: tree_map(lambda t: t.contiguous(), p)
    args = (x, valid, packed(fam.expected_params(prior, stats)),
            packed(fam.expected_params(prior, sub_stats)),
            torch.where(live, torch.log(stats.n.clamp(min=1) / n), -1e30),
            torch.full((k, 2), -0.6931472, device=dev), live,
            torch.arange(n, device=dev) + 3,
            torch.tensor([1, 2], device=dev), torch.tensor([3, 4],
                                                           device=dev), k)
    acc0 = lambda: fam.empty_stats((k, 2), d, dev)
    whole = fam.sweep(*args, acc0())
    whole_stats = fam.stats_from_labels(x, valid, lab, sub, k, acc=acc0())
    monkeypatch.setattr(labelstats, "WINDOW_BYTES", 1)
    assert len(fam.windows(x, k)) == 6
    before = ops.launch_counts()["fold_partials"]
    win = fam.sweep(*args, acc0())
    assert ops.launch_counts()["fold_partials"] - before == 6
    win_stats = fam.stats_from_labels(x, valid, lab, sub, k, acc=acc0())
    assert torch.equal(win[0], whole[0]) and torch.equal(win[1], whole[1])
    for a, b in ((win[2], whole[2]), (win_stats, whole_stats)):
        for name in a.__dataclass_fields__:
            assert torch.equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("nb,k,d", [(0, 33, 5), (1, 33, 5), (7, 33, 5),
                                    (17, 33, 5), (33, 33, 5), (977, 33, 5),
                                    # sxx of 2^20 elements: 256-wide tiles
                                    # beside n and sx's 32-wide ones
                                    (40, 32, 128)])
def test_one_launch_fold_is_the_per_field_loop_bitwise(dev, nb, k, d):
    """Every field of a stat fold in one launch (a Gaussian's n, sx, sxx
    and the diagonal Gaussian's two halves of one moment array, read in
    place) from a nonzero accumulator: the plain loop of adds field by
    field, bit for bit, and one launch."""
    from repro_torch.core import labelstats
    from repro_torch.core.diag_gaussian import DiagStats
    from repro_torch.core.niw import GaussStats
    g = torch.Generator().manual_seed(nb)
    r = lambda *s: (torch.randn(s, generator=g) * 1e4).to(dev)
    acc = GaussStats(r(k, 2), r(k, 2, d), r(k, 2, d, d))
    parts = GaussStats(r(nb, k, 2), r(nb, k, 2, d), r(nb, k, 2, d, d))
    moments = r(nb, k, 2, 2 * d)
    dacc = DiagStats(r(k, 2), r(k, 2, d), r(k, 2, d))
    dparts = DiagStats(r(nb, k, 2), moments[..., :d], moments[..., d:])
    for a, p in ((acc, parts), (dacc, dparts)):
        before = fold.fold_fields_cuda.launches
        got = labelstats.fold_stats(a, p)
        assert fold.fold_fields_cuda.launches == before + 1
        again = labelstats.fold_stats(a, p)
        for name in a.__dataclass_fields__:
            want = fold.fold_partials_plain(getattr(a, name),
                                            getattr(p, name))
            assert torch.equal(getattr(got, name), want)
            assert torch.equal(getattr(again, name), want)


def test_fit_past_the_one_read_slab_runs_sweep_ref(dev):
    """``k_max = 4096, compact=False``: every sweep on the 4096-slot dense
    slab, past the one-read kernels' 2048, through the three-pass sweep
    (one-read kernels would refuse the slab); chip_smoke.py's fit_k_large
    data and settings."""
    x, y = generate_gmm(100_000, 16, 16, seed=0)
    ops.reset_launch_counts()
    r = DPMM(DPMMConfig(k_max=4096, compact=False, iters=40, burnout=10,
                        log_every=10), device=dev).fit(x)
    counts = ops.launch_counts()
    assert counts["sweep_gauss"] == 0 and counts["assign_gauss"] == 40
    assert counts["sub_assign_gauss"] == 40 * assign.SUB_LAUNCHES
    assert r.nmi(y) > 0.9, (r.nmi(y), r.history["k"])


@pytest.mark.parametrize("tiled", [False, True])
def test_rotation_resume_on_the_card_is_the_uninterrupted_chain(dev,
                                                                tmp_path,
                                                                tiled):
    """Auto-checkpoint every 4 iterations, stop after 6, ``resume=True`` to
    12: the 12-iteration chain bit for bit on the card."""
    x, _ = generate_gmm(20_000, 8, 4, seed=5)
    kw = dict(iters=12, burnout=4, log_every=3,
              tile_size=4096 if tiled else None)
    rot = DPMMConfig(checkpoint_path=str(tmp_path / "ck"),
                     checkpoint_every=4, **kw)
    DPMM(rot, device=dev).fit(x, 6)
    rest = DPMM(rot, device=dev).fit(x, resume=True)
    whole = DPMM(DPMMConfig(**kw), device=dev).fit(x)
    np.testing.assert_array_equal(rest.labels, whole.labels)
    for group in ("params", "subparams", "stats", "substats"):
        a, b = getattr(rest.state, group), getattr(whole.state, group)
        for f in a.__dataclass_fields__:
            assert torch.equal(getattr(a, f), getattr(b, f)), (group, f)


@pytest.mark.parametrize("tiled", [False, True])
def test_chain_c_on_the_card_is_the_single_chain_fit(dev, tiled):
    from repro_torch.kernels import prng
    x, _ = generate_gmm(20_000, 8, 4, seed=5)
    cfg = DPMMConfig(iters=10, burnout=4, log_every=5,
                     tile_size=4096 if tiled else None)
    multi = DPMM(cfg, device=dev).fit(x, n_chains=3)
    for c in range(3):
        single = DPMM(DPMMConfig(iters=10, burnout=4, log_every=5),
                      device=dev).fit(x, key=prng.fold_in((0, 0), c))
        np.testing.assert_array_equal(multi.labels[c], single.labels)
        assert torch.equal(multi.state.stats.sx[c], single.state.stats.sx)


def test_divergence_on_the_card_raises_and_the_next_fit_runs(dev):
    from repro_torch.core.resilience import DivergenceError
    x, y = generate_gmm(20_000, 8, 4, seed=5)
    bad = x.copy()
    bad[5] = np.inf
    with pytest.raises(DivergenceError) as e:
        DPMM(DPMMConfig(iters=8, burnout=2, log_every=4,
                        max_recoveries=1), device=dev).fit(bad)
    assert len(e.value.recoveries) == 2
    torch.cuda.synchronize()
    r = DPMM(DPMMConfig(iters=20, burnout=5, log_every=5), device=dev).fit(x)
    assert r.nmi(y) > 0.9


def test_auto_slab_on_the_card_grows_and_repeats(dev):
    x, y = generate_gmm(20_000, 4, 6, seed=0, sep=10.0)
    cfg = DPMMConfig(alpha=10.0, iters=16, k_max="auto", k_max_cap=64,
                     burnout=5, log_every=4)
    a, b = DPMM(cfg, device=dev).fit(x), DPMM(cfg, device=dev).fit(x)
    assert a.slab_sizes[0] == 8 and a.state.active.shape[0] > 8
    assert a.nmi(y) > 0.9 and a.slab_sizes == b.slab_sizes
    np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("component,gen,d", [("gaussian", generate_gmm, 4),
                                             ("multinomial", generate_mnmm,
                                              32)])
def test_two_worker_fit_on_the_card_is_the_tiled_fit(dev, component, gen,
                                                     d):
    """A coordinator and two worker processes on the card: the chain is
    the card's single-process tiled fit bit for bit, the workers ran the
    sweep kernels and the coordinator the fold."""
    x, y = gen(20_000, d, 4, seed=0)
    cfg = dict(component=component, iters=14, burnout=5, tile_size=4096)
    single = DPMM(DPMMConfig(**cfg), device=dev).fit(HostTiledSource(x))
    ops.reset_launch_counts()
    dist = DPMM(DPMMConfig(workers=2, **cfg), device=dev).fit(
        HostTiledSource(x))
    assert ops.launch_counts()["fold_partials"] > 0
    lw = dist.dist["worker_launches"]
    sweep_k = "sweep_gauss" if component == "gaussian" else "sweep_linear"
    assert lw[sweep_k] > 0 and lw["fold_partials"] == 0
    assert dist.mode == "distributed" and dist.recoveries == []
    np.testing.assert_array_equal(dist.labels, single.labels)
    for key in single.history:
        np.testing.assert_array_equal(dist.history[key], single.history[key])
    for group in ("stats", "substats", "params"):
        a, b = getattr(dist.state, group), getattr(single.state, group)
        for name in a.__dataclass_fields__:
            assert torch.equal(getattr(a, name), getattr(b, name))
    assert dist.nmi(y) > 0.9


@pytest.mark.parametrize("component,gen,d", [("gaussian", generate_gmm, 8),
                                             ("multinomial", generate_mnmm,
                                              32)])
def test_refine_sweep_on_the_card_matches_its_plain_path(dev, component,
                                                         gen, d):
    """One refinement sweep through the kernels (``sweep_gauss`` or
    ``sweep_linear``, ``fold_partials``) against the same sweep on the
    plain sweep on the same card, model and keys: labels equal except
    near-ties, blended stats within rtol 1e-4; then (Gaussian) a poisoned
    batch is rejected and the answers stay as they were."""
    import dataclasses
    from repro_torch.core import niw
    from repro_torch.serve.dpmm import DPMMEngine, ServeConfig
    x, _ = gen(20_000, d, 4, seed=0)
    res = DPMM(DPMMConfig(component=component, iters=20, burnout=5),
               device=dev).fit(x)
    fam = get_family(component)
    eng = DPMMEngine(res.state, component,
                     ServeConfig(refine=True, refine_batch=1024))
    step, prior = eng._refine_setup(eng._served)
    q, _ = gen(1024, d, 4, seed=1)
    xb = torch.as_tensor(q, device=dev)
    valid = torch.ones(1024, device=dev)
    ops.reset_launch_counts()
    m_k, ok, lab_k = step(eng.model, xb, valid, prior)
    counts = ops.launch_counts()
    assert bool(ok) and counts["fold_partials"] == 1
    assert counts["sweep_gauss" if component == "gaussian"
                  else "sweep_linear"] > 0

    if component == "gaussian":
        def fused(x, v, p, sp, lw, slw, act, gidx, kz, kzb, slots):
            mu, f, ld, smu, sf, sld = niw.sweep_pack(p, sp)
            lab, sub, *parts = sweep.sweep_gauss_plain(
                x, mu, f, ld, lw, act, smu, sf, sld, slw, v, gidx, kz, kzb,
                slots)
            return lab, sub, niw.GaussStats(*parts)
    else:
        mod = fam.module

        def fused(x, v, p, sp, lw, slw, act, gidx, kz, kzb, slots):
            feats, w, const, subw, subconst = mod.sweep_pack(x, p, sp)
            lab, sub, n2, sf2 = sweep.sweep_linear_plain(
                feats, w, const, lw, act, subw, subconst, slw, v, gidx, kz,
                kzb, slots)
            return lab, sub, mod.stats_from_moments(n2, sf2)
    plain = dataclasses.replace(fam, fused_sweep=fused)
    m_p, lab_p = gibbs.refine_sweep(eng.model, xb, valid, prior, plain,
                                    DPMMConfig().alpha,
                                    decay=eng.cfg.refine_decay)
    assert m_k.it == m_p.it == eng.model.it + 1
    bad = int((lab_k != lab_p).sum())
    assert bad <= 2
    for group in ("stats", "substats"):
        a, b = getattr(m_k, group), getattr(m_p, group)
        for name in a.__dataclass_fields__:
            ta, tb = getattr(a, name), getattr(b, name)
            if name == "n" and bad == 0:
                assert torch.equal(ta, tb)
            assert torch.allclose(ta, tb, rtol=1e-4,
                                  atol=1e-4 * float(tb.abs().max()))
    if component == "gaussian":      # 1e30^2 overflows the sxx stat
        held = eng.query(q)
        out = eng.refine(x=np.full((1024, d), 1e30, np.float32))
        assert out["rejected"] == 1 and out["published"] == 0
        assert eng.events[-1]["kind"] == "refine_rejected"
        again = eng.query(q)
        np.testing.assert_array_equal(again.logprobs, held.logprobs)
    assert eng.refine(x=q)["published"] == 1


def _same_fit(a, b):
    np.testing.assert_array_equal(a.labels, b.labels)
    for key in a.history:
        np.testing.assert_array_equal(a.history[key], b.history[key])
    for group in ("stats", "substats"):
        sa, sb = getattr(a.state, group), getattr(b.state, group)
        for name in sa.__dataclass_fields__:
            assert torch.equal(getattr(sa, name).cpu(),
                               getattr(sb, name).cpu()), (group, name)


def _card_mesh(devices, model: int = 1):
    from repro_torch.core.distributed import Mesh
    if model == 1:
        return Mesh(list(devices), ("data",))
    return Mesh(np.array(list(devices), dtype=object).reshape(-1, model),
                ("data", "model"))


def test_two_logical_shards_hold_the_cross_mesh_contract(dev):
    """2 data shards on one card against 1 (the reference's cross-mesh
    contract: labels and every history but score equal, score within
    rtol 1e-3 / atol 1.0), at a ragged N; two runs of the 2-shard chain
    are bitwise, each shard launched its kernels, and a reduction a pass
    gathered G K 2 T 4 bytes."""
    x, y = generate_gmm(20_001, 8, 6, seed=2, sep=10.0)
    cfg = DPMMConfig(k_max=16, iters=25, burnout=5, compact=False)
    one = DPMM(cfg, mesh=_card_mesh([dev])).fit(x)
    two = DPMM(cfg, mesh=_card_mesh([dev, dev])).fit(x)
    again = DPMM(cfg, mesh=_card_mesh([dev, dev])).fit(x)
    _same_fit(two, again)
    np.testing.assert_array_equal(one.labels, two.labels)
    for key in one.history:
        if key == "score":
            np.testing.assert_allclose(one.history[key], two.history[key],
                                       rtol=1e-3, atol=1.0)
        else:
            np.testing.assert_array_equal(one.history[key],
                                          two.history[key])
    assert two.nmi(y) > 0.9
    for launches in two.mesh["shard_launches"]:
        assert launches["sweep_gauss"] > 0
        assert launches["suffstats_labels"] > 0
    assert two.mesh["reduce_bytes"] == (two.mesh["reductions"] * 2 * 16 * 2
                                        * (1 + 8 + 64) * 4)
    assert one.mesh["reductions"] == 0


def test_tiled_is_the_resident_chain_on_a_two_shard_mesh(dev):
    x, _ = generate_gmm(30_000, 4, 5, seed=3)
    mesh = _card_mesh([dev, dev])
    cfg = dict(k_max=16, iters=20, burnout=5)
    resident = DPMM(DPMMConfig(**cfg), mesh=mesh).fit(x)
    tiled = DPMM(DPMMConfig(tile_size=4096, **cfg), mesh=mesh).fit(
        HostTiledSource(x))
    _same_fit(resident, tiled)
    assert tiled.mesh["data_shards"] == 2


def test_feature_sharded_multinomial_on_the_card(dev):
    """(2 x 2): the features of each data shard in two slices, the plain
    route and ``moments_labels`` on each slice; the (2 x 1) fit runs the
    kernels. The two routes' log-likelihood sums round differently, so at
    most 2 of the 20,000 labels may differ (``chip_smoke.py``
    ``fit_feature_shard`` counts them at 10^6 points); two (2 x 2) runs
    bitwise."""
    x, y = generate_mnmm(20_000, 64, 5, seed=1)
    cfg = dict(component="multinomial", k_max=16, iters=20, burnout=5)
    plain = DPMM(DPMMConfig(**cfg), mesh=_card_mesh([dev] * 2)).fit(x)
    fs = DPMMConfig(shard_features=True, **cfg)
    a = DPMM(fs, mesh=_card_mesh([dev] * 4, model=2)).fit(x)
    b = DPMM(fs, mesh=_card_mesh([dev] * 4, model=2)).fit(x)
    _same_fit(a, b)
    assert a.mesh["model_shards"] == 2
    assert all(launches["moments_labels"] > 0
               for launches in a.mesh["shard_launches"])
    assert int((a.labels != plain.labels).sum()) <= 2
    assert a.nmi(y) > 0.9


def test_two_cards_give_the_one_card_mesh_bits(dev):
    """A G-shard chain's bits depend on G, not on the cards that hold the
    shards: shards on cuda:0 and cuda:1 against both on cuda:0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x, _ = generate_gmm(20_000, 8, 6, seed=2, sep=10.0)
    cfg = DPMMConfig(k_max=16, iters=20, burnout=5)
    logical = DPMM(cfg, mesh=_card_mesh(["cuda:0", "cuda:0"])).fit(x)
    cards = DPMM(cfg, mesh=_card_mesh(["cuda:0", "cuda:1"])).fit(x)
    _same_fit(logical, cards)


LM_DENSE = ("granite-8b", "starcoder2-7b", "gemma2-9b", "mistral-large-123b")


def _lm_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("arch", LM_DENSE)
def test_lm_logits_on_the_card_are_the_cpus(dev, arch):
    """The dense-attention archs at smoke size: the card's forward and
    teacher-forced decode logits against the CPU's on the same weights and
    tokens (float32 sums in another order; TF32 off), within 1e-5 of the
    logits' scale."""
    import copy
    from repro_torch.configs import smoke_config
    from repro_torch.models import decode, transformer
    cfg = smoke_config(arch)
    model = transformer.init_params(0, cfg, device="cpu")
    card = copy.deepcopy(model).to(dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want, _ = transformer.forward(model, toks)
        got, _ = transformer.forward(card, toks.to(dev))
        assert _lm_rel(got, want) <= 1e-5
        outs = []
        for m, t in ((model, toks), (card, toks.to(dev))):
            cache = decode.init_cache(cfg, 2, 10, torch.float32,
                                      device=t.device)
            steps = []
            for i in range(10):
                lg, cache = decode.decode_step(m, cache, t[:, i:i + 1],
                                               cache_len=10)
                steps.append(lg[:, 0])
            outs.append(torch.stack(steps, dim=1))
        assert _lm_rel(outs[1], outs[0]) <= 1e-5
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_lm_greedy_generator_on_the_card_is_the_cpus(dev):
    """gemma2-9b at smoke size: greedy ids from the card's Generator equal
    the CPU's."""
    import dataclasses
    from repro_torch.configs import INPUT_SHAPES, smoke_config
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Generator
    cfg = smoke_config("gemma2-9b")
    shape = dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=64,
                                global_batch=2)
    prompts = np.arange(16).reshape(2, 8) % cfg.vocab_size
    cpu = Generator(cfg, shape,
                    transformer.init_params(0, cfg, device="cpu"),
                    device="cpu").generate(prompts, steps=16)
    card = Generator(cfg, shape,
                     transformer.init_params(0, cfg, device="cpu"),
                     device=dev).generate(prompts, steps=16)
    assert torch.equal(card.cpu(), cpu)
