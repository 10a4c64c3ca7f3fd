"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (from a fixture, at run time) where no
CUDA device is available. Run on a GPU machine with
``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.

Rules: labels equal except mismatches proven to be near-ties (the two
logits within 1e-4, relative; at most 0.1 % of the points), stats partials within rtol 1e-4 of each array's scale (long
float32 sums in another order), counts exact; a repeat launch on the same
inputs gives identical bits (no float atomics).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import DPMMConfig
from repro_torch.core.sampler import DPMM
from repro_torch.data.synthetic import generate_gmm
from repro_torch.kernels import ops, suffstats, sweep


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
                                   (3000, 20, 5), (2100, 64, 3)])
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


@pytest.mark.parametrize("n,d,k", [(2500, 2, 8), (4096, 32, 64)])
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


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    a = list(_args(2048, 4, 4, dev))
    bad = list(a)
    bad[0] = a[0].double()
    with pytest.raises(TypeError):
        sweep.sweep_gauss_cuda(*bad)
    bad = list(a)
    bad[0] = torch.randn(2048, 65, device=dev)
    with pytest.raises(ValueError, match="d=65"):
        sweep.sweep_gauss_cuda(*bad)
    with pytest.raises(ValueError, match="d=65"):
        suffstats.suffstats_labels_cuda(bad[0], a[5][:1].repeat(2048),
                                        a[5][:1].repeat(2048), a[10], 4)
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
