"""The checks of ``chip_smoke.py`` that need no card, run on the CPU.

The smoke run holds the card's model-side draws (Dirichlet, Beta and NIW
posterior) against their analytic moments; here the same check runs on
the CPU at a small state, passes on the port's samplers and fails on a
gamma sampler biased by 5 %.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import DPMMConfig
from repro_torch.core import niw

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _state(k_max=6, live=4, d=3, n=3000, seed=0):
    """Stats of ``live`` of ``k_max`` slots from labelled Gaussian points."""
    g = torch.Generator().manual_seed(seed)
    lab = torch.randint(0, live, (n,), generator=g)
    x = torch.randn(n, d, generator=g) + 4.0 * lab[:, None].float()
    sub = torch.randint(0, 2, (n,), generator=g)
    cfg = DPMMConfig(k_max=k_max)
    stats2 = niw.stats_from_labels(x, torch.ones(n), lab, sub, k_max)
    stats = niw.GaussStats(stats2.n.sum(1), stats2.sx.sum(1),
                           stats2.sxx.sum(1))
    active = torch.arange(k_max) < live
    prior = niw.build_prior(cfg, x.mean(dim=0, keepdim=True))
    return active, stats, stats2, prior, cfg.alpha


@pytest.mark.parametrize("bias", [1.0, 1.05])
def test_model_draw_check_passes_the_samplers_and_catches_a_bias(
        smoke, monkeypatch, bias):
    state = _state()
    if bias != 1.0:
        gamma = torch._standard_gamma
        monkeypatch.setattr(torch, "_standard_gamma",
                            lambda *a, **kw: gamma(*a, **kw) * bias)
        with pytest.raises(SystemExit, match="analytic moments"):
            smoke.check_model_draws(*state, "cpu")
    else:
        z = smoke.check_model_draws(*state, "cpu")
        assert set(z) == {"weights", "subweights", "precision",
                          "logdet_prec", "mu"}
        assert max(z.values()) <= smoke.Z_MAX
