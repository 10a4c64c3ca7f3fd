"""The checks of ``chip_smoke.py`` that need no card, run on the CPU.

The smoke run holds the card's model-side draws (Dirichlet, Beta and NIW
posterior; the linear families' Dirichlet, Gamma and NIG posteriors)
against their analytic moments; here the same checks run on the CPU at a
small state, pass on the port's samplers and fail on a gamma sampler
biased by 5 %.
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


def _linear_state(name, k_max=6, live=4, n=3000, seed=0):
    """Stats of ``live`` of ``k_max`` slots from labelled count (or, for
    diag_gaussian, Gaussian) points of the family ``name``."""
    from repro_torch.core.family import get_family
    fam = get_family(name)
    g = torch.Generator().manual_seed(seed)
    lab = torch.randint(0, live, (n,), generator=g)
    if name == "diag_gaussian":
        x = torch.randn(n, 3, generator=g) + 4.0 * lab[:, None].float()
    else:
        x = torch.poisson(2.0 + 3.0 * lab[:, None].float().expand(n, 5),
                          generator=g)
    sub = torch.randint(0, 2, (n,), generator=g)
    stats2 = fam.stats_from_labels(x, torch.ones(n), lab, sub, k_max)
    stats = type(stats2)(**{f: getattr(stats2, f).sum(1)
                            for f in stats2.__dataclass_fields__})
    prior = fam.build_prior(DPMMConfig(), x.mean(dim=0, keepdim=True))
    return fam, torch.arange(k_max) < live, stats, stats2, prior


@pytest.mark.parametrize("bias", [1.0, 1.05])
@pytest.mark.parametrize("name", ["multinomial", "poisson", "diag_gaussian"])
def test_linear_draw_check_passes_the_samplers_and_catches_a_bias(
        smoke, monkeypatch, name, bias):
    state = _linear_state(name)
    if bias != 1.0:
        gamma = torch._standard_gamma
        if name == "multinomial":
            # a common scale cancels in theta: bias one coordinate's
            # concentration instead
            first = lambda c: torch.where(torch.arange(c.shape[-1]) == 0,
                                          bias, 1.0)
            biased = lambda c, **kw: gamma(c * first(c), **kw)
        else:
            biased = lambda *a, **kw: gamma(*a, **kw) * bias
        monkeypatch.setattr(torch, "_standard_gamma", biased)
        with pytest.raises(SystemExit, match="analytic moments"):
            smoke.check_linear_draws(*state, "cpu")
    else:
        z = smoke.check_linear_draws(*state, "cpu")
        assert max(z.values()) <= smoke.Z_MAX
