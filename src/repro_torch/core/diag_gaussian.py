"""Normal-Inverse-Gamma conjugate component (diagonal-covariance Gaussian).

Port of ``repro.core.diag_gaussian``: per-feature independent Gaussians
with conjugate NIG priors,

    tau_j ~ Gamma(a0, b0),   mu_j | tau_j ~ N(m_j, 1 / (kappa tau_j)),

the d = 1 NIW taken per coordinate. Every quantity is a sum over features,
so the likelihood is linear in the features [x, x^2]:
loglik_b(x) = [x, x^2] @ [prec mu, -prec / 2]_b + const_b.

Batched over a leading cluster shape B like the other families. The Gamma
and normal draws of ``sample_posterior`` come from an explicit
``torch.Generator`` or are passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.labelstats import fold_stats, moments_from_labels

LOG_2PI = 1.8378770664093453


@dataclasses.dataclass
class NIGPrior:
    """Per-feature NIG hyper-parameters (m, kappa, a0, b0)."""
    m: torch.Tensor        # (d,) prior mean per feature
    kappa: torch.Tensor    # ()
    a0: torch.Tensor       # () Gamma shape of the precision
    b0: torch.Tensor       # () Gamma rate of the precision


@dataclasses.dataclass
class DiagStats:
    """(n, sum x, sum x^2) per feature."""
    n: torch.Tensor        # (*B,)
    sx: torch.Tensor       # (*B, d)
    sxx: torch.Tensor      # (*B, d)


@dataclasses.dataclass
class DiagParams:
    mu: torch.Tensor        # (*B, d)
    log_prec: torch.Tensor  # (*B, d) log tau per feature


def build_prior(cfg, x: torch.Tensor) -> NIGPrior:
    """Prior centred on the data mean, from the config and a (rows, d)
    data summary."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    return NIGPrior(m=x.to(torch.float32).mean(dim=0), kappa=t(cfg.nig_kappa),
                    a0=t(cfg.nig_a0), b0=t(cfg.nig_b0))


def empty_stats(batch_shape: Tuple[int, ...], d: int, device) -> DiagStats:
    z = lambda *s: torch.zeros(batch_shape + s, dtype=torch.float32,
                               device=device)
    return DiagStats(n=z(), sx=z(d), sxx=z(d))


def add_stats(a: DiagStats, b: DiagStats) -> DiagStats:
    return DiagStats(a.n + b.n, a.sx + b.sx, a.sxx + b.sxx)


def features(x: torch.Tensor) -> torch.Tensor:
    """The (N, 2d) feature block [x, x^2]: the likelihood's features and
    the stat feature map alike."""
    return torch.cat([x, x * x], dim=-1)


def stats_from_moments(n2: torch.Tensor, sf2: torch.Tensor) -> DiagStats:
    """Stats from [x, x^2] moment sums, folded or per block."""
    d = sf2.shape[-1] // 2
    return DiagStats(n=n2, sx=sf2[..., :d], sxx=sf2[..., d:])


def partials_from_labels(x, valid, labels, sublabels,
                         k_max: int) -> DiagStats:
    """Per-STATS_BLOCK (nsb, k_max, 2) sub-cluster stat partials from int
    labels."""
    return stats_from_moments(*moments_from_labels(features(x), valid, labels,
                                                   sublabels, k_max))


def stats_from_labels(x, valid, labels, sublabels, k_max: int) -> DiagStats:
    """(k_max, 2) sub-cluster stats straight from int labels: the partials
    folded left to right."""
    return fold_stats(empty_stats((k_max, 2), x.shape[1], x.device),
                      partials_from_labels(x, valid, labels, sublabels,
                                           k_max))


def _pack_linear(params: DiagParams, d: int):
    """(w, const) of the expanded quadratic (cf. ``loglik``)."""
    prec = torch.exp(params.log_prec)
    w = torch.cat([prec * params.mu, -0.5 * prec], dim=-1)
    const = (0.5 * params.log_prec.sum(dim=-1)
             - 0.5 * (prec * params.mu * params.mu).sum(dim=-1)
             - 0.5 * d * LOG_2PI)
    return w, const


def assign_pack(x: torch.Tensor, params: DiagParams):
    """(feats, w, const) with feats = [x, x^2]."""
    return (features(x),) + _pack_linear(params, x.shape[-1])


def slice_params(params: DiagParams, start: int, n: int) -> DiagParams:
    """Features ``start .. start + n`` of the params (feature sharding)."""
    sl = lambda t: t[..., start:start + n]
    return DiagParams(mu=sl(params.mu), log_prec=sl(params.log_prec))


def sweep_pack(x: torch.Tensor, params: DiagParams, subparams: DiagParams):
    """The fused sweep's operands (feats, w, const, subw, subconst): the
    [x, x^2] block is built once, here in PyTorch, and shared by steps
    (e), (f) and the stat fold."""
    d = x.shape[-1]
    return ((features(x),) + _pack_linear(params, d)
            + _pack_linear(subparams, d))


def posterior(prior: NIGPrior, stats: DiagStats):
    """NIG posterior (m_n (*B, d), kappa_n (*B,), a_n (*B,), b_n (*B, d))."""
    kappa_n = prior.kappa + stats.n
    m_n = (prior.kappa * prior.m + stats.sx) / kappa_n[..., None]
    a_n = prior.a0 + 0.5 * stats.n
    b_n = prior.b0 + 0.5 * (stats.sxx + prior.kappa * prior.m ** 2
                            - kappa_n[..., None] * m_n ** 2)
    return m_n, kappa_n, a_n, torch.clamp(b_n, min=1e-10)


def log_marginal(prior: NIGPrior, stats: DiagStats) -> torch.Tensor:
    """Product of the per-feature NIG marginals (Murphy 2007 eq. 266 at
    d = 1), summed in log space over the features."""
    d = prior.m.shape[-1]
    _, kappa_n, a_n, b_n = posterior(prior, stats)
    per_feature = (torch.lgamma(a_n)[..., None] - torch.lgamma(prior.a0)
                   + prior.a0 * torch.log(prior.b0)
                   - a_n[..., None] * torch.log(b_n))
    return (per_feature.sum(dim=-1)
            + 0.5 * d * (torch.log(prior.kappa) - torch.log(kappa_n))
            - 0.5 * stats.n * d * LOG_2PI)


def sample_posterior(prior: NIGPrior, stats: DiagStats,
                     generator: Optional[torch.Generator] = None, *,
                     gammas: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None) -> DiagParams:
    """(mu_j, tau_j) from the NIG posterior, batched. ``gammas`` (*B, d)
    replaces the Gamma(a_n, 1) draws and ``z`` (*B, d) the normal draws;
    each one not given is drawn from ``generator`` in that order."""
    m_n, kappa_n, a_n, b_n = posterior(prior, stats)
    if gammas is None:
        gammas = torch._standard_gamma(a_n[..., None].expand(b_n.shape)
                                       .contiguous(), generator=generator)
    if z is None:
        z = torch.randn(m_n.shape, generator=generator, dtype=m_n.dtype,
                        device=m_n.device)
    log_prec = torch.log(torch.clamp(gammas, min=1e-30)) - torch.log(b_n)
    sd = torch.exp(-0.5 * log_prec) / torch.sqrt(kappa_n)[..., None]
    return DiagParams(mu=m_n + z * sd, log_prec=log_prec)


def expected_params(prior: NIGPrior, stats: DiagStats) -> DiagParams:
    m_n, _, a_n, b_n = posterior(prior, stats)
    return DiagParams(mu=m_n,
                      log_prec=torch.log(a_n)[..., None] - torch.log(b_n))


def loglik(x: torch.Tensor, params: DiagParams,
           matmul=None) -> torch.Tensor:
    """sum_j log N(x_j; mu_bj, 1 / tau_bj) -> (N, *B), as two matmuls of
    the expanded quadratic. ``matmul`` swaps the (N, d) x (d, B) product
    (the family's query path passes ``ops.matmul_auto``, the paper's
    size-dispatched kernel); the default is ``torch.matmul``."""
    mm = matmul if matmul is not None else torch.matmul
    d = x.shape[-1]
    bshape = params.mu.shape[:-1]
    mu = params.mu.reshape(-1, d)
    log_prec = params.log_prec.reshape(-1, d)
    prec = torch.exp(log_prec)
    quad = mm(x * x, prec.T) - 2.0 * mm(x, (prec * mu).T)
    const = (0.5 * log_prec.sum(dim=-1) - 0.5 * (prec * mu * mu).sum(dim=-1)
             - 0.5 * d * LOG_2PI)
    return (const[None, :] - 0.5 * quad).reshape((x.shape[0],) + bshape)
