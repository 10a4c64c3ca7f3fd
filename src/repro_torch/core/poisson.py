"""Gamma-Poisson conjugate component (count observations).

Port of ``repro.core.poisson``. Points are count vectors x in N^d with
independent Poisson(lambda_j) rates per feature; the conjugate prior is
Gamma(a0, b0) per rate. The per-point log(x_ij!) terms are dropped: they
do not depend on the label.

Batched over a leading cluster shape B like the other families. The gamma
draws of ``sample_posterior`` come from an explicit ``torch.Generator`` or
are passed in.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.labelstats import fold_stats, moments_from_labels


@dataclasses.dataclass
class PoisPrior:
    a0: torch.Tensor       # () Gamma shape
    b0: torch.Tensor       # () Gamma rate
    d: int


@dataclasses.dataclass
class PoisStats:
    n: torch.Tensor        # (*B,) number of points
    sx: torch.Tensor       # (*B, d) summed counts


@dataclasses.dataclass
class PoisParams:
    log_rate: torch.Tensor  # (*B, d)


def build_prior(cfg, x: torch.Tensor) -> PoisPrior:
    """Prior from the config and a (rows, d) data summary."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    return PoisPrior(a0=t(cfg.gamma_a0), b0=t(cfg.gamma_b0), d=x.shape[1])


def empty_stats(batch_shape: Tuple[int, ...], d: int, device) -> PoisStats:
    z = lambda *s: torch.zeros(batch_shape + s, dtype=torch.float32,
                               device=device)
    return PoisStats(n=z(), sx=z(d))


def add_stats(a: PoisStats, b: PoisStats) -> PoisStats:
    return PoisStats(a.n + b.n, a.sx + b.sx)


def stats_from_moments(n2: torch.Tensor, sf2: torch.Tensor) -> PoisStats:
    """Stats from moment sums, folded or per block (the features are
    x)."""
    return PoisStats(n=n2, sx=sf2)


def partials_from_labels(x, valid, labels, sublabels,
                         k_max: int) -> PoisStats:
    """Per-STATS_BLOCK (nsb, k_max, 2) sub-cluster stat partials from int
    labels."""
    return stats_from_moments(*moments_from_labels(x, valid, labels,
                                                   sublabels, k_max))


def stats_from_labels(x, valid, labels, sublabels, k_max: int) -> PoisStats:
    """(k_max, 2) sub-cluster stats straight from int labels: the partials
    folded left to right."""
    return fold_stats(empty_stats((k_max, 2), x.shape[1], x.device),
                      partials_from_labels(x, valid, labels, sublabels,
                                           k_max))


def assign_pack(x: torch.Tensor, params: PoisParams):
    """loglik(x)_b = x @ log(lambda_b) - sum_j lambda_bj."""
    return (x, params.log_rate,
            -torch.exp(params.log_rate).sum(dim=-1))


def slice_params(params: PoisParams, start: int, n: int) -> PoisParams:
    """Features ``start .. start + n`` of the params (feature sharding)."""
    return PoisParams(log_rate=params.log_rate[..., start:start + n])


def sweep_pack(x: torch.Tensor, params: PoisParams, subparams: PoisParams):
    """The fused sweep's operands (feats, w, const, subw, subconst); the
    ``-sum exp(log rate)`` constants are computed here, outside the
    kernel."""
    feats, w, const = assign_pack(x, params)
    _, subw, subconst = assign_pack(x, subparams)
    return feats, w, const, subw, subconst


def posterior(prior: PoisPrior, stats: PoisStats):
    """Gamma posterior (a_n (*B, d), b_n (*B, 1)) of every rate."""
    return prior.a0 + stats.sx, prior.b0 + stats.n[..., None]


def log_marginal(prior: PoisPrior, stats: PoisStats) -> torch.Tensor:
    """Negative-binomial marginal (log x! dropped):
    sum_j [a0 log b0 - log G(a0) + log G(a_n,j) - a_n,j log b_n]."""
    a_n, b_n = posterior(prior, stats)
    return (prior.a0 * torch.log(prior.b0) - torch.lgamma(prior.a0)
            + torch.lgamma(a_n) - a_n * torch.log(b_n)).sum(dim=-1)


def sample_posterior(prior: PoisPrior, stats: PoisStats,
                     generator: Optional[torch.Generator] = None, *,
                     gammas: Optional[torch.Tensor] = None) -> PoisParams:
    """lambda_j ~ Gamma(a0 + S_j, b0 + n), batched; returns log lambda.
    ``gammas`` (*B, d) replaces the Gamma(a_n, 1) draws."""
    a_n, b_n = posterior(prior, stats)
    g = (torch._standard_gamma(a_n, generator=generator)
         if gammas is None else gammas)
    g = torch.clamp(g, min=1e-30)
    return PoisParams(log_rate=torch.log(g) - torch.log(b_n))


def expected_params(prior: PoisPrior, stats: PoisStats) -> PoisParams:
    a_n, b_n = posterior(prior, stats)
    return PoisParams(log_rate=torch.log(a_n) - torch.log(b_n))


def loglik(x: torch.Tensor, params: PoisParams,
           matmul=None) -> torch.Tensor:
    """sum_j [x_ij log lambda_bj - lambda_bj] -> (N, *B); log x! dropped.
    ``matmul`` swaps the (N, d) x (d, B) product (default
    ``torch.matmul``)."""
    mm = matmul if matmul is not None else torch.matmul
    lr = params.log_rate.reshape(-1, params.log_rate.shape[-1])
    out = mm(x, lr.T) - torch.exp(lr).sum(dim=-1)[None, :]
    return out.reshape((x.shape[0],) + params.log_rate.shape[:-1])
