"""Dirichlet-multinomial conjugate component (count observations).

Port of ``repro.core.multinomial``: the paper's DPMNMM (§5.2, and the
20newsgroups fit of §5.3). Points are count vectors x in N^d; the prior
over a component's probability vector is Dir(alpha0 * 1_d). The per-point
multinomial coefficient is dropped everywhere: it does not depend on the
label, so it cancels in the assignment and in every Hastings ratio.

Every function takes a batch of clusters: stats carry a leading shape B
((K,) for clusters, (K, 2) for sub-clusters). The gamma draws of
``sample_posterior`` come from an explicit ``torch.Generator`` or are
passed in, so a test can feed the JAX package's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.labelstats import fold_stats, moments_from_labels


@dataclasses.dataclass
class MultPrior:
    alpha0: torch.Tensor   # () symmetric Dirichlet concentration
    d: int


@dataclasses.dataclass
class MultStats:
    n: torch.Tensor        # (*B,) number of points
    counts: torch.Tensor   # (*B, d) summed count vectors


@dataclasses.dataclass
class MultParams:
    logtheta: torch.Tensor  # (*B, d)


def build_prior(cfg, x: torch.Tensor) -> MultPrior:
    """Prior from the config and a (rows, d) data summary."""
    return MultPrior(alpha0=torch.tensor(cfg.dir_alpha, dtype=torch.float32,
                                         device=x.device), d=x.shape[1])


def empty_stats(batch_shape: Tuple[int, ...], d: int, device) -> MultStats:
    z = lambda *s: torch.zeros(batch_shape + s, dtype=torch.float32,
                               device=device)
    return MultStats(n=z(), counts=z(d))


def add_stats(a: MultStats, b: MultStats) -> MultStats:
    return MultStats(a.n + b.n, a.counts + b.counts)


def stats_from_moments(n2: torch.Tensor, sf2: torch.Tensor) -> MultStats:
    """Stats from moment sums, folded or per block: the features are x,
    so the moment sums are the counts."""
    return MultStats(n=n2, counts=sf2)


def partials_from_labels(x, valid, labels, sublabels,
                         k_max: int) -> MultStats:
    """Per-STATS_BLOCK (nsb, k_max, 2) sub-cluster stat partials from int
    labels."""
    return stats_from_moments(*moments_from_labels(x, valid, labels,
                                                   sublabels, k_max))


def stats_from_labels(x, valid, labels, sublabels, k_max: int) -> MultStats:
    """(k_max, 2) sub-cluster stats straight from int labels: the partials
    folded left to right."""
    return fold_stats(empty_stats((k_max, 2), x.shape[1], x.device),
                      partials_from_labels(x, valid, labels, sublabels,
                                           k_max))


def assign_pack(x: torch.Tensor, params: MultParams):
    """loglik(x)_b = feats @ w_b + const_b with feats = x, w = log theta."""
    return x, params.logtheta, params.logtheta.new_zeros(
        params.logtheta.shape[:-1])


def slice_params(params: MultParams, start: int, n: int) -> MultParams:
    """Features ``start .. start + n`` of the params (feature sharding)."""
    return MultParams(logtheta=params.logtheta[..., start:start + n])


def sweep_pack(x: torch.Tensor, params: MultParams, subparams: MultParams):
    """The fused sweep's operands: x is both the feature block and the
    stat feature map. Returns (feats, w, const, subw, subconst)."""
    feats, w, const = assign_pack(x, params)
    _, subw, subconst = assign_pack(x, subparams)
    return feats, w, const, subw, subconst


def log_marginal(prior: MultPrior, stats: MultStats) -> torch.Tensor:
    """Dirichlet-multinomial marginal (multinomial coefficients dropped):
    log G(A) - log G(A + M) + sum_j [log G(a0 + c_j) - log G(a0)] with
    A = d a0 and M = sum_j c_j."""
    a0 = prior.alpha0
    a_tot = prior.d * a0
    m_tot = stats.counts.sum(dim=-1)
    return (torch.lgamma(a_tot) - torch.lgamma(a_tot + m_tot)
            + (torch.lgamma(a0 + stats.counts) - torch.lgamma(a0)).sum(-1))


def posterior(prior: MultPrior, stats: MultStats) -> torch.Tensor:
    """Dirichlet posterior concentration alpha0 + counts."""
    return prior.alpha0 + stats.counts


def sample_posterior(prior: MultPrior, stats: MultStats,
                     generator: Optional[torch.Generator] = None, *,
                     gammas: Optional[torch.Tensor] = None) -> MultParams:
    """theta ~ Dir(alpha0 + counts), batched; returns log theta.
    ``gammas`` (*B, d) replaces the Gamma(alpha0 + counts) draws."""
    conc = posterior(prior, stats)
    g = (torch._standard_gamma(conc, generator=generator)
         if gammas is None else gammas)
    g = torch.clamp(g, min=1e-30)
    return MultParams(logtheta=torch.log(g)
                      - torch.log(g.sum(dim=-1, keepdim=True)))


def expected_params(prior: MultPrior, stats: MultStats) -> MultParams:
    conc = posterior(prior, stats)
    return MultParams(logtheta=torch.log(conc)
                      - torch.log(conc.sum(dim=-1, keepdim=True)))


def loglik(x: torch.Tensor, params: MultParams,
           matmul=None) -> torch.Tensor:
    """sum_j x_ij log theta_bj for all points and clusters -> (N, *B).
    ``matmul`` swaps the (N, d) x (d, B) product (default
    ``torch.matmul``)."""
    mm = matmul if matmul is not None else torch.matmul
    lt = params.logtheta.reshape(-1, params.logtheta.shape[-1])
    return mm(x, lt.T).reshape((x.shape[0],) + params.logtheta.shape[:-1])
