"""Normal-Inverse-Wishart conjugate component (Gaussian observations).

Port of ``repro.core.niw``: posterior parameters, posterior sampling
(Bartlett decomposition), the log marginal likelihood of the split/merge
Hastings ratios (paper eqs. 12, 20, 21) and the label-indexed statistics
(through ``kernels.ops``).
Every function takes a batch of clusters: stats carry a leading shape B
((K,) for clusters, (K, 2) for sub-clusters).

As in the reference, ``chol_prec`` is a factor F of the precision,
Sigma^-1 = F F^T, so the likelihood is a whitening product, and
``logdet_prec = log det Sigma^-1``.

The random draws of ``sample_posterior`` (chi-square and normal) come
from an explicit ``torch.Generator``, or are passed in, so a test can feed
the JAX package's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.labelstats import fold_stats
from repro_torch.kernels import ops


@dataclasses.dataclass
class NIWPrior:
    """Hyper-parameters lambda = (m, Psi, kappa, nu) (paper eq. 9)."""
    m: torch.Tensor        # (d,)
    psi: torch.Tensor      # (d, d)
    kappa: torch.Tensor    # ()
    nu: torch.Tensor       # ()


@dataclasses.dataclass
class GaussStats:
    """Sufficient statistics (n, sum x, sum x x^T)."""
    n: torch.Tensor        # (*B,)
    sx: torch.Tensor       # (*B, d)
    sxx: torch.Tensor      # (*B, d, d)


@dataclasses.dataclass
class GaussParams:
    mu: torch.Tensor           # (*B, d)
    chol_prec: torch.Tensor    # (*B, d, d) F with Sigma^-1 = F F^T
    logdet_prec: torch.Tensor  # (*B,)


def default_prior(x_mean: torch.Tensor, psi_diag: torch.Tensor,
                  kappa: float, nu: float) -> NIWPrior:
    psi = torch.diag(torch.clamp(psi_diag, min=1e-6))
    return NIWPrior(m=x_mean, psi=psi,
                    kappa=torch.tensor(kappa, dtype=x_mean.dtype,
                                       device=x_mean.device),
                    nu=torch.tensor(nu, dtype=x_mean.dtype,
                                    device=x_mean.device))


def build_prior(cfg, x: torch.Tensor) -> NIWPrior:
    """Prior from the config and a (rows, d) data summary (the fit passes
    the one-row column mean)."""
    mean = x.to(torch.float32).mean(dim=0)
    psi_diag = torch.full((x.shape[1],), cfg.niw_psi, dtype=torch.float32,
                          device=x.device)
    return default_prior(mean, psi_diag, cfg.niw_kappa,
                         x.shape[1] + cfg.niw_nu_extra)


def empty_stats(batch_shape: Tuple[int, ...], d: int,
                device) -> GaussStats:
    z = lambda *s: torch.zeros(batch_shape + s, dtype=torch.float32,
                               device=device)
    return GaussStats(n=z(), sx=z(d), sxx=z(d, d))


def add_stats(a: GaussStats, b: GaussStats) -> GaussStats:
    return GaussStats(a.n + b.n, a.sx + b.sx, a.sxx + b.sxx)


def partials_from_labels(x: torch.Tensor, valid: torch.Tensor,
                         labels: torch.Tensor, sublabels: torch.Tensor,
                         k_max: int) -> GaussStats:
    """Per-STATS_BLOCK (nsb, k_max, 2) sub-cluster stat partials from int
    labels: the ``suffstats_labels`` kernel (its plain version on the
    CPU)."""
    return GaussStats(*ops.suffstats_labels(
        x, labels.to(torch.int32), sublabels.to(torch.int32), valid, k_max))


def stats_from_labels(x: torch.Tensor, valid: torch.Tensor,
                      labels: torch.Tensor, sublabels: torch.Tensor,
                      k_max: int) -> GaussStats:
    """(k_max, 2) sub-cluster stats straight from int labels: the partials
    folded left to right."""
    return fold_stats(empty_stats((k_max, 2), x.shape[1], x.device),
                      partials_from_labels(x, valid, labels, sublabels,
                                           k_max))


def sweep_pack(params: GaussParams, subparams: GaussParams):
    """The fields the fused sweep kernel takes, in its argument order."""
    return (params.mu, params.chol_prec, params.logdet_prec,
            subparams.mu, subparams.chol_prec, subparams.logdet_prec)


def posterior(prior: NIWPrior, stats: GaussStats):
    """NIW posterior hyper-parameters (m_n, Psi_n, kappa_n, nu_n)."""
    kappa_n = prior.kappa + stats.n
    nu_n = prior.nu + stats.n
    m_n = (prior.kappa * prior.m + stats.sx) / kappa_n[..., None]
    psi_n = (prior.psi + stats.sxx
             + prior.kappa * torch.outer(prior.m, prior.m)
             - kappa_n[..., None, None]
             * (m_n[..., :, None] * m_n[..., None, :]))
    psi_n = 0.5 * (psi_n + psi_n.transpose(-1, -2))
    return m_n, psi_n, kappa_n, nu_n


def multigammaln(a: torch.Tensor, d: int) -> torch.Tensor:
    """log of the multivariate gamma function Gamma_d(a), elementwise."""
    j = torch.arange(d, dtype=a.dtype, device=a.device)
    return (d * (d - 1) / 4.0 * math.log(math.pi)
            + torch.lgamma(a[..., None] - 0.5 * j).sum(dim=-1))


def _log_z(psi, kappa, nu, d: int):
    logdet = torch.linalg.slogdet(psi).logabsdet
    return (-0.5 * nu * logdet - 0.5 * d * torch.log(kappa)
            + multigammaln(0.5 * nu, d) + 0.5 * nu * d * math.log(2.0))


def log_marginal(prior: NIWPrior, stats: GaussStats) -> torch.Tensor:
    """log f_x(C; lambda), the marginal likelihood of a point set
    (paper eq. 13; Murphy 2007 eq. 266)."""
    d = prior.m.shape[-1]
    _, psi_n, kappa_n, nu_n = posterior(prior, stats)
    prior_z = _log_z(prior.psi, prior.kappa, prior.nu, d)
    post_z = _log_z(psi_n, kappa_n, nu_n, d)
    return post_z - prior_z - 0.5 * stats.n * d * math.log(2.0 * math.pi)


def _eye_like(m: torch.Tensor) -> torch.Tensor:
    d = m.shape[-1]
    return torch.eye(d, dtype=m.dtype, device=m.device).expand(m.shape)


def sample_posterior(prior: NIWPrior, stats: GaussStats,
                     generator: Optional[torch.Generator] = None, *,
                     chi: Optional[torch.Tensor] = None,
                     normals: Optional[torch.Tensor] = None,
                     z: Optional[torch.Tensor] = None) -> GaussParams:
    """Draw (mu, Sigma) from the NIW posterior, batched.

    Bartlett: Sigma^-1 = (L A)(L A)^T with L = chol(Psi_n^-1), A lower
    triangular with sqrt(chi2(nu_n - i)) on its diagonal and N(0, 1) below.
    ``chi`` (*B, d), ``normals`` (*B, d, d) and ``z`` (*B, d) are the
    chi-square, Bartlett-normal and mean-normal draws; each one not given
    is drawn from ``generator`` in that order.
    """
    m_n, psi_n, kappa_n, nu_n = posterior(prior, stats)
    d = prior.m.shape[-1]
    bshape = tuple(stats.n.shape)
    dev, dt = m_n.device, m_n.dtype
    if chi is None:
        i = torch.arange(d, dtype=dt, device=dev)
        df = torch.clamp(nu_n[..., None] - i, min=1e-3)
        chi = 2.0 * torch._standard_gamma(0.5 * df, generator=generator)
    if normals is None:
        normals = torch.randn(bshape + (d, d), generator=generator,
                              dtype=dt, device=dev)
    if z is None:
        z = torch.randn(bshape + (d,), generator=generator, dtype=dt,
                        device=dev)
    a_diag = torch.sqrt(chi)
    a_mat = torch.tril(normals, diagonal=-1) + torch.diag_embed(a_diag)
    eye = _eye_like(psi_n)
    jitter = (1e-5 * torch.diagonal(psi_n, dim1=-2, dim2=-1).sum(-1)
              [..., None, None] / d)
    c = torch.linalg.cholesky_ex(psi_n + jitter * eye).L
    l_inv_t = torch.linalg.solve_triangular(c.transpose(-1, -2), eye,
                                            upper=True)       # C^-T
    chol_prec = l_inv_t @ a_mat
    logdet_prec = (2.0 * torch.log(torch.abs(a_diag)).sum(-1)
                   - 2.0 * torch.log(torch.diagonal(c, dim1=-2,
                                                    dim2=-1)).sum(-1))
    u = torch.linalg.solve_ex(chol_prec.transpose(-1, -2),
                              z[..., None]).result[..., 0]
    mu = m_n + u / torch.sqrt(kappa_n)[..., None]
    return GaussParams(mu=mu, chol_prec=chol_prec, logdet_prec=logdet_prec)


def expected_params(prior: NIWPrior, stats: GaussStats) -> GaussParams:
    """Posterior-mean parameters (deterministic; used at init)."""
    m_n, psi_n, kappa_n, nu_n = posterior(prior, stats)
    d = prior.m.shape[-1]
    sigma = psi_n / torch.clamp(nu_n - d - 1.0, min=1.0)[..., None, None]
    eye = _eye_like(sigma)
    c = torch.linalg.cholesky_ex(sigma + 1e-6 * eye).L
    f = torch.linalg.solve_triangular(c.transpose(-1, -2), eye, upper=True)
    logdet_prec = -2.0 * torch.log(torch.diagonal(c, dim1=-2,
                                                  dim2=-1)).sum(-1)
    return GaussParams(mu=m_n, chol_prec=f, logdet_prec=logdet_prec)

