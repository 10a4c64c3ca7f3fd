"""Synthetic mixture data, the port's own copy of
``repro.data.synthetic``: pure numpy, so the same seed gives the same
arrays in both packages.

``generate_gmm``  : Gaussian mixture (gaussian, diag_gaussian fits);
``generate_mnmm`` : multinomial mixture of count vectors (multinomial);
``generate_pmm``  : Poisson mixture of count vectors (poisson).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def generate_gmm(n: int, d: int, k: int, seed: int = 0,
                 sep: float = 6.0) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n,d) float32, labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    means = rng.normal(0.0, sep, size=(k, d))
    # random SPD covariances with eigenvalues in [0.3, 1.3]
    covs = np.zeros((k, d, d))
    for j in range(k):
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        eig = rng.uniform(0.3, 1.3, size=(d,))
        covs[j] = (q * eig) @ q.T
    weights = rng.dirichlet(np.full(k, 5.0))
    labels = rng.choice(k, size=n, p=weights).astype(np.int32)
    x = np.empty((n, d), np.float32)
    for j in range(k):
        idx = np.nonzero(labels == j)[0]
        if idx.size:
            l_chol = np.linalg.cholesky(covs[j])
            z = rng.normal(size=(idx.size, d))
            x[idx] = (means[j] + z @ l_chol.T).astype(np.float32)
    return x, labels


def generate_mnmm(n: int, d: int, k: int, seed: int = 0,
                  trials: int = 50, concentration: float = 0.2
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Multinomial mixture: each point is a count vector of ``trials``
    draws from its cluster's sparse probability vector."""
    rng = np.random.default_rng(seed)
    thetas = rng.dirichlet(np.full(d, concentration), size=k)
    weights = rng.dirichlet(np.full(k, 5.0))
    labels = rng.choice(k, size=n, p=weights).astype(np.int32)
    x = np.empty((n, d), np.float32)
    for j in range(k):
        idx = np.nonzero(labels == j)[0]
        if idx.size:
            x[idx] = rng.multinomial(trials, thetas[j], size=idx.size)
    return x, labels


def generate_pmm(n: int, d: int, k: int, seed: int = 0,
                 rate_scale: float = 20.0) -> Tuple[np.ndarray, np.ndarray]:
    """Poisson mixture: each cluster has per-feature rates
    ``rate_scale * d * Dir(0.5)``."""
    rng = np.random.default_rng(seed)
    rates = rng.dirichlet(np.full(d, 0.5), size=k) * rate_scale * d
    weights = rng.dirichlet(np.full(k, 5.0))
    labels = rng.choice(k, size=n, p=weights).astype(np.int32)
    x = rng.poisson(rates[labels]).astype(np.float32)
    return x, labels
