"""Synthetic Gaussian-mixture data, the port's own copy of
``repro.data.synthetic.generate_gmm``: pure numpy, so the same seed gives
the same arrays in both packages."""
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
