"""Clustering metrics: NMI (the paper's accuracy metric) and ARI.

Port of ``repro.core.metrics``, computed from the contingency table in
float64 on the labels' device.
"""
from __future__ import annotations

import torch


def contingency(true: torch.Tensor, pred: torch.Tensor, n_true: int,
                n_pred: int) -> torch.Tensor:
    """(n_true, n_pred) float64 co-occurrence counts."""
    flat = true.long() * n_pred + pred.long()
    counts = torch.bincount(flat, minlength=n_true * n_pred)
    return counts.to(torch.float64).reshape(n_true, n_pred)


def _entropy(p: torch.Tensor) -> torch.Tensor:
    p = p[p > 0]
    return -(p * torch.log(p)).sum()


def nmi(true, pred, n_true: int, n_pred: int) -> float:
    """Normalized mutual information, arithmetic normalization."""
    c = contingency(true, pred, n_true, n_pred)
    pij = c / c.sum()
    pi, pj = pij.sum(dim=1), pij.sum(dim=0)
    outer = pi[:, None] * pj[None, :]
    mask = pij > 0
    mi = (pij[mask] * (torch.log(pij[mask]) - torch.log(outer[mask]))).sum()
    denom = 0.5 * (_entropy(pi) + _entropy(pj))
    return float(mi / denom) if float(denom) > 0 else 1.0


def ari(true, pred, n_true: int, n_pred: int) -> float:
    """Adjusted Rand index."""
    c = contingency(true, pred, n_true, n_pred)
    comb2 = lambda v: v * (v - 1.0) / 2.0
    sum_ij = comb2(c).sum()
    a = comb2(c.sum(dim=1)).sum()
    b = comb2(c.sum(dim=0)).sum()
    expected = a * b / comb2(c.sum())
    max_index = 0.5 * (a + b)
    if float(max_index) > float(expected):
        return float((sum_ij - expected) / (max_index - expected))
    return 0.0
