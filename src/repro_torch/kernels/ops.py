"""Dispatch between each kernel and its plain PyTorch version.

A tensor on the CPU goes to the plain version (the tests' path). A CUDA
tensor goes to the hand-written kernel, which raises on a shape or type it
does not take: there is no fallback to the plain version, to the CPU or to
a library kernel on the card. Any other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import assign as _assign
from repro_torch.kernels import fold as _fold
from repro_torch.kernels import loglik as _loglik
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import suffstats as _suffstats
from repro_torch.kernels import sweep as _sweep
from repro_torch.kernels.matmul import MATMUL_CROSSOVER


def _route(x: torch.Tensor, cuda, plain):
    if x.device.type == "cuda":
        return cuda
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no kernel for device {x.device}: the port runs on "
                     "'cuda' (kernels) or 'cpu' (plain versions)")


def sweep_gauss(x, mu, chol_prec, logdet_prec, logw, active, sub_mu,
                sub_chol_prec, sub_logdet_prec, sublogw, valid, gidx, key_z,
                key_zb, slots):
    """Fused steps (e) + (f) + per-STATS_BLOCK stat partials
    (``kernels/sweep.py``)."""
    fn = _route(x, _sweep.sweep_gauss_cuda, _sweep.sweep_gauss_plain)
    return fn(x, mu, chol_prec, logdet_prec, logw, active, sub_mu,
              sub_chol_prec, sub_logdet_prec, sublogw, valid, gidx, key_z,
              key_zb, slots)


def suffstats_labels(x, labels, sublabels, valid, k: int):
    """Per-STATS_BLOCK sub-cluster stat partials from int labels
    (``kernels/suffstats.py``)."""
    fn = _route(x, _suffstats.suffstats_labels_cuda,
                _suffstats.suffstats_labels_plain)
    return fn(x, labels, sublabels, valid, k)


def sweep_linear(feats, w, const, logw, active, subw, subconst, sublogw,
                 valid, gidx, key_z, key_zb, slots):
    """Fused steps (e) + (f) + per-STATS_BLOCK first-moment partials for
    the linear families (``kernels/sweep.py``)."""
    fn = _route(feats, _sweep.sweep_linear_cuda, _sweep.sweep_linear_plain)
    return fn(feats, w, const, logw, active, subw, subconst, sublogw, valid,
              gidx, key_z, key_zb, slots)


def moments_labels(feats, labels, sublabels, valid, k: int):
    """Per-STATS_BLOCK n / first-moment partials from int labels
    (``kernels/suffstats.py``)."""
    fn = _route(feats, _suffstats.moments_labels_cuda,
                _suffstats.moments_labels_plain)
    return fn(feats, labels, sublabels, valid, k)


def fold_partials(acc, parts):
    """``acc`` plus the (nb, *acc.shape) partials, added left to right in
    block order (``kernels/fold.py``)."""
    fn = _route(acc, _fold.fold_partials_cuda, _fold.fold_partials_plain)
    return fn(acc, parts.contiguous())


def suffstats(x, resp):
    """n, sx, sxx from dense (N, K) responsibilities, the oracle of
    ``repro.kernels.ops.suffstats_pallas`` (``kernels/suffstats.py``)."""
    fn = _route(x, _suffstats.suffstats_cuda, _suffstats.suffstats_plain)
    return fn(x, resp)


def loglik_gauss(x, mu, chol_prec, logdet_prec):
    """(N, K) Gaussian log-likelihoods (``kernels/loglik.py``)."""
    fn = _route(x, _loglik.loglik_cuda, _loglik.loglik_plain)
    return fn(x, mu, chol_prec, logdet_prec)


def assign_gauss(x, mu, chol_prec, logdet_prec, logw, active, gidx, key_z,
                 slots):
    """Step (e) alone, full-covariance Gaussian (``kernels/assign.py``)."""
    fn = _route(x, _assign.assign_gauss_cuda, _assign.assign_gauss_plain)
    return fn(x, mu, chol_prec, logdet_prec, logw, active, gidx, key_z,
              slots)


def assign_linear(feats, w, const, logw, active, gidx, key_z, slots):
    """Step (e) alone, linear families (``kernels/assign.py``)."""
    fn = _route(feats, _assign.assign_linear_cuda,
                _assign.assign_linear_plain)
    return fn(feats, w, const, logw, active, gidx, key_z, slots)


def sub_assign_gauss(x, sub_mu, sub_chol_prec, sub_logdet_prec, sublogw,
                     labels, gidx, key_zb):
    """Step (f) alone, full-covariance Gaussian (``kernels/assign.py``)."""
    fn = _route(x, _assign.sub_assign_gauss_cuda,
                _assign.sub_assign_gauss_plain)
    return fn(x, sub_mu, sub_chol_prec, sub_logdet_prec, sublogw, labels,
              gidx, key_zb)


def sub_assign_linear(feats, subw, subconst, sublogw, labels, gidx, key_zb):
    """Step (f) alone, linear families (``kernels/assign.py``)."""
    fn = _route(feats, _assign.sub_assign_linear_cuda,
                _assign.sub_assign_linear_plain)
    return fn(feats, subw, subconst, sublogw, labels, gidx, key_zb)


def matmul(a, b):
    """(M, K) @ (K, N) through the blocked kernel (``kernels/matmul.py``)."""
    fn = _route(a, _matmul.matmul_cuda, _matmul.matmul_plain)
    return fn(a.contiguous(), b.contiguous())


def matmul_auto(a, b):
    """The paper's size-dispatched product: the blocked kernel while the
    left operand has fewer than ``MATMUL_CROSSOVER`` elements (its d N
    measure), ``torch.matmul`` above, as
    ``repro.kernels.ops.matmul_auto``."""
    if a.shape[0] * a.shape[1] < MATMUL_CROSSOVER:
        return matmul(a, b)
    return torch.matmul(a, b)


# every kernel wrapper, by kernel name
_CUDA = {"sweep_gauss": _sweep.sweep_gauss_cuda,
         "suffstats_labels": _suffstats.suffstats_labels_cuda,
         "sweep_linear": _sweep.sweep_linear_cuda,
         "moments_labels": _suffstats.moments_labels_cuda,
         "loglik_gauss": _loglik.loglik_cuda,
         "assign_gauss": _assign.assign_gauss_cuda,
         "assign_linear": _assign.assign_linear_cuda,
         "matmul": _matmul.matmul_cuda,
         "sub_assign_gauss": _assign.sub_assign_gauss_cuda,
         "sub_assign_linear": _assign.sub_assign_linear_cuda,
         "fold_partials": _fold.fold_partials_cuda,
         "suffstats": _suffstats.suffstats_cuda}


def launch_counts() -> dict:
    """Launches of every kernel wrapper since its count was last reset."""
    return {name: fn.launches for name, fn in _CUDA.items()}


def reset_launch_counts() -> None:
    for fn in _CUDA.values():
        fn.launches = 0
