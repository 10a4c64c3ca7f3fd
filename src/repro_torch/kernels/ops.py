"""Dispatch between each kernel and its plain PyTorch version.

A tensor on the CPU goes to the plain version (the tests' path). A CUDA
tensor goes to the hand-written kernel, which raises on a shape or type it
does not take: there is no fallback to the plain version, to the CPU or to
a library kernel on the card. Any other device raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import suffstats as _suffstats
from repro_torch.kernels import sweep as _sweep


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


# every kernel wrapper, by kernel name
_CUDA = {"sweep_gauss": _sweep.sweep_gauss_cuda,
         "suffstats_labels": _suffstats.suffstats_labels_cuda,
         "sweep_linear": _sweep.sweep_linear_cuda,
         "moments_labels": _suffstats.moments_labels_cuda}


def launch_counts() -> dict:
    """Launches of every kernel wrapper since its count was last reset."""
    return {name: fn.launches for name, fn in _CUDA.items()}


def reset_launch_counts() -> None:
    for fn in _CUDA.values():
        fn.launches = 0
