"""Configuration of the port's DPMM sampler.

The port's own copy of the fields of ``repro.configs.base.DPMMConfig`` that
the resident fit reads, with the same names and defaults, for the four
component families (gaussian, diag_gaussian, multinomial, poisson). There
is no ``use_pallas``: on the card the hand-written kernels are the path.
"""
from __future__ import annotations

import dataclasses
import numbers


@dataclasses.dataclass(frozen=True)
class DPMMConfig:
    """Hyper-parameters of the sub-cluster split/merge DPMM sampler."""
    component: str = "gaussian"       # core.family registry key
    alpha: float = 10.0               # DP concentration
    k_max: int = 64                   # static slot capacity
    init_clusters: int = 1
    iters: int = 100
    burnout: int = 15                 # no splits/merges before this iter
    log_every: int = 10               # iterations per history sync
    subreset_every: int = 10          # re-init sub-labels after this many
    #                                   consecutive rejected splits
    # NIW prior: m is the data mean, Psi = niw_psi * I, nu = d + nu_extra
    niw_kappa: float = 1.0
    niw_nu_extra: float = 3.0
    niw_psi: float = 1.0
    # Dirichlet prior (multinomial)
    dir_alpha: float = 1.0
    # Gamma prior (poisson)
    gamma_a0: float = 1.0
    gamma_b0: float = 1.0
    # NIG prior (diag_gaussian); m is the data mean
    nig_kappa: float = 1.0
    nig_a0: float = 2.0
    nig_b0: float = 0.5
    # sweep and split/merge stat fold on a compact slab of the live
    # clusters (O(K_active) per-point work instead of O(k_max))
    compact: bool = True
    k_block: int = 8                  # least compact slab size
    seed: int = 0

    def __post_init__(self):
        if self.k_max == "auto":
            raise NotImplementedError(
                "k_max='auto' is not ported yet (ROADMAP.md, multi-chain "
                "and k_max='auto' item): pass an integer k_max")

        def positive(name, value):
            if (isinstance(value, bool)
                    or not isinstance(value, numbers.Integral) or value <= 0):
                raise ValueError(f"DPMMConfig.{name} must be a positive "
                                 f"int, got {value!r}")
        for name in ("k_max", "init_clusters", "log_every", "k_block",
                     "subreset_every"):
            positive(name, getattr(self, name))
        if self.init_clusters > self.k_max:
            raise ValueError(
                f"DPMMConfig.init_clusters ({self.init_clusters}) exceeds "
                f"k_max ({self.k_max})")
        if self.iters < 0 or self.burnout < 0:
            raise ValueError(
                f"DPMMConfig.iters/burnout must be >= 0, got "
                f"iters={self.iters} burnout={self.burnout}")
