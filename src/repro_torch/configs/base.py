"""Configuration of the port's DPMM sampler.

The port's own copy of the fields of ``repro.configs.base.DPMMConfig`` that
the resident and tiled fits read, with the same names, defaults and
validation, for the four component families (gaussian, diag_gaussian,
multinomial, poisson), ``k_max='auto'``, auto-checkpointing and the
guardrails included. There is no ``use_pallas``: on the card the
hand-written kernels are the path. ``workers`` (multi-process fits) is
not ported (ROADMAP.md §1 item 6).
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DPMMConfig:
    """Hyper-parameters of the sub-cluster split/merge DPMM sampler."""
    component: str = "gaussian"       # core.family registry key
    alpha: float = 10.0               # DP concentration
    # static slot capacity, or the string 'auto' (resident plane only):
    # the slab starts at max(8, 2 * init_clusters) slots and doubles at
    # log_every chunk boundaries while the live count exceeds half of it,
    # up to k_max_cap
    k_max: object = 64
    k_max_cap: int = 4096
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
    # data plane: None = resident (points on the device for the whole
    # fit); an int streams the points from the DataSource in tiles of about
    # this many rows (rounded up to STATS_BLOCK): device memory is
    # O(k_max + tile_size). Chains are bitwise equal across planes and
    # tile sizes.
    tile_size: Optional[int] = None
    # tiled reads: transient IOError / short-read and, with guard_tiles,
    # NaN/Inf-row faults of DataSource.read_block are retried up to
    # io_retries times with io_backoff_s exponential backoff, then raise
    # TileReadError with the tile's rows
    io_retries: int = 3
    io_backoff_s: float = 0.05
    guard_tiles: bool = True
    # auto-checkpointing: a rotation of {checkpoint_path}-{it:08d}.npz
    # members (core/checkpoint.save_checkpoint, the newest checkpoint_keep
    # kept), saved once checkpoint_every iterations have passed since the
    # last save (resident: at log_every chunk boundaries; tiled: after each
    # iteration); fit(resume=True) continues from the newest that verifies
    checkpoint_path: Optional[str] = None
    checkpoint_every: Optional[int] = None
    checkpoint_keep: int = 3
    # guardrails: the model's health (core/resilience.model_health) read
    # with each chunk's (resident) or iteration's (tiled) history; on a bad
    # verdict the fit goes back to the last healthy state with its key
    # advanced, at most max_recoveries times, then raises DivergenceError
    guardrails: bool = True
    max_recoveries: int = 3
    seed: int = 0

    def __post_init__(self):
        def positive(name, value):
            if (isinstance(value, bool)
                    or not isinstance(value, numbers.Integral) or value <= 0):
                raise ValueError(f"DPMMConfig.{name} must be a positive "
                                 f"int, got {value!r}")
        if self.k_max == "auto":
            if self.tile_size is not None:
                raise ValueError(
                    "DPMMConfig.k_max='auto' requires the resident data "
                    "plane (tile_size=None): the tiled fit has no chunk "
                    "boundary to grow the slab at")
            positive("k_max_cap", self.k_max_cap)
            cap = self.k_max_cap
        else:
            positive("k_max", self.k_max)
            cap = self.k_max
        for name in ("init_clusters", "log_every", "k_block",
                     "subreset_every"):
            positive(name, getattr(self, name))
        if self.tile_size is not None:
            positive("tile_size", self.tile_size)
        if self.init_clusters > cap:
            raise ValueError(
                f"DPMMConfig.init_clusters ({self.init_clusters}) exceeds "
                f"k_max ({cap})")
        if self.iters < 0 or self.burnout < 0:
            raise ValueError(
                f"DPMMConfig.iters/burnout must be >= 0, got "
                f"iters={self.iters} burnout={self.burnout}")
        if self.checkpoint_every is not None:
            positive("checkpoint_every", self.checkpoint_every)
            if not self.checkpoint_path:
                raise ValueError(
                    "DPMMConfig.checkpoint_every is set but "
                    "checkpoint_path is not: auto-checkpointing needs a "
                    "rotation prefix to write to")
        positive("checkpoint_keep", self.checkpoint_keep)
        if self.io_retries < 0 or self.io_backoff_s < 0:
            raise ValueError(
                f"DPMMConfig.io_retries/io_backoff_s must be >= 0, got "
                f"{self.io_retries}/{self.io_backoff_s}")
        if self.max_recoveries < 0:
            raise ValueError(
                f"DPMMConfig.max_recoveries must be >= 0, got "
                f"{self.max_recoveries}")
