"""Configuration of the port: the LM zoo's architectures and input shapes,
and the DPMM sampler.

``ModelConfig`` and ``InputShape`` are copies of the reference's
(``repro.configs.base``), field for field, so a config compares equal to
the reference's under ``dataclasses.asdict``. ``TrainConfig`` comes with
the training slice.

The port's own copy of the fields of ``repro.configs.base.DPMMConfig`` that
the resident and tiled fits read, with the same names, defaults and
validation, for the four component families (gaussian, diag_gaussian,
multinomial, poisson), ``k_max='auto'``, auto-checkpointing and the
guardrails included. There is no ``use_pallas``: on the card the
hand-written kernels are the path. ``workers`` runs the fit on a
coordinator and that many worker processes (``repro_torch.dist``), with
the reference's deadline, heartbeat and respawn knobs; ``shard_features``
splits the features over a mesh's ``model`` axis
(``core/distributed.py``).
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer-pattern vocabulary (per-layer block kinds, see models/transformer.py)
# ---------------------------------------------------------------------------
ATTN = "attn"            # global self-attention block
LOCAL_ATTN = "local"     # sliding-window self-attention block
CROSS = "cross"          # self-attention + cross-attention block (VLM/enc-dec)
SSM = "ssm"              # Mamba-1 selective-SSM block
RGLRU = "rglru"          # RG-LRU (Griffin) recurrent block


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (None on dense archs)."""
    num_experts: int                 # routed experts
    num_shared_experts: int          # always-on shared experts
    top_k: int
    d_expert: int                    # per-expert FFN hidden dim
    d_shared: int                    # shared-expert FFN hidden dim (total)
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2) sub-config."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 => full-rank q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 sub-config."""
    state_dim: int = 16
    conv_kernel: int = 4
    expand: int = 2
    dt_rank: int = 0                 # 0 => ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RG-LRU (RecurrentGemma) sub-config."""
    lru_width: int = 0               # 0 => d_model
    conv_kernel: int = 4
    block_width: int = 0             # reserved


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture. Defaults describe a vanilla dense LM."""
    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads
    # Layer pattern: repeated `pattern` then `remainder`; len(pattern) *
    # repeats + len(remainder) == num_layers.  Empty pattern => all ATTN.
    pattern: Tuple[str, ...] = ()
    remainder: Tuple[str, ...] = ()
    # Attention details
    rope_theta: float = 10000.0
    sliding_window: int = 4096       # used by LOCAL_ATTN blocks
    logit_softcap: float = 0.0       # gemma2-style attn logit soft-capping
    final_softcap: float = 0.0       # gemma2-style final-logit soft-capping
    qk_norm: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                # silu | gelu
    gated_mlp: bool = True           # SwiGLU-style gate (False: plain 2-mat)
    # Sub-configs (None when not applicable)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # Encoder-decoder (audio) / vision frontends.
    encoder_layers: int = 0          # >0 => enc-dec (whisper)
    encoder_seq: int = 0             # stubbed frontend output length
    vision_tokens: int = 0           # stubbed VLM patch-embedding count
    # Serving
    long_context: str = "none"       # none | sliding_window | native
    # Reference / provenance
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Fully expanded per-layer kind list (length == num_layers)."""
        if not self.pattern:
            kinds: Tuple[str, ...] = (ATTN,) * self.num_layers
        else:
            reps = (self.num_layers - len(self.remainder)) // len(self.pattern)
            kinds = tuple(self.pattern) * reps + tuple(self.remainder)
        assert len(kinds) == self.num_layers, (
            f"{self.name}: pattern does not tile num_layers "
            f"({len(kinds)} != {self.num_layers})")
        return kinds

    @property
    def pattern_repeats(self) -> int:
        if not self.pattern:
            return self.num_layers
        return (self.num_layers - len(self.remainder)) // len(self.pattern)

    def validate(self) -> None:
        assert self.d_model % self.num_heads == 0 or self.head_dim, self.name
        assert self.num_heads % self.num_kv_heads == 0 or self.mla, self.name
        _ = self.layer_kinds


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One assigned (seq_len, global_batch) workload."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


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
    # on a mesh with a 'model' axis, split x's features over it (the
    # feature-separable families: multinomial, poisson, diag_gaussian; a
    # gaussian keeps its features whole)
    shard_features: bool = False
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
    # elastic multi-process fits (repro_torch.dist): workers=N spawns N
    # worker processes, each streaming STATS_BLOCK-aligned row ranges of
    # x; the coordinator keeps the model and folds their per-block stat
    # partials in global block order, so the chain is the single-process
    # tiled fit's bit for bit at any worker count. A work item that misses
    # worker_deadline_s gets its worker killed and its rows requeued; a
    # slot is respawned at most max_worker_retries times
    workers: Optional[int] = None
    worker_deadline_s: float = 120.0
    worker_heartbeat_s: float = 0.5
    max_worker_retries: int = 2
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
        if self.workers is not None:
            positive("workers", self.workers)
            if self.k_max == "auto":
                raise ValueError(
                    "DPMMConfig.workers requires a fixed integer k_max: "
                    "the growable slab re-plans shapes mid-fit, which the "
                    "worker protocol does not ship")
            if self.shard_features:
                raise ValueError(
                    "DPMMConfig.workers does not compose with "
                    "shard_features yet: worker shards split rows, not "
                    "columns")
        if self.worker_deadline_s <= 0 or self.worker_heartbeat_s <= 0:
            raise ValueError(
                "DPMMConfig.worker_deadline_s/worker_heartbeat_s must be "
                f"> 0, got {self.worker_deadline_s}/"
                f"{self.worker_heartbeat_s}")
        if self.max_worker_retries < 0:
            raise ValueError(
                f"DPMMConfig.max_worker_retries must be >= 0, got "
                f"{self.max_worker_retries}")
