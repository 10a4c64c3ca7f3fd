"""Config registry: ``get_config("<arch-id>")``, reduced smoke variants, and
the DPMM sampler's ``DPMMConfig``.

A copy of ``repro.configs``: the ten arch configs are the reference's data,
``source`` strings included, and ``smoke_config`` cuts them the same way.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ATTN, CROSS, LOCAL_ATTN, RGLRU, SSM,
    DPMMConfig, InputShape, MLAConfig, MoEConfig, ModelConfig, RGLRUConfig,
    SSMConfig,
    INPUT_SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)

_ARCH_MODULES: Dict[str, str] = {
    "granite-8b": "granite_8b",
    "starcoder2-7b": "starcoder2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mistral-large-123b": "mistral_large_123b",
    "whisper-medium": "whisper_medium",
    "gemma2-9b": "gemma2_9b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    cfg: ModelConfig = mod.CONFIG
    cfg.validate()
    return cfg


def first_k_dense(name: str) -> int:
    """How many leading FFNs the arch ``name`` keeps dense: its module's
    ``FIRST_K_DENSE`` (DeepSeek-V2 keeps one), else 0."""
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return int(getattr(mod, "FIRST_K_DENSE", 0))


def smoke_config(name: str) -> ModelConfig:
    """Reduced variant of the same family: 2 layers, d_model<=512, <=4 experts.

    Used by the per-arch CPU tests and ``chip_smoke.py``'s smoke-size
    phases.
    """
    cfg = get_config(name)
    kinds = cfg.layer_kinds
    # keep one period of the pattern (or 2 layers) to preserve heterogeneity
    if cfg.pattern and len(cfg.pattern) <= 4:
        pattern = cfg.pattern
        n_layers = len(pattern)
        remainder: tuple = ()
    elif cfg.pattern:
        # long pattern: keep one layer of each distinct kind (e.g. VLM's
        # (attn x4, cross) -> (attn, cross)), preserving first-seen order
        pattern = tuple(dict.fromkeys(cfg.pattern))
        n_layers = len(pattern)
        remainder = ()
    else:
        pattern = tuple(kinds[:2]) or (ATTN, ATTN)
        n_layers = 2
        remainder = ()
    changes = dict(
        name=cfg.name + "-smoke",
        num_layers=n_layers,
        d_model=256,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=64,
        d_ff=512 if cfg.d_ff else 0,
        vocab_size=512,
        pattern=pattern,
        remainder=remainder,
        sliding_window=64,
        vision_tokens=16 if cfg.vision_tokens else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=24 if cfg.encoder_layers else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, num_shared_experts=1, top_k=2,
            d_expert=128, d_shared=128)
        changes["d_ff"] = 512
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(
            kv_lora_rank=64, q_lora_rank=0, rope_head_dim=32,
            nope_head_dim=32, v_head_dim=64)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, state_dim=8)
    if cfg.rglru is not None:
        changes["rglru"] = dataclasses.replace(cfg.rglru, lru_width=256)
    out = dataclasses.replace(cfg, **changes)
    out.validate()
    return out
