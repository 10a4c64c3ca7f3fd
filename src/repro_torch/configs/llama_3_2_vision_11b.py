"""llama-3.2-vision-11b — VLM with interleaved cross-attention layers.

Backbone only; the ViT encoder + projector is stubbed per the carve-out:
``input_specs()`` provides precomputed patch embeddings (1601 tokens).
[hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.configs.base import ModelConfig, ATTN, CROSS

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    rope_theta=500_000.0,
    # cross-attention block every 5th layer (8 of 40)
    pattern=(ATTN, ATTN, ATTN, CROSS, ATTN),
    vision_tokens=1601,
    act="silu",
    long_context="sliding_window",
    source="Llama 3.2 Vision [hf:meta-llama/Llama-3.2-11B-Vision]",
)
