"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2 [arXiv:2402.19427]."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, RGLRU, LOCAL_ATTN

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,             # MQA
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    tie_embeddings=True,   # gemma-family tied unembedding
    sliding_window=2048,
    # (rec, rec, attn) x 8 + (rec, rec) = 26 layers
    pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    remainder=(RGLRU, RGLRU),
    rglru=RGLRUConfig(lru_width=2560, conv_kernel=4),
    act="gelu",
    long_context="native",      # recurrent state + bounded-window KV
    source="RecurrentGemma / Griffin [arXiv:2402.19427]",
)
