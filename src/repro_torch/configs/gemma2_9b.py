"""gemma2-9b — local+global alternating attention, logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig, ATTN, LOCAL_ATTN

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=256000,
    head_dim=256,
    sliding_window=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    tie_embeddings=True,
    pattern=(LOCAL_ATTN, ATTN),     # 21 repeats
    act="gelu",
    long_context="sliding_window",
    source="Gemma 2 [arXiv:2408.00118]",
)
