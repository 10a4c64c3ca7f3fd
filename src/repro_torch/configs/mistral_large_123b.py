"""mistral-large-123b — dense GQA [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    arch_type="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    act="silu",
    long_context="sliding_window",
    source="Mistral-Large-Instruct-2407 [hf:mistralai/Mistral-Large-Instruct-2407]",
)
