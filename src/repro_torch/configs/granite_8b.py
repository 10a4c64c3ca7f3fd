"""granite-8b — dense llama-arch code model [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    arch_type="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    head_dim=128,
    rope_theta=10_000_000.0,
    act="silu",
    long_context="sliding_window",
    source="IBM Granite Code Models [arXiv:2405.04324]",
)
