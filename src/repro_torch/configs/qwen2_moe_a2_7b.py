"""qwen2-moe-a2.7b — MoE: 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                  # per routed expert
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=60,
        num_shared_experts=4,
        top_k=4,
        d_expert=1408,
        d_shared=5632,          # 4 x 1408
    ),
    act="silu",
    long_context="sliding_window",
    source="Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]",
)
