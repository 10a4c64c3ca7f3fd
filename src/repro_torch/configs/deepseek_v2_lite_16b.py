"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE 64e top-6, 2 shared [arXiv:2405.04434].

Layer 0 uses a dense FFN (first_k_dense=1), layers 1..26 are MoE —
matching the published DeepSeek-V2-Lite layout (the assignment's
"2 shared + 160 routed" figure describes full V2; Lite has 64 routed,
consistent with the assignment's own "MoE 64e top-6").
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,            # unused with MLA
    d_ff=10944,                 # layer-0 dense FFN width
    vocab_size=102400,
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        d_expert=1408,
        d_shared=2816,          # 2 x 1408
    ),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    act="silu",
    long_context="sliding_window",
    source="DeepSeek-V2(-Lite) [arXiv:2405.04434]",
)
FIRST_K_DENSE = 1
