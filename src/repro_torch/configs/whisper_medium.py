"""whisper-medium — encoder-decoder audio model [arXiv:2212.04356].

Backbone only; the mel-spectrogram + conv frontend is stubbed per the
carve-out: ``input_specs()`` provides precomputed frame embeddings
(1500 frames). 24 encoder + 24 decoder layers.

``long_500k`` is SKIPPED for this arch: the decoder is specified for <=448
target positions and cross-attends to a <=1500-frame encoder output; a 524k
decoder self-attention cache is architecturally meaningless (DESIGN §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    num_layers=24,              # decoder layers
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    gated_mlp=False,
    long_context="none",
    source="Whisper [arXiv:2212.04356]",
)
