"""Model zoo: the dense-attention LM stacks (port of ``repro.models``).

Public surface:
    transformer.init_params / params_from_jax / forward / hidden_forward
    decode.init_cache / decode_step
"""
from repro_torch.models import attention, common, decode, transformer  # noqa: F401
