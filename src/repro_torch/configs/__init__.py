from repro_torch.configs.base import DPMMConfig

__all__ = ["DPMMConfig"]
