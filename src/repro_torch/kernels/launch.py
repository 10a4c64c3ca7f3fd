"""How a wrapper hands its tensors to a built kernel: the checks every
wrapper makes on a CUDA argument, and the call on the device's current
stream. Every ``*_cuda`` wrapper of ``repro_torch.kernels`` launches
through ``launch``."""
from __future__ import annotations

import torch


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
               device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(fn, dev: torch.device, *args) -> None:
    """``fn(*args, stream)`` with ``dev``'s current stream, entering the
    device's context only when ``dev`` is not the current device. The
    stream handle comes from ``torch._C._cuda_getCurrentRawStream``, the
    call PyTorch's own generated kernels launch with: a context manager
    and a ``torch.cuda.Stream`` object a call are host time that every
    call of a small kernel pays (the serving ``matmul``'s single call is
    mostly host time, PERF.md §6)."""
    idx = dev.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            fn(*args, stream)
