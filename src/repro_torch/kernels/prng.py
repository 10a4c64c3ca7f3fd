"""Counter-based Threefry-2x32 and Gumbel noise in plain PyTorch.

The plain twin of ``csrc/threefry.cuh`` (the device version every kernel
includes) and the port of ``repro.kernels.prng``. Per-(point, cluster)
noise is a pure function of ``(key words, global point index, slot id)``:

    bits = threefry2x32(key, counter=(global_index, slot))[0]
    u    = ((bits >> 8) + 0.5) * 2^-24
    g    = -log(-log(u))

PyTorch on the CPU has no uint32 ``add``, ``<<`` or ``>>``, so the words
are held in int64 tensors and every sum is masked with ``& 0xFFFFFFFF``;
the bits equal JAX's exactly. Everything broadcasts: pass
``c0 = gidx[:, None]`` and ``c1 = slots[None, :]`` for an (N, K) draw.
"""
from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, c0, c1) -> Tuple[torch.Tensor, torch.Tensor]:
    """20-round Threefry-2x32 of counter (c0, c1) under key (k0, k1).

    Inputs are int64 tensors (or ints) holding uint32 values; they
    broadcast. Returns the two output words as int64 in [0, 2^32).
    """
    x0 = (c0 + k0) & MASK
    x1 = (c1 + k1) & MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) -> float32 uniform in (0, 1].

    The top 24 bits plus half a step, times 2^-24: (2^24 - 1 + 0.5) * 2^-24
    rounds to 1.0 in float32, so bits >= 0xFFFFFF00 (one draw in 2^24)
    give u == 1.0 and a +inf Gumbel. The reference does the same; the bits
    are kept equal to it (ROADMAP.md, faults)."""
    top = (bits >> 8).to(torch.float32)
    return (top + 0.5) * (1.0 / (1 << 24))


def gumbel(key: torch.Tensor, c0: torch.Tensor,
           c1: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise keyed by ``key`` ((2,) int64 words) at
    counters (c0, c1); broadcasts."""
    b0, _ = threefry2x32(key[0], key[1], c0, c1)
    return -torch.log(-torch.log(uniform01(b0)))


def key_words(generator: torch.Generator, device) -> torch.Tensor:
    """Two fresh uint32 key words (as a (2,) int64 tensor on ``device``)
    drawn from ``generator`` — one draw, so a seed fixes the stream."""
    return torch.randint(0, 1 << 32, (2,), generator=generator,
                         device=device, dtype=torch.int64)
