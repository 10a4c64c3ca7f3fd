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

Key derivation (``fold_in``, ``split``) gives the key data of
``jax.random.fold_in`` and ``jax.random.split`` under partitionable
Threefry (``jax_threefry_partitionable``, the default since JAX 0.5):

    fold_in(key, d)  = threefry2x32(key, (0, d mod 2^32))
    split(key, n)[i] = threefry2x32(key, (0, i))

both output words. A chain's keys are these pairs of Python ints; a draw
that is not a Threefry word (gamma, normal, uniform) comes from a
``torch.Generator`` seeded from its key's 64 bits (``generator``:
``key[0] * 2^32 + key[1]``), made for that draw alone.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

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



Words = Tuple[int, int]


def words_of(key: Union[torch.Tensor, Sequence[int]]) -> Words:
    """A key's two uint32 words as Python ints, from a (2,) tensor, array
    or sequence."""
    if isinstance(key, torch.Tensor):
        key = key.tolist()
    k0, k1 = (int(v) & MASK for v in key)
    return k0, k1


def fold_in(key, data: int) -> Words:
    """``jax.random.fold_in(key, data)``'s key data: ``data`` is taken mod
    2^32, so a negative fold is JAX's of ``jnp.int32(data)``."""
    k0, k1 = words_of(key)
    return threefry2x32(k0, k1, 0, int(data) & MASK)


def split(key, n: int) -> List[Words]:
    """``jax.random.split(key, n)``'s key data, row by row."""
    k0, k1 = words_of(key)
    return [threefry2x32(k0, k1, 0, i) for i in range(n)]


def key_tensor(key, device) -> torch.Tensor:
    """A key's words as the (2,) int64 tensor the kernels read."""
    return torch.tensor(words_of(key), dtype=torch.int64, device=device)


def generator(key, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the key's 64 bits
    (first word high)."""
    k0, k1 = words_of(key)
    return torch.Generator(device=device).manual_seed((k0 << 32) | k1)
