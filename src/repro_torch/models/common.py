"""Shared model-building blocks: norms, MLPs, RoPE, embeddings.

The port of ``repro.models.common`` for one device. Conventions:

 - Parameters live in ``nn.Module``s, in the reference's layouts: a
   projection is ``(d_in, d_out)`` (``(d, h, hd)`` / ``(h, hd, d)`` for
   attention), so ``models.transformer.params_from_jax`` copies a reference
   tree leaf for leaf.
 - Every product accumulates in float32 and keeps its float32 result until
   the reference rounds it (``preferred_element_type=f32`` then
   ``astype``): ``dot`` does that for every parameter dtype.
 - Random initialisation draws from an explicit ``torch.Generator``; the
   draws are not the reference's (its ``jax.random`` stream), so parity
   tests carry the reference's parameters across.

The reference's ``ShardingPolicy``, ``constrain`` and ``spec_*`` functions
place tensors on a device mesh; on one card they do nothing, and they come
with the multi-card slice (ROADMAP.md §1).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------
def dense_init(gen: Optional[torch.Generator], shape: Tuple[int, ...],
               dtype, in_axis: int = -2, device=None) -> torch.Tensor:
    """LeCun-normal (fan-in) init; ``gen=None`` leaves the tensor empty
    (to be filled from a reference tree)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(1.0 / math.sqrt(shape[in_axis])).to(dtype)


def embed_init(gen: Optional[torch.Generator], shape: Tuple[int, ...],
               dtype, device=None) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(0.02).to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    """A serving parameter (no gradient until the training slice)."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------
def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over x's last axis, accumulated and returned in float32
    (the reference's ``einsum(..., preferred_element_type=f32)``).

    float32 operands multiply as they are; a lower-precision pair on the
    card goes to cuBLAS with a float32 output (no rounding of the result to
    the operands' dtype); elsewhere both are widened first."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return x @ w
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype == w.dtype:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(*lead, w.shape[-1])


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
class RMSNorm(nn.Module):
    """gemma-style RMSNorm: ``x / rms(x) * (1 + scale)``, scale zero-init."""

    def __init__(self, d: int, dtype, device=None):
        super().__init__()
        self.scale = param(torch.zeros((d,), dtype=dtype, device=device))


def init_rmsnorm(d: int, dtype, device=None) -> RMSNorm:
    return RMSNorm(d, dtype, device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Computed in float32, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return functools.partial(F.gelu, approximate="tanh")
    raise ValueError(name)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU-style or plain 2-matrix)
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool, dtype,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.up = param(dense_init(gen, (d_model, d_ff), dtype,
                                   device=device))
        self.down = param(dense_init(gen, (d_ff, d_model), dtype,
                                     device=device))
        self.gate = (param(dense_init(gen, (d_model, d_ff), dtype,
                                      device=device)) if gated else None)


def init_mlp(gen, d_model: int, d_ff: int, gated: bool, dtype,
             device=None) -> MLP:
    return MLP(d_model, d_ff, gated, dtype, gen, device)


def mlp(x: torch.Tensor, p: MLP, act: str) -> torch.Tensor:
    f = activation(act)
    h = dot(x, p.up)
    if p.gate is not None:
        h = f(dot(x, p.gate)) * h
    else:
        h = f(h)
    h = h.to(x.dtype)
    return dot(h, p.down).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split, not interleaved)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))          # (head_dim/2,)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the rotation angles, (..., S, hd/2) for positions
    (..., S): what ``apply_rope`` computes first. A decode step makes it
    once for all its layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               table: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """x: (..., S, H, hd) or (..., S, hd); positions: broadcastable (S,);
    ``table``: ``rope_table(positions, hd, theta)`` if already made."""
    cos, sin = table or rope_table(positions, x.shape[-1], theta)
    if x.dim() >= cos.dim() + 2:                    # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]   # (..., S, 1, hd/2)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
class Embed(nn.Module):
    """The token table, and the output head unless it is tied."""

    def __init__(self, vocab: int, d_model: int, tie: bool, dtype,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.tok = param(embed_init(gen, (vocab, d_model), dtype, device))
        self.head = (None if tie else
                     param(dense_init(gen, (d_model, vocab), dtype,
                                      device=device)))


def init_embed(gen, vocab: int, d_model: int, tie: bool, dtype,
               device=None) -> Embed:
    return Embed(vocab, d_model, tie, dtype, gen, device)


def embed(tokens: torch.Tensor, p: Embed) -> torch.Tensor:
    return F.embedding(tokens, p.tok)


def unembed(x: torch.Tensor, p: Embed, final_cap: float = 0.0
            ) -> torch.Tensor:
    """float32 logits; the tied head is ``tok.T``."""
    w = p.tok.T if p.head is None else p.head
    return softcap(dot(x, w), final_cap)
