"""Self-attention blocks: GQA (RoPE, sliding window, soft-cap) over a whole
sequence, and one-token cached decoding.

The port of ``repro.models.attention`` for the ``ATTN`` and ``LOCAL_ATTN``
kinds. The whole-sequence path is the reference's blockwise online
softmax, a Python loop over KV chunks of ``kv_chunk`` tokens in plain
PyTorch: the (S, S) score matrix never materializes, and the sums run in
the reference's order (chunk by chunk, the running max and sum rescaled).
Decode attends one query token against a cache that is updated in place;
a cache shorter than the sequence is a ring (slot ``pos mod cache_len``).

Cross-attention (``cross_attention``, ``init_cross_cache``,
``decode_cross_attention``) comes with the cross / encoder-decoder slice
(ROADMAP.md §1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import apply_rope, dense_init, dot, param, softcap

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """GQA projections in the reference's layouts: ``wq`` (d, h, hd),
    ``wk`` / ``wv`` (d, kv, hd), ``wo`` (h, hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.num_heads, cfg.num_kv_heads
        self.wq = param(dense_init(gen, (d, h, hd), dtype, 0, device))
        self.wk = param(dense_init(gen, (d, kv, hd), dtype, 0, device))
        self.wv = param(dense_init(gen, (d, kv, hd), dtype, 0, device))
        self.wo = param(dense_init(gen, (h, hd, d), dtype, 1, device))
        if cfg.qk_norm:
            self.q_norm = common.init_rmsnorm(hd, dtype, device)
            self.k_norm = common.init_rmsnorm(hd, dtype, device)
        else:
            self.q_norm = self.k_norm = None


def init_attn(gen, cfg: ModelConfig, dtype, device=None) -> Attention:
    return Attention(cfg, dtype, gen, device)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") in float32, rounded to x's dtype."""
    d, h, k = w.shape
    return dot(x, w.reshape(d, h * k)).to(x.dtype).reshape(
        *x.shape[:-1], h, k)


def _out(o: torch.Tensor, wo: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") in float32, rounded to ``dtype``."""
    h, k, d = wo.shape
    return dot(o.reshape(*o.shape[:-2], h * k),
               wo.reshape(h * k, d)).to(dtype)


def _project_qkv(x: torch.Tensor, kv_src: torch.Tensor, p: Attention,
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _heads(x, p.wq)
    k = _heads(kv_src, p.wk)
    v = _heads(kv_src, p.wv)
    if cfg.qk_norm:
        q = common.rmsnorm(q, p.q_norm.scale, cfg.norm_eps)
        k = common.rmsnorm(k, p.k_norm.scale, cfg.norm_eps)
    return q, k, v


# ---------------------------------------------------------------------------
# Blockwise (online-softmax) attention — the prefill path
# ---------------------------------------------------------------------------
def _blockwise_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int, cap: float,
                    q_offset: int = 0, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd). Returns (B, Sq, H, hd).

    Loops over KV chunks keeping (out_acc, row_max, row_sum), all float32;
    K and V are zero-padded to whole chunks and the padding masked, as in
    the reference. GQA repeats K/V to the H query heads inside the step.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    group = h // kvh
    scale = hd ** -0.5
    kv_chunk = min(kv_chunk, skv)
    n_chunks = -(-skv // kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_pos = (torch.arange(sq, device=dev) + q_offset)[None, :, None, None]
    qf = q.float()
    out = torch.zeros((b, sq, h, hdv), dtype=torch.float32, device=dev)
    m = torch.full((b, sq, h), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, h), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kb = k[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        vb = v[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        if group > 1:
            kb = torch.repeat_interleave(kb, group, dim=2)
            vb = torch.repeat_interleave(vb, group, dim=2)
        s = torch.einsum("bqhk,bchk->bqhc", qf, kb.float()) * scale
        s = softcap(s, cap)
        kv_pos = (ci * kv_chunk + torch.arange(kv_chunk, device=dev)
                  )[None, None, None, :]
        mask = kv_pos < skv
        if causal:
            mask = mask & (kv_pos <= q_pos)
        if window:
            mask = mask & (kv_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bqhc,bchk->bqhk", p.to(vb.dtype).float(),
                          vb.float())
        out = out * corr[..., None] + pv
        m = m_new
    out = out / torch.clamp_min(l[..., None], 1e-30)
    return out.to(q.dtype)


def self_attention(x: torch.Tensor, p: Attention, cfg: ModelConfig, *,
                   local: bool, causal: bool = True,
                   positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence self-attention (prefill). x: (B, S, d)."""
    q, k, v = _project_qkv(x, x, p, cfg)
    pos = (torch.arange(x.shape[1], device=x.device) if positions is None
           else positions)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    window = cfg.sliding_window if local else 0
    out = _blockwise_attn(q, k, v, causal=causal, window=window,
                          cap=cfg.logit_softcap)
    return _out(out, p.wo, x.dtype)


# ---------------------------------------------------------------------------
# Cached decode
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                  device=None) -> Dict[str, torch.Tensor]:
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, cache_len, kv, hd), dtype=dtype,
                             device=device)}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.float()


def decode_mask(cache_len: int, pos: int, device) -> Optional[torch.Tensor]:
    """The valid slots of a ``cache_len`` cache at ``pos``: the prefix
    until the cache wraps, then every slot (None)."""
    if pos >= cache_len:
        return None
    return torch.arange(cache_len, device=device) <= pos


def decode_self_attention(x: torch.Tensor, cache: Dict[str, torch.Tensor],
                          pos: int, p: Attention, cfg: ModelConfig, *,
                          local: bool, rope, mask: Optional[torch.Tensor]
                          ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x: (B, 1, d); cache k/v: (B, L, KV, hd), written in
    place at slot ``pos mod L``; ``pos`` the token's position.

    A cache shorter than the sequence is a ring: once ``pos >= L`` every
    slot holds one of the last L tokens. ``rope`` is ``rope_table`` at
    ``pos`` and ``mask`` is ``decode_mask(L, pos)``, both made once a step
    by ``decode_step``. ``local`` is the reference's argument; the ring
    follows from L.
    """
    b = x.shape[0]
    cache_len = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(x, x, p, cfg)
    q = apply_rope(q, None, cfg.rope_theta, rope)
    k_new = apply_rope(k_new, None, cfg.rope_theta, rope)

    slot = pos % cache_len                # ring semantics (identity if full)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    k, v = cache["k"], cache["v"]

    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    h = cfg.num_heads
    group = h // kvh
    qg = q.reshape(b, kvh, group, hd)
    # einsum("bhgk,bthk->bhgt") and ("bhgt,bthk->bhgk") in float32
    s = torch.matmul(_f32(qg), _f32(k).permute(0, 2, 3, 1)) * hd ** -0.5
    s = softcap(s, cfg.logit_softcap)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.matmul(_f32(w.to(v.dtype)), _f32(v).transpose(1, 2))
    out = out.reshape(b, 1, h, hd).to(x.dtype)
    return _out(out, p.wo, x.dtype), cache
