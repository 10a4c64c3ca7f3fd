"""Cached one-token decode over a stack of attention layers.

The port of ``repro.models.decode`` for the ``ATTN`` and ``LOCAL_ATTN``
kinds. The cache holds ``pos`` (the next token's position, a Python int)
and one ``{"kv": {"k", "v"}}`` entry a layer, in the model's layer order
(the reference stacks them by period position for its scan). Each
``decode_step`` writes its token's K and V into the caches in place and
returns the same cache with ``pos`` advanced.

Cache sizing (as the reference's):
 - full-attention layers get a ``cache_len``-token KV cache;
 - sliding-window layers get a ``min(window, cache_len)`` ring buffer;
 - ``window_override=True`` (the long_500k serving variant) puts every
   attention layer on the ring buffer.

``prefill_cross`` and the recurrent, MLA and cross-attention caches come
with their slices (ROADMAP.md §1).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig
from repro_torch.core.sampler import resolve_device
from repro_torch.models import attention, common
from repro_torch.models.transformer import (Block, Transformer, _norms,
                                            check_ported, layer_kinds)


def _attn_cache_len(kind: str, cfg: ModelConfig, cache_len: int,
                    window_override: bool) -> int:
    if kind == LOCAL_ATTN or window_override:
        return min(cfg.sliding_window, cache_len)
    return cache_len


def _is_local(kind: str, cfg: ModelConfig, cache_len: int,
              window_override: bool) -> bool:
    return _attn_cache_len(kind, cfg, cache_len, window_override) < cache_len


# ---------------------------------------------------------------------------
# Cache init
# ---------------------------------------------------------------------------
def init_block_cache(kind: str, cfg: ModelConfig, batch: int, cache_len: int,
                     dtype, window_override: bool, device=None) -> Dict:
    if kind in (ATTN, LOCAL_ATTN) and cfg.mla is None:
        ln = _attn_cache_len(kind, cfg, cache_len, window_override)
        return {"kv": attention.init_kv_cache(cfg, batch, ln, dtype, device)}
    raise NotImplementedError(
        f"{cfg.name}: no decode cache for layer kind {kind!r} yet; see "
        "ROADMAP.md §1")


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
               window_override: bool = False, device=None) -> Dict:
    """The caches of every layer, on ``device`` (default the card)."""
    check_ported(cfg)
    device = resolve_device(device)
    return {"pos": 0,
            "layers": [init_block_cache(k, cfg, batch, cache_len, dtype,
                                        window_override, device)
                       for k in layer_kinds(cfg)]}


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------
def decode_block(x: torch.Tensor, bcache: Dict, p: Block, cfg: ModelConfig,
                 pos: int, window_override: bool, cache_len: int,
                 rope, masks: Dict) -> Tuple[torch.Tensor, Dict]:
    """One layer. ``rope`` and ``masks`` (by cache length) are the step's:
    ``decode_step`` makes them once for all its layers."""
    _, norm = _norms(cfg)
    h = norm(x, p.ln1.scale, cfg.norm_eps)
    length = bcache["kv"]["k"].shape[1]
    y, kv = attention.decode_self_attention(
        h, bcache["kv"], pos, p.attn, cfg,
        local=_is_local(p.kind, cfg, cache_len, window_override),
        rope=rope, mask=masks[length])
    bcache["kv"] = kv
    x = x + y
    h = norm(x, p.ln2.scale, cfg.norm_eps)
    return x + common.mlp(h, p.mlp, cfg.act), bcache


@torch.no_grad()
def decode_step(model: Transformer, cache: Dict, tokens: torch.Tensor,
                window_override: bool = False, cache_len: int = 0
                ) -> Tuple[torch.Tensor, Dict]:
    """tokens: (B, 1) -> (logits (B, 1, V) float32, the cache updated in
    place, ``pos`` advanced)."""
    cfg = model.cfg
    _, norm = _norms(cfg)
    pos = cache["pos"]
    x = common.embed(tokens, model.embed)
    # the step's rotation and each cache length's valid slots, made once
    rope = common.rope_table(torch.full((1,), pos, device=x.device),
                             cfg.resolved_head_dim, cfg.rope_theta)
    masks = {n: attention.decode_mask(n, pos, x.device)
             for n in {c["kv"]["k"].shape[1] for c in cache["layers"]}}
    for block, bcache in zip(model.layers, cache["layers"]):
        x, _ = decode_block(x, bcache, block, cfg, pos, window_override,
                            cache_len, rope, masks)
    cache["pos"] = pos + 1
    x = norm(x, model.final_norm.scale, cfg.norm_eps)
    return common.unembed(x, model.embed, cfg.final_softcap), cache
