"""Model assembly: pattern-driven layer stacks.

The port of ``repro.models.transformer`` for the dense-attention
architectures: layer kinds ``ATTN`` and ``LOCAL_ATTN`` with a dense MLP,
gated or plain (granite-8b, starcoder2-7b, gemma2-9b, mistral-large-123b).
The reference scans one period of the pattern over stacked parameters
(``lax.scan``); here every layer is its own ``Block`` module and the stack
is a Python loop, in the reference's layer order (``first``, then the
period ``repeats`` times, then ``remainder``).

Entry points:
  ``init_params``    — a ``Transformer`` with random weights
  ``params_from_jax``— a ``Transformer`` holding a reference parameter tree
  ``forward``        — full-sequence (prefill) -> float32 logits
  ``hidden_forward`` — final hidden states (the embedding example)

Any other kind (``CROSS``, ``SSM``, ``RGLRU``, the encoder-decoder), MoE
and MLA raise ``NotImplementedError``: they come in later slices
(ROADMAP.md §1). So does training (``remat``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ATTN, LOCAL_ATTN, ModelConfig
from repro_torch.core.sampler import resolve_device
from repro_torch.models import attention, common

ENCDEC = "encdec"          # whisper decoder layer: self-attn + cross-attn
PORTED_KINDS = (ATTN, LOCAL_ATTN)


# ---------------------------------------------------------------------------
# Layout: (first, period, repeats, remainder)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Layout:
    first: Tuple[str, ...]       # leading layers (dense FFN)
    period: Tuple[str, ...]      # the repeated pattern
    repeats: int
    remainder: Tuple[str, ...]   # trailing layers


def layout(cfg: ModelConfig, first_k_dense: int = 0) -> Layout:
    """``first_k_dense``: the leading layers with a dense FFN
    (``configs.first_k_dense(arch_id)``). Only MoE archs have any, and
    none of them is ported yet (``check_ported``)."""
    if cfg.encoder_layers:
        kinds: Tuple[str, ...] = (ENCDEC,) * cfg.num_layers
    else:
        kinds = cfg.layer_kinds
    first = kinds[:first_k_dense]
    rest = kinds[first_k_dense:]
    if cfg.pattern and not cfg.encoder_layers:
        period = cfg.pattern
        remainder = cfg.remainder
    else:
        period = (rest[0],)
        remainder = ()
    repeats = (len(rest) - len(remainder)) // len(period)
    assert (repeats * len(period) + len(remainder) + first_k_dense
            == cfg.num_layers)
    return Layout(first, period, repeats, remainder)


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """Every layer's kind, in execution order."""
    lay = layout(cfg)
    return lay.first + lay.period * lay.repeats + lay.remainder


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this slice does not run."""
    missing = []
    if cfg.encoder_layers:
        missing.append("the encoder-decoder (audio) stack")
    if cfg.moe is not None:
        missing.append("mixture-of-experts FFNs")
    if cfg.mla is not None:
        missing.append("multi-head latent attention")
    kinds = sorted(set(layer_kinds(cfg)) - set(PORTED_KINDS))
    if kinds:
        missing.append(f"layer kinds {kinds}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch "
            "yet; the port runs the dense-attention archs (layer kinds "
            f"{list(PORTED_KINDS)}, a dense MLP). See ROADMAP.md §1 for "
            "the queue.")


def _norms(cfg: ModelConfig):
    """(init, apply): RMSNorm; whisper's LayerNorm comes with the audio
    slice."""
    if cfg.arch_type == "audio":
        raise NotImplementedError(
            f"{cfg.name}: LayerNorm (the audio slice) is not ported yet; "
            "see ROADMAP.md §1")
    return common.init_rmsnorm, common.rmsnorm


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """Pre-norm residual block: attention, then the MLP."""

    def __init__(self, kind: str, cfg: ModelConfig, dtype,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"layer kind {kind!r} is not ported yet; see ROADMAP.md §1")
        ninit, _ = _norms(cfg)
        d = cfg.d_model
        self.kind = kind
        self.ln1 = ninit(d, dtype, device)
        self.attn = attention.init_attn(gen, cfg, dtype, device)
        self.ln2 = ninit(d, dtype, device)
        self.mlp = common.init_mlp(gen, d, cfg.d_ff, cfg.gated_mlp, dtype,
                                   device)


def init_block(gen, kind: str, cfg: ModelConfig, dtype,
               device=None) -> Block:
    """``device`` defaults to the card (``resolve_device``)."""
    return Block(kind, cfg, dtype, gen, resolve_device(device))


def apply_block(x: torch.Tensor, p: Block, cfg: ModelConfig, *,
                causal: bool = True) -> torch.Tensor:
    _, norm = _norms(cfg)
    h = norm(x, p.ln1.scale, cfg.norm_eps)
    x = x + attention.self_attention(h, p.attn, cfg,
                                     local=(p.kind == LOCAL_ATTN),
                                     causal=causal)
    h = norm(x, p.ln2.scale, cfg.norm_eps)
    return x + common.mlp(h, p.mlp, cfg.act)


# ---------------------------------------------------------------------------
# Whole model
# ---------------------------------------------------------------------------
class Transformer(nn.Module):
    """The stack: ``embed``, ``layers`` (one ``Block`` each) and
    ``final_norm``, on ``device`` (default the card; without one it
    raises, as ``core.sampler.resolve_device`` does)."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        check_ported(cfg)
        device = resolve_device(device)
        ninit, _ = _norms(cfg)
        self.cfg = cfg
        self.embed = common.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                       cfg.tie_embeddings, dtype, device)
        self.final_norm = ninit(cfg.d_model, dtype, device)
        self.layers = nn.ModuleList(
            init_block(gen, kind, cfg, dtype, device)
            for kind in layer_kinds(cfg))


def init_params(key: Union[int, torch.Generator], cfg: ModelConfig,
                dtype=torch.float32, device=None) -> Transformer:
    """Random weights drawn on ``device`` (default the card) from ``key``
    (a seed or a ``torch.Generator`` on that device)."""
    device = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=device).manual_seed(int(key))
    return Transformer(cfg, dtype, gen, device)


@torch.no_grad()
def hidden_forward(model: Transformer, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (final hidden states (B, S, d), MoE aux ()). The
    aux loss is zero until MoE is ported."""
    cfg = model.cfg
    _, norm = _norms(cfg)
    x = common.embed(tokens, model.embed)
    for block in model.layers:
        x = apply_block(x, block, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return norm(x, model.final_norm.scale, cfg.norm_eps), aux


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, V) float32, MoE aux ())."""
    x, aux = hidden_forward(model, tokens)
    return common.unembed(x, model.embed, model.cfg.final_softcap), aux


# ---------------------------------------------------------------------------
# Weights carried across from the reference
# ---------------------------------------------------------------------------
def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _reference_sources(cfg: ModelConfig) -> List[Tuple[str, str, Optional[int]]]:
    """(section, key, stack index) of each layer, in execution order: the
    reference keeps ``first`` and ``rem`` unstacked and stacks each
    period position's ``repeats`` copies in ``blocks``."""
    lay = layout(cfg)
    src = [("first", f"{i}_{k}", None) for i, k in enumerate(lay.first)]
    for r in range(lay.repeats):
        src += [("blocks", f"{j}_{k}", r) for j, k in enumerate(lay.period)]
    src += [("rem", f"{i}_{k}", None) for i, k in enumerate(lay.remainder)]
    return src


def params_from_jax(cfg: ModelConfig, tree, device=None) -> Transformer:
    """The reference's ``init_params`` tree (nested dicts of arrays: numpy,
    or anything ``np.asarray`` reads) as the port's module, on ``device``
    (default the card), in the tree's dtype.

    Every leaf must be there with its shape, and no other: a missing,
    extra or misshapen leaf raises ``ValueError``."""
    flat = _flatten(tree)
    dtypes = {a.dtype for a in flat.values()}
    if len(dtypes) != 1:
        raise ValueError(f"mixed parameter dtypes {sorted(map(str, dtypes))}")
    dtype = torch.from_numpy(np.zeros(0, dtype=dtypes.pop())).dtype
    model = Transformer(cfg, dtype, None, device)
    layers = _reference_sources(cfg)
    seen, problems = set(), []
    for name, prm in model.named_parameters():
        parts = name.split(".")
        index = None
        if parts[0] == "layers":
            section, key, index = layers[int(parts[1])]
            path = (section, key, *parts[2:])
        else:
            path = tuple(parts)
        if path not in flat:
            problems.append(f"missing leaf {'/'.join(path)}")
            continue
        seen.add(path)
        arr = flat[path]
        if index is not None:
            if arr.ndim == 0 or arr.shape[0] != layout(cfg).repeats:
                problems.append(f"{'/'.join(path)}: stacked shape "
                                f"{arr.shape}, want ({layout(cfg).repeats}, "
                                f"{', '.join(map(str, prm.shape))})")
                continue
            arr = arr[index]
        if tuple(arr.shape) != tuple(prm.shape):
            problems.append(f"{'/'.join(path)}: shape {arr.shape}, want "
                            f"{tuple(prm.shape)}")
            continue
        with torch.no_grad():
            prm.copy_(torch.from_numpy(np.array(arr)))
    problems += [f"extra leaf {'/'.join(p)}"
                 for p in sorted(set(flat) - seen)]
    if problems:
        raise ValueError(f"{cfg.name}: the reference tree does not fit the "
                         f"port's model: {'; '.join(problems)}")
    return model
