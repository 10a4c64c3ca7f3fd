"""Serving engine for the LM zoo: batched cached decoding on one card.

The port of ``repro.serve.engine``. ``serve_step`` is one decode step and
the choice of the next token (greedy ``argmax``, or a categorical draw at
``temperature > 0``); ``Generator`` drives it for batched requests, the
prompt fed token by token through the decode path (teacher-forced
prefill, as the reference does; there is no batched prefill).

Sampling draws Gumbel noise from a ``torch.Generator`` seeded with the
request's ``seed``: a seed gives the same tokens on the same device, not
the reference's ``jax.random`` tokens. Greedy decoding gives the
reference's tokens.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.sampler import resolve_device
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer


def categorical(logits: torch.Tensor, generator: torch.Generator
                ) -> torch.Tensor:
    """One draw a row of ``softmax(logits)`` (Gumbel-max, float32)."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def serve_step(model, cache: Dict, tokens: torch.Tensor,
               generator: Optional[torch.Generator], *,
               window_override: bool, cache_len: int,
               temperature: float = 0.0) -> Tuple[torch.Tensor, Any]:
    """One decode step + sampling: (B, 1) tokens -> (B, 1) next tokens."""
    logits, new_cache = decode_mod.decode_step(
        model, cache, tokens, window_override=window_override,
        cache_len=cache_len)
    if temperature > 0.0:
        next_tok = categorical(logits[:, 0] / temperature, generator)
    else:
        next_tok = torch.argmax(logits[:, 0], dim=-1)
    return next_tok[:, None], new_cache


def uses_window_override(cfg: ModelConfig, shape: InputShape) -> bool:
    """``long_500k`` forces the sliding-window serving variant onto every
    attention layer (the sub-quadratic path of the dense archs)."""
    return shape.seq_len > 32_768 and cfg.long_context == "sliding_window"


def make_serve_step(cfg: ModelConfig, shape: InputShape,
                    temperature: float = 0.0) -> Tuple[Callable, bool]:
    """The serve step for one (arch, decode shape) pair, and whether it
    runs every attention layer on a ring (``window_override``)."""
    window_override = uses_window_override(cfg, shape)
    fn = functools.partial(serve_step, window_override=window_override,
                           cache_len=shape.seq_len, temperature=temperature)
    return fn, window_override


class Generator:
    """Batched generation loop over the serve step.

    ``params_or_model``: a ``transformer.Transformer`` (moved to the
    device in place), or the reference's parameter tree (nested dicts of
    arrays, ``transformer.params_from_jax``). ``dtype`` is the caches'.
    ``device`` defaults to the card; without one it raises."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, params_or_model,
                 temperature: float = 0.0, dtype=torch.float32,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.shape = cfg, shape
        if isinstance(params_or_model, torch.nn.Module):
            model = params_or_model
        else:
            model = transformer.params_from_jax(cfg, params_or_model,
                                                device=self.device)
        self.model = model.to(self.device)
        self.temperature = temperature
        self.step, self.window_override = make_serve_step(
            cfg, shape, temperature)
        self.dtype = dtype

    def generate(self, prompts, steps: int, seed: int = 0) -> torch.Tensor:
        """prompts: (B, P) ints -> (B, P + steps) greedy/temp continuation
        (int64, on the device).

        The prompt is consumed token by token through the decode path, and
        no step reads anything back to the host."""
        if not isinstance(prompts, torch.Tensor):
            prompts = torch.tensor(np.asarray(prompts))
        prompts = prompts.to(self.device, torch.long)
        b, plen = prompts.shape
        cache = decode_mod.init_cache(
            self.cfg, b, self.shape.seq_len, self.dtype,
            window_override=self.window_override, device=self.device)
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        out = [prompts]
        tok = prompts[:, :1]
        for t in range(plen + steps - 1):
            nxt, cache = self.step(self.model, cache, tok, gen)
            if t + 1 < plen:
                tok = prompts[:, t + 1:t + 2]       # teacher-forced prefill
            else:
                tok = nxt
                out.append(nxt)
        return torch.cat(out, dim=1)
