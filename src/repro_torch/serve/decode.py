"""Serving: batched autoregressive decode over ``Model.decode_step``.

The port's ``repro.serve.decode``.  :func:`make_serve_step` is the unit
of decode: one new token against a KV cache.  :func:`generate` drives it
in a host loop (greedy or temperature sampling).  The caches are made
once, on the device, and every step updates them in place: no step pads
or copies them, and the loop reads nothing back from the device until
the caller reads the tokens.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.policies import resolve_device
from ..models.transformer import Model, ParallelCtx


def make_serve_step(model: Model, pctx: ParallelCtx = ParallelCtx()):
    def serve_step(params, batch, caches):
        logits, new_caches = model.decode_step(params, batch, caches, pctx)
        return logits, new_caches

    return serve_step


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator]
                 = None, temperature: float = 0.0) -> torch.Tensor:
    """logits (B, 1, V) -> (B, 1) int32: the argmax, or with
    ``temperature > 0`` a draw from softmax(logits / temperature) with
    ``generator``."""
    lf = logits[:, -1].to(torch.float32)
    if temperature <= 0:
        return torch.argmax(lf, dim=-1)[:, None].to(torch.int32)
    probs = torch.softmax(lf / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


def generate(model: Model, params, prompt: torch.Tensor, max_new: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             pctx: ParallelCtx = ParallelCtx(),
             extra_batch: Optional[Dict] = None,
             device=None) -> torch.Tensor:
    """Greedy or temperature generation.  prompt: (B, S0) integers ->
    (B, S0 + max_new) int32 tokens on ``device`` (default the card, where
    ``params`` must lie).

    The prompt is prefilled token by token through the same decode step
    (as the reference does), into caches of S0 + max_new tokens.  Sampling with ``temperature > 0`` draws from
    ``generator`` (default: one seeded with 0 on ``device``).
    """
    dev = resolve_device(device)
    prompt = prompt.to(device=dev, dtype=torch.int32)
    B, S0 = prompt.shape
    if generator is None and temperature > 0:
        generator = torch.Generator(device=dev).manual_seed(0)
    caches = model.init_cache(B, S0 + max_new, device=dev)
    step_fn = make_serve_step(model, pctx)

    def step(tokens, pos):
        batch = {"tokens": tokens, "pos": pos}
        if extra_batch:
            batch.update(extra_batch)
        return step_fn(params, batch, caches)[0]

    with torch.no_grad():
        logits = None
        for i in range(S0):
            logits = step(prompt[:, i:i + 1], i)
        out = [prompt]
        cur = sample_token(logits, generator, temperature)
        for i in range(max_new):
            out.append(cur)
            logits = step(cur, S0 + i)
            cur = sample_token(logits, generator, temperature)
    return torch.cat(out, dim=1)
