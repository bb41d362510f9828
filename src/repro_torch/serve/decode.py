"""Serving loop: batched autoregressive decode over the KV cache.

Port of ``repro/serve/decode.py``.  ``serve_step`` is one new token for
every sequence in the batch against the cache; ``generate`` builds the
cache by repeated decode, as the reference does, so it launches no K11.

Sampling: greedy (``temperature <= 0``) is exact, ties to the lowest id
as ``jnp.argmax``.  With a temperature the token is drawn from the same
distribution as the reference's (softmax of logits / temperature, cut to
the top k when ``top_k`` > 0) with a ``torch.Generator``; JAX's threefry
bits cannot be reproduced, so sampled tokens differ from the reference's.
"""
from __future__ import annotations

import torch

from .. import spans
from ..models import transformer as tf
from ..models.config import ModelConfig


def sample_tokens(logits: torch.Tensor,
                  generator: torch.Generator | None = None, *,
                  temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, 1, V) -> (B, 1) int32 token ids; a ``sample`` span of
    the last request of :mod:`repro_torch.spans`."""
    with spans.request("sample", new=False):
        lg = logits[:, -1].float()
        if temperature <= 0.0:
            return torch.argmax(lg, dim=-1)[:, None].to(torch.int32)
        lg = lg / temperature
        if top_k > 0:
            kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
            lg = torch.where(lg < kth, -torch.inf, lg)
        probs = torch.softmax(lg, dim=-1)
        return torch.multinomial(probs, 1,
                                 generator=generator).to(torch.int32)


def serve_step(params: dict, cfg: ModelConfig, cache: dict,
               tokens: torch.Tensor, pos: torch.Tensor,
               generator: torch.Generator | None = None, *,
               temperature: float = 0.0, moe_dispatch: str = "capacity"):
    """One decode step: (B, 1) token in -> (B, 1) token out + the cache,
    updated in place; MoE layers dispatch as ``moe_dispatch`` says (the
    reference's capacity here and in :func:`generate`; ``serve_lm``'s
    loop asks for ``"dropless"``)."""
    logits, cache = tf.decode_step(params, cfg, cache, tokens, pos,
                                   moe_dispatch=moe_dispatch)
    return sample_tokens(logits, generator, temperature=temperature), cache


def generate(params: dict, cfg: ModelConfig, prompt: torch.Tensor, *,
             steps: int, cache_len: int, temperature: float = 0.0,
             seed: int = 0) -> torch.Tensor:
    """Greedy/sampled generation with the prompt fed token by token
    (teacher-forced prefill by repeated decode: no sampling, no draws).
    prompt (B, Tp) -> (B, Tp + steps)."""
    B, Tp = prompt.shape
    dev = prompt.device
    cache = tf.init_cache(cfg, B, cache_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for t in range(Tp - 1):
        _, cache = tf.decode_step(
            params, cfg, cache, prompt[:, t:t + 1],
            torch.full((B,), t, dtype=torch.int32, device=dev))
    cur = prompt[:, -1:]
    outs = [prompt]
    for t in range(steps):
        cur, cache = serve_step(
            params, cfg, cache, cur,
            torch.full((B,), Tp - 1 + t, dtype=torch.int32, device=dev),
            gen, temperature=temperature)
        outs.append(cur.to(prompt.dtype))
    return torch.cat(outs, dim=1)
