"""LM serving: greedy / temperature generation (port of
repro/serve/engine.py:generate and _sample).

``DetectionService`` (the detection serving engine of the same
reference module) is a later slice of the port.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.model import DenseLM, decode_step, prefill

Tensor = torch.Tensor


def generate(params: DenseLM, cfg: ModelConfig, prompt,
             max_new_tokens: int = 32, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> Tensor:
    """Greedy or temperature decoding. prompt: (B, S) token ids, numpy or
    a tensor, moved to the parameters' device -> (B, S + new) int64 on
    that device.

    Greedy decoding (``temperature`` <= 0, or no ``generator``) gives the
    reference's tokens. Temperature sampling draws from ``generator``
    (on the parameters' device): the same distribution as the
    reference's ``jax.random.categorical``, not the same tokens.
    """
    dev = params.device
    prompt = torch.as_tensor(np.asarray(prompt) if not isinstance(
        prompt, Tensor) else prompt).to(device=dev, dtype=torch.int64)
    B, S = prompt.shape
    logits, cache = prefill(params, {"tokens": prompt}, cfg,
                            max_len=S + max_new_tokens)
    toks = [prompt]
    cur = _sample(logits[:, -1], temperature, generator)
    for t in range(max_new_tokens):
        toks.append(cur)
        if t == max_new_tokens - 1:
            break
        logits, cache = decode_step(params, cur, cache, cfg)
        cur = _sample(logits[:, -1], temperature, generator)
    return torch.cat(toks, dim=1)


def _sample(logits: Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> Tensor:
    """(B, V) logits -> (B, 1) token ids: argmax (the first index of a
    tie, as jnp.argmax), or one draw from softmax(logits / temperature)."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1, keepdim=True)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)
