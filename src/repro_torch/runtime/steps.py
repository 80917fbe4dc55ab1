"""Serving step builders: prefill and decode, in torch.

Port of the serving half of `repro.runtime.steps`. The functions take
explicit param and cache trees and run eagerly (no jit). The train step
and `init_opt_state` wait for the training slice (ROADMAP queue A
item 11).
"""

from __future__ import annotations

import torch

from ..models.model import BaseLM


def make_prefill_step(model: BaseLM):
    """serve prefill: (params, batch, cache) -> (last-token logits, cache)."""

    def prefill(params, batch, cache):
        logits, cache = model.forward(params, batch, cache=cache)
        return logits[:, -1:], cache

    return prefill


def make_decode_step(model: BaseLM, sample: bool = False, temperature: float = 1.0):
    """serve decode: (params, tokens (B, 1), cache[, generator]) -> (next
    (B, 1) int32, cache). Greedy decoding takes the argmax (the first
    maximum, as `jnp.argmax`); sampling draws from softmax(logits / T)
    with the explicit `generator`, so its draws are torch's, not the
    reference's `jax.random` ones."""

    def decode(params, tokens, cache, generator=None):
        logits, cache = model.forward(params, {"tokens": tokens}, cache=cache)
        last = logits[:, -1]
        if sample:
            probs = torch.softmax(last / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)
        else:
            nxt = torch.argmax(last, dim=-1)[:, None]
        return nxt.to(torch.int32), cache

    return decode
