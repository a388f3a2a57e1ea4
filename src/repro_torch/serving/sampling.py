"""Token sampling for the serving engine: greedy, temperature and top-k.

The counterpart of ``repro/serving/sampling.py::sample``.  Randomness
comes from an explicit ``torch.Generator`` on the logits' device; it
cannot reproduce ``jax.random``'s streams, so only greedy results are
comparable across the two packages.
"""
from __future__ import annotations

import torch


def sample(logits, temperature: float = 0.0, top_k: int = 0,
           generator: torch.Generator = None):
    """logits (B, V) float32 -> (B,) int64 token ids.

    ``temperature == 0`` is greedy argmax; the first maximum wins, as with
    ``jnp.argmax``.  Otherwise sample from ``softmax(logits /
    temperature)``, restricted to each row's ``top_k`` highest logits when
    ``top_k > 0``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling with temperature > 0 needs a generator")
    logits = logits.float() / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
