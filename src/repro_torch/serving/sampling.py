"""Token sampling for the serving engine: greedy, temperature and top-k.

The counterpart of ``repro/serving/sampling.py``.  ``sample`` draws from
an explicit ``torch.Generator`` (the conv family's one-shot
classification).  ``sample_slots`` is the LM engine's per-slot rule, and
its randomness is POSITIONAL, as the reference's ``fold_in`` rule: the
token at absolute position ``p`` of request ``rid`` draws Gumbel noise
from a counter-based hash of (engine seed, rid, p, token id), so a
token's sample depends only on (request, position), never on which
dispatch drew it or on other slots' traffic: streams are the same for
every ``ticks_per_dispatch``.  Neither can reproduce ``jax.random``'s
streams, so only greedy results are comparable across the two packages.
"""
from __future__ import annotations

import torch

_MASK32 = 0xFFFFFFFF


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
    probs = torch.softmax(_scaled(logits, temperature, top_k), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _scaled(logits, temperature: float, top_k: int):
    logits = logits.float() / temperature
    if top_k:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    return logits


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors x < 2**32 and c < 2**32,
    without overflowing int64: x's two 16-bit halves multiply apart."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _MASK32


def _mix32(x):
    """The murmur3 32-bit finalizer on int64 tensors holding uint32s."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _uniform(seed: int, rids, pos, vocab: int):
    """(B, V) uniforms in (0, 1), a function of (seed, rids[b], pos[b],
    token id) only."""
    h = _mix32(torch.full_like(rids, seed & _MASK32))
    h = _mix32(h ^ (rids & _MASK32))
    h = _mix32(h ^ (pos.long() & _MASK32))                       # (B,)
    ids = torch.arange(vocab, device=rids.device, dtype=torch.long)
    u = _mix32(h[:, None] ^ _mul32(ids, 0x9E3779B1)[None, :])   # (B, V)
    return ((u >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_slots(seed: int, rids, pos, logits, temperature: float = 0.0,
                 top_k: int = 0):
    """Per-slot positional sampling: rids (B,) int64 request ids, pos (B,)
    ints, the absolute position of the token being sampled; logits (B, V)
    -> (B,) int64.  Greedy (``temperature == 0``) is argmax, the first
    maximum winning; otherwise Gumbel-max over ``logits / temperature``
    (top-k restricted), the noise from ``_uniform``."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    u = _uniform(seed, rids.long(), pos, logits.shape[-1])
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(_scaled(logits, temperature, top_k) + gumbel, dim=-1)
