"""Model API of the port: init, logits, loss and the decode-state surface
by family (the counterpart of ``repro/models/__init__.py``).

Ported: the conv family (AlexNet) and the ``dense``, ``moe``
(mixture-of-experts FFN, ``moe.py``), ``ssm`` (RWKV6) and ``hybrid``
(RG-LRU + local attention) LM families (``transformer``).  ``init``
returns an ``AlexNet`` module for conv and a params tree in the
reference's structure for the LMs; ``logits_fn`` returns (logits, aux)
and ``loss_fn`` takes a params tree and a batch dict for all.  The LM
loss is next-token cross-entropy, ``logits[:, :-1]`` against
``labels[:, 1:]``, plus the moe layers' aux load-balance loss (0 for the
other families), as the reference's.

The **DecodeState contract** (the reference's docs/serving.md):

  ``init_decode_state(cfg, batch, capacity)``      -> DecodeState
  ``prefill(params, cfg, tokens, capacity, ...)``  -> (logits, DecodeState)
  ``decode_step(params, cfg, state, tokens)``      -> (logits, DecodeState)

plus the slot surgery of the serving engine (``read_slots`` /
``write_slots``).  Image classification is one forward pass, so its
``DecodeState`` carries an empty cache and ``pos``; an LM's cache is
``transformer.init_decode_cache``'s stacked tree: ring KV caches for the
attention layers (dense, and the hybrid's local attention) and the
constant-size recurrent state of the ``rwkv`` and ``rec`` layers.
``DecodeState.pos`` is per row.  Unlike the reference, the cache is
written in place: ``decode_step`` and ``write_slots`` return a state
that shares (and has updated) the cache of the state passed in.  

Speculative decoding's primitives: ``decode_seq(params, cfg, state,
tokens, commit_len)`` runs T tokens per row in one call and commits each
row's first ``commit_len[b]``; ``decode_seq_pending`` is its forward,
which writes nothing, and ``commit_pending`` its commit, in place, with
``pos`` advanced by ``commit_len``.  The vlm and encdec families come
with later slices (ROADMAP queue A item 8, A8b and A8c); asking for them
raises.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.kernels.common import device_of
from repro_torch.models import alexnet, transformer
from repro_torch.models.layers import softmax_xent

_NOT_PORTED = ("family {family!r} ({name}) is not ported to PyTorch yet: "
               "see ROADMAP.md queue A ({what})")
FAMILIES = ("conv", "dense", "moe", "ssm", "hybrid")
# the families still to port, and their ROADMAP items
_NOT_PORTED_ITEMS = {"vlm": "item 8, A8b: the vlm family",
                     "encdec": "item 8, A8c: the encdec family"}


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(_NOT_PORTED.format(
            family=cfg.family, name=cfg.name,
            what=_NOT_PORTED_ITEMS.get(cfg.family,
                                       "item 8, the remaining LM families")))


def init(cfg, generator: torch.Generator, *, device=None):
    """A randomly initialized model for ``cfg`` on ``device``: an
    ``AlexNet`` for conv, a params tree for the LMs."""
    _check_family(cfg)
    if cfg.family == "conv":
        return alexnet.init(cfg, generator, device=device)
    return transformer.init(cfg, generator, device=device)


def logits_fn(params, cfg, batch):
    """(fp32 logits, aux) of a params tree on a batch dict (``images`` for
    conv, ``tokens`` for the LMs); aux is the moe layers' summed aux loss
    (an fp32 scalar), 0.0 for conv."""
    _check_family(cfg)
    if cfg.family == "conv":
        return alexnet.forward(params, cfg, batch["images"]), 0.0
    return transformer.forward(params, cfg, batch["tokens"])


def loss_fn(params, cfg, batch):
    """Classification cross-entropy for conv; next-token cross-entropy
    for the LMs; each plus the aux loss (nonzero for moe alone)."""
    logits, aux = logits_fn(params, cfg, batch)
    labels = batch["labels"]
    if cfg.family == "conv":
        return softmax_xent(logits[:, None, :], labels[:, None]) + aux
    return softmax_xent(logits[:, :-1], labels[:, 1:]) + aux


@dataclasses.dataclass
class DecodeState:
    """``cache`` is the family's state (empty for conv); ``pos`` (B,)
    int32 counts the tokens each row has consumed, i.e. the absolute
    position the next ``decode_step`` token takes."""
    cache: Any
    pos: torch.Tensor


def init_decode_cache(cfg, batch: int, seq_len: int, *, device=None):
    """The DecodeState's ``cache`` tree (``{}`` for conv)."""
    _check_family(cfg)
    if cfg.family == "conv":
        # classification is one forward: there is no state to carry
        return {}
    return transformer.init_decode_cache(cfg, batch, seq_len, device=device)


def init_decode_state(cfg, batch: int, capacity: int, *,
                      device=None) -> DecodeState:
    dev = device_of(device)
    return DecodeState(
        cache=init_decode_cache(cfg, batch, capacity, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev))


def _check_lm(cfg):
    _check_family(cfg)
    if cfg.family == "conv":
        raise ValueError(f"{cfg.name} ({cfg.family}) has no token decode "
                         "path: the conv family classifies in one forward")


@torch.no_grad()
def prefill(params, cfg, tokens, capacity: int, *, length=None):
    """Prompt (B,S) -> (logits (B,S,V) fp32, ready-to-decode DecodeState).

    ``length`` (an int, or (B,) ints) marks per-row true lengths of
    right-padded prompts: the state comes out as if each row had been
    prefilled unpadded (ring writes and ``pos`` both respect it)."""
    _check_lm(cfg)
    b, s = tokens.shape
    logits, cache = transformer.prefill(params, cfg, tokens, capacity,
                                        length=length)
    pos = torch.as_tensor(s if length is None else length, dtype=torch.int32,
                          device=tokens.device).expand(b).clone()
    return logits, DecodeState(cache=cache, pos=pos)


@torch.no_grad()
def decode_step(params, cfg, state: DecodeState, tokens, table=None):
    """One decode step for every row: tokens (B,1) ints at positions
    ``state.pos``.  Returns (logits (B,1,V) fp32, DecodeState with each
    row's position advanced); the cache is written in place and shared.
    ``table`` (B, cap/bs) int32 switches the cache leaves to the block
    pool (``serving/blocks.py``): logical ring slot ``s`` of row b lives
    at ``pool[table[b, s // bs], s % bs]``."""
    _check_lm(cfg)
    logits = transformer.decode_step(params, cfg, state.cache, tokens,
                                     state.pos, table)
    return logits, DecodeState(cache=state.cache, pos=state.pos + 1)


@torch.no_grad()
def decode_seq(params, cfg, state: DecodeState, tokens, commit_len):
    """Chunked decode: tokens (B,T) ints at positions ``state.pos ..
    state.pos+T-1``; commit_len (an int or (B,) ints in [0, T]).  Returns
    (logits (B,T,V) fp32, each what sequential ``decode_step`` calls
    would give, and the DecodeState with ``pos += commit_len``, whose
    cache is the one passed in, advanced in place by each row's first
    ``commit_len[b]`` tokens).  ``commit_len = 0`` is speculative
    decoding's verify, ``commit_len = accepted`` its commit."""
    _check_lm(cfg)
    cl = _commit_len(commit_len, state.pos)
    logits = transformer.decode_seq(params, cfg, state.cache, tokens,
                                    state.pos, cl)
    return logits, DecodeState(cache=state.cache, pos=state.pos + cl)


@torch.no_grad()
def decode_seq_pending(params, cfg, state: DecodeState, tokens):
    """The commit-independent half of ``decode_seq``: the T-token forward
    from ``state``, which it leaves untouched.  Returns (logits (B,T,V)
    fp32, pending) for ``commit_pending``, so that a verify and its
    commit cost one forward."""
    _check_lm(cfg)
    return transformer.decode_seq_pending(params, cfg, state.cache, tokens,
                                          state.pos)


@torch.no_grad()
def commit_pending(params, cfg, state: DecodeState, pending,
                   commit_len) -> DecodeState:
    """Commit each row's first ``commit_len[b]`` tokens of a
    ``decode_seq_pending`` chunk into ``state.cache`` in place; returns
    the DecodeState with ``pos`` advanced by ``commit_len``."""
    cl = _commit_len(commit_len, state.pos)
    transformer.decode_seq_commit(params, cfg, state.cache, pending,
                                  state.pos, cl)
    return DecodeState(cache=state.cache, pos=state.pos + cl)


def _commit_len(commit_len, pos):
    """``commit_len`` (an int or (B,) ints) as a (B,) tensor like
    ``pos``."""
    return torch.as_tensor(commit_len, dtype=pos.dtype,
                           device=pos.device).expand(pos.shape[0])


# slot surgery: the continuous-batching engine swaps one request's state in
# and out of a fixed-slot DecodeState.  Stacked cache leaves carry their
# layer axis BEFORE batch.
_STACKED_RE = re.compile(r"(^|/)(blocks|self|cross)/")


def stacked_cache_path(path_str: str) -> bool:
    """Whether a decode-cache leaf at this '/'-joined path carries a
    leading stacked layer axis (batch is then axis 1, not 0)."""
    return bool(_STACKED_RE.search(path_str)) and \
        "rem_blocks" not in path_str


def map_cache(fn, cache, *rest, path: str = ""):
    """``fn(leaf, *rest_leaves, batch_axis)`` over a cache tree (dicts
    and tuples), keeping its structure; ``batch_axis`` is 1 for stacked
    leaves (``stacked_cache_path``), else 0."""
    if isinstance(cache, dict):
        return {k: map_cache(fn, cache[k], *(r[k] for r in rest),
                             path=f"{path}/{k}" if path else str(k))
                for k in cache}
    if isinstance(cache, (tuple, list)):
        return type(cache)(
            map_cache(fn, c, *(r[i] for r in rest),
                      path=f"{path}/{i}" if path else str(i))
            for i, c in enumerate(cache))
    return fn(cache, *rest, 1 if stacked_cache_path(path) else 0)


def _index(slots, device):
    return torch.as_tensor(list(slots), dtype=torch.long, device=device)


def write_slots(state: DecodeState, sub: DecodeState, slots) -> DecodeState:
    """Scatter ``sub`` (batch = len(slots)) into ``state`` at ``slots``:
    the cache in place, ``pos`` into a new tensor (the input state's
    ``pos`` is untouched)."""
    idx = _index(slots, state.pos.device)

    def one(leaf, new, axis):
        if axis:
            leaf[:, idx] = new.to(leaf.dtype)
        else:
            leaf[idx] = new.to(leaf.dtype)

    map_cache(one, state.cache, sub.cache)
    pos = state.pos.clone()
    pos[idx] = sub.pos.to(device=pos.device, dtype=pos.dtype)
    return DecodeState(cache=state.cache, pos=pos)


def read_slots(state: DecodeState, slots) -> DecodeState:
    """Gather rows ``slots`` of ``state`` into a new sub-state (batch =
    len(slots)): the inverse of ``write_slots``, bit for bit."""
    idx = _index(slots, state.pos.device)
    cache = map_cache(lambda leaf, axis: leaf[:, idx] if axis else leaf[idx],
                      state.cache)
    return DecodeState(cache=cache, pos=state.pos[idx])
