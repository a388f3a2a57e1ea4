"""Decoder-only transformer for the ``dense``, ``moe``, ``ssm`` and
``hybrid`` families (the counterpart of ``repro/models/transformer.py``),
through a per-layer *pattern* of block kinds:

  ``dense``  attention (full or sliding-window per config) + MLP
  ``moe``    attention + mixture-of-experts FFN (``moe.py``)
  ``attn``   local (sliding-window) attention + MLP      [hybrid]
  ``rec``    RG-LRU recurrent block + MLP                [hybrid]
  ``rwkv``   RWKV6 time-mix + channel-mix                [ssm]

Params are the reference's tree: ``{"embed": {"tok"[, "lm_head"]},
"final_norm": {...}, "blocks": (stacked, ...), "rem_blocks": (...)}``.
Layers are grouped into superblocks of ``len(pattern)``: ``blocks``
holds one entry per pattern position whose leaves carry a leading axis
of ``n_layers // len(pattern)``, and ``rem_blocks`` the remaining
``n_layers % len(pattern)`` layers unstacked, so the weight bridge and
checkpoints copy them as they are.  The forward runs the layers in the
reference's superblock-major order (``blocks[0][i]``, ``blocks[1][i]``,
... for each i, then ``rem_blocks``; the reference scans the
superblocks), unbinding the stacked leaves; unbind's backward stacks the
layers' grads in one pass.  ``forward`` returns the logits and the sum of
the ``moe`` layers' aux losses (0 for the other kinds), as the
reference's.  A ``moe`` layer dispatches with the configured, dropping,
capacity factor in ``forward`` and a prefill, and dropless (capacity
factor E) in every decode path, as the reference's (``_decode_moe_cf``).

Decode: ``init_decode_cache`` stacks one cache per layer in the same
tree (a ring KV cache for ``dense`` and ``attn``, the recurrent state for
``rwkv`` and ``rec``), ``prefill`` / ``forward(..., cache=)`` fill it and
``decode_step`` advances it one token.  Each layer writes its view
(``unbind``) of the stacked leaves, so every write lands in place in the
stacked tensors.  Speculative decoding's chunk splits in two:
``decode_seq_pending`` runs T tokens per row from the cache and writes
nothing (the attention kinds against the ring as it is, the recurrent
kinds from their carried state), and ``decode_seq_commit`` then advances
the cache in place by each row's first ``commit_len`` tokens: a masked
ring write for the attention kinds, a re-run of the length-masked carry
from the stored sublayer inputs for the recurrent kinds.  A prefill
starts from the fresh cache's zero state, so its ``rwkv`` layers run the
WKV kernel (``rwkv.time_mix_seq``); a ``forward`` from a carried cache,
and a chunk, take the plain chunked WKV with the state.  The vlm family
is not ported (ROADMAP queue A item 8, A8b).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import device_of
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.layers import (embed_apply, embed_init, mlp_apply,
                                       mlp_init, norm_apply, norm_init,
                                       unembed_apply)
from repro_torch.numerics import param_dtype
from repro_torch.tree import tree_map


def block_kinds(cfg) -> tuple:
    """The pattern of block kinds one superblock repeats."""
    if cfg.family == "dense":
        return ("dense",)
    if cfg.family == "moe":
        k = cfg.moe.every_k
        return ("dense",) * (k - 1) + ("moe",) if k > 1 else ("moe",)
    if cfg.family == "ssm":
        return ("rwkv",)
    if cfg.family == "hybrid":
        return tuple(cfg.layer_pattern or ("rec", "rec", "attn"))
    raise NotImplementedError(
        f"family {cfg.family!r} ({cfg.name}) is not ported yet: see "
        "ROADMAP.md queue A item 8 (A8b: vlm; A8c: encdec)")


def _split(cfg):
    """(pattern, superblocks, remainder layers)."""
    pattern = block_kinds(cfg)
    n_super, rem = divmod(cfg.n_layers, len(pattern))
    return pattern, n_super, rem


def layer_kinds(cfg) -> list:
    """Every layer's kind, in the order the forward runs them."""
    pattern, n_super, rem = _split(cfg)
    return list(pattern) * n_super + list(pattern[:rem])


def block_init(cfg, generator, kind: str, device):
    dt = param_dtype(cfg)
    p = {"norm1": norm_init(cfg, dt, device),
         "norm2": norm_init(cfg, dt, device)}
    if kind == "rwkv":
        return {**rwkv_mod.rwkv_block_init(cfg, generator, dt, device), **p}
    if kind == "rec":
        p["mix"] = rglru_mod.rglru_block_init(cfg, generator, dt, device)
    else:
        p["attn"] = attn.attn_init(cfg, generator, dt, device)
    p["ffn"] = (moe_mod.moe_init(cfg, generator, dt, device)
                if kind == "moe" else mlp_init(cfg, generator, dt, device))
    return p


def _device_generator(generator: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``generator`` (a CPU one), so
    full-width weights are drawn where they live."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def init(cfg, generator: torch.Generator, *, device=None) -> dict:
    """Random params for ``cfg`` on ``device`` (drawn from ``generator``
    through ``torch.Generator``: they differ from the reference's
    ``jax.random`` draws; the bridge carries the reference's over)."""
    dev = device_of(device)
    pattern, n_super, rem = _split(cfg)
    gen = _device_generator(generator, dev)
    dt = param_dtype(cfg)
    params = {"embed": embed_init(cfg, gen, dt, dev),
              "final_norm": norm_init(cfg, dt, dev)}
    params["blocks"] = tuple(_stacked_init(cfg, gen, kind, dev, n_super)
                             for kind in pattern) if n_super else ()
    params["rem_blocks"] = tuple(block_init(cfg, gen, pattern[i], dev)
                                 for i in range(rem))
    return params


def _stacked_init(cfg, gen, kind, dev, n: int) -> dict:
    """``n`` layers of ``kind`` drawn one after another, each copied into
    its row of the stacked leaves as it is drawn, so the peak is the
    stack and one layer (Mixtral's 16 layers are 47 GB in bf16)."""
    out = None
    for i in range(n):
        layer = block_init(cfg, gen, kind, dev)
        if out is None:
            out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)),
                           layer)
        tree_map(lambda o, x: o[i].copy_(x), out, layer)
    return out


def _write(cache, new) -> None:
    """Copy a block's new state into its cache views, in place."""
    for key, value in new.items():
        if isinstance(value, dict):
            _write(cache[key], value)
        else:
            cache[key].copy_(value)


def _ffn(p, cfg, kind, x, decode=False):
    """The block's FFN: (y, aux) for ``moe`` (dropless when ``decode``,
    else at the config's capacity factor), (y, None) for the MLP kinds."""
    if kind == "moe":
        return moe_mod.moe_apply(p["ffn"], cfg, x, _decode_moe_cf(cfg)
                                 if decode else None)
    return mlp_apply(p["ffn"], cfg, x), None


def _decode_moe_cf(cfg) -> float:
    """Decode is dropless (capacity factor E makes the capacity tokens *
    top_k): which tokens a dropping dispatch keeps depends on the tokens
    that share it, so a served token's logits would change with its
    co-scheduled slots and with tick batching, breaking speculative and
    multi-tick token identity.  Training and prefill keep the
    configured (dropping) factor."""
    return float(cfg.moe.n_experts)


def block_apply_seq(p, cfg, kind, h, *, cache=None, length=None,
                    zero_state=False):
    """One full-sequence block: h (B,S,d) -> (h (B,S,d), aux: the moe
    FFN's fp32 aux loss, or None for the other kinds).  With ``cache``
    (this layer's views of the decode cache) the block resumes from it
    and writes its state after the prefix back in place, per row up to
    ``length`` when given: the ``rwkv`` / ``rec`` state, or the ring's K/V
    for ``dense`` / ``attn``.  ``zero_state`` says the cache holds the
    zero state (a fresh prefill), so the WKV runs from zero."""
    if kind == "rwkv":
        carried = cache is not None and not zero_state
        y, (tm_shift, wkv) = rwkv_mod.time_mix_seq(
            p, cfg, norm_apply(p["norm1"], cfg, h),
            cache["tm_shift"] if carried else None,
            cache["wkv"] if carried else None, length=length)
        h = h + y
        y, cm_shift = rwkv_mod.channel_mix_seq(
            p, cfg, norm_apply(p["norm2"], cfg, h),
            cache["cm_shift"] if carried else None, length=length)
        if cache is not None:
            _write(cache, {"tm_shift": tm_shift, "wkv": wkv,
                           "cm_shift": cm_shift})
        return h + y, None
    x = norm_apply(p["norm1"], cfg, h)
    if kind == "rec":
        y, new = rglru_mod.rglru_seq(
            p["mix"], cfg, x, None if cache is None else cache["mix"],
            length)
        if cache is not None:
            _write(cache["mix"], new)
    else:
        # dense layers are windowed when the config says so; hybrid attn
        # layers are local by construction (the reference's _window)
        y = attn.full_attention(p["attn"], cfg, x, causal=True,
                                window=cfg.sliding_window, cache=cache,
                                length=length)
    h = h + y
    y, aux = _ffn(p, cfg, kind, norm_apply(p["norm2"], cfg, h))
    return h + y, aux


def block_apply_decode(p, cfg, kind, h, cache, pos, table=None):
    """One single-token block: h (B,1,d) -> h (B,1,d); writes this
    layer's cache in place.  ``table`` switches an attention cache to the
    block pool (``attention.decode_attention``); the recurrent kinds hold
    a constant-size state and take none."""
    if kind == "rwkv":
        x = norm_apply(p["norm1"], cfg, h)[:, 0]
        y, (tm_shift, wkv) = rwkv_mod.time_mix_decode(
            p, cfg, x, cache["tm_shift"], cache["wkv"])
        h = h + y[:, None]
        x = norm_apply(p["norm2"], cfg, h)[:, 0]
        y, cm_shift = rwkv_mod.channel_mix_decode(p, cfg, x,
                                                  cache["cm_shift"])
        _write(cache, {"tm_shift": tm_shift, "wkv": wkv,
                       "cm_shift": cm_shift})
        return h + y[:, None]
    x = norm_apply(p["norm1"], cfg, h)
    if kind == "rec":
        y, new = rglru_mod.rglru_decode(p["mix"], cfg, x[:, 0], cache["mix"])
        _write(cache["mix"], new)
        h = h + y[:, None]
    else:
        h = h + attn.decode_attention(p["attn"], cfg, x, cache, pos,
                                      window=cfg.sliding_window, table=table)
    x = norm_apply(p["norm2"], cfg, h)
    return h + _ffn(p, cfg, kind, x, decode=True)[0]


def block_apply_decode_seq(p, cfg, kind, h, cache, pos, commit_len):
    """A T-token chunk through one block: h (B,T,d) -> h (B,T,d), the
    outputs T sequential ``block_apply_decode`` steps would give; the
    cache advances in place by each row's first ``commit_len[b]``
    tokens only."""
    h, pending = block_decode_seq_pending(p, cfg, kind, h, cache, pos)
    block_commit_seq(p, cfg, kind, cache, pending, pos, commit_len)
    return h


def block_decode_seq_pending(p, cfg, kind, h, cache, pos):
    """The forward half: (h (B,T,d), pending), the cache untouched.
    ``pending`` holds what ``block_commit_seq`` needs to commit any
    per-row prefix: the write-ready K/V chunk of the attention kinds, the
    normed sublayer inputs of the recurrent kinds."""
    if kind == "rwkv":
        x1 = norm_apply(p["norm1"], cfg, h)
        y, _ = rwkv_mod.time_mix_seq(p, cfg, x1, cache["tm_shift"],
                                     cache["wkv"])
        h = h + y
        x2 = norm_apply(p["norm2"], cfg, h)
        y, _ = rwkv_mod.channel_mix_seq(p, cfg, x2, cache["cm_shift"])
        return h + y, {"x1": x1, "x2": x2}
    x = norm_apply(p["norm1"], cfg, h)
    if kind == "rec":
        y, _ = rglru_mod.rglru_seq(p["mix"], cfg, x, cache["mix"])
        pending = {"x1": x}
    else:
        y, pending = attn.decode_attention_seq_pending(
            p["attn"], cfg, x, cache, pos, window=cfg.sliding_window)
    h = h + y
    x = norm_apply(p["norm2"], cfg, h)
    return h + _ffn(p, cfg, kind, x, decode=True)[0], pending


def _commit_state(cache, new, cl) -> None:
    """Write a recurrent state re-run over each row's first ``cl[b]``
    tokens into its cache views, in place.  A row committing 0 keeps its
    old state: there the length-masked carries would take position 0's
    values, not the state before the chunk."""
    for key, value in new.items():
        old = cache[key]
        m = (cl > 0).reshape((-1,) + (1,) * (old.ndim - 1))
        old.copy_(torch.where(m, value.to(old.dtype), old))


def block_commit_seq(p, cfg, kind, cache, pending, pos, commit_len):
    """The commit half: advance this layer's cache in place by each row's
    first ``commit_len[b]`` tokens of a ``block_decode_seq_pending``
    chunk."""
    cl = torch.as_tensor(commit_len, device=pos.device).long().expand(
        pos.shape[0])
    if kind == "rwkv":
        _, (tm_shift, wkv) = rwkv_mod.time_mix_seq(
            p, cfg, pending["x1"], cache["tm_shift"], cache["wkv"],
            length=cl)
        _, cm_shift = rwkv_mod.channel_mix_seq(
            p, cfg, pending["x2"], cache["cm_shift"], length=cl)
        _commit_state(cache, {"tm_shift": tm_shift, "wkv": wkv,
                              "cm_shift": cm_shift}, cl)
    elif kind == "rec":
        _, new = rglru_mod.rglru_seq(p["mix"], cfg, pending["x1"],
                                     cache["mix"], length=cl)
        _commit_state(cache["mix"], new, cl)
    else:
        attn.commit_attention_seq(cache, pending, pos, cl)


def _layers(stacked, n: int) -> list:
    """The ``n`` per-layer trees of a stacked block tree (``unbind``
    views: one stack of the layers' grads in the backward)."""
    parts = tree_map(lambda x: x.unbind(0), stacked)

    def select(t, i):
        return {k: select(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else t[i]

    return [select(parts, i) for i in range(n)]


def _all_layers(tree, cfg) -> list:
    """One subtree per layer of a params or decode-cache tree, in the
    reference's superblock-major order (``layer_kinds``): views of the
    stacked leaves (writes to a cache's land in the stacked tensors),
    then the remainder layers'."""
    _, n_super, _ = _split(cfg)
    stacks = [_layers(stacked, n_super) for stacked in tree["blocks"]]
    return [stack[i] for i in range(n_super) for stack in stacks] + \
        list(tree["rem_blocks"])


def forward(params, cfg, tokens, *, cache=None, length=None,
            zero_state=False):
    """tokens (B,S) -> (fp32 logits (B,S,V), aux: the fp32 sum of the
    ``moe`` layers' aux losses, 0 without any).  With ``cache`` (an
    ``init_decode_cache`` tree) the layers resume from it and write their
    state after the prefix in place (per row up to ``length``), and the
    result is (logits, aux, cache); ``zero_state`` says the cache is
    fresh (``block_apply_seq``)."""
    h = embed_apply(params["embed"], cfg, tokens)
    layers = _all_layers(params, cfg)
    caches = [None] * len(layers) if cache is None \
        else _all_layers(cache, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for kind, layer, c in zip(layer_kinds(cfg), layers, caches,
                              strict=True):
        h, a = block_apply_seq(layer, cfg, kind, h, cache=c, length=length,
                               zero_state=zero_state)
        if a is not None:
            aux = aux + a
    h = norm_apply(params["final_norm"], cfg, h)
    logits = unembed_apply(params["embed"], cfg, h)
    return (logits, aux) if cache is None else (logits, aux, cache)


def prefill(params, cfg, tokens, capacity: int, *, length=None):
    """Prompt (B,S) -> (logits (B,S,V), a decode cache of ``capacity``
    filled with it).  ``length`` marks per-row true lengths of
    right-padded prompts: the cache comes out as if each row had been
    prefilled unpadded at its own length."""
    cache = init_decode_cache(cfg, tokens.shape[0], capacity,
                              device=tokens.device)
    logits, _, cache = forward(params, cfg, tokens, cache=cache,
                               length=length, zero_state=True)
    return logits, cache


def _block_cache_init(cfg, kind, batch, capacity, device, lead=()):
    """One pattern position's zero cache, with the stacked-layer axis
    ``lead`` before batch: the recurrent state of ``rwkv`` / ``rec``, a
    ring of ``attention.cache_capacity`` slots for the attention kinds."""
    dt = param_dtype(cfg)
    if kind == "rwkv":
        return rwkv_mod.init_rwkv_cache(cfg, batch, dt, device, lead)
    if kind == "rec":
        return {"mix": rglru_mod.init_rglru_cache(cfg, batch, dt, device,
                                                  lead)}
    return attn.init_cache(cfg, batch, attn.cache_capacity(cfg, capacity),
                           dt, device, lead=lead)


def init_decode_cache(cfg, batch: int, seq_len: int, *, device=None):
    """The stacked per-layer caches, in the params' tree: ``{"blocks":
    (one per pattern position, leaves (n_super, batch, ...)),
    "rem_blocks": (one per remainder layer)}``.  An attention layer's is a
    ring {k, v[, k_scale, v_scale]: (.., batch, cap, Hkv, hd)} with ``cap
    = cache_capacity(cfg, seq_len)`` in the params' dtype (or the
    numerics policy's ``kv_cache_dtype``); a ``rwkv`` layer's {tm_shift,
    wkv, cm_shift}, a ``rec`` layer's {mix: {conv, h}}, their fp32 parts
    fp32."""
    dev = device_of(device)
    pattern, n_super, rem = _split(cfg)
    return {"blocks": tuple(_block_cache_init(cfg, kind, batch, seq_len,
                                              dev, (n_super,))
                            for kind in pattern) if n_super else (),
            "rem_blocks": tuple(_block_cache_init(cfg, pattern[i], batch,
                                                  seq_len, dev)
                                for i in range(rem))}


def decode_step(params, cfg, cache, tokens, pos, table=None):
    """One decode step.  tokens (B,1) ints; pos (B,) ints, each row's
    absolute position.  Writes ``cache`` in place and returns fp32
    logits (B,1,V).  ``table`` (B, cap/bs) int32: the block-pool layout
    (``attention.decode_attention``)."""
    h = embed_apply(params["embed"], cfg, tokens)
    for kind, layer, c in zip(layer_kinds(cfg), _all_layers(params, cfg),
                              _all_layers(cache, cfg), strict=True):
        h = block_apply_decode(layer, cfg, kind, h, c, pos, table)
    h = norm_apply(params["final_norm"], cfg, h)
    return unembed_apply(params["embed"], cfg, h)


def decode_seq(params, cfg, cache, tokens, pos, commit_len):
    """Chunked decode: tokens (B,T) at positions ``pos .. pos+T-1``;
    returns fp32 logits (B,T,V), each what sequential ``decode_step``
    calls would give, and advances ``cache`` in place by each row's first
    ``commit_len[b]`` tokens."""
    logits, pending = decode_seq_pending(params, cfg, cache, tokens, pos)
    decode_seq_commit(params, cfg, cache, pending, pos, commit_len)
    return logits


def decode_seq_pending(params, cfg, cache, tokens, pos):
    """The commit-independent half of ``decode_seq``: the whole T-token
    forward from ``cache``, which it leaves untouched.  Returns (fp32
    logits (B,T,V), pending: one entry per layer, in ``layer_kinds``
    order) for ``decode_seq_commit``."""
    h = embed_apply(params["embed"], cfg, tokens)
    pending = []
    for kind, layer, c in zip(layer_kinds(cfg), _all_layers(params, cfg),
                              _all_layers(cache, cfg), strict=True):
        h, pd = block_decode_seq_pending(layer, cfg, kind, h, c, pos)
        pending.append(pd)
    h = norm_apply(params["final_norm"], cfg, h)
    return unembed_apply(params["embed"], cfg, h), pending


def decode_seq_commit(params, cfg, cache, pending, pos, commit_len) -> None:
    """Advance ``cache`` in place by each row's first ``commit_len[b]``
    tokens of a ``decode_seq_pending`` chunk; no attention math re-runs."""
    commit_len = torch.as_tensor(commit_len, device=pos.device).long() \
        .expand(pos.shape[0])
    for kind, layer, c, pd in zip(layer_kinds(cfg), _all_layers(params, cfg),
                                  _all_layers(cache, cfg), pending,
                                  strict=True):
        block_commit_seq(layer, cfg, kind, c, pd, pos, commit_len)


def param_shapes(cfg) -> dict:
    """The params tree's shapes (tuples of ints), without allocating."""
    pattern, n_super, rem = _split(cfg)
    d = cfg.d_model
    v = cfg.padded_vocab
    norm = {} if cfg.norm == "np_ln" else (
        {"scale": (d,), "bias": (d,)} if cfg.norm == "layernorm"
        else {"scale": (d,)})
    hq, hkv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    ffn = {"w_in": (d, f), "w_out": (f, d)}
    if cfg.mlp in ("swiglu", "geglu"):
        ffn["w_gate"] = (d, f)

    def block(kind):
        p = {"norm1": norm, "norm2": norm}
        if kind == "rwkv":
            return {**rwkv_mod.param_shapes(cfg), **p}
        if kind == "rec":
            p["mix"] = rglru_mod.param_shapes(cfg)
        else:
            p["attn"] = {"wq": (d, hq, hd), "wk": (d, hkv, hd),
                         "wv": (d, hkv, hd), "wo": (hq, hd, d)}
        p["ffn"] = moe_mod.param_shapes(cfg) if kind == "moe" else ffn
        return p

    embed = {"tok": (v, d)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = (d, v)

    def stack(t):
        return {k: stack(v) for k, v in t.items()} \
            if isinstance(t, dict) else (n_super,) + t

    return {"embed": embed, "final_norm": norm,
            "blocks": tuple(stack(block(kind)) for kind in pattern)
            if n_super else (),
            "rem_blocks": tuple(block(pattern[i]) for i in range(rem))}
