"""Attention: GQA/MQA, causal and sliding-window masks, and the decode
surface (the counterpart of ``repro/models/attention.py``).

``full_attention`` projects q, k and v, applies RoPE to q and k, groups
the query heads onto their KV heads, runs the attention the config's
``KernelPolicy`` selects (``resolve_impl``) and projects back:

  ``flash``  the flash-attention kernels (``kernels.flash_attention``):
             forward, dq and dk/dv on CUDA tensors, the plain version on
             CPU tensors
  ``xla``    the plain masked-softmax version on any device

Cross-attention memory and a query offset raise, as the reference's
flash path does; the reference's ``chunked`` / ``qloop`` are not ported
(ROADMAP queue A).

The decode surface: ``init_cache`` builds a ring KV cache of
``cache_capacity`` slots per row (bf16/fp32, or int8 with fp32 scales,
per ``numerics.kv_cache_spec``); ``fill_cache`` writes a prompt's K/V
into it (per-row ``length`` for right-padded prompts), and
``full_attention(..., cache=)`` does so from the K/V it computed anyway;
``decode_attention`` writes one token's K/V at slot ``pos % cap`` and
attends over the valid slots through the flash-decode kernels
(``kernels.decode_attention``), on a ring or, with ``table``, on the
block pool.  Unlike the reference's functional ``.at[].set`` (whose
state is donated), every cache write here lands IN PLACE in the tensors
passed in: a copy of the cache per token would swamp the step.

Speculative decoding's chunk: ``decode_attention_seq_pending`` runs T
tokens per row against the UNMUTATED ring (the ring slots a sequential
step would still see, plus the causal in-flight tokens) in plain
PyTorch, as the reference's verify is plain XLA, and returns the
write-ready K/V; ``commit_attention_seq`` writes each row's first
``commit_len`` of them into the ring in place.  Cross-attention decode
belongs to the encdec family (ROADMAP queue A item 8, A8b).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import policy_of
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import NEG
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, matmul, \
    rope_freqs
from repro_torch.numerics import kv_cache_spec

IMPLS = ("xla", "flash")


def resolve_impl(cfg, *, cross: bool = False, q_offset=0,
                 impl: str = None) -> str:
    """``flash`` or ``xla`` for one call.  Precedence: explicit ``impl`` >
    ``cfg.kernels.attention`` > ``auto`` (= ``flash``: the kernels on the
    card, their plain version on the CPU)."""
    sel = impl if impl is not None else (policy_of(cfg).attention or "auto")
    if cross or q_offset != 0:
        why = "cross-attention memory" if cross else \
            f"a query offset ({q_offset})"
        raise NotImplementedError(
            f"attention with {why} is not ported yet: see ROADMAP.md queue "
            "A (the decode surface and encdec come with later slices)")
    if sel in ("auto", "flash"):
        return "flash"
    if sel == "xla":
        return "xla"
    raise ValueError(f"unknown attention impl {sel!r}; known: "
                     f"{IMPLS + ('auto',)}")


def attn_init(cfg, generator, dtype, device):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def w(d_in, d_out, shape):
        return dense_init((d_in, d_out), generator, dtype,
                          device).reshape(shape)

    return {"wq": w(d, hq * hd, (d, hq, hd)),
            "wk": w(d, hkv * hd, (d, hkv, hd)),
            "wv": w(d, hkv * hd, (d, hkv, hd)),
            "wo": w(hq * hd, d, (hq, hd, d))}


def _proj(x, w):
    """x (B,S,d) @ w (d,H,hd) -> (B,S,H,hd)."""
    b, s, d = x.shape
    return matmul(x, w.reshape(d, -1)).reshape(b, s, w.shape[1], w.shape[2])


def _qkv(params, cfg, x):
    return (_proj(x, params["wq"]), _proj(x, params["wk"]),
            _proj(x, params["wv"]))


def _out(params, cfg, o):
    """o (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d)."""
    b, s, h, hd = o.shape
    return matmul(o.reshape(b, s, h * hd), params["wo"].reshape(h * hd, -1))


def _group(q, n_kv):
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def full_attention(params, cfg, x, *, xc=None, causal=True, rope=True,
                   window=None, impl=None, q_offset=0, cache=None,
                   length=None):
    """x (B,S,d) -> (B,S,d): self-attention over the whole sequence.
    With ``cache`` its K/V also fill that ring in place (``fill_cache``)."""
    b, s, _ = x.shape
    impl = resolve_impl(cfg, cross=xc is not None, q_offset=q_offset,
                        impl=impl)
    q, k, v = _qkv(params, cfg, x)
    if rope:
        inv = rope_freqs(cfg, x.device)
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, inv)
        k = apply_rope(k, pos, inv)
    if cache is not None:
        _fill(cache, k, v, length)
    qg = _group(q, cfg.n_kv_heads)
    pol = policy_of(cfg)
    o = flash_ops.flash_attention(
        qg, k, v, causal=causal, window=window, scale=cfg.head_dim ** -0.5,
        backend="plain" if impl == "xla" else pol.attention_backend())
    return _out(params, cfg, o.reshape(b, s, cfg.n_heads, cfg.head_dim))


# ------------------------------------------------------------- KV cache ----

def cache_capacity(cfg, seq_len: int, window=None) -> int:
    w = window if window is not None else cfg.sliding_window
    return min(seq_len, w) if w is not None else seq_len


def init_cache(cfg, batch: int, capacity: int, dtype, device,
               lead: tuple = ()) -> dict:
    """A zeroed ring KV cache {k, v: (*lead, batch, capacity, Hkv, hd)}
    in the storage dtype of ``numerics.kv_cache_spec``; an int8 cache
    also has fp32 ``k_scale`` / ``v_scale`` (*lead, batch, capacity,
    Hkv).  ``lead`` is the stacked-layer axis of the transformer's
    cache."""
    store, quant = kv_cache_spec(cfg, dtype)
    shape = tuple(lead) + (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=store, device=device),
             "v": torch.zeros(shape, dtype=store, device=device)}
    if quant:
        cache["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=device)
    return cache


def _kv_quant(x):
    """Symmetric int8 quantization over the hd axis: x (..., hd) ->
    (int8 values, fp32 scale (...)).  amax is clamped so all-zero rows get
    scale eps, not 0."""
    xf = x.float()
    scale = xf.abs().amax(-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q, scale):
    return q.float() * scale[..., None].float()


def _fill(cache, k, v, length=None):
    """Write the last ``cap`` positions of k, v (B,S,Hkv,hd) into the
    ring at slot ``position % cap``, in place.  ``length`` (int, or (B,)
    ints) is each row's true prefix length in a right-padded batch: row
    b keeps only positions ``< length[b]``, so a bucketed prefill fills
    the ring exactly as an unpadded one would."""
    b, s = k.shape[:2]
    cap = cache["k"].shape[1]
    take = min(cap, s)
    ln = torch.as_tensor(s if length is None else length, dtype=torch.long,
                         device=k.device).expand(b)
    # the last `take` positions relative to each row's length; `take`
    # consecutive ints stay distinct mod cap, so no row writes a slot twice
    positions = ln[:, None] - take + torch.arange(take, device=k.device)
    valid = positions >= 0
    rows = torch.arange(b, device=k.device)[:, None].expand(b, take)
    pclip = positions.clamp(0, s - 1)
    kw, vw = k[rows, pclip], v[rows, pclip]
    if "k_scale" in cache:
        kw, ks = _kv_quant(kw)
        vw, vs = _kv_quant(vw)
    rows, slots = rows[valid], torch.remainder(positions, cap)[valid]
    cache["k"][rows, slots] = kw[valid].to(cache["k"].dtype)
    cache["v"][rows, slots] = vw[valid].to(cache["v"].dtype)
    if "k_scale" in cache:
        cache["k_scale"][rows, slots] = ks[valid]
        cache["v_scale"][rows, slots] = vs[valid]


def fill_cache(params, cfg, x, cache, *, rope=True, length=None):
    """Fill a ring cache in place from a full prefix x (B,S,d): the K/V
    the last ``cap`` positions would have written in S decode steps
    (``length``: per-row true lengths, see ``_fill``).  Returns the
    cache."""
    _, k, v = _qkv(params, cfg, x)
    if rope:
        k = apply_rope(k, torch.arange(x.shape[1], device=x.device),
                       rope_freqs(cfg, x.device))
    _fill(cache, k, v, length)
    return cache


def decode_attention(params, cfg, x, cache, pos, *, window=None, rope=True,
                     table=None):
    """One-token decode.  x (B,1,d); cache {k, v} (B,cap,Hkv,hd) rings
    (with ``table`` (B, cap/bs) int32: (NB,bs,Hkv,hd) block pools); pos
    (B,) int: the absolute position of each row's token.

    Writes each row's K/V at slot ``pos % cap`` in place (on the pool,
    at ``table[b, slot // bs]``, offset ``slot % bs``), then attends over
    the valid slots through the policy's ``decode_backend``: the kernels
    on CUDA tensors, the plain version on CPU tensors or under
    ``decode_attention="xla"``.  Returns out (B,1,d)."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(params, cfg, x)
    bs = cache["k"].shape[1]
    cap = bs if table is None else table.shape[1] * bs
    pv = torch.as_tensor(pos, device=x.device).expand(b)
    if rope:
        inv = rope_freqs(cfg, x.device)
        q = apply_rope(q, pv[:, None], inv)
        k_new = apply_rope(k_new, pv[:, None], inv)
    slot = torch.remainder(pv.long(), cap)
    kw, vw = k_new[:, 0], v_new[:, 0]
    quant = "k_scale" in cache
    if quant:
        kw, ks = _kv_quant(kw)                      # scale (B, Hkv)
        vw, vs = _kv_quant(vw)
    if table is None:
        wr, ws = torch.arange(b, device=x.device), slot
    else:
        # rows never share a writable block; retired rows all point at the
        # trash block, where their colliding writes are harmless
        wr = table.gather(1, (slot // bs)[:, None])[:, 0].long()
        ws = slot % bs
    cache["k"][wr, ws] = kw.to(cache["k"].dtype)
    cache["v"][wr, ws] = vw.to(cache["v"].dtype)
    if quant:
        cache["k_scale"][wr, ws] = ks
        cache["v_scale"][wr, ws] = vs
    qg = q.reshape(b, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                   cfg.head_dim)
    o = decode_ops.decode_attention(
        qg, cache["k"], cache["v"], pv.to(torch.int32), window=window,
        scale=cfg.head_dim ** -0.5, k_scale=cache.get("k_scale"),
        v_scale=cache.get("v_scale"), table=table,
        backend=policy_of(cfg).decode_backend())
    return _out(params, cfg, o.reshape(b, 1, cfg.n_heads, cfg.head_dim))


def decode_attention_seq(params, cfg, x, cache, pos, commit_len, *,
                         window=None, rope=True):
    """Chunked decode: x (B,T,d) at positions ``pos .. pos+T-1`` against
    the ring as it is, then each row's first ``commit_len[b]`` tokens
    written into it in place.  Returns out (B,T,d)."""
    out, pending = decode_attention_seq_pending(params, cfg, x, cache, pos,
                                                window=window, rope=rope)
    commit_attention_seq(cache, pending, pos, commit_len)
    return out


def decode_attention_seq_pending(params, cfg, x, cache, pos, *,
                                 window=None, rope=True):
    """The commit-independent half of ``decode_attention_seq``; writes
    nothing.  x (B,T,d) holds the tokens at positions ``pos .. pos+T-1``
    (pos (B,): the tokens each row has consumed).  Token j attends over
    the ring slots a sequential step j would still see (written, not yet
    overwritten by steps <= j, inside the window) and the in-flight
    tokens 0..j.  Returns (out (B,T,d), pending: the K/V chunk in the
    cache's storage type, quantized with its scales for an int8 cache).
    Under int8 the in-flight K/V enter the scores dequantized, as
    sequential steps read back what they wrote."""
    b, t, _ = x.shape
    cap = cache["k"].shape[1]
    if t > cap:
        raise ValueError(f"decode_seq over {t} tokens needs ring capacity "
                         f">= {t} (distinct slots mod cap); got {cap}")
    dev = x.device
    q, k_new, v_new = _qkv(params, cfg, x)
    pv = torch.as_tensor(pos, device=dev).long().expand(b)
    positions = pv[:, None] + torch.arange(t, device=dev)        # (B, T)
    if rope:
        inv = rope_freqs(cfg, dev)
        q = apply_rope(q, positions, inv)
        k_new = apply_rope(k_new, positions, inv)
    quant = "k_scale" in cache
    kw, vw = k_new, v_new
    if quant:
        kw, ks = _kv_quant(k_new)                   # scales (B, T, Hkv)
        vw, vs = _kv_quant(v_new)
        k_new = _kv_dequant(kw, ks).to(x.dtype)
        v_new = _kv_dequant(vw, vs).to(x.dtype)

    # slot i holds position (pos-1) - ((pos-1-i) mod cap); query j sees it
    # iff it exists, no step <= j has overwritten it (slot_pos > p_j -
    # cap), and it lies inside the window
    base = pv - 1
    idx = torch.arange(cap, device=dev)
    slot_pos = base[:, None] - torch.remainder(base[:, None] - idx, cap)
    sp, pj = slot_pos[:, None, :], positions[:, :, None]
    valid_r = (sp >= 0) & (sp > pj - cap)                        # (B,T,cap)
    if window is not None:
        valid_r &= sp > pj - window
    ka, va = cache["k"], cache["v"]
    if quant:
        ka = _kv_dequant(ka, cache["k_scale"])
        va = _kv_dequant(va, cache["v_scale"])
    qg = _group(q, cfg.n_kv_heads).float()               # (B,T,Hkv,G,hd)
    scale = cfg.head_dim ** -0.5
    s_r = torch.einsum("bqhgk,bshk->bhgqs", qg, ka.float()) * scale
    s_r = s_r.masked_fill(~valid_r[:, None, None], NEG)

    # in-flight scores: causal over the T tokens themselves
    j = torch.arange(t, device=dev)
    diff = j[:, None] - j[None, :]
    valid_f = (diff >= 0) & (diff < cap)
    if window is not None:
        valid_f &= diff < window
    s_f = torch.einsum("bqhgk,bshk->bhgqs", qg, k_new.float()) * scale
    s_f = s_f.masked_fill(~valid_f, NEG)

    # P rounds to the activations' type, as the reference's does
    p = torch.softmax(torch.cat([s_r, s_f], -1), -1).to(x.dtype).float()
    v_all = torch.cat([va.float(), v_new.float()], 1)
    o = torch.einsum("bhgqs,bshk->bqhgk", p, v_all).to(x.dtype)
    pending = {"k": kw, "v": vw}
    if quant:
        pending["k_scale"], pending["v_scale"] = ks, vs
    return _out(params, cfg, o.reshape(b, t, cfg.n_heads, cfg.head_dim)), \
        pending


def commit_attention_seq(cache, pending, pos, commit_len) -> None:
    """Write each row's first ``commit_len[b]`` tokens of a
    ``decode_attention_seq_pending`` chunk into the ring at slot
    ``position % cap``, in place; the slots of the others keep their
    value.  T consecutive positions stay distinct mod cap, so no row
    writes a slot twice.  No attention math runs here."""
    b, t = pending["k"].shape[:2]
    cap = cache["k"].shape[1]
    dev = cache["k"].device
    pv = torch.as_tensor(pos, device=dev).long().expand(b)
    cl = torch.as_tensor(commit_len, device=dev).long().expand(b)
    rows = torch.arange(b, device=dev)[:, None]
    slots = torch.remainder(pv[:, None] + torch.arange(t, device=dev), cap)
    keep = torch.arange(t, device=dev)[None, :] < cl[:, None]     # (B, T)
    for key, new in pending.items():
        leaf = cache[key]
        m = keep.reshape(keep.shape + (1,) * (new.ndim - 2))
        # a select, not a boolean index: the commit never waits for the
        # card to count the committed tokens
        leaf[rows, slots] = torch.where(m, new.to(leaf.dtype),
                                        leaf[rows, slots])
