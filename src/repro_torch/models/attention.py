"""Full-sequence attention: GQA/MQA, causal and sliding-window masks (the
counterpart of ``repro/models/attention.py``'s training path).

``full_attention`` projects q, k and v, applies RoPE to q and k, groups
the query heads onto their KV heads, runs the attention the config's
``KernelPolicy`` selects (``resolve_impl``) and projects back:

  ``flash``  the flash-attention kernels (``kernels.flash_attention``):
             forward, dq and dk/dv on CUDA tensors, the plain version on
             CPU tensors
  ``xla``    the plain masked-softmax version on any device

Cross-attention memory and a query offset raise, as the reference's
flash path does; the reference's ``chunked`` / ``qloop`` and the decode
surface (KV cache, ring buffer) are not ported (ROADMAP queue A).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import policy_of
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, dense_init, matmul, \
    rope_freqs

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
                   window=None, impl=None, q_offset=0):
    """x (B,S,d) -> (B,S,d): self-attention over the whole sequence."""
    b, s, _ = x.shape
    impl = resolve_impl(cfg, cross=xc is not None, q_offset=q_offset,
                        impl=impl)
    q, k, v = _qkv(params, cfg, x)
    if rope:
        inv = rope_freqs(cfg, x.device)
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, inv)
        k = apply_rope(k, pos, inv)
    qg = _group(q, cfg.n_kv_heads)
    pol = policy_of(cfg)
    o = flash_ops.flash_attention(
        qg, k, v, causal=causal, window=window, scale=cfg.head_dim ** -0.5,
        backend="plain" if impl == "xla" else pol.attention_backend())
    return _out(params, cfg, o.reshape(b, s, cfg.n_heads, cfg.head_dim))
