"""Plain PyTorch versions of the flash-attention kernels.

``attention_ref`` is the reference's oracle (``repro/kernels/
flash_attention/ref.py``): masked-softmax attention in fp32, cast to q's
dtype, in the model layout.  ``attention_folded_ref`` is the same on the
folded (B*H, S, hd) layout the kernels take; autograd gives its
gradients, and it is what the port runs on CPU tensors.

``flash_fwd_ref``, ``flash_dq_ref`` and ``flash_dkv_ref`` repeat the
arithmetic of the three CUDA kernels with the kernels' signatures (the
forward's (o, lse); the backward's rebuild of p from lse, ds = p (dp -
delta)), so each kernel is held against its own plain version on the
card.  All of them form the (S, S) scores: they are for parity and CPU
runs, not for speed.  Masked entries use the finite NEG = -1e30.
"""
from __future__ import annotations

import torch

NEG = -1e30


def mask(sq: int, sk: int, causal: bool, window, device) -> torch.Tensor:
    """(sq, sk) validity: ``col <= row`` if causal, ``col > row - window``
    if a window is set."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        m = m & (cols <= rows)
    if window is not None:
        m = m & (cols > rows - window)
    return m


def attention_ref(q, k, v, *, causal=True, window=None, scale=1.0):
    """q (B,S,Hkv,G,hd); k,v (B,S,Hkv,hd) -> (B,S,Hkv,G,hd) in q's dtype."""
    s = torch.einsum("bqhgk,bshk->bhgqs", q.float(), k.float()) * scale
    s = torch.where(mask(q.shape[1], k.shape[1], causal, window, q.device),
                    s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqs,bshk->bqhgk", p, v.float()).to(q.dtype)


def expand_kv(x, n_q_heads: int, n_kv_heads: int):
    """(B*Hkv, S, hd) -> (B*Hq, S, hd): row ``b*Hq + h`` is KV row
    ``b*Hkv + h // G``."""
    bhkv, s, hd = x.shape
    b, g = bhkv // n_kv_heads, n_q_heads // n_kv_heads
    if g == 1:
        return x
    return x.view(b, n_kv_heads, 1, s, hd).expand(
        b, n_kv_heads, g, s, hd).reshape(b * n_q_heads, s, hd)


def _scores(q, k, n_q_heads, n_kv_heads, causal, window, scale):
    s = torch.matmul(q.float(), expand_kv(k, n_q_heads, n_kv_heads).float()
                     .transpose(-1, -2)) * scale
    return s, mask(q.shape[1], k.shape[1], causal, window, q.device)


def attention_folded_ref(q, k, v, *, n_q_heads: int, n_kv_heads: int,
                         causal=True, window=None, scale=1.0):
    """q (B*Hq,S,hd); k,v (B*Hkv,S,hd) -> o (B*Hq,S,hd) in q's dtype.
    Differentiable through autograd."""
    s, m = _scores(q, k, n_q_heads, n_kv_heads, causal, window, scale)
    p = torch.softmax(torch.where(m, s, NEG), dim=-1)
    return torch.matmul(p, expand_kv(v, n_q_heads, n_kv_heads).float()).to(
        q.dtype)


def flash_fwd_ref(q, k, v, *, n_q_heads: int, n_kv_heads: int, causal=True,
                  window=None, scale=1.0):
    """(o in q's dtype, lse fp32 (B*Hq, S)): the forward kernel's
    outputs."""
    s, m = _scores(q, k, n_q_heads, n_kv_heads, causal, window, scale)
    s = torch.where(m, s, NEG)
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p, expand_kv(v, n_q_heads, n_kv_heads).float()) / denom
    return o.to(q.dtype), (mx + torch.log(denom))[..., 0]


def _probs(q, k, v, do, lse, delta, n_q_heads, n_kv_heads, causal, window,
           scale):
    """p rebuilt from lse and ds = p (dp - delta), both (B*Hq, S, S)."""
    s, m = _scores(q, k, n_q_heads, n_kv_heads, causal, window, scale)
    p = torch.exp(torch.where(m, s - lse[..., None], NEG))
    dp = torch.matmul(do.float(), expand_kv(v, n_q_heads, n_kv_heads)
                      .float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_dq_ref(q, k, v, do, lse, delta, *, n_q_heads: int,
                 n_kv_heads: int, causal=True, window=None, scale=1.0):
    """dq in q's dtype: the dq kernel's output."""
    _, ds = _probs(q, k, v, do, lse, delta, n_q_heads, n_kv_heads, causal,
                   window, scale)
    kx = expand_kv(k, n_q_heads, n_kv_heads).float()
    return (torch.matmul(ds, kx) * scale).to(q.dtype)


def flash_dkv_ref(q, k, v, do, lse, delta, *, n_q_heads: int,
                  n_kv_heads: int, causal=True, window=None, scale=1.0):
    """(dk, dv) in k's dtype, summed over each KV head's G query heads:
    the dk/dv kernel's outputs."""
    p, ds = _probs(q, k, v, do, lse, delta, n_q_heads, n_kv_heads, causal,
                   window, scale)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    bhq, s, hd = q.shape
    b, g = bhq // n_q_heads, n_q_heads // n_kv_heads

    def fold(x):
        return x.reshape(b, n_kv_heads, g, s, hd).sum(2).reshape(
            b * n_kv_heads, s, hd).to(k.dtype)

    return fold(dk), fold(dv)
