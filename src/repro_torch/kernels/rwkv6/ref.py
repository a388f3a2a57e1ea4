"""Plain fp32 versions of the RWKV6 (Finch) WKV recurrence (the
counterparts of ``repro/kernels/rwkv6/ref.py``).

Per head, with the state S (K x K, key dim x value dim):

    y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv_sequential`` walks the steps one by one.  ``wkv_chunked`` is the
reference's chunked-parallel form: within a chunk of C steps the (C, C)
decay-weighted scores use exponents ``cum_{t-1} - cum_s <= 0`` (no
overflow) and the state is carried from chunk to chunk.  It takes
``log(w)``, so a ``w`` that underflowed to 0 makes it NaN where the
sequential form stays finite (ROADMAP.md section C).  ``chunk_step``
is one chunk of it, which the WKV backward rebuilds chunk by chunk
(``ops.WKV``).  ``wkv_decode`` is one step from a given state (the
serving path's decode).
"""
from __future__ import annotations

import torch


def wkv_sequential(r, k, v, w, u, s0=None):
    """r, k, v, w (B,T,H,K), w the per-step decay; u (H,K).  Returns y
    (B,T,H,K) and the final state (B,H,K,K), fp32."""
    b, t, h, kk = r.shape
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    s = (torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]        # (B,H,K,K)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i],
                               s + u[None, :, :, None] * kv))
        s = w[:, i, :, :, None] * s + kv
    y = torch.stack(ys, 1) if ys else r.new_zeros((b, 0, h, kk))
    return y, s


def pad_steps(x, chunk: int, value: float = 0.0):
    """x (B,T,...) padded along T to a multiple of ``chunk`` with
    ``value``: k = v = 0 and w = 1 make inert steps (the state is
    unchanged)."""
    pad = -x.shape[1] % chunk
    if not pad:
        return x
    return torch.cat([x, x.new_full((x.shape[0], pad) + tuple(x.shape[2:]),
                                    value)], 1)


def to_chunks(x, chunk: int):
    """(B,T,H,K) with T % chunk == 0 -> (nc, B, H, C, K) fp32."""
    b, t, h, kk = x.shape
    return x.float().reshape(b, t // chunk, chunk, h, kk).permute(1, 0, 3, 2,
                                                                  4)


def chunk_carry(s, k, v, cum):
    """The state after a chunk: S' = diag(e^{cum_C}) S + sum_s (k_s
    e^{cum_C - cum_s}) v_s^T, with cum the chunk's cumulative log w."""
    cend = cum[..., -1:, :]                              # (B,H,1,K)
    kscaled = k * torch.exp(cend - cum)
    return torch.exp(cend[..., 0, :])[..., :, None] * s + \
        kscaled.transpose(-1, -2) @ v


def chunk_step(s, r, k, v, w, u):
    """One chunk: s (B,H,K,K) the state before it; r, k, v, w (B,H,C,K)
    fp32; u (H,K).  Returns (y (B,H,C,K), the state after it)."""
    c = r.shape[-2]
    lw = torch.log(w)                                   # <= 0
    cum = torch.cumsum(lw, dim=-2)                      # cum_t
    cum_prev = cum - lw                                 # cum_{t-1}
    tri = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    # A[t,s] = sum_i r[t,i] k[s,i] e^{cum_{t-1,i} - cum_{s,i}} for s < t
    expo = cum_prev[..., :, None, :] - cum[..., None, :, :]  # (B,H,C,C,K)
    dec = torch.exp(expo.masked_fill(~tri[:, :, None], -torch.inf))
    a = (r[..., :, None, :] * k[..., None, :, :] * dec).sum(-1)
    diag = (r * u.float()[None, :, None, :] * k).sum(-1)       # (B,H,C)
    a = a + torch.diag_embed(diag)
    # within the chunk, then across chunks: y_t += (r_t e^{cum_{t-1}}) S
    y = a @ v + (r * torch.exp(cum_prev)) @ s
    return y, chunk_carry(s, k, v, cum)


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = 64):
    """The chunked-parallel WKV6, equal to ``wkv_sequential`` in fp32 up
    to rounding.  T is padded to a chunk multiple with inert steps and
    the padded outputs are sliced off.  Returns (y, final state), fp32."""
    b, t, h, kk = r.shape
    r, k, v = (pad_steps(x, chunk) for x in (r, k, v))
    w = pad_steps(w, chunk, 1.0)
    s = (torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for rc, kc, vc, wc in zip(*(to_chunks(x, chunk) for x in (r, k, v, w))):
        y, s = chunk_step(s, rc, kc, vc, wc, u)
        ys.append(y)
    y = torch.stack(ys, 1)                               # (B,nc,H,C,K)
    y = y.permute(0, 1, 3, 2, 4).reshape(b, -1, h, kk)
    return y[:, :t], s


def wkv_decode(r, k, v, w, u, s):
    """One token: r, k, v, w (B,H,K); u (H,K); s (B,H,K,K) the state
    before it.  Returns (y (B,H,K), the state after it), fp32."""
    r, k, v, w = (x.float() for x in (r, k, v, w))
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r,
                     s.float() + u.float()[None, :, :, None] * kv)
    return y, w[..., :, None] * s.float() + kv
