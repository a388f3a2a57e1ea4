"""Plain fp32 versions of the RG-LRU diagonal linear recurrence (the
counterparts of ``repro/kernels/rglru/ref.py``):

    h_t = a_t * h_{t-1} + b_t          (elementwise over channels)

``rglru_sequential`` walks the steps from ``h0`` (zero by default);
``rglru_transpose`` is its transpose, the recurrence the backward runs:
``g_t = b_t + a_{t+1} g_{t+1}`` from ``g_{T-1} = b_{T-1}``;
``rglru_transpose_grads`` the whole backward, (g, da) with ``da_t = g_t
h_{t-1}``.  None takes a log, so any ``a`` works.
"""
from __future__ import annotations

import torch


def rglru_sequential(a, b, h0=None):
    """a, b (B,T,D) -> (h (B,T,D), h_final (B,D)), fp32."""
    a, b = a.float(), b.float()
    h = (torch.zeros_like(b[:, 0]) if h0 is None else h0.float())
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = torch.addcmul(b[:, t], a[:, t], h)
        out[:, t] = h
    return out, h


def rglru_transpose(a, b):
    """a, b (B,T,D) -> g (B,T,D) fp32 with g_t = b_t + a_{t+1} g_{t+1}:
    the cotangent of ``rglru_sequential``'s h flowing back to b when b
    here is the cotangent of h."""
    a, b = a.float(), b.float()
    out = torch.empty_like(b)
    g = torch.zeros_like(b[:, 0])
    for t in reversed(range(b.shape[1])):
        g = b[:, t] if t == b.shape[1] - 1 else \
            torch.addcmul(b[:, t], a[:, t + 1], g)
        out[:, t] = g
    return out


def rglru_transpose_grads(a, dh, h):
    """a, dh, h (B,T,D) -> (g, da) fp32: the cotangents of
    ``rglru_sequential``'s b and a for the cotangent dh of its output h,
    g = ``rglru_transpose(a, dh)`` and da_t = g_t h_{t-1} (h_{-1} = 0)."""
    g = rglru_transpose(a, dh)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1).float()
    return g, g * h_prev
