"""The plain PyTorch version of single-token decode attention (the
counterpart of ``repro/kernels/decode_attention/ref.py``).

The ring cache of capacity W holds the last W absolute positions: slot
``i`` holds position ``pos - ((pos - i) mod W)`` (floor mod) and is
valid iff that position is >= 0 and, with a window, ``> pos - window``.
``pos`` is per row: the continuous-batching engine decodes slots at
different depths in one call.  The block-pool form gathers each row's
blocks into a contiguous ring first (``gather_pool``) and runs the same
math.
"""
from __future__ import annotations

import torch

NEG = -1e30


def slot_positions(pos, cap: int):
    """(B,) pos -> (B, W) absolute position held by each ring slot."""
    pos = pos.long()
    idx = torch.arange(cap, device=pos.device)
    return pos[:, None] - torch.remainder(pos[:, None] - idx[None, :], cap)


def gather_pool(pool, table):
    """A (NB, bs, ...) pool read through a (B, cap/bs) block table as a
    (B, cap, ...) ring: row b's slot s is ``pool[table[b, s // bs],
    s % bs]``."""
    b, n_k = table.shape
    return pool[table.long()].reshape((b, n_k * pool.shape[1])
                                      + tuple(pool.shape[2:]))


def decode_attention_ref(q, k, v, pos, *, window=None, scale=1.0,
                         k_scale=None, v_scale=None):
    """q (B,Hkv,G,hd) one token per row; k, v (B,W,Hkv,hd) ring cache
    AFTER the current token's K/V was written; pos (B,) int.  Returns
    (B,Hkv,G,hd) in q's dtype, computed in fp32.

    ``k_scale`` / ``v_scale`` (B,W,Hkv) fp32 mark an int8 cache: values
    dequantize as ``int8 * scale`` before the attention math."""
    cap = k.shape[1]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
        vf = vf * v_scale.float()[..., None]
    sp = slot_positions(pos, cap)                          # (B, W)
    valid = sp >= 0
    if window is not None:
        valid &= sp > pos.long()[:, None] - window
    s = torch.einsum("bhgk,bshk->bhgs", q.float(), kf) * scale
    s = s.masked_fill(~valid[:, None, None, :], NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgs,bshk->bhgk", p, vf).to(q.dtype)


def decode_attention_table_ref(q, k, v, pos, table, *, window=None,
                               scale=1.0, k_scale=None, v_scale=None):
    """The block-pool form: k, v (NB,bs,Hkv,hd) pools, scales (NB,bs,Hkv),
    table (B, cap/bs) block ids."""
    if k_scale is not None:
        k_scale, v_scale = (gather_pool(x, table) for x in (k_scale,
                                                            v_scale))
    return decode_attention_ref(q, gather_pool(k, table),
                                gather_pool(v, table), pos, window=window,
                                scale=scale, k_scale=k_scale,
                                v_scale=v_scale)
