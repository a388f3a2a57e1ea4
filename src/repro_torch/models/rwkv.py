"""RWKV6 (Finch) block, the sequence path (the counterpart of
``repro/models/rwkv.py``): data-dependent token-shift time-mix and
channel-mix (arXiv:2404.05892 section 3).

The ddlerp token shift with a shared low-rank adapter gives the five
interpolated inputs (w, k, v, r, g); the decay ``w_t = exp(-exp(z_t))``
comes through its own low-rank adapter; ``u`` is the per-head bonus;
GroupNorm over heads follows the WKV.  The recurrence is
``kernels.rwkv6.ops.wkv``: the CUDA kernel on CUDA tensors, the plain
chunked form on CPU tensors, or the plain form on any device under
``KernelPolicy(rwkv6="chunked")``.  ``w`` and ``u`` enter it in fp32,
``r``, ``k`` and ``v`` in the params' dtype.

Only the training forward (no cache) is ported: a carried shift or WKV
state, per-row ``length`` and the decode functions come with serving
(ROADMAP.md queue A item 8) and raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import policy_of
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models.layers import dense_init, matmul

DDLERP_RANK = 32
DECAY_RANK = 64


def _no_state(what):
    raise NotImplementedError(
        f"the RWKV6 block with {what} is not ported yet: see ROADMAP.md "
        "queue A item 8 (serving the recurrent families)")


def rwkv_block_init(cfg, generator, dtype, device):
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff

    def dense(d_in, d_out, scale=None):
        return dense_init((d_in, d_out), generator, dtype, device, scale)

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)

    tm = {"mu_base": full((d,), 0.0), "mu_wkvrg": full((5, d), 0.0),
          "lora_a": dense(d, 5 * DDLERP_RANK, 0.01),
          "lora_b": normal((5, DDLERP_RANK, d), 0.01),
          "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
          "wg": dense(d, d), "wo": dense(d, d),
          "decay_base": full((d,), -4.0),     # w ~ exp(-e^-4) ~ .982
          "decay_a": dense(d, DECAY_RANK, 0.01),
          "decay_b": dense(DECAY_RANK, d, 0.01),
          "u": normal((h, hd), 0.5), "ln_x_scale": full((d,), 1.0)}
    cm = {"mu_k": full((d,), 0.0), "mu_r": full((d,), 0.0),
          "wk": dense(d, f), "wv": dense(f, d), "wr": dense(d, d)}
    return {"tm": tm, "cm": cm}


def param_shapes(cfg) -> dict:
    """The block's ``tm`` / ``cm`` shapes (the norms are the caller's)."""
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    sq = (d, d)
    return {"tm": {"mu_base": (d,), "mu_wkvrg": (5, d),
                   "lora_a": (d, 5 * DDLERP_RANK),
                   "lora_b": (5, DDLERP_RANK, d), "wr": sq, "wk": sq,
                   "wv": sq, "wg": sq, "wo": sq, "decay_base": (d,),
                   "decay_a": (d, DECAY_RANK), "decay_b": (DECAY_RANK, d),
                   "u": (h, hd), "ln_x_scale": (d,)},
            "cm": {"mu_k": (d,), "mu_r": (d,), "wk": (d, f), "wv": (f, d),
                   "wr": sq}}


def _shift(x):
    """x (B,S,d) -> the previous token's x, zero before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)


def _ddlerp(tm, x, x_prev):
    """Data-dependent lerp giving the 5 shifted inputs (w, k, v, r, g):
    (..., 5, d)."""
    xx = x_prev - x
    xxx = x + xx * tm["mu_base"].to(x.dtype)
    lo = torch.tanh(matmul(xxx, tm["lora_a"]))                   # (..., 5R)
    lo = lo.reshape(lo.shape[:-1] + (5, DDLERP_RANK))
    delta = torch.einsum("...nr,nrd->...nd", lo, tm["lora_b"].to(x.dtype))
    mu = tm["mu_wkvrg"].to(x.dtype) + delta                      # (..., 5, d)
    return x[..., None, :] + xx[..., None, :] * mu


def _decay(tm, xw):
    """fp32 w = exp(-exp(z)) in (0, 1], z clamped at 8."""
    z = tm["decay_base"].float() + matmul(
        torch.tanh(matmul(xw, tm["decay_a"])), tm["decay_b"]).float()
    return torch.exp(-torch.exp(torch.clamp(z, max=8.0)))


def _groupnorm_heads(x, scale, h, eps=64e-5):
    """GroupNorm, one group per head, over the flattened (H*hd) output;
    fp32, population variance, cast back to x's dtype."""
    xh = x.reshape(x.shape[:-1] + (h, -1)).float()
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, keepdim=True, unbiased=False)
    y = (xh - mu) * torch.rsqrt(var + eps)
    y = y.reshape(x.shape) * scale.float()
    return y.to(x.dtype)


def time_mix_seq(p, cfg, x, shift_state=None, wkv_state=None, length=None):
    """x (B,S,d) -> (out (B,S,d), (last x (B,d), final WKV state
    (B,H,hd,hd) fp32)), from zero shift and WKV states."""
    if shift_state is not None or wkv_state is not None:
        _no_state("a carried shift or WKV state")
    if length is not None:
        _no_state("per-row lengths")
    tm = p["tm"]
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xs = _ddlerp(tm, x, _shift(x))                               # (B,S,5,d)
    xw, xk, xv, xr, xg = xs.unbind(2)
    w = _decay(tm, xw).reshape(b, s, h, hd)
    r = matmul(xr, tm["wr"]).reshape(b, s, h, hd)
    k = matmul(xk, tm["wk"]).reshape(b, s, h, hd)
    v = matmul(xv, tm["wv"]).reshape(b, s, h, hd)
    g = F.silu(matmul(xg, tm["wg"]))
    y, s_fin = wkv_ops.wkv(r, k, v, w, tm["u"].float(),
                           backend=policy_of(cfg).rwkv6_backend())
    y = y.to(x.dtype).reshape(b, s, d)
    y = _groupnorm_heads(y, tm["ln_x_scale"], h) * g
    return matmul(y, tm["wo"]), (x[:, -1], s_fin)


def channel_mix_seq(p, cfg, x, shift_state=None, length=None):
    """x (B,S,d) -> (out (B,S,d), last x (B,d)), from a zero shift."""
    if shift_state is not None or length is not None:
        _no_state("a carried shift state or per-row lengths")
    cm = p["cm"]
    xx = _shift(x) - x
    xk = x + xx * cm["mu_k"].to(x.dtype)
    xr = x + xx * cm["mu_r"].to(x.dtype)
    kk = torch.square(torch.relu(matmul(xk, cm["wk"])))
    out = torch.sigmoid(matmul(xr, cm["wr"])) * matmul(kk, cm["wv"])
    return out, x[:, -1]
