"""RWKV6 (Finch) block (the counterpart of ``repro/models/rwkv.py``):
data-dependent token-shift time-mix and channel-mix (arXiv:2404.05892
section 3).

The ddlerp token shift with a shared low-rank adapter gives the five
interpolated inputs (w, k, v, r, g); the decay ``w_t = exp(-exp(z_t))``
comes through its own low-rank adapter; ``u`` is the per-head bonus;
GroupNorm over heads follows the WKV.  ``w`` and ``u`` enter the WKV in
fp32, ``r``, ``k`` and ``v`` in the params' dtype.

The sequence path (``time_mix_seq`` / ``channel_mix_seq``) takes an
optional carried state (the previous token's x, the WKV state) and
per-row ``length`` of a right-padded prompt; the decode path
(``time_mix_decode`` / ``channel_mix_decode``) advances one token.  The
WKV routes by its start:

  zero state    (training, and a prefill from a fresh cache)
                ``kernels.rwkv6.ops.wkv``: the CUDA kernel ``wkv_fwd`` on
                CUDA tensors, the plain chunked form on CPU tensors or
                under ``KernelPolicy(rwkv6="chunked")``
  carried state the plain chunked form with its ``s0``
                (``kernels.rwkv6.ref.wkv_chunked``): the kernel starts
                from zero, as the TPU kernel does, and the reference
                takes its chunked XLA form here too
                (``resolve_wkv_impl(has_state=True)``): speculative
                decoding's chunks (``transformer.decode_seq``) run here
  one token     ``kernels.rwkv6.ref.wkv_decode``, plain fp32 (the
                reference's decode has no kernel either)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import policy_of
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.models.layers import dense_init, matmul

DDLERP_RANK = 32
DECAY_RANK = 64


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


def _prev(x, shift_state):
    """x (B,S,d) -> the previous token's x: ``shift_state`` (B,d) before
    the first (zero when None)."""
    first = torch.zeros_like(x[:, :1]) if shift_state is None \
        else shift_state[:, None].to(x.dtype)
    return torch.cat([first, x[:, :-1]], 1)


def _length_mask(length, b, s, device):
    """((B,S) bool, position t is a real token of row b; (B,) lengths)."""
    ln = torch.as_tensor(length, dtype=torch.long, device=device).expand(b)
    return torch.arange(s, device=device)[None, :] < ln[:, None], ln


def _gather_last(x, ln):
    """x (B,S,...) -> x[b, ln[b] - 1] per row: the last real position."""
    idx = torch.clamp(ln - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


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
    (B,H,hd,hd) fp32)), from ``shift_state`` (B,d) and ``wkv_state``
    (zero when None).

    ``length`` (an int or (B,) ints; a right-padded prompt) freezes the
    padded steps out of the recurrence with w = 1 and k = 0, which makes
    the state update the identity, so the final state is each row's after
    exactly ``length[b]`` tokens; ``last x`` is the last real position's.
    The real positions' outputs see only the past and are untouched."""
    tm = p["tm"]
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xs = _ddlerp(tm, x, _prev(x, shift_state))                   # (B,S,5,d)
    xw, xk, xv, xr, xg = xs.unbind(2)
    w = _decay(tm, xw).reshape(b, s, h, hd)
    r = matmul(xr, tm["wr"]).reshape(b, s, h, hd)
    k = matmul(xk, tm["wk"]).reshape(b, s, h, hd)
    v = matmul(xv, tm["wv"]).reshape(b, s, h, hd)
    g = F.silu(matmul(xg, tm["wg"]))
    if length is not None:
        real, ln = _length_mask(length, b, s, x.device)
        m = real[..., None, None]
        w = torch.where(m, w, torch.ones_like(w))
        k = torch.where(m, k, torch.zeros_like(k))
    u = tm["u"].float()
    if wkv_state is None:
        y, s_fin = wkv_ops.wkv(r, k, v, w, u,
                               backend=policy_of(cfg).rwkv6_backend())
    else:
        y, s_fin = wkv_ref.wkv_chunked(r, k, v, w, u, wkv_state,
                                       chunk=min(wkv_ops.CHUNK, max(s, 1)))
    y = y.to(x.dtype).reshape(b, s, d)
    y = _groupnorm_heads(y, tm["ln_x_scale"], h) * g
    last = x[:, -1] if length is None else _gather_last(x, ln)
    return matmul(y, tm["wo"]), (last, s_fin)


def time_mix_decode(p, cfg, x, shift_state, wkv_state):
    """x (B,d), one token -> (out (B,d), (x, the new WKV state))."""
    tm = p["tm"]
    b, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xs = _ddlerp(tm, x, shift_state.to(x.dtype))                 # (B,5,d)
    xw, xk, xv, xr, xg = xs.unbind(1)
    w = _decay(tm, xw).reshape(b, h, hd)
    r = matmul(xr, tm["wr"]).reshape(b, h, hd)
    k = matmul(xk, tm["wk"]).reshape(b, h, hd)
    v = matmul(xv, tm["wv"]).reshape(b, h, hd)
    g = F.silu(matmul(xg, tm["wg"]))
    # a named range, so a profiler trace can book the state update apart
    with torch.profiler.record_function("wkv_decode"):
        y, s_new = wkv_ref.wkv_decode(r, k, v, w, tm["u"].float(),
                                      wkv_state)
    y = y.to(x.dtype).reshape(b, d)
    y = _groupnorm_heads(y, tm["ln_x_scale"], h) * g
    return matmul(y, tm["wo"]), (x, s_new)


def _channel_mix(cm, x, x_prev):
    xx = x_prev - x
    xk = x + xx * cm["mu_k"].to(x.dtype)
    xr = x + xx * cm["mu_r"].to(x.dtype)
    kk = torch.square(torch.relu(matmul(xk, cm["wk"])))
    return torch.sigmoid(matmul(xr, cm["wr"])) * matmul(kk, cm["wv"])


def channel_mix_seq(p, cfg, x, shift_state=None, length=None):
    """x (B,S,d) -> (out (B,S,d), last x (B,d)), from ``shift_state``
    (zero when None); ``length`` as in ``time_mix_seq``."""
    out = _channel_mix(p["cm"], x, _prev(x, shift_state))
    if length is None:
        return out, x[:, -1]
    _, ln = _length_mask(length, x.shape[0], x.shape[1], x.device)
    return out, _gather_last(x, ln)


def channel_mix_decode(p, cfg, x, shift_state):
    """x (B,d), one token -> (out (B,d), x)."""
    return _channel_mix(p["cm"], x, shift_state.to(x.dtype)), x


def init_rwkv_cache(cfg, batch: int, dtype, device, lead: tuple = ()):
    """The block's zero state: ``tm_shift`` / ``cm_shift`` (*lead, B, d)
    in ``dtype``, ``wkv`` (*lead, B, H, hd, hd) fp32.  ``lead`` is the
    stacked-layer axis of the transformer's cache."""
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    lead = tuple(lead)
    return {"tm_shift": torch.zeros(lead + (batch, d), dtype=dtype,
                                    device=device),
            "wkv": torch.zeros(lead + (batch, h, hd, hd),
                               dtype=torch.float32, device=device),
            "cm_shift": torch.zeros(lead + (batch, d), dtype=dtype,
                                    device=device)}
