"""Layers shared by the port's models (the counterpart of
``repro/models/layers.py``): norms, MLPs, embeddings, RoPE and the loss.

Functional, as the reference: ``*_init`` builds a params dict, the apply
functions are pure functions of it.  Matmuls accumulate in fp32 and
return ``x``'s dtype (a bf16 ``torch.matmul`` does both); norms, softmax
and RoPE run in fp32 and cast back; the unembedding returns fp32 logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def dense_init(shape, generator, dtype, device, scale=None):
    """N(0, 1) * ``scale`` (default fan-in ``shape[0] ** -0.5``) drawn in
    fp32 on ``device``, cast to ``dtype``."""
    scale = shape[0] ** -0.5 if scale is None else scale
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * scale
    return w.to(dtype)


def matmul(x, w):
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------- norms ----

def norm_init(cfg, dtype, device):
    if cfg.norm == "np_ln":        # non-parametric (olmo): no learnables
        return {}
    scale = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    if cfg.norm == "layernorm":
        return {"scale": scale,
                "bias": torch.zeros((cfg.d_model,), dtype=dtype,
                                    device=device)}
    return {"scale": scale}                                    # rmsnorm


def norm_apply(params, cfg, x, eps: float = 1e-6):
    """LayerNorm (population variance) / non-parametric LN / RMSNorm in
    fp32, eps inside the rsqrt, cast back to ``x``'s dtype."""
    xf = x.float()
    if cfg.norm in ("layernorm", "np_ln"):
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "layernorm":
            y = y * params["scale"].float() + params["bias"].float()
    else:                                                      # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------- MLPs ----

def mlp_init(cfg, generator, dtype, device, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_in": dense_init((d, f), generator, dtype, device)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = dense_init((d, f), generator, dtype, device)
    p["w_out"] = dense_init((f, d), generator, dtype, device)
    return p


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(params, cfg, x):
    h = matmul(x, params["w_in"])
    if cfg.mlp == "swiglu":
        h = h * F.silu(matmul(x, params["w_gate"]))
    elif cfg.mlp == "geglu":
        h = h * gelu(matmul(x, params["w_gate"]))
    else:
        h = gelu(h)
    return matmul(h, params["w_out"])


# ----------------------------------------------------------- embeddings ----

def embed_init(cfg, generator, dtype, device):
    v = cfg.padded_vocab
    p = {"tok": dense_init((v, cfg.d_model), generator, dtype, device,
                           scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, v), generator, dtype, device)
    return p


def embed_apply(params, cfg, tokens):
    # F.embedding's backward sums the rows of repeated tokens without
    # atomics, so a resumed run can repeat an uninterrupted one bit for bit
    return F.embedding(tokens.long(), params["tok"])


class _F32Logits(torch.autograd.Function):
    """(N, d) @ (d, V) -> fp32 (N, V) without rounding the products' sums
    to the operands' type (the reference's ``preferred_element_type``).
    bf16 CUDA operands take the library's bf16 GEMM with an fp32 output;
    the backward casts the fp32 cotangent to the operands' type and runs
    two bf16 GEMMs.  fp32 operands are a plain fp32 product both ways."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        if h.dtype == torch.float32:
            return h @ w
        if h.is_cuda:
            return torch.mm(h, w, out_dtype=torch.float32)
        return h.float() @ w.float()

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = h.t() @ g if ctx.needs_input_grad[1] else None
        return dh, dw


def unembed_apply(params, cfg, h):
    """h (B,S,d) -> fp32 logits (B,S,V): through the embedding table when
    tied, else ``lm_head``; padded vocab rows are sliced off."""
    w = params["tok"].t() if cfg.tie_embeddings else params["lm_head"]
    b, s, d = h.shape
    logits = _F32Logits.apply(h.reshape(b * s, d), w.to(h.dtype)).reshape(
        b, s, -1)
    if cfg.padded_vocab != cfg.vocab_size:
        logits = logits[..., :cfg.vocab_size]
    return logits


# ----------------------------------------------------------------- RoPE ----

def rope_freqs(cfg, device, head_dim=None):
    hd = head_dim or cfg.head_dim
    exponent = torch.arange(0, hd, 2, dtype=torch.float32,
                            device=device) / hd
    # a Python-float base rides into the kernel as an fp32 scalar: no
    # host-to-device copy, which would wait for the card on every call
    return 1.0 / (float(cfg.rope_theta) ** exponent)           # (hd/2,)


def apply_rope(x, positions, inv_freq):
    """x (..., S, H, hd), positions broadcastable to (..., S): the halves
    rotated (not interleaved), angles in fp32."""
    angles = positions[..., None].float() * inv_freq        # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- loss ----

def softmax_xent(logits, labels, mask=None):
    """Mean cross-entropy; logits float32 (B, S, V), labels int (B, S);
    with ``mask`` (B, S) the mean over the masked-in positions."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
