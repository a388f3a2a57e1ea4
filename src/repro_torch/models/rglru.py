"""Griffin / RecurrentGemma recurrent block, the sequence path (the
counterpart of ``repro/models/rglru.py``; arXiv:2402.19427).

Two linear branches from the normed input: branch 1 goes through a
causal depthwise conv (width 4) and the RG-LRU, branch 2 is a GeLU gate;
their product is projected back to d_model.  Per channel:

    r_t = sigmoid(block_diag_A x_t)          recurrence gate
    i_t = sigmoid(block_diag_I x_t)          input gate
    log a_t = -c * softplus(Lambda) * r_t    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The sequence form (``rglru_seq``) runs the recurrence through
``kernels.rglru.ops.rglru_scan`` on fp32 (a, b): the CUDA kernel on CUDA
tensors (its backward the same kernel reversed), the plain loop on CPU
tensors, or the plain loop on any device under
``KernelPolicy(rglru="xla")``.  A carried state (``cache``: the conv
history and h) folds into the first step's b (``b_1 += a_1 h_0``), so the
scan still starts from zero; per-row ``length`` of a right-padded prompt
freezes the padded steps with a = 1, b = 0.  ``rglru_decode`` advances
one token in plain PyTorch, as the reference's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import policy_of
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.models.layers import dense_init, gelu, matmul

CONV_WIDTH = 4
N_DIAG_BLOCKS = 16
C_COEF = 8.0


def rglru_block_init(cfg, generator, dtype, device):
    d = d_rnn = cfg.d_model
    bs = d_rnn // N_DIAG_BLOCKS

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)

    # Lambda so that a^c lies in [0.9, 0.999] at r = 1 (the paper's range)
    lam = torch.rand((d_rnn,), generator=generator, device=device) * 0.6 \
        + 0.3
    return {"wx": dense_init((d, d_rnn), generator, dtype, device),
            "wg": dense_init((d, d_rnn), generator, dtype, device),
            "wo": dense_init((d_rnn, d), generator, dtype, device),
            "conv_w": normal((CONV_WIDTH, d_rnn), 0.1),
            "conv_b": torch.zeros((d_rnn,), dtype=dtype, device=device),
            "gate_a": normal((N_DIAG_BLOCKS, bs, bs), bs ** -0.5),
            "gate_i": normal((N_DIAG_BLOCKS, bs, bs), bs ** -0.5),
            "lambda": lam.to(dtype)}


def param_shapes(cfg) -> dict:
    d = cfg.d_model
    bs = d // N_DIAG_BLOCKS
    return {"wx": (d, d), "wg": (d, d), "wo": (d, d),
            "conv_w": (CONV_WIDTH, d), "conv_b": (d,),
            "gate_a": (N_DIAG_BLOCKS, bs, bs),
            "gate_i": (N_DIAG_BLOCKS, bs, bs), "lambda": (d,)}


def _block_diag(x, w):
    """x (..., d_rnn) @ block-diagonal w (NB, bs, bs)."""
    nb, bs, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (nb, bs))
    return torch.einsum("...nb,nbc->...nc", xb, w.to(x.dtype)).reshape(
        x.shape)


def _gates(p, x):
    """(a, b) of the recurrence, fp32 (B,S,d)."""
    r = torch.sigmoid(_block_diag(x, p["gate_a"]).float())
    i = torch.sigmoid(_block_diag(x, p["gate_i"]).float())
    log_a = -C_COEF * F.softplus(p["lambda"].float()) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2), stably: -expm1(2 log a)
    b_scale = torch.sqrt(-torch.expm1(2.0 * log_a))
    return a, b_scale * (i * x.float())


def _conv1d_causal(p, x, state=None):
    """Depthwise causal conv, width 4: x (B,S,d) -> (y (B,S,d), the last
    CONV_WIDTH - 1 inputs (B,3,d)), after the history ``state`` (B,3,d)
    (zero when None)."""
    b, s, d = x.shape
    pad = x.new_zeros((b, CONV_WIDTH - 1, d)) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    w = p["conv_w"].to(x.dtype)
    y = sum(xp[:, i:i + s] * w[i] for i in range(CONV_WIDTH))
    return y + p["conv_b"].to(x.dtype), xp[:, -(CONV_WIDTH - 1):]


def rglru_seq(p, cfg, x, cache=None, length=None):
    """x (B,S,d) -> (out (B,S,d), {"conv": (B,3,d), "h": (B,d) fp32}), from
    ``cache`` (a zero state when None).

    ``length`` (an int or (B,) ints; a right-padded prompt): the padded
    steps get a = 1 and b = 0, so the state is each row's after exactly
    ``length[b]`` tokens, and the conv history takes each row's last
    CONV_WIDTH - 1 real inputs."""
    b, s, _ = x.shape
    xb = matmul(x, p["wx"])
    gate = gelu(matmul(x, p["wg"]))
    xc, conv_state = _conv1d_causal(p, xb,
                                    None if cache is None else cache["conv"])
    a, bt = _gates(p, xc)                                   # (B,S,d) fp32
    if cache is not None:
        bt = torch.cat([bt[:, :1] + a[:, :1] * cache["h"].float()[:, None],
                        bt[:, 1:]], 1)
    if length is not None:
        ln = torch.as_tensor(length, dtype=torch.long,
                             device=x.device).expand(b)
        real = (torch.arange(s, device=x.device)[None, :]
                < ln[:, None])[..., None]
        a = torch.where(real, a, torch.ones_like(a))
        bt = torch.where(real, bt, torch.zeros_like(bt))
    h = rglru_ops.rglru_scan(a, bt, backend=policy_of(cfg).rglru_backend())
    out = matmul(h.to(x.dtype) * gate, p["wo"])
    if length is not None:
        # input position t sits at index t + CONV_WIDTH - 1 of the padded
        # stream, so positions ln - 3 .. ln - 1 sit at ln .. ln + 2
        pad = xb.new_zeros((b, CONV_WIDTH - 1, xb.shape[-1])) \
            if cache is None else cache["conv"].to(xb.dtype)
        xp = torch.cat([pad, xb], 1)
        idx = ln[:, None] + torch.arange(CONV_WIDTH - 1, device=x.device)
        conv_state = xp[torch.arange(b, device=x.device)[:, None], idx]
    return out, {"conv": conv_state.to(x.dtype), "h": h[:, -1].float()}


def rglru_decode(p, cfg, x, cache):
    """x (B,d), one token -> (out (B,d), the new {"conv", "h"})."""
    xb = matmul(x, p["wx"])
    gate = gelu(matmul(x, p["wg"]))
    xp = torch.cat([cache["conv"].to(x.dtype), xb[:, None]], 1)
    w = p["conv_w"].to(x.dtype)
    xc = sum(xp[:, i] * w[i] for i in range(CONV_WIDTH)) \
        + p["conv_b"].to(x.dtype)
    # a named range, so a profiler trace can book the state update apart
    with torch.profiler.record_function("rglru_decode"):
        a, bt = _gates(p, xc)
        h = a * cache["h"].float() + bt
    out = matmul(h.to(x.dtype) * gate, p["wo"])
    return out, {"conv": xp[:, 1:], "h": h}


def init_rglru_cache(cfg, batch: int, dtype, device, lead: tuple = ()):
    """The block's zero state: the conv history ``conv`` (*lead, B, 3, d)
    in ``dtype`` and ``h`` (*lead, B, d) fp32; ``lead`` is the stacked-
    layer axis of the transformer's cache."""
    d = cfg.d_model
    lead = tuple(lead)
    return {"conv": torch.zeros(lead + (batch, CONV_WIDTH - 1, d),
                                dtype=dtype, device=device),
            "h": torch.zeros(lead + (batch, d), dtype=torch.float32,
                             device=device)}
