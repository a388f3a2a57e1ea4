"""Mixture-of-Experts FFN with top-k routing and capacity-bounded,
sort-based dispatch (the counterpart of ``repro/models/moe.py``: GShard
semantics, MaxText-style mechanics).

The token assignments are sorted by expert id (a stable sort), each
token's rank within its expert is its position in the expert's buffer,
the tokens are scattered into a static (E, C, d) buffer (assignments past
the capacity C are dropped, GShard-style), the experts run as one batched
product, and the outputs are gathered back weighted by the router's gate.

Two dispatch scopes (``MoEConfig.dispatch``): ``flat`` sorts all B*S
tokens at once; ``rowwise`` dispatches each batch row on its own (the
reference's ``vmap``, here a loop over rows) and takes the mean of the
rows' aux losses.  ``MoEConfig.buffer_sharding`` is a GSPMD sharding hint
of the reference with no counterpart on one device: it is accepted and
ignored.

The aux load-balance loss is the Switch Transformer's: E * sum_e f_e *
p_e * ``router_aux_coef``, with f_e the fraction of tokens whose top-1
expert is e and p_e the mean router probability.

The expert FFN is the library's batched product by default (the
reference's XLA einsum, outside any Pallas kernel).  ``KernelPolicy(
matmul="kernel")`` opts in to ``kernels.conv2d.ops.matmul_bias``: one
kernel call per expert weight with zero biases, differentiable through
its backward's two more launches, as the reference's
``_expert_ffn_pallas`` does under ``matmul="pallas"``.

Nothing here waits on the card: the capacity is computed from the shapes,
and the counts and positions stay on the device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import policy_of
from repro_torch.kernels.conv2d.ops import matmul_bias
from repro_torch.models.layers import (dense_init, gelu, matmul, mlp_apply,
                                       mlp_init)


def moe_init(cfg, generator, dtype, device) -> dict:
    """The reference's params: ``router`` (d, E), ``w_in`` (E, d, f),
    ``w_out`` (E, f, d), ``w_gate`` (E, d, f) for swiglu / geglu, and
    ``shared`` (a dense MLP) with a shared expert."""
    d, f, m = cfg.d_model, cfg.d_ff, cfg.moe
    e = m.n_experts
    p = {"router": dense_init((d, e), generator, dtype, device),
         "w_in": dense_init((e, d, f), generator, dtype, device,
                            scale=d ** -0.5),
         "w_out": dense_init((e, f, d), generator, dtype, device,
                             scale=f ** -0.5)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = dense_init((e, d, f), generator, dtype, device,
                                 scale=d ** -0.5)
    if m.shared_expert:
        p["shared"] = mlp_init(cfg, generator, dtype, device)
    return p


def param_shapes(cfg) -> dict:
    """The shapes of ``moe_init``'s tree."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"router": (d, e), "w_in": (e, d, f), "w_out": (e, f, d)}
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = (e, d, f)
    if cfg.moe.shared_expert:
        p["shared"] = {"w_in": (d, f), "w_out": (f, d)}
        if cfg.mlp in ("swiglu", "geglu"):
            p["shared"]["w_gate"] = (d, f)
    return p


def _act(cfg):
    return F.silu if cfg.mlp == "swiglu" else gelu


def _expert_ffn_kernel(p, cfg, x):
    """x (E, C, d) -> (E, C, d) on the ``matmul_bias`` kernel: one call per
    expert weight, zero biases, weights cast to x's dtype."""
    backend = policy_of(cfg).backend
    e = x.shape[0]
    f = p["w_in"].shape[-1]
    d = p["w_out"].shape[-1]
    zf = x.new_zeros((f,))
    zd = x.new_zeros((d,))
    gated = cfg.mlp in ("swiglu", "geglu")
    outs = []
    for ei in range(e):
        h = matmul_bias(x[ei], p["w_in"][ei].to(x.dtype), zf,
                        backend=backend)
        if gated:
            g = matmul_bias(x[ei], p["w_gate"][ei].to(x.dtype), zf,
                            backend=backend)
            h = h * _act(cfg)(g)
        else:
            h = gelu(h)
        outs.append(matmul_bias(h, p["w_out"][ei].to(x.dtype), zd,
                                backend=backend))
    return torch.stack(outs)


def _expert_ffn(p, cfg, x):
    """x (E, C, d) -> (E, C, d): batched expert products (fp32
    accumulation, one rounding to x's dtype), or the kernel under the
    ``matmul`` opt-in."""
    if policy_of(cfg).matmul == "kernel":
        return _expert_ffn_kernel(p, cfg, x)
    h = torch.bmm(x, p["w_in"].to(x.dtype))
    if cfg.mlp in ("swiglu", "geglu"):
        h = h * _act(cfg)(torch.bmm(x, p["w_gate"].to(x.dtype)))
    else:
        h = gelu(h)
    return torch.bmm(h, p["w_out"].to(x.dtype))


def capacity(t: int, k: int, cf: float, e: int) -> int:
    """Rows of each expert's buffer for ``t`` tokens routed top-``k``
    among ``e`` experts at capacity factor ``cf`` (Python's ``round``, as
    the reference's)."""
    return int(max(1, min(t * k, round(t * k * cf / e))))


def _top_k(probs, k: int):
    """(values, indices) of the k largest probabilities per row, the lower
    index first among equals (``jax.lax.top_k``'s order; bf16 router
    logits tie now and then)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _dispatch_ffn(p, cfg, xt, cf: float):
    """Sort-based dispatch over a flat token block xt (T, d).  Returns
    (out (T, d) in xt's dtype, aux: an fp32 scalar)."""
    m = cfg.moe
    t, d = xt.shape
    e, k = m.n_experts, m.top_k
    dev = xt.device

    logits = matmul(xt, p["router"]).float()                 # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, eid = _top_k(probs, k)                             # (T, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)

    # Switch aux: E * sum_e (fraction whose top-1 is e) * (mean prob); the
    # counts are sums of ones (exact in any order)
    ones = torch.ones((t,), dtype=torch.float32, device=dev)
    f_e = torch.zeros((e,), dtype=torch.float32, device=dev) \
        .index_add_(0, eid[:, 0], ones) / t
    p_e = probs.mean(0)
    aux = e * (f_e * p_e).sum() * m.router_aux_coef

    cap = capacity(t, k, cf, e)
    flat_e = eid.reshape(t * k)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.zeros((e,), dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                # exclusive
    pos = torch.arange(t * k, device=dev) - starts[se]       # rank in expert
    keep = pos < cap
    # the buffer flat, with one trash row past its end: an assignment past
    # the capacity is written there and dropped (the reference's
    # mode="drop"), so no mask has to be brought to the host
    slot = torch.where(keep, se * cap + pos, torch.full_like(pos, e * cap))
    src = xt[flat_tok[order]]                                # (TK, d)
    buf = xt.new_zeros((e * cap + 1, d)).index_put((slot,), src)
    out_buf = _expert_ffn(p, cfg, buf[:e * cap].view(e, cap, d))

    vals = out_buf.reshape(e * cap, d)[se * cap + pos.clamp(0, cap - 1)]
    vals = torch.where(keep[:, None], vals, vals.new_zeros(()))
    gflat = gate.reshape(t * k)[order]
    # the combine adds each token's <= top_k rows in xt's dtype; with
    # top_k <= 2 a token takes at most two adds into zero, and a + b rounds
    # alike in either order, so the atomics of index_add repeat bit for
    # bit (a top_k > 2 config would need a fixed order here)
    out = xt.new_zeros((t, d)).index_add(
        0, flat_tok[order], vals * gflat[:, None].to(xt.dtype))
    return out, aux


def moe_apply(p, cfg, x, capacity_factor: float | None = None):
    """x (B, S, d) -> (out (B, S, d), aux fp32 scalar).
    ``capacity_factor`` overrides the config's (decode passes E: dropless,
    see ``transformer._decode_moe_cf``)."""
    m = cfg.moe
    cf = m.capacity_factor if capacity_factor is None else capacity_factor
    b, s, d = x.shape
    if getattr(m, "dispatch", "flat") == "rowwise":
        rows = [_dispatch_ffn(p, cfg, x[i], cf) for i in range(b)]
        out = torch.stack([r[0] for r in rows])
        aux = torch.stack([r[1] for r in rows]).mean()
    else:
        out, aux = _dispatch_ffn(p, cfg, x.reshape(b * s, d), cf)
        out = out.reshape(b, s, d)
    if m.shared_expert:
        out = out + mlp_apply(p["shared"], cfg,
                              x.reshape(b * s, d)).reshape(b, s, d)
    return out, aux
