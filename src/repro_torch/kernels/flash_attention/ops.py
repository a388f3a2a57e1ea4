"""Flash-attention dispatch: the CUDA kernels (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``; for bf16 all three run on the tensor cores,
``csrc/flash_fwd_sm90.cu``, ``csrc/flash_dq_sm90.cu`` and
``csrc/flash_dkv_sm90.cu``) or their plain versions (``ref``).

``flash_attention_folded(q, k, v, ...)`` takes the kernels' layout, q
(B*Hq, S, hd) and k, v (B*Hkv, S, hd), the counterpart of the
reference's ``flash_attention_folded`` (``flash_attention.py:401``);
``flash_attention`` takes the model layout, q (B,S,Hkv,G,hd) and k, v
(B,S,Hkv,hd), as the reference's ``ops.flash_attention``.  Both are
differentiable.

Under ``backend="auto"`` a CUDA tensor runs the kernels through
``FlashAttention``, a ``torch.autograd.Function`` whose forward keeps
(q, k, v, o, lse) and whose backward forms ``delta = rowsum(do * o)`` and
launches the dq and dk/dv kernels; a CPU tensor runs the plain
masked-softmax attention, differentiated by autograd.  ``backend="plain"``
asks for the plain version on any device.

``flash_fwd``, ``flash_dq`` and ``flash_dkv`` are the three kernel
wrappers; each counts its launches in ``.launches`` (one per call, however
many kernels the call runs: bf16 dk/dv at hd 256 is two passes, and a
split group adds a fixed-order sum, ``dkv_split``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.flash_attention import ref

HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
_HEAD = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_FWD_ARGTYPES = [ctypes.c_void_p] * 5 + _HEAD
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _HEAD
_DKV_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] + _HEAD
# KV rows per block of the bf16 dk/dv kernel: flash_dkv_sm90.cu's
# Layout::BK (64 per consumer warpgroup) at the warpgroups its dispatch picks
# for each hd; tests/test_torch_cli_flags.py reads both from the source and
# holds this table to them.
DKV_ROWS = {64: 128, 128: 64, 256: 64}


def dkv_split(b: int, n_kv_heads: int, s: int, group: int, hd: int,
              sms: int) -> int:
    """Blocks over which the bf16 dk/dv kernel deals out the ``group``
    query heads of each (KV head, KV tile), split z taking heads
    [z G / n, (z + 1) G / n): doubled while the grid has fewer than two
    blocks per SM of a card with ``sms`` SMs, at most ``group``.  1 at
    G 1 (no scratch, no sum)."""
    blocks = b * n_kv_heads * -(-s // DKV_ROWS[hd])
    n = 1
    while n < group and blocks * n < 2 * sms:
        n *= 2
    return min(n, group)


def _check_shapes(q, k, v, n_q_heads, n_kv_heads, window):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (B*H, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if n_kv_heads < 1 or n_q_heads % n_kv_heads:
        raise ValueError(f"n_q_heads {n_q_heads} is not a multiple of "
                         f"n_kv_heads {n_kv_heads}")
    bhq, s, hd = q.shape
    if bhq % n_q_heads:
        raise ValueError(f"q's {bhq} rows are not B x {n_q_heads} heads")
    want = (bhq // n_q_heads * n_kv_heads, s, hd)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"k, v must be {want}, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _check_cuda(named, hd, tma=False):
    """What the kernels take: contiguous CUDA tensors of one type (fp32 or
    bf16; lse and delta fp32) and a head dim of 64, 128 or 256; with
    ``tma`` (the tensor-core kernels' TMA loads) bf16 ones 16-byte
    aligned."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernels take head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    dtype = named[0][1].dtype
    for name, t in named:
        if name in ("lse", "delta"):
            common.check_operand(name, t, 2)
        else:
            common.check_operand(name, t, 3, DTYPES)
            if t.dtype != dtype:
                raise ValueError(f"{name} is {t.dtype}, q is {dtype}")
            if tma and dtype == torch.bfloat16 and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    return int(dtype == torch.bfloat16)


def _call(name, argtypes, *args):
    err = _build.function(name, argtypes)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error(name, err)


def _conf(n_q_heads, n_kv_heads, causal, window, scale):
    return (n_q_heads, n_kv_heads, int(causal),
            -1 if window is None else int(window), float(scale))


def flash_fwd(q, k, v, *, n_q_heads: int, n_kv_heads: int, causal=True,
              window=None, scale=1.0, backend: str = "auto"):
    """(o (B*Hq,S,hd) in q's dtype, lse (B*Hq,S) fp32): the forward
    kernel, or its plain version."""
    _check_shapes(q, k, v, n_q_heads, n_kv_heads, window)
    kw = dict(n_q_heads=n_q_heads, n_kv_heads=n_kv_heads, causal=causal,
              window=window, scale=scale)
    if common.route(backend, q) == "plain":
        return ref.flash_fwd_ref(q, k, v, **kw)
    bhq, s, hd = q.shape
    bf16 = _check_cuda([("q", q), ("k", k), ("v", v)], hd, tma=True)
    o = torch.empty_like(q)
    lse = torch.empty((bhq, s), device=q.device, dtype=torch.float32)
    _call("flash_fwd", _FWD_ARGTYPES, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), o.data_ptr(), lse.data_ptr(), bhq, s, hd,
          *_conf(n_q_heads, n_kv_heads, causal, window, scale), bf16)
    flash_fwd.launches += 1
    return o, lse


def flash_dq(q, k, v, do, lse, delta, *, n_q_heads: int, n_kv_heads: int,
             causal=True, window=None, scale=1.0, backend: str = "auto"):
    """dq (B*Hq,S,hd) in q's dtype: the dq kernel, or its plain
    version."""
    _check_shapes(q, k, v, n_q_heads, n_kv_heads, window)
    kw = dict(n_q_heads=n_q_heads, n_kv_heads=n_kv_heads, causal=causal,
              window=window, scale=scale)
    if common.route(backend, q) == "plain":
        return ref.flash_dq_ref(q, k, v, do, lse, delta, **kw)
    bhq, s, hd = q.shape
    bf16 = _check_cuda([("q", q), ("k", k), ("v", v), ("do", do),
                        ("lse", lse), ("delta", delta)], hd, tma=True)
    dq = torch.empty_like(q)
    _call("flash_dq", _DQ_ARGTYPES, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          dq.data_ptr(), bhq, s, hd,
          *_conf(n_q_heads, n_kv_heads, causal, window, scale), bf16)
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, do, lse, delta, *, n_q_heads: int, n_kv_heads: int,
              causal=True, window=None, scale=1.0, backend: str = "auto"):
    """(dk, dv) (B*Hkv,S,hd) in k's dtype, each summed over the G query
    heads of its KV head: the dk/dv kernel, or its plain version."""
    _check_shapes(q, k, v, n_q_heads, n_kv_heads, window)
    kw = dict(n_q_heads=n_q_heads, n_kv_heads=n_kv_heads, causal=causal,
              window=window, scale=scale)
    if common.route(backend, q) == "plain":
        return ref.flash_dkv_ref(q, k, v, do, lse, delta, **kw)
    bhkv, s, hd = k.shape
    bf16 = _check_cuda([("q", q), ("k", k), ("v", v), ("do", do),
                        ("lse", lse), ("delta", delta)], hd, tma=True)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    sms = torch.cuda.get_device_properties(k.device).multi_processor_count
    n_split = (dkv_split(bhkv // n_kv_heads, n_kv_heads, s,
                         n_q_heads // n_kv_heads, hd, sms) if bf16 else 1)
    part = (torch.empty((2, n_split, bhkv, s, hd), device=k.device,
                        dtype=torch.float32) if n_split > 1 else None)
    _call("flash_dkv", _DKV_ARGTYPES, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
          dk.data_ptr(), dv.data_ptr(),
          None if part is None else part.data_ptr(), n_split, bhkv, s, hd,
          *_conf(n_q_heads, n_kv_heads, causal, window, scale), bf16)
    flash_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention through the three kernel wrappers: the forward kernel,
    then the dq and dk/dv kernels in the backward (on CPU tensors each
    wrapper runs its plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, n_q_heads, n_kv_heads, causal, window, scale,
                backend):
        kw = dict(n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
                  causal=causal, window=window, scale=scale, backend=backend)
        o, lse = flash_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(do * o) in fp32, outside the kernels as in the
        # reference (flash_attention.py:352)
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_dq(q, k, v, do, lse, delta, **ctx.kw)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_folded(q, k, v, *, n_q_heads: int, n_kv_heads: int,
                           causal=True, window=None, scale=1.0,
                           backend: str = "auto"):
    """q (B*Hq,S,hd); k, v (B*Hkv,S,hd) -> o (B*Hq,S,hd) in q's dtype.
    Differentiable in q, k and v."""
    _check_shapes(q, k, v, n_q_heads, n_kv_heads, window)
    if common.route(backend, q) == "plain":
        return ref.attention_folded_ref(
            q, k, v, n_q_heads=n_q_heads, n_kv_heads=n_kv_heads,
            causal=causal, window=window, scale=scale)
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), n_q_heads, n_kv_heads,
                                causal, window, scale, backend)


def flash_attention(q, k, v, *, causal=True, window=None, scale=1.0,
                    backend: str = "auto"):
    """q (B,S,Hkv,G,hd); k, v (B,S,Hkv,hd) -> (B,S,Hkv,G,hd)."""
    b, s, hkv, g, hd = q.shape
    hq = hkv * g
    qf = q.permute(0, 2, 3, 1, 4).reshape(b * hq, s, hd)
    kf = k.permute(0, 2, 1, 3).reshape(b * hkv, s, hd)
    vf = v.permute(0, 2, 1, 3).reshape(b * hkv, s, hd)
    o = flash_attention_folded(qf, kf, vf, n_q_heads=hq, n_kv_heads=hkv,
                               causal=causal, window=window, scale=scale,
                               backend=backend)
    return o.reshape(b, hkv, g, s, hd).permute(0, 3, 1, 2, 4)
