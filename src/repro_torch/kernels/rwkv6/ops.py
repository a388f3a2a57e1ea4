"""WKV6 dispatch: the CUDA kernel (``csrc/wkv.cu``) or its plain version
(``ref``), differentiable.

``wkv(r, k, v, w, u, *, backend)`` takes the model's layout, r, k, v, w
(B,T,H,K) and u (H,K), from a zero state, and returns (y (B,T,H,K) in
r's dtype, the final state (B,H,K,K) fp32), as the reference's
``wkv_pallas(..., return_state=True)``.  It is the ``WKV``
``torch.autograd.Function``: the forward is ``wkv_fwd``, the kernel on
CUDA tensors (``wkv_fwd.launches`` counts its launches) and the plain
chunked form on CPU tensors; ``backend="plain"`` asks for the plain
version on any device.

The backward has no kernel, in the reference or here: the reference
pulls the cotangents of y and of the final state through
``ref.wkv_chunked`` in XLA (``repro/kernels/rwkv6/rwkv6.py:128-145``).
Autograd through the whole chunked form would keep one (B,H,C,C,K)
decay tensor per chunk (268 MB each at B 4, H 64, C 64, K 64), so the
Function saves only its inputs: the backward recomputes the states at
the chunk boundaries without grad, then walks the chunks in reverse,
rebuilding one chunk's graph at a time and pulling (dy, dS) through it.
It is plain PyTorch on both routes, so the CPU tests run the code the
card runs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.rwkv6 import ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64           # the reference's ``chunk=min(64, S)`` (models/rwkv.py)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check_shapes(r, k, v, w, u):
    if r.dim() != 4:
        raise ValueError(f"r must be (B,T,H,K), got {tuple(r.shape)}")
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"{name} must be {tuple(r.shape)}, got "
                             f"{tuple(x.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"u must be (H,K) = {tuple(r.shape[2:])}, got "
                         f"{tuple(u.shape)}")


def wkv_fwd(r, k, v, w, u, *, backend: str = "auto"):
    """(y (B,T,H,K) in r's dtype, final state (B,H,K,K) fp32) from a
    zero state: the kernel, or the plain chunked form.  The kernel takes
    r, k, v in fp32 or bf16 (one dtype), w and u in fp32."""
    _check_shapes(r, k, v, w, u)
    b, t, h, kk = r.shape
    if common.route(backend, r) == "plain":
        y, s = ref.wkv_chunked(r, k, v, w, u, chunk=min(CHUNK, max(t, 1)))
        return y.to(r.dtype), s
    if kk not in HEAD_DIMS:
        raise ValueError(f"the wkv kernel takes K in {HEAD_DIMS}, got {kk}")
    for name, x in (("r", r), ("k", k), ("v", v)):
        common.check_operand(name, x, 4, DTYPES)
        if x.dtype != r.dtype:
            raise ValueError(f"{name} is {x.dtype}, r is {r.dtype}")
    common.check_operand("w", w, 4)
    common.check_operand("u", u, 2)
    y = torch.empty_like(r)
    s = torch.empty((b, h, kk, kk), device=r.device, dtype=torch.float32)
    if r.numel() == 0:
        return y, s.zero_()
    err = _build.function("wkv_fwd", _ARGTYPES)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), s.data_ptr(), b, t, h, kk,
        int(r.dtype == torch.bfloat16),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error("wkv_fwd", err)
    wkv_fwd.launches += 1
    return y, s


wkv_fwd.launches = 0


@torch.no_grad()
def chunk_states(k, v, w, chunk: int):
    """The states before each chunk of the padded sequence (nc, B,H,K,K)
    fp32, from a zero state: the chunked form's carry without its
    outputs."""
    b, _, h, kk = k.shape
    s = torch.zeros((b, h, kk, kk), dtype=torch.float32, device=k.device)
    out = []
    for kc, vc, wc in zip(*(ref.to_chunks(x, chunk) for x in (k, v, w))):
        out.append(s)
        s = ref.chunk_carry(s, kc, vc, torch.cumsum(torch.log(wc), dim=-2))
    return out


def wkv_bwd(r, k, v, w, u, dy, ds):
    """Cotangents (dr, dk, dv, dw, du) of ``ref.wkv_chunked`` (zero
    state, ``chunk=min(64, T)``) for the cotangents dy (B,T,H,K) of y and
    ds (B,H,K,K) of the final state, chunk by chunk in reverse: one
    chunk's graph at a time."""
    b, t, h, kk = r.shape
    chunk = min(CHUNK, max(t, 1))
    padded = [ref.pad_steps(x, chunk, 1.0 if x is w else 0.0)
              for x in (r, k, v, w, dy)]
    states = chunk_states(*padded[1:4], chunk)
    chunks = [ref.to_chunks(x, chunk) for x in padded]
    uf = u.float()
    grads = [torch.empty_like(c) for c in chunks[:4]]
    du = torch.zeros_like(uf)
    ds = ds.float()
    for c in reversed(range(len(states))):
        with torch.enable_grad():
            leaves = [x[c].detach().requires_grad_()
                      for x in chunks[:4]] + [
                uf.detach().requires_grad_(),
                states[c].detach().requires_grad_()]
            y_c, s_c = ref.chunk_step(leaves[5], *leaves[:5])
            got = torch.autograd.grad((y_c, s_c), leaves,
                                      (chunks[4][c], ds))
        for g, d in zip(grads, got[:4]):
            g[c] = d
        du += got[4]
        ds = got[5]

    def back(g, like):
        g = g.permute(1, 0, 3, 2, 4).reshape(b, -1, h, kk)[:, :t]
        return g.to(like.dtype)

    return (back(grads[0], r), back(grads[1], k), back(grads[2], v),
            back(grads[3], w), du.to(u.dtype))


class WKV(torch.autograd.Function):
    """The WKV6 recurrence: ``wkv_fwd`` forward, the chunk-recompute
    backward ``wkv_bwd``."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, backend):
        y, s = wkv_fwd(r, k, v, w, u, backend=backend)
        ctx.save_for_backward(r, k, v, w, u)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, w, u = ctx.saved_tensors
        # a named range, so a profiler trace can book its kernels apart
        with torch.profiler.record_function("wkv_bwd"):
            return (*wkv_bwd(r, k, v, w, u, dy.float(), ds), None)


def wkv(r, k, v, w, u, *, backend: str = "auto"):
    """r, k, v, w (B,T,H,K); u (H,K) -> (y (B,T,H,K) in r's dtype, final
    state (B,H,K,K) fp32), from a zero state.  Differentiable in all
    five inputs."""
    return WKV.apply(r.contiguous(), k.contiguous(), v.contiguous(),
                     w.contiguous(), u.contiguous(), backend)
