"""WKV6 dispatch: the CUDA kernel (``csrc/wkv.cu``) or its plain version
(``ref``), differentiable.

``wkv(r, k, v, w, u, *, backend)`` takes the model's layout, r, k, v, w
(B,T,H,K) and u (H,K), from a zero state, and returns (y (B,T,H,K) in
r's dtype, the final state (B,H,K,K) fp32), as the reference's
``wkv_pallas(..., return_state=True)``.  It is the ``WKV``
``torch.autograd.Function``: the forward is ``wkv_fwd``, the kernel on
CUDA tensors (``wkv_fwd.launches`` counts its calls, one for its two or
three kernels) and the plain chunked form on CPU tensors; ``backend="plain"``
asks for the plain version on any device.  The kernel cuts T into chunks
of ``wkv_chunk`` steps that it walks in parallel, with the states between
them carried in fp32 scratch the wrapper allocates.

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
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.rwkv6 import ref

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
CHUNK = 64           # the reference's ``chunk=min(64, S)`` (models/rwkv.py)
# the kernel's chunks: multiples of the steps it stages at a time (TS in
# csrc/wkv.cu), between WKV_MIN_CHUNK and WKV_MAX_CHUNK steps; the last
# launch's walks of the later chunks aim at WKV_BLOCKS_PER_SM blocks per SM
# (one wave: the walk's 168 registers a thread fit six blocks of 64 threads)
WKV_STEP = 16
WKV_MIN_CHUNK = 32
WKV_MAX_CHUNK = 512
WKV_BLOCKS_PER_SM = 6
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])


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


@functools.lru_cache(maxsize=1024)
def wkv_chunk(t: int, bh: int, sms: int) -> int:
    """Steps per chunk of the WKV kernel for T = ``t`` and ``bh`` (batch
    x heads) sequences on a card with ``sms`` SMs: the largest chunk of
    WKV_MIN_CHUNK * 2^j steps, at most WKV_MAX_CHUNK, whose chunks after
    the first (``wkv_chunks``; the first launch walks the first) still
    give WKV_BLOCKS_PER_SM walks per SM.  Longer chunks carry fewer
    states through memory and cost the first launch a longer walk;
    shorter ones fill the card.  Pure: no device sync."""
    chunk = WKV_MIN_CHUNK
    want = WKV_BLOCKS_PER_SM * sms
    while (chunk < min(t, WKV_MAX_CHUNK)
           and bh * (-(-t // (2 * chunk)) - 1) >= want):
        chunk *= 2
    return chunk


def wkv_chunks(t: int, chunk: int) -> list:
    """The step runs ``[t0, t1)`` of ``[0, t)`` the kernel's chunks take,
    the last one short."""
    return [(t0, min(t, t0 + chunk)) for t0 in range(0, t, chunk)]


def wkv_fwd(r, k, v, w, u, *, backend: str = "auto"):
    """(y (B,T,H,K) in r's dtype, final state (B,H,K,K) fp32) from a
    zero state: the kernel, or the plain chunked form.  The kernel takes
    r, k, v in fp32 or bf16 (one dtype), w and u in fp32."""
    _check_shapes(r, k, v, w, u)
    t = r.shape[1]
    if common.route(backend, r) == "plain":
        y, s = ref.wkv_chunked(r, k, v, w, u, chunk=min(CHUNK, max(t, 1)))
        return y.to(r.dtype), s
    return _fwd(r, k, v, w, u)


def _fwd(r, k, v, w, u, chunk=None):
    """One call of the kernel, in chunks of ``wkv_chunk``'s size, or of
    ``chunk`` steps (a multiple of WKV_STEP) when given (kernel_sweep.py
    times the choices)."""
    b, t, h, kk = r.shape
    if kk not in HEAD_DIMS:
        raise ValueError(f"the wkv kernel takes K in {HEAD_DIMS}, got {kk}")
    for name, x in (("r", r), ("k", k), ("v", v)):
        common.check_operand(name, x, 4, DTYPES)
        if x.dtype != r.dtype:
            raise ValueError(f"{name} is {x.dtype}, r is {r.dtype}")
    common.check_operand("w", w, 4)
    common.check_operand("u", u, 2)
    for name, x in (("r", r), ("k", k), ("v", v), ("w", w)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    y = torch.empty_like(r)
    s = torch.empty((b, h, kk, kk), device=r.device, dtype=torch.float32)
    if r.numel() == 0:
        return y, s.zero_()
    if chunk is None:
        sms = torch.cuda.get_device_properties(
            r.device).multi_processor_count
        chunk = wkv_chunk(t, b * h, sms)
    n = len(wkv_chunks(t, chunk)) - 1
    part = None
    if n:
        part = torch.empty((b * h * n * (kk * kk + kk),), device=r.device,
                           dtype=torch.float32)
    err = _build.function("wkv_fwd", _ARGTYPES)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), s.data_ptr(), None if part is None else part.data_ptr(),
        b, t, h, kk, chunk, int(r.dtype == torch.bfloat16),
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
