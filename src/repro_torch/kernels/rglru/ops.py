"""RG-LRU dispatch: the CUDA kernel (``csrc/rglru.cu``) or its plain
version (``ref``), differentiable.

``rglru_scan(a, b, *, backend)`` takes fp32 a, b (B,T,D) and returns h
(B,T,D) fp32 from a zero state, as the reference's ``rglru_pallas``.  It
is the ``RGLRU`` ``torch.autograd.Function``, whose forward and backward
both go through ``rglru_fwd``, the kernel on CUDA tensors and the plain
loop on CPU tensors (``backend="plain"`` asks for the plain version on
any device).  The cotangent of a linear recurrence is the same
recurrence run backwards (``g_t = dh_t + a_{t+1} g_{t+1}``), so the
backward launches the kernel once more with ``reverse=True``, as the
reference's backward calls its Pallas kernel again
(``repro/kernels/rglru/rglru.py:98-111``), then ``da = g * h_{t-1}`` and
``db = g``.  ``rglru_fwd.launches`` counts both launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.rglru import ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _check_shapes(a, b):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a, b must be one (B,T,D) shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")


def rglru_fwd(a, b, *, reverse: bool = False, backend: str = "auto"):
    """h (B,T,D) fp32 with h_t = a_t h_{t-1} + b_t from zero, or with
    ``reverse`` g_t = b_t + a_{t+1} g_{t+1} from the end: the kernel, or
    the plain loop.  The kernel takes fp32 a and b."""
    _check_shapes(a, b)
    if common.route(backend, a) == "plain":
        return ref.rglru_transpose(a, b) if reverse else \
            ref.rglru_sequential(a, b)[0]
    common.check_operand("a", a, 3)
    common.check_operand("b", b, 3)
    bsz, t, d = a.shape
    h = torch.empty_like(a)
    if a.numel() == 0:
        return h
    err = _build.function("rglru_fwd", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), h.data_ptr(), bsz, t, d, int(reverse),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error("rglru_fwd", err)
    rglru_fwd.launches += 1
    return h


rglru_fwd.launches = 0


class RGLRU(torch.autograd.Function):
    """``h_t = a_t h_{t-1} + b_t``: ``rglru_fwd`` forward, ``rglru_fwd``
    reversed in the backward."""

    @staticmethod
    def forward(ctx, a, b, backend):
        h = rglru_fwd(a, b, backend=backend)
        ctx.save_for_backward(a, h)
        ctx.backend = backend
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        g = rglru_fwd(a, dh.float().contiguous(), reverse=True,
                      backend=ctx.backend)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        return g * h_prev, g, None


def rglru_scan(a, b, *, backend: str = "auto"):
    """a, b (B,T,D) fp32 -> h (B,T,D) fp32.  Differentiable in a and b."""
    return RGLRU.apply(a.float().contiguous(), b.float().contiguous(),
                       backend)
