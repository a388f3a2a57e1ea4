"""LRN dispatch: the CUDA kernel (``csrc/lrn.cu``) or its plain version,
differentiable.

``lrn(x, ...)`` takes NHWC (or any (..., C)) fp32 activations.  Under
``backend="auto"`` a CUDA tensor runs the kernel and a CPU tensor the
plain version (``ref.lrn_ref``); ``lrn.launches`` counts forward kernel
launches.  The backward is the reference's closed form (``_lrn_bwd`` in
``repro/kernels/lrn/lrn.py``), which the reference leaves to XLA and this
port computes in plain PyTorch (``ref.lrn_grad``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.lrn import ref as lrn_ref_mod

MAX_CHANNELS = 12288     # one row in the default 48 KB of shared memory

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p]


def _lrn_forward(x, n, alpha, beta, k, backend):
    """One forward: the kernel launch, or the plain version."""
    if common.route(backend, x) == "plain":
        return lrn_ref_mod.lrn_ref(x, n=n, alpha=alpha, beta=beta, k=k)
    common.check_operand("x", x, x.dim())
    c = x.shape[-1]
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"lrn kernel takes 1..{MAX_CHANNELS} channels, "
                         f"got {c}")
    y = torch.empty_like(x)
    m = x.numel() // c
    if m == 0:
        return y
    fn = _build.function("lrn_f32", _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), m, c, n, alpha, beta, k,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error("lrn_f32", err)
    lrn.launches += 1
    return y


class _LRN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, alpha, beta, k, backend):
        ctx.save_for_backward(x)
        ctx.conf = (n, alpha, beta, k)
        return _lrn_forward(x, n, alpha, beta, k, backend)

    @staticmethod
    def backward(ctx, dy):
        x, = ctx.saved_tensors
        n, alpha, beta, k = ctx.conf
        return (lrn_ref_mod.lrn_grad(x, dy, n=n, alpha=alpha, beta=beta, k=k),
                None, None, None, None, None)


def lrn(x, *, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 2.0, backend: str = "auto"):
    """x (..., C) -> (..., C) float32.  Differentiable."""
    if n < 1:
        raise ValueError(f"window size n must be >= 1, got {n}")
    return _LRN.apply(x, n, float(alpha), float(beta), float(k), backend)


lrn.launches = 0
