"""LRN dispatch: the CUDA kernel (``csrc/lrn.cu``) or its plain version.

``lrn(x, ...)`` takes NHWC (or any (..., C)) fp32 activations.  Under
``backend="auto"`` a CUDA tensor runs the kernel and a CPU tensor the
plain version (``ref.lrn_ref``); ``lrn.launches`` counts kernel launches.
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


def lrn(x, *, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 2.0, backend: str = "auto"):
    """x (..., C) -> (..., C) float32."""
    if n < 1:
        raise ValueError(f"window size n must be >= 1, got {n}")
    if common.route(backend, x) == "plain":
        return lrn_ref_mod.lrn_ref(x, n=n, alpha=alpha, beta=beta, k=k)
    common.check_operand("x", x, x.dim())
    common.check_no_grad(x)
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


lrn.launches = 0
