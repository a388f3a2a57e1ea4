"""LRN dispatch: the CUDA kernel (``csrc/lrn.cu``) or its plain version,
differentiable.

``lrn(x, ...)`` takes NHWC (or any (..., C)) fp32 or bf16 activations
and returns y in x's dtype (the window and the scale in fp32, as the
reference kernel computes).  Under ``backend="auto"`` a CUDA tensor runs
the kernel of its dtype (``lrn_f32`` or ``lrn_bf16``) and a CPU tensor
the plain version (``ref.lrn_ref``); ``lrn.launches`` counts forward
launches of the fp32 entry and ``lrn.launches_bf16`` of the bf16 one.
The backward is the reference's closed form (``_lrn_bwd`` in
``repro/kernels/lrn/lrn.py``), which the reference leaves to XLA and this
port computes in plain PyTorch (``ref.lrn_grad``) inside a
``torch.profiler.record_function("lrn_bwd")`` range, so that a trace books
its device time apart.

The kernel takes any C >= 1 and picks its path by shape before the
launch (``lrn_path``): in bf16, C % 8 == 0 up to VEC8_MAX_CHANNELS with a
window up to VEC_MAX_WINDOW, k >= FLT_MIN and alpha >= 0 (AlexNet's C = 96
and 256, n = 5, k = 2) runs the 8-channel path (16-byte loads, the power
on the SFU); otherwise, in either dtype, C % 4 == 0 up to
VEC_MAX_CHANNELS runs the 4-channel vectorized path, and other shapes a
plain one-element-a-thread path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.lrn import ref as lrn_ref_mod

# the vectorized path (MAX_GROUPS * 4 and MAX_N in csrc/lrn.cu), and the
# bf16 8-channel path (MAX_GROUPS * 8)
VEC_MAX_CHANNELS = 1024
VEC_MAX_WINDOW = 9
VEC8_MAX_CHANNELS = 2048

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p]
# the entry per activation dtype, and the launch count it adds to
_ENTRIES = {torch.float32: ("lrn_f32", "launches"),
            torch.bfloat16: ("lrn_bf16", "launches_bf16")}


def lrn_path(c: int, n: int, dtype, k: float, alpha: float,
             align: int = 16) -> str:
    """The kernel's path for rows of ``c`` channels, a window of ``n``,
    ``k`` and ``alpha`` as the kernel takes them (fp32), and x and y
    whose addresses are multiples of ``align`` bytes (``lrn_bf16`` and
    ``launch`` in csrc/lrn.cu): ``"vec8"`` (bf16 only, 8 channels a
    thread, the power on the SFU: d >= k must be a normal number),
    ``"vec4"`` (4 channels a thread) or ``"generic"``."""
    if n > VEC_MAX_WINDOW:
        return "generic"
    k32, alpha32 = torch.tensor([k, alpha], dtype=torch.float32).tolist()
    if (dtype == torch.bfloat16 and c % 8 == 0 and c <= VEC8_MAX_CHANNELS
            and k32 >= torch.finfo(torch.float32).tiny and alpha32 >= 0
            and align % 16 == 0):
        return "vec8"
    itemsize = torch.finfo(dtype).bits // 8
    if c % 4 == 0 and c <= VEC_MAX_CHANNELS and align % (4 * itemsize) == 0:
        return "vec4"
    return "generic"


def _lrn_forward(x, n, alpha, beta, k, backend):
    """One forward: the kernel launch, or the plain version."""
    if common.route(backend, x) == "plain":
        return lrn_ref_mod.lrn_ref(x, n=n, alpha=alpha, beta=beta, k=k)
    common.check_operand("x", x, x.dim(), tuple(_ENTRIES))
    c = x.shape[-1]
    if c < 1:
        raise ValueError(f"lrn kernel takes C >= 1 channels, got {c}")
    y = torch.empty_like(x)
    m = x.numel() // c
    if m == 0:
        return y
    entry, counter = _ENTRIES[x.dtype]
    fn = _build.function(entry, _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), m, c, n, alpha, beta, k,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error(entry, err)
    setattr(lrn, counter, getattr(lrn, counter) + 1)
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
        with torch.profiler.record_function("lrn_bwd"):
            dx = lrn_ref_mod.lrn_grad(x, dy, n=n, alpha=alpha, beta=beta,
                                      k=k)
        return dx, None, None, None, None, None


def lrn(x, *, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 2.0, backend: str = "auto"):
    """x (..., C) -> (..., C) in x's dtype (fp32 or bf16).
    Differentiable."""
    if n < 1:
        raise ValueError(f"window size n must be >= 1, got {n}")
    return _LRN.apply(x, n, float(alpha), float(beta), float(k), backend)


lrn.launches = 0
lrn.launches_bf16 = 0
