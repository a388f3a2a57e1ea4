"""Conv dispatch: the CUDA implicit-GEMM kernel (``csrc/conv2d_fused.cu``)
or its plain version.

``conv2d_fused(x, w, ...)`` takes the reference's layouts: x (B,H,W,Cin)
NHWC, w (K,K,Cin/G,Cout) HWIO, output channels group-major.  Under
``backend="auto"`` a CUDA tensor runs the kernel and a CPU tensor the
plain version (``ref.conv2d_ref``); ``conv2d_fused.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.conv2d import ref as conv_ref

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
             + [ctypes.c_void_p])


def conv2d_fused(x, w, *, stride: int, padding: int, bias=None,
                 relu: bool = False, groups: int = 1,
                 backend: str = "auto"):
    """x (B,H,W,Cin), w (K,K,Cin/G,Cout) -> (B,OH,OW,Cout) float32, with
    the bias add and optional ReLU fused."""
    k, _, wcin, cout = w.shape
    cin = x.shape[-1]
    if wcin * groups != cin:
        raise ValueError(f"w in-channels {wcin} x groups {groups} != "
                         f"x channels {cin}")
    if cout % groups:
        raise ValueError(f"cout {cout} not divisible by groups {groups}")
    if common.route(backend, x) == "plain":
        return conv_ref.conv2d_ref(x, w, stride, padding, groups,
                                   bias=bias, relu=relu)
    common.check_operand("x", x, 4)
    common.check_operand("w", w, 4)
    if bias is not None:
        common.check_operand("bias", bias, 1)
        if bias.shape[0] != cout:
            raise ValueError(f"bias has {bias.shape[0]} entries, "
                             f"cout is {cout}")
    common.check_no_grad(x, w, *(() if bias is None else (bias,)))
    if w.shape[1] != k:
        raise ValueError(f"the kernel takes square windows, got "
                         f"{tuple(w.shape[:2])}")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride} / padding {padding} out of range")
    b_, h, wd, _ = x.shape
    oh = (h + 2 * padding - k) // stride + 1
    ow = (wd + 2 * padding - k) // stride + 1
    if b_ < 1 or oh < 1 or ow < 1:
        raise ValueError(f"empty output: batch {b_}, {oh}x{ow} map")
    y = torch.empty((b_, oh, ow, cout), device=x.device, dtype=torch.float32)
    common.check_operand("y", y, 4)
    fn = _build.function("conv2d_fused_f32", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(), y.data_ptr(),
             b_, h, wd, cin, oh, ow, cout, k, stride, padding, groups,
             int(relu), torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error("conv2d_fused_f32", err)
    conv2d_fused.launches += 1
    return y


conv2d_fused.launches = 0
