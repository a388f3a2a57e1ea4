"""Plain PyTorch versions of the conv kernels: the grouped NHWC x HWIO conv
with bias and ReLU, and the blocked GEMM with its bias/ReLU epilogue, each
in fp32 over upcast operands and cast once to x's dtype.

``conv2d_ref`` repeats the arithmetic of the reference kernel
(``repro/kernels/conv2d/conv2d.py::_conv_fused_kernel``): for every kernel
offset (kh, kw) the strided window slice of the zero-padded image is that
offset's (M, Cg) slab of the im2col matrix, and the conv is the sum of
K*K (M, Cg) @ (Cg, Cout/G) products per group, in fp32 over upcast
operands, with the bias and ReLU in fp32 and the result cast once to x's
dtype (bf16 under the bf16 numerics preset).  It calls no library
convolution, so it is independent of the kernel and of cuDNN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_ref(x, w, stride: int, padding: int, groups: int = 1, *,
               bias=None, relu: bool = False):
    """x (B,H,W,Cin), w (K,K,Cin/G,Cout) -> (B,OH,OW,Cout) in x's dtype.

    Output channels are group-major: group g owns
    ``[g*Cout/G, (g+1)*Cout/G)`` and reads input channels
    ``[g*Cin/G, (g+1)*Cin/G)``."""
    k, _, cig, cout = w.shape
    npg = cout // groups
    xf = x.float()
    if padding:
        xf = F.pad(xf, (0, 0, padding, padding, padding, padding))
    b_, hp, wp, _ = xf.shape
    oh = (hp - k) // stride + 1
    ow = (wp - k) // stride + 1
    span_h = (oh - 1) * stride + 1
    span_w = (ow - 1) * stride + 1
    outs = []
    for g in range(groups):
        xg = xf[..., g * cig:(g + 1) * cig]
        wg = w[..., g * npg:(g + 1) * npg].float()
        acc = xf.new_zeros((b_, oh, ow, npg))
        for kh in range(k):
            for kw in range(k):
                win = xg[:, kh:kh + span_h:stride, kw:kw + span_w:stride, :]
                acc = acc + torch.matmul(win, wg[kh, kw])
        outs.append(acc)
    y = outs[0] if groups == 1 else torch.cat(outs, dim=-1)
    if bias is not None:
        y = y + bias.float()
    return (torch.relu(y) if relu else y).to(x.dtype)


def matmul_bias_ref(x, w, b=None, relu: bool = False):
    """(M,K) @ (K,N) + b(N,) in fp32 over upcast operands, optional ReLU,
    cast once to x's dtype: the arithmetic of the reference kernel
    (``repro/kernels/conv2d/conv2d.py::_matmul_kernel``), the plain
    version of the fp32 and bf16 entries alike.  Takes transposed views
    as they are."""
    y = x.float() @ w.float()
    if b is not None:
        y = y + b.float()
    return (torch.relu(y) if relu else y).to(x.dtype)
