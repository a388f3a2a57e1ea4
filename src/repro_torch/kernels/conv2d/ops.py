"""Conv dispatch: the CUDA kernels (``csrc/conv2d_fused.cu``,
``csrc/conv2d_fused_bf16.cu``, ``csrc/matmul_bias.cu``) or their plain
versions, each differentiable.

``conv2d_fused(x, w, ...)`` takes the reference's layouts: x (B,H,W,Cin)
NHWC, w (K,K,Cin/G,Cout) HWIO, output channels group-major, in fp32 or
bf16 (x, w and the bias of one dtype; y in it).  fp32 operands launch
``conv2d_fused_f32``, bf16 ones ``conv2d_fused_bf16`` (tensor cores, fp32
accumulation, bias and ReLU in fp32, one rounding to bf16, as the
reference kernel computes on upcast operands).  The bf16 entry has two
bodies, picked by shape before the launch (``conv_route_bf16``): the
``wgmma`` body (warp-specialised, a TMA-fed weight ring, whole-group
tiles; ``conv_tiles_bf16``) wherever it takes the shape, every AlexNet
conv among them, and the ``mma_sync`` body (``conv_tiles``) elsewhere.
Its backward follows ``_conv_fused_bwd``
(``repro/kernels/conv2d/conv2d.py``): the ReLU mask, the bias sum, and dx
/ dw as the conv's transposes in fp32 over upcast operands, cast back to
the operands' dtype, which the reference leaves to XLA's conv-grad and
this port to the library's (``aten.convolution_backward``, TF32 off).

``matmul_bias(x, w, b, ...)`` is (M,K) @ (K,N) + b with the bias/ReLU
epilogue, in the operands' dtype (x, w and b share one): fp32 operands
launch ``matmul_bias_f32`` (``csrc/matmul_bias.cu``, the fp32 FMA pipes),
bf16 ones ``matmul_bias_bf16`` (``csrc/matmul_bias_bf16.cu``, the tensor
cores, fp32 accumulation over the whole reduction, one rounding to
bf16), as the reference kernel accumulates in fp32 and writes x's dtype.
The bf16 entry has three bodies, picked by shape and alignment before the
launch (``gemm_plan_bf16``): ``wgmma`` (warp-specialised, TMA-fed, 128 x
128-256 tiles; ``gemm_tiles_bf16``) for operands TMA can map, ``swap_ab``
(Y^T = W^T X^T, the weight's columns along wgmma's 128 rows) for those at
M <= 64 (decode), and ``mma_sync`` (``gemm_split``) for the rest (AlexNet
conv1's 363-wide patches).  Its backward is two more launches of the same
entry, ``dx = dy @ w^T`` and ``dw = x^T @ dy``, with the transposes read
in place.  Where the output tiles are too few to fill the card, the rule
deals each tile's reduction out over several blocks, whose fp32 partials
a second kernel adds in a fixed order (one launch all the same).
``conv2d_im2col`` is the two-stage parity formulation built on it:
``F.unfold`` patches (the reference's XLA patch extraction) times the
reordered, block-diagonal weight matrix, in fp32 or bf16.

Under ``backend="auto"`` a CUDA tensor runs the kernels and a CPU tensor
the plain versions (``ref``).  ``conv2d_fused.launches`` counts forward
launches of the fp32 entry and ``conv2d_fused.launches_bf16`` of the bf16
one (the backward is the library's), of which
``conv2d_fused.launches_bf16_wgmma`` took the wgmma body;
``matmul_bias.launches`` counts every launch of the fp32 GEMM entry and
``matmul_bias.launches_bf16`` of the bf16 one, backward included, of
which ``matmul_bias.launches_bf16_wgmma`` took a TMA body (``wgmma`` or
``swap_ab``).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, common
from repro_torch.kernels.conv2d import ref as conv_ref

_CONV_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 14
                  + [ctypes.c_void_p])
# the bf16 entry takes the body as one more int
_CONV_BF16_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p])
_MATMUL_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p]
# the bf16 entry takes the tile width and the body as two more ints
_MATMUL_BF16_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
    ctypes.c_void_p]
# the fused conv's entry per operand dtype, the launch count it adds to and
# its argument types
_CONV_ENTRIES = {torch.float32: ("conv2d_fused_f32", "launches",
                                 _CONV_ARGTYPES),
                 torch.bfloat16: ("conv2d_fused_bf16", "launches_bf16",
                                  _CONV_BF16_ARGTYPES)}
# the bf16 entry's bodies, by the code it takes
CONV_BF16_BODIES = {"wgmma": 1, "mma_sync": 2}
# the GEMM's entry per operand dtype, the launch count it adds to and its
# argument types
_MATMUL_ENTRIES = {torch.float32: ("matmul_bias_f32", "launches",
                                   _MATMUL_ARGTYPES),
                   torch.bfloat16: ("matmul_bias_bf16", "launches_bf16",
                                    _MATMUL_BF16_ARGTYPES)}
# the bf16 GEMM entry's bodies, by the code it takes
GEMM_BF16_BODIES = {"wgmma": 1, "mma_sync": 2, "swap_ab": 3}
# The fp32 GEMM kernel's output tile (GEMM_BM rows, gemm_bn(N) columns) and
# its reduction chunk (csrc/matmul_bias.cu's BM, BK and the N <= 64 pick of
# launch_tiles; tests/test_torch_matmul.py reads them from the source).
GEMM_BM, GEMM_BK = 128, 16
# The bf16 kernel's mma_sync body (csrc/matmul_bias_bf16.cu's BM, BN and
# BK): one tile of 128 x 128 at every N, chunks of 32.
GEMM_BF16_BM, GEMM_BF16_BN, GEMM_BF16_BK = 128, 128, 32
GEMM_MIN_CHUNKS = 8      # a split's reduction runs at least this many chunks
# gemm_split's cost model, in chunk-times (one block's step of GEMM_BK over
# its tile): a block's cost outside its reduction (the ring's fill, the
# epilogue), and the HBM rate at which each split's fp32 partial is written
# and read back by the sum.  A chunk-time of a 128 x 128 tile is 262,144
# FMAs, 2,048 cycles of an H100 SM's 128 fp32 lanes: 1.17 us at 1.755 GHz.
# GEMM_CHUNK_S sits between that and the 1.5-1.6 us the unsplit products
# took on an H100 80GB HBM3 at 700 W (kernel_sweep.py: conv2's dx, 27 waves
# of 20 chunk-times in 0.824 ms; conv2's forward, 3 waves of 154 in 0.758).
# It only weighs the partials' traffic against the chunks, and HBM_RATE is
# the H100 SXM's 3.35 TB/s.
GEMM_FILL_CHUNKS = 4
GEMM_CHUNK_S = 1.4e-6
HBM_RATE = 3.35e12
# The bf16 kernel's mma_sync body borrows the model and GEMM_FILL_CHUNKS /
# GEMM_MIN_CHUNKS, with its own chunk-time and two blocks resident on an SM
# (~125 registers x 256 threads).  It runs only operands TMA cannot map,
# whose rows take the narrow copy path, so its chunk-time is fitted to that
# path's times alone (kernel_sweep.py --kernels gemm_bf16, fit_gemm_bf16,
# on an H100 80GB HBM3 at 700 W: AlexNet conv1's forward and its dw at 13
# (split) points, 2.9 % rms with a fixed 28 us a call; the dw took 0.1393
# ms at 87 splits, which the second resident block makes one wave).
GEMM_BF16_CHUNK_S = 2.57e-6
GEMM_BF16_RESIDENT = 2
# The bf16 kernel's TMA bodies (csrc/matmul_bias_bf16.cu's TMA_BM, TMA_BK,
# WGMMA_WIDTHS and SWAP_WIDTHS; tests/test_torch_matmul.py reads them from
# the source): tiles of 128 rows (of M, or of N on the swap_ab body) by one
# of GEMM_BF16_BNS (GEMM_BF16_SWAP_BNS) columns, a reduction step of 64, a
# persistent block of 384 threads per SM.  gemm_tiles_bf16's cost model: a
# unit's chunk takes GEMM_BF16_CHUNK_US[bn] (GEMM_BF16_SWAP_CHUNK_US[bn]) of
# its SM's time and its epilogue GEMM_BF16_FILL_CHUNKS chunks more; a split
# adds the partials' HBM traffic and GEMM_BF16_SUM_US for the kernel that
# adds them; a split's run is at least GEMM_BF16_MIN_CHUNKS chunks.  The
# swap_ab body takes M <= GEMM_BF16_SWAP_MAX_M.  The constants are the
# least-squares fit (relative error) that kernel_sweep.py --kernels
# gemm_bf16 prints (fit_gemm_bf16), the mean of two sweeps on an H100 80GB
# HBM3 at 700 W, rounded: with a fixed 6.8 us a call they reproduce the 372
# timed (body, width, split) points of its 26 shapes (Mixtral's expert
# products, decode's at M = 16, 32 and 64, AlexNet's aligned im2col
# products) to 9.7 % rms, and the rule picks the fastest timed choice at
# 22 of the 26 (their sum 1.7237 ms against the fastest choices' 1.7205;
# AlexNet conv4's dw the worst, 0.0408 against 0.0384).
GEMM_BF16_TMA_BM, GEMM_BF16_TMA_BK = 128, 64
GEMM_BF16_CHUNK_US = {128: 0.36, 160: 0.42, 192: 0.46, 256: 0.59}
GEMM_BF16_SWAP_CHUNK_US = {16: 0.39, 32: 0.40, 64: 0.41}
GEMM_BF16_FILL_CHUNKS = 4.25
GEMM_BF16_SUM_US = 4.41
GEMM_BF16_MIN_CHUNKS = 2
GEMM_BF16_SWAP_MAX_M = 64
GEMM_BF16_BNS = tuple(sorted(GEMM_BF16_CHUNK_US))
GEMM_BF16_SWAP_BNS = tuple(sorted(GEMM_BF16_SWAP_CHUNK_US))
# The fused conv kernel's output tile (CONV_BM rows, one of CONV_BNS
# columns) and reduction chunk (csrc/conv2d_fused.cu's BM, BK and the bn
# cases of conv2d_fused_f32; tests/test_torch_conv2d.py reads them from the
# source; the bf16 kernel's mma_sync body, csrc/conv2d_fused_bf16.cu,
# shares BM, BK and the widths, so the same rules pick for it).
# conv_tiles' cost model (timed on the fp32 kernel): the 64-wide kernel
# fits two blocks to
# an SM (116-128 registers a thread), the 96-wide one one (181-199); a
# block's chunk takes CONV_CHUNK_US[bn] of its SM's time, or CONV_ALONE_US
# where a 64-wide block has its SM to itself.  kernel_sweep.py's times on
# an H100 80GB HBM3 at 700 W: conv2 at batch 128 at width 64, 1.539 ms
# for 12 waves of two blocks of 79 chunk-times (75 chunks + the fill);
# conv4 at width 96, 0.921 ms for 6 waves of 112; conv3 at batch 8 at
# width 64 with one block per SM, 0.0858 ms for 76.
CONV_BM, CONV_BK = 128, 16
CONV_RESIDENT = {64: 2, 96: 1}
CONV_CHUNK_US = {64: 0.81, 96: 1.37}
CONV_ALONE_US = 1.13
CONV_BNS = tuple(sorted(CONV_CHUNK_US))
# The bf16 kernel's wgmma body (csrc/conv2d_fused_bf16.cu's WG_BM, WG_BK and
# the widths conv2d_fused_bf16 launches; tests/test_torch_conv2d.py reads
# them from the source): 128-row tiles of one of CONV_BF16_BNS columns, a
# reduction chunk of CONV_BF16_BK columns (one kh on the rows route), a
# persistent block of 384 threads per SM.  conv_tiles_bf16's cost model: a
# work unit's chunk takes CONV_BF16_CHUNK_US[bn] of its SM's time and its
# epilogue CONV_BF16_FILL_CHUNKS chunks more; a split adds the partials'
# HBM traffic and CONV_BF16_SUM_US for the kernel that adds them; a
# split's run is at least CONV_BF16_MIN_CHUNKS chunks.  The constants are a
# least-squares fit (relative error) to kernel_sweep.py --kernels
# conv_bf16 on an H100 80GB HBM3 at 700 W: with 6 us a launch they
# reproduce the 180 timed (width, split) points of the 11 pieces-route
# shapes to 5 % rms, and on the final kernel's sweep the rule picks the
# fastest choice at all 15 shapes.
CONV_BF16_BM, CONV_BF16_BK = 128, 64
CONV_BF16_ROW_RUN = 37   # the rows route's longest run (ROW_RUN)
CONV_BF16_CHUNK_US = {64: 0.48, 96: 0.59, 128: 0.62, 192: 0.78}
CONV_BF16_FILL_CHUNKS = 1.5
CONV_BF16_SUM_US = 2.0
CONV_BF16_MIN_CHUNKS = 2
CONV_BF16_BNS = tuple(sorted(CONV_BF16_CHUNK_US))

# ------------------------------------------------------- fused conv ------

def conv_ranges(kdim: int, n_split: int) -> list:
    """The runs ``[lo, hi)`` of the ``ceil(kdim / CONV_BK)`` reduction
    chunks that the conv kernel's splits take when ``n_split`` are asked
    (the kernel's ``c_lo`` / ``c_hi``, as ``gemm_ranges``)."""
    chunks = -(-kdim // CONV_BK)
    per = -(-chunks // n_split)
    return [(lo, min(chunks, lo + per)) for lo in range(0, chunks, per)]


@functools.lru_cache(maxsize=1024)
def conv_tiles(m: int, npg: int, kdim: int, groups: int, sms: int) -> tuple:
    """(bn, n_split) for the fused conv kernel: the output tile's width
    (one of ``CONV_BNS``, one that divides ``npg`` where one does) and the
    blocks over which each tile's reduction chunks are dealt out
    (``conv_ranges``), for M = ``m`` output pixels, ``npg`` output
    channels per group, a reduction of ``kdim`` = K*K*Cg and a card with
    ``sms`` SMs.  It minimises the run's time in the model above: the
    busiest SM's blocks, each taking its chunks plus ``GEMM_FILL_CHUNKS``,
    plus every split's partial through HBM.  Ties go to the wider tile
    and to fewer splits."""
    chunks = -(-kdim // CONV_BK)
    partial_us = 8.0 * m * npg * groups / HBM_RATE * 1e6
    best, best_cost = None, None
    for bn in sorted([w for w in CONV_BNS if npg % w == 0] or CONV_BNS,
                     reverse=True):
        tiles = -(-m // CONV_BM) * -(-npg // bn) * groups
        for want in range(1, max(1, min(chunks // GEMM_MIN_CHUNKS,
                                        -(-4 * sms // tiles))) + 1):
            runs = conv_ranges(kdim, want)
            split, per = len(runs), runs[0][1]
            k = -(-tiles * split // sms)       # blocks on the busiest SM
            chunk_us = (CONV_ALONE_US if k == 1 and CONV_RESIDENT[bn] > 1
                        else k * CONV_CHUNK_US[bn])
            cost = (chunk_us * (per + GEMM_FILL_CHUNKS)
                    + (split > 1) * split * partial_us)
            if best_cost is None or cost < best_cost - 1e-9:
                best, best_cost = (bn, split), cost
    return best


def conv_route_bf16(cin: int, cout: int, k: int, padding: int,
                    groups: int, aligned: bool = True):
    """How the bf16 kernel's wgmma body gathers its A operand for this
    shape, or None where it takes none and the ``mma_sync`` body runs
    (the rule that picks the body; the entry point's ``wgmma_route``
    refuses the wgmma body where it fails): ``"pieces"`` (16-byte copies of 8
    channels of one tap) where Cg % 8 == 0, ``"rows"`` (each pixel's run
    of K * Cin values for one kh, copied raw and shifted into place) for
    an ungrouped, unpadded conv whose run is at most ``CONV_BF16_ROW_RUN``
    values (conv1: Cin 3, K 11).  Both need whole 16-byte output pieces
    (npg % 8 == 0) and 16-byte aligned operands."""
    cg, npg = cin // groups, cout // groups
    if npg % 8 or not aligned:
        return None
    if cg % 8 == 0:
        return "pieces"
    if groups == 1 and padding == 0 and k * cin <= CONV_BF16_ROW_RUN:
        return "rows"
    return None


def conv_chunks_bf16(route: str, k: int, cg: int) -> int:
    """Reduction chunks of the wgmma body: one per kh on the rows route,
    else ``ceil(K*K*Cg / CONV_BF16_BK)``."""
    return k if route == "rows" else -(-k * k * cg // CONV_BF16_BK)


def conv_ranges_bf16(chunks: int, n_split: int) -> list:
    """The runs ``[lo, hi)`` of the wgmma body's ``chunks`` that its
    splits take when ``n_split`` are asked (the kernel's ``c_lo`` and
    ``n_c``); empty runs are left out."""
    per = -(-chunks // n_split)
    return [(lo, min(chunks, lo + per)) for lo in range(0, chunks, per)]


@functools.lru_cache(maxsize=1024)
def conv_tiles_bf16(m: int, npg: int, chunks: int, groups: int,
                    sms: int) -> tuple:
    """(bn, n_split) for the bf16 kernel's wgmma body: the output tile's
    width (one of ``CONV_BF16_BNS`` that divides ``npg`` where one does,
    so a tile spans the group's channels or an equal share of them) and
    the blocks over which each tile's reduction chunks are dealt out
    (``conv_ranges_bf16``), for M = ``m`` output pixels, ``npg`` output
    channels per group, ``chunks`` reduction chunks and a card with
    ``sms`` SMs.  It minimises the run's time in the model above: the
    busiest SM's units (``ceil(units / sms)`` of them), each taking its
    chunks plus ``CONV_BF16_FILL_CHUNKS``, plus, for a split, the sum
    kernel and every split's fp32 partial through HBM.  Ties go to the
    wider tile and to fewer splits."""
    partial_us = 8.0 * m * npg * groups / HBM_RATE * 1e6
    best, best_cost = None, None
    for bn in sorted([w for w in CONV_BF16_BNS if npg % w == 0]
                     or CONV_BF16_BNS, reverse=True):
        tiles = -(-m // CONV_BF16_BM) * -(-npg // bn) * groups
        for want in range(1, max(1, min(chunks // CONV_BF16_MIN_CHUNKS,
                                        -(-2 * sms // tiles))) + 1):
            runs = conv_ranges_bf16(chunks, want)
            split, per = len(runs), runs[0][1]
            waves = -(-tiles * split // sms)
            cost = (waves * (per + CONV_BF16_FILL_CHUNKS)
                    * CONV_BF16_CHUNK_US[bn]
                    + (split > 1) * (CONV_BF16_SUM_US + split * partial_us))
            if best_cost is None or cost < best_cost - 1e-9:
                best, best_cost = (bn, split), cost
    return best


def conv_plan_bf16(x_shape, cout: int, k: int, stride: int, padding: int,
                   groups: int, sms: int, aligned: bool = True, tiles=None,
                   body=None) -> tuple:
    """(body, bn, n_split) of a bf16 launch on x of ``x_shape`` (B, H, W,
    Cin), with 16-byte aligned operands where ``aligned``: the body
    ``conv_route_bf16`` picks, or ``body`` when given (``"wgmma"`` raises
    where the route takes no shape); then the tile width and split of
    that body's rule, or of ``tiles`` = (bn, n_split) over that body's
    runs.  ``_conv_forward`` names the body to the entry point, which
    runs it or refuses it and never picks another."""
    b_, h, wd, cin = x_shape
    m = (b_ * ((h + 2 * padding - k) // stride + 1)
         * ((wd + 2 * padding - k) // stride + 1))
    route = conv_route_bf16(cin, cout, k, padding, groups, aligned)
    if body is None:
        body = "mma_sync" if route is None else "wgmma"
    elif body not in CONV_BF16_BODIES:
        raise ValueError(f"body must be one of {tuple(CONV_BF16_BODIES)}, "
                         f"got {body!r}")
    elif body == "wgmma" and route is None:
        raise ValueError("the wgmma body does not take this shape "
                         "(see conv_route_bf16)")
    cg, npg = cin // groups, cout // groups
    if body == "wgmma":
        chunks = conv_chunks_bf16(route, k, cg)
        if tiles is None:
            return (body,) + conv_tiles_bf16(m, npg, chunks, groups, sms)
        return body, tiles[0], len(conv_ranges_bf16(chunks, tiles[1]))
    kdim = k * k * cg
    if tiles is None:
        return (body,) + conv_tiles(m, npg, kdim, groups, sms)
    return body, tiles[0], len(conv_ranges(kdim, tiles[1]))


def _conv_forward(x, w, bias, stride, padding, relu, groups, backend,
                  tiles=None, body=None):
    """One forward: the kernel launch of x's dtype, or the plain version.
    bf16 operands run the body ``conv_route_bf16`` picks, or ``body``
    (``"wgmma"`` or ``"mma_sync"``) when given (``conv_plan_bf16``).  The
    kernel takes the tile width and split its body's rule picks
    (``conv_tiles_bf16``, or ``conv_tiles`` for fp32 and the mma_sync
    body), or ``tiles`` = (bn, n_split) when given, the split over the
    runs of ``conv_ranges_bf16`` or ``conv_ranges`` (kernel_sweep.py times
    the choices)."""
    k, _, _, cout = w.shape
    for name, t in (("w", w), ("bias", bias)):
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"conv2d_fused: {name} is {t.dtype}, x is "
                             f"{x.dtype}; the operands share one dtype")
    if common.route(backend, x) == "plain":
        return conv_ref.conv2d_ref(x, w, stride, padding, groups,
                                   bias=bias, relu=relu)
    dtypes = tuple(_CONV_ENTRIES)
    common.check_operand("x", x, 4, dtypes)
    common.check_operand("w", w, 4, dtypes)
    if bias is not None:
        common.check_operand("bias", bias, 1, dtypes)
        if bias.shape[0] != cout:
            raise ValueError(f"bias has {bias.shape[0]} entries, "
                             f"cout is {cout}")
    if w.shape[1] != k:
        raise ValueError(f"the kernel takes square windows, got "
                         f"{tuple(w.shape[:2])}")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride} / padding {padding} out of range")
    b_, h, wd, cin = x.shape
    oh = (h + 2 * padding - k) // stride + 1
    ow = (wd + 2 * padding - k) // stride + 1
    if b_ < 1 or oh < 1 or ow < 1:
        raise ValueError(f"empty output: batch {b_}, {oh}x{ow} map")
    y = torch.empty((b_, oh, ow, cout), device=x.device, dtype=x.dtype)
    common.check_operand("y", y, 4, dtypes)
    kdim = k * k * (cin // groups)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if x.dtype == torch.bfloat16:
        # the wgmma body's rule on these operands' addresses (a fresh part
        # is aligned); the entry runs the body named, or refuses it
        body, bn, n_split = conv_plan_bf16(
            x.shape, cout, k, stride, padding, groups, sms,
            (x.data_ptr() | w.data_ptr() | y.data_ptr()
             | (0 if bias is None else bias.data_ptr())) % 16 == 0, tiles,
            body)
    elif body is not None:
        raise ValueError("body applies to bf16 operands only")
    elif tiles is None:
        bn, n_split = conv_tiles(b_ * oh * ow, cout // groups, kdim, groups,
                                 sms)
    else:
        bn, n_split = tiles[0], len(conv_ranges(kdim, tiles[1]))
    part = None
    if n_split > 1:
        part = torch.empty((n_split,) + tuple(y.shape), device=x.device,
                           dtype=torch.float32)
        common.check_operand("part", part, 5)
    entry, counter, argtypes = _CONV_ENTRIES[x.dtype]
    fn = _build.function(entry, argtypes)
    body_arg = ((CONV_BF16_BODIES[body],) if x.dtype == torch.bfloat16
                else ())
    err = fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(), y.data_ptr(),
             None if part is None else part.data_ptr(),
             b_, h, wd, cin, oh, ow, cout, k, stride, padding, groups,
             int(relu), bn, n_split, *body_arg,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error(entry, err)
    setattr(conv2d_fused, counter, getattr(conv2d_fused, counter) + 1)
    if body == "wgmma":
        conv2d_fused.launches_bf16_wgmma += 1
    return y


def conv_transpose_grads(dy, x, w, stride: int, padding: int, groups: int,
                         need_x: bool = True, need_w: bool = True):
    """dx (NHWC) and dw (HWIO) of the grouped conv y = conv(x, w) for the
    cotangent dy (NHWC): the library's conv-grad on channels-last views,
    the counterpart of XLA's conv-transpose in the reference.  A grad
    that is not needed comes back as None.  The operands are upcast to
    fp32 and the grads cast back to x's and w's dtype, as the
    reference's ``_conv_fused_bwd`` does (a no-op in fp32)."""
    x_dt, w_dt = x.dtype, w.dtype
    dy, x, w = dy.float(), x.float(), w.float()
    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_oihw, None,
        [stride, stride], [padding, padding], [1, 1], False, [0, 0],
        groups, [need_x, need_w, False])
    return (dx.permute(0, 2, 3, 1).to(x_dt).contiguous() if need_x
            else None,
            dw.permute(2, 3, 1, 0).to(w_dt).contiguous() if need_w
            else None)


class _ConvFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, relu, groups, backend):
        y = _conv_forward(x, w, bias, stride, padding, relu, groups,
                          backend)
        ctx.save_for_backward(x, w, y)
        ctx.conf = (stride, padding, relu, groups)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        stride, padding, relu, groups = ctx.conf
        if relu:
            dy = dy * (y > 0).to(dy.dtype)
        db = dy.sum((0, 1, 2)) if ctx.needs_input_grad[2] else None
        dx, dw = conv_transpose_grads(dy, x, w, stride, padding, groups,
                                      ctx.needs_input_grad[0],
                                      ctx.needs_input_grad[1])
        return dx, dw, db, None, None, None, None, None


def conv2d_fused(x, w, *, stride: int, padding: int, bias=None,
                 relu: bool = False, groups: int = 1,
                 backend: str = "auto"):
    """x (B,H,W,Cin), w (K,K,Cin/G,Cout) -> (B,OH,OW,Cout) in x's dtype
    (fp32 or bf16, shared by w and the bias), with the bias add and
    optional ReLU fused.  Differentiable."""
    _, _, wcin, cout = w.shape
    cin = x.shape[-1]
    if wcin * groups != cin:
        raise ValueError(f"w in-channels {wcin} x groups {groups} != "
                         f"x channels {cin}")
    if cout % groups:
        raise ValueError(f"cout {cout} not divisible by groups {groups}")
    return _ConvFused.apply(x, w, bias, stride, padding, relu, groups,
                            backend)


conv2d_fused.launches = 0
conv2d_fused.launches_bf16 = 0
conv2d_fused.launches_bf16_wgmma = 0


# --------------------------------------------------- blocked GEMM --------

def _layout(name: str, t: torch.Tensor, dtypes=(torch.float32,)) -> int:
    """1 when ``t`` is the transpose of a contiguous matrix (the kernel
    reads it in place), 0 when it is contiguous; raises otherwise."""
    if t.dim() != 2:
        raise ValueError(f"{name} must be a matrix, got shape "
                         f"{tuple(t.shape)}")
    if t.is_contiguous():
        common.check_operand(name, t, 2, dtypes)
        return 0
    if t.t().is_contiguous():
        common.check_operand(f"{name}^T", t.t(), 2, dtypes)
        return 1
    raise ValueError(f"{name} must be contiguous or the transpose of a "
                     "contiguous matrix")


def gemm_bn(n: int, dtype=torch.float32) -> int:
    """Output columns per block of the GEMM kernel of ``dtype`` for N =
    ``n`` (in bf16, of its ``mma_sync`` body; ``gemm_plan_bf16`` gives
    every body's)."""
    if dtype == torch.bfloat16:
        return GEMM_BF16_BN
    return 64 if n <= 64 else 128


def _gemm_consts(dtype) -> tuple:
    """(rows per tile, reduction chunk, chunk-time in s) of the GEMM
    kernel of ``dtype`` (in bf16, of its ``mma_sync`` body)."""
    if dtype == torch.bfloat16:
        return GEMM_BF16_BM, GEMM_BF16_BK, GEMM_BF16_CHUNK_S
    return GEMM_BM, GEMM_BK, GEMM_CHUNK_S


def gemm_ranges(k: int, n_split: int, dtype=torch.float32,
                body: str = "mma_sync") -> list:
    """The runs ``[lo, hi)`` of the ``ceil(k / bk)`` reduction chunks
    that the GEMM kernel of ``dtype`` (chunks of ``GEMM_BK`` in fp32;
    in bf16 ``GEMM_BF16_BK`` on the ``mma_sync`` body and
    ``GEMM_BF16_TMA_BK`` on the TMA bodies) deals to its splits when
    ``n_split`` are asked: split z takes the z-th run of ``ceil(chunks /
    n_split)`` (the kernel's ``c_lo`` / ``c_hi``).  Empty runs are left
    out, so the list's length is the split that covers the chunks with
    none empty."""
    bk = (GEMM_BF16_TMA_BK if dtype == torch.bfloat16 and body != "mma_sync"
          else _gemm_consts(dtype)[1])
    chunks = -(-k // bk)
    per = -(-chunks // n_split)
    return [(lo, min(chunks, lo + per)) for lo in range(0, chunks, per)]


@functools.lru_cache(maxsize=1024)
def gemm_split(m: int, n: int, k: int, sms: int,
               dtype=torch.float32) -> int:
    """Blocks over which the GEMM kernel of ``dtype`` deals out each
    output tile's reduction chunks (``gemm_ranges``), none empty and
    every one but the last at least ``GEMM_MIN_CHUNKS`` long.  It
    minimises the run's time in waves on a card with ``sms`` SMs:
    ``ceil(tiles * n_split / slots)`` waves of blocks (``slots``: ``sms``,
    or ``GEMM_BF16_RESIDENT`` blocks an SM on the bf16 mma_sync body),
    each taking its chunks plus ``GEMM_FILL_CHUNKS``, plus every split's
    fp32 partial through HBM.  So a grid that fills whole waves keeps 1, and a small
    grid with a long reduction (conv1's dw) splits until its blocks fill
    the card."""
    bm, bk, chunk_s = _gemm_consts(dtype)
    tiles = -(-m // bm) * -(-n // gemm_bn(n, dtype))
    slots = sms * (GEMM_BF16_RESIDENT if dtype == torch.bfloat16 else 1)
    chunks = -(-k // bk)
    partial = 8.0 * m * n / HBM_RATE / chunk_s
    best, best_cost = 1, None
    for want in range(1, min(chunks // GEMM_MIN_CHUNKS,
                             -(-4 * sms // tiles)) + 1):
        runs = gemm_ranges(k, want, dtype)
        split, per = len(runs), runs[0][1]
        cost = (-(-tiles * split // slots) * (per + GEMM_FILL_CHUNKS)
                + (split > 1) * split * partial)
        if best_cost is None or cost < best_cost:
            best, best_cost = split, cost
    return best


def gemm_widths_bf16(m: int, swap: bool, trans_b: bool) -> list:
    """The tile widths a TMA body takes: on the wgmma body every one of
    ``GEMM_BF16_BNS`` that is a multiple of 64 (an MN-major w comes in
    panels of 64 columns), any where w is read transposed (K-major); on
    the swap_ab body the narrowest of ``GEMM_BF16_SWAP_BNS`` that holds M
    (the widest for a larger M)."""
    if swap:
        return [min([w for w in GEMM_BF16_SWAP_BNS if w >= m]
                    or [GEMM_BF16_SWAP_BNS[-1]])]
    return [w for w in GEMM_BF16_BNS if trans_b or w % 64 == 0]


@functools.lru_cache(maxsize=1024)
def gemm_tiles_bf16(m: int, n: int, k: int, swap: bool, trans_b: bool,
                    sms: int) -> tuple:
    """(bn, n_split) for a TMA body of the bf16 GEMM (``swap``: the
    swap_ab body) on an (m, k) @ (k, n) product, w stored transposed where
    ``trans_b``, and a card with ``sms`` SMs: the tile width (one of
    ``gemm_widths_bf16``) and the units over
    which each tile's reduction chunks are dealt out (``gemm_ranges``).
    It minimises the run's time in the model above: the busiest SM's units
    (``ceil(units / sms)`` of them), each taking its chunks plus
    ``GEMM_BF16_FILL_CHUNKS``, plus, for a split, the sum kernel and
    every split's fp32 partial through HBM.  Ties go to the wider tile and
    to fewer splits."""
    body = "swap_ab" if swap else "wgmma"
    rows, cols = (n, m) if swap else (m, n)
    table = GEMM_BF16_SWAP_CHUNK_US if swap else GEMM_BF16_CHUNK_US
    chunks = -(-k // GEMM_BF16_TMA_BK)
    partial_us = 8.0 * m * n / HBM_RATE * 1e6
    best, best_cost = None, None
    for bn in sorted(gemm_widths_bf16(m, swap, trans_b), reverse=True):
        tiles = -(-rows // GEMM_BF16_TMA_BM) * -(-cols // bn)
        for want in range(1, max(1, min(chunks // GEMM_BF16_MIN_CHUNKS,
                                        -(-4 * sms // tiles))) + 1):
            runs = gemm_ranges(k, want, torch.bfloat16, body)
            split, per = len(runs), runs[0][1]
            waves = -(-tiles * split // sms)
            cost = (waves * (per + GEMM_BF16_FILL_CHUNKS) * table[bn]
                    + (split > 1) * (GEMM_BF16_SUM_US + split * partial_us))
            if best_cost is None or cost < best_cost - 1e-9:
                best, best_cost = (bn, split), cost
    return best


def gemm_plan_bf16(m: int, n: int, k: int, trans_a: bool, trans_b: bool,
                   aligned_a: bool, aligned_b: bool, sms: int, body=None,
                   tiles=None) -> tuple:
    """(body, bn, n_split) of a bf16 launch on an (m, k) @ (k, n) product,
    x stored transposed where ``trans_a``, w where ``trans_b``;
    ``aligned_*``: the operand's base is 16-byte aligned and its rows a
    multiple of 8 values apart, so TMA can map it.  The body: ``wgmma``
    where TMA maps both operands and N % 8 == 0 (whole 16-byte output
    pieces), ``swap_ab`` there at M <= ``GEMM_BF16_SWAP_MAX_M`` with x not
    transposed, ``mma_sync`` elsewhere; or ``body`` when given (a TMA body
    raises where it cannot take the operands).  Then the tile width and
    split of that body's rule (``gemm_tiles_bf16``, or ``gemm_split`` for
    ``mma_sync``), or of ``tiles`` = (bn, n_split) over that body's runs.
    ``_matmul`` names the body to the entry point, which runs it or
    refuses it and never picks another."""
    tma = aligned_a and aligned_b and n % 8 == 0
    swap = m <= GEMM_BF16_SWAP_MAX_M and not trans_a
    if body is None:
        body = "mma_sync" if not tma else "swap_ab" if swap else "wgmma"
    elif body not in GEMM_BF16_BODIES:
        raise ValueError(f"body must be one of {tuple(GEMM_BF16_BODIES)}, "
                         f"got {body!r}")
    elif body != "mma_sync" and not tma:
        raise ValueError(f"the {body} body needs operands TMA can map "
                         "(16-byte aligned, rows a multiple of 8 values "
                         "apart) and N % 8 == 0")
    elif body == "swap_ab" and trans_a:
        raise ValueError("the swap_ab body reads x in its (M, K) storage "
                         "only")
    if tiles is not None:
        if tiles[0] not in ([GEMM_BF16_BN] if body == "mma_sync" else
                            gemm_widths_bf16(m, body == "swap_ab",
                                             trans_b)):
            raise ValueError(f"the {body} body does not take width "
                             f"{tiles[0]} here")
        return body, tiles[0], len(gemm_ranges(k, tiles[1], torch.bfloat16,
                                               body))
    if body == "mma_sync":
        return body, GEMM_BF16_BN, gemm_split(m, n, k, sms, torch.bfloat16)
    return (body,) + gemm_tiles_bf16(m, n, k, body == "swap_ab",
                                     bool(trans_b), sms)


def _aligned(t: torch.Tensor, trans: int) -> bool:
    """Whether TMA can map the storage of ``t`` (read in place, ``trans``
    as ``_layout`` says): a 16-byte aligned base, rows a multiple of 8
    values apart."""
    pitch = t.shape[0] if trans else t.shape[1]
    return t.data_ptr() % 16 == 0 and pitch % 8 == 0


def _matmul(x, w, b, relu, backend, n_split=None, body=None, bn=None):
    """One product: the kernel launch of the operands' dtype, or the
    plain version.  The fp32 kernel splits the reduction as
    ``gemm_split`` picks, or over the runs of ``gemm_ranges(K, n_split)``
    when ``n_split`` is given; bf16 operands run the body, width and split
    ``gemm_plan_bf16`` picks, or ``body`` (``"wgmma"``, ``"swap_ab"`` or
    ``"mma_sync"``), ``bn`` and ``n_split`` where given (kernel_sweep.py
    and chip_smoke.py time the choices)."""
    for name, t in (("w", w), ("b", b)):
        if t is not None and t.dtype != x.dtype:
            raise ValueError(f"matmul_bias: {name} is {t.dtype}, x is "
                             f"{x.dtype}; the operands share one dtype")
    if common.route(backend, x) == "plain":
        return conv_ref.matmul_bias_ref(x, w, b, relu)
    dtypes = tuple(_MATMUL_ENTRIES)
    m, k = x.shape
    n = w.shape[1]
    trans_a = _layout("x", x, dtypes)
    trans_b = _layout("w", w, dtypes)
    if b is not None:
        common.check_operand("b", b, 1, dtypes)
    if n > 65535 * 64:
        raise ValueError(f"N = {n} exceeds the kernel's grid")
    y = torch.empty((m, n), device=x.device, dtype=x.dtype)
    common.check_operand("y", y, 2, dtypes)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if x.dtype == torch.bfloat16:
        shape = (m, n, k, trans_a, trans_b, _aligned(x, trans_a),
                 _aligned(w, trans_b), sms)
        rule = gemm_plan_bf16(*shape, body)
        body = rule[0]
        if bn is not None or n_split is not None:
            rule = gemm_plan_bf16(*shape, body, (bn or rule[1],
                                                 n_split or rule[2]))
        _, bn, n_split = rule
        extra = (bn, n_split, GEMM_BF16_BODIES[body])
    elif body is not None or bn is not None:
        raise ValueError("body and bn apply to bf16 operands only")
    else:
        n_split = (gemm_split(m, n, k, sms) if n_split is None
                   else len(gemm_ranges(k, n_split)))
        extra = (n_split,)
    part = None
    if n_split > 1:
        part = torch.empty((n_split, m, n), device=x.device,
                           dtype=torch.float32)
        common.check_operand("part", part, 3)
    entry, counter, argtypes = _MATMUL_ENTRIES[x.dtype]
    fn = _build.function(entry, argtypes)
    err = fn(x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
             y.data_ptr(), None if part is None else part.data_ptr(), m, n,
             k, trans_a, trans_b, int(relu), *extra,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error(entry, err)
    setattr(matmul_bias, counter, getattr(matmul_bias, counter) + 1)
    if body in ("wgmma", "swap_ab"):
        matmul_bias.launches_bf16_wgmma += 1
    return y


class _MatmulBias(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, relu, backend):
        y = _matmul(x, w, b, relu, backend)
        ctx.save_for_backward(x, w, y)
        ctx.conf = (relu, backend)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, y = ctx.saved_tensors
        relu, backend = ctx.conf
        if relu:
            dy = dy * (y > 0).to(dy.dtype)
        dy = dy.contiguous()
        db = dy.sum(0) if ctx.needs_input_grad[2] else None
        # the same kernel on permuted operands, transposes read in place,
        # in the cotangent's dtype (y's), cast to the operands' as the
        # reference's _matmul_bias_bwd does
        dx = (_matmul(dy, w.t(), None, False, backend).to(x.dtype)
              if ctx.needs_input_grad[0] else None)
        dw = (_matmul(x.t(), dy, None, False, backend).to(w.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw, db, None, None


def matmul_bias(x, w, b=None, *, relu: bool = False, backend: str = "auto"):
    """(M,K) @ (K,N) + b(N,) -> (M,N) in x's dtype (fp32 or bf16, shared
    by w and b) with the bias add and optional ReLU fused, accumulated in
    fp32.  ``x`` and ``w`` may be transposed views of contiguous
    matrices.  Differentiable."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} @ {tuple(w.shape)} do "
                         "not chain")
    if x.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"empty output {x.shape[0]} x {w.shape[1]}")
    if b is not None and tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"b has shape {tuple(b.shape)}, expected "
                         f"({w.shape[1]},)")
    return _MatmulBias.apply(x, w, b, relu, backend)


matmul_bias.launches = 0
matmul_bias.launches_bf16 = 0
matmul_bias.launches_bf16_wgmma = 0


# ------------------------------------------------ two-stage im2col -------

def im2col(x, kernel: int, stride: int, padding: int):
    """x (B,H,W,C) -> patches (B, OH, OW, C*K*K), channel-major features
    (c*K*K + kh*K + kw), the layout of the reference's
    ``conv_general_dilated_patches``."""
    b_, h, wd, _ = x.shape
    oh = (h + 2 * padding - kernel) // stride + 1
    ow = (wd + 2 * padding - kernel) // stride + 1
    cols = F.unfold(x.permute(0, 3, 1, 2), kernel, padding=padding,
                    stride=stride)                      # (B, C*K*K, L)
    return cols.transpose(1, 2).reshape(b_, oh, ow, -1)


def reorder_weights(w, groups: int = 1):
    """(K,K,Cin/G,Cout) -> (Cin*K*K, Cout) rows in the patches'
    channel-major order; a grouped conv embeds as the block-diagonal
    matrix, so one GEMM runs every group.  Recomputed per call (a cheap
    reshape of the weights) so autograd sees the live weight."""
    wm = w.permute(2, 0, 1, 3).reshape(-1, w.shape[-1])
    if groups == 1:
        return wm
    npg = w.shape[-1] // groups
    return torch.block_diag(*[wm[:, g * npg:(g + 1) * npg]
                              for g in range(groups)])


def conv2d_im2col(x, w, *, stride: int, padding: int, bias=None,
                  relu: bool = False, groups: int = 1,
                  backend: str = "auto"):
    """Two-stage conv: ``F.unfold`` patches, then ``matmul_bias`` against
    the reordered weights.  x (B,H,W,Cin), w (K,K,Cin/G,Cout) ->
    (B,OH,OW,Cout) in x's dtype (fp32 or bf16, shared by w and the
    bias).  Differentiable."""
    k, _, wcin, cout = w.shape
    if wcin * groups != x.shape[-1]:
        raise ValueError(f"w in-channels {wcin} x groups {groups} != "
                         f"x channels {x.shape[-1]}")
    if cout % groups:
        raise ValueError(f"cout {cout} not divisible by groups {groups}")
    patches = im2col(x, k, stride, padding)
    b_, oh, ow, feat = patches.shape
    y = matmul_bias(patches.reshape(b_ * oh * ow, feat),
                    reorder_weights(w, groups), bias, relu=relu,
                    backend=backend)
    return y.reshape(b_, oh, ow, cout)
