"""Decode-attention dispatch: the CUDA kernels (``csrc/decode_attention.cu``)
or their plain version (``ref``).

``decode_attention(q, k, v, pos, ...)`` takes the model layout, the
counterpart of the reference's ``ops.decode_attention``: q (B,Hkv,G,hd)
one token per row; k, v (B,cap,Hkv,hd) ring caches or, with ``table``
(B, cap/bs) int32, (NB,bs,Hkv,hd) block pools; pos (B,) int32; int8
caches carry fp32 ``k_scale`` / ``v_scale`` of the cache's leading three
dims.  Under ``backend="auto"`` a CUDA tensor launches ``decode_ring`` or
``decode_table``, which read the cache and the pool in place (no fold,
transpose or padding of the cache); a CPU tensor runs the plain version,
which gathers the pool through the table.  ``backend="plain"`` asks for
the plain version on any device.  Inference only: nothing here is
differentiable.

``decode_ring`` and ``decode_table`` are the kernel wrappers; each counts
its launches in ``.launches``.  Both kernels deal each row's slots out
over several blocks (split-KV) in chunks of ``decode_chunk`` slots, whose
fp32 partials a second kernel folds in split order (one launch all the
same).  On the ring, a group of more than 8 query heads with bf16 q and
bf16 or int8 K/V runs the kernel's tensor-core body (``tensor_core_ring``):
blocks of MMA_HEADS heads that stage MMA_TILE slots at a time.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.decode_attention import ref

HEAD_DIMS = (64, 128, 256)
MAX_BLOCKS = 8192        # block ids per row the table kernel stages (32 KB)
# decode_chunk's aim: blocks per SM (two waves of the two blocks of 512
# threads an SM holds), and the fewest slots a split takes.
DECODE_BLOCKS_PER_SM = 4
DECODE_MIN_CHUNK = 64
# and the fewest steps of its warps a split takes: a block's fixed cost (q,
# the warps' merge, the partial) outweighs fewer
DECODE_MIN_STEPS = 4
# the ring kernel's tensor-core body (decode_mma_kernel): query heads a
# block holds (MMA_M), slots a stage holds (MMA_TILE), and the fewest
# stages a split takes
MMA_HEADS = 16
MMA_TILE = 32
DECODE_MMA_MIN_TILES = 2
Q_TYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int
_RING_ARGTYPES = [_P] * 8 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _P]
_TABLE_ARGTYPES = [_P] * 9 + [_I] * 7 + [ctypes.c_float, _I, _I, _I, _P]


def _check_shapes(q, k, v, pos, k_scale, v_scale, table):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be (B,Hkv,G,hd) and k, v 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hkv, _, hd = q.shape
    if k.shape != v.shape or k.shape[2:] != (hkv, hd):
        raise ValueError(f"k, v must be (.., .., {hkv}, {hd}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if table is None and k.shape[0] != b:
        raise ValueError(f"a ring cache has one row per query row: "
                         f"k {tuple(k.shape)} for q {tuple(q.shape)}")
    if table is not None and (table.dim() != 2 or table.shape[0] != b):
        raise ValueError(f"table must be (B, cap/bs) = ({b}, ..), got "
                         f"{tuple(table.shape)}")
    if tuple(pos.shape) != (b,):
        raise ValueError(f"pos must be ({b},), got {tuple(pos.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache needs both k_scale and v_scale")
    if k_scale is not None and (k_scale.shape != k.shape[:3]
                                or v_scale.shape != k.shape[:3]):
        raise ValueError(f"scales must be {tuple(k.shape[:3])}, got "
                         f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")


def _check_cuda(q, k, v, pos, k_scale, v_scale, table):
    """What the kernels take: contiguous CUDA tensors, q fp32 or bf16, k
    and v of one type (fp32, bf16, or int8 with fp32 scales), int32 pos
    and table, hd 64, 128 or 256, and 32-byte aligned rows."""
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the decode kernels take head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    common.check_operand("q", q, 4, tuple(Q_TYPES))
    common.check_operand("k", k, 4, tuple(KV_TYPES))
    common.check_operand("v", v, 4, (k.dtype,))
    common.check_operand("pos", pos, 1, (torch.int32,))
    if table is not None:
        common.check_operand("table", table, 2, (torch.int32,))
        if table.shape[1] > MAX_BLOCKS:
            raise ValueError(f"the table kernel stages at most {MAX_BLOCKS} "
                             f"block ids per row, got {table.shape[1]}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None):
        raise ValueError("k_scale / v_scale go with an int8 cache, and only "
                         f"with one (k is {k.dtype})")
    if quant:
        common.check_operand("k_scale", k_scale, 3)
        common.check_operand("v_scale", v_scale, 3)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must start on a 32-byte boundary")
    return Q_TYPES[q.dtype], KV_TYPES[k.dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _call(name, argtypes, *args):
    err = _build.function(name, argtypes)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error(name, err)


def _window(window):
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    return -1 if window is None else int(window)


def tensor_core_ring(g: int, q_dtype, kv_dtype) -> bool:
    """Whether the ring kernel runs its tensor-core body for a group of
    ``g`` query heads, q of ``q_dtype`` and K/V of ``kv_dtype`` (``by_group``
    in the kernel source): G > 8, bf16 q, bf16 or int8 K/V."""
    return g > 8 and q_dtype == torch.bfloat16 and \
        kv_dtype in (torch.bfloat16, torch.int8)


def group_tile(g: int) -> int:
    """Query heads a block of the decode kernels holds for a group of
    ``g``: 1, 2, 4 or 8 (``by_group`` in the kernel source)."""
    return next(t for t in (1, 2, 4, 8) if g <= t or t == 8)


def warp_step(hd: int, kv_bytes: int, g: int) -> int:
    """Slots the decode kernels' warps take in one step for head_dim ``hd``,
    K/V of ``kv_bytes`` bytes an element and a group of ``g``: warps x
    unroll of the kernel's ``Shape`` (about 2 KB of K and V per warp, at
    most 32 scores a thread)."""
    gt = group_tile(g)
    warps = 8 if gt * hd // 32 >= 32 else 16
    unroll = min(2048 // (2 * hd * kv_bytes), 32 // gt)
    return warps * max(2, min(16, unroll))


def decode_chunks(cap: int, chunk: int) -> list:
    """The slot runs ``[lo, hi)`` of ``[0, cap)`` that the kernels' splits
    take for ``chunk`` slots each (the kernel's ``lo`` / ``hi`` before the
    row's valid slots cut them), the last one short."""
    return [(lo, min(cap, lo + chunk)) for lo in range(0, cap, chunk)]


@functools.lru_cache(maxsize=1024)
def decode_chunk(cap: int, unit: int, rows: int, sms: int,
                 least: int = DECODE_MIN_CHUNK) -> int:
    """Slots per block of a decode kernel over ``cap`` slots, for ``rows``
    blocks per split (B x Hkv x query-head tiles) on a card with ``sms``
    SMs: the largest chunk of unit * 2^j slots, at least ``least``, whose
    splits (``decode_chunks``) give ``DECODE_BLOCKS_PER_SM`` blocks per
    SM.  ``unit`` is bs for the table, so a chunk's block ids are one run
    of the table, and the ring's ``warp_step``, so a chunk is whole steps
    of the kernel's warps.  Pure: it reads no ``pos``, so choosing it
    costs no device sync; on the card a split past a row's visible slots
    exits at once."""
    chunk = unit
    while chunk < least:
        chunk *= 2
    want = DECODE_BLOCKS_PER_SM * sms
    while chunk < cap and rows * -(-cap // (2 * chunk)) >= want:
        chunk *= 2
    return min(chunk, cap)


def kernel_chunk(q, k, table, sms: int) -> int:
    """``decode_chunk`` for the kernel that takes q (B,Hkv,G,hd) and the
    cache ``k``: the table's (``table`` given, k a pool) or the ring's,
    at least DECODE_MIN_STEPS steps of the kernel's warps; for the ring's
    tensor-core body whole stages of MMA_TILE slots, at least
    DECODE_MMA_MIN_TILES of them."""
    b, hkv, g, hd = q.shape
    if table is None and tensor_core_ring(g, q.dtype, k.dtype):
        rows = b * hkv * -(-g // MMA_HEADS)
        return decode_chunk(k.shape[1], MMA_TILE, rows, sms,
                            max(DECODE_MIN_CHUNK,
                                DECODE_MMA_MIN_TILES * MMA_TILE))
    rows = b * hkv * -(-g // group_tile(g))
    step = warp_step(hd, k.element_size(), g)
    least = max(DECODE_MIN_CHUNK, DECODE_MIN_STEPS * step)
    if table is not None:
        bs = k.shape[1]
        return decode_chunk(table.shape[1] * bs, bs, rows, sms, least)
    return decode_chunk(k.shape[1], step, rows, sms, least)


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def _part(q, n_split):
    """The fp32 partials of ``n_split`` splits per (row, KV head): acc,
    then m and l (``run`` in the kernel source); none for one split."""
    if n_split == 1:
        return None
    b, hkv, g, hd = q.shape
    return torch.empty((b * hkv * n_split * g * (hd + 2),),
                       device=q.device, dtype=torch.float32)


def decode_ring(q, k, v, pos, *, window=None, scale=1.0, k_scale=None,
                v_scale=None, backend: str = "auto"):
    """o (B,Hkv,G,hd) in q's dtype against the ring k, v (B,cap,Hkv,hd):
    the ring kernel, or its plain version."""
    _check_shapes(q, k, v, pos, k_scale, v_scale, None)
    if common.route(backend, q) == "plain":
        return ref.decode_attention_ref(q, k, v, pos, window=window,
                                        scale=scale, k_scale=k_scale,
                                        v_scale=v_scale)
    return _ring(q, k, v, pos, window, scale, k_scale, v_scale)


def _ring(q, k, v, pos, window, scale, k_scale, v_scale, chunk=None):
    """One launch of the ring kernel, its slots split in chunks of
    ``kernel_chunk``'s size, or of ``chunk`` slots when given
    (kernel_sweep.py times the choices)."""
    qt, kvt = _check_cuda(q, k, v, pos, k_scale, v_scale, None)
    b, hkv, g, hd = q.shape
    cap = k.shape[1]
    if chunk is None:
        chunk = kernel_chunk(q, k, None, _sms(q))
    o = torch.empty_like(q)
    part = _part(q, len(decode_chunks(cap, chunk)))
    _call("decode_ring", _RING_ARGTYPES, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), _ptr(k_scale), _ptr(v_scale), pos.data_ptr(),
          o.data_ptr(), _ptr(part), b, hkv, g, cap, hd, _window(window),
          float(scale), chunk, qt, kvt)
    decode_ring.launches += 1
    return o


def decode_table(q, k, v, pos, table, *, window=None, scale=1.0,
                 k_scale=None, v_scale=None, backend: str = "auto"):
    """o (B,Hkv,G,hd) in q's dtype against the pools k, v (NB,bs,Hkv,hd)
    read through ``table`` (B, cap/bs): the table kernel, or its plain
    version."""
    _check_shapes(q, k, v, pos, k_scale, v_scale, table)
    if common.route(backend, q) == "plain":
        return ref.decode_attention_table_ref(
            q, k, v, pos, table, window=window, scale=scale,
            k_scale=k_scale, v_scale=v_scale)
    return _table(q, k, v, pos, table, window, scale, k_scale, v_scale)


def _table(q, k, v, pos, table, window, scale, k_scale, v_scale,
           chunk=None):
    """One launch of the table kernel, its slots split in chunks of
    ``kernel_chunk``'s size, or of ``chunk`` slots (a multiple of bs) when
    given (kernel_sweep.py times the choices)."""
    qt, kvt = _check_cuda(q, k, v, pos, k_scale, v_scale, table)
    b, hkv, g, hd = q.shape
    bs = k.shape[1]
    cap = table.shape[1] * bs
    if chunk is None:
        chunk = kernel_chunk(q, k, table, _sms(q))
    o = torch.empty_like(q)
    part = _part(q, len(decode_chunks(cap, chunk)))
    _call("decode_table", _TABLE_ARGTYPES, q.data_ptr(), k.data_ptr(),
          v.data_ptr(), _ptr(k_scale), _ptr(v_scale), pos.data_ptr(),
          table.data_ptr(), o.data_ptr(), _ptr(part), b, hkv, g,
          table.shape[1], bs, hd, _window(window), float(scale), chunk, qt,
          kvt)
    decode_table.launches += 1
    return o


decode_ring.launches = 0
decode_table.launches = 0


def decode_attention(q, k, v, pos, *, window=None, scale=1.0, k_scale=None,
                     v_scale=None, table=None, backend: str = "auto"):
    """q (B,Hkv,G,hd); k, v (B,cap,Hkv,hd) ring caches, or with ``table``
    (NB,bs,Hkv,hd) pools; pos (B,) int32 -> (B,Hkv,G,hd) in q's dtype."""
    kw = dict(window=window, scale=scale, k_scale=k_scale, v_scale=v_scale,
              backend=backend)
    if table is None:
        return decode_ring(q, k, v, pos, **kw)
    return decode_table(q, k, v, pos, table, **kw)
