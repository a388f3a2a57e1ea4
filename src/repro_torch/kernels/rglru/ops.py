"""RG-LRU dispatch: the CUDA kernel (``csrc/rglru.cu``) or its plain
version (``ref``), differentiable.

``rglru_scan(a, b, *, backend)`` takes fp32 a, b (B,T,D) and returns h
(B,T,D) fp32 from a zero state, as the reference's ``rglru_pallas``.  It
is the ``RGLRU`` ``torch.autograd.Function``: its forward is
``rglru_fwd``, the kernel on CUDA tensors and the plain loop on CPU
tensors (``backend="plain"`` asks for the plain version on any device).
The cotangent of a linear recurrence is the same recurrence run
backwards (``g_t = dh_t + a_{t+1} g_{t+1}``), as the reference's
backward calls its Pallas kernel again
(``repro/kernels/rglru/rglru.py:98-111``); then ``db = g`` and
``da_t = g_t h_{t-1}``.  The backward is one entry on both routes,
``rglru_transpose_grads``: the kernel's reversed launch, which takes h
and writes g and da in one pass, or ``ref.rglru_transpose_grads``.
``rglru_fwd.launches`` counts one launch per direction.

The kernel is chunk-parallel over T: blocks of RGLRU_TILE channels x
``rglru_chunk`` steps, chained in a fixed order through a ticket, flags
and carried states that the wrapper allocates per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, common
from repro_torch.kernels.rglru import ref

RGLRU_TILE = 32                  # channels per block (TILE in csrc/rglru.cu)
RGLRU_CHUNKS = (64, 128, 256)    # the chunks the kernel is built for
# the rule's aim: one wave of the two blocks an SM holds (about 100
# registers a thread, 256 threads) at the least, else shorter chunks
RGLRU_BLOCKS_PER_SM = 2
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


def _check_shapes(a, b):
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"a, b must be one (B,T,D) shape, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")


def rglru_chunk(t: int, n_rows: int, sms: int) -> int:
    """Steps per chunk of the RG-LRU kernel for T = ``t`` and ``n_rows``
    (batch x channels) recurrences on a card with ``sms`` SMs: the
    longest chunk of RGLRU_CHUNKS whose blocks (RGLRU_TILE channels x a
    chunk) still number RGLRU_BLOCKS_PER_SM per SM, else the shortest.
    Longer chunks chain fewer links and carry fewer states; shorter ones
    fill the card.  Pure: no device sync."""
    tiles = -(-n_rows // RGLRU_TILE)
    want = RGLRU_BLOCKS_PER_SM * sms
    for chunk in sorted(RGLRU_CHUNKS, reverse=True):
        if tiles * -(-t // chunk) >= want:
            return chunk
    return min(RGLRU_CHUNKS)


def rglru_grid(b: int, t: int, d: int, chunk: int) -> tuple:
    """(tiles, chunks) of one launch: B * ceil(D / RGLRU_TILE) channel
    tiles and ceil(T / chunk) chunks, one block each."""
    return b * -(-d // RGLRU_TILE), -(-t // chunk)


def rglru_fwd(a, b, *, reverse: bool = False, backend: str = "auto"):
    """h (B,T,D) fp32 with h_t = a_t h_{t-1} + b_t from zero, or with
    ``reverse`` g_t = b_t + a_{t+1} g_{t+1} from the end: the kernel, or
    the plain loop.  The kernel takes fp32 a and b."""
    _check_shapes(a, b)
    if common.route(backend, a) == "plain":
        return ref.rglru_transpose(a, b) if reverse else \
            ref.rglru_sequential(a, b)[0]
    return _launch(a, b, reverse=reverse)[0]


def rglru_transpose_grads(a, dh, h, *, backend: str = "auto"):
    """(g, da) of the recurrence's backward: g = db (``rglru_fwd`` with
    ``reverse`` on dh) and da_t = g_t h_{t-1}: one reversed launch of the
    kernel, or ``ref.rglru_transpose_grads``."""
    _check_shapes(a, dh)
    _check_shapes(a, h)
    if common.route(backend, a) == "plain":
        return ref.rglru_transpose_grads(a, dh, h)
    return _launch(a, dh, reverse=True, h=h)


def _launch(a, b, *, reverse, h=None, chunk=None):
    """One launch of the kernel: (out, da or None).  ``chunk`` (one of
    RGLRU_CHUNKS) overrides ``rglru_chunk`` (kernel_sweep.py times the
    choices)."""
    common.check_operand("a", a, 3)
    common.check_operand("b", b, 3)
    if h is not None:
        common.check_operand("h", h, 3)
    bsz, t, d = a.shape
    out = torch.empty_like(a)
    da = None if h is None else torch.empty_like(a)
    if a.numel() == 0:
        return out, da
    if chunk is None:
        sms = torch.cuda.get_device_properties(
            a.device).multi_processor_count
        chunk = rglru_chunk(t, bsz * d, sms)
    if chunk not in RGLRU_CHUNKS:
        raise ValueError(f"chunk must be one of {RGLRU_CHUNKS}, got {chunk}")
    tiles, chunks = rglru_grid(bsz, t, d, chunk)
    sync = torch.zeros(1 + tiles * chunks, device=a.device,
                       dtype=torch.int32)
    carry = torch.empty(tiles * chunks * RGLRU_TILE, device=a.device,
                        dtype=torch.float32)
    err = _build.function("rglru_fwd", _ARGTYPES)(
        a.data_ptr(), b.data_ptr(), None if h is None else h.data_ptr(),
        out.data_ptr(), None if da is None else da.data_ptr(),
        carry.data_ptr(), sync.data_ptr(), bsz, t, d, chunk, int(reverse),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise _build.launch_error("rglru_fwd", err)
    rglru_fwd.launches += 1
    return out, da


rglru_fwd.launches = 0


class RGLRU(torch.autograd.Function):
    """``h_t = a_t h_{t-1} + b_t``: ``rglru_fwd`` forward,
    ``rglru_transpose_grads`` (the reversed launch) in the backward."""

    @staticmethod
    def forward(ctx, a, b, backend):
        h = rglru_fwd(a, b, backend=backend)
        ctx.save_for_backward(a, h)
        ctx.backend = backend
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        g, da = rglru_transpose_grads(a, dh.float().contiguous(), h,
                                      backend=ctx.backend)
        return da, g, None


def rglru_scan(a, b, *, backend: str = "auto"):
    """a, b (B,T,D) fp32 -> h (B,T,D) fp32.  Differentiable in a and b."""
    return RGLRU.apply(a.float().contiguous(), b.float().contiguous(),
                       backend)
