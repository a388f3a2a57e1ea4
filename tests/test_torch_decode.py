"""The port's decode attention and LM decode surface against the
reference's, and the flash-decode CUDA kernels against their plain
version.

On the CPU the port runs the plain version (``kernels.decode_attention
.ref``); the reference runs its Pallas kernels in interpret mode
(``decode_attention_pallas(..., interpret=True)``) and its
``decode_attention_ref``.  The model tests run the reference's
``models.prefill`` / ``decode_step`` (XLA attention) and the port's on
the same weights (``weights.lm_from_reference``) and tokens, fp32,
reduced configs.  Tests marked ``cuda`` hold each kernel against its
plain version on the card.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import models, weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import ops, ref
from repro_torch.models import attention
from repro_torch.numerics import NumericsPolicy, kv_cache_spec

try:
    import jax
    import jax.numpy as jnp

    from repro import models as jax_models
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.kernels.decode_attention import ops as jax_ops
    from repro.kernels.decode_attention import ref as jax_ref
    from repro.kernels.decode_attention.decode_attention import (
        decode_attention_pallas)
    from repro.models import attention as jax_attention
    from repro.numerics import NumericsPolicy as JaxNumerics
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

TOL = 2e-4               # the registry tolerance (decode_attention/ops.py:69)
MODEL_TOL = 1e-4
# A bf16 or int8 cache rounds each side's fp32 K/V, which differ by ~1e-6
# across the packages, onto the storage grid: the few values within 1e-6 of
# a rounding midpoint land one storage step apart (one bf16 ulp, rtol 2^-7
# beside MODEL_TOL; one int8 step) and move the logits by that step's
# weight in the softmax (up to ~2e-3 after 6 int8 steps on these inputs).
# Everything else is held at MODEL_TOL.
BF16_ULP = 2.0 ** -7
QUANT_LOGIT_TOL = 5e-3
QUANT_FLIP_SHARE = 2e-3  # of a leaf's entries at most this share may differ


def _qkv(b, cap, hkv, g, hd, seed=0, int8=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    if int8:
        k, v = (rng.integers(-127, 128, size=(b, cap, hkv, hd)).astype(
            np.int8) for _ in range(2))
        ks, vs = ((rng.random(size=(b, cap, hkv)) * 0.05 + 1e-3).astype(
            np.float32) for _ in range(2))
        return q, k, v, ks, vs
    k, v = (rng.normal(size=(b, cap, hkv, hd)).astype(np.float32)
            for _ in range(2))
    return q, k, v, None, None


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


# --------------------------------------------------------------- kernels --

REF_CASES = [  # (b, cap, hkv, g, hd, window, pos): the reference's cases
    (2, 64, 2, 2, 32, None, [0, 63]),       # first token + exactly full
    (2, 64, 1, 4, 32, None, [5, 200]),      # mid-fill + wrapped (GQA 4)
    (1, 40, 2, 1, 32, None, [39]),          # odd capacity
    (2, 16, 2, 2, 64, 16, [7, 100]),        # SWA ring at window capacity
    (1, 48, 4, 2, 32, 32, [45]),            # window < capacity
]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", REF_CASES, ids=str)
def test_plain_matches_reference(case, int8):
    """The port's plain version against the reference's Pallas kernel
    (interpret mode) and its ``decode_attention_ref``."""
    b, cap, hkv, g, hd, window, pos = case
    q, k, v, ks, vs = _qkv(b, cap, hkv, g, hd, seed=cap + hd, int8=int8)
    pos = np.asarray(pos, np.int32)
    kw = dict(window=window, scale=hd ** -0.5)
    got = ops.decode_attention(*map(_t, (q, k, v, pos)), k_scale=_t(ks),
                               v_scale=_t(vs), **kw).numpy()
    want = decode_attention_pallas(*map(_j, (q, k, v, pos)), k_scale=_j(ks),
                                   v_scale=_j(vs), interpret=True, **kw)
    want_ref = jax_ref.decode_attention_ref(*map(_j, (q, k, v, pos)),
                                            k_scale=_j(ks), v_scale=_j(vs),
                                            **kw)
    for w in (want, want_ref):
        np.testing.assert_allclose(got, np.asarray(w), rtol=TOL, atol=TOL)


# rows 0 and 1 share their first two blocks, row 2 is retired (all trash)
TABLE = np.asarray([[1, 2, 3, 4], [1, 2, 5, 6], [0, 0, 0, 0]], np.int32)


@pytest.mark.parametrize("window", [None, 12])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_table_plain_matches_reference(int8, window):
    """The block-pool form: a (B, cap/bs) table over a (NB, bs, ...) pool
    with shared blocks and the trash block."""
    bs, hkv, g, hd = 8, 2, 2, 32
    q, k, v, ks, vs = _qkv(7, bs, hkv, g, hd, seed=5, int8=int8)
    q = q[:3]
    pos = np.asarray([20, 31, 5], np.int32)
    kw = dict(window=window, scale=hd ** -0.5)
    got = ops.decode_attention(*map(_t, (q, k, v, pos)), table=_t(TABLE),
                               k_scale=_t(ks), v_scale=_t(vs), **kw).numpy()
    want = decode_attention_pallas(*map(_j, (q, k, v, pos)),
                                   table=_j(TABLE), k_scale=_j(ks),
                                   v_scale=_j(vs), interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    # the gather the plain version does is the pool read through the table
    ring = ref.gather_pool(_t(k), _t(TABLE))
    assert torch.equal(ring[1, 8:16], _t(k)[2])
    assert torch.equal(ring[2, 24:32], _t(k)[0])


def test_slot_positions_use_floor_mod():
    """Ring slot i holds pos - ((pos - i) mod W): an unwritten slot
    (i > pos before the ring wraps) holds a negative position."""
    sp = ref.slot_positions(torch.tensor([2, 7]), 4)
    assert sp.tolist() == [[0, 1, 2, -1], [4, 5, 6, 7]]
    want = jax_ref.slot_positions(jnp.asarray([2, 7, 0, 130]), 48)
    got = ref.slot_positions(torch.tensor([2, 7, 0, 130]), 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rows_at_different_depths_see_different_slots():
    q, k, v, _, _ = _qkv(2, 32, 2, 2, 32)
    q, k, v = map(_t, (q, k, v))
    o = ref.decode_attention_ref(q, k, v, torch.tensor([3, 30]), scale=0.2)
    lock = ref.decode_attention_ref(q, k, v, torch.tensor([3, 3]), scale=0.2)
    torch.testing.assert_close(o[0], lock[0], rtol=1e-6, atol=1e-6)
    assert (o[1] - lock[1]).abs().max() > 1e-3


def test_wrappers_check_their_inputs():
    q, k, v = torch.zeros(2, 2, 2, 64), torch.zeros(2, 8, 2, 64), \
        torch.zeros(2, 8, 2, 64)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.decode_ring(q, k, v, pos, backend="cuda")
    with pytest.raises(ValueError, match="pos must be"):
        ops.decode_ring(q, k, v, pos[:1])
    with pytest.raises(ValueError, match="k, v must be"):
        ops.decode_ring(q, k[..., :32], v[..., :32], pos)
    with pytest.raises(ValueError, match="table must be"):
        ops.decode_table(q, k, v, pos, torch.zeros(3, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        ops.decode_ring(q, k, v, pos, k_scale=torch.ones(2, 8, 2))
    # on CPU tensors the wrappers run the plain version and launch nothing
    before = (ops.decode_ring.launches, ops.decode_table.launches)
    ops.decode_ring(q, k, v, pos)
    ops.decode_table(q, k, v, pos, torch.zeros(2, 1, dtype=torch.int32))
    assert (ops.decode_ring.launches, ops.decode_table.launches) == before


@pytest.mark.parametrize("cap,bs,rows,sms", [
    (2048, 16, 128, 132),       # the serving tick: B 8 x Hkv 16
    (2048, 16, 8, 132),
    (272, 16, 2, 132),          # cap not a multiple of the chunk
    (256, 8, 48, 16),
    (96, 48, 4, 132),           # bs above DECODE_MIN_CHUNK
    (4096, 32, 4096, 132),      # the rows alone fill the card
])
def test_decode_split_covers_each_slot_once(cap, bs, rows, sms):
    """The table kernel's splits take every slot of [0, cap) exactly
    once, in chunks that are multiples of bs (so a chunk's block ids are
    one run of the table), none empty."""
    chunk = ops.decode_chunk(cap, bs, rows, sms)
    runs = ops.decode_chunks(cap, chunk)
    n_split = -(-cap // chunk)            # the kernel's n_split
    # split z's slots as decode_kernel computes them (lo, hi)
    assert runs == [(z * chunk, min(cap, (z + 1) * chunk))
                    for z in range(n_split)]
    assert chunk % bs == 0 and 1 <= n_split == len(runs)
    assert [c for lo, hi in runs for c in range(lo, hi)] == list(range(cap))


def test_decode_split_by_grid_and_card():
    """At the serving tick chunks of 256 slots for the ring (whole 64-slot
    steps of its warps) and for the table (eight splits,
    DECODE_BLOCKS_PER_SM blocks per SM); fewer splits on a card with
    fewer SMs or for more rows; at most one per DECODE_MIN_CHUNK
    slots."""
    assert ops.decode_chunk(2048, ops.warp_step(128, 2, 1), 128, 132,
                            4 * 64) == 256
    serve = ops.decode_chunk(2048, 16, 128, 132)
    assert serve == 256
    assert 128 * 2048 // serve >= ops.DECODE_BLOCKS_PER_SM * 132
    assert ops.decode_chunk(2048, 16, 128, 16) > serve
    assert ops.decode_chunk(2048, 16, 4096, 132) == 2048
    assert ops.decode_chunk(2048, 16, 1, 132) == ops.DECODE_MIN_CHUNK


RING_RULE_CASES = [  # (cap, hd, K/V bytes, G, rows, sms)
    (2048, 128, 2, 1, 128, 132),     # the serving tick: B 8 x Hkv 16
    (2048, 128, 1, 1, 128, 132),     # int8 K/V
    (2048, 128, 4, 1, 128, 132),     # fp32 K/V
    (2048, 256, 2, 16, 16, 132),     # G 16 on the SIMT body: 2 tiles
    (2048, 128, 2, 4, 64, 132),      # GQA 4
    (300, 128, 2, 1, 4, 132),        # cap not a multiple of the chunk
    (200, 64, 2, 4, 2, 16),
    (64, 128, 2, 12, 8, 132),        # one split
    (2048, 128, 2, 1, 4096, 132),    # the rows alone fill the card
]


@pytest.mark.parametrize("cap,hd,kv_bytes,g,rows,sms", RING_RULE_CASES)
def test_ring_split_covers_each_slot_once(cap, hd, kv_bytes, g, rows, sms):
    """The ring kernel's splits take every slot of [0, cap) exactly once;
    above one split their chunks are whole steps of the kernel's warps
    (``warp_step``), at least DECODE_MIN_STEPS of them and at least
    DECODE_MIN_CHUNK slots."""
    dtype = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32}[kv_bytes]
    b = rows // -(-g // ops.group_tile(g))
    q = torch.zeros((b, 1, g, hd), dtype=torch.float32)
    k = torch.zeros((b, cap, 1, hd), dtype=dtype)
    step = ops.warp_step(hd, kv_bytes, g)
    chunk = ops.kernel_chunk(q, k, None, sms)
    runs = ops.decode_chunks(cap, chunk)
    assert runs == [(z * chunk, min(cap, (z + 1) * chunk))
                    for z in range(-(-cap // chunk))]
    assert [c for lo, hi in runs for c in range(lo, hi)] == list(range(cap))
    if len(runs) > 1:
        assert chunk % step == 0
        assert chunk >= max(ops.DECODE_MIN_CHUNK,
                            ops.DECODE_MIN_STEPS * step)
    else:
        assert chunk == cap


def test_ring_split_at_the_serving_tick():
    """olmo-1b's tick (B 8, Hkv 16, G 1, hd 128, bf16 ring of 2048 slots)
    on 132 SMs: eight chunks of 256 slots, four 64-slot warp steps each;
    ``kernel_chunk`` reads it off the tensors' shapes alone."""
    q = torch.zeros((8, 16, 1, 128), dtype=torch.bfloat16)
    k = torch.zeros((8, 2048, 16, 128), dtype=torch.bfloat16)
    assert ops.warp_step(128, 2, 1) == 64
    chunk = ops.kernel_chunk(q, k, None, 132)
    assert chunk == 256 and len(ops.decode_chunks(2048, chunk)) == 8
    assert 128 * 8 >= ops.DECODE_BLOCKS_PER_SM * 132
    pool = torch.zeros((8 * 128 + 1, 16, 16, 128), dtype=torch.bfloat16)
    table = torch.zeros((8, 128), dtype=torch.int32)
    assert ops.kernel_chunk(q, pool, table, 132) == 256


def test_ring_split_at_the_hybrid_tick():
    """recurrentgemma-9b's attn layers (B 8, one KV head, G 16, hd 256,
    bf16 q, a bf16 or int8 ring of 2048 slots) on 132 SMs take the
    tensor-core body: one block per row and split, chunks of two 32-slot
    stages, 32 splits; fp32 q keeps the SIMT body's two head tiles."""
    k = torch.zeros((8, 2048, 1, 256), dtype=torch.bfloat16)
    for kv in (torch.bfloat16, torch.int8):
        q = torch.zeros((8, 1, 16, 256), dtype=torch.bfloat16)
        assert ops.tensor_core_ring(16, q.dtype, kv)
        chunk = ops.kernel_chunk(q, k.to(kv), None, 132)
        assert chunk == ops.DECODE_MMA_MIN_TILES * ops.MMA_TILE == 64
        assert len(ops.decode_chunks(2048, chunk)) == 32
    q = torch.zeros((8, 1, 16, 256), dtype=torch.float32)
    assert not ops.tensor_core_ring(16, q.dtype, k.dtype)
    assert ops.kernel_chunk(q, k, None, 132) % ops.warp_step(256, 2, 16) == 0


def _arc_cut(lo, hi, p, cap, window):
    """decode_kernel's cut of a chunk [lo, hi) to the arc of a row's
    valid slots (the nv slots ending at p mod cap), mirrored."""
    pm = p % cap
    nv = min(p + 1, cap, window if window else cap)
    first = pm - nv + 1
    if nv <= 0:
        return lo, lo
    if first >= 0:
        return max(lo, first), min(hi, pm + 1)
    if lo > pm:
        lo = max(lo, first + cap)
    if hi <= first + cap:
        hi = min(hi, pm + 1)
    return lo, hi


def _slot_valid(c, p, cap, nv):
    """decode_kernel's test of slot c: (pm - c) mod cap < nv."""
    pm = p % cap
    return pm - c + (cap if c > pm else 0) < nv


@pytest.mark.parametrize("cap", [64, 96, 100])
@pytest.mark.parametrize("window", [None, 1, 17, 40, 64, 500])
def test_ring_arc_cut_keeps_every_valid_slot(cap, window):
    """For rows mid-fill and wrapped, each chunk's cut [lo, hi) holds all
    of its valid slots (those ``ref.slot_positions`` and the window
    allow), the kernel's slot test agrees with the reference's, and a
    chunk with no valid slot is cut to nothing."""
    for p in (0, 5, cap - 1, cap, cap + 7, 3 * cap - 2, 1000):
        sp = ref.slot_positions(torch.tensor([p]), cap)[0]
        valid = sp >= 0
        if window:
            valid &= sp > p - window
        nv = min(p + 1, cap, window or cap)
        assert [_slot_valid(c, p, cap, nv) for c in range(cap)] == \
            valid.tolist()
        for chunk in (16, 32, cap):
            for lo0, hi0 in ops.decode_chunks(cap, chunk):
                lo, hi = _arc_cut(lo0, hi0, p, cap, window)
                inside = [c for c in range(lo0, hi0) if valid[c]]
                if not inside:
                    assert lo >= hi
                else:
                    assert lo0 <= lo <= min(inside) and \
                        max(inside) < hi <= hi0


def _split_merge(q, k, v, pos, chunk, *, window=None, scale=1.0,
                 k_scale=None, v_scale=None):
    """The ring kernel's split-KV in plain PyTorch: per chunk of ``chunk``
    slots below a row's visible ones, the online-softmax state (m, l,
    acc) of the valid slots of its cut (m = NEG, l = 0 where none), then
    the chunks merged in split order, as ``decode_merge`` does."""
    b, cap, hkv, hd = k.shape
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
        vf = vf * v_scale.float()[..., None]
    s = torch.einsum("bhgk,bshk->bhgs", q.float(), kf) * scale
    out = torch.zeros(q.shape, dtype=torch.float32)
    for row in range(b):
        p = int(pos[row])
        nv = min(p + 1, cap, window or cap)
        n_used = -(-min(p + 1, cap) // chunk)
        parts = []
        for z in range(n_used):
            lo, hi = _arc_cut(z * chunk, min(cap, (z + 1) * chunk), p, cap,
                              window)
            idx = [c for c in range(lo, hi) if _slot_valid(c, p, cap, nv)]
            if not idx:
                parts.append((torch.full(q.shape[1:3], ref.NEG),
                              torch.zeros(q.shape[1:3]),
                              torch.zeros(q.shape[1:])))
                continue
            sz = s[row][..., idx]                        # (Hkv, G, n)
            m = sz.max(-1).values
            pe = torch.exp(sz - m[..., None])
            parts.append((m, pe.sum(-1),
                          torch.einsum("hgs,shd->hgd", pe, vf[row, idx])))
        mx = torch.stack([m for m, _, _ in parts]).max(0).values
        lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
        osum = sum(a * torch.exp(m - mx)[..., None] for m, _, a in parts)
        out[row] = osum / torch.clamp(lsum, min=1e-30)[..., None]
    return out.to(q.dtype)


SPLIT_CASES = [  # (b, cap, hkv, g, hd, window, pos, chunk, int8)
    # wrapped rows whose window empties whole chunks (6 of 8 at pos 600)
    (2, 256, 2, 1, 64, 40, [600, 290], 32, False),
    # a row shorter than one chunk beside rows over several
    (3, 128, 2, 2, 32, None, [10, 127, 300], 32, False),
    # the hybrid's attn layers: G 16 on one KV head at hd 256
    (2, 96, 1, 16, 256, None, [50, 300], 32, False),
    (2, 100, 2, 4, 32, 30, [99, 450], 16, True),     # int8, cap % chunk
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_ring_split_and_merge_matches_reference(case):
    """The split-and-merge mirror against the port's plain version and
    the reference's op (its Pallas kernel in interpret mode) on the same
    numpy inputs."""
    b, cap, hkv, g, hd, window, pos, chunk, int8 = case
    q, k, v, ks, vs = _qkv(b, cap, hkv, g, hd, seed=cap + g, int8=int8)
    pos = np.asarray(pos, np.int32)
    kw = dict(window=window, scale=hd ** -0.5)
    got = _split_merge(*map(_t, (q, k, v, pos)), chunk, k_scale=_t(ks),
                       v_scale=_t(vs), **kw).numpy()
    plain = ref.decode_attention_ref(*map(_t, (q, k, v, pos)),
                                     k_scale=_t(ks), v_scale=_t(vs), **kw)
    want = jax_ops.decode_attention(*map(_j, (q, k, v, pos)),
                                    k_scale=_j(ks), v_scale=_j(vs),
                                    impl="pallas", interpret=True, **kw)
    for w in (plain.numpy(), np.asarray(want)):
        np.testing.assert_allclose(got, w, rtol=TOL, atol=TOL)
    if window:   # the case holds chunks the window empties
        p = int(pos[0])
        assert any(lo >= hi for lo, hi in (
            _arc_cut(lo0, hi0, p, cap, window)
            for lo0, hi0 in ops.decode_chunks(cap, chunk)))


def test_warp_step_matches_the_kernel():
    """``warp_step`` mirrors the kernel's ``Shape`` (warps x unroll), read
    from the source, at every head dim, K/V type and group tile; the ring
    entry takes a chunk and the partials' scratch."""
    src = (Path(ops.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()
    shape = re.search(
        r"warps = GT \* HD / 32 >= (\d+) \? (\d+) : (\d+);.*?"
        r"by_bytes = (\d+) / \(2 \* HD \* \(int\)sizeof\(TKV\)\);.*?"
        r"u = by_bytes < (\d+) / GT \? by_bytes : \5 / GT;.*?"
        r"unroll = u < (\d+) \? \6 : \(u > (\d+) \? \7 : u\);",
        src, re.S)
    assert shape, "the kernel's Shape moved"
    cut, many, few, budget, scores, lo, hi = map(int, shape.groups())
    for hd in ops.HEAD_DIMS:
        for kv_bytes in (1, 2, 4):
            for g in range(1, 17):
                gt = ops.group_tile(g)
                warps = many if gt * hd // 32 >= cut else few
                u = min(budget // (2 * hd * kv_bytes), scores // gt)
                assert ops.warp_step(hd, kv_bytes, g) == \
                    warps * max(lo, min(hi, u))
    ring = src[src.index('extern "C" int decode_ring'):]
    assert "float* part" in ring and "int chunk" in ring
    assert "n_split = (cap + chunk - 1) / chunk" in ring


def test_decode_tiles_match_the_kernel():
    """``group_tile`` mirrors the kernel's ``by_group`` (query heads per
    block), and the wrapper's scratch of B * Hkv * n_split * G * (hd + 2)
    floats the partials' layout (acc, then m and l) in ``run``."""
    src = (Path(ops.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()
    picks = [(int(a), int(b)) for a, b in re.findall(
        r"if \(a\.G <= (\d+)\) return run<TQ, TKV, HD, (\d+), TABLE>",
        src)]
    last = re.search(r"\n  return run<TQ, TKV, HD, (\d+), TABLE>\(a\);",
                     src)
    assert picks and last, "the kernel's group tiles moved"
    for g in range(1, 17):
        want = next((t for cut, t in picks if g <= cut), int(last.group(1)))
        assert ops.group_tile(g) == want
    assert "a.part + (size_t)rows * a.n_split * a.G * HD" in src
    assert "chunk % bs" in src


def test_policy_selects_the_decode_attention():
    assert common.KernelPolicy().decode_backend() == "auto"
    assert common.KernelPolicy(backend="cuda").decode_backend() == "cuda"
    assert common.KernelPolicy(decode_attention="xla",
                               backend="cuda").decode_backend() == "plain"
    assert common.KernelPolicy(decode_attention="auto").decode_backend() \
        == "auto"
    with pytest.raises(ValueError, match="decode_attention must be"):
        common.KernelPolicy(decode_attention="pallas")


def test_kv_cache_spec_follows_the_policy():
    cfg = reduced(ARCHS["olmo-1b"])
    assert kv_cache_spec(cfg, torch.float32) == (torch.float32, False)
    for sel, want in (("fp32", (torch.float32, False)),
                      ("bf16", (torch.bfloat16, False)),
                      ("int8", (torch.int8, True))):
        c = dataclasses.replace(cfg, numerics=NumericsPolicy(
            kv_cache_dtype=sel))
        assert kv_cache_spec(c, torch.bfloat16) == want


def test_kv_quant_matches_reference():
    x = (np.random.default_rng(3).normal(size=(4, 5, 2, 32)) * 3).astype(
        np.float32)
    x[0, 0, 0] = 0.0                                   # an all-zero row
    q, s = attention._kv_quant(torch.from_numpy(x))
    jq, js = jax_attention._kv_quant(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(attention._kv_dequant(q, s).numpy(), x,
                               atol=float(s.max()) / 2 + 1e-7)


# ----------------------------------------------------------------- model --

CAPACITY = 48
# reduced configs: olmo np_ln + gelu + tied embeddings; minitron GQA 2;
# gemma-swa a window of 16, so the ring of 16 slots wraps while decoding
MODELS = {"olmo-1b": {}, "minitron-8b": {"n_kv_heads": 2},
          "gemma-7b-swa": {"sliding_window": 16}}


def _pair(name, kv="auto"):
    extra = MODELS[name]
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[name]),
                               kernels=JaxPolicy(backend="xla"),
                               numerics=JaxNumerics(kv_cache_dtype=kv),
                               **extra)
    cfg = dataclasses.replace(reduced(ARCHS[name]),
                              numerics=NumericsPolicy(kv_cache_dtype=kv),
                              **extra)
    params = jax_models.init(jax.random.PRNGKey(0), jcfg)
    port = weights.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return jcfg, params, cfg, port


def _leaves(cache):
    return {k: v for k, v in cache["blocks"][0].items()}


def _compare_caches(jstate, state, quant=False):
    want = {k: np.asarray(v, np.float32)
            for k, v in jstate.cache["blocks"][0].items()}
    got = {k: v.float().numpy() for k, v in _leaves(state.cache).items()}
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    for name in got:
        _close_leaf(name, got[name], want[name],
                    state.cache["blocks"][0][name].dtype, quant)


def _close_leaf(name, g, w, dtype, quant):
    if not quant or name.endswith("scale"):
        np.testing.assert_allclose(g, w, rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=name)
        return
    # one storage step: an int8 step, or one bf16 ulp on top of MODEL_TOL
    # (the fp32 noise is absolute: it can move a tiny value by more than
    # its ulp)
    step = 1.0 if dtype == torch.int8 else BF16_ULP * np.abs(w) + MODEL_TOL
    assert np.all(np.abs(g - w) <= step), name
    assert np.mean(g != w) <= QUANT_FLIP_SHARE, name


def _run_both(name, kv="auto", steps=6):
    """Prefill at a bucket of 32 with per-row lengths, then ``steps``
    decode steps with rows at different depths, in both packages.
    Yields (what, reference logits, reference state, port logits, port
    state) after the prefill and after each step."""
    jcfg, params, cfg, port = _pair(name, kv)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 32)).astype(np.int32)
    length = np.asarray([32, 20, 7], np.int32)
    jl, js = jax_models.prefill(params, jcfg, jnp.asarray(toks), CAPACITY,
                                length=jnp.asarray(length))
    pl, ps = models.prefill(port, cfg, torch.from_numpy(toks), CAPACITY,
                            length=torch.from_numpy(length))
    yield "prefill", jl, js, pl, ps
    for i in range(steps):
        t = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, js = jax_models.decode_step(params, jcfg, js, jnp.asarray(t))
        pl, ps = models.decode_step(port, cfg, ps, torch.from_numpy(t))
        yield f"step {i}", jl, js, pl, ps


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_and_decode_match_reference(name):
    """Logits and every cache leaf at 1e-4 after the bucketed prefill and
    after each of 6 decode steps (gemma-swa's 16-slot ring wraps)."""
    for what, jl, js, pl, ps in _run_both(name):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=what)
        _compare_caches(js, ps)
    assert ps.pos.tolist() == [38, 26, 13]


@pytest.mark.parametrize("name,kv", [("olmo-1b", "bf16"),
                                     ("minitron-8b", "int8")])
def test_quantized_cache_matches_reference(name, kv):
    """A bf16 / int8 cache: stored dtypes, scales at 1e-4, stored values
    within one storage step (see QUANT_LOGIT_TOL), logits within
    QUANT_LOGIT_TOL."""
    for what, jl, js, pl, ps in _run_both(name, kv):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   rtol=QUANT_LOGIT_TOL,
                                   atol=QUANT_LOGIT_TOL, err_msg=what)
        _compare_caches(js, ps, quant=True)
    leaves = _leaves(ps.cache)
    assert leaves["k"].dtype == {"bf16": torch.bfloat16,
                                 "int8": torch.int8}[kv]
    assert ("k_scale" in leaves) == (kv == "int8")


def test_fill_cache_matches_reference():
    """A 24-token prefix into a 16-slot ring (it wraps), rows cut to
    their own lengths, fp32 and int8."""
    jcfg, params, cfg, port = _pair("olmo-1b")
    attn = {k: v[0] for k, v in port["blocks"][0]["attn"].items()}
    jattn = jax.tree.map(lambda a: a[0], params["blocks"][0]["attn"])
    x = np.random.default_rng(4).normal(size=(3, 24, cfg.d_model)).astype(
        np.float32)
    length = np.asarray([24, 10, 3], np.int32)
    for kv in ("auto", "int8"):
        c = dataclasses.replace(cfg, numerics=NumericsPolicy(
            kv_cache_dtype=kv))
        jc = dataclasses.replace(jcfg, numerics=JaxNumerics(
            kv_cache_dtype=kv))
        cache = attention.init_cache(c, 3, 16, torch.float32, "cpu")
        got = attention.fill_cache(attn, c, torch.from_numpy(x), cache,
                                   length=torch.from_numpy(length))
        want = jax_attention.fill_cache(
            jattn, jc, jnp.asarray(x),
            jax_attention.init_cache(jc, 3, 16, jnp.float32),
            length=jnp.asarray(length))
        assert got is cache and sorted(got) == sorted(want)
        for name in got:
            _close_leaf(f"{kv} {name}", got[name].float().numpy(),
                        np.asarray(want[name], np.float32), got[name].dtype,
                        kv == "int8")


def test_decode_from_the_reference_state():
    """The bridge carries a reference DecodeState across bit for bit:
    one decode step from it matches the reference's at 1e-4, and the port's
    state goes back unchanged."""
    *_, (_, jl, js, pl, ps) = _run_both("olmo-1b", steps=1)
    jcfg, params, cfg, port = _pair("olmo-1b")
    state = weights.decode_state_from_reference(js, cfg, device="cpu")
    back = weights.decode_state_to_reference(state)
    for k, v in js.cache["blocks"][0].items():
        np.testing.assert_array_equal(back["cache"]["blocks"][0][k],
                                      np.asarray(v))
    np.testing.assert_array_equal(back["pos"], np.asarray(js.pos))
    t = np.asarray([[3], [4], [5]], np.int32)
    jl2, js2 = jax_models.decode_step(params, jcfg,
                                      jax_models.DecodeState(**back),
                                      jnp.asarray(t))
    pl2, ps2 = models.decode_step(port, cfg, state, torch.from_numpy(t))
    np.testing.assert_allclose(pl2.numpy(), np.asarray(jl2), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    _compare_caches(js2, ps2)


def test_bridge_checks_the_cache():
    cfg = reduced(ARCHS["olmo-1b"])
    state = models.init_decode_state(cfg, 2, 16, device="cpu")
    ref_state = weights.decode_state_to_reference(state)
    bad = dict(ref_state)
    bad["cache"] = {"blocks": ({"k": ref_state["cache"]["blocks"][0]["k"]},),
                    "rem_blocks": ()}
    with pytest.raises(ValueError, match="decode cache leaves"):
        weights.decode_state_from_reference(
            dataclasses.make_dataclass("S", ["cache", "pos"])(**bad), cfg,
            device="cpu")
    wrong = {"blocks": ({k: v.astype(np.float64) for k, v in
                         ref_state["cache"]["blocks"][0].items()},),
             "rem_blocks": ()}
    with pytest.raises(ValueError, match="expected float32"):
        weights.decode_state_from_reference(
            dataclasses.make_dataclass("S", ["cache", "pos"])(
                wrong, ref_state["pos"]), cfg, device="cpu")


def test_table_decode_matches_reference():
    """decode_step on the block pool (table layout, shared blocks and a
    row on the trash block) against the reference's."""
    jcfg, params, cfg, port = _pair("olmo-1b")
    rng = np.random.default_rng(2)
    pool = jax_models.init_decode_cache(jcfg, 7, 8)
    pool = jax.tree.map(lambda x: jnp.asarray(
        rng.normal(size=x.shape).astype(np.float32)), pool)
    jstate = jax_models.DecodeState(cache=pool, pos=jnp.asarray(
        [20, 31, 5], jnp.int32))
    state = weights.decode_state_from_reference(jstate, cfg, device="cpu")
    t = np.asarray([[7], [8], [9]], np.int32)
    for _ in range(3):
        jl, jstate = jax_models.decode_step(params, jcfg, jstate,
                                            jnp.asarray(t),
                                            table=jnp.asarray(TABLE))
        pl, state = models.decode_step(port, cfg, state, torch.from_numpy(t),
                                       table=torch.from_numpy(TABLE))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        _compare_caches(jstate, state)


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_slots_round_trip_bit_for_bit(kv):
    """read_slots then write_slots is the identity; write_slots writes the
    cache in place and leaves the input's pos alone."""
    cfg = dataclasses.replace(reduced(ARCHS["minitron-8b"]),
                              numerics=NumericsPolicy(kv_cache_dtype=kv))
    state = models.init_decode_state(cfg, 4, 16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for leaf in _leaves(state.cache).values():
        leaf.copy_((torch.randn(leaf.shape, generator=gen) * 50).to(
            leaf.dtype))
    state.pos.copy_(torch.tensor([3, 9, 0, 15]))
    before = {k: v.clone() for k, v in _leaves(state.cache).items()}
    sub = models.read_slots(state, [2, 0])
    assert sub.pos.tolist() == [0, 3]
    assert _leaves(sub.cache)["k"].shape[:2] == (cfg.n_layers, 2)
    other = models.init_decode_state(cfg, 4, 16, device="cpu")
    out = models.write_slots(other, sub, [1, 3])
    assert out.cache is other.cache and other.pos.tolist() == [0, 0, 0, 0]
    assert out.pos.tolist() == [0, 0, 0, 3]
    back = models.read_slots(out, [1, 3])
    for k, v in _leaves(back.cache).items():
        assert torch.equal(v, _leaves(sub.cache)[k])
    for k, v in _leaves(models.write_slots(state, back, [2, 0]).cache).items():
        assert torch.equal(v, before[k])


def test_decode_step_writes_the_cache_in_place():
    cfg = reduced(ARCHS["olmo-1b"])
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    _, state = models.prefill(params, cfg, torch.ones((2, 8),
                                                      dtype=torch.long), 16)
    k = _leaves(state.cache)["k"]
    ptr = k.data_ptr()
    _, new = models.decode_step(params, cfg, state,
                                torch.ones((2, 1), dtype=torch.long))
    assert new.cache is state.cache and k.data_ptr() == ptr
    assert new.pos.tolist() == [9, 9] and state.pos.tolist() == [8, 8]
    assert k[:, :, 8].abs().sum() > 0 and k[:, :, 9:].abs().sum() == 0


def test_xla_policy_runs_the_plain_version():
    cfg = reduced(ARCHS["olmo-1b"])
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    toks = torch.arange(8).reshape(1, 8)
    plain = dataclasses.replace(cfg, kernels=common.KernelPolicy(
        decode_attention="xla"))
    outs = []
    for c in (cfg, plain):
        _, st = models.prefill(params, c, toks, 16)
        outs.append(models.decode_step(params, c, st, toks[:, :1])[0])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi-3-vision-4.2b",
                                  "seamless-m4t-medium"])
def test_other_families_have_no_decode_yet(arch):
    """vlm and encdec still raise, naming their queue-A item; moe is
    ported, and its decode state is a ring per layer."""
    cfg = reduced(ARCHS[arch])
    if cfg.family == "moe":
        state = models.init_decode_state(cfg, 2, 16, device="cpu")
        assert state.cache["blocks"][0]["k"].shape[:3] == (2, 2, 16)
        return
    with pytest.raises(NotImplementedError, match=r"queue A \(item 8"):
        models.init_decode_state(cfg, 2, 16, device="cpu")


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


CARD_CASES = [  # (b, cap, hkv, g, hd, window, pos, bs): bs 0 = ring
    (3, 200, 2, 1, 128, None, [0, 150, 1000], 0),
    (2, 512, 2, 4, 64, None, [511, 2000], 0),
    (2, 300, 1, 8, 256, 100, [299, 777], 0),
    (2, 64, 2, 12, 128, None, [5, 64], 0),          # G > 8: two chunks
    (3, 256, 2, 2, 128, None, [100, 255, 17], 16),
    (2, 256, 4, 4, 128, 64, [200, 255], 16),
    # the table kernel's split (decode_chunk; chunks of 64 slots here):
    # rows longer than several chunks, a row shorter than one, a window
    # that empties whole chunks, cap not a multiple of the chunk, G 12
    (2, 1024, 2, 1, 128, None, [1023, 3000], 16),
    (3, 512, 2, 1, 64, None, [10, 511, 40], 16),
    (2, 1024, 2, 2, 128, 100, [1023, 2000], 16),
    (2, 272, 1, 4, 128, None, [271, 500], 16),
    (2, 256, 2, 12, 128, None, [255, 100], 16),
    # the ring kernel's split (kernel_chunk; several chunks per row here):
    # the same five, and G 16 at hd 256 (the hybrid's attn layers: two
    # query-head tiles per row on the SIMT body, one on the tensor-core
    # body) on a wrapped, windowed ring
    (2, 1024, 2, 1, 128, None, [1023, 3000], 0),
    (3, 512, 2, 1, 64, None, [10, 511, 40], 0),
    (2, 1024, 2, 2, 128, 100, [1023, 2000], 0),
    (2, 272, 1, 4, 128, None, [271, 500], 0),
    (2, 256, 2, 12, 128, None, [255, 100], 0),
    (2, 512, 1, 16, 256, 300, [511, 1500], 0),
    # the ring's tensor-core body (bf16 q, bf16 or int8 K/V, G > 8): rows
    # of many stages, cap not a multiple of a stage, and G 24 (a second
    # block of 8 heads in a 16-head tile) on a windowed, wrapped ring
    (2, 2048, 1, 16, 256, None, [100, 5000], 0),
    (3, 100, 1, 16, 128, None, [10, 99, 250], 0),
    (2, 300, 2, 24, 64, 50, [299, 1000], 0),
]


def _card(case, q_dtype, kv_dtype, seed=0):
    b, cap, hkv, g, hd, window, pos, bs = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hkv, g, hd), generator=gen, device="cuda").to(
        q_dtype)
    table = None
    if bs:
        n_k = cap // bs
        ids = torch.randperm(b * n_k, generator=gen, device="cuda") + 1
        table = ids.reshape(b, n_k).to(torch.int32)
        shape = (b * n_k + 1, bs, hkv, hd)
    else:
        shape = (b, cap, hkv, hd)
    ks = vs = None
    if kv_dtype == torch.int8:
        k, v = (torch.randint(-127, 128, shape, generator=gen,
                              device="cuda").to(torch.int8)
                for _ in range(2))
        ks, vs = (torch.rand(shape[:3], generator=gen, device="cuda") * 0.05
                  for _ in range(2))
    else:
        k, v = (torch.randn(shape, generator=gen, device="cuda").to(kv_dtype)
                for _ in range(2))
    return (q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda"),
            dict(window=window, scale=hd ** -0.5, k_scale=ks, v_scale=vs,
                 table=table))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.int8),
    (torch.bfloat16, torch.int8)], ids=str)
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_kernels_match_plain_version(cuda, case, dtypes):
    q, k, v, pos, kw = _card(case, *dtypes)
    which = ops.decode_table if kw["table"] is not None else ops.decode_ring
    before = which.launches
    got = ops.decode_attention(q, k, v, pos, **kw)
    assert which.launches == before + 1 and got.dtype == q.dtype
    want = ops.decode_attention(q, k, v, pos, backend="plain", **kw)
    tol = TOL if q.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_decode_table_is_deterministic(cuda):
    """At the serving tick's shape the table kernel splits each row over
    blocks whose partials a second kernel folds in split order, not by
    atomics: two calls agree bit for bit."""
    case = (8, 2048, 16, 1, 128, None,
            [100, 517, 1023, 1500, 2047, 2048, 3000, 5000], 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.decode_chunk(2048, 16, 8 * 16, sms) < 2048
    q, k, v, pos, kw = _card(case, torch.bfloat16, torch.bfloat16)
    first = ops.decode_attention(q, k, v, pos, **kw)
    second = ops.decode_attention(q, k, v, pos, **kw)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_decode_ring_is_deterministic(cuda):
    """At the serving tick's shape the ring kernel splits each row over
    eight blocks whose partials a second kernel folds in split order:
    two calls agree bit for bit."""
    case = (8, 2048, 16, 1, 128, None,
            [100, 517, 1023, 1500, 2047, 2048, 3000, 5000], 0)
    q, k, v, pos, kw = _card(case, torch.bfloat16, torch.bfloat16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.kernel_chunk(q, k, None, sms) < 2048
    first = ops.decode_attention(q, k, v, pos, **kw)
    second = ops.decode_attention(q, k, v, pos, **kw)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=str)
def test_decode_ring_tensor_cores_are_deterministic(cuda, kv_dtype):
    """The hybrid's attn layers at the serving tick (B 8, one KV head,
    G 16, hd 256, a ring of 2048): the tensor-core body, split in chunks
    of whole stages, merged in split order: two calls agree bit for
    bit."""
    case = (8, 2048, 1, 16, 256, None,
            [100, 517, 1023, 1500, 2047, 2048, 3000, 5000], 0)
    q, k, v, pos, kw = _card(case, torch.bfloat16, kv_dtype)
    assert ops.tensor_core_ring(16, q.dtype, k.dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = ops.kernel_chunk(q, k, None, sms)
    assert chunk < 2048 and chunk % ops.MMA_TILE == 0
    first = ops.decode_attention(q, k, v, pos, **kw)
    second = ops.decode_attention(q, k, v, pos, **kw)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_model_decode_on_the_card_matches_plain(cuda):
    """Prefill and 4 decode steps of the reduced olmo at hd 128 under the
    kernels and under the plain policy, from the same weights."""
    cfg = dataclasses.replace(reduced(ARCHS["olmo-1b"]), head_dim=128)
    plain = dataclasses.replace(cfg, kernels=common.KernelPolicy("plain"))
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (3, 32), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(1))
    length = torch.tensor([32, 20, 7], device="cuda")
    outs = []
    for c in (cfg, plain):
        logits, st = models.prefill(params, c, toks, 64, length=length)
        seq = [logits]
        for i in range(4):
            logits, st = models.decode_step(params, c, st, toks[:, i:i + 1])
            seq.append(logits)
        outs.append(seq)
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3)
