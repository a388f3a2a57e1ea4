"""Serving the port's recurrent LMs, ``rwkv6-7b`` (ssm) and
``recurrentgemma-9b`` (hybrid), against the reference's: the decode
surface (prefill with per-row lengths, decode steps, every cache leaf), a
prefill from a carried state, the single-token steps ``wkv_decode`` and
``rglru_decode``, slot surgery on the recurrent state, and the engine's
greedy streams.  Then the ring decode kernel's tensor-core body, which
the hybrid's 16-head MQA layers run: its decomposition mirrored in plain
PyTorch against the reference's op, and the kernel itself on the card.

The reference runs live on the CPU under its XLA policy (its init,
prefill, decode step and forward under ``jax.jit``); weights come from
``repro.models.init`` through ``weights.lm_from_reference``, inputs from
numpy.  fp32, reduced configs at d_model 64: ``rwkv6-7b`` at 2
layers, ``recurrentgemma-9b`` at 4 (one ``rec, rec, attn`` superblock and
a remainder ``rec`` layer) with a window of 16, so that prefill and
decode run past the window and the attn layers' 16-slot ring wraps.
"""
import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import models, weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.rwkv6 import ref as wkv_ref
from repro_torch.models import rglru, transformer
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import flatten_with_paths

try:
    import jax
    import jax.numpy as jnp

    from repro import models as jax_models
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.kernels.decode_attention import ops as jax_decode_ops
    from repro.kernels.rwkv6 import ref as jax_wkv_ref
    from repro.models import rglru as jax_rglru
    from repro.models import transformer as jax_transformer
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

TOL = 1e-4
WIDTH = 64
CAPACITY = 48
# (layers, config fields): the hybrid's window of 16 is shorter than the
# 32-token prefill bucket
MODELS = {"rwkv6-7b": (2, {}),
          "recurrentgemma-9b": (4, {"sliding_window": 16})}


@functools.lru_cache(maxsize=None)
def _jitted(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _forward_from(params, cfg, tokens, cache):
    return jax_transformer.forward(params, cfg, tokens, return_cache=True,
                                   cache=cache)


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference config, reference params, port config, port params)."""
    layers, extra = MODELS[name]
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[name], layers, WIDTH),
                               kernels=JaxPolicy(backend="xla"), **extra)
    cfg = dataclasses.replace(reduced(ARCHS[name], layers, WIDTH), **extra)
    params = _jitted(jax_models.init, 1)(jax.random.PRNGKey(0), jcfg)
    port = weights.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return jcfg, params, cfg, port


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    return _pair(request.param)


def _compare_caches(jcache, cache, what):
    """Every leaf of the port's cache tree against the reference's, by
    path, at TOL."""
    want = flatten_with_paths(jax.tree.map(np.asarray, jcache))
    got = flatten_with_paths(cache)
    assert sorted(got) == sorted(want), what
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape, f"{what} {path}"
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(want[path], np.float32),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {path}")


def _run_both(pair, steps=6):
    """Prefill at a bucket of 32 with per-row lengths [32, 20, 7], then
    ``steps`` decode steps with the rows at different depths, in both
    packages: (what, reference logits, state, port logits, state) after
    the prefill and after each step."""
    jcfg, params, cfg, port = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 32)).astype(np.int32)
    length = np.asarray([32, 20, 7], np.int32)
    jl, js = _jitted(jax_models.prefill, 1, 3)(
        params, jcfg, jnp.asarray(toks), CAPACITY, length=jnp.asarray(length))
    pl, ps = models.prefill(port, cfg, torch.from_numpy(toks), CAPACITY,
                            length=torch.from_numpy(length))
    yield "prefill", jl, js, pl, ps
    for i in range(steps):
        t = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, js = _jitted(jax_models.decode_step, 1)(params, jcfg, js,
                                                    jnp.asarray(t))
        pl, ps = models.decode_step(port, cfg, ps, torch.from_numpy(t))
        yield f"step {i}", jl, js, pl, ps


def test_prefill_and_decode_match_reference(pair):
    """Logits and every cache leaf (``tm_shift``, ``wkv``, ``cm_shift``;
    ``conv``, ``h``; the attn layers' ring) at 1e-4 after the bucketed
    prefill and after each of 6 decode steps."""
    for what, jl, js, pl, ps in _run_both(pair):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=what)
        _compare_caches(js.cache, ps.cache, what)
        np.testing.assert_array_equal(ps.pos.numpy(), np.asarray(js.pos))
    assert ps.pos.tolist() == [38, 26, 13]


def test_prefill_from_a_carried_state_matches_reference(pair):
    """A forward from a non-zero cache (the plain chunked WKV with its
    state, the RG-LRU's folded h and conv history; the attn layers fill
    their ring as the reference's do) against the reference's
    ``forward(..., cache=)``: logits and every new leaf."""
    jcfg, params, cfg, port = pair
    *_, (_, _, js, _, ps) = _run_both(pair, steps=2)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (3, 8)).astype(np.int32)
    jl, _, jcache = _jitted(_forward_from, 1)(params, jcfg,
                                              jnp.asarray(toks), js.cache)
    pl, aux, cache = transformer.forward(port, cfg, torch.from_numpy(toks),
                                         cache=ps.cache)
    assert float(aux) == 0.0
    assert cache is ps.cache
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _compare_caches(jcache, cache, "carried")


def test_wkv_decode_matches_reference():
    rng = np.random.default_rng(3)
    b, h, k = 2, 3, 16
    r, kk, v = (rng.normal(size=(b, h, k)).astype(np.float32)
                for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, h, k)))).astype(np.float32)
    u = rng.normal(size=(h, k)).astype(np.float32)
    s = rng.normal(size=(b, h, k, k)).astype(np.float32)
    y, s_new = wkv_ref.wkv_decode(*map(torch.from_numpy, (r, kk, v, w, u, s)))
    jy, js = jax_wkv_ref.wkv_decode(*map(jnp.asarray, (r, kk, v, w, u, s)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(s_new.numpy(), np.asarray(js), rtol=TOL,
                               atol=TOL)


def test_rglru_decode_matches_reference():
    """One RG-LRU step from a non-zero conv history and h."""
    jcfg, params, cfg, port = _pair("recurrentgemma-9b")
    jp = params["blocks"][0]["mix"]
    p = {k: v[0] for k, v in port["blocks"][0]["mix"].items()}
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    cache = {"conv": rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32),
             "h": rng.normal(size=(2, cfg.d_model)).astype(np.float32)}
    out, new = rglru.rglru_decode(p, cfg, torch.from_numpy(x),
                                  {k: torch.from_numpy(v)
                                   for k, v in cache.items()})
    jout, jnew = jax_rglru.rglru_decode(
        jax.tree.map(lambda a: a[0], jp), jcfg, jnp.asarray(x),
        jax.tree.map(jnp.asarray, cache))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    for key in ("conv", "h"):
        np.testing.assert_allclose(new[key].numpy(), np.asarray(jnew[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_write_slots_overwrites_every_recurrent_leaf(pair):
    """A slot that decoded garbage takes a fresh request's state whole:
    every leaf of its row equals the prefilled sub-state bit for bit, and
    the other rows keep theirs."""
    _, _, cfg, port = pair
    state = models.init_decode_state(cfg, 3, CAPACITY, device="cpu")
    for t in range(3):
        _, state = models.decode_step(port, cfg, state,
                                      torch.full((3, 1), t + 5))
    before = {k: v.clone() for k, v in flatten_with_paths(
        models.read_slots(state, [0, 2]).cache).items()}
    _, sub = models.prefill(port, cfg, torch.arange(1, 9)[None], CAPACITY,
                            length=torch.tensor([6]))
    state = models.write_slots(state, sub, [1])
    row = flatten_with_paths(models.read_slots(state, [1]).cache)
    for path, leaf in flatten_with_paths(sub.cache).items():
        assert torch.equal(row[path], leaf), path
    for path, leaf in flatten_with_paths(
            models.read_slots(state, [0, 2]).cache).items():
        assert torch.equal(before[path], leaf), path
    assert state.pos.tolist() == [3, 6, 3]


def _requests(vocab):
    """4 requests: prompts of 5-40 tokens, 6-25 new tokens each."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, n), m)
            for n, m in ((5, 25), (40, 6), (17, 12), (29, 20))]


@pytest.mark.parametrize("ticks", [1, 4])
def test_engine_matches_reference_engine(pair, ticks):
    """Both engines' greedy streams equal per rid (2 slots, capacity 48,
    so slots are reused and long rows retire on the capacity)."""
    jcfg, params, cfg, port = pair
    reqs = _requests(cfg.vocab_size)
    jeng = JaxEngine(params, jcfg, slots=2, capacity=CAPACITY,
                     ticks_per_dispatch=ticks)
    want = {r.rid: list(r.tokens) for r in jeng.run(
        [JaxRequest(prompt=p, max_new_tokens=m) for p, m in reqs])}
    eng = ServingEngine(port, cfg, slots=2, capacity=CAPACITY,
                        ticks_per_dispatch=ticks)
    got = {r.rid: list(r.tokens) for r in eng.run(
        [Request(prompt=p, max_new_tokens=m) for p, m in reqs])}
    assert got == want
    assert eng.decode_steps == jeng.decode_steps
    assert eng.free_slots == 2 and eng._results == {}


# ------------------------------------------- the ring's tensor-core body --

def _arc_cut(lo, hi, p, cap, window):
    """The kernels' cut of a chunk [lo, hi) to the arc of a row's valid
    slots (``cut_to_arc``), mirrored."""
    pm = p % cap
    nv = min(p + 1, cap, window if window else cap)
    first = pm - nv + 1
    if first >= 0:
        return max(lo, first), min(hi, pm + 1)
    if lo > pm:
        lo = max(lo, first + cap)
    if hi <= first + cap:
        hi = min(hi, pm + 1)
    return lo, hi


def _tensor_core_mirror(q, k, v, pos, chunk, *, window=None, scale=1.0,
                        k_scale=None, v_scale=None):
    """``decode_mma_kernel``'s decomposition in plain PyTorch (fp32): per
    (row, KV head, split) all of up to MMA_HEADS query heads at once, the
    split's chunk cut to the arc and walked in stages of MMA_TILE slots;
    per stage S = Q K^T with k_scale on its columns, the heads' running
    max m, P = exp(S - m) (0 on invalid slots) with v_scale folded into
    its columns for P V, l summed without it; the splits merged in split
    order."""
    b, cap, hkv, hd = k.shape
    g = q.shape[2]
    kf, vf = k.float(), v.float()
    ks = torch.ones(k.shape[:3]) if k_scale is None else k_scale.float()
    vs = torch.ones(k.shape[:3]) if v_scale is None else v_scale.float()
    out = torch.zeros(q.shape, dtype=torch.float32)
    for row in range(b):
        p = int(pos[row])
        nv = min(p + 1, cap, window or cap)
        sp = decode_ref.slot_positions(torch.tensor([p]), cap)[0]
        valid = (sp >= 0) & (sp > p - nv)
        n_used = -(-min(p + 1, cap) // chunk)
        for h in range(hkv):
            for g0 in range(0, g, decode_ops.MMA_HEADS):
                qs = q[row, h, g0:g0 + decode_ops.MMA_HEADS].float()
                parts = []
                for z in range(n_used):
                    lo, hi = _arc_cut(z * chunk, min(cap, (z + 1) * chunk),
                                      p, cap, window)
                    m = torch.full((qs.shape[0],), decode_ref.NEG)
                    l = torch.zeros(qs.shape[0])
                    acc = torch.zeros(qs.shape)
                    for t0 in range(lo, hi, decode_ops.MMA_TILE):
                        cs = torch.arange(t0, min(hi, t0 +
                                                  decode_ops.MMA_TILE))
                        ok = valid[cs]
                        s = qs @ kf[row, cs, h].T * scale * ks[row, cs, h]
                        s = torch.where(ok, s, decode_ref.NEG)
                        mn = torch.maximum(m, s.max(-1).values)
                        alpha = torch.exp(m - mn)
                        pe = torch.where(ok, torch.exp(s - mn[:, None]), 0.)
                        l = l * alpha + pe.sum(-1)
                        acc = acc * alpha[:, None] + \
                            (pe * vs[row, cs, h]) @ vf[row, cs, h]
                        m = mn
                    parts.append((m, l, acc))
                mx = torch.stack([m for m, _, _ in parts]).max(0).values
                lsum = sum(l * torch.exp(m - mx) for m, l, _ in parts)
                osum = sum(a * torch.exp(m - mx)[:, None]
                           for m, _, a in parts)
                out[row, h, g0:g0 + decode_ops.MMA_HEADS] = \
                    osum / torch.clamp(lsum, min=1e-30)[:, None]
    return out.to(q.dtype)


MIRROR_CASES = [  # (b, cap, hkv, g, hd, window, pos, int8)
    # the hybrid's attn layers: G 16 on one KV head at hd 256
    (2, 96, 1, 16, 256, None, [50, 300], False),
    # G 12 (rows past the group), int8, a window that empties chunks
    (2, 200, 2, 12, 64, 40, [199, 650], True),
    # G 24 (two head tiles), cap not a multiple of the chunk, int8
    (3, 100, 1, 24, 32, None, [10, 99, 250], True),
]


def _mirror_inputs(case, seed):
    b, cap, hkv, g, hd, window, pos, int8 = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hkv, g, hd)).astype(np.float32)
    shape = (b, cap, hkv, hd)
    ks = vs = None
    if int8:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(1e-3, 0.05, shape[:3]).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    return q, k, v, np.asarray(pos, np.int32), ks, vs


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("case", MIRROR_CASES, ids=str)
def test_tensor_core_mirror_matches_reference(case):
    """The mirror, at the chunk ``kernel_chunk`` picks for bf16 q (whole
    stages), against the port's plain version and the reference's op (its
    Pallas kernel in interpret mode) on the same numpy inputs."""
    b, cap, hkv, g, hd, window, pos, int8 = case
    q, k, v, pos, ks, vs = _mirror_inputs(case, seed=cap + g)
    kv_dtype = torch.int8 if int8 else torch.bfloat16
    assert decode_ops.tensor_core_ring(g, torch.bfloat16, kv_dtype)
    chunk = decode_ops.kernel_chunk(
        torch.zeros((b, hkv, g, hd), dtype=torch.bfloat16),
        torch.zeros((b, cap, hkv, hd), dtype=kv_dtype), None, 132)
    assert chunk == cap or chunk % decode_ops.MMA_TILE == 0
    kw = dict(window=window, scale=hd ** -0.5)
    got = _tensor_core_mirror(*map(_t, (q, k, v, pos)), chunk,
                              k_scale=_t(ks), v_scale=_t(vs), **kw).numpy()
    plain = decode_ref.decode_attention_ref(*map(_t, (q, k, v, pos)),
                                            k_scale=_t(ks), v_scale=_t(vs),
                                            **kw)
    want = jax_decode_ops.decode_attention(*map(_j, (q, k, v, pos)),
                                           k_scale=_j(ks), v_scale=_j(vs),
                                           impl="pallas", interpret=True,
                                           **kw)
    for w in (plain.numpy(), np.asarray(want)):
        np.testing.assert_allclose(got, w, rtol=2e-4, atol=2e-4)


def test_tensor_core_constants_match_the_kernel():
    """``MMA_HEADS``, ``MMA_TILE`` and ``tensor_core_ring`` mirror the
    kernel's MMA_M, MMA_TILE (8 slots a warp) and ``by_group``'s test."""
    src = (Path(decode_ops.__file__).parent / "csrc"
           / "decode_attention.cu").read_text()
    warps = int(re.search(r"constexpr int MMA_WARPS = (\d+);", src)[1])
    assert f"constexpr int MMA_M = {decode_ops.MMA_HEADS};" in src
    assert "constexpr int MMA_TILE = 8 * MMA_WARPS;" in src
    assert decode_ops.MMA_TILE == 8 * warps
    assert "if (a.G > 8) return run_mma<TKV, HD>(a);" in src
    assert "!std::is_same<TKV, float>::value" in src
    for g in range(1, 33):
        for qd in (torch.float32, torch.bfloat16):
            for kd in (torch.float32, torch.bfloat16, torch.int8):
                assert decode_ops.tensor_core_ring(g, qd, kd) == (
                    g > 8 and qd == torch.bfloat16 and kd != torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", MIRROR_CASES, ids=str)
def test_tensor_core_body_matches_plain_on_the_card(case):
    """The kernel's tensor-core body (bf16 q, bf16 or int8 K/V) against
    its plain version on the mirror's cases, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    b, cap, hkv, g, hd, window, pos, int8 = case
    if hd not in decode_ops.HEAD_DIMS:
        hd = 64                    # the kernel's smallest head dim
    q, k, v, pos, ks, vs = _mirror_inputs(
        (b, cap, hkv, g, hd, window, pos, int8), seed=cap + g)
    dev = torch.device("cuda")
    q = torch.from_numpy(q).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(x).to(dev) for x in (k, v))
    if not int8:
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    kw = dict(window=window, scale=hd ** -0.5,
              k_scale=None if ks is None else torch.from_numpy(ks).to(dev),
              v_scale=None if vs is None else torch.from_numpy(vs).to(dev))
    pos = torch.from_numpy(pos).to(dev)
    before = decode_ops.decode_ring.launches
    got = decode_ops.decode_ring(q, k, v, pos, **kw)
    assert decode_ops.decode_ring.launches == before + 1
    want = decode_ops.decode_ring(q, k, v, pos, backend="plain", **kw)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
