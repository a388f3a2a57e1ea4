"""The port's speculative decoding against the reference's: the chunked
decode primitives (``models.decode_seq`` with its pending forward and
its commit), ``truncated_draft``, the engine's speculative rounds and
their gates, for the dense, ssm and hybrid families.

The reference runs live on the CPU under its XLA policy; weights come
from ``repro.models.init`` through ``weights.lm_from_reference``, inputs
from numpy.  fp32, reduced configs at d_model 64: ``olmo-1b`` at 2
layers (and with an int8 KV cache), ``rwkv6-7b`` at 2 and
``recurrentgemma-9b`` at 4 (one ``rec, rec, attn`` superblock and a
remainder ``rec`` layer) with a window of 16 below its prompts, so that
the chunk runs on a wrapped ring.  Greedy spec streams must equal the
reference's spec engine's and the port's plain engine's per rid, whatever
the draft proposes.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import models, weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import spec_decode
from repro_torch.tree import flatten_with_paths, tree_leaves

try:
    import jax
    import jax.numpy as jnp

    from repro import models as jax_models
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
    from repro.serving import spec_decode as jax_spec
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

TOL = 1e-4
WIDTH = 64
CAPACITY = 48
# (arch, layers, config fields): the hybrid's window of 16 lies below its
# prompts, so its attn layers' 16-slot ring wraps
MODELS = {"dense": ("olmo-1b", 2, {}),
          "int8": ("olmo-1b", 2, {"kv_cache_dtype": "int8"}),
          "ssm": ("rwkv6-7b", 2, {}),
          "hybrid": ("recurrentgemma-9b", 4, {"sliding_window": 16}),
          "hybrid5": ("recurrentgemma-9b", 5, {})}
FAMILIES = ("dense", "ssm", "hybrid")
TRUNCATE = {"dense": 1, "ssm": 1, "hybrid": 3}   # truncated draft layers


@functools.lru_cache(maxsize=None)
def _jitted(fn, *static):
    return jax.jit(fn, static_argnums=static)


def _configs(name):
    arch, layers, extra = MODELS[name]
    kv = extra.get("kv_cache_dtype")
    fields = {k: v for k, v in extra.items() if k != "kv_cache_dtype"}
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[arch], layers, WIDTH),
                               kernels=JaxPolicy(backend="xla"), **fields)
    cfg = dataclasses.replace(reduced(ARCHS[arch], layers, WIDTH), **fields)
    if kv:
        jcfg = dataclasses.replace(jcfg, numerics=dataclasses.replace(
            jcfg.numerics, kv_cache_dtype=kv))
        cfg = dataclasses.replace(cfg, numerics=dataclasses.replace(
            cfg.numerics, kv_cache_dtype=kv))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _reference_params(arch, layers, seed):
    """``repro.models.init`` of the reduced arch (its window and KV
    storage shape no weight).  The 4-layer hybrid is the 5-layer one's
    first 4 layers, which saves a compile of the init."""
    if (arch, layers) == ("recurrentgemma-9b", 4):
        jcfg5 = jax_reduced(JAX_ARCHS[arch], 5, WIDTH)
        return jax_spec.truncated_draft(
            jcfg5, _reference_params(arch, 5, seed), 4)[1]
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[arch], layers, WIDTH),
                               kernels=JaxPolicy(backend="xla"))
    return _jitted(jax_models.init, 1)(jax.random.PRNGKey(seed), jcfg)


@functools.lru_cache(maxsize=None)
def _pair(name, seed=0):
    """(reference config, reference params, port config, port params)."""
    jcfg, cfg = _configs(name)
    arch, layers, _ = MODELS[name]
    params = _reference_params(arch, layers, seed)
    port = weights.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return jcfg, params, cfg, port


def _compare_caches(jcache, cache, what):
    want = flatten_with_paths(jax.tree.map(np.asarray, jcache))
    got = flatten_with_paths(cache)
    assert sorted(got) == sorted(want), what
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(want[path], np.float32),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"{what} {path}")


def _clone(state):
    return models.DecodeState(
        cache=models.map_cache(lambda leaf, _: leaf.clone(), state.cache),
        pos=state.pos.clone())


# ------------------------------------------------------------ decode_seq --

@pytest.fixture(scope="module", params=["dense", "int8", "ssm", "hybrid"])
def seq_runs(request):
    """Both packages prefill 2 rows (lengths 24 and 19, past the hybrid's
    window) and run one 4-token chunk from there, committing 0 and then
    [3, 1]: (name, reference results, port results, port state before)."""
    jcfg, params, cfg, port = _pair(request.param)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    length = np.asarray([24, 19], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    _, js = _jitted(jax_models.prefill, 1, 3)(
        params, jcfg, jnp.asarray(prompt), CAPACITY,
        length=jnp.asarray(length))
    _, ps = models.prefill(port, cfg, torch.from_numpy(prompt), CAPACITY,
                           length=torch.from_numpy(length))
    seq = _jitted(jax_models.decode_seq, 1)
    want = {cl: seq(params, jcfg, js, jnp.asarray(toks),
                    jnp.asarray(cl, jnp.int32)) for cl in ((0, 0), (3, 1))}
    before = _clone(ps)
    got = {(0, 0): models.decode_seq(port, cfg, ps, torch.from_numpy(toks),
                                     0)}
    after_verify = _clone(ps)
    got[3, 1] = models.decode_seq(port, cfg, ps, torch.from_numpy(toks),
                                  torch.tensor([3, 1]))
    return request.param, want, got, before, after_verify


def test_decode_seq_logits_match_reference(seq_runs):
    name, want, got, _, _ = seq_runs
    for cl in want:
        np.testing.assert_allclose(got[cl][0].numpy(),
                                   np.asarray(want[cl][0]), rtol=TOL,
                                   atol=TOL, err_msg=f"{name} {cl}")


def test_decode_seq_commit_nothing_writes_nothing(seq_runs):
    """commit_len = 0 leaves every cache leaf bit for bit, and pos."""
    name, _, got, before, after = seq_runs
    a, b = flatten_with_paths(before.cache), flatten_with_paths(after.cache)
    for path, leaf in a.items():
        assert torch.equal(leaf, b[path]), f"{name} {path}"
    assert torch.equal(got[0, 0][1].pos, before.pos)


def test_decode_seq_commit_matches_reference(seq_runs):
    """Per-row commit_len [3, 1]: every cache leaf and pos as the
    reference's."""
    name, want, got, before, _ = seq_runs
    _compare_caches(want[3, 1][1].cache, got[3, 1][1].cache, name)
    np.testing.assert_array_equal(got[3, 1][1].pos.numpy(),
                                  np.asarray(want[3, 1][1].pos))
    assert got[3, 1][1].pos.tolist() == [27, 20]


# (config, layer, kind): every kind of block, the hybrid's attn layer on
# its 16-slot window, the int8 ring
BLOCKS = [("dense", 0, "dense"), ("int8", 0, "dense"), ("ssm", 0, "rwkv"),
          ("hybrid", 0, "rec"), ("hybrid", 2, "attn")]


@pytest.mark.parametrize("name,layer,kind", BLOCKS,
                         ids=[f"{n}-{k}" for n, _, k in BLOCKS])
def test_block_chunk_matches_reference(name, layer, kind):
    """One block's 4-token chunk from a random state (rows at positions
    20 and 5; the hybrid's ring wrapped in row 0) with per-row
    commit_len [3, 1]: the outputs and every leaf of the state as the
    reference's ``block_apply_decode_seq``, and, for the attention kinds,
    ``decode_attention_seq`` alone as the reference's."""
    from repro.models import attention as jax_attn
    from repro.models import transformer as jax_transformer

    from repro_torch.models import attention, transformer
    from repro_torch.tree import unflatten_like

    jcfg, params, cfg, port = _pair(name)
    rng = np.random.default_rng(11)
    like = transformer._all_layers(
        models.init_decode_cache(cfg, 2, CAPACITY, device="cpu"), cfg)[layer]
    flat = {}
    for path, leaf in flatten_with_paths(like).items():
        if leaf.dtype == torch.int8:
            flat[path] = rng.integers(-127, 128, leaf.shape).astype(np.int8)
        elif path.endswith("_scale"):
            flat[path] = (rng.random(leaf.shape) * 0.05).astype(np.float32)
        else:
            flat[path] = rng.standard_normal(leaf.shape).astype(np.float32)

    def state(convert):
        return unflatten_like(like, {k: convert(v.copy())
                                     for k, v in flat.items()})

    pos, cl = np.asarray([20, 5], np.int32), np.asarray([3, 1], np.int32)
    h = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    n_kinds = len(transformer.block_kinds(cfg))
    jp = jax.tree.map(lambda x: x[layer // n_kinds],
                      params["blocks"][layer % n_kinds])
    lp = transformer._all_layers(port, cfg)[layer]
    args = [(jnp.asarray(h), state(jnp.asarray), jnp.asarray(pos),
             jnp.asarray(cl)),
            (torch.from_numpy(h), state(torch.from_numpy),
             torch.from_numpy(pos), torch.from_numpy(cl))]
    jh, jc = _jitted(jax_transformer.block_apply_decode_seq, 1, 2)(
        jp, jcfg, kind, *args[0])
    ph = transformer.block_apply_decode_seq(lp, cfg, kind, *args[1])
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=TOL,
                               atol=TOL)
    _compare_caches(jc, args[1][1], f"{name} layer {layer}")
    if kind in ("dense", "attn"):
        jo, jc = jax.jit(functools.partial(
            jax_attn.decode_attention_seq, cfg=jcfg,
            window=cfg.sliding_window))(
            jp["attn"], x=jnp.asarray(h), cache=state(jnp.asarray),
            pos=jnp.asarray(pos), commit_len=jnp.asarray(cl))
        pc = state(torch.from_numpy)
        po = attention.decode_attention_seq(
            lp["attn"], cfg, torch.from_numpy(h), pc, torch.from_numpy(pos),
            torch.from_numpy(cl), window=cfg.sliding_window)
        np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=TOL,
                                   atol=TOL)
        _compare_caches(jc, pc, f"{name} attention")


def test_decode_seq_rejects_a_chunk_longer_than_the_ring():
    _, _, cfg, port = _pair("hybrid")
    state = models.init_decode_state(cfg, 1, CAPACITY, device="cpu")
    with pytest.raises(ValueError, match="ring capacity"):
        models.decode_seq_pending(port, cfg, state,
                                  torch.zeros((1, 17), dtype=torch.long))


# ------------------------------------------------------- truncated draft --

@pytest.mark.parametrize("name,k", [("hybrid5", 1), ("hybrid5", 3),
                                    ("hybrid5", 4), ("dense", 1)])
def test_truncated_draft_matches_reference(name, k):
    """The draft's config and leaves equal the reference's, and every leaf
    is a view of the target's storage."""
    jcfg, params, cfg, port = _pair(name)
    jd, jdp = jax_spec.truncated_draft(jcfg, params, k)
    dcfg, dparams = spec_decode.truncated_draft(cfg, port, k)
    assert (dcfg.n_layers, dcfg.name) == (jd.n_layers, jd.name)
    want = flatten_with_paths(jax.tree.map(np.asarray, jdp))
    got = flatten_with_paths(dparams)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[path], path)
    target = {t.untyped_storage().data_ptr() for t in tree_leaves(port)}
    assert all(t.untyped_storage().data_ptr() in target
               for t in tree_leaves(dparams))
    with pytest.raises(ValueError, match="draft layers"):
        spec_decode.truncated_draft(cfg, port, cfg.n_layers)


# ---------------------------------------------------------------- engine --

def _requests(vocab):
    """4 requests: prompts of 5-40 tokens in two buckets (16 and 48);
    the last one's prompt plus budget passes the capacity, so it retires
    on a full ring."""
    rng = np.random.default_rng(5)
    return [(rng.integers(0, vocab, n), m)
            for n, m in ((5, 12), (12, 6), (9, 9), (40, 12))]


def _streams(results):
    return {r.rid: list(r.tokens) for r in results}


def _drafts(family, port, cfg):
    """The three drafts, (params, config, gamma): other weights (gamma
    2), the target itself (gamma 3), its first layers (gamma 4)."""
    _, _, _, other = _pair(family, seed=9)
    dcfg, dparams = spec_decode.truncated_draft(cfg, port, TRUNCATE[family])
    return {"adversarial": (other, cfg, 2), "self": (port, cfg, 3),
            "truncated": (dparams, dcfg, 4)}


@pytest.fixture(scope="module", params=FAMILIES)
def engine_runs(request):
    """On the same 4 requests (2 slots, capacity 48): the port's plain
    engine, its spec engine with each draft, and the reference's spec
    engine with the adversarial draft.  Whatever the draft, a greedy
    spec engine's streams are its plain engine's, so the reference runs
    one draft: each spec_fn costs a compile."""
    family = request.param
    jcfg, params, cfg, port = _pair(family)
    reqs = _requests(cfg.vocab_size)
    plain = ServingEngine(port, cfg, slots=2, capacity=CAPACITY)
    runs = {"plain": (plain, _streams(plain.run(
        [Request(prompt=p, max_new_tokens=m) for p, m in reqs])))}
    jeng = JaxEngine(params, jcfg, slots=2, capacity=CAPACITY,
                     draft_params=_pair(family, seed=9)[1], draft_cfg=jcfg,
                     spec_tokens=2)
    runs["reference"] = (jeng, _streams(jeng.run(
        [JaxRequest(prompt=p, max_new_tokens=m) for p, m in reqs])))
    for name, (dparams, dcfg, gamma) in _drafts(family, port, cfg).items():
        eng = ServingEngine(port, cfg, slots=2, capacity=CAPACITY,
                            draft_params=dparams, draft_cfg=dcfg,
                            spec_tokens=gamma)
        results = eng.run([Request(prompt=p, max_new_tokens=m)
                           for p, m in reqs])
        runs[name] = (eng, _streams(results), results)
    return family, reqs, runs


@pytest.mark.parametrize("draft", ["adversarial", "self", "truncated"])
def test_spec_streams_match_reference_and_plain(engine_runs, draft):
    family, reqs, runs = engine_runs
    eng, got, _ = runs[draft]
    jeng, want = runs["reference"]
    assert got == want, f"{family} {draft}: reference spec engine"
    assert got == runs["plain"][1], f"{family} {draft}: plain engine"
    if draft == "adversarial":        # the reference's own draft
        assert (eng.dispatches, eng.spec_proposed, eng.spec_accepted) == \
            (jeng.dispatches, jeng.spec_proposed, jeng.spec_accepted)
    assert eng.free_slots == 2 and eng._results == {}


def test_spec_stops_at_the_capacity(engine_runs):
    """A row whose prompt plus budget passes the capacity gets the tokens
    its ring holds, as the plain engine's does, though the round's chunk
    runs past it."""
    _, reqs, runs = engine_runs
    for name in ("plain", "adversarial", "self", "truncated"):
        streams = runs[name][1]
        for rid, (prompt, budget) in enumerate(reqs):
            assert len(streams[rid]) == min(budget,
                                            CAPACITY - len(prompt) + 1)
    assert len(runs["self"][1][3]) == CAPACITY - 40 + 1 < reqs[3][1]


def test_self_draft_accepts_everything(engine_runs):
    """The target as its own draft: every proposal accepted, per request
    as well, and fewer dispatches than the plain engine and the
    adversarial draft."""
    _, _, runs = engine_runs
    own, _, results = runs["self"]
    assert own.spec_proposed > 0 and own.spec_accepted == own.spec_proposed
    for r in results:
        assert r.draft_proposed > 0 and r.acceptance == 1.0
        assert r.draft_accepted == r.draft_proposed
    assert sum(r.draft_proposed for r in results) == own.spec_proposed
    assert own.dispatches < runs["plain"][0].dispatches
    assert own.dispatches < runs["adversarial"][0].dispatches
    adv = runs["adversarial"][0]
    assert adv.spec_accepted < adv.spec_proposed


def test_spec_reads_the_host_once_per_dispatch(engine_runs, monkeypatch):
    _, reqs, runs = engine_runs
    eng = runs["truncated"][0]
    calls = []
    real = engine_mod._to_host
    monkeypatch.setattr(engine_mod, "_to_host",
                        lambda x: calls.append(x.shape) or real(x))
    d0 = eng.dispatches
    eng.run([Request(prompt=p, max_new_tokens=m) for p, m in reqs[:2]])
    assert len(calls) == eng.dispatches - d0
    assert set(calls) == {(2, 2 * (eng.spec_tokens + 1) + 1)}


def test_gamma_zero_is_a_plain_tick():
    _, _, cfg, port = _pair("dense")
    _, _, _, other = _pair("dense", seed=9)
    reqs = [Request(prompt=p, max_new_tokens=m)
            for p, m in _requests(cfg.vocab_size)]
    plain = ServingEngine(port, cfg, slots=2, capacity=CAPACITY)
    base = _streams(plain.run(reqs))
    eng = ServingEngine(port, cfg, slots=2, capacity=CAPACITY,
                        draft_params=other, draft_cfg=cfg, spec_tokens=0)
    assert _streams(eng.run([Request(prompt=r.prompt,
                                     max_new_tokens=r.max_new_tokens)
                             for r in reqs])) == base
    assert eng.spec_proposed == 0 and eng.spec_accepted == 0
    assert eng.dispatches == plain.dispatches


def test_draft_state_after_rejections():
    """After rounds full of rejections, both states equal a sequential
    decode of the accepted stream: the hybrid, its 16-slot rings wrapped
    by a 20-token prompt, so a propose that left its writes behind (ring
    slots or recurrent leaves) would show."""
    _, _, cfg, port = _pair("hybrid")
    _, _, _, dport = _pair("hybrid", seed=9)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, 20)
    eng = ServingEngine(port, cfg, slots=1, capacity=CAPACITY,
                        draft_params=dport, draft_cfg=cfg, spec_tokens=2)
    eng.submit(Request(prompt=prompt, max_new_tokens=24))
    for _ in range(5):
        eng.step()
    [req] = [r for r in eng._active if r is not None]
    emitted = eng._results[req.rid].tokens
    assert eng.spec_accepted < eng.spec_proposed
    assert len(prompt) > cfg.sliding_window    # the rings have wrapped
    toks = torch.as_tensor(prompt)[None]
    for params, state in ((port, eng.state), (dport, eng.draft_state)):
        _, ref = models.prefill(params, cfg, toks, CAPACITY)
        for t in emitted[:-1]:
            _, ref = models.decode_step(params, cfg, ref,
                                        torch.tensor([[t]]))
        assert torch.equal(state.pos, ref.pos)
        want = flatten_with_paths(ref.cache)
        for path, leaf in flatten_with_paths(state.cache).items():
            torch.testing.assert_close(leaf, want[path], rtol=TOL, atol=TOL,
                                       msg=path)


def test_spec_gates():
    _, _, cfg, port = _pair("dense")
    spec = {"draft_params": port, "draft_cfg": cfg}
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(port, cfg, temperature=0.5, **spec)
    with pytest.raises(ValueError, match="ticks"):
        ServingEngine(port, cfg, ticks_per_dispatch=2, **spec)
    with pytest.raises(ValueError, match="BOTH"):
        ServingEngine(port, cfg, draft_params=port)
    with pytest.raises(ValueError, match="BOTH"):
        ServingEngine(port, cfg, draft_cfg=cfg)
    with pytest.raises(ValueError, match="spec_tokens"):
        ServingEngine(port, cfg, spec_tokens=-1, **spec)
    small = dataclasses.replace(cfg, vocab_size=cfg.vocab_size // 2)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(port, cfg, draft_params=port, draft_cfg=small)
    with pytest.raises(ValueError, match="speculative decoding"):
        ServingEngine(port, cfg, capacity=CAPACITY, block_size=8, **spec)
    vlm = reduced(ARCHS["phi-3-vision-4.2b"], 2, WIDTH)
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        ServingEngine(port, cfg, draft_params=port, draft_cfg=vlm)


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("olmo-1b", 2), ("rwkv6-7b", 2),
                                         ("recurrentgemma-9b", 3)])
def test_spec_streams_under_the_kernels_match_plain(cuda, arch, layers):
    """fp32 at d_model 256, head_dim 64: the spec engine's greedy streams
    with a 1-layer truncated draft (the hybrid: 2 rec layers) under the
    kernels equal those under the plain policy, and equal the plain
    engine's."""
    from repro_torch.kernels.common import KernelPolicy

    base = dataclasses.replace(reduced(ARCHS[arch], layers, 256),
                               head_dim=64, n_heads=4, sliding_window=32)
    params = models.init(base, torch.Generator().manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, base.vocab_size, n), 12) for n in (9, 40, 70)]
    streams = {}
    for policy in ("auto", "plain"):
        cfg = dataclasses.replace(base, kernels=KernelPolicy(policy))
        dcfg, dparams = spec_decode.truncated_draft(
            cfg, params, 2 if arch == "recurrentgemma-9b" else 1)
        for spec in (True, False):
            kw = {"draft_params": dparams, "draft_cfg": dcfg} if spec else {}
            eng = ServingEngine(params, cfg, slots=2, capacity=128, **kw)
            streams[policy, spec] = _streams(eng.run(
                [Request(prompt=p, max_new_tokens=m) for p, m in reqs]))
    assert streams["auto", True] == streams["plain", True]
    assert streams["auto", True] == streams["auto", False]
