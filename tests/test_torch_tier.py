"""The port's serving tier in one process, against the reference's: the
``pack_tree`` container across the two packages, ``export_slot`` against
the reference's, drain and replay into a second engine, prefill-worker
snapshots, and the tier's refusals.  The multi-process layer on top is
``tests/test_torch_router.py``.

The reference runs live on the CPU under its XLA policy; weights come
from ``repro.models.init`` through ``weights.lm_from_reference``.  fp32,
reduced configs at d_model 64 (``olmo-1b --smoke --layers 2 --d-model
64``, ``rwkv6-7b`` at 2 layers, ``recurrentgemma-9b`` at one ``rec, rec,
attn`` superblock with a window of 16, so its ring wraps), 3 slots,
capacity 48.  Greedy streams must equal the reference's uninterrupted
ones; sampled streams (the port's counter-based draw cannot match
``jax.random``) must equal the port's own uninterrupted ones.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.serving import DrainingError, Request, ServingEngine
from repro_torch.serving import tier
from repro_torch.tree import flatten_with_paths

try:
    import jax

    from repro import checkpoint as jax_checkpoint
    from repro import models as jax_models
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

TOL = 1e-4
WIDTH = 64
SLOTS = 3
CAPACITY = 48
# (layers, config fields, kv cache dtype): the hybrid's window of 16 is
# shorter than its prompts, so its 16-slot ring wraps
MODELS = {"olmo-1b": (2, {}, "auto"),
          "olmo-1b-int8": (2, {}, "int8"),
          "rwkv6-7b": (2, {}, "auto"),
          "recurrentgemma-9b": (3, {"sliding_window": 16}, "auto")}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(reference config, reference params, port config, port params)."""
    layers, extra, kv = MODELS[name]
    arch = name.removesuffix("-int8")
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[arch], layers, WIDTH),
                               kernels=JaxPolicy(backend="xla"), **extra)
    jcfg = dataclasses.replace(jcfg, numerics=dataclasses.replace(
        jcfg.numerics, kv_cache_dtype=kv))
    cfg = dataclasses.replace(reduced(ARCHS[arch], layers, WIDTH), **extra)
    cfg = dataclasses.replace(cfg, numerics=dataclasses.replace(
        cfg.numerics, kv_cache_dtype=kv))
    params = jax_models.init(jax.random.PRNGKey(0), jcfg)
    port = weights.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return jcfg, params, cfg, port


def _requests(vocab, seed=0):
    """(prompt, new tokens) of 5 requests, 2 more than the slots, so that
    a drain after a few steps finds rows mid-stream and requests
    queued; prompts of 5 to 24 tokens, decodes past the window of 16."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n), m)
            for n, m in ((24, 10), (5, 14), (18, 6), (9, 12), (20, 8))]


@functools.lru_cache(maxsize=None)
def _reference_streams(name):
    """The reference engine's uninterrupted greedy streams, by prompt."""
    jcfg, params, _, _ = _pair(name)
    reqs = _requests(jcfg.vocab_size)
    eng = JaxEngine(params, jcfg, slots=SLOTS, capacity=CAPACITY)
    res = eng.run([JaxRequest(prompt=p, max_new_tokens=m) for p, m in reqs])
    assert len(res) == len(reqs)
    return {tuple(reqs[r.rid][0].tolist()): list(r.tokens) for r in res}


def _submit(eng, reqs):
    return {eng.submit(Request(prompt=p, max_new_tokens=m)): p
            for p, m in reqs}


def _peer(cfg, params, **kw):
    """An engine that has served one request, so that its next local rid
    (1) is not the rid a moved row was sampled with."""
    eng = ServingEngine(params, cfg, slots=SLOTS, capacity=CAPACITY, **kw)
    eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2)])
    return eng


def _drain_replay(cfg, params, reqs, steps, **kw):
    """Serve ``reqs`` on one engine for ``steps`` steps, drain it, carry
    its snapshots through ``pack_snapshot`` / ``unpack_snapshot`` into a
    peer (``_peer``), resubmit its queue there and finish: {prompt:
    tokens} over both engines."""
    eng1 = ServingEngine(params, cfg, slots=SLOTS, capacity=CAPACITY, **kw)
    prompts = _submit(eng1, reqs)
    out = {}
    for _ in range(steps):
        for res in eng1.step():
            out[tuple(prompts[res.rid].tolist())] = res.tokens
    snaps, queued = eng1.drain()
    assert snaps, "the drain must find rows mid-stream"
    assert len(snaps) + len(queued) + len(out) == len(reqs)   # none dropped
    assert eng1.load() == {"free_slots": SLOTS, "queue_len": 0, "active": 0,
                           "draining": True}
    like = tier.snapshot_like(cfg, CAPACITY)
    eng2 = _peer(cfg, params, **kw)
    moved = {}
    for snap in snaps:
        back = tier.unpack_snapshot(tier.pack_snapshot(snap), like)
        rid = eng2.import_snapshot(back)
        assert rid is not None
        moved[rid] = tuple(back["meta"]["prompt"])
    for q in queued:
        moved[eng2.submit(Request(prompt=q.prompt,
                                  max_new_tokens=q.max_new_tokens))] = \
            tuple(np.asarray(q.prompt).tolist())
    for res in eng2.run([]):
        out[moved[res.rid]] = res.tokens
    return out


# ----------------------------------------------------------- containers ----

LEAVES = {  # dtype: (port tensor, its reference dtype name)
    "float32": (torch.tensor([[1.5, -2.25, 3e-9], [0.0, -0.0, 7.0]]),
                "float32"),
    "bfloat16": (torch.tensor([1.5, -3.0, 1e-3], dtype=torch.bfloat16),
                 "bfloat16"),
    "int8": (torch.tensor([-128, -7, 0, 127], dtype=torch.int8), "int8"),
    "int32": (torch.tensor([[2 ** 31 - 1, -5]], dtype=torch.int32), "int32"),
    "int64": (torch.tensor(2 ** 40 + 3, dtype=torch.long), "int64"),
}


def _bits(t: torch.Tensor) -> bytes:
    return t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("dtype", sorted(LEAVES))
def test_pack_tree_crosses_packages_bit_for_bit(dtype):
    """A tree packed by the port unpacks in the reference and, packed
    again there, back in the port, the leaf bit for bit; a tree packed by
    the reference unpacks in the port; ``peek_meta`` reads the same meta
    from every buffer."""
    leaf, name = LEAVES[dtype]
    tree = {"a": {"x": leaf, "pad": torch.arange(3, dtype=torch.int32)},
            "b": (leaf.clone(),)}
    meta = {"rid": 41, "tokens": [3, 1, 4]}
    buf = checkpoint.pack_tree(tree, meta=meta)
    assert checkpoint.peek_meta(buf) == jax_checkpoint.peek_meta(buf) == meta
    with jax.enable_x64(True):       # keep the reference's int64 as int64
        jtree, jmeta = jax_checkpoint.unpack_tree(
            buf, jax.tree.map(np.asarray, {"a": {"x": 0, "pad": 0},
                                           "b": (0,)}))
        assert jmeta == meta
        assert str(jtree["a"]["x"].dtype) == name
        assert np.asarray(jtree["a"]["x"]).tobytes() == _bits(leaf)
        jbuf = jax_checkpoint.pack_tree(jtree, meta=jmeta)
    assert checkpoint.peek_meta(jbuf) == meta
    like = {"a": {"x": 0, "pad": 0}, "b": (0,)}
    for b in (buf, jbuf):
        back, bmeta = checkpoint.unpack_tree(b, like)
        assert bmeta == meta
        for path, want in flatten_with_paths(tree).items():
            got = flatten_with_paths(back)[path]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert _bits(got) == _bits(want), path


def test_unpack_tree_names_a_missing_leaf():
    buf = checkpoint.pack_tree({"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="'b'"):
        checkpoint.unpack_tree(buf, {"a": 0, "b": 0})


# ---------------------------------------------------------- export_slot ----

def test_export_slot_matches_the_reference():
    """After the same requests and steps, slot 0's exported cache leaves
    and pos equal the reference's (read through
    ``decode_state_from_reference``) at 1e-4, with the same tokens."""
    jcfg, params, cfg, port = _pair("olmo-1b")
    reqs = _requests(cfg.vocab_size)
    jeng = JaxEngine(params, jcfg, slots=SLOTS, capacity=CAPACITY)
    eng = ServingEngine(port, cfg, slots=SLOTS, capacity=CAPACITY)
    for p, m in reqs:
        jeng.submit(JaxRequest(prompt=p, max_new_tokens=m))
        eng.submit(Request(prompt=p, max_new_tokens=m))
    for _ in range(4):
        jeng.step()
        eng.step()
    jsnap, snap = jeng.export_slot(0), eng.export_slot(0)
    want = weights.decode_state_from_reference(
        types.SimpleNamespace(cache=jsnap["arrays"]["cache"],
                              pos=np.asarray(jsnap["arrays"]["pos"])),
        cfg, device="cpu")
    got = flatten_with_paths(snap["arrays"]["cache"])
    assert sorted(got) == sorted(flatten_with_paths(want.cache))
    for path, leaf in flatten_with_paths(want.cache).items():
        assert got[path].device.type == "cpu"
        np.testing.assert_allclose(got[path].float().numpy(),
                                   leaf.float().numpy(), rtol=TOL, atol=TOL,
                                   err_msg=path)
    assert torch.equal(snap["arrays"]["pos"], want.pos)
    assert snap["meta"]["tokens"] == jsnap["meta"]["tokens"]
    assert snap["meta"]["prompt"] == jsnap["meta"]["prompt"]
    assert int(snap["arrays"]["last_tok"][0, 0]) == snap["meta"]["tokens"][-1]
    assert int(snap["arrays"]["slot_key"]) == snap["meta"]["rid"] == 0
    with pytest.raises(ValueError, match="not active"):
        ServingEngine(port, cfg, slots=SLOTS, capacity=CAPACITY).export_slot(0)


# -------------------------------------------------------- drain / replay ----

@pytest.mark.parametrize("name", sorted(MODELS))
def test_drain_replay_equals_the_reference_uninterrupted(name):
    """Drain mid-stream, replay the snapshots (through the wire form) and
    the queue into a second engine: no request is dropped and every
    greedy stream equals the reference engine's uninterrupted one (dense,
    int8 KV cache, ssm, hybrid past its window)."""
    _, _, cfg, port = _pair(name)
    got = _drain_replay(cfg, port, _requests(cfg.vocab_size), steps=4)
    assert got == _reference_streams(name)


def test_sampled_handoff_equals_the_uninterrupted_stream():
    """At temperature 0.8, top-k 8, a drained row replayed into a peer
    whose own rids have moved on samples on with its sampling rid: the
    streams equal an uninterrupted run's, and a prefill worker's snapshot
    sampled with the rid the engine would have given continues that
    engine's stream."""
    _, _, cfg, port = _pair("olmo-1b")
    kw = {"temperature": 0.8, "top_k": 8, "seed": 5}
    reqs = _requests(cfg.vocab_size, seed=2)[:SLOTS]   # all admitted at once
    eng = ServingEngine(port, cfg, slots=SLOTS, capacity=CAPACITY, **kw)
    prompts = _submit(eng, reqs)
    want = {tuple(prompts[r.rid].tolist()): r.tokens for r in eng.run([])}
    assert _drain_replay(cfg, port, reqs, steps=3, **kw) == want
    # a drain at another step gives the same streams
    assert _drain_replay(cfg, port, reqs, steps=1, **kw) == want

    pw = tier.PrefillWorker(port, cfg, capacity=CAPACITY, temperature=0.8,
                            top_k=8, seed=5)
    dec = _peer(cfg, port, **kw)
    like = tier.snapshot_like(cfg, CAPACITY)
    moved = {}
    for rid, (p, m) in enumerate(reqs):
        wire = tier.request_to_wire(Request(prompt=p, max_new_tokens=m))
        wire["rid"] = rid
        snap = tier.unpack_snapshot(tier.pack_snapshot(pw.prefill(wire)),
                                    like)
        moved[dec.import_snapshot(snap)] = tuple(p.tolist())
    assert {moved[r.rid]: r.tokens for r in dec.run([])} == want


@pytest.mark.parametrize("name", ["olmo-1b", "rwkv6-7b",
                                  "recurrentgemma-9b"])
def test_prefill_worker_snapshots_give_the_colocated_stream(name):
    """Prefill-worker snapshots injected into a decode engine (which runs
    no prefill) continue the streams the reference's colocated engine
    emits."""
    _, _, cfg, port = _pair(name)
    reqs = _requests(cfg.vocab_size)
    pw = tier.PrefillWorker(port, cfg, capacity=CAPACITY)
    eng = ServingEngine(port, cfg, slots=len(reqs), capacity=CAPACITY)
    like = tier.snapshot_like(cfg, CAPACITY)
    moved = {}
    for rid, (p, m) in enumerate(reqs):
        wire = tier.request_to_wire(Request(prompt=p, max_new_tokens=m))
        wire["rid"] = rid
        buf = tier.pack_snapshot(pw.prefill(wire))
        assert checkpoint.peek_meta(buf)["rid"] == rid
        moved[eng.import_snapshot(tier.unpack_snapshot(buf, like))] = \
            tuple(p.tolist())
    assert pw.prefills == len(reqs)
    assert eng.prefill_compiles == 0          # the engine ran no prefill
    assert {moved[r.rid]: r.tokens for r in eng.run([])} == \
        _reference_streams(name)


def test_import_snapshot_needs_a_free_slot():
    _, _, cfg, port = _pair("olmo-1b")
    reqs = _requests(cfg.vocab_size)
    eng = ServingEngine(port, cfg, slots=1, capacity=CAPACITY)
    _submit(eng, reqs[:1])
    eng.step()
    snap = eng.export_slot(0)
    assert eng.import_snapshot(snap) is None


# ------------------------------------------------------------ refusals ----

def test_submit_while_draining_raises():
    _, _, cfg, port = _pair("olmo-1b")
    eng = ServingEngine(port, cfg, slots=2, capacity=CAPACITY)
    assert eng.drain() == ([], [])
    with pytest.raises(DrainingError):
        eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=2))


def test_drain_refuses_the_block_pool_and_spec_engines():
    """As the reference refuses them: a block table indexes a
    process-local pool, and a spec engine would need its draft state
    exported too."""
    _, _, cfg, port = _pair("olmo-1b")
    eng = ServingEngine(port, cfg, slots=2, capacity=CAPACITY, block_size=8)
    with pytest.raises(NotImplementedError, match="block-pool"):
        eng.drain()
    spec = ServingEngine(port, cfg, slots=2, capacity=CAPACITY,
                         draft_params=port, draft_cfg=cfg, spec_tokens=2)
    with pytest.raises(NotImplementedError, match="spec engine"):
        spec.drain()
    assert not eng.load()["draining"] and not spec.load()["draining"]


def test_wire_refuses_an_image_request():
    with pytest.raises(NotImplementedError, match="token requests only"):
        tier.request_to_wire(Request(prompt=[1, 2], max_new_tokens=4,
                                     image=np.zeros((8, 8, 3), np.float32)))
    wire = tier.request_to_wire(Request(prompt=np.array([3, 4]),
                                        max_new_tokens=5))
    assert wire == {"prompt": [3, 4], "max_new_tokens": 5, "rid": -1}
    back = tier.request_from_wire(wire)
    assert back.prompt.tolist() == [3, 4] and back.max_new_tokens == 5


def test_prefill_worker_refuses_the_conv_family():
    from repro_torch.configs import ALEXNET_SMOKE
    with pytest.raises(NotImplementedError, match="token requests"):
        tier.PrefillWorker(None, ALEXNET_SMOKE, capacity=CAPACITY)
