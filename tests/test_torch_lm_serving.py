"""The port's LM serving against the reference's: the block manager, the
continuous-batching engine (ring cache, block pool, multi-tick dispatch)
and the serve CLI.

Both engines serve the reduced ``olmo-1b`` (fp32) from the same weights
(``weights.lm_from_reference``) and the same prompts; the reference runs
its XLA path.  Greedy streams must be equal per rid.  Sampled streams
use the port's counter-based draw and cannot match ``jax.random``: they
are checked within the port only.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import models, weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.serving import BlockManager, Request, ServingEngine
from repro_torch.serving import blocks as blk
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import sample_slots

try:
    import jax

    from repro import models as jax_models
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.serving import BlockManager as JaxBlockManager
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
CAPACITY = 64


@pytest.fixture(scope="module")
def pair():
    """(reference config, reference params, port config, port params)."""
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS["olmo-1b"]),
                               kernels=JaxPolicy(backend="xla"))
    cfg = reduced(ARCHS["olmo-1b"])
    params = jax_models.init(jax.random.PRNGKey(0), jcfg)
    port = weights.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return jcfg, params, cfg, port


def _prompts(vocab, seed=0):
    """Prompts and budgets: fresh prompts, two sharing a 16-token prefix,
    an exact repeat of one of them (a zero-forward admission in block
    mode) and a prefix of it."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, 20)
    prompts = [rng.integers(0, vocab, n) for n in (5, 9, 13, 7)]
    prompts += [np.concatenate([base[:16], rng.integers(0, vocab, 3)]),
                base, base.copy(), base[:12]]
    return list(zip(prompts, [6, 3, 8, 5, 4, 7, 7, 3]))


def _streams(results):
    return {r.rid: list(r.tokens) for r in results}


@pytest.fixture(scope="module")
def reference_runs(pair):
    """The reference engine's greedy streams and counters, per mode."""
    jcfg, params, _, _ = pair
    out = {}
    for mode, kw in MODES.items():
        eng = JaxEngine(params, jcfg, slots=3, capacity=CAPACITY, **kw)
        res = eng.run([JaxRequest(prompt=p, max_new_tokens=m)
                       for p, m in _prompts(jcfg.vocab_size)])
        out[mode] = {"streams": _streams(res),
                     "prefill_compiles": eng.prefill_compiles,
                     "decode_steps": eng.decode_steps,
                     "skipped": (eng.block_mgr.prefills_skipped
                                 if eng.block_mgr else 0)}
    return out


MODES = {"ring": {}, "ticks4": {"ticks_per_dispatch": 4},
         "blocks": {"block_size": 8}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_matches_reference_engine(pair, reference_runs, mode,
                                         monkeypatch):
    """The same greedy stream per rid, the same prefill buckets and decode
    ticks; one host read per dispatch; in block mode the exact repeat
    admits with no forward (one prefill fewer)."""
    _, _, cfg, port = pair
    want = reference_runs[mode]
    calls = {"to_host": 0, "prefill": 0}
    to_host, prefill = engine_mod._to_host, models.prefill

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(engine_mod, "_to_host", count("to_host", to_host))
    monkeypatch.setattr(models, "prefill", count("prefill", prefill))
    eng = ServingEngine(port, cfg, slots=3, capacity=CAPACITY, **MODES[mode])
    reqs = _prompts(cfg.vocab_size)
    results = eng.run([Request(prompt=p, max_new_tokens=m) for p, m in reqs])
    assert _streams(results) == want["streams"]
    assert eng.prefill_compiles == want["prefill_compiles"]
    assert eng.decode_steps == want["decode_steps"]
    assert calls["to_host"] == eng.dispatches
    assert eng.decode_steps == eng.dispatches * eng.ticks
    skipped = eng.block_mgr.prefills_skipped if eng.block_mgr else 0
    assert skipped == want["skipped"] and (mode != "blocks" or skipped == 1)
    assert calls["prefill"] == len(reqs) - skipped
    assert eng._results == {} and eng.free_slots == 3


def test_temperature_streams_do_not_depend_on_the_dispatch(pair):
    """Positional sampling: the same sampled streams for K = 1 and K = 4
    and for another slot count; another seed draws others."""
    _, _, cfg, port = pair

    def run(seed=3, **kw):
        eng = ServingEngine(port, cfg, capacity=CAPACITY, temperature=1.5,
                            top_k=20, seed=seed, **kw)
        return _streams(eng.run([Request(prompt=p, max_new_tokens=m)
                                 for p, m in _prompts(cfg.vocab_size)]))

    one = run(slots=3)
    assert run(slots=3, ticks_per_dispatch=4) == one
    assert run(slots=2) == one
    assert run(seed=4, slots=3) != one


def test_capacity_retires_a_full_ring(pair, reference_runs):
    """A row retires when its ring is full: a prompt of 60 in a capacity
    of 64 yields 5 tokens whatever its budget, as in the reference."""
    jcfg, params, cfg, port = pair
    prompt = np.arange(60) % cfg.vocab_size
    ref = JaxEngine(params, jcfg, slots=2, capacity=CAPACITY).run(
        [JaxRequest(prompt=prompt, max_new_tokens=50)])
    got = ServingEngine(port, cfg, slots=2, capacity=CAPACITY).run(
        [Request(prompt=prompt, max_new_tokens=50)])
    assert len(got[0].tokens) == 5 == len(ref[0].tokens)
    assert got[0].tokens == ref[0].tokens


def test_eos_retires_the_row(pair):
    _, _, cfg, port = pair
    first = ServingEngine(port, cfg, slots=1, capacity=CAPACITY).run(
        [Request(prompt=[1, 2, 3], max_new_tokens=8)])[0].tokens
    # eos is checked on decoded tokens, not on the prefill's first one
    stop = next(j for j in range(1, 3) if first[j] == first[2])
    for k in (1, 4):
        eng = ServingEngine(port, cfg, slots=1, capacity=CAPACITY,
                            eos_id=first[2], ticks_per_dispatch=k)
        got = eng.run([Request(prompt=[1, 2, 3], max_new_tokens=8)])
        assert got[0].tokens == first[:stop + 1]


def test_sample_slots_is_positional():
    """A row's draw depends on (seed, rid, pos) only; greedy is argmax with
    the first maximum winning; top-k keeps the draw in the top k."""
    logits = torch.randn(4, 100, generator=torch.Generator().manual_seed(0))
    rids, pos = torch.tensor([0, 1, 2, 3]), torch.tensor([5, 5, 9, 9])
    a = sample_slots(7, rids, pos, logits, 2.0, 5)
    b = sample_slots(7, rids.flip(0), pos.flip(0), logits.flip(0), 2.0, 5)
    assert torch.equal(a, b.flip(0))
    top = torch.topk(logits, 5, dim=-1).indices
    for seed in range(20):
        d = sample_slots(seed, rids, pos, logits, 3.0, 5)
        assert all(d[i].item() in top[i].tolist() for i in range(4))
    draws = {sample_slots(s, rids, pos, logits, 1.0)[0].item()
             for s in range(40)}
    assert len(draws) > 5
    tie = torch.tensor([[0.0, 3.0, 3.0, 1.0]])
    assert sample_slots(0, rids[:1], pos[:1], tie).tolist() == [1]


# ------------------------------------------------------- block manager ----

def _manager_script(m):
    """Admissions, finishes and releases in the reference test's order,
    eviction included; returns every observable."""
    seen = []
    a = m.admit([1, 2, 3, 4, 5], n_k=2)
    m.finish(a, first_token=1)
    seen.append((a.table, a.snapshot, m.in_use, len(m.prompts)))
    b = m.admit([9, 9], n_k=2)                   # evicts a's snapshot
    m.finish(b, first_token=2)
    seen.append((b.table, b.snapshot, m.in_use, len(m.prompts)))
    seen.append(m.admit([8, 8], n_k=2))          # truly full: None
    m.release(a)
    m.release(b)
    for prompt in ([9, 9], [9, 9], [1, 2, 3, 4, 7], [1, 2, 3, 4, 7, 1]):
        adm = m.admit(prompt, n_k=2)
        seen.append(None if adm is None else (adm.table, adm.n_shared,
                                              adm.cow, adm.first_token))
        if adm is not None and adm.first_token is None:
            m.finish(adm, first_token=3)
    seen.append((sorted(m.ref.items()), sorted(m.free), m.peak,
                 m.prefills_skipped, len(m.prompts)))
    return seen


def test_block_manager_matches_reference():
    assert _manager_script(BlockManager(6, 4)) == \
        _manager_script(JaxBlockManager(6, 4))
    big = [(BlockManager(32, 4), JaxBlockManager(32, 4))]
    for port, ref in big:
        for prompt in ([1, 2, 3, 4, 5, 6, 7, 8, 9], [1, 2, 3, 4, 5, 6, 7, 8,
                                                     7, 7],
                       [1, 2, 3, 4, 5, 6, 7, 8, 9]):
            pa, ra = port.admit(prompt, 4), ref.admit(prompt, 4)
            assert (pa.table, pa.n_shared, pa.cow, pa.first_token) == \
                (ra.table, ra.n_shared, ra.cow, ra.first_token)
            if pa.first_token is None:
                port.finish(pa, 42)
                ref.finish(ra, 42)
        assert port.ref == ref.ref and port.free == ref.free
        assert port.prefills_skipped == ref.prefills_skipped == 1


def test_block_device_ops_write_in_place(pair):
    _, _, cfg, port = pair
    state = blk.init_blocked_state(cfg, 5, 8, slots=2, device="cpu")
    logits, sub = models.prefill(port, cfg, torch.arange(10)[None], 16)
    k = state.cache["blocks"][0]["k"]
    blk.write_prefill(state, sub, [3, 1], slot=1, block_size=8)
    assert state.pos.tolist() == [0, 10]
    ring = sub.cache["blocks"][0]["k"][:, 0]
    assert torch.equal(k[:, 3], ring[:, :8]) and torch.equal(k[:, 1],
                                                              ring[:, 8:])
    blk.copy_block(state, 4, 3)
    assert torch.equal(k[:, 4], k[:, 3])
    assert state.cache["blocks"][0]["k"] is k


def test_block_mode_gates(pair):
    _, _, cfg, port = pair
    with pytest.raises(ValueError, match="multi-tick"):
        ServingEngine(port, cfg, capacity=CAPACITY, block_size=8,
                      ticks_per_dispatch=2)
    with pytest.raises(ValueError, match="not a multiple"):
        ServingEngine(port, cfg, capacity=60, block_size=8)
    swa = dataclasses.replace(cfg, sliding_window=16)
    with pytest.raises(NotImplementedError, match="full attention"):
        ServingEngine(port, swa, capacity=CAPACITY, block_size=8)
    eng = ServingEngine(port, cfg, slots=1, capacity=CAPACITY, block_size=8,
                        num_blocks=4)
    with pytest.raises(RuntimeError, match="cannot host one request"):
        eng.run([Request(prompt=[1, 2, 3], max_new_tokens=2)])


def test_what_is_not_ported_raises(pair):
    _, _, cfg, port = pair
    # speculative decoding is ported; the reference's gates hold: greedy
    # only, and not on the block pool
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(port, cfg, temperature=1.0, draft_params=port,
                      draft_cfg=cfg)
    with pytest.raises(ValueError, match="speculative decoding"):
        ServingEngine(port, cfg, capacity=CAPACITY, block_size=8,
                      draft_params=port, draft_cfg=cfg)
    with pytest.raises(NotImplementedError, match="item 12"):
        ServingEngine(port, cfg, mesh=object())
    # the tier's handoff is ported; the reference's drain refusals hold
    with pytest.raises(NotImplementedError, match="block-pool"):
        ServingEngine(port, cfg, capacity=CAPACITY, block_size=8).drain()
    with pytest.raises(NotImplementedError, match="spec engine"):
        ServingEngine(port, cfg, capacity=CAPACITY, draft_params=port,
                      draft_cfg=cfg).drain()
    eng = ServingEngine(port, cfg, capacity=CAPACITY)
    with pytest.raises(ValueError, match="not active"):
        eng.export_slot(0)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(prompt=[]))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        eng.submit(Request(prompt=list(range(CAPACITY + 1))))


# ------------------------------------------------------------------- CLI --

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("extra", [[], ["--block-size", "8"],
                                   ["--ticks-per-dispatch", "4"],
                                   ["--kv-cache-dtype", "int8"]], ids=str)
def test_cli_serves_an_lm_on_the_cpu(extra):
    proc = _cli("--arch", "olmo-1b", "--smoke", "--device", "cpu",
                "--requests", "5", "--slots", "2", "--capacity", "64",
                "--max-new", "6", *extra)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "serve OK"
    assert "served 5 requests / 30 tokens" in proc.stdout
    assert "generated tok/s" in proc.stdout and "ttft p50" in proc.stdout
    if extra[:1] == ["--block-size"]:
        assert "blocks: peak" in proc.stdout


def test_cli_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    proc = _cli("--arch", "olmo-1b", "--smoke", "--requests", "1")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "serve OK" not in proc.stdout
