"""The port's moe LM on its decode and serving paths, and its train CLI,
against the reference's.

Both packages run the reduced ``mixtral-8x7b`` (2 layers, d_model 64, 4
experts top-2; fp32 unless a test says bf16) from the same weights
(``weights.lm_from_reference``); the reference runs its XLA policy on the
CPU.  Prefill dispatches at the configured, dropping, capacity factor, so
its logits depend on which tokens (padding included) share the forward;
decode is dropless.  Logits and caches agree at 1e-4 (fp32 sums in
another order), greedy streams per rid exactly.
"""
import dataclasses
import functools
import shutil
import sys

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, models, weights
from repro_torch.checkpoint.checkpoint import step_dir
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import train as train_cli
from repro_torch.numerics import get_policy
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import spec_decode
from repro_torch.train_loop import read_jsonl
from repro_torch.tree import flatten_with_paths

try:
    import jax
    import jax.numpy as jnp

    from repro import models as jax_models
    from repro import numerics as jax_num
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.launch import train as jax_train_cli
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
except ImportError:      # a GPU host without JAX
    jax = None

TOL = 1e-4
WIDTH = 64
CAPACITY = 48
ARCH = "mixtral-8x7b"


@functools.lru_cache(maxsize=None)
def _pair(numerics="fp32", window=True):
    """(reference config, reference params, port config, port params):
    under the fp32 or the bf16 preset, with the reduced config's window
    of 64 or without one (the block pool takes full attention only)."""
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS[ARCH], 2, WIDTH),
                               kernels=JaxPolicy(backend="xla"),
                               numerics=jax_num.get_policy(numerics))
    cfg = dataclasses.replace(reduced(ARCHS[ARCH], 2, WIDTH),
                              numerics=get_policy(numerics))
    if not window:
        jcfg = dataclasses.replace(jcfg, sliding_window=None)
        cfg = dataclasses.replace(cfg, sliding_window=None)
    params = jax.jit(jax_models.init, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    port = weights.lm_from_reference(jax.tree.map(np.asarray, params), cfg,
                                     device="cpu")
    return jcfg, params, cfg, port


def _close_caches(jcache, cache):
    want = flatten_with_paths(jax.tree.map(np.asarray, jcache))
    got = flatten_with_paths(cache)
    assert sorted(got) == sorted(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(want[path], np.float32),
                                   rtol=TOL, atol=TOL, err_msg=path)


def test_prefill_decode_and_decode_seq_match_reference():
    """A right-padded prefill of 2 rows (lengths 20 and 13, at the
    dropping capacity), 3 decode steps, and one 4-token chunk committing
    [3, 1]: logits, every cache leaf and pos as the reference's."""
    jcfg, params, cfg, port = _pair()
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    length = np.asarray([20, 13], np.int32)
    jl, js = jax.jit(jax_models.prefill, static_argnums=(1, 3))(
        params, jcfg, jnp.asarray(prompt), CAPACITY,
        length=jnp.asarray(length))
    pl, ps = models.prefill(port, cfg, torch.from_numpy(prompt), CAPACITY,
                            length=torch.from_numpy(length))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _close_caches(js.cache, ps.cache)
    step = jax.jit(jax_models.decode_step, static_argnums=1)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jl, js = step(params, jcfg, js, jnp.asarray(tok))
        pl, ps = models.decode_step(port, cfg, ps, torch.from_numpy(tok))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
    _close_caches(js.cache, ps.cache)
    toks = rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    jl, js = jax.jit(jax_models.decode_seq, static_argnums=1)(
        params, jcfg, js, jnp.asarray(toks), jnp.asarray([3, 1], jnp.int32))
    pl, ps = models.decode_seq(port, cfg, ps, torch.from_numpy(toks),
                               torch.tensor([3, 1]))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=TOL,
                               atol=TOL)
    _close_caches(js.cache, ps.cache)
    assert ps.pos.tolist() == np.asarray(js.pos).tolist() == [26, 17]


def _prompts(vocab, seed=0):
    """Prompts of several lengths (several padding buckets) and budgets,
    two of them sharing a prefix."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, 18)
    prompts = [rng.integers(0, vocab, n) for n in (5, 11, 14, 7)]
    prompts += [base, base[:12].copy()]
    return list(zip(prompts, [6, 4, 8, 5, 7, 3]))


def _streams(results):
    return {r.rid: list(r.tokens) for r in results}


# (numerics, window, engine keywords): the ring in fp32 and under the
# bf16 preset (bf16 params and KV cache), and the block pool (full
# attention, as the reference's pool takes)
MODES = {"ring": ("fp32", True, {}), "ring_bf16": ("bf16", True, {}),
         "blocks": ("fp32", False, {"block_size": 8})}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_streams_match_reference_engine(mode):
    """The same greedy stream per rid as the reference engine, from 3
    slots and 6 requests of several prompt buckets."""
    numerics, window, kw = MODES[mode]
    jcfg, params, cfg, port = _pair(numerics, window)
    reqs = _prompts(cfg.vocab_size)
    jeng = JaxEngine(params, jcfg, slots=3, capacity=CAPACITY, **kw)
    want = _streams(jeng.run([JaxRequest(prompt=p, max_new_tokens=m)
                              for p, m in reqs]))
    eng = ServingEngine(port, cfg, slots=3, capacity=CAPACITY, **kw)
    got = _streams(eng.run([Request(prompt=p, max_new_tokens=m)
                            for p, m in reqs]))
    assert got == want
    assert eng.decode_steps == jeng.decode_steps


def test_spec_stream_equals_plain_decoding():
    """A moe target drafting with its own first layer: the greedy spec
    stream per rid is the plain engine's."""
    _, _, cfg, port = _pair()
    reqs = _prompts(cfg.vocab_size, seed=1)
    plain = ServingEngine(port, cfg, slots=3, capacity=CAPACITY)
    want = _streams(plain.run([Request(prompt=p, max_new_tokens=m)
                               for p, m in reqs]))
    dcfg, dparams = spec_decode.truncated_draft(cfg, port, 1)
    spec = ServingEngine(port, cfg, slots=3, capacity=CAPACITY,
                         draft_params=dparams, draft_cfg=dcfg,
                         spec_tokens=3)
    got = _streams(spec.run([Request(prompt=p, max_new_tokens=m)
                             for p, m in reqs]))
    assert got == want
    assert spec.spec_proposed > 0


def test_train_cli_loss_trace_matches_reference_cli(tmp_path, monkeypatch):
    """The reference CLI trains the reduced mixtral 4 steps, writing a
    checkpoint after step 2; the port's CLI resumes from it for steps 3
    and 4 on the same ``markov_lm`` batches: its losses (cross-entropy +
    aux) agree with the reference's (whose resume repeats its
    uninterrupted run, as its own tests hold)."""
    common = ["--arch", ARCH, "--smoke", "--layers", "1", "--d-model",
              str(WIDTH), "--seq-len", "16", "--batch", "4", "--replicas",
              "2", "--lr", "0.01", "--log-every", "1"]
    ref_ck = str(tmp_path / "ref")

    def ref_cli(*extra):
        monkeypatch.setattr(sys, "argv", ["train"] + common + list(extra))
        monkeypatch.delenv("REPRO_DEVICES", raising=False)
        jax_train_cli.main()

    ref_cli("--steps", "4", "--ckpt-dir", ref_ck, "--ckpt-every", "2",
            "--metrics-out", str(tmp_path / "ref.jsonl"))
    port_ck = str(tmp_path / "port")
    shutil.copytree(step_dir(ref_ck, 2), step_dir(port_ck, 2))
    assert checkpoint.latest_step(port_ck) == 2
    got = train_cli.main(common + ["--steps", "4", "--ckpt-dir", port_ck,
                                   "--resume", "--device", "cpu"])
    want = [r["loss"] for r in read_jsonl(str(tmp_path / "ref.jsonl"),
                                          "train")][2:]
    assert got.start_step == 2 and len(got.losses) == len(want) == 2
    np.testing.assert_allclose([v for _, v in got.losses], want,
                               rtol=TOL, atol=TOL)
