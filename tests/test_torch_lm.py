"""The port's dense LM against the reference's: layers, the model's
logits, loss and grads, the parameter-averaging trainer, the data
stream, the weight bridge, checkpoints and the CLI.

The reference runs live on the CPU: ``repro.models.logits_fn`` /
``loss_fn`` with its flash kernels in interpret mode
(``KernelPolicy(attention="flash", interpret=True)``) and on its XLA
path; the port runs the plain attention.  Weights come from
``repro.models.init`` through ``weights.lm_from_reference``, batches
from numpy.  All fp32, reduced configs.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, models, weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import param_avg, steps
from repro_torch.data import synthetic
from repro_torch.launch import train as train_cli
from repro_torch.models import layers, transformer
from repro_torch.numerics import NumericsPolicy, param_dtype
from repro_torch.optim import optimizers, schedules
from repro_torch.train_loop import lm_metrics, read_jsonl
from repro_torch.tree import (flatten_with_paths, tree_leaves, tree_map,
                              unflatten_like)

try:
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jax_ckpt
    from repro import core as jax_core
    from repro import models as jax_models
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from repro.data import synthetic as jax_synth
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.models import layers as jax_layers
    from repro.optim import optimizers as jax_opt
    from repro.optim import schedules as jax_sched
    from repro.train_loop import eval as jax_eval
except ImportError:
    jax = None

TOL = 1e-4
TRACE_DRIFT = 5e-3       # test_golden_traces.py's cross-backend tolerance
SEQ = 64
# the reduced configs, and what each exercises: olmo np_ln + gelu + tied
# embeddings; gemma-swa rmsnorm + geglu + a window (32, so that it masks
# at S=64: reduced() would give 64); minitron layernorm + swiglu + GQA 2
MODELS = {"olmo-1b": {}, "gemma-7b-swa": {"sliding_window": 32},
          "minitron-8b": {"n_kv_heads": 2}}


def _pair(name, **kw):
    extra = dict(MODELS.get(name, {}), **kw)
    return (dataclasses.replace(jax_reduced(JAX_ARCHS[name]), **extra),
            dataclasses.replace(reduced(ARCHS[name]), **extra))


def _tokens(cfg, shape, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    tree_map(lambda g, w: np.testing.assert_allclose(
        g.detach().float().numpy(), np.asarray(w, np.float32), rtol=tol,
        atol=tol), got, want)


# ----------------------------------------------------------------- layers --

@pytest.mark.parametrize("norm", ["np_ln", "layernorm", "rmsnorm"])
def test_norms_match_reference(norm):
    cfg = dataclasses.replace(reduced(ARCHS["olmo-1b"]), norm=norm)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, cfg.d_model)) * 3 + 1).astype(np.float32)
    p = {k: (rng.normal(size=(cfg.d_model,)) + 1).astype(np.float32)
         for k in layers.norm_init(cfg, torch.float32, "cpu")}
    want = jax_layers.norm_apply(p, cfg, jnp.asarray(x))
    got = layers.norm_apply(tree_map(torch.from_numpy, p), cfg,
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mlp", ["gelu", "swiglu", "geglu"])
def test_mlps_match_reference(mlp):
    cfg = dataclasses.replace(reduced(ARCHS["olmo-1b"]), mlp=mlp)
    p = layers.mlp_init(cfg, torch.Generator().manual_seed(0),
                        torch.float32, "cpu")
    x = np.random.default_rng(1).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    want = jax_layers.mlp_apply(tree_map(lambda t: jnp.asarray(t.numpy()), p),
                                cfg, jnp.asarray(x))
    got = layers.mlp_apply(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rope_and_masked_xent_match_reference():
    cfg = reduced(ARCHS["olmo-1b"])
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, cfg.head_dim)).astype(np.float32)
    pos = np.arange(7)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                 jax_layers.rope_freqs(cfg))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            layers.rope_freqs(cfg, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    logits = rng.normal(size=(2, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.3).astype(np.float32)
    for m in (None, mask):
        want = jax_layers.softmax_xent(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m))
        got = layers.softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  None if m is None else torch.from_numpy(m))
        assert float(got) == pytest.approx(float(want), abs=1e-6)


# ------------------------------------------------------------------ model --

@pytest.mark.parametrize("policy", ["flash", "xla"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_matches_reference(name, policy):
    """Logits, loss and every param grad at 1e-4 (fp32, S=64)."""
    jcfg, cfg = _pair(name)
    jcfg = dataclasses.replace(jcfg, kernels=JaxPolicy(attention=policy,
                                                       interpret=True))
    params = jax_models.init(jax.random.PRNGKey(0), jcfg)
    batch = _tokens(jcfg, (2, SEQ), seed=1)
    jb = jax.tree.map(jnp.asarray, batch)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jax_models.loss_fn(p, jcfg, jb))(params)
    want_logits, _ = jax_models.logits_fn(params, jcfg, jb)

    p = weights.lm_from_reference(_host(params), cfg, device="cpu")
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_()
    tb = tree_map(torch.from_numpy, batch)
    logits, aux = models.logits_fn(p, cfg, tb)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=TOL, atol=TOL)
    loss = models.loss_fn(p, cfg, tb)
    assert loss.item() == pytest.approx(float(want_loss), abs=TOL)
    grads = unflatten_like(p, dict(zip(flatten_with_paths(p),
                                       torch.autograd.grad(loss, leaves))))
    _close(grads, want_grads)


def test_full_width_olmo_shapes():
    """The published olmo-1b: 908,328,960 params in the reference's
    layout, bf16, with the port's shapes tallied without allocating."""
    cfg = ARCHS["olmo-1b"]
    assert cfg.n_params() == 908_328_960
    assert cfg.n_params() == JAX_ARCHS["olmo-1b"].n_params()
    shapes = transformer.param_shapes(cfg)

    def tally(t):
        if isinstance(t, dict):
            return sum(tally(v) for v in t.values())
        if t and all(isinstance(i, int) for i in t):
            return math.prod(t)
        return sum(tally(v) for v in t)

    assert tally(shapes) == cfg.n_params()
    assert shapes["blocks"][0]["attn"]["wq"] == (16, 2048, 16, 128)
    assert shapes["final_norm"] == {} and shapes["rem_blocks"] == ()
    assert param_dtype(cfg) == torch.bfloat16
    # the policy's param_dtype wins over the config's dtype (the numerics
    # slice ported the rest of the policy; nothing raises any more)
    assert param_dtype(dataclasses.replace(
        cfg, dtype="float32", numerics=NumericsPolicy(
            param_dtype="bfloat16", master_weights=True))) == torch.bfloat16


def test_lm_metrics_match_reference():
    jcfg, cfg = _pair("olmo-1b")
    params = _host(jax_models.init(jax.random.PRNGKey(2), jcfg))
    batch = _tokens(jcfg, (2, 32), seed=3)
    want = jax_eval.lm_metrics(jcfg)(params, jax.tree.map(jnp.asarray,
                                                          batch))
    got = lm_metrics(cfg)(weights.lm_from_reference(params, cfg,
                                                    device="cpu"),
                          tree_map(torch.from_numpy, batch))
    for k in ("loss", "perplexity"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5)


# ---------------------------------------------------------------- trainer --

@pytest.mark.parametrize("sync_every", [1, 2])
@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
def test_param_avg_steps_match_reference(opt, sync_every):
    """3 steps of the paper's step on reduced olmo-1b, R=2: the loss of
    every step, then params and optimizer state.  AdamW runs at OLMo-1B's
    published peak LR, 4e-4 (arXiv:2402.00838): its update is about
    +-lr per element whatever the grad's size, so at SGD's 0.01 a
    near-zero grad whose sign differs in the last fp32 bits between the
    two frameworks moves a weight by up to 0.02."""
    lr = 0.01 if opt == "sgd_momentum" else 4e-4
    jcfg, cfg = _pair("olmo-1b")
    jstate = jax_core.init_param_avg_state(
        jax.random.PRNGKey(0), lambda r: jax_models.init(r, jcfg),
        jax_opt.get_optimizer(opt), 2)
    state = weights.state_from_reference(jstate, cfg, device="cpu")
    jstep = jax.jit(jax_core.make_param_avg_step(
        lambda p, b: jax_models.loss_fn(p, jcfg, b),
        jax_opt.get_optimizer(opt), jax_sched.constant(lr),
        strategy="all_reduce", sync_every=sync_every))
    step = steps.make_param_avg_step(
        lambda p, b: models.loss_fn(p, cfg, b), optimizers.get_optimizer(opt),
        schedules.constant(lr), strategy="all_reduce",
        sync_every=sync_every)
    for i in range(3):
        batch = _tokens(jcfg, (2, 2, 32), seed=10 + i)
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(torch.from_numpy, batch))
        assert abs(loss.item() - float(jloss)) <= TOL
    assert state.step == int(jstate.step) == 3
    _close(state.params, jstate.params)
    _close(state.opt_state, jstate.opt_state)
    assert (param_avg.replica_spread(state.params) == 0.0) == \
        (sync_every == 1)


def test_twenty_step_trace_matches_reference():
    """The golden-trace protocol for olmo_1b (plain SGD momentum 0.9,
    LR 0.01, batch 4 x 32 tokens) run live on both sides."""
    jcfg, cfg = _pair("olmo-1b")
    params = jax_models.init(jax.random.PRNGKey(0), jcfg)
    mom = jax.tree.map(jnp.zeros_like, params)

    @jax.jit
    def jstep(params, mom, batch):
        loss, g = jax.value_and_grad(
            lambda p: jax_models.loss_fn(p, jcfg, batch))(params)
        mom = jax.tree.map(lambda m, d: 0.9 * m + d, mom, g)
        params = jax.tree.map(lambda p, m: p - 0.01 * m, params, mom)
        return params, mom, loss

    host = _host(params)
    opt = optimizers.sgd_momentum(momentum=0.9, weight_decay=0.0)
    state = steps.init_param_avg_state(
        None, lambda _: weights.lm_from_reference(host, cfg, device="cpu"),
        opt, 1)
    step = steps.make_param_avg_step(lambda p, b: models.loss_fn(p, cfg, b),
                                     opt, schedules.constant(0.01),
                                     strategy="none")
    want, got = [], []
    for i in range(20):
        batch = _tokens(jcfg, (4, 32), seed=100 + i)
        params, mom, jloss = jstep(params, mom,
                                   jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(
            lambda x: torch.from_numpy(x)[None], batch))
        want.append(float(jloss))
        got.append(loss.item())
    drift = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    print(f"olmo_1b: 20-step max loss drift {drift:.3e}")
    assert np.all(np.isfinite(got))
    assert drift <= TRACE_DRIFT


# ------------------------------------------------------------------- data --

@pytest.mark.parametrize("vocab,sample_seed", [(512, None), (512, 9),
                                               (5000, None), (5000, 3)])
def test_markov_lm_is_bit_identical(vocab, sample_seed):
    kw = dict(seed=4, sample_seed=sample_seed)
    mine = synthetic.markov_lm(vocab, 3, 20, **kw)
    theirs = jax_synth.markov_lm(vocab, 3, 20, **kw)
    for _ in range(2):
        a, b = next(mine), next(theirs)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# -------------------------------------------------- bridge and checkpoints --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_cross_the_bridge_bit_for_bit(dtype):
    jcfg, cfg = _pair("minitron-8b", dtype=dtype)
    params = _host(jax_models.init(jax.random.PRNGKey(5), jcfg))
    port = weights.lm_from_reference(params, cfg, device="cpu")
    assert all(str(t.dtype) == f"torch.{dtype}" for t in tree_leaves(port))
    back = weights.lm_to_reference(port)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="expected"):
        weights.lm_from_reference(params, dataclasses.replace(cfg, d_ff=96),
                                  device="cpu")


def _ref_state(jcfg, opt, seed=0):
    return jax_core.init_param_avg_state(
        jax.random.PRNGKey(seed), lambda r: jax_models.init(r, jcfg),
        jax_opt.get_optimizer(opt), 2)


@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
def test_train_state_crosses_the_bridge_bit_for_bit(opt):
    jcfg, cfg = _pair("olmo-1b", dtype="bfloat16")
    jstate = _ref_state(jcfg, opt)
    state = weights.state_from_reference(jstate, cfg, device="cpu")
    assert state.params["embed"]["tok"].dtype == torch.bfloat16
    assert all(t.dtype in (torch.float32, torch.int32)
               for t in tree_leaves(state.opt_state))
    back = jax_core.TrainState(**weights.state_to_reference(state))
    for a, b in zip(jax.tree.leaves((back.params, back.opt_state,
                                     back.step)),
                    jax.tree.leaves((jstate.params, jstate.opt_state,
                                     jstate.step))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
def test_lm_checkpoints_cross_both_ways(tmp_path, opt):
    """bf16 params, fp32 optimizer state: a reference checkpoint restores
    in the port and a port checkpoint in the reference, bit for bit."""
    jcfg, cfg = _pair("olmo-1b", dtype="bfloat16")
    jstate = dataclasses.replace(_ref_state(jcfg, opt, seed=1),
                                 step=jnp.asarray(4, jnp.int32))
    jax_ckpt.save(str(tmp_path / "ref"), 4, jstate)
    like = weights.state_from_reference(_ref_state(jcfg, opt, seed=2), cfg,
                                        device="cpu")
    got = checkpoint.restore(str(tmp_path / "ref"), 4, like)
    want = weights.state_from_reference(jstate, cfg, device="cpu")
    assert got.step == 4
    tree_map(lambda a, b: (a.dtype == b.dtype and torch.equal(
        a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
        b.view(torch.int16) if b.dtype == torch.bfloat16 else b))
        or pytest.fail("restored leaf differs"),
        (got.params, got.opt_state), (want.params, want.opt_state))

    checkpoint.save(str(tmp_path / "port"), 4, got)
    back = jax_ckpt.restore(str(tmp_path / "port"), 4,
                            _ref_state(jcfg, opt, seed=3))
    for a, b in zip(jax.tree.leaves((back.params, back.opt_state)),
                    jax.tree.leaves((jstate.params, jstate.opt_state))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_tree_paths_keep_tuples_and_empty_nodes():
    """``blocks`` / ``rem_blocks`` tuples and the empty ``{}`` of np_ln:
    the same keys as the reference checkpoint's flattening, and
    ``unflatten_like`` rebuilds the empty nodes."""
    from repro.checkpoint.checkpoint import _flatten
    cfg = reduced(ARCHS["olmo-1b"])
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    keys = flatten_with_paths(params)
    assert sorted(keys) == sorted(_flatten(jax.tree.map(
        lambda t: np.zeros(1), weights.lm_to_reference(params))))
    assert "blocks/0/attn/wq" in keys and not any("norm" in k for k in keys)
    again = unflatten_like(params, keys)
    assert again["final_norm"] == {} and again["rem_blocks"] == ()
    assert again["blocks"][0]["norm1"] == {}


# -------------------------------------------------------------------- CLI --

CLI = ["--arch", "olmo-1b", "--smoke", "--seq-len", "32", "--batch", "4",
       "--replicas", "2", "--device", "cpu", "--log-every", "100"]


def test_lm_cli_resume_repeats_an_uninterrupted_run(tmp_path):
    """6 steps straight, and 3 + resume + 3, give bit-identical losses
    and params (CPU, in-process CLI)."""
    straight = train_cli.main(CLI + ["--steps", "6", "--metrics-out",
                                     str(tmp_path / "a.jsonl")])
    ck = str(tmp_path / "ck")
    path = str(tmp_path / "b.jsonl")
    first = train_cli.main(CLI + ["--steps", "3", "--ckpt-dir", ck,
                                  "--ckpt-every", "3", "--metrics-out", path,
                                  "--eval-every", "3", "--eval-batches", "1"])
    resumed = train_cli.main(CLI + ["--steps", "6", "--ckpt-dir", ck,
                                    "--resume", "--metrics-out", path])
    assert (first.final_step, resumed.start_step, resumed.final_step) == \
        (3, 3, 6)
    assert first.evals[0][1]["perplexity"] == pytest.approx(
        math.exp(first.evals[0][1]["loss"]), rel=1e-5)
    want = [r["loss"] for r in read_jsonl(str(tmp_path / "a.jsonl"),
                                          "train")]
    got = [r["loss"] for r in read_jsonl(path, "train")]
    assert len(want) == 6 and got == want
    tree_map(lambda a, b: torch.equal(a, b) or pytest.fail("params differ"),
             resumed.state.params, straight.state.params)


@pytest.mark.parametrize("extra,exc,match", [
    (["--arch", "phi-3-vision-4.2b"], NotImplementedError,
     "ROADMAP.md queue A item 8"),
    (["--arch", "seamless-m4t-medium"], NotImplementedError, "ROADMAP.md"),
    (["--attn-impl", "chunked"], NotImplementedError, "ROADMAP.md"),
])
def test_lm_cli_refuses_what_is_not_ported(extra, exc, match):
    with pytest.raises(exc, match=match):
        train_cli.main(CLI + ["--steps", "1"] + extra)


def test_lm_cli_cuts_depth_at_full_width_only(capsys):
    with pytest.raises(SystemExit):
        train_cli.main([a for a in CLI if a != "--smoke"]
                       + ["--d-model", "128", "--steps", "1"])
    args = train_cli.build_parser().parse_args(
        ["--arch", "olmo-1b", "--layers", "3"])
    cfg = train_cli.build_cfg(args, pytest.fail)
    assert (cfg.n_layers, cfg.d_model, cfg.dtype) == (3, 2048, "bfloat16")
