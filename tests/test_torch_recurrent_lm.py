"""The port's recurrent LMs, ``rwkv6-7b`` (ssm) and ``recurrentgemma-9b``
(hybrid), against the reference's: the model's logits, loss and grads,
the layer order, the parameter-averaging trainer, the weight and state
bridge, the CLIs and what still refuses.

The reference runs live on the CPU: ``repro.models.loss_fn`` under its
XLA policy and under its Pallas kernels in interpret mode
(``KernelPolicy(rwkv6="pallas", rglru="pallas", attention="flash",
interpret=True)``); the port runs its plain versions.  Weights come from
``repro.models.init`` through ``weights.lm_from_reference``, batches
from numpy.  fp32, reduced configs (d_model 128, S 64): ``rwkv6-7b`` at
2 layers, ``recurrentgemma-9b`` at 4 and 5 (one ``rec, rec, attn``
superblock and one or two remainder ``rec`` layers).
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import models, weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import param_avg, steps
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer
from repro_torch.optim import optimizers, schedules
from repro_torch.serving import ServingEngine
from repro_torch.tree import (flatten_with_paths, tree_leaves, tree_map,
                              unflatten_like)

try:
    import jax
    import jax.numpy as jnp

    from repro import core as jax_core
    from repro import models as jax_models
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.optim import optimizers as jax_opt
    from repro.optim import schedules as jax_sched
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
SEQ = 64
WIDTH = 128
RECURRENT = ("rwkv6-7b", "recurrentgemma-9b")
CASES = [("rwkv6-7b", 2), ("recurrentgemma-9b", 4), ("recurrentgemma-9b", 5)]


def _pair(name, n_layers, **kw):
    return (dataclasses.replace(jax_reduced(JAX_ARCHS[name], n_layers,
                                            WIDTH), **kw),
            dataclasses.replace(reduced(ARCHS[name], n_layers, WIDTH), **kw))


def _policy(name):
    if name == "xla":
        return JaxPolicy(backend="xla")
    return JaxPolicy(rwkv6="pallas", rglru="pallas", attention="flash",
                     interpret=True)


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


# ------------------------------------------------------------------ model --

@pytest.mark.parametrize("policy", ["xla", "pallas"])
@pytest.mark.parametrize("name,n_layers", CASES)
def test_model_matches_reference(name, n_layers, policy):
    """Logits, loss and every param grad at 1e-4 (fp32, S=64)."""
    jcfg, cfg = _pair(name, n_layers)
    jcfg = dataclasses.replace(jcfg, kernels=_policy(policy))
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
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=TOL, atol=TOL)
    loss = models.loss_fn(p, cfg, tb)
    assert loss.item() == pytest.approx(float(want_loss), abs=TOL)
    grads = unflatten_like(p, dict(zip(flatten_with_paths(p),
                                       torch.autograd.grad(loss, leaves))))
    _close(grads, want_grads)


@pytest.mark.parametrize("name,n_layers", CASES + [("minitron-8b", 3)])
def test_layers_run_superblock_major(name, n_layers):
    """The forward's layers are the reference's order: ``blocks[0][i]``,
    ``blocks[1][i]``, ... for each superblock i, then ``rem_blocks``.
    Each layer's norm scale carries its own index, so the walk shows
    which layer comes where; and the forward with every layer's weights
    distinct matches the reference only in that order (above)."""
    _, cfg = _pair(name, n_layers)
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    pattern, n_super, rem = transformer._split(cfg)
    want = []
    for i in range(n_super):
        for pi in range(len(pattern)):
            want.append(("blocks", pi, i))
    want += [("rem_blocks", i, None) for i in range(rem)]
    for n, (group, pi, i) in enumerate(want):
        node = params[group][pi]
        scale = node["norm1"]["scale"]
        if i is None:
            scale.fill_(n)
        else:
            scale[i] = n
    kinds = transformer.layer_kinds(cfg)
    layers = transformer._all_layers(params, cfg)
    assert len(layers) == len(kinds) == cfg.n_layers
    assert [int(layer["norm1"]["scale"][0]) for layer in layers] == \
        list(range(cfg.n_layers))
    assert kinds == [pattern[pi] for _, pi, _ in want]
    if cfg.family == "hybrid":
        assert kinds[:3] == ["rec", "rec", "attn"] and \
            all(k == "rec" for k in kinds[3:])
        assert ("mix" in layers[0]) and ("attn" in layers[2])


@pytest.mark.parametrize("name,params", [("rwkv6-7b", 7_576_887_296),
                                         ("recurrentgemma-9b",
                                          9_626_882_048)])
def test_full_width_shapes(name, params):
    """The published configs: the reference's param count (from
    ``jax.eval_shape`` of its init) and tree, bf16, tallied without
    allocating."""
    cfg = ARCHS[name]
    shapes = transformer.param_shapes(cfg)
    abstract = jax.eval_shape(lambda: jax_models.init(
        jax.random.PRNGKey(0), JAX_ARCHS[name]))
    assert sum(math.prod(x.shape) for x in jax.tree.leaves(abstract)) == \
        params
    flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(x.shape) for path, x in flat}
    mine = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [k])
        elif t and all(isinstance(i, int) for i in t):
            mine["/".join(map(str, path))] = tuple(t)
        else:
            for i, v in enumerate(t):
                walk(v, path + [i])

    walk(shapes, [])
    assert mine == want
    assert sum(math.prod(s) for s in mine.values()) == params
    assert all(x.dtype == jnp.bfloat16 for x in jax.tree.leaves(abstract))


# ---------------------------------------------------------------- trainer --

@pytest.mark.parametrize("sync_every", [1, 2])
@pytest.mark.parametrize("name,n_layers", [("rwkv6-7b", 2),
                                           ("recurrentgemma-9b", 4)])
def test_param_avg_steps_match_reference(name, n_layers, sync_every):
    """3 steps of the paper's step, R=2, SGD momentum: the loss of every
    step, then params and velocity, at 1e-4."""
    jcfg, cfg = _pair(name, n_layers)
    opt = "sgd_momentum"
    jstate = jax_core.init_param_avg_state(
        jax.random.PRNGKey(0), lambda r: jax_models.init(r, jcfg),
        jax_opt.get_optimizer(opt), 2)
    state = weights.state_from_reference(jstate, cfg, device="cpu")
    jstep = jax.jit(jax_core.make_param_avg_step(
        lambda p, b: jax_models.loss_fn(p, jcfg, b),
        jax_opt.get_optimizer(opt), jax_sched.constant(0.01),
        strategy="all_reduce", sync_every=sync_every))
    step = steps.make_param_avg_step(
        lambda p, b: models.loss_fn(p, cfg, b), optimizers.get_optimizer(opt),
        schedules.constant(0.01), strategy="all_reduce",
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


@pytest.mark.parametrize("opt,strategy,sync_every", [
    ("sgd_momentum", "all_reduce", 1), ("sgd_momentum", "all_reduce", 2),
    ("sgd_momentum", "ring", 1), ("adamw", "pairwise", 1),
    ("adamw", "none", 1), ("adamw", "all_reduce", 2)])
def test_chunked_step_equals_whole_leaf_step(opt, strategy, sync_every,
                                             monkeypatch):
    """The step updates the state's own tensors in place, chunk by chunk;
    with chunks cut small, so that every leaf spans several, it gives the
    losses, params and optimizer state of chunks that hold whole leaves,
    bit for bit (bf16 params, hybrid model)."""
    cfg = dataclasses.replace(reduced(ARCHS["recurrentgemma-9b"], 4, 64),
                              dtype="bfloat16")
    optimizer = optimizers.get_optimizer(opt)
    state = steps.init_param_avg_state(
        torch.Generator().manual_seed(0),
        lambda g: models.init(cfg, g, device="cpu"), optimizer, 2)
    assert max(x[0].numel() for x in tree_leaves(state.params)) \
        < param_avg.CHUNK

    def run(chunk):
        monkeypatch.setattr(param_avg, "CHUNK", chunk)
        st = steps.TrainState(tree_map(torch.clone, state.params),
                              tree_map(torch.clone, state.opt_state))
        given = tree_leaves((st.params, st.opt_state))
        step = steps.make_param_avg_step(
            lambda p, b: models.loss_fn(p, cfg, b), optimizer,
            schedules.constant(0.01), strategy=strategy,
            sync_every=sync_every)
        losses = []
        for i in range(3):
            batch = tree_map(torch.from_numpy, _tokens(cfg, (2, 2, 16), i))
            st, loss = step(st, batch)
            losses.append(loss)
        assert all(a is b for a, b in zip(
            tree_leaves((st.params, st.opt_state)), given))
        return st, losses

    (want, want_losses), (got, losses) = run(param_avg.CHUNK), run(1000)
    assert torch.equal(torch.stack(losses), torch.stack(want_losses))
    for a, b in zip(tree_leaves((got.params, got.opt_state)),
                    tree_leaves((want.params, want.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ----------------------------------------------------------------- bridge --

@pytest.mark.parametrize("name,n_layers", CASES)
def test_params_cross_the_bridge_bit_for_bit(name, n_layers):
    jcfg, cfg = _pair(name, n_layers, dtype="bfloat16")
    params = _host(jax_models.init(jax.random.PRNGKey(5), jcfg))
    port = weights.lm_from_reference(params, cfg, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(port))
    back = weights.lm_to_reference(port)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="expected"):
        weights.lm_from_reference(params, dataclasses.replace(
            cfg, n_layers=n_layers + 1), device="cpu")


@pytest.mark.parametrize("name,n_layers", CASES)
def test_train_state_crosses_the_bridge_bit_for_bit(name, n_layers):
    jcfg, cfg = _pair(name, n_layers, dtype="bfloat16")
    jstate = jax_core.init_param_avg_state(
        jax.random.PRNGKey(1), lambda r: jax_models.init(r, jcfg),
        jax_opt.get_optimizer("sgd_momentum"), 2)
    state = weights.state_from_reference(jstate, cfg, device="cpu")
    assert all(t.dtype == torch.float32
               for t in tree_leaves(state.opt_state))
    back = jax_core.TrainState(**weights.state_to_reference(state))
    for a, b in zip(jax.tree.leaves((back.params, back.opt_state,
                                     back.step)),
                    jax.tree.leaves((jstate.params, jstate.opt_state,
                                     jstate.step))):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


# ------------------------------------------------------------------- CLIs --

@pytest.mark.parametrize("name,n_layers", [("rwkv6-7b", 1),
                                           ("recurrentgemma-9b", 4)])
def test_train_cli_resume_repeats_an_uninterrupted_run(tmp_path, name,
                                                       n_layers):
    """The train CLI trains on the CPU: 4 steps straight, and 2 + resume
    + 2, give the same finite losses and params bit for bit, the
    replicas equal after every exchange (in-process CLI, its state
    updated in place)."""
    cli = ["--arch", name, "--smoke", "--layers", str(n_layers),
           "--d-model", "64", "--seq-len", "32", "--batch", "4",
           "--replicas", "2", "--device", "cpu", "--log-every", "1"]
    straight = train_cli.main(cli + ["--steps", "4"])
    ck = str(tmp_path / "ck")
    first = train_cli.main(cli + ["--steps", "2", "--ckpt-dir", ck,
                                  "--ckpt-every", "2"])
    resumed = train_cli.main(cli + ["--steps", "4", "--ckpt-dir", ck,
                                    "--resume"])
    assert (first.final_step, resumed.start_step) == (2, 2)
    losses = [loss for _, loss in straight.losses]
    assert len(losses) == 4 and all(map(math.isfinite, losses))
    assert [loss for _, loss in first.losses + resumed.losses] == losses
    assert param_avg.replica_spread(straight.state.params) == 0.0
    for a, b in zip(tree_leaves(resumed.state.params),
                    tree_leaves(straight.state.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", RECURRENT)
def test_train_cli_cuts_depth_at_full_width_only(name):
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", name, "--d-model", "128", "--steps", "1",
                        "--device", "cpu"])
    args = train_cli.build_parser().parse_args(["--arch", name,
                                                "--layers", "3"])
    cfg = train_cli.build_cfg(args, pytest.fail)
    assert (cfg.n_layers, cfg.d_model, cfg.dtype) == (3, 4096, "bfloat16")


def test_train_cli_needs_cuda_unless_asked_for_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "rwkv6-7b", "--smoke", "--steps", "1"], capture_output=True,
        text=True, env=env, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


@pytest.mark.parametrize("name", RECURRENT)
def test_serving_still_refuses(name):
    """These families serve (``tests/test_torch_recurrent_decode.py``),
    speculatively too (``tests/test_torch_spec_decode.py``); what their
    serving still refuses names its ROADMAP item or says why: the replica
    mesh (queue A item 12), spec decode under sampling, in the serve CLI
    and the engine, as the reference refuses it, and the block pool,
    which holds no recurrent state."""
    with pytest.raises(ValueError, match="greedy"):
        serve_cli.main(["--arch", name, "--smoke", "--device", "cpu",
                        "--draft-layers", "1", "--temperature", "1.0"])
    cfg = reduced(ARCHS[name], 3, 64)
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        ServingEngine(params, cfg, temperature=0.5, draft_params=params,
                      draft_cfg=cfg)
    with pytest.raises(NotImplementedError, match="queue A item 12"):
        ServingEngine(params, cfg, mesh=object())
    with pytest.raises(ValueError, match="pure-attention family"):
        ServingEngine(params, cfg, block_size=8)
    with pytest.raises(ValueError, match="pure-attention family"):
        ServingEngine(params, cfg, block_size=8, draft_params=params,
                      draft_cfg=cfg)
    cache = transformer.init_decode_cache(cfg, 1, 16, device="cpu")
    assert len(cache["blocks"]) == len(transformer.block_kinds(cfg))


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_layers", CASES)
def test_kernels_match_plain_policy_on_the_card(cuda, name, n_layers):
    """Loss and every param grad under the kernels against the plain
    policy, fp32, at d_model 256 with head_dim 64 (the flash kernels'
    smallest), and each kernel launched once per layer of its kind."""
    from repro_torch.kernels.common import KernelPolicy
    from repro_torch.kernels.flash_attention.ops import flash_fwd
    from repro_torch.kernels.rglru.ops import rglru_fwd
    from repro_torch.kernels.rwkv6.ops import wkv_fwd

    base = dataclasses.replace(reduced(ARCHS[name], n_layers, 256),
                               head_dim=64, n_heads=4)
    params = models.init(base, torch.Generator().manual_seed(0),
                         device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _tokens(base, (2, 128), seed=3).items()}
    out = []
    for backend in ("auto", "plain"):
        cfg = dataclasses.replace(base, kernels=KernelPolicy(backend))
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        p = unflatten_like(params, dict(zip(flatten_with_paths(params),
                                            leaves)))
        counts = (wkv_fwd.launches, rglru_fwd.launches, flash_fwd.launches)
        loss = models.loss_fn(p, cfg, batch)
        grads = torch.autograd.grad(loss, leaves)
        counts = [a - b for a, b in zip(
            (wkv_fwd.launches, rglru_fwd.launches, flash_fwd.launches),
            counts)]
        out.append((loss, grads, counts))
    kinds = transformer.layer_kinds(base)
    assert out[0][2] == [kinds.count("rwkv"), 2 * kinds.count("rec"),
                         kinds.count("attn")]
    assert out[1][2] == [0, 0, 0]
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
