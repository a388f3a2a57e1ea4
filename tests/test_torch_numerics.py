"""The port's numerics policy against the reference's (docs/numerics.md),
live on the CPU with the same numpy inputs and weights:

* the policy, its presets, validation and ``describe``; ``cast_floats``
  and ``all_finite`` on mixed trees holding inf and NaN;
* the loss-scale state, step for step (growth, halving, floor, cap,
  static);
* ``with_master_weights`` / ``for_numerics`` on a bf16 tree;
* the loss-scaled step on the reference test's 8x4 linear model against
  the reference's ``replica_exec="scan"``: a poisoned step skipped on
  both replicas with the state bit-unchanged and the scale halved, then
  recovery; the fp32 preset bit-equal to no policy;
* FAITHFUL_SMOKE AlexNet and a reduced olmo-1b under the bf16 preset;
* bf16-preset checkpoints both ways, and a bit-exact resume.

Every comparison states its tolerance.  bf16 rounds at other places in
the two frameworks (XLA's fusions, the order of a matmul's sums), and one
ulp of bf16 is 2^-8 of a value, so traces are held to 2e-2 where bf16
activations feed them and to fp32 tolerances where only fp32 math does.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, models, numerics, weights
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs import alexnet as port_cfgs
from repro_torch.core import param_avg, steps
from repro_torch.launch import train as train_cli
from repro_torch.models import alexnet
from repro_torch.optim import optimizers, schedules
from repro_torch.train_loop import read_jsonl
from repro_torch.tree import tree_leaves, tree_map

try:
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jax_ckpt
    from repro import core as jax_core
    from repro import models as jax_models
    from repro import numerics as jax_num
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import alexnet as jax_cfgs
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.models import alexnet as jax_alexnet
    from repro.optim import optimizers as jax_opt
except ImportError:
    jax = None

BF16 = numerics.get_policy("bf16")
SCHED = schedules.constant(0.1)
IMAGE_SIZE = 48
BF16_LOSS_TOL = 2e-2     # bf16 activations: a loss within 2e-2
MASTER_TOL = 1e-3        # fp32 masters fed by bf16 grads, after 6 steps


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _bits(t) -> bytes:
    return weights.to_numpy(t).tobytes()


def _same_bits(a, b) -> bool:
    return all(_bits(x) == _bits(y) for x, y in zip(tree_leaves(a),
                                                     tree_leaves(b)))


def _arrays(state):
    """A TrainState's tensors: params, optimizer and loss-scale state."""
    return (state.params, state.opt_state, state.numerics)


def _ulps(a, b) -> int:
    """The most bf16 ulps between two bf16 tensors (ordered patterns)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


# ------------------------------------------------------------ the policy ---

def test_policy_presets_and_describe_match_reference():
    assert set(numerics.PRESETS) == set(jax_num.PRESETS)
    for name in numerics.PRESETS:
        port, ref = numerics.get_policy(name), jax_num.get_policy(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.describe() == ref.describe()
        assert port.is_training_default == ref.is_training_default
    for kw in ({"kv_cache_dtype": "int8"}, {"master_weights": True},
               {"compute_dtype": "bfloat16", "loss_scale": "static"}):
        port, ref = numerics.NumericsPolicy(**kw), jax_num.NumericsPolicy(**kw)
        assert port.describe() == ref.describe()
        assert port.is_training_default == ref.is_training_default
    assert numerics.get_policy(BF16) is BF16


@pytest.mark.parametrize("kw,err", [
    ({"loss_scale": "sometimes"}, ValueError),
    ({"accum_dtype": "bfloat16"}, ValueError),
    ({"kv_cache_dtype": "int4"}, ValueError),
    ({"param_dtype": "float33"}, TypeError),
    ({"loss_scale_init": 0.0}, ValueError),
])
def test_policy_validation_matches_reference(kw, err):
    with pytest.raises(err):
        jax_num.NumericsPolicy(**kw)
    with pytest.raises(err):
        numerics.NumericsPolicy(**kw)


def test_unknown_preset_raises_like_reference():
    with pytest.raises(ValueError, match="preset") as ref:
        jax_num.get_policy("fp16")
    with pytest.raises(ValueError, match="preset") as port:
        numerics.get_policy("fp16")
    assert str(port.value) == str(ref.value)


def test_dtypes_of_a_config():
    cfg = dataclasses.replace(port_cfgs.FAITHFUL_SMOKE, numerics=BF16)
    assert numerics.param_dtype(cfg) == torch.bfloat16
    assert numerics.compute_dtype(cfg) == torch.bfloat16
    assert numerics.param_dtype(port_cfgs.FAITHFUL_SMOKE) == torch.float32
    mixed = dataclasses.replace(cfg, numerics=numerics.NumericsPolicy(
        compute_dtype="bfloat16"))
    assert numerics.param_dtype(mixed) == torch.float32
    assert numerics.compute_dtype(mixed) == torch.bfloat16


def _mixed_tree(bad=None):
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    if bad is not None:
        w[1, 2] = bad
    return {"w": w, "n": np.arange(5, dtype=np.int32),
            "m": [np.ones(2, np.float32), np.array(True)]}


@pytest.mark.parametrize("bad", [None, np.inf, -np.inf, np.nan])
def test_cast_floats_and_all_finite_match_reference(bad):
    tree = _mixed_tree(bad)
    ttree = tree_map(torch.from_numpy, tree)
    got = numerics.cast_floats(ttree, "bfloat16")
    want = jax_num.cast_floats(jax.tree.map(jnp.asarray, tree),
                               jnp.bfloat16)
    assert got["n"].dtype == torch.int32 and got["m"][1].dtype == torch.bool
    assert got["w"].dtype == torch.bfloat16
    # the same bf16 values (a NaN's payload bits are the frameworks' own)
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(want["w"], np.float32))
    flag = numerics.all_finite(ttree)
    assert flag.dtype == torch.bool and flag.dim() == 0
    assert bool(flag) == bool(jax_num.all_finite(
        jax.tree.map(jnp.asarray, tree))) == (bad is None)
    assert bool(numerics.all_finite({"n": torch.arange(3)}))


# ----------------------------------------------------------- loss scale ----

@pytest.mark.parametrize("mode,init,interval,flags", [
    # growth every 3 clean steps, then a halving, then regrowth
    ("dynamic", 2.0, 3, [1, 1, 1, 1, 0, 1, 1, 1]),
    # the floor: halvings stop at 1.0
    ("dynamic", 4.0, 200, [0, 0, 0, 0, 1]),
    # the cap: doublings stop at 2^24
    ("dynamic", 2.0 ** 23, 1, [1, 1, 1, 0, 1]),
    ("static", 256.0, 1, [1, 0, 1, 0, 0, 1]),
])
def test_loss_scale_state_matches_reference(mode, init, interval, flags):
    kw = dict(param_dtype="bfloat16", master_weights=True, loss_scale=mode,
              loss_scale_init=init, growth_interval=interval)
    port_pol, ref_pol = (numerics.NumericsPolicy(**kw),
                         jax_num.NumericsPolicy(**kw))
    ns = numerics.init_loss_scale_state(port_pol)
    jns = jax_num.init_loss_scale_state(ref_pol)
    for f in flags:
        ns = numerics.next_loss_scale_state(
            port_pol, ns, torch.tensor(bool(f)))
        jns = jax_num.next_loss_scale_state(ref_pol, jns,
                                            jnp.asarray(bool(f)))
        assert float(ns["scale"]) == float(jns["scale"])
        assert int(ns["good_steps"]) == int(jns["good_steps"])
        assert int(ns["skipped"]) == int(jns["skipped"])
    assert ns["scale"].dtype == torch.float32
    assert ns["skipped"].dtype == ns["good_steps"].dtype == torch.int32
    assert numerics.init_loss_scale_state(numerics.get_policy("fp32")) \
        is None


# ------------------------------------------------------- master weights ----

def _bf16_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"convs": [{"w": rng.normal(size=(3, 3, 2, 4)),
                       "b": rng.normal(size=(4,))}],
            "fcs": [{"w": rng.normal(size=(8, 5)), "b": rng.normal(size=(5,))}]}
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        tree)


@pytest.mark.parametrize("name", ["sgd_momentum", "adamw"])
def test_master_weights_match_reference(name):
    """4 updates of bf16 params through the wrapper on both sides, the
    reference eager (op by op, as the port runs): masters bit for bit
    for SGD momentum; AdamW's bias corrections take ``b ** count`` in each
    framework's own pow, so its masters are held to 1e-6 (the plain
    AdamW test's tolerance); params within 1 bf16 ulp of their master's
    cast, and of the reference's params."""
    jo = jax_opt.for_numerics(jax_opt.get_optimizer(name), BF16)
    to = optimizers.for_numerics(optimizers.get_optimizer(name), BF16)
    assert to.name == jo.name == f"{name}+master"
    params = _bf16_tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(weights.to_torch, params)
    js, ts = jo.init(jp), to.init(tp)
    # a copy, not an alias, even of fp32 params
    fp = {"w": torch.ones(3)}
    assert to.init(fp)["master"]["w"].data_ptr() != fp["w"].data_ptr()
    for step in range(4):
        grads = _bf16_tree(10 + step)
        ju, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp, 0.01)
        tu, ts = to.update(tree_map(weights.to_torch, grads), ts, tp, 0.01)
        jp = jax_opt.apply_updates(jp, ju)
        tp = optimizers.apply_updates(tp, tu)
    masters = ts["master"]
    assert {x.dtype for x in tree_leaves(masters)} == {torch.float32}
    assert {x.dtype for x in tree_leaves(tp)} == {torch.bfloat16}
    if name == "sgd_momentum":
        tree_map(lambda g, w: _bits(g) == np.asarray(w).tobytes()
                 or pytest.fail("master differs"), masters, js["master"])
    else:
        tree_map(lambda g, w: np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6), masters,
            js["master"])
    tree_map(lambda p, m, w: (_ulps(p, m.to(torch.bfloat16)) <= 1
                              and _ulps(p, weights.to_torch(w)) <= 1)
             or pytest.fail("params beyond 1 ulp"), tp, masters, jp)


def test_for_numerics_is_identity_without_masters():
    opt = optimizers.get_optimizer("sgd_momentum")
    assert optimizers.for_numerics(opt, None) is opt
    assert optimizers.for_numerics(opt, numerics.get_policy("fp32")) is opt


# ----------------------------------------------------------- the step ------

def _linear_init(seed=0):
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    return {"w": jax.random.normal(k1, (8, 4), jnp.float32) * 0.1,
            "b": jnp.zeros((4,), jnp.float32)}


def _jax_loss(params, batch):
    x, y = batch
    logits = x @ params["w"].astype(x.dtype) + params["b"].astype(x.dtype)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _port_loss(params, batch):
    x, y = batch
    logits = x @ params["w"].to(x.dtype) + params["b"].to(x.dtype)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, y[:, None].long()).mean()


def _linear_batches(n, poison_at=None):
    """(R=2, 4, 8) inputs and (2, 4) labels; batch ``poison_at`` carries
    one NaN in replica 1 only."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        x = rng.normal(size=(2, 4, 8)).astype(np.float32)
        if i == poison_at:
            x[1, 0, 0] = np.nan
        out.append((x, rng.integers(0, 4, (2, 4)).astype(np.int32)))
    return out


def test_loss_scaled_step_matches_reference_and_skips_the_poisoned_step():
    """6 steps at R=2 under the bf16 preset, step 3 poisoned in replica 1:
    the port against the reference's scan engine.  Losses within
    BF16_LOSS_TOL, masters within MASTER_TOL after every step; on step 3
    both replicas' params and whole optimizer state (masters, velocity)
    come back bit-unchanged, the scale halves and one skip is counted,
    on both sides; steps 4-6 move the state again."""
    mopt_j = jax_opt.for_numerics(jax_opt.get_optimizer("sgd_momentum"),
                                  jax_num.get_policy("bf16"))
    mopt_t = optimizers.for_numerics(optimizers.get_optimizer("sgd_momentum"),
                                     BF16)
    jstate = jax_core.init_param_avg_state(
        jax.random.PRNGKey(0),
        lambda r: jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                               _linear_init()),
        mopt_j, 2, numerics=jax_num.get_policy("bf16"))
    jstep = jax.jit(jax_core.make_param_avg_step(
        _jax_loss, mopt_j, lambda s: 0.1, replica_exec="scan",
        numerics=jax_num.get_policy("bf16")))
    state = steps.TrainState(
        tree_map(weights.to_torch, _host(jstate.params)),
        tree_map(weights.to_torch, _host(jstate.opt_state)), 0,
        numerics=numerics.init_loss_scale_state(BF16))
    ulps = []

    class UlpChecked(param_avg.Exchanger):
        """The all-reduce, after reading how far each updated param lies
        from its master's cast: 1 ulp at most right after the update; the
        exchange then averages params and masters each on its own, as the
        reference's does, so a mean of opposite-signed replicas near 0
        may sit many of its own ulps from the masters' mean."""
        def average_(self, tree):
            params, opt_state = tree
            ulps.append(max(_ulps(p, m.to(torch.bfloat16)) for p, m in zip(
                tree_leaves(params), tree_leaves(opt_state["master"]))))
            super().average_(tree)

    step = steps.make_param_avg_step(_port_loss, mopt_t, SCHED,
                                     strategy=UlpChecked("all_reduce"),
                                     numerics=BF16)
    for i, (x, y) in enumerate(_linear_batches(6, poison_at=2)):
        before = [t.clone() for t in tree_leaves((state.params,
                                                  state.opt_state))]
        jstate, jloss = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, loss = step(state, (torch.from_numpy(x),
                                   torch.from_numpy(y)))
        after = tree_leaves((state.params, state.opt_state))
        moved = not all(torch.equal(a, b) for a, b in zip(before, after))
        if i == 2:
            assert math.isnan(loss.item()) and math.isnan(float(jloss))
            assert not moved
            assert float(state.numerics["scale"]) == 2.0 ** 14
        else:
            assert moved
            assert abs(loss.item() - float(jloss)) <= BF16_LOSS_TOL
        assert float(state.numerics["scale"]) == \
            float(jstate.numerics["scale"])
        assert int(state.numerics["skipped"]) == \
            int(jstate.numerics["skipped"]) == (i >= 2)
        assert int(state.numerics["good_steps"]) == \
            int(jstate.numerics["good_steps"])
        tree_map(lambda g, w: np.testing.assert_allclose(
            g.numpy(), np.asarray(w), rtol=MASTER_TOL, atol=MASTER_TOL),
            state.opt_state["master"], jstate.opt_state["master"])
    assert state.step == int(jstate.step) == 6
    assert {t.dtype for t in tree_leaves(state.params)} == {torch.bfloat16}
    assert len(ulps) == 6 and max(ulps) <= 1


def test_fp32_preset_is_bit_equal_to_no_policy():
    """The default policy is inert: the same 3 steps built with
    ``numerics=get_policy("fp32")`` and with none give bit-equal state
    and losses, and no loss-scale state."""
    init = tree_map(weights.to_torch, _host(_linear_init()))
    opt = optimizers.get_optimizer("sgd_momentum")
    fp32 = numerics.get_policy("fp32")
    sa = steps.init_param_avg_state(None, lambda _: init, opt, 2)
    sb = steps.init_param_avg_state(
        None, lambda _: init, optimizers.for_numerics(opt, fp32), 2,
        numerics=fp32)
    step_a = steps.make_param_avg_step(_port_loss, opt, SCHED)
    step_b = steps.make_param_avg_step(_port_loss, opt, SCHED,
                                       numerics=fp32)
    for x, y in _linear_batches(3):
        b = (torch.from_numpy(x), torch.from_numpy(y))
        sa, la = step_a(sa, b)
        sb, lb = step_b(sb, b)
        assert _bits(la) == _bits(lb)
    assert sb.numerics is None
    assert _same_bits((sa.params, sa.opt_state), (sb.params, sb.opt_state))


def test_nested_state_updates_in_place_like_the_functional_update():
    """``update_replica_`` walks the masters' nested state (and AdamW's
    count under it) and writes the same values as the optimizer's own
    functional update of the replica's slices."""
    mopt = optimizers.for_numerics(optimizers.get_optimizer("adamw"), BF16)
    params = tree_map(lambda a: weights.to_torch(a)[None].repeat(
        (2,) + (1,) * a.ndim), _bf16_tree(3))
    opt_state = steps.replicate(mopt.init(tree_map(lambda p: p[0], params)),
                                2)
    grads = tree_map(weights.to_torch, _bf16_tree(4))
    want_u, want_s = mopt.update(grads, tree_map(
        lambda t: t[1], opt_state), tree_map(lambda p: p[1], params), 0.01)
    want_p = optimizers.apply_updates(tree_map(lambda p: p[1], params),
                                      want_u)
    steps.update_replica_(mopt, tree_leaves(grads), params, opt_state, 1,
                          0.01)
    tree_map(lambda g, w: torch.equal(g[1], w) or pytest.fail("differs"),
             (params, opt_state), (want_p, want_s))


# ---------------------------------------------------------------- models ---

def _alexnet_pair(backend):
    jcfg = dataclasses.replace(jax_cfgs.FAITHFUL_SMOKE, image_size=IMAGE_SIZE,
                               kernels=JaxPolicy(backend=backend),
                               numerics=jax_num.get_policy("bf16"))
    cfg = dataclasses.replace(port_cfgs.FAITHFUL_SMOKE,
                              image_size=IMAGE_SIZE, numerics=BF16)
    return jcfg, cfg


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(
        np.float32)


def test_bf16_alexnet_forward_matches_reference_pallas():
    """One forward of FAITHFUL_SMOKE in bf16 (params and images) against
    the reference's Pallas conv and LRN kernels, interpreted: logits
    fp32, within 2e-2 of max |logit| (bf16 activations through 5 convs
    and 3 FC layers, rounded at other places)."""
    jcfg, cfg = _alexnet_pair("pallas")
    params = _host(jax_models.init(jax.random.PRNGKey(1), jcfg))
    assert {a.dtype.name for a in jax.tree.leaves(params)} == {"bfloat16"}
    imgs = _images(1, seed=1)
    want = np.asarray(jax_alexnet.forward(
        params, jcfg, jnp.asarray(imgs, jnp.bfloat16),
        conv_backend="pallas"))
    model = weights.from_reference(params, cfg, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    with torch.no_grad():
        got = model(torch.from_numpy(imgs).to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == want.shape
    top = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_LOSS_TOL * top)
    assert weights.to_reference(model)["fcs"][0]["w"].tobytes() == \
        params["fcs"][0]["w"].tobytes()


def _bf16_state_pair(jcfg, cfg, init, opt_name="sgd_momentum"):
    jpol = jax_num.get_policy("bf16")
    jopt = jax_opt.for_numerics(jax_opt.get_optimizer(opt_name), jpol)
    jstate = jax_core.init_param_avg_state(jax.random.PRNGKey(0), init,
                                           jopt, 2, numerics=jpol)
    return jopt, jstate, weights.state_from_reference(jstate, cfg,
                                                      device="cpu")


def test_bf16_alexnet_trace_matches_reference():
    """3 steps of the faithful AlexNet (smoke width) under the bf16
    preset, R=2, against the reference's xla policy, which upcasts its
    conv operands the same way: losses within BF16_LOSS_TOL."""
    jcfg, cfg = _alexnet_pair("xla")
    jopt, jstate, state = _bf16_state_pair(
        jcfg, cfg, lambda r: jax_models.init(r, jcfg))
    assert state.opt_state["master"]["convs"][0]["w"].dtype == torch.float32
    jstep = jax.jit(jax_core.make_param_avg_step(
        lambda p, b: jax_models.loss_fn(p, jcfg, b), jopt, lambda s: 0.01,
        numerics=jcfg.numerics))
    step = steps.make_param_avg_step(
        lambda p, b: alexnet.loss_fn(p, cfg, b["images"], b["labels"]),
        optimizers.for_numerics(optimizers.get_optimizer("sgd_momentum"),
                                BF16), schedules.constant(0.01),
        numerics=BF16)
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = {"images": rng.standard_normal(
                     (2, 4, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32),
                 "labels": rng.integers(0, 10, (2, 4)).astype(np.int32)}
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(torch.from_numpy, batch))
        assert math.isfinite(loss.item())
        assert abs(loss.item() - float(jloss)) <= BF16_LOSS_TOL
    assert float(state.numerics["scale"]) == 2.0 ** 15
    assert int(state.numerics["good_steps"]) == 3


def test_bf16_lm_trace_matches_reference():
    """3 steps of a reduced olmo-1b (2 layers) under the bf16 preset,
    R=2, AdamW at OLMo-1B's 4e-4: losses within BF16_LOSS_TOL."""
    jcfg = dataclasses.replace(jax_reduced(JAX_ARCHS["olmo-1b"]),
                               numerics=jax_num.get_policy("bf16"))
    cfg = dataclasses.replace(reduced(ARCHS["olmo-1b"]), numerics=BF16)
    assert cfg.n_layers == jcfg.n_layers == 2
    jopt, jstate, state = _bf16_state_pair(
        jcfg, cfg, lambda r: jax_models.init(r, jcfg), "adamw")
    jstep = jax.jit(jax_core.make_param_avg_step(
        lambda p, b: jax_models.loss_fn(p, jcfg, b), jopt, lambda s: 4e-4,
        numerics=jcfg.numerics))
    step = steps.make_param_avg_step(
        lambda p, b: models.loss_fn(p, cfg, b),
        optimizers.for_numerics(optimizers.get_optimizer("adamw"), BF16),
        schedules.constant(4e-4), numerics=BF16)
    rng = np.random.default_rng(7)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (2, 2, 32)).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(torch.from_numpy, batch))
        assert abs(loss.item() - float(jloss)) <= BF16_LOSS_TOL
    assert {t.dtype for t in tree_leaves(state.params)} == {torch.bfloat16}
    assert int(state.numerics["skipped"]) == 0


# ----------------------------------------------------------- checkpoints ---

def test_bf16_checkpoints_cross_both_ways(tmp_path):
    """A bf16-preset AlexNet state (bf16 params, fp32 masters under the
    velocity, the loss-scale state) saved by either package restores in
    the other bit for bit."""
    jcfg, cfg = _alexnet_pair("xla")
    _, jstate, _ = _bf16_state_pair(jcfg, cfg,
                                    lambda r: jax_models.init(r, jcfg))
    jstate = dataclasses.replace(
        jstate, step=jnp.asarray(5, jnp.int32),
        numerics={"scale": jnp.asarray(2.0 ** 13, jnp.float32),
                  "good_steps": jnp.asarray(7, jnp.int32),
                  "skipped": jnp.asarray(2, jnp.int32)})
    jax_ckpt.save(str(tmp_path / "ref"), 5, jstate)
    like = weights.state_from_reference(
        _bf16_state_pair(jcfg, cfg, lambda r: jax_models.init(
            jax.random.PRNGKey(9), jcfg))[1], cfg, device="cpu")
    got = checkpoint.restore(str(tmp_path / "ref"), 5, like)
    want = weights.state_from_reference(jstate, cfg, device="cpu")
    assert got.step == 5 and float(got.numerics["scale"]) == 2.0 ** 13
    assert _same_bits(_arrays(got), _arrays(want))
    checkpoint.save(str(tmp_path / "port"), 5, got)
    back = jax_ckpt.restore(str(tmp_path / "port"), 5, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_bf16_resume_repeats_an_uninterrupted_run(tmp_path):
    """The train CLI under --numerics bf16: 4 steps straight, and 2 +
    resume + 2, give bit-identical losses, loss scales and state."""
    cli = ["--arch", "alexnet", "--smoke", "--faithful", "--image-size",
           str(IMAGE_SIZE), "--batch", "8", "--replicas", "2", "--device",
           "cpu", "--log-every", "100", "--numerics", "bf16"]
    straight = train_cli.main(cli + ["--steps", "4", "--metrics-out",
                                     str(tmp_path / "a.jsonl")])
    ck, path = str(tmp_path / "ck"), str(tmp_path / "b.jsonl")
    train_cli.main(cli + ["--steps", "2", "--ckpt-dir", ck,
                          "--ckpt-every", "2", "--metrics-out", path])
    meta = checkpoint.load_meta(ck, 2)["run_meta"]
    assert meta["numerics"] == BF16.describe()
    resumed = train_cli.main(cli + ["--steps", "4", "--ckpt-dir", ck,
                                    "--resume", "--metrics-out", path])
    assert resumed.start_step == 2
    want = read_jsonl(str(tmp_path / "a.jsonl"), "train")
    got = read_jsonl(path, "train")
    assert [(r["loss"], r["loss_scale"], r["skipped_steps"]) for r in got] \
        == [(r["loss"], r["loss_scale"], r["skipped_steps"]) for r in want]
    assert read_jsonl(path, "summary")[-1]["loss_scale"] == 2.0 ** 15
    assert _same_bits(_arrays(resumed.state), _arrays(straight.state))
