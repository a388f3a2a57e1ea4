"""The rest of the port's exchange against the reference's, live on the
CPU: the delay=1 one-step-stale exchange under each compression, the
error-feedback arithmetic, microbatching, the grad-avg baseline, the
small public helpers, and checkpoints of a delayed top-k state across
the two packages.

Weights come from ``repro.models.init`` through
``weights.state_from_reference`` (torch cannot match JAX's RNG), batches
from numpy.  The models are FAITHFUL_SMOKE at 48 px and the reference
tests' 8x4 linear toy.  Losses and state are held to ``STEP_TOL`` (the
trainer tests' tolerance) unless a comparison says otherwise.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, numerics, weights
from repro_torch.configs import alexnet as port_cfgs
from repro_torch.core import param_avg, steps
from repro_torch.models import alexnet
from repro_torch.optim import optimizers, schedules
from repro_torch.tree import tree_leaves, tree_map

try:
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jax_ckpt
    from repro import core as jax_core
    from repro import models as jax_models
    from repro import numerics as jax_num
    from repro.configs import alexnet as jax_cfgs
    from repro.core import param_avg as jax_pa
    from repro.optim import optimizers as jax_opt
    from repro.optim import schedules as jax_sched
except ImportError:
    jax = None

IMAGE_SIZE = 48
STEP_TOL = 1e-4          # test_torch_train.py's
BF16_LOSS_TOL = 2e-2     # test_torch_numerics.py's: bf16 activations
MASTER_TOL = 1e-3        # test_torch_numerics.py's: fp32 masters, bf16 grads
BF16 = numerics.get_policy("bf16")
# the bf16 wire: where the two packages' fp32 deltas (equal within
# STEP_TOL) lie either side of a bf16 rounding boundary, they round to
# neighbouring bf16 values, one ulp apart; the momentum's deltas here are
# below 0.125, whose bf16 ulp is 2^-11 (4.9e-4)
BF16_FLIP_TOL = 1e-3
BF16_FLIP_SHARE = 1e-3   # of the elements may sit beyond STEP_TOL


def _pair():
    return (dataclasses.replace(jax_cfgs.FAITHFUL_SMOKE,
                                image_size=IMAGE_SIZE),
            dataclasses.replace(port_cfgs.FAITHFUL_SMOKE,
                                image_size=IMAGE_SIZE))


def _batches(n, prefix, seed=0, n_classes=10):
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal(
                prefix + (IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32),
             "labels": rng.integers(0, n_classes, prefix).astype(np.int32)}
            for _ in range(n)]


def _close(got, want, tol):
    """Port tree (tensors) against a reference tree, leaf by leaf."""
    tree_map(lambda g, w: np.testing.assert_allclose(
        g.detach().float().numpy(), np.asarray(w, np.float32), rtol=tol,
        atol=tol), got, want)


def _same_bits(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _alexnet_steps(cfg, jcfg, **kw):
    jstep = jax.jit(jax_core.make_param_avg_step(
        lambda p, b: jax_models.loss_fn(p, jcfg, b), jax_opt.sgd_momentum(),
        jax_sched.constant(0.01), **kw))
    pkw = dict(kw)
    if isinstance(kw.get("strategy"), jax_core.ExchangeConfig):
        pkw["strategy"] = _port_exchange(kw["strategy"])
    step = steps.make_param_avg_step(
        lambda p, b: alexnet.loss_fn(p, cfg, b["images"], b["labels"]),
        optimizers.sgd_momentum(), schedules.constant(0.01), **pkw)
    return jstep, step


def _port_exchange(jex):
    return param_avg.ExchangeConfig(**dataclasses.asdict(jex))


def _alexnet_states(jcfg, cfg, jex=None):
    jstate = jax_core.init_param_avg_state(
        jax.random.PRNGKey(0), lambda r: jax_models.init(r, jcfg),
        jax_opt.sgd_momentum(), 2, exchange=jex)
    return jstate, weights.state_from_reference(jstate, cfg, device="cpu")


def _run_alexnet(jex, n=3):
    """``n`` steps of both packages at R=2 under the reference's exchange
    config ``jex``: (the reference's state, the port's, the losses of
    each step, reference first)."""
    jcfg, cfg = _pair()
    jstate, state = _alexnet_states(jcfg, cfg, jex)
    jstep, step = _alexnet_steps(cfg, jcfg, strategy=jex)
    losses = []
    for batch in _batches(n, (2, 4)):
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(torch.from_numpy, batch))
        losses.append((float(jloss), loss.item()))
    return jstate, state, losses


DELAYED = {"none": dict(), "bf16": dict(compression="bf16"),
           "topk": dict(compression="topk", topk_frac=0.05)}


@pytest.fixture(scope="module")
def delayed_runs():
    """Each delayed exchange run once, for the tests that read it."""
    return {name: _run_alexnet(jax_core.ExchangeConfig(delay=1, **kw))
            for name, kw in DELAYED.items()}


@pytest.mark.parametrize("name", list(DELAYED))
def test_delayed_exchange_matches_reference(delayed_runs, name):
    """3 steps of FAITHFUL_SMOKE at R=2 under delay=1: every loss, then
    params, momentum and the exchange's base and residual (under the
    bf16 wire the last three within BF16_FLIP_TOL, and all but
    BF16_FLIP_SHARE of their elements within STEP_TOL)."""
    jstate, state, losses = delayed_runs[name]
    for want, got in losses:
        assert abs(got - want) <= STEP_TOL
    assert state.step == int(jstate.step) == 3
    _close(state.params, jstate.params, STEP_TOL)
    assert (state.exchange is None) == (jstate.exchange is None) == \
        (name == "none")
    rest = (state.opt_state, state.exchange)
    jrest = (jstate.opt_state, jstate.exchange)
    if name != "bf16":
        _close(rest, jrest, STEP_TOL)
    else:
        _close(rest, jrest, BF16_FLIP_TOL)
        far = []
        tree_map(lambda g, w: far.append(
            (np.abs(g.numpy() - np.asarray(w)) > STEP_TOL).reshape(-1)),
            rest, jrest)
        far = np.concatenate(far)
        print(f"bf16 wire: {far.sum()} of {far.size} beyond STEP_TOL")
        assert far.mean() <= BF16_FLIP_SHARE
    if state.exchange is not None:
        # the consensus is replica-identical after every exchange
        assert param_avg.replica_spread(state.exchange["base"]) == 0.0
    # delay=1 leaves the replicas one local step apart
    assert param_avg.replica_spread(state.params) > 0.0


def test_topk_of_everything_is_bit_equal_to_none():
    """topk_frac 1.0 takes the dense whole-value path: losses and state
    bit-equal to the uncompressed delay=1 exchange; the residual stays
    zero."""
    jcfg, cfg = _pair()
    out = []
    for ex in (param_avg.ExchangeConfig(delay=1),
               param_avg.ExchangeConfig(delay=1, compression="topk",
                                        topk_frac=1.0)):
        state = steps.init_param_avg_state(
            torch.Generator().manual_seed(3),
            lambda g: tree_map(lambda p: p.detach(),
                               alexnet.init(cfg, g, device="cpu")
                               .params()),
            optimizers.sgd_momentum(), 2, exchange=ex)
        step = steps.make_param_avg_step(
            lambda p, b: alexnet.loss_fn(p, cfg, b["images"], b["labels"]),
            optimizers.sgd_momentum(), schedules.constant(0.01),
            strategy=ex)
        losses = []
        for batch in _batches(3, (2, 4), seed=4):
            state, loss = step(state, tree_map(torch.from_numpy, batch))
            losses.append(loss)
        out.append((state, losses))
    (a, la), (b, lb) = out
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert _same_bits((a.params, a.opt_state), (b.params, b.opt_state))
    assert all(not t.any() for t in tree_leaves(b.exchange["residual"]))


def _delta_tree(seed):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(2, 40, 5)).astype(np.float32),
            "b": rng.normal(size=(2, 7)).astype(np.float32)}
    base = jax.tree.map(lambda x: np.broadcast_to(
        rng.normal(size=x.shape[1:]).astype(np.float32), x.shape).copy(),
        tree)
    res = jax.tree.map(lambda x: (0.01 * rng.normal(size=x.shape)).astype(
        np.float32), tree)
    return tree, base, res


@pytest.mark.parametrize("compression,frac", [("topk", 0.05),
                                              ("topk", 0.3),
                                              ("bf16", 0.01),
                                              ("none", 0.01)])
def test_error_feedback_identity_and_reference(compression, frac):
    """``average_delta`` against the reference's on the same numpy trees
    (1e-6), and its arithmetic: with d = (x - base) + residual, what was
    kept plus the new residual is d bit for bit; top-k keeps exactly k
    entries a replica, the k largest |d|; bf16 keeps d's bf16 cast."""
    tree, base, res = _delta_tree(7)
    ex = param_avg.Exchanger(compression=compression, topk_frac=frac)
    jex = jax_pa.Exchanger(compression=compression, topk_frac=frac)
    t = lambda x: tree_map(torch.from_numpy, x)   # noqa: E731
    avg, new_res = ex.average_delta(t(tree), t(base), t(res))
    javg, jres = jex.average_delta(jax.tree.map(jnp.asarray, tree),
                                   jax.tree.map(jnp.asarray, base),
                                   jax.tree.map(jnp.asarray, res))
    _close(avg, javg, 1e-6)
    _close(new_res, jres, 1e-6)
    for key in tree:
        d = (torch.from_numpy(tree[key]) - torch.from_numpy(base[key])
             + torch.from_numpy(res[key]))
        kept = d - new_res[key]
        assert torch.equal(kept + new_res[key], d)
        if compression == "topk":
            n = d[0].numel()
            k = ex.topk_k(n)
            for r in range(2):
                nz = kept[r].reshape(-1).nonzero().reshape(-1)
                assert nz.numel() == k
                top = d[r].reshape(-1).abs().topk(k).indices
                assert set(nz.tolist()) == set(top.tolist())
        elif compression == "bf16":
            assert torch.equal(kept, d.to(torch.bfloat16).float())
        else:
            assert torch.equal(kept, d)


def test_topk_without_delay_is_refused_as_in_the_reference():
    with pytest.raises(ValueError) as want:
        jax_pa.ExchangeConfig(compression="topk")
    with pytest.raises(ValueError) as got:
        param_avg.ExchangeConfig(compression="topk")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_core.make_param_avg_step(
            lambda p, b: 0.0, jax_opt.sgd_momentum(), lambda s: 0.01,
            strategy=jax_pa.Exchanger(compression="topk"))
    with pytest.raises(ValueError) as got:
        steps.make_param_avg_step(
            lambda p, b: 0.0, optimizers.sgd_momentum(), lambda s: 0.01,
            strategy=param_avg.Exchanger(compression="topk"))
    assert str(got.value) == str(want.value)


# ------------------------------------------------- the linear toy -----

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


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _linear_state(jstate, policy=None):
    return steps.TrainState(
        tree_map(weights.to_torch, _host(jstate.params)),
        tree_map(weights.to_torch, _host(jstate.opt_state)), 0,
        tree_map(weights.to_torch, _host(jstate.exchange)),
        numerics.init_loss_scale_state(policy))


def test_sync_every_leaves_the_exchange_state_alone_on_skipped_steps():
    """delay=1 bf16 with sync_every=2 on the linear toy, 4 steps: the
    base and residual stay bit-unchanged on steps 1 and 3, move on 2 and
    4, and every step matches the reference."""
    jex = jax_core.ExchangeConfig(delay=1, compression="bf16", sync_every=2)
    jstate = jax_core.init_param_avg_state(
        jax.random.PRNGKey(0), lambda r: _linear_init(),
        jax_opt.sgd_momentum(), 2, exchange=jex)
    jstep = jax.jit(jax_core.make_param_avg_step(
        _jax_loss, jax_opt.sgd_momentum(), lambda s: 0.1, strategy=jex))
    state = _linear_state(jstate)
    step = steps.make_param_avg_step(
        _port_loss, optimizers.sgd_momentum(), schedules.constant(0.1),
        strategy=_port_exchange(jex))
    for i, (x, y) in enumerate(_linear_batches(4)):
        before = tree_map(torch.clone, state.exchange)
        jstate, jloss = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, loss = step(state, (torch.from_numpy(x),
                                   torch.from_numpy(y)))
        assert _same_bits(before, state.exchange) == (i % 2 == 0)
        assert abs(loss.item() - float(jloss)) <= STEP_TOL
        _close((state.params, state.opt_state, state.exchange),
               (jstate.params, jstate.opt_state, jstate.exchange), STEP_TOL)


def test_bf16_preset_under_delay_skips_the_poisoned_step():
    """The bf16 preset (bf16 params, fp32 masters, loss scaling) under
    delay=1, 4 steps at R=2, step 2's batch carrying one NaN pixel in
    replica 1: both packages skip the update on both replicas (the state
    becomes the exchange of the incoming one), halve the scale and count
    one skip; losses within BF16_LOSS_TOL, masters within MASTER_TOL."""
    jpol = jax_num.get_policy("bf16")
    jopt = jax_opt.for_numerics(jax_opt.get_optimizer("sgd_momentum"), jpol)
    jex = jax_core.ExchangeConfig(delay=1)
    jstate = jax_core.init_param_avg_state(
        jax.random.PRNGKey(0),
        lambda r: jax.tree.map(lambda p: p.astype(jnp.bfloat16),
                               _linear_init()),
        jopt, 2, exchange=jex, numerics=jpol)
    jstep = jax.jit(jax_core.make_param_avg_step(
        _jax_loss, jopt, lambda s: 0.1, strategy=jex, replica_exec="scan",
        numerics=jpol))
    opt = optimizers.for_numerics(optimizers.get_optimizer("sgd_momentum"),
                                  BF16)
    state = _linear_state(jstate, BF16)
    step = steps.make_param_avg_step(_port_loss, opt,
                                     schedules.constant(0.1),
                                     strategy=_port_exchange(jex),
                                     numerics=BF16)
    for i, (x, y) in enumerate(_linear_batches(4, poison_at=1)):
        before = tree_map(torch.clone, (state.params, state.opt_state))
        jstate, jloss = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, loss = step(state, (torch.from_numpy(x),
                                   torch.from_numpy(y)))
        if i == 1:
            assert math.isnan(loss.item()) and math.isnan(float(jloss))
            # no local progress: each leaf is the incoming replicas' mean
            want = param_avg.Exchanger().average(before)
            assert _same_bits((state.params, state.opt_state), want)
            assert float(state.numerics["scale"]) == 2.0 ** 14
        else:
            assert abs(loss.item() - float(jloss)) <= BF16_LOSS_TOL
        for k in ("scale", "good_steps", "skipped"):
            assert float(state.numerics[k]) == float(jstate.numerics[k])
        assert int(state.numerics["skipped"]) == (i >= 1)
        _close(state.opt_state["master"], jstate.opt_state["master"],
               MASTER_TOL)


# ------------------------------------------ microbatch and grad-avg -----

def test_microbatch_matches_reference():
    """microbatch=2 (rows i, i + 2, ... of each replica's batch of 4,
    fp32 grad accumulation): 2 steps of FAITHFUL_SMOKE at R=2."""
    jcfg, cfg = _pair()
    jstate, state = _alexnet_states(jcfg, cfg)
    jstep, step = _alexnet_steps(cfg, jcfg, microbatch=2)
    for batch in _batches(2, (2, 4), seed=9):
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(torch.from_numpy, batch))
        assert abs(loss.item() - float(jloss)) <= STEP_TOL
    _close(state.params, jstate.params, STEP_TOL)
    _close(state.opt_state, jstate.opt_state, STEP_TOL)


def test_grad_avg_step_matches_reference():
    """The grad-avg baseline, 3 steps of FAITHFUL_SMOKE on a global batch
    of 8: one params copy, updated in place."""
    jcfg, cfg = _pair()
    jstate = jax_core.init_grad_avg_state(
        jax.random.PRNGKey(0), lambda r: jax_models.init(r, jcfg),
        jax_opt.sgd_momentum())
    jstep = jax.jit(jax_core.make_grad_avg_step(
        lambda p, b: jax_models.loss_fn(p, jcfg, b), jax_opt.sgd_momentum(),
        jax_sched.constant(0.01)))
    params = tree_map(weights.to_torch, _host(jstate.params))
    state = steps.init_grad_avg_state(None, lambda _: params,
                                      optimizers.sgd_momentum())
    given = tree_leaves(state.params)
    step = steps.make_grad_avg_step(
        lambda p, b: alexnet.loss_fn(p, cfg, b["images"], b["labels"]),
        optimizers.sgd_momentum(), schedules.constant(0.01))
    for batch in _batches(3, (8,), seed=11):
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(torch.from_numpy, batch))
        assert abs(loss.item() - float(jloss)) <= STEP_TOL
    assert state.step == int(jstate.step) == 3
    assert all(a is b for a, b in zip(given, tree_leaves(state.params)))
    _close(state.params, jstate.params, STEP_TOL)
    _close(state.opt_state, jstate.opt_state, STEP_TOL)


# --------------------------------------------------- the small helpers --

def test_helpers_match_reference():
    """``exchange_average`` (each strategy, none and bf16 wire),
    ``unreplicate``, ``logical_bytes`` and ``make_serve_step``."""
    tree, _, _ = _delta_tree(5)
    tree["count"] = np.asarray(3, np.int32)
    t = tree_map(torch.from_numpy, tree)
    j = jax.tree.map(jnp.asarray, tree)
    for strategy in param_avg.STRATEGIES:
        for comp in ("none", "bf16"):
            ex = param_avg.Exchanger(strategy, compression=comp)
            jex = jax_pa.Exchanger(strategy, compression=comp)
            _close(param_avg.exchange_average(t, ex),
                   jax_pa.exchange_average(j, jex), 1e-6)
    del tree["count"]
    _close(param_avg.unreplicate(tree_map(torch.from_numpy, tree)),
           jax_pa.unreplicate(jax.tree.map(jnp.asarray, tree)), 0.0)
    for comp, frac in (("none", 0.01), ("bf16", 0.01), ("topk", 0.05),
                       ("topk", 1.0)):
        for strategy in ("all_reduce", "none"):
            ex = param_avg.Exchanger(strategy, compression=comp,
                                     topk_frac=frac)
            jex = jax_pa.Exchanger(strategy, compression=comp,
                                   topk_frac=frac)
            assert ex.logical_bytes(t, 2) == jex.logical_bytes(j, 2)
            assert (ex.expected_collective is None) == \
                (jex.expected_collective is None)
    table = np.random.default_rng(2).normal(size=(11, 6)).astype(np.float32)

    def jdecode(params, cache, tokens, pos):
        return params[tokens] + pos[:, None, None], cache + 1

    def tdecode(params, cache, tokens, pos):
        return params[tokens.long()] + pos[:, None, None], cache + 1

    tokens = np.asarray([[3], [7], [0]], np.int32)
    pos = np.asarray([0.0, 1.0, 2.0], np.float32)
    jtok, jcache = jax_core.make_serve_step(jdecode)(
        jnp.asarray(table), jnp.zeros(()), jnp.asarray(tokens),
        jnp.asarray(pos))
    tok, cache = steps.make_serve_step(tdecode)(
        torch.from_numpy(table), torch.zeros(()), torch.from_numpy(tokens),
        torch.from_numpy(pos))
    assert tok.dtype == torch.int32 and tok.shape == (3, 1)
    assert tok.numpy().tolist() == np.asarray(jtok).tolist()
    assert float(cache) == float(jcache) == 1.0


# ------------------------------------------------------- checkpoints ----

def test_delayed_topk_checkpoints_cross_both_ways(delayed_runs, tmp_path):
    """The reference's delay=1 topk state after 3 steps restores in the
    port bit for bit, exchange slot included; the port's restores in the
    reference the same way."""
    jstate, state, _ = delayed_runs["topk"]
    jcfg, cfg = _pair()
    jex = jax_core.ExchangeConfig(delay=1, **DELAYED["topk"])
    fresh_j, fresh = _alexnet_states(jcfg, cfg, jex)
    jax_ckpt.save(str(tmp_path / "ref"), 3, jstate)
    got = checkpoint.restore(str(tmp_path / "ref"), 3, fresh)
    want = weights.state_from_reference(jstate, cfg, device="cpu")
    assert got.step == want.step == 3
    assert got.exchange is not None
    assert _same_bits((got.params, got.opt_state, got.exchange),
                      (want.params, want.opt_state, want.exchange))
    checkpoint.save(str(tmp_path / "port"), 3, state)
    back = jax_ckpt.restore(str(tmp_path / "port"), 3, fresh_j)
    mine = jax_core.TrainState(**weights.state_to_reference(state))
    assert int(back.step) == 3
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(mine),
                    strict=True):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
