"""The port's optimizer and schedules against the reference's, on the
same numpy trees and metric sequences."""
import numpy as np
import pytest
import torch

from repro_torch.optim import optimizers, schedules
from repro_torch.tree import tree_map

try:
    import jax
    import jax.numpy as jnp

    from repro.optim import optimizers as jax_opt
    from repro.optim import schedules as jax_sched
except ImportError:
    jax = None

TOL = 1e-6


def _tree(seed):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"convs": [{"w": a(3, 3, 2, 4), "b": a(4)}],
            "fcs": [{"w": a(8, 5), "b": a(5)}, {"w": a(5, 3), "b": a(3)}]}


def _torch(tree):
    return tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_matches_reference(nesterov):
    kw = dict(momentum=0.9, weight_decay=5e-4, nesterov=nesterov)
    jo, to = jax_opt.sgd_momentum(**kw), optimizers.sgd_momentum(**kw)
    params = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        grads = _tree(10 + step)
        ju, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp, 0.01)
        tu, ts = to.update(_torch(grads), ts, tp, 0.01)
        jp = jax_opt.apply_updates(jp, ju)
        tp = optimizers.apply_updates(tp, tu)
    # (jax orders dict leaves by key: compare leaf by leaf through the
    # port's tree instead of flattening both)
    tree_map(lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=TOL, atol=TOL),
        {"p": tp, "v": ts["velocity"]}, {"p": jp, "v": js["velocity"]})


def test_weight_decay_form():
    """v = m*v + (g + wd*p); p += -lr*v: the decay enters the velocity."""
    opt = optimizers.sgd_momentum(momentum=0.9, weight_decay=0.1)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    state = {"velocity": {"w": torch.tensor([1.0, 1.0])}}
    upd, state = opt.update(g, state, p, 0.5)
    want_v = 0.9 * torch.tensor([1.0, 1.0]) + (g["w"] + 0.1 * p["w"])
    torch.testing.assert_close(state["velocity"]["w"], want_v)
    torch.testing.assert_close(optimizers.apply_updates(p, upd)["w"],
                               p["w"] - 0.5 * want_v)


def test_unported_optimizers_raise():
    # adamw and the master-weights wrapper are ported now (the LM training
    # and numerics slices); an unknown name raises
    assert optimizers.get_optimizer("adamw").name == "adamw"
    assert optimizers.with_master_weights(
        optimizers.get_optimizer("adamw")).name == "adamw+master"
    with pytest.raises(ValueError, match="unknown optimizer"):
        optimizers.get_optimizer("lamb")


def test_adamw_matches_reference():
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    jo, to = jax_opt.adamw(**kw), optimizers.adamw(**kw)
    params = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        grads = _tree(10 + step)
        ju, js = jo.update(jax.tree.map(jnp.asarray, grads), js, jp, 0.01)
        tu, ts = to.update(_torch(grads), ts, tp, 0.01)
        jp = jax_opt.apply_updates(jp, ju)
        tp = optimizers.apply_updates(tp, tu)
    assert int(ts["count"]) == int(js["count"]) == 4
    assert ts["count"].dtype == torch.int32
    tree_map(lambda got, want: np.testing.assert_allclose(
        got.numpy(), np.asarray(want), rtol=TOL, atol=TOL),
        {"p": tp, "mu": ts["mu"], "nu": ts["nu"]},
        {"p": jp, "mu": js["mu"], "nu": js["nu"]})


@pytest.mark.parametrize("name,kw", [
    ("constant", dict(lr=0.01)),
    ("step_decay", dict(lr=0.1, decay_every=4, factor=0.1)),
    ("cosine", dict(lr=0.3, warmup=3, total=17)),
    ("wsd", dict(lr=0.2, warmup=2, stable=5, decay=6)),
])
def test_schedules_match_reference(name, kw):
    js = jax_sched.get_schedule(name, **kw)
    ts = getattr(schedules, name)(**kw)
    for step in range(20):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=TOL,
                                   atol=1e-9)


METRICS = [2.0, 1.5, 1.499, 1.6, 1.2, 1.2, 1.21, 1.19, 1.3, 1.3, 1.3, 0.9]


@pytest.mark.parametrize("mode,patience", [("min", 2), ("max", 1),
                                           ("min", 3)])
def test_plateau_decisions_match_reference(mode, patience):
    kw = dict(factor=0.1, patience=patience, threshold=1e-3, min_lr=1e-5,
              mode=mode)
    jc = jax_sched.plateau_decay(0.1, **kw)
    tc = schedules.plateau_decay(0.1, **kw)
    for m in METRICS:
        assert tc.update(m) == jc.update(m)
        assert tc.state_dict() == jc.state_dict()
        assert tc.schedule()(0) == pytest.approx(float(jc.schedule()(0)),
                                                 rel=1e-6)


def test_plateau_state_round_trips():
    """A controller restored from a mid-run state_dict makes the same
    decisions as the one that never stopped."""
    a = schedules.plateau_decay(0.1, patience=2)
    for m in METRICS[:6]:
        a.update(m)
    b = schedules.plateau_decay(0.1, patience=2)
    b.load_state_dict(a.state_dict())
    for m in METRICS[6:]:
        assert a.update(m) == b.update(m)
        assert a.state_dict() == b.state_dict()
    with pytest.raises(ValueError, match="factor"):
        schedules.plateau_decay(0.1, factor=1.5)
    assert isinstance(schedules.as_controller(schedules.constant(0.1)),
                      schedules.StaticController)
