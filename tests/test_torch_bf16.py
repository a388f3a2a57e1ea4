"""bf16 params through the port's optimizers and exchange, against the
reference's.

The LM zoo's published configs train bf16 params (``ModelConfig.dtype``).
The reference keeps SGD's velocity and AdamW's moments in fp32, does the
update math in fp32, adds the update in fp32 and casts back to the
param's dtype (``repro/optim/optimizers.py``), and averages every leaf in
fp32 before casting back (``Exchanger.average``).  The port must give
the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import param_avg
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import to_numpy, to_torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core import param_avg as jax_pa
    from repro.optim import optimizers as jax_opt
except ImportError:
    jax = None


def _tree(seed, lead=()):
    """A bf16 tree (as numpy bfloat16) of the LM's leaf kinds."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return jnp.asarray(rng.normal(size=lead + shape), jnp.bfloat16)

    return {"embed": {"tok": a(16, 8)}, "final_norm": {},
            "blocks": ({"attn": {"wq": a(3, 8, 2, 4)},
                        "ffn": {"w_in": a(3, 8, 12)}},)}


def _port(tree):
    return tree_map(to_torch, jax.tree.map(np.asarray, tree))


def _bits_equal(got, want):
    """Every port leaf has the reference leaf's dtype and bytes."""
    def check(g, w):
        w = np.asarray(w)
        assert to_numpy(g).dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(to_numpy(g).view(np.uint8),
                                      w.view(np.uint8))
    tree_map(check, got, jax.tree.map(np.asarray, want))


@pytest.mark.parametrize("name", ["sgd_momentum", "adamw"])
def test_optimizer_state_is_fp32_and_params_match_bit_for_bit(name):
    jo, to = jax_opt.get_optimizer(name), optimizers.get_optimizer(name)
    jp, tp = _tree(0), _port(_tree(0))
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        grads = _tree(10 + step)
        ju, js = jo.update(grads, js, jp, 0.01)
        tu, ts = to.update(_port(grads), ts, tp, 0.01)
        jp = jax_opt.apply_updates(jp, ju)
        tp = optimizers.apply_updates(tp, tu)
    _bits_equal(tp, jp)
    state = {k: v for k, v in ts.items() if k != "count"}
    assert all(t.dtype == torch.float32 for t in tree_leaves(state))
    tree_map(lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7), state,
        {k: v for k, v in js.items() if k != "count"})


def test_apply_updates_adds_in_fp32_and_keeps_the_dtype():
    p = _tree(1)
    u = jax.tree.map(lambda x: jnp.asarray(
        np.random.default_rng(2).normal(size=x.shape) * 1e-3, jnp.float32), p)
    want = jax_opt.apply_updates(p, u)
    got = optimizers.apply_updates(_port(p), _port(u))
    _bits_equal(got, want)


@pytest.mark.parametrize("strategy", ["all_reduce", "ring", "pairwise"])
def test_exchange_averages_bf16_leaves_in_fp32(strategy):
    """R=4 replicas of bf16 params and fp32 velocity: the averaged tree,
    bit for bit, and the leaves' dtypes kept."""
    tree = {"params": _tree(3, lead=(4,)),
            "velocity": jax.tree.map(lambda x: x.astype(jnp.float32) * 0.37,
                                     _tree(4, lead=(4,))),
            "count": jnp.full((4,), 7, jnp.int32)}
    want = jax_pa.Exchanger(strategy).average(tree)
    got = param_avg.Exchanger(strategy).average(_port(tree))
    _bits_equal(got, want)


@pytest.mark.parametrize("strategy", ["all_reduce", "ring", "pairwise"])
def test_exchange_in_place_matches_reference(strategy, monkeypatch):
    """``average_`` writes the same bits into the tree's own tensors,
    chunk by chunk (chunks cut small so that every leaf spans several),
    the leaves' dtypes kept."""
    monkeypatch.setattr(param_avg, "CHUNK", 5)
    tree = {"params": _tree(3, lead=(4,)),
            "velocity": jax.tree.map(lambda x: x.astype(jnp.float32) * 0.37,
                                     _tree(4, lead=(4,))),
            "count": jnp.full((4,), 7, jnp.int32)}
    want = jax_pa.Exchanger(strategy).average(tree)
    got = _port(tree)
    param_avg.Exchanger(strategy).average_(got)
    _bits_equal(got, want)
