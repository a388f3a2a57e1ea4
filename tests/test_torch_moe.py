"""The port's mixture-of-experts FFN and moe LM against the reference's.

The reference runs live on the CPU: ``repro.models.moe.moe_apply`` on
its batched-einsum route and, under ``KernelPolicy(matmul="pallas",
interpret=True)``, on its per-expert Pallas GEMMs in interpret mode; the
port runs the library's batched product and, under
``KernelPolicy(matmul="kernel")``, ``matmul_bias``'s plain version (the
kernel runs on CUDA tensors only).  Weights come from the reference's
``moe_init`` / ``repro.models.init`` through the weight bridge, inputs
from numpy.  Reduced configs: ``mixtral-8x7b`` (top-2, swiglu) and
``llama4-maverick-400b-a17b`` (top-1 and a shared expert), 4 experts,
fp32; one hand-built config interleaves dense and moe layers
(``every_k = 2``).  Tolerance: 1e-4 on outputs, aux and grads (fp32
sums in another order), as the dense LM's tests.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import models, weights
from repro_torch.configs import ARCHS, MoEConfig, reduced
from repro_torch.kernels.common import KernelPolicy
from repro_torch.models import moe, transformer
from repro_torch.tree import (flatten_with_paths, tree_leaves, tree_map,
                              unflatten_like)

try:
    import jax
    import jax.numpy as jnp

    from repro import models as jax_models
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs import MoEConfig as JaxMoEConfig
    from repro.configs import reduced as jax_reduced
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.models import moe as jax_moe
except ImportError:      # a GPU host without JAX
    jax = None

TOL = 1e-4
WIDTH = 64
ARCH_NAMES = ["mixtral-8x7b", "llama4-maverick-400b-a17b"]
# capacity factors: 0.5 drops (half the mean assignments per expert fit),
# the expert count (4) is dropless
CAPS = {"drop": 0.5, "dropless": 4.0}
ROUTES = {"einsum": (JaxPolicy(), KernelPolicy()),
          "kernel": (JaxPolicy(matmul="pallas", interpret=True),
                     KernelPolicy(matmul="kernel"))}


def _cfgs(arch, dispatch="flat", route="einsum", **moe_kw):
    jcfg = jax_reduced(JAX_ARCHS[arch], 2, WIDTH)
    cfg = reduced(ARCHS[arch], 2, WIDTH)
    jpol, pol = ROUTES[route]
    jcfg = dataclasses.replace(
        jcfg, kernels=jpol,
        moe=dataclasses.replace(jcfg.moe, dispatch=dispatch, **moe_kw))
    cfg = dataclasses.replace(
        cfg, kernels=pol,
        moe=dataclasses.replace(cfg.moe, dispatch=dispatch, **moe_kw))
    return jcfg, cfg


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    tree_map(lambda g, w: np.testing.assert_allclose(
        g.detach().float().numpy(), np.asarray(w, np.float32), rtol=tol,
        atol=tol), got, want)


@pytest.fixture(scope="module")
def ffn_params():
    """Each arch's reference moe FFN params (numpy), from one init."""
    return {arch: _host(jax_moe.moe_init(
        jax.random.PRNGKey(1), jax_reduced(JAX_ARCHS[arch], 2, WIDTH),
        jnp.float32)) for arch in ARCH_NAMES}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("dispatch", ["flat", "rowwise"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_moe_apply_matches_reference(ffn_params, arch, dispatch, route):
    """out, aux and the grads of every param and of x, flat and rowwise,
    at a capacity that drops tokens and at the dropless one (one jitted
    reference call for both), on the einsum route and on the matmul
    opt-in."""
    jcfg, cfg = _cfgs(arch, dispatch, route)
    jp = ffn_params[arch]
    x = np.random.default_rng(2).normal(
        size=(2, 12, WIDTH)).astype(np.float32)

    def jloss(p, x_, cf):
        out, aux = jax_moe.moe_apply(p, jcfg, x_, capacity_factor=cf)
        return jnp.sum(jnp.sin(out)) + aux, (out, aux)

    @jax.jit
    def both(p, x_):
        return {cap: jax.value_and_grad(
            lambda p_, y_: jloss(p_, y_, cf), argnums=(0, 1),
            has_aux=True)(p, x_) for cap, cf in CAPS.items()}

    want = both(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    outs = {}
    for cap, cf in CAPS.items():
        (_, (jout, jaux)), jgrads = want[cap]
        p = tree_map(lambda a: torch.from_numpy(a.copy()).requires_grad_(),
                     jp)
        xt = torch.from_numpy(x).requires_grad_()
        out, aux = moe.moe_apply(p, cfg, xt, capacity_factor=cf)
        (torch.sin(out).sum() + aux).backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   rtol=TOL, atol=TOL, err_msg=cap)
        assert aux.dtype == torch.float32
        assert aux.item() == pytest.approx(float(jaux), abs=1e-6)
        _close(tree_map(lambda t: t.grad, p), jgrads[0])
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrads[1]),
                                   rtol=TOL, atol=TOL, err_msg=cap)
        outs[cap] = out.detach()
    # the small capacity does drop: the dropless one gives another output
    assert not torch.allclose(outs["drop"], outs["dropless"], atol=1e-3)


def test_capacity_is_the_references():
    """``round`` as the reference's (Python's, half to even), clamped to
    [1, T*k]."""
    for t, k, cf, e in [(16, 2, 1.25, 8), (2048, 2, 1.25, 8), (5, 1, 0.5, 4),
                        (3, 2, 8.0, 8), (1, 1, 0.01, 128), (10, 2, 0.25, 4)]:
        assert moe.capacity(t, k, cf, e) == int(
            max(1, min(t * k, round(t * k * cf / e))))
    assert moe.capacity(2048, 2, 1.25, 8) == 640
    assert moe.capacity(8, 2, 8.0, 8) == 16        # decode: dropless


def test_ties_route_to_the_lower_expert_as_the_reference():
    """Equal router probabilities (bf16 logits tie) pick the lower expert
    id first, as ``jax.lax.top_k``."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = moe._top_k(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 2]]
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert np.asarray(ji).tolist() == idx.tolist()


def test_matmul_opt_in_is_explicit(ffn_params, monkeypatch):
    """Only ``matmul="kernel"`` routes the expert FFN through
    ``matmul_bias`` (3 calls per expert for a gated MLP); the global
    backend never flips it, as the reference's ``wants_pallas``."""
    assert KernelPolicy(matmul="kernel").describe() == {
        "backend": "auto", "matmul": "kernel"}
    with pytest.raises(ValueError, match="matmul must be one of"):
        KernelPolicy(matmul="pallas")
    assert not JaxPolicy(backend="pallas").wants_pallas("matmul")
    calls = []
    real = moe.matmul_bias

    def counting(*a, **k):
        calls.append(k["backend"])
        return real(*a, **k)

    monkeypatch.setattr(moe, "matmul_bias", counting)
    p = tree_map(torch.from_numpy, ffn_params["mixtral-8x7b"])
    x = torch.zeros((1, 4, WIDTH))
    for backend in ("auto", "plain", "cuda"):
        _, cfg = _cfgs("mixtral-8x7b")
        cfg = dataclasses.replace(cfg, kernels=KernelPolicy(backend=backend))
        moe.moe_apply(p, cfg, x)
        assert calls == []
    _, cfg = _cfgs("mixtral-8x7b", route="kernel")
    cfg = dataclasses.replace(cfg, kernels=KernelPolicy(backend="plain",
                                                        matmul="kernel"))
    moe.moe_apply(p, cfg, x)
    assert calls == ["plain"] * 3 * cfg.moe.n_experts


def test_moe_init_matches_the_references_tree():
    """Param names and shapes, shared expert and gate included."""
    for arch in ARCH_NAMES:
        jcfg, cfg = _cfgs(arch)
        want = jax.tree.map(lambda a: tuple(a.shape), jax_moe.moe_init(
            jax.random.PRNGKey(0), jcfg, jnp.float32))
        got = tree_map(lambda t: tuple(t.shape), moe.moe_init(
            cfg, torch.Generator().manual_seed(0), torch.float32, "cpu"))
        assert got == want == moe.param_shapes(cfg)


# ------------------------------------------------------------ the LM ------

def _tokens(cfg, shape, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _every_k_pair():
    """A hand-built reduced llama4-like config with 3 layers interleaving
    dense and moe FFNs (every_k = 2: pattern (dense, moe), one superblock
    and one dense remainder layer)."""
    jcfg = jax_reduced(JAX_ARCHS["llama4-maverick-400b-a17b"], 3, WIDTH)
    cfg = reduced(ARCHS["llama4-maverick-400b-a17b"], 3, WIDTH)
    jcfg = dataclasses.replace(jcfg, moe=JaxMoEConfig(
        n_experts=4, top_k=1, shared_expert=True, every_k=2))
    cfg = dataclasses.replace(cfg, moe=MoEConfig(
        n_experts=4, top_k=1, shared_expert=True, every_k=2))
    return jcfg, cfg


@pytest.mark.parametrize("arch", ARCH_NAMES + ["every_k_2"])
def test_lm_loss_with_aux_matches_reference(arch):
    """The LM's logits, aux, loss (cross-entropy + aux) and every param
    grad against ``repro.models.loss_fn``, through the weight bridge both
    ways."""
    if arch == "every_k_2":
        jcfg, cfg = _every_k_pair()
        assert transformer.block_kinds(cfg) == ("dense", "moe")
        assert transformer.layer_kinds(cfg) == ["dense", "moe", "dense"]
    else:
        jcfg, cfg = _cfgs(arch)
    params = jax_models.init(jax.random.PRNGKey(0), jcfg)
    batch = _tokens(cfg, (2, 16))
    jb = jax.tree.map(jnp.asarray, batch)
    (want_loss, want_grads), (want_logits, want_aux) = jax.jit(
        lambda p: (jax.value_and_grad(
            lambda q: jax_models.loss_fn(q, jcfg, jb))(p),
            jax_models.logits_fn(p, jcfg, jb)))(params)
    assert float(want_aux) > 0

    host = _host(params)
    p = weights.lm_from_reference(host, cfg, device="cpu")
    back = weights.lm_to_reference(p)
    tree_map(np.testing.assert_array_equal, back, host)
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_()
    tb = tree_map(torch.from_numpy, batch)
    logits, aux = models.logits_fn(p, cfg, tb)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=TOL, atol=TOL)
    assert aux.item() == pytest.approx(float(want_aux), abs=1e-6)
    loss = models.loss_fn(p, cfg, tb)
    assert loss.item() == pytest.approx(float(want_loss), abs=TOL)
    grads = unflatten_like(p, dict(zip(flatten_with_paths(p),
                                       torch.autograd.grad(loss, leaves))))
    _close(grads, want_grads)


def test_train_state_bridge_carries_moe_params():
    """A replicated TrainState (R=2) crosses both ways bit for bit."""
    jcfg, cfg = _cfgs("mixtral-8x7b")
    params = _host(jax_models.init(jax.random.PRNGKey(3), jcfg))
    stacked = jax.tree.map(lambda a: np.stack([a, a + 1]), params)
    opt = {"velocity": jax.tree.map(np.zeros_like, stacked)}
    state = type("S", (), {"params": stacked, "opt_state": opt,
                           "step": np.int32(5)})()
    ts = weights.state_from_reference(state, cfg, device="cpu")
    assert ts.step == 5
    back = weights.state_to_reference(ts)
    tree_map(np.testing.assert_array_equal, back["params"], stacked)
    assert ts.params["blocks"][0]["ffn"]["w_in"].shape == (
        2, 2, 4, WIDTH, cfg.d_ff)
