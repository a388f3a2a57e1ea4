"""The port's AlexNet against the reference's, on the same weights.

Weights come from ``repro.models.init`` and cross through
``repro_torch.weights.from_reference`` (jax's RNG streams cannot be
matched in torch); images are numpy.  On the CPU the port runs the plain
versions of its kernels.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import alexnet as jax_cfgs
from repro.kernels.common import KernelPolicy as JaxPolicy
from repro.models import alexnet as jax_alexnet
from repro_torch import models, weights
from repro_torch.configs import alexnet as port_cfgs
from repro_torch.kernels.common import KernelPolicy, device_of
from repro_torch.models.alexnet import AlexNet

TOL = 1e-4


def _ref_params(cfg, seed=0):
    params = jax_models.init(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(np.asarray, params)


def _images(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.image_size, cfg.image_size,
                                cfg.in_channels)).astype(np.float32)


@pytest.mark.parametrize("name", ["SMOKE", "FAITHFUL_SMOKE"])
def test_weight_bridge_round_trips_bit_for_bit(name):
    params = _ref_params(getattr(jax_cfgs, name))
    model = weights.from_reference(params, getattr(port_cfgs, name),
                                   device="cpu")
    back = weights.to_reference(model)
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype == np.float32
        assert a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_weight_bridge_rejects_wrong_shapes():
    params = _ref_params(jax_cfgs.SMOKE)
    with pytest.raises(ValueError, match="expected float32"):
        weights.from_reference(params, port_cfgs.FAITHFUL_SMOKE, device="cpu")


@pytest.mark.parametrize("name,backend", [
    ("SMOKE", "xla"),               # LRN before the pool, ungrouped
    ("FAITHFUL_SMOKE", "xla"),      # pool then LRN, grouped conv2/4/5
    ("FAITHFUL_SMOKE", "pallas"),   # the reference's kernels, interpreted
])
def test_logits_match_reference(name, backend):
    jcfg = dataclasses.replace(getattr(jax_cfgs, name),
                               kernels=JaxPolicy(backend=backend))
    params = _ref_params(jcfg, seed=1)
    imgs = _images(jcfg, seed=1)
    want = np.asarray(jax_alexnet.forward(params, jcfg, jnp.asarray(imgs),
                                          conv_backend=backend))
    model = weights.from_reference(params, getattr(port_cfgs, name),
                                   device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(imgs))
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_faithful_param_count_at_full_width():
    model = AlexNet(port_cfgs.FAITHFUL, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 60_965_224


def test_init_is_seeded_and_he_scaled():
    cfg = port_cfgs.FAITHFUL_SMOKE

    def make(seed):
        return models.init(cfg, torch.Generator().manual_seed(seed),
                           device="cpu")

    a, b, c = make(0), make(0), make(1)
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    assert not torch.equal(a.conv_w[0], c.conv_w[0])
    w = a.conv_w[1]                       # grouped: fan-in over Cin/G
    fan_in = w.shape[0] * w.shape[1] * w.shape[2]
    assert abs(w.std().item() - (2.0 / fan_in) ** 0.5) < 0.1 * (
        2.0 / fan_in) ** 0.5
    assert all((b_ == 0).all() for b_ in a.conv_b)


def test_policy_backends_on_cpu():
    """``auto`` on CPU tensors is the plain version, bit for bit; a forced
    ``cuda`` backend refuses CPU tensors."""
    cfg = port_cfgs.SMOKE
    model = models.init(cfg, torch.Generator().manual_seed(2), device="cpu")

    def with_policy(pol):
        other = AlexNet(dataclasses.replace(cfg, kernels=pol), device="cpu")
        other.load_state_dict(model.state_dict())
        return other

    x = torch.from_numpy(_images(cfg, seed=2))
    with torch.no_grad():
        torch.testing.assert_close(
            model(x), with_policy(KernelPolicy(backend="plain"))(x),
            rtol=0, atol=0)
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            with_policy(KernelPolicy(backend="cuda"))(x)


def test_other_families_are_not_ported():
    # conv, dense and moe are ported, their decode states too; the other
    # LM families raise, at init and at the decode state
    cfg = types.SimpleNamespace(family="vlm", name="phi-3-vision-4.2b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        models.init(cfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        models.init_decode_state(cfg, 2, 16, device="cpu")


def test_conv_decode_state_only_moves_pos():
    st = models.init_decode_state(port_cfgs.FAITHFUL_SMOKE, 3, 16,
                                  device="cpu")
    assert st.cache == {} and st.pos.tolist() == [0, 0, 0]
    st2 = models.write_slots(
        st, models.DecodeState(cache={},
                               pos=torch.ones((1,), dtype=torch.int32)), [2])
    assert st2.pos.tolist() == [0, 0, 1]
    assert st.pos.tolist() == [0, 0, 0]       # the input state is untouched


def test_policy_validates_backends():
    assert KernelPolicy().describe() == {"backend": "auto"}
    assert KernelPolicy(backend="cuda").describe() == {"backend": "cuda"}
    with pytest.raises(ValueError, match="backend must be one of"):
        KernelPolicy(backend="pallas")
    with pytest.raises(ValueError, match="backend must be one of"):
        KernelPolicy(backend="xla")


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        assert device_of().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_of()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            AlexNet(port_cfgs.SMOKE)
    assert device_of("cpu").type == "cpu"
