"""Gradients of the port's kernels and of AlexNet against ``jax.grad``
through the reference.

The port's conv and LRN wrappers are ``torch.autograd.Function``s whose
backwards mirror the reference's ``custom_vjp``s (``_conv_fused_bwd``,
``_lrn_bwd``).  On the CPU the forward runs the plain version; the
reference runs its Pallas kernels in interpret mode or its XLA path.
AlexNet's loss and every parameter grad are held against
``repro.models.alexnet.loss_fn`` on the golden-trace setup (smoke nets at
48x48).  Tests marked ``cuda`` hold the card's kernels against the plain
versions through the same Functions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import alexnet as port_cfgs
from repro_torch.kernels.common import KernelPolicy
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.lrn import ops as lrn_ops
from repro_torch.models import alexnet
from repro_torch.tree import tree_leaves, tree_map

try:
    import jax
    import jax.numpy as jnp

    from repro import models as jax_models
    from repro.configs import alexnet as jax_cfgs
    from repro.kernels.common import KernelPolicy as JaxPolicy
    from repro.models import alexnet as jax_alexnet
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

CONV_TOL = 2e-4
LRN_TOL = 1e-4
MODEL_TOL = 1e-4
IMAGE_SIZE = 48          # tests/train_loop/test_golden_traces.py's setup


@pytest.fixture
def cuda():
    """The card, with cuDNN's TF32 off: the backward's library conv-grad
    would otherwise round its operands to 10-bit mantissas, and two runs
    whose cotangents differ in the last bits could differ by 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _conv_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 9, 9, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 4, 12)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(12,)) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("need_x", [True, False], ids=["dx", "no-dx"])
def test_conv_grads_match_jax(backend, need_x):
    x, w, b = _conv_inputs()
    kw = dict(stride=2, padding=1, relu=True, groups=2)

    def jloss(x_, w_, b_):
        y = jax_alexnet.conv2d(x_, w_, b_, kw["stride"], kw["padding"],
                               backend, relu=True, groups=2,
                               interpret=True)
        return jnp.sum(jnp.sin(y))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    xt = torch.tensor(x, requires_grad=need_x)
    wt, bt = (torch.tensor(a, requires_grad=True) for a in (w, b))
    torch.sin(conv_ops.conv2d_fused(xt, wt, bias=bt, **kw)).sum().backward()
    assert (xt.grad is not None) == need_x
    got = (xt.grad, wt.grad, bt.grad)
    for i, (g, r) in enumerate(zip(got, want)):
        if g is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       rtol=CONV_TOL, atol=CONV_TOL,
                                       err_msg=f"grad {i}")


# The reference's closed-form backward (``_lrn_bwd``, which the port
# mirrors) is the exact VJP only for odd n, where the channel window is
# symmetric; for even n only its Pallas path uses it, while its XLA path
# differentiates ``lrn_ref`` and differs.  So even n is held against the
# Pallas path alone.
@pytest.mark.parametrize("backend,n", [("xla", 5), ("pallas", 5),
                                       ("pallas", 4)])
def test_lrn_grads_match_jax(backend, n):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 5, 24)) * 3).astype(np.float32)
    c = np.linspace(-1, 1, 24).astype(np.float32)

    def jloss(x_):
        y = jax_alexnet.lrn(x_, n=n, alpha=1e-3, backend=backend,
                            interpret=True)
        return jnp.sum(y * c)

    want = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (lrn_ops.lrn(xt, n=n, alpha=1e-3) * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want),
                               rtol=LRN_TOL, atol=LRN_TOL)


def _setup(name, seed=0, batch=4):
    jcfg = dataclasses.replace(getattr(jax_cfgs, name),
                               image_size=IMAGE_SIZE,
                               kernels=JaxPolicy(backend="xla"))
    params = jax.tree.map(np.asarray,
                          jax_models.init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((batch, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(
        np.float32)
    labels = rng.integers(0, jcfg.n_classes, batch).astype(np.int32)
    return jcfg, params, imgs, labels


@pytest.mark.parametrize("conv", [None, "im2col_ref"],
                         ids=["fused", "im2col_ref"])
@pytest.mark.parametrize("name", ["SMOKE", "FAITHFUL_SMOKE"])
def test_alexnet_loss_and_grads_match_reference(name, conv):
    jcfg, params, imgs, labels = _setup(name)
    want_loss, want = jax.value_and_grad(
        lambda p: jax_alexnet.loss_fn(p, jcfg, jnp.asarray(imgs),
                                      jnp.asarray(labels)))(params)
    cfg = dataclasses.replace(getattr(port_cfgs, name),
                              image_size=IMAGE_SIZE,
                              kernels=KernelPolicy(conv2d=conv))
    p = tree_map(lambda a: torch.tensor(a, requires_grad=True), params)
    loss = alexnet.loss_fn(p, cfg, torch.from_numpy(imgs),
                           torch.from_numpy(labels))
    grads = torch.autograd.grad(loss, tree_leaves(p))
    assert abs(loss.item() - float(want_loss)) <= MODEL_TOL
    want_leaves = tree_leaves(tree_map(np.asarray, want))
    assert len(grads) == len(want_leaves) == 16
    for g, r in zip(grads, want_leaves):
        np.testing.assert_allclose(g.numpy(), r, rtol=MODEL_TOL,
                                   atol=MODEL_TOL)


def test_module_forward_is_the_functional_forward():
    cfg = dataclasses.replace(port_cfgs.FAITHFUL_SMOKE, image_size=IMAGE_SIZE)
    model = alexnet.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, IMAGE_SIZE, IMAGE_SIZE, 3)
    torch.testing.assert_close(model(x), alexnet.forward(model.params(), cfg,
                                                         x), rtol=0, atol=0)
    assert all(p.requires_grad for p in model.parameters())


def test_dropout_statistics():
    """The reference's dropout (``models/alexnet.py``): keep 1-p of the FC
    activations and scale the kept ones by 1/(1-p).  The two RNG streams
    cannot match, so only the statistics are checked."""
    h = torch.rand(256, 512) + 0.5
    out = alexnet.dropout(h, 0.5, torch.Generator().manual_seed(3))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01
    torch.testing.assert_close(out[kept], h[kept] / 0.5, rtol=0, atol=0)
    again = alexnet.dropout(h, 0.5, torch.Generator().manual_seed(3))
    torch.testing.assert_close(out, again, rtol=0, atol=0)
    assert abs((alexnet.dropout(h, 0.2, torch.Generator().manual_seed(4))
                != 0).float().mean().item() - 0.8) < 0.01


def test_dropout_runs_only_when_training():
    cfg = dataclasses.replace(port_cfgs.FAITHFUL_SMOKE, image_size=IMAGE_SIZE)
    params = alexnet.init(cfg, torch.Generator().manual_seed(0),
                          device="cpu").params()
    x = torch.randn(4, IMAGE_SIZE, IMAGE_SIZE, 3)
    with torch.no_grad():
        y_eval = alexnet.forward(params, cfg, x)
        y_off = alexnet.forward(params, cfg, x, train=False,
                                generator=torch.Generator())
        y_train = alexnet.forward(params, cfg, x, train=True,
                                  generator=torch.Generator().manual_seed(0))
        no_rate = dataclasses.replace(cfg, dropout=0.0)
        y_zero = alexnet.forward(params, no_rate, x, train=True)
    torch.testing.assert_close(y_eval, y_off, rtol=0, atol=0)
    torch.testing.assert_close(y_eval, y_zero, rtol=0, atol=0)
    assert not torch.equal(y_eval, y_train)
    with pytest.raises(ValueError, match="Generator"):
        alexnet.forward(params, cfg, x, train=True)


# With ReLU the mask comes from each forward's own y, and a pre-activation
# within rounding of 0 can flip it between kernel and plain version (a
# real difference of the two forwards, not of the backward), so the
# grouped cases compare the linear conv.
@pytest.mark.cuda
@pytest.mark.parametrize("groups,stride,padding,need_x,relu", [
    (1, 4, 0, False, True), (2, 1, 2, True, False), (2, 1, 1, True, False)])
def test_cuda_conv_grads_match_plain(cuda, groups, stride, padding, need_x,
                                     relu):
    rng = np.random.default_rng(groups + stride)
    cin = 6 if groups == 2 else 3
    x = rng.normal(size=(2, 19, 19, cin)).astype(np.float32)
    w = (rng.normal(size=(5, 5, cin // groups, 16)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(16,)) * 0.1).astype(np.float32)
    grads = {}
    for backend in ("cuda", "plain"):
        xt = torch.tensor(x, device=cuda, requires_grad=need_x)
        wt, bt = (torch.tensor(a, device=cuda, requires_grad=True)
                  for a in (w, b))
        y = conv_ops.conv2d_fused(xt, wt, bias=bt, stride=stride,
                                  padding=padding, relu=relu, groups=groups,
                                  backend=backend)
        torch.sin(y).sum().backward()
        grads[backend] = (xt.grad, wt.grad, bt.grad)
    for got, want in zip(grads["cuda"], grads["plain"]):
        assert (got is None) == (want is None)
        if got is not None:
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert (grads["cuda"][0] is None) == (not need_x)


@pytest.mark.cuda
def test_cuda_lrn_grads_match_plain(cuda):
    x = torch.randn(2, 7, 7, 96, device=cuda) * 3
    grads = {}
    for backend in ("cuda", "plain"):
        xt = x.clone().requires_grad_()
        before = lrn_ops.lrn.launches
        torch.cos(lrn_ops.lrn(xt, backend=backend)).sum().backward()
        assert lrn_ops.lrn.launches == before + (backend == "cuda")
        grads[backend] = xt.grad
    torch.testing.assert_close(grads["cuda"], grads["plain"], rtol=1e-4,
                               atol=1e-5)
