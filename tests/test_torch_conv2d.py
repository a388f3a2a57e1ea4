"""The port's grouped implicit-GEMM conv against the reference's.

On the CPU ``repro_torch``'s ``conv2d_fused`` runs its plain version; the
reference's ``conv2d_fused`` runs its Pallas kernel in interpret mode
(what ``auto`` gives on a CPU host).  Both get the same numpy inputs.
The tests marked ``cuda`` hold the CUDA kernel against the plain version
and skip on a host without a card; they import no JAX, so they run on a
GPU host with ``python -m pytest -m cuda tests/test_torch_*.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ALEXNET, ALEXNET_FAITHFUL
from repro_torch.kernels.conv2d import ops, ref

try:
    import jax.numpy as jnp

    from repro.kernels.conv2d import ops as jax_ops
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jnp = jax_ops = None

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(b, hw, cin, cout, kernel, groups, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, hw, hw, cin)).astype(np.float32)
    w = (rng.normal(size=(kernel, kernel, cin // groups, cout))
         * (2.0 / (kernel * kernel * cin // groups)) ** 0.5).astype(np.float32)
    bb = (rng.normal(size=(cout,)) * 0.1).astype(np.float32) if bias else None
    return x, w, bb


def _both(x, w, bias, **kw):
    t = ops.conv2d_fused(torch.from_numpy(x), torch.from_numpy(w),
                         bias=None if bias is None else torch.from_numpy(bias),
                         **kw)
    j = jax_ops.conv2d_fused(jnp.asarray(x), jnp.asarray(w),
                             bias=None if bias is None else jnp.asarray(bias),
                             **kw)
    return t.numpy(), np.asarray(j)


def _registry_example(grouped, seed=0):
    """The inputs of the reference registry's ``conv2d`` and
    ``conv2d_grouped`` examples (repro/kernels/conv2d/ops.py)."""
    rng = np.random.default_rng(seed)
    c, co = (8, 12) if grouped else (5, 11)
    x = rng.normal(size=(2, 13, 13, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c // (2 if grouped else 1), co))
         * 0.2).astype(np.float32)
    return x, w


@pytest.mark.parametrize("grouped,stride,padding,groups", [
    (False, 2, 1, 1),       # registry op "conv2d"
    (True, 1, 1, 2),        # registry op "conv2d_grouped"
], ids=["conv2d", "conv2d_grouped"])
def test_registry_examples_match_reference(grouped, stride, padding, groups):
    x, w = _registry_example(grouped)
    got, want = _both(x, w, None, stride=stride, padding=padding,
                      groups=groups)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _layers(cfg, sizes):
    cin = [cfg.in_channels] + [c.out_channels for c in cfg.convs[:-1]]
    return [pytest.param(cs.kernel, cs.stride, cs.padding, ci,
                         cs.out_channels, cs.groups, hw,
                         id=f"{cfg.name}-conv{i + 1}")
            for i, (cs, ci, hw) in enumerate(zip(cfg.convs, cin, sizes))
            if cfg is ALEXNET or cs.groups > 1]


# the full-width nets' layer geometry (kernel, stride, padding, channels,
# groups) at reduced spatial size so interpret mode stays fast
ALEXNET_LAYERS = (_layers(ALEXNET, [19, 8, 6, 6, 6])
                  + _layers(ALEXNET_FAITHFUL, [19, 8, 6, 6, 6]))


@pytest.mark.parametrize("kernel,stride,padding,cin,cout,groups,hw",
                         ALEXNET_LAYERS)
def test_alexnet_layers_match_reference(kernel, stride, padding, cin, cout,
                                        groups, hw):
    x, w, b = _inputs(2, hw, cin, cout, kernel, groups)
    got, want = _both(x, w, b, stride=stride, padding=padding, relu=True,
                      groups=groups)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_epilogue_matches_reference(bias, relu):
    x, w, b = _inputs(2, 9, 6, 10, 3, 2, seed=3, bias=bias)
    got, want = _both(x, w, b, stride=1, padding=1, relu=relu, groups=2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if relu:
        assert (got >= 0).all()


@pytest.mark.parametrize("wshape,groups,match", [
    ((3, 3, 4, 12), 1, "w in-channels 4 x groups 1 != x channels 8"),
    ((3, 3, 4, 9), 2, "cout 9 not divisible by groups 2"),
])
def test_same_value_errors_as_reference(wshape, groups, match):
    x = np.zeros((1, 5, 5, 8), np.float32)
    w = np.zeros(wshape, np.float32)
    with pytest.raises(ValueError, match=match):
        ops.conv2d_fused(torch.from_numpy(x), torch.from_numpy(w), stride=1,
                         padding=0, groups=groups)
    with pytest.raises(ValueError, match=match):
        jax_ops.conv2d_fused(jnp.asarray(x), jnp.asarray(w), stride=1,
                             padding=0, groups=groups)


def test_cuda_backend_refuses_cpu_tensors():
    x, w, _ = _inputs(1, 5, 4, 4, 3, 1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.conv2d_fused(torch.from_numpy(x), torch.from_numpy(w), stride=1,
                         padding=1, backend="cuda")


def test_plain_backend_never_counts_a_launch():
    x, w, b = _inputs(1, 7, 4, 6, 3, 2)
    before = ops.conv2d_fused.launches
    ops.conv2d_fused(torch.from_numpy(x), torch.from_numpy(w), stride=1,
                     padding=1, bias=torch.from_numpy(b), groups=2)
    assert ops.conv2d_fused.launches == before


# kernel edge cases: ragged M and N tiles, Cg below and across BK, padding
# wider than a stride, odd strides, 1x1 windows, no bias, no ReLU
CUDA_CASES = [
    # b, hw, cin, cout, kernel, stride, padding, groups, bias, relu
    (2, 13, 5, 11, 3, 2, 1, 1, False, False),
    (2, 13, 8, 12, 3, 1, 1, 2, True, True),
    (3, 27, 3, 96, 11, 4, 0, 1, True, True),
    (2, 9, 96, 256, 5, 1, 2, 2, True, True),
    (1, 13, 384, 384, 3, 1, 1, 2, True, False),
    (2, 11, 9, 9, 3, 3, 2, 3, True, True),
    (1, 10, 16, 70, 1, 1, 0, 1, True, True),
    (1, 17, 6, 130, 5, 2, 3, 2, False, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,hw,cin,cout,kernel,stride,padding,groups,bias,relu", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, b, hw, cin, cout, kernel, stride,
                                   padding, groups, bias, relu):
    x, w, bb = _inputs(b, hw, cin, cout, kernel, groups, seed=5, bias=bias)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    bt = None if bb is None else torch.from_numpy(bb).to(cuda)
    before = ops.conv2d_fused.launches
    with torch.no_grad():
        got = ops.conv2d_fused(xt, wt, stride=stride, padding=padding,
                               bias=bt, relu=relu, groups=groups)
        torch.cuda.synchronize()
    assert ops.conv2d_fused.launches == before + 1
    want = ref.conv2d_ref(xt, wt, stride, padding, groups, bias=bt,
                          relu=relu)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
