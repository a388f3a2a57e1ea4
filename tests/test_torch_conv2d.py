"""The port's grouped implicit-GEMM conv against the reference's.

On the CPU ``repro_torch``'s ``conv2d_fused`` runs its plain version; the
reference's ``conv2d_fused`` runs its Pallas kernel in interpret mode
(what ``auto`` gives on a CPU host).  Both get the same numpy inputs.
The tests marked ``cuda`` hold the CUDA kernel against the plain version
and skip on a host without a card; they import no JAX, so they run on a
GPU host with ``python -m pytest -m cuda tests/test_torch_*.py``.
"""
import re
from pathlib import Path

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
    # the five layers of the faithful AlexNet at the serving batch (conv_tiles
    # picks widths 96 and 128 and splits conv3-5), and a ragged Cg = 5
    # (4-byte copies of x and of w's 18-wide slab) with padding
    (8, 227, 3, 96, 11, 4, 0, 1, True, True),
    (8, 27, 96, 256, 5, 1, 2, 2, True, True),
    (8, 13, 256, 384, 3, 1, 1, 1, True, True),
    (8, 13, 384, 384, 3, 1, 1, 2, True, True),
    (8, 13, 384, 256, 3, 1, 1, 2, True, True),
    (2, 15, 10, 36, 3, 1, 2, 2, True, True),
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


@pytest.mark.cuda
def test_conv_is_deterministic(cuda):
    """Where conv_tiles splits the reduction (conv3 at the serving batch),
    the partials are added in split order by a second kernel, not by
    atomics: two calls agree bit for bit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.conv_tiles(8 * 13 * 13, 384, 9 * 256, 1, sms)[1] > 1
    x, w, bb = _inputs(8, 13, 256, 384, 3, 1, seed=6)
    xt, wt, bt = (torch.from_numpy(a).to(cuda) for a in (x, w, bb))
    with torch.no_grad():
        first = ops.conv2d_fused(xt, wt, stride=1, padding=1, bias=bt,
                                 relu=True)
        second = ops.conv2d_fused(xt, wt, stride=1, padding=1, bias=bt,
                                  relu=True)
    assert torch.equal(first, second)


def test_conv_tile_constants_match_the_kernel():
    """``CONV_BM``, ``CONV_BK`` and ``CONV_BNS`` mirror the kernel's BM,
    BK and the tile widths its entry point launches."""
    src = (Path(ops.__file__).parent / "csrc"
           / "conv2d_fused.cu").read_text()
    bm = re.search(r"constexpr int BM = (\d+);", src)
    bk = re.search(r"constexpr int BK = (\d+);", src)
    widths = [int(a) for a, b in re.findall(
        r"case (\d+):\n\s+e = launch_vec<(\d+)>", src) if a == b]
    assert bm and bk and widths, "the kernel's tile constants moved"
    assert ops.CONV_BM == int(bm.group(1))
    assert ops.CONV_BK == int(bk.group(1))
    assert tuple(sorted(widths)) == ops.CONV_BNS


@pytest.mark.parametrize("kdim,n_split", [(363, 1), (1200, 3), (2304, 4),
                                          (1728, 6), (100, 4), (16, 1)])
def test_conv_ranges_cover_each_chunk_once(kdim, n_split):
    """The splits take every reduction chunk exactly once, none empty, in
    the kernel's runs (``c_lo`` / ``c_hi``)."""
    runs = ops.conv_ranges(kdim, n_split)
    chunks = -(-kdim // ops.CONV_BK)
    per = -(-chunks // n_split)
    assert runs == [(z * per, min(chunks, (z + 1) * per))
                    for z in range(len(runs))]
    assert runs[0][0] == 0 and runs[-1][1] == chunks
    assert all(lo < hi for lo, hi in runs)


def _alexnet_convs():
    """(config, layer, batch, M, npg, K*K*Cg, groups) of every conv of
    both AlexNets at the serving and the training batch."""
    out = []
    for cfg in (ALEXNET_FAITHFUL, ALEXNET):
        c_in, hw = cfg.in_channels, cfg.image_size
        for i, cs in enumerate(cfg.convs):
            oh = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
            for batch in (8, 128):
                out.append(pytest.param(
                    batch * oh * oh, cs.out_channels // cs.groups,
                    cs.kernel ** 2 * c_in // cs.groups, cs.groups, batch,
                    id=f"{cfg.name}-conv{i + 1}-b{batch}"))
            hw = (oh - 3) // 2 + 1 if cs.pool else oh
            c_in = cs.out_channels
    return out


@pytest.mark.parametrize("npg", [1, 11, 65, 130, 200])
def test_conv_tiles_take_any_group_width(npg):
    """Where no tile width divides the group's channels the rule still
    picks one (the last tile is ragged) and a split that covers the
    chunks."""
    bn, n_split = ops.conv_tiles(1000, npg, 300, 1, 132)
    assert bn in ops.CONV_BNS
    assert len(ops.conv_ranges(300, n_split)) == n_split


@pytest.mark.parametrize("m,npg,kdim,groups,batch", _alexnet_convs())
def test_conv_tiles_fit_alexnet(m, npg, kdim, groups, batch):
    """At every AlexNet layer the rule's width divides the group's
    channels (no ragged tile), its split covers the chunks with none
    empty, and at the serving batch the grid fills a wave of the card's
    132 SMs or the reduction is split over blocks."""
    sms = 132
    bn, n_split = ops.conv_tiles(m, npg, kdim, groups, sms)
    assert bn in ops.CONV_BNS and npg % bn == 0
    assert len(ops.conv_ranges(kdim, n_split)) == n_split
    blocks = -(-m // ops.CONV_BM) * (npg // bn) * groups
    if batch == 8:
        assert blocks >= sms or n_split > 1
