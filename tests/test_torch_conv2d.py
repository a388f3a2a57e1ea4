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


# bf16 kernel vs its plain version (upcast, fp32 math, one rounding):
# chip_smoke.py's BF16_TOL, 2 bf16 ulps of max |y|
BF16_TOL = 8e-3


def _bf16_close(got, want):
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    assert err <= BF16_TOL * top, f"max |err| {err} beyond {BF16_TOL} x {top}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "b,hw,cin,cout,kernel,stride,padding,groups,bias,relu", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, b, hw, cin, cout, kernel, stride,
                                   padding, groups, bias, relu, dtype):
    x, w, bb = _inputs(b, hw, cin, cout, kernel, groups, seed=5, bias=bias)
    xt = torch.from_numpy(x).to(cuda, dtype)
    wt = torch.from_numpy(w).to(cuda, dtype)
    bt = None if bb is None else torch.from_numpy(bb).to(cuda, dtype)
    counter = "launches" if dtype == torch.float32 else "launches_bf16"
    before = getattr(ops.conv2d_fused, counter)
    with torch.no_grad():
        got = ops.conv2d_fused(xt, wt, stride=stride, padding=padding,
                               bias=bt, relu=relu, groups=groups)
        torch.cuda.synchronize()
    assert getattr(ops.conv2d_fused, counter) == before + 1
    want = ref.conv2d_ref(xt, wt, stride, padding, groups, bias=bt,
                          relu=relu)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        _bf16_close(got, want)


# the bf16 kernel's wgmma body at its edges: both A routes, ragged M and N
# tiles (npg below and across a tile), padding wider than a stride, Cg of 8
# and 16, a rows-route run of 14 and of 64 values, every tile width
WGMMA_CASES = [
    # b, hw, cin, cout, kernel, stride, padding, groups
    (2, 13, 16, 24, 3, 2, 1, 1),
    (1, 9, 8, 40, 3, 1, 2, 1),
    (2, 11, 32, 208, 3, 1, 1, 2),
    (3, 20, 2, 16, 7, 3, 0, 1),
    (2, 19, 4, 72, 4, 1, 0, 1),
    (2, 27, 96, 256, 5, 1, 2, 2),
    (3, 35, 3, 96, 11, 4, 0, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tiles", [None, (64, 3), (96, 2), (128, 1),
                                   (192, 2)],
                         ids=["rule", "64x3", "96x2", "128x1", "192x2"])
@pytest.mark.parametrize("b,hw,cin,cout,kernel,stride,padding,groups",
                         WGMMA_CASES)
def test_cuda_bf16_wgmma_body_matches_plain(cuda, b, hw, cin, cout, kernel,
                                            stride, padding, groups, tiles):
    assert ops.conv_route_bf16(cin, cout, kernel, padding, groups)
    x, w, bb = _inputs(b, hw, cin, cout, kernel, groups, seed=7)
    xt, wt, bt = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (x, w, bb))
    with torch.no_grad():
        got = ops._conv_forward(xt, wt, bt, stride, padding, True, groups,
                                "cuda", tiles=tiles, body="wgmma")
        torch.cuda.synchronize()
        want = ref.conv2d_ref(xt, wt, stride, padding, groups, bias=bt,
                              relu=True)
    _bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["wgmma", "mma_sync"])
def test_cuda_bf16_bodies_agree_at_alexnet_serving(cuda, body):
    """Both bodies of the bf16 entry at the faithful AlexNet's conv2 and
    conv3 at the serving batch, against the plain version."""
    for b, hw, cin, cout, kernel, stride, padding, groups in [
            (8, 27, 96, 256, 5, 1, 2, 2), (8, 13, 256, 384, 3, 1, 1, 1)]:
        x, w, bb = _inputs(b, hw, cin, cout, kernel, groups, seed=8)
        xt, wt, bt = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                      for a in (x, w, bb))
        with torch.no_grad():
            got = ops._conv_forward(xt, wt, bt, stride, padding, True,
                                    groups, "cuda", body=body)
            want = ref.conv2d_ref(xt, wt, stride, padding, groups, bias=bt,
                                  relu=True)
        _bf16_close(got, want)


@pytest.mark.cuda
def test_cuda_bf16_conv_is_deterministic(cuda):
    """Where the wgmma body splits the reduction (conv3 at the serving
    batch), two calls agree bit for bit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.conv_plan_bf16((8, 13, 13, 256), 384, 3, 1, 1, 1,
                              sms)[2] > 1
    x, w, bb = _inputs(8, 13, 256, 384, 3, 1, seed=6)
    xt, wt, bt = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (x, w, bb))
    with torch.no_grad():
        first = ops.conv2d_fused(xt, wt, stride=1, padding=1, bias=bt,
                                 relu=True)
        second = ops.conv2d_fused(xt, wt, stride=1, padding=1, bias=bt,
                                  relu=True)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 27, 27, 3, 11, 4, 0, 96, 1),
                                   (2, 13, 13, 96, 3, 1, 1, 64, 2)],
                         ids=["rows", "pieces"])
def test_cuda_bf16_relu_keeps_nan(cuda, shape):
    """A NaN in x comes through the bf16 kernel's ReLU as a NaN in every
    output its window reaches, and nowhere else (ROADMAP C2)."""
    b, h, wd, cin, kernel, stride, padding, cout, groups = shape
    x, w, bb = _inputs(b, h, cin, cout, kernel, groups, seed=9)
    x[1, h // 2, wd // 2, 0] = np.nan
    xt, wt, bt = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (x, w, bb))
    with torch.no_grad():
        got = ops.conv2d_fused(xt, wt, stride=stride, padding=padding,
                               bias=bt, relu=True, groups=groups)
        want = ref.conv2d_ref(xt, wt, stride, padding, groups, bias=bt,
                              relu=True)
    assert want.isnan().any()
    assert torch.equal(got.isnan(), want.isnan())


@pytest.mark.cuda
def test_cuda_bf16_rows_route_at_the_end_of_storage(cuda):
    """conv1's rows route where x ends exactly at the end of its storage,
    a fresh 12 MiB allocation: the last pixel's last run ends at x's last
    value, and its copy must read nothing past it (where the driver maps
    nothing past the allocation, a read past it faults)."""
    b, hw = 40, 227
    x, w, bb = _inputs(b, hw, 3, 96, 11, 1, seed=10)
    torch.cuda.empty_cache()
    store = torch.empty(12 << 19, device=cuda, dtype=torch.bfloat16)
    xt = store[store.numel() - x.size:].view(x.shape)
    xt.copy_(torch.from_numpy(x))
    assert xt.data_ptr() % 16 == 0
    assert xt.data_ptr() + 2 * xt.numel() == store.data_ptr() + (12 << 20)
    assert (55 - 1) * 4 + 11 == hw          # the last run ends at W
    wt, bt = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in (w, bb))
    assert ops.conv_route_bf16(3, 96, 11, 0, 1) == "rows"
    before = ops.conv2d_fused.launches_bf16_wgmma
    with torch.no_grad():
        got = ops.conv2d_fused(xt, wt, stride=4, padding=0, bias=bt,
                               relu=True)
        torch.cuda.synchronize()
        want = ref.conv2d_ref(xt, wt, 4, 0, 1, bias=bt, relu=True)
    assert ops.conv2d_fused.launches_bf16_wgmma == before + 1
    _bf16_close(got, want)


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


def _alexnet_bf16_convs():
    """(x shape, Cout, K, stride, padding, groups) of every conv of both
    AlexNets at the serving and the training batch (the ids of
    ``_alexnet_convs``)."""
    out = []
    for cfg in (ALEXNET_FAITHFUL, ALEXNET):
        c_in, hw = cfg.in_channels, cfg.image_size
        for i, cs in enumerate(cfg.convs):
            oh = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
            for batch in (8, 128):
                out.append(pytest.param(
                    (batch, hw, hw, c_in), cs.out_channels, cs.kernel,
                    cs.stride, cs.padding, cs.groups,
                    id=f"{cfg.name}-conv{i + 1}-b{batch}"))
            hw = (oh - 3) // 2 + 1 if cs.pool else oh
            c_in = cs.out_channels
    return out


def test_alexnet_bf16_convs_are_the_alexnet_convs():
    """The two lists walk the same layers: the same M, npg, K*K*Cg,
    groups and batch under the same ids."""
    walked = [(p.id, p.values) for p in _alexnet_convs()]
    here = []
    for p in _alexnet_bf16_convs():
        (b, hw, _, cin), cout, k, stride, pad, g = p.values
        oh = (hw + 2 * pad - k) // stride + 1
        here.append((p.id, (b * oh * oh, cout // g, k * k * cin // g, g, b)))
    assert here == walked


def test_conv_bf16_constants_match_the_kernel():
    """``CONV_BF16_BM``, ``CONV_BF16_BK`` and ``CONV_BF16_BNS`` mirror the
    wgmma body's WG_BM, WG_BK and the widths the bf16 entry launches on
    it; the mma_sync body launches ``CONV_BNS``; the body codes, the rows
    route's longest run and the chunk count (``conv_chunks_bf16``) are
    the entry point's."""
    src = (Path(ops.__file__).parent / "csrc"
           / "conv2d_fused_bf16.cu").read_text()
    bm = re.search(r"constexpr int WG_BM = (\d+);", src)
    bk = re.search(r"constexpr int WG_BK = (\d+);", src)
    wg = [int(a) for a, b in re.findall(
        r"case (\d+):\n\s+e = launch_wg_route<(\d+)>", src) if a == b]
    mma = [int(a) for a, b in re.findall(
        r"case (\d+):\n\s+e = launch_vec<(\d+)>", src) if a == b]
    assert bm and bk and wg and mma, "the kernel's tile constants moved"
    assert ops.CONV_BF16_BM == int(bm.group(1))
    assert ops.CONV_BF16_BK == int(bk.group(1))
    assert tuple(sorted(wg)) == ops.CONV_BF16_BNS
    assert tuple(sorted(mma)) == ops.CONV_BNS
    assert ops.CONV_BF16_BODIES == {"wgmma": 1, "mma_sync": 2}
    run = re.search(r"constexpr int ROW_RUN = (\d+);", src)
    assert run and int(run.group(1)) == ops.CONV_BF16_ROW_RUN
    for code in ("if (body == 1) {", "} else if (body == 2) {",
                 "s.chunks = route == ROUTE_ROWS ? K : "
                 "(s.Kdim + WG_BK - 1) / WG_BK;"):
        assert code in src, code


@pytest.mark.parametrize("chunks,n_split", [(11, 1), (11, 3), (19, 2),
                                            (36, 6), (27, 6), (27, 4),
                                            (5, 4), (1, 1)])
def test_conv_ranges_bf16_cover_each_chunk_once(chunks, n_split):
    """The wgmma body's splits take every chunk exactly once, none empty,
    in the kernel's runs (``c_lo`` / ``n_c``)."""
    runs = ops.conv_ranges_bf16(chunks, n_split)
    per = -(-chunks // n_split)
    assert runs == [(z * per, min(chunks, (z + 1) * per))
                    for z in range(len(runs))]
    assert runs[0][0] == 0 and runs[-1][1] == chunks
    assert all(lo < hi for lo, hi in runs)


@pytest.mark.parametrize("xs,cout,k,stride,padding,groups",
                         _alexnet_bf16_convs())
def test_conv_tiles_bf16_fit_alexnet(xs, cout, k, stride, padding, groups):
    """At every AlexNet conv the bf16 preset runs the wgmma body; its rule
    picks a width that is a multiple of 8, at most 256 and divides the
    group's channels, a split that covers the chunks with none empty, and
    at the serving batch a grid that fills a wave of the card's 132 SMs,
    or a split, or one that a split by 2 would push past a wave."""
    sms = 132
    body, bn, n_split = ops.conv_plan_bf16(xs, cout, k, stride, padding,
                                           groups, sms)
    assert body == "wgmma"
    npg = cout // groups
    assert bn % 8 == 0 and bn <= 256 and npg % bn == 0
    batch, hw, _, cin = xs
    oh = (hw + 2 * padding - k) // stride + 1
    m = batch * oh * oh
    route = ops.conv_route_bf16(cin, cout, k, padding, groups)
    chunks = ops.conv_chunks_bf16(route, k, cin // groups)
    runs = ops.conv_ranges_bf16(chunks, n_split)
    assert len(runs) == n_split and runs[-1][1] == chunks
    blocks = -(-m // ops.CONV_BF16_BM) * (npg // bn) * groups
    if batch == 8:
        assert blocks >= sms or n_split > 1 or 2 * blocks > sms


@pytest.mark.parametrize(
    "b,hw,cin,cout,kernel,stride,padding,groups,bias,relu", CUDA_CASES)
def test_conv_bf16_body_rule_on_cuda_cases(b, hw, cin, cout, kernel, stride,
                                           padding, groups, bias, relu):
    """The five faithful AlexNet convs at the serving batch and the
    conv1-like case take the wgmma body (conv1's Cin 3 on the rows route,
    the others on the pieces route); the odd shapes (npg or Cg not a
    multiple of 8) take the mma_sync body."""
    npg, cg = cout // groups, cin // groups
    route = ops.conv_route_bf16(cin, cout, kernel, padding, groups)
    if npg % 8 or (cg % 8 and (groups > 1 or padding or kernel * cin > 37)):
        assert route is None
    elif cg % 8 == 0:
        assert route == "pieces"
    else:
        assert route == "rows" and (cin, kernel, padding) == (3, 11, 0)
    alexnet = (cin, cout, kernel, stride, padding, groups) in [
        (3, 96, 11, 4, 0, 1), (96, 256, 5, 1, 2, 2), (256, 384, 3, 1, 1, 1),
        (384, 384, 3, 1, 1, 2), (384, 256, 3, 1, 1, 2)]
    if alexnet:
        assert route is not None
    body = ops.conv_plan_bf16((b, hw, hw, cin), cout, kernel, stride,
                              padding, groups, 132)[0]
    assert body == ("mma_sync" if route is None else "wgmma")


def test_conv_plan_bf16_forces_a_body():
    """``body`` forces a body, whose code ``_conv_forward`` names to the
    entry point; operands off a 16-byte boundary take the mma_sync body;
    the wgmma body refuses a shape its route does not take."""
    xs = (8, 13, 13, 256)
    assert ops.conv_plan_bf16(xs, 384, 3, 1, 1, 1, 132)[0] == "wgmma"
    assert ops.conv_plan_bf16(xs, 384, 3, 1, 1, 1, 132,
                              body="mma_sync")[0] == "mma_sync"
    assert ops.conv_plan_bf16(xs, 384, 3, 1, 1, 1, 132,
                              body="wgmma")[0] == "wgmma"
    assert ops.conv_plan_bf16(xs, 384, 3, 1, 1, 1, 132,
                              aligned=False)[0] == "mma_sync"
    with pytest.raises(ValueError, match="does not take this shape"):
        ops.conv_plan_bf16(xs, 384, 3, 1, 1, 1, 132, aligned=False,
                           body="wgmma")
    with pytest.raises(ValueError, match="does not take this shape"):
        ops.conv_plan_bf16((2, 13, 13, 5), 11, 3, 1, 1, 1, 132,
                           body="wgmma")
    with pytest.raises(ValueError, match="body must be one of"):
        ops.conv_plan_bf16((2, 13, 13, 16), 16, 3, 1, 1, 1, 132,
                           body="fast")


@pytest.mark.parametrize("cin,k,padding,groups,route", [
    (3, 11, 0, 1, "rows"),       # conv1: a run of 33 values
    (2, 7, 0, 1, "rows"),
    (3, 12, 0, 1, "rows"),       # 36
    (37, 1, 0, 1, "rows"),       # the longest run
    (19, 2, 0, 1, None),         # 38 values: past ROW_RUN
    (3, 11, 1, 1, None),         # padded
    (6, 3, 0, 2, None),          # grouped: a run is not contiguous
])
def test_conv_route_bf16_rows(cin, k, padding, groups, route):
    """The rows route takes an ungrouped, unpadded conv whose run of K *
    Cin values fits the producer's slot, and only where Cg % 8 != 0."""
    assert ops.conv_route_bf16(cin, 16 * groups, k, padding,
                               groups) == route


@pytest.mark.cuda
@pytest.mark.parametrize("xs,cout,k,stride,padding,groups",
                         _alexnet_bf16_convs())
def test_cuda_bf16_wgmma_body_repeats_bit_equal(cuda, xs, cout, k, stride,
                                                padding, groups):
    """Every AlexNet conv on the wgmma body, 200 calls back to back: all
    launch (a barrier wait that never completes would trap), all take
    the wgmma body, and each agrees with the first bit for bit."""
    batch, hw, _, cin = xs
    x, w, bb = _inputs(batch, hw, cin, cout, k, groups, seed=12)
    xt, wt, bt = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (x, w, bb))
    kw = dict(stride=stride, padding=padding, bias=bt, relu=True,
              groups=groups)
    before = ops.conv2d_fused.launches_bf16_wgmma
    with torch.no_grad():
        first = ops.conv2d_fused(xt, wt, **kw)
        kept = []
        for i in range(1, 200):
            y = ops.conv2d_fused(xt, wt, **kw)
            if i % 50 == 0:
                kept.append(y)
        torch.cuda.synchronize()
    assert ops.conv2d_fused.launches_bf16_wgmma == before + 200
    assert all(torch.equal(y, first) for y in kept)
