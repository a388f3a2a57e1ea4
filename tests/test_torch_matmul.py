"""The port's blocked GEMM and two-stage im2col conv against the
reference's.

On the CPU ``repro_torch``'s ``matmul_bias`` runs its plain version and
the reference's its Pallas kernel in interpret mode, on the same numpy
inputs; grads go through the port's ``torch.autograd.Function`` and
``jax.grad`` through the reference's ``custom_vjp``.  The tests marked
``cuda`` hold the CUDA kernel against the plain version on the card and
skip on a host without one; they import no JAX.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.conv2d import ops, ref

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels.conv2d import conv2d as jax_conv
    from repro.kernels.conv2d import ops as jax_ops
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = jnp = jax_conv = jax_ops = None

TOL = 1e-5               # tests/kernels/test_conv2d.py's matmul tolerance
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
CONV_TOL = 2e-4          # the conv registry's tolerance


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _mats(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("m,k,n", [(100, 70, 50), (150, 93, 37)])
def test_forward_matches_reference(m, k, n, relu):
    x, w, b = _mats(m, k, n)
    got = ops.matmul_bias(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), relu=relu)
    want = jax_conv.matmul_bias(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), relu=relu, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_grads_match_jax_grad(relu):
    x, w, b = _mats(64, 48, 40, seed=1)

    def jloss(x_, w_, b_):
        return jnp.sum(jnp.cos(jax_conv.matmul_bias(x_, w_, b_, relu=relu,
                                                    interpret=True)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    torch.cos(ops.matmul_bias(xt, wt, bt, relu=relu)).sum().backward()
    for got, ref_ in zip((xt.grad, wt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_transposed_views_are_read_in_place():
    x, w, b = _mats(30, 20, 10, seed=2)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).t()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).t()
    assert not xt.is_contiguous() and not wt.is_contiguous()
    got = ops.matmul_bias(xt, wt, torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), x @ w + b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("xs,ws,bs,match", [
    ((4, 5), (6, 3), None, "do not chain"),
    ((4, 5), (5, 3), (4,), "b has shape"),
    ((0, 5), (5, 3), None, "empty output"),
])
def test_shape_errors(xs, ws, bs, match):
    with pytest.raises(ValueError, match=match):
        ops.matmul_bias(torch.zeros(xs), torch.zeros(ws),
                        None if bs is None else torch.zeros(bs))


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.matmul_bias(torch.zeros(4, 5), torch.zeros(5, 3),
                        backend="cuda")


def _registry_example(grouped, seed=0):
    rng = np.random.default_rng(seed)
    c, co = (8, 12) if grouped else (5, 11)
    x = rng.normal(size=(2, 13, 13, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c // (2 if grouped else 1), co))
         * 0.2).astype(np.float32)
    return x, w


@pytest.mark.parametrize("grouped,stride,groups", [
    (False, 2, 1),          # registry op "conv2d": stride 2, pad 1
    (True, 1, 2),           # registry op "conv2d_grouped": stride 1, pad 1
], ids=["conv2d", "conv2d_grouped"])
def test_im2col_conv_matches_reference(grouped, stride, groups):
    x, w = _registry_example(grouped)
    b = np.linspace(-0.5, 0.5, w.shape[-1]).astype(np.float32)
    kw = dict(stride=stride, padding=1, relu=True, groups=groups)

    def jloss(x_, w_, b_):
        y = jax_ops.conv2d_im2col(x_, w_, bias=b_, interpret=True, **kw)
        return jnp.sum(jnp.sin(y)), y

    (_, jy), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    y = ops.conv2d_im2col(xt, wt, bias=bt, **kw)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=CONV_TOL, atol=CONV_TOL)
    for got, want in zip((xt.grad, wt.grad, bt.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=CONV_TOL, atol=CONV_TOL)


def test_im2col_features_are_channel_major_like_the_reference():
    """``F.unfold``'s features and XLA's patches agree at groups=2, and
    the block-diagonal weights line up with them."""
    x, w = _registry_example(True, seed=3)
    got = ops.im2col(torch.from_numpy(x), 3, 1, 1)
    want = jax_ops.im2col(jnp.asarray(x), 3, 1, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        ops.reorder_weights(torch.from_numpy(w), 2).numpy(),
        np.asarray(jax_ops._reorder(jnp.asarray(w), 2)))


# kernel edge cases: M, K or N of 1, K off the 16-wide chunk, ragged
# 64- and 128-wide tiles, every transposed-operand flag, ReLU on and off
CUDA_CASES = [
    # m, k, n, trans_a, trans_b, bias, relu
    (1, 16, 64, False, False, True, True),
    (64, 1, 64, False, False, True, False),
    (65, 17, 1, False, False, False, False),
    (100, 70, 50, False, False, True, True),
    (150, 93, 37, True, False, False, False),
    (97, 363, 96, False, True, False, False),
    (363, 1000, 96, True, False, False, False),
    (130, 33, 129, True, True, True, True),
    (1, 1, 1, True, True, True, False),
    # split-K: transposed A, a long reduction and a small output (rows of
    # 363 floats take the 4-byte copies, of 1,200 the 16-byte ones)
    (363, 20000, 96, True, False, False, False),
    (1200, 5000, 128, True, False, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,trans_a,trans_b,bias,relu", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, m, k, n, trans_a, trans_b, bias,
                                   relu):
    x, w, b = _mats(m, k, n, seed=5)
    xt = (torch.from_numpy(np.ascontiguousarray(x.T)).to(cuda).t()
          if trans_a else torch.from_numpy(x).to(cuda))
    wt = (torch.from_numpy(np.ascontiguousarray(w.T)).to(cuda).t()
          if trans_b else torch.from_numpy(w).to(cuda))
    bt = torch.from_numpy(b).to(cuda) if bias else None
    before = ops.matmul_bias.launches
    with torch.no_grad():
        got = ops.matmul_bias(xt, wt, bt, relu=relu)
        torch.cuda.synchronize()
    assert ops.matmul_bias.launches == before + 1
    want = ref.matmul_bias_ref(xt, wt, bt, relu)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_backward_launches_the_kernel_twice(cuda):
    x, w, b = _mats(200, 75, 40, seed=6)
    xt, wt, bt = (torch.tensor(a, device=cuda, requires_grad=True)
                  for a in (x, w, b))
    before = ops.matmul_bias.launches
    torch.cos(ops.matmul_bias(xt, wt, bt, relu=True)).sum().backward()
    torch.cuda.synchronize()
    assert ops.matmul_bias.launches == before + 3
    xp, wp, bp = (torch.tensor(a, device=cuda, requires_grad=True)
                  for a in (x, w, b))
    torch.cos(torch.relu(xp @ wp + bp)).sum().backward()
    for got, want in ((xt.grad, xp.grad), (wt.grad, wp.grad),
                      (bt.grad, bp.grad)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_im2col_conv_matches_fused(cuda):
    x, w = _registry_example(True, seed=7)
    xt, wt = (torch.from_numpy(a).to(cuda) for a in (x, w))
    with torch.no_grad():
        got = ops.conv2d_im2col(xt, wt, stride=1, padding=1, groups=2,
                                relu=True)
        want = ops.conv2d_fused(xt, wt, stride=1, padding=1, groups=2,
                                relu=True)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("m,n,k,sms", [
    (363, 96, 96800, 132),      # conv1's dw at batch 32
    (5408, 384, 2304, 132),     # conv3's forward
    (1200, 128, 5000, 132),
    (363, 96, 20000, 16),
    (100, 100, 100, 132),       # too short to split
])
def test_gemm_split_covers_each_chunk_once(m, n, k, sms):
    """The split rule deals every reduction chunk to exactly one split,
    none empty, so the partials sum to the whole product."""
    n_split = ops.gemm_split(m, n, k, sms)
    ranges = ops.gemm_ranges(k, n_split)
    # split z's chunks as matmul_bias_kernel computes them (c_lo, c_hi)
    chunks = -(-k // ops.GEMM_BK)
    per = -(-chunks // n_split)
    assert ranges == [(z * per, min(chunks, (z + 1) * per))
                      for z in range(n_split)]
    assert len(ranges) == n_split >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == chunks
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(ranges[-1][1], 0)]):
        assert lo < hi == nxt
    if n_split > 1:   # the last split takes what is left
        assert all(hi - lo >= ops.GEMM_MIN_CHUNKS for lo, hi in ranges[:-1])


def test_gemm_split_by_grid_and_card():
    """1 where the tile grid already fills the card, more for conv1's dw,
    and fewer on a card with fewer SMs."""
    assert ops.gemm_split(96800, 96, 363, 132) == 1
    assert ops.gemm_split(23328, 2400, 256, 132) == 1
    big = ops.gemm_split(363, 96, 96800, 132)
    assert big > 1
    assert 1 < ops.gemm_split(363, 96, 96800, 16) < big


def test_gemm_tile_constants_match_the_kernel():
    """``GEMM_BM``, ``GEMM_BK`` and ``gemm_bn`` mirror the kernel's BM, BK
    and its choice of 64- or 128-column tiles (``launch_tiles``)."""
    src = (Path(ops.__file__).parent / "csrc" / "matmul_bias.cu").read_text()
    bm = re.search(r"constexpr int BM = (\d+);", src)
    bk = re.search(r"constexpr int BK = (\d+);", src)
    narrow = re.search(r"return N <= (\d+) \? launch<TA, TB, (\d+)>", src)
    wide = re.search(r": launch<TA, TB, (\d+)>", src)
    assert bm and bk and narrow and wide, "the kernel's tile constants moved"
    assert ops.GEMM_BM == int(bm.group(1))
    assert ops.GEMM_BK == int(bk.group(1))
    cut, bn_narrow = int(narrow.group(1)), int(narrow.group(2))
    assert ops.gemm_bn(cut) == bn_narrow
    assert ops.gemm_bn(cut + 1) == int(wide.group(1))


@pytest.mark.cuda
def test_cuda_split_is_deterministic(cuda):
    """Where the reduction is split over blocks, the partials are added in
    split order by a second kernel, not by atomics: two calls agree bit
    for bit."""
    m, k, n = 363, 20000, 96
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.gemm_split(m, n, k, sms) > 1
    x, w, _ = _mats(m, k, n, seed=8)
    xt = torch.from_numpy(np.ascontiguousarray(x.T)).to(cuda).t()
    wt = torch.from_numpy(w).to(cuda)
    with torch.no_grad():
        first = ops.matmul_bias(xt, wt)
        second = ops.matmul_bias(xt, wt)
    assert torch.equal(first, second)


# ------------------------------------------------------------- bf16 ------
# The bf16 entry and its plain version compute one fp32 sum over upcast
# operands and round it to bf16 once, as the reference kernel does; sums
# taken in another order round to the neighbouring bf16 value now and then.
# So an element may differ by one bf16 ulp, or, near zero (where a bf16 ulp
# is far below the fp32 sums' own error), by BF16_ATOL of the output's max.
BF16_ATOL = 1e-5
BF16_GRAD_RTOL = 2 ** -6     # db: a bf16 sum, reduced in another order


def _bf16(a, device=None):
    return torch.from_numpy(a).to(device=device, dtype=torch.bfloat16)


def _ulp_check(got, want):
    """Every element of ``got`` within one bf16 ulp of ``want``'s, or
    within ``BF16_ATOL`` of max |want| (see above).  Returns the number of
    elements that differ at all."""
    g, w = got.float(), want.float()
    ulp = torch.where(w == 0, torch.full_like(w, 2.0 ** -133),
                      2.0 ** (torch.floor(torch.log2(w.abs())) - 7))
    err = (g - w).abs()
    atol = BF16_ATOL * w.abs().max()
    bad = (err > ulp * 1.0001) & (err > atol)
    assert not bad.any(), (f"{int(bad.sum())} elements beyond one bf16 ulp;"
                           f" worst {float(err.max())}")
    return int((g != w).sum())


def _jax_bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("m,k,n,trans", [(100, 70, 50, False),
                                         (37, 363, 96, False),
                                         (65, 93, 40, True)],
                         ids=["even", "odd_k_and_m", "transposed"])
def test_bf16_forward_matches_reference(m, k, n, trans, relu):
    """bf16 in, bf16 out: the port's plain version against the reference
    kernel in interpret mode, odd K and M, and x as a transposed view."""
    x, w, b = _mats(m, k, n, seed=9)
    xt = (torch.from_numpy(np.ascontiguousarray(x.T)).bfloat16().t()
          if trans else _bf16(x))
    got = ops.matmul_bias(xt, _bf16(w), _bf16(b), relu=relu)
    assert got.dtype == torch.bfloat16
    want = jax_conv.matmul_bias(_jax_bf16(x), _jax_bf16(w), _jax_bf16(b),
                                relu=relu, interpret=True)
    assert want.dtype == jnp.bfloat16
    _ulp_check(got, torch.from_numpy(np.asarray(want, np.float32)))


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_bf16_grads_match_jax_grad(relu):
    """dx, dw (the same kernel, bf16 out) and db (a bf16 sum) against the
    reference's custom_vjp."""
    x, w, b = _mats(45, 37, 24, seed=10)

    def jloss(x_, w_, b_):
        y = jax_conv.matmul_bias(x_, w_, b_, relu=relu, interpret=True)
        return jnp.sum(jnp.cos(y).astype(jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(_jax_bf16(x), _jax_bf16(w),
                                              _jax_bf16(b))
    xt, wt, bt = (_bf16(a).requires_grad_() for a in (x, w, b))
    torch.cos(ops.matmul_bias(xt, wt, bt, relu=relu)).float().sum() \
        .backward()
    for name, got, ref_ in zip("xwb", (xt.grad, wt.grad, bt.grad), want):
        assert got.dtype == torch.bfloat16, name
        want_t = torch.from_numpy(np.asarray(ref_, np.float32))
        if name == "b":
            torch.testing.assert_close(got.float(), want_t,
                                       rtol=BF16_GRAD_RTOL, atol=1e-3)
        else:
            _ulp_check(got, want_t)


def test_bf16_im2col_conv_matches_reference():
    """``conv2d_im2col`` in bf16 against the reference's
    ``pallas_im2col_ref`` route (its ``conv2d_im2col``) in interpret
    mode: the patches are exact, so the GEMM's one rounding is all that
    can differ."""
    x, w = _registry_example(True, seed=11)
    b = np.linspace(-0.5, 0.5, w.shape[-1]).astype(np.float32)
    kw = dict(stride=1, padding=1, relu=True, groups=2)
    got = ops.conv2d_im2col(_bf16(x), _bf16(w), bias=_bf16(b), **kw)
    assert got.dtype == torch.bfloat16
    want = jax_ops.conv2d_im2col(_jax_bf16(x), _jax_bf16(w),
                                 bias=_jax_bf16(b), interpret=True, **kw)
    _ulp_check(got, torch.from_numpy(np.asarray(want, np.float32)))


def test_bf16_operands_share_one_dtype():
    with pytest.raises(ValueError, match="share one dtype"):
        ops.matmul_bias(torch.zeros(4, 5, dtype=torch.bfloat16),
                        torch.zeros(5, 3))


def test_gemm_bf16_tile_constants_match_the_kernel():
    """``GEMM_BF16_BM``, ``GEMM_BF16_BN`` and ``GEMM_BF16_BK`` mirror the
    bf16 kernel's mma_sync body's BM, BN and BK; ``GEMM_BF16_TMA_BM``,
    ``GEMM_BF16_TMA_BK``, ``GEMM_BF16_BNS`` and ``GEMM_BF16_SWAP_BNS`` its
    TMA bodies' TMA_BM, TMA_BK and the widths each is built for."""
    src = (Path(ops.__file__).parent / "csrc"
           / "matmul_bias_bf16.cu").read_text()
    got = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
           for name in ("BM", "BN", "BK", "TMA_BM", "TMA_BK")}
    assert got == {"BM": ops.GEMM_BF16_BM, "BN": ops.GEMM_BF16_BN,
                   "BK": ops.GEMM_BF16_BK, "TMA_BM": ops.GEMM_BF16_TMA_BM,
                   "TMA_BK": ops.GEMM_BF16_TMA_BK}
    widths = {name: tuple(sorted(int(w) for w in re.findall(
        r"X\((\d+)\)", re.search(rf"#define {name}\(X\) (.*)",
                                  src).group(1))))
              for name in ("WGMMA_WIDTHS", "SWAP_WIDTHS")}
    assert widths == {"WGMMA_WIDTHS": ops.GEMM_BF16_BNS,
                      "SWAP_WIDTHS": ops.GEMM_BF16_SWAP_BNS}
    assert ops.gemm_bn(16, torch.bfloat16) == ops.GEMM_BF16_BN
    # decode's M = 16 takes the swap_ab body's narrowest width: no idle
    # rows of x in a tile
    body, bn, _ = ops.gemm_plan_bf16(16, 14336, 4096, False, False, True,
                                     True, 132)
    assert (body, bn) == ("swap_ab", ops.GEMM_BF16_SWAP_BNS[0]) == \
        ("swap_ab", 16)


def _mixtral_products(cap=640):
    """(m, k, n, trans_a, trans_b) of Mixtral-8x7B's expert FFN products
    at capacity ``cap`` (chip_smoke.mixtral_gemm_cases): the forward of
    w_in / w_gate and w_out, then each one's dx and dw."""
    from repro_torch.configs import ARCHS

    d, f = ARCHS["mixtral-8x7b"].d_model, ARCHS["mixtral-8x7b"].d_ff
    return [(cap, d, f, False, False), (cap, f, d, False, False),
            (cap, f, d, False, True), (d, cap, f, True, False),
            (cap, d, f, False, True), (f, cap, d, True, False)]


def _alexnet_products(batch=32):
    """(layer, m, k, n, trans_a, trans_b) of the faithful AlexNet's
    im2col products in one replica-step (chip_smoke.gemm_cases): per conv
    the forward, dw and, past conv1, dx."""
    from repro_torch.configs import ALEXNET_FAITHFUL as cfg

    out, c_in, hw = [], cfg.in_channels, cfg.image_size
    for i, cs in enumerate(cfg.convs):
        oh = (hw + 2 * cs.padding - cs.kernel) // cs.stride + 1
        m, k, n = batch * oh * oh, c_in * cs.kernel ** 2, cs.out_channels
        out.append((i, m, k, n, False, False))
        if i > 0:
            out.append((i, m, n, k, False, True))
        out.append((i, k, m, n, True, False))
        hw = (oh - 3) // 2 + 1 if cs.pool else oh
        c_in = cs.out_channels
    return out


def _takes(m, k, n, trans_a, trans_b):
    """The bodies that can run a product on fresh (aligned) tensors: the
    TMA bodies need each operand's rows a multiple of 8 values apart and
    N % 8 == 0, swap_ab x in its (M, K) storage."""
    tma = (m if trans_a else k) % 8 == 0 and (k if trans_b else n) % 8 == 0
    return {"mma_sync"} | ({"wgmma"} if tma and n % 8 == 0 else set()) | (
        {"swap_ab"} if tma and n % 8 == 0 and not trans_a else set())


def test_gemm_plan_bf16_picks_each_body():
    """Mixtral's 9 training products at C = 640 go to the wgmma body, the
    two decode products (M = 16) to swap_ab, AlexNet conv1's two products
    (363-wide patch rows) to mma_sync and its other 12 to wgmma; every
    edge case of CUDA_BF16_CASES to a body that takes it, and a body
    forced where it cannot run raises."""
    def body(m, k, n, ta, tb):
        pa = (m if ta else k) % 8 == 0
        pb = (k if tb else n) % 8 == 0
        return ops.gemm_plan_bf16(m, n, k, ta, tb, pa, pb, 132)[0]

    assert {body(*p) for p in _mixtral_products()} == {"wgmma"}
    assert [body(16, 4096, 14336, False, False),
            body(16, 14336, 4096, False, False)] == ["swap_ab"] * 2
    got = [(layer, body(*p)) for layer, *p in _alexnet_products()]
    assert len(got) == 14
    assert [b for layer, b in got if layer == 0] == ["mma_sync"] * 2
    assert [b for layer, b in got if layer > 0] == ["wgmma"] * 12
    for m, k, n, ta, tb, _, _ in CUDA_BF16_CASES:
        assert body(m, k, n, ta, tb) in _takes(m, k, n, ta, tb)
    with pytest.raises(ValueError, match="TMA can map"):
        ops.gemm_plan_bf16(97, 96, 363, False, True, False, True, 132,
                           body="wgmma")
    with pytest.raises(ValueError, match="swap_ab"):
        ops.gemm_plan_bf16(16, 96, 64, True, False, True, True, 132,
                           body="swap_ab")


@pytest.mark.parametrize("m,n,k", [
    (640, 4096, 14336),     # Mixtral's w_out dx at capacity 640
    (16, 14336, 4096),      # a decode product
    (363, 96, 96800),       # conv1's dw at batch 32
])
def test_gemm_split_bf16_covers_each_chunk_once(m, n, k):
    """Each body's split, at its rule and at forced splits, covers the
    reduction's chunks (32 wide on mma_sync, 64 on the TMA bodies) once,
    none empty."""
    picks = {"mma_sync": ops.gemm_split(m, n, k, 132, torch.bfloat16)}
    for body in ("wgmma", "swap_ab"):
        picks[body] = ops.gemm_plan_bf16(m, n, k, False, False, True, True,
                                         132, body=body)[2]
    for body, rule in picks.items():
        bk = ops.GEMM_BF16_BK if body == "mma_sync" else ops.GEMM_BF16_TMA_BK
        chunks = -(-k // bk)
        for n_split in (rule, 3, 7):
            ranges = ops.gemm_ranges(k, n_split, torch.bfloat16, body)
            assert 1 <= len(ranges) <= n_split
            assert len(ranges) == n_split or n_split != rule
            assert ranges[0][0] == 0 and ranges[-1][1] == chunks
            for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(chunks, 0)]):
                assert lo < hi == nxt


# the bf16 kernel's edge cases: M, K or N of 1, K off the 32-wide chunk,
# ragged tiles, every transposed-operand flag, rows of odd length (the
# narrow copy path), ReLU on and off, a split reduction
CUDA_BF16_CASES = [
    # m, k, n, trans_a, trans_b, bias, relu
    (1, 32, 64, False, False, True, True),
    (64, 1, 64, False, False, True, False),
    (65, 17, 1, False, False, False, False),
    (100, 70, 50, False, False, True, True),
    (150, 96, 37, True, False, False, False),
    (97, 363, 96, False, True, False, False),
    (363, 1000, 96, True, False, False, False),
    (130, 40, 136, True, True, True, True),
    (1, 1, 1, True, True, True, False),
    (16, 4096, 1024, False, False, False, False),
    (641, 256, 520, False, False, True, False),
    (363, 20000, 96, True, False, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,trans_a,trans_b,bias,relu", CUDA_BF16_CASES)
def test_cuda_bf16_kernel_matches_plain(cuda, m, k, n, trans_a, trans_b,
                                        bias, relu):
    x, w, b = _mats(m, k, n, seed=12)
    xt = (_bf16(np.ascontiguousarray(x.T), cuda).t() if trans_a
          else _bf16(x, cuda))
    wt = (_bf16(np.ascontiguousarray(w.T), cuda).t() if trans_b
          else _bf16(w, cuda))
    bt = _bf16(b, cuda) if bias else None
    before = ops.matmul_bias.launches_bf16
    with torch.no_grad():
        got = ops.matmul_bias(xt, wt, bt, relu=relu)
        torch.cuda.synchronize()
    assert ops.matmul_bias.launches_bf16 == before + 1
    assert got.dtype == torch.bfloat16
    _ulp_check(got, ref.matmul_bias_ref(xt, wt, bt, relu))


@pytest.mark.cuda
def test_cuda_bf16_operands_at_the_end_of_their_storage(cuda):
    """x and w as the last rows of larger buffers, with ragged M, N and K
    and rows of odd length: the kernel reads nothing past them (a read
    past the end of the allocation would fault or bring in garbage)."""
    for (m, k, n) in ((37, 363, 96), (200, 64, 72)):
        x, w, b = _mats(m, k, n, seed=13)
        xbuf = torch.empty((4096 * 64 + m * k,), dtype=torch.bfloat16,
                           device=cuda)
        wbuf = torch.empty((4096 * 64 + k * n,), dtype=torch.bfloat16,
                           device=cuda)
        xt = xbuf[-m * k:].view(m, k)
        wt = wbuf[-k * n:].view(k, n)
        xt.copy_(_bf16(x, cuda))
        wt.copy_(_bf16(w, cuda))
        with torch.no_grad():
            got = ops.matmul_bias(xt, wt, _bf16(b, cuda), relu=True)
            torch.cuda.synchronize()
        _ulp_check(got, ref.matmul_bias_ref(xt, wt, _bf16(b, cuda), True))


@pytest.mark.cuda
def test_cuda_bf16_backward_launches_the_kernel_twice(cuda):
    x, w, b = _mats(200, 75, 40, seed=14)
    xt, wt, bt = (_bf16(a, cuda).requires_grad_() for a in (x, w, b))
    before = ops.matmul_bias.launches_bf16
    torch.cos(ops.matmul_bias(xt, wt, bt, relu=True)).float().sum() \
        .backward()
    torch.cuda.synchronize()
    assert ops.matmul_bias.launches_bf16 == before + 3
    xp, wp, bp = (_bf16(a, cuda).requires_grad_() for a in (x, w, b))
    torch.cos(ops.matmul_bias(xp, wp, bp, relu=True, backend="plain")) \
        .float().sum().backward()
    for got, want in ((xt.grad, xp.grad), (wt.grad, wp.grad)):
        _ulp_check(got, want)
    torch.testing.assert_close(bt.grad.float(), bp.grad.float(),
                               rtol=BF16_GRAD_RTOL, atol=1e-3)


@pytest.mark.cuda
def test_cuda_bf16_split_is_deterministic(cuda):
    m, k, n = 363, 20000, 96
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.gemm_split(m, n, k, sms, torch.bfloat16) > 1
    x, w, _ = _mats(m, k, n, seed=15)
    xt = _bf16(np.ascontiguousarray(x.T), cuda).t()
    wt = _bf16(w, cuda)
    with torch.no_grad():
        first = ops.matmul_bias(xt, wt)
        second = ops.matmul_bias(xt, wt)
    assert torch.equal(first, second)


# every CUDA_BF16_CASES case through each body that takes it
BODY_CASES = [(body,) + case for case in CUDA_BF16_CASES
              for body in ("wgmma", "swap_ab", "mma_sync")
              if body in _takes(*case[:5])]


@pytest.mark.cuda
@pytest.mark.parametrize("body,m,k,n,trans_a,trans_b,bias,relu", BODY_CASES)
def test_cuda_bf16_each_body_matches_plain(cuda, body, m, k, n, trans_a,
                                           trans_b, bias, relu):
    x, w, b = _mats(m, k, n, seed=16)
    xt = (_bf16(np.ascontiguousarray(x.T), cuda).t() if trans_a
          else _bf16(x, cuda))
    wt = (_bf16(np.ascontiguousarray(w.T), cuda).t() if trans_b
          else _bf16(w, cuda))
    bt = _bf16(b, cuda) if bias else None
    before = (ops.matmul_bias.launches_bf16,
              ops.matmul_bias.launches_bf16_wgmma)
    with torch.no_grad():
        got = ops._matmul(xt, wt, bt, relu, "cuda", body=body)
        torch.cuda.synchronize()
    assert (ops.matmul_bias.launches_bf16,
            ops.matmul_bias.launches_bf16_wgmma) == (
        before[0] + 1, before[1] + (body != "mma_sync"))
    _ulp_check(got, ref.matmul_bias_ref(xt, wt, bt, relu))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(640, 1024, 4096), (16, 1024, 4096)],
                         ids=["mixtral", "decode"])
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True),
                                             (True, False)],
                         ids=["fwd", "dx", "dw"])
def test_cuda_bf16_model_shapes_match_plain(cuda, m, k, n, trans_a,
                                            trans_b):
    """Mixtral's and decode's products at a reduced K, in the three
    layouts the forward and backward give the kernel, on the body the
    rule picks (wgmma, or swap_ab at M = 16 with x in its storage)."""
    x, w, b = _mats(m, k, n, seed=17)
    xt = (_bf16(np.ascontiguousarray(x.T), cuda).t() if trans_a
          else _bf16(x, cuda))
    wt = (_bf16(np.ascontiguousarray(w.T), cuda).t() if trans_b
          else _bf16(w, cuda))
    bt = _bf16(b, cuda)
    before = ops.matmul_bias.launches_bf16_wgmma
    with torch.no_grad():
        got = ops.matmul_bias(xt, wt, bt)
        torch.cuda.synchronize()
    assert ops.matmul_bias.launches_bf16_wgmma == before + 1
    _ulp_check(got, ref.matmul_bias_ref(xt, wt, bt, False))


@pytest.mark.cuda
@pytest.mark.parametrize("body,m,k,n", [("wgmma", 300, 4096, 256),
                                        ("swap_ab", 16, 8192, 1024)])
def test_cuda_bf16_tma_split_is_deterministic(cuda, body, m, k, n):
    """A split reduction on each TMA body: two calls bit-equal, and within
    one bf16 ulp of the plain version."""
    x, w, _ = _mats(m, k, n, seed=18)
    xt, wt = _bf16(x, cuda), _bf16(w, cuda)
    with torch.no_grad():
        first = ops._matmul(xt, wt, None, False, "cuda", body=body,
                            n_split=4)
        second = ops._matmul(xt, wt, None, False, "cuda", body=body,
                             n_split=4)
        torch.cuda.synchronize()
    assert torch.equal(first, second)
    _ulp_check(first, ref.matmul_bias_ref(xt, wt, None, False))


@pytest.mark.cuda
@pytest.mark.parametrize("body,m,k,n", [("wgmma", 200, 136, 72),
                                        ("swap_ab", 37, 72, 96)])
def test_cuda_bf16_tma_operands_at_the_end_of_their_storage(cuda, body, m,
                                                            k, n):
    """x and w as the last rows of larger buffers, with ragged M, N and K
    tiles: TMA's zero fill reads nothing past them."""
    x, w, b = _mats(m, k, n, seed=19)
    xbuf = torch.empty((4096 * 64 + m * k,), dtype=torch.bfloat16,
                       device=cuda)
    wbuf = torch.empty((4096 * 64 + k * n,), dtype=torch.bfloat16,
                       device=cuda)
    xt = xbuf[-m * k:].view(m, k)
    wt = wbuf[-k * n:].view(k, n)
    xt.copy_(_bf16(x, cuda))
    wt.copy_(_bf16(w, cuda))
    with torch.no_grad():
        got = ops._matmul(xt, wt, _bf16(b, cuda), True, "cuda", body=body)
        torch.cuda.synchronize()
    _ulp_check(got, ref.matmul_bias_ref(xt, wt, _bf16(b, cuda), True))


@pytest.mark.cuda
@pytest.mark.parametrize("body,m", [("wgmma", 130), ("swap_ab", 16)])
def test_cuda_bf16_tma_relu_keeps_a_nan(cuda, body, m):
    """A NaN in x reaches its row of y through the bias and the ReLU on
    each TMA body (the ReLU keeps a NaN, as the reference's does), and
    the other rows stay finite."""
    x, w, b = _mats(m, 64, 72, seed=20)
    x[3, 5] = np.nan
    xt, wt, bt = _bf16(x, cuda), _bf16(w, cuda), _bf16(b, cuda)
    with torch.no_grad():
        got = ops._matmul(xt, wt, bt, True, "cuda", body=body)
        torch.cuda.synchronize()
    assert torch.isnan(got[3]).all()
    rest = torch.cat([got[:3], got[4:]])
    assert torch.isfinite(rest).all()
    _ulp_check(rest, torch.cat([ref.matmul_bias_ref(xt[:3], wt, bt, True),
                                ref.matmul_bias_ref(xt[4:], wt, bt, True)]))


@pytest.mark.cuda
def test_cuda_bf16_tma_backward_launches_the_kernel_twice(cuda):
    """Aligned operands: the forward, dx (w read transposed) and dw (x
    read transposed) all on the wgmma body."""
    x, w, b = _mats(200, 72, 40, seed=21)
    xt, wt, bt = (_bf16(a, cuda).requires_grad_() for a in (x, w, b))
    before = (ops.matmul_bias.launches_bf16,
              ops.matmul_bias.launches_bf16_wgmma)
    torch.cos(ops.matmul_bias(xt, wt, bt, relu=True)).float().sum() \
        .backward()
    torch.cuda.synchronize()
    assert (ops.matmul_bias.launches_bf16,
            ops.matmul_bias.launches_bf16_wgmma) == (before[0] + 3,
                                                     before[1] + 3)
    xp, wp, bp = (_bf16(a, cuda).requires_grad_() for a in (x, w, b))
    torch.cos(ops.matmul_bias(xp, wp, bp, relu=True, backend="plain")) \
        .float().sum().backward()
    for got, want in ((xt.grad, xp.grad), (wt.grad, wp.grad)):
        _ulp_check(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (False, True),
                                             (True, False)],
                         ids=["fwd", "dx", "dw"])
def test_cuda_bf16_tma_store_panels_across_tiles(cuda, trans_a, trans_b):
    """At width 192 a warp stores three 64-column panels a tile through two
    staging buffers; with one reduction chunk a tile and several tiles an
    SM, a tile's last store is still reading while the next tile's first
    panel is staged.  Two calls bit-equal and within one bf16 ulp."""
    m, k, n = 4096, 64, 192 * 16
    x, w, b = _mats(m, k, n, seed=22)
    xt = (_bf16(np.ascontiguousarray(x.T), cuda).t() if trans_a
          else _bf16(x, cuda))
    wt = (_bf16(np.ascontiguousarray(w.T), cuda).t() if trans_b
          else _bf16(w, cuda))
    bt = _bf16(b, cuda)
    with torch.no_grad():
        first = ops._matmul(xt, wt, bt, True, "cuda", body="wgmma", bn=192,
                            n_split=1)
        second = ops._matmul(xt, wt, bt, True, "cuda", body="wgmma",
                             bn=192, n_split=1)
        torch.cuda.synchronize()
    assert torch.equal(first, second)
    _ulp_check(first, ref.matmul_bias_ref(xt, wt, bt, True))


def test_gemm_bf16_fit_recovers_the_rules_constants():
    """kernel_sweep.fit_gemm_bf16 (the source of the GEMM_BF16_*
    constants) recovers a model's constants from times that model made,
    at Mixtral's, decode's (M 16, 32, 64) and AlexNet's shapes, and then
    picks the fastest timed choice at every TMA shape."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import kernel_sweep as ks

    bf, sms = torch.bfloat16, 132
    chunk = {("wgmma", 128): 0.4, ("wgmma", 160): 0.45,
             ("wgmma", 192): 0.5, ("wgmma", 256): 0.66,
             ("swap_ab", 16): 0.41, ("swap_ab", 32): 0.46,
             ("swap_ab", 64): 0.55}
    launch_us, sum_us, fill, chunk_s = 5.0, 4.0, 4.25, 2.5e-6
    shapes = [(m, n, k, False, tb) for m, k, n, _, tb in
              _mixtral_products()[:3]]
    shapes += [(m, n, k, False, False) for m in (16, 32, 64)
               for k, n in ((4096, 14336), (14336, 4096))]
    shapes += [(m, n, k, ta, tb) for _, m, k, n, ta, tb in
               _alexnet_products()[2:6]]
    shapes += [(m, n, k, ta, tb) for layer, m, k, n, ta, tb in
               _alexnet_products() if layer == 0]
    points = []
    for m, n, k, ta, tb in shapes:
        body = ops.gemm_plan_bf16(m, n, k, ta, tb, (m if ta else k) % 8 == 0,
                                  (k if tb else n) % 8 == 0, sms)[0]
        times = {}
        if body == "mma_sync":
            tiles = -(-m // ops.GEMM_BF16_BM) * -(-n // ops.GEMM_BF16_BN)
            for z in (1, 2, 4, 8, 16):
                runs = ops.gemm_ranges(k, z, bf)
                split, per = len(runs), runs[0][1]
                waves = -(-tiles * split // (sms * ops.GEMM_BF16_RESIDENT))
                s_ = (launch_us * 1e-6 + waves * (per + ops.GEMM_FILL_CHUNKS)
                      * chunk_s + (split > 1) * split * 8.0 * m * n
                      / ops.HBM_RATE)
                times[("mma_sync", ops.GEMM_BF16_BN, split)] = s_ * 1e3
        else:
            for bn in ops.gemm_widths_bf16(m, body == "swap_ab", tb):
                for z in (1, 2, 3, 4, 6):
                    split = len(ops.gemm_ranges(k, z, bf, body))
                    factor, summed, partial_us = ks._tma_model_terms(
                        ops, m, n, k, body, bn, split, sms, fill)
                    times[(body, bn, split)] = 1e-3 * (
                        launch_us + factor * chunk[(body, bn)]
                        + summed * sum_us + partial_us)
        points.append((m, n, k, body, times))
    fit = ks.fit_gemm_bf16(points, sms)
    tma = fit["tma"]
    assert tma["fill_chunks"] == fill and tma["rms"] < 1e-9
    assert tma["launch_us"] == pytest.approx(launch_us)
    assert tma["sum_us"] == pytest.approx(sum_us)
    for (body, bn), us in chunk.items():
        table = tma["chunk_us" if body == "wgmma" else "swap_chunk_us"]
        assert table[str(bn)] == pytest.approx(us), (body, bn)
    assert fit["mma_sync"]["chunk_s"] == pytest.approx(chunk_s)
    assert fit["mma_sync"]["launch_us"] == pytest.approx(launch_us)
    picks = fit["fitted_model_picks"]
    assert picks["fastest"] == picks["shapes"] == len(shapes) - 2
