"""The port's LRN against the reference's Pallas kernel (interpret mode on
the CPU), on the same numpy inputs.  Tests marked ``cuda`` hold the CUDA
kernel against the plain version and skip on a host without a card."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.lrn import ops, ref

try:
    import jax.numpy as jnp

    from repro.kernels.lrn.lrn import lrn_pallas
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jnp = lrn_pallas = None

TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _x(shape, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 7, 7, 24), (2, 5, 5, 96),
                                   (1, 4, 4, 256)],
                         ids=["C24", "C96", "C256"])
def test_lrn_matches_reference(shape):
    x = _x(shape)
    got = ops.lrn(torch.from_numpy(x)).numpy()
    want = np.asarray(lrn_pallas(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n,alpha,beta,k", [
    (3, 5e-3, 0.5, 1.0),
    (7, 1e-3, 1.0, 2.0),     # beta = 1
    (4, 2e-3, 0.75, 1.5),    # even window: one more channel below than above
    (5, 1e-2, 0.6, 0.5),
])
def test_lrn_constants_match_reference(n, alpha, beta, k):
    x = _x((2, 6, 6, 16), seed=1)
    got = ops.lrn(torch.from_numpy(x), n=n, alpha=alpha, beta=beta,
                  k=k).numpy()
    want = np.asarray(lrn_pallas(jnp.asarray(x), n=n, alpha=alpha, beta=beta,
                                 k=k))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [3, 5, 7])
def test_library_lrn_needs_alpha_times_n(n):
    """The chip smoke's yardstick ``F.local_response_norm`` divides alpha
    by the window size: with ``n * alpha`` it computes the same LRN."""
    x = torch.from_numpy(_x((2, 5, 5, 20), seed=2, scale=10.0))
    lib = F.local_response_norm(x.permute(0, 3, 1, 2), n, alpha=n * 1e-4,
                                beta=0.75, k=2.0).permute(0, 2, 3, 1)
    torch.testing.assert_close(lib, ref.lrn_ref(x, n=n), rtol=TOL, atol=TOL)


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.lrn(torch.zeros(2, 3, 3, 8), backend="cuda")


def test_lrn_constants_match_the_kernel():
    """The wrapper's account of the vectorized path is the kernel's: 4
    channels a thread, a row's MAX_GROUPS = BLOCK groups in one block,
    windows up to MAX_N."""
    src = (Path(ops.__file__).parent / "csrc" / "lrn.cu").read_text()
    block = re.search(r"constexpr int BLOCK = (\d+);", src)
    window = re.search(r"constexpr int MAX_N = (\d+);", src)
    assert "constexpr int MAX_GROUPS = BLOCK;" in src
    assert block and 4 * int(block.group(1)) == ops.VEC_MAX_CHANNELS
    assert window and int(window.group(1)) == ops.VEC_MAX_WINDOW
    assert "C % 4 == 0 && G <= MAX_GROUPS && n <= MAX_N" in src


def test_lrn_bf16_constants_match_the_kernel():
    """The wrapper's account of the bf16 8-channel path is the kernel's:
    a row's MAX_GROUPS = BLOCK groups of 8 channels in one block, windows
    up to MAX_N, picked by shape in ``lrn_bf16`` before the launch."""
    src = (Path(ops.__file__).parent / "csrc" / "lrn.cu").read_text()
    block = re.search(r"constexpr int BLOCK = (\d+);", src)
    assert block and 8 * int(block.group(1)) == ops.VEC8_MAX_CHANNELS
    assert "C % 8 == 0 && G <= MAX_GROUPS && n <= MAX_N &&\n" \
        "                    k >= FLT_MIN && alpha >= 0.f &&\n" \
        "                    ((uintptr_t)x | (uintptr_t)y) % 16 == 0;" in src
    assert "if (!vec8) return launch(x, y, M, C, n, alpha, beta, k, st);" \
        in src


@pytest.mark.parametrize("c,n,dtype,k,alpha,align,path", [
    (96, 5, torch.bfloat16, 2.0, 1e-4, 16, "vec8"),    # lrn1: 12 a row
    (256, 5, torch.bfloat16, 2.0, 1e-4, 16, "vec8"),   # lrn2: 32 a row
    (2048, 9, torch.bfloat16, 2.0, 1e-4, 16, "vec8"),
    (20, 5, torch.bfloat16, 2.0, 1e-4, 16, "vec4"),    # C % 8 != 0
    (2056, 5, torch.bfloat16, 2.0, 1e-4, 16, "generic"),  # past both
    (96, 11, torch.bfloat16, 2.0, 1e-4, 16, "generic"),   # n past MAX_N
    (5, 5, torch.bfloat16, 2.0, 1e-4, 16, "generic"),
    (96, 5, torch.bfloat16, 0.0, 1e-4, 16, "vec4"),    # d may be 0
    (96, 5, torch.bfloat16, 1e-39, 1e-4, 16, "vec4"),  # k subnormal
    (96, 5, torch.bfloat16, 2.0, -1e-4, 16, "vec4"),   # d may fall below k
    (96, 5, torch.bfloat16, 2.0, 1e-4, 8, "vec4"),     # 8 bytes off
    (96, 5, torch.bfloat16, 2.0, 1e-4, 4, "generic"),
    (96, 5, torch.float32, 2.0, 1e-4, 16, "vec4"),     # fp32 keeps its path
    (1024, 9, torch.float32, 2.0, 1e-4, 16, "vec4"),
    (2048, 5, torch.float32, 2.0, 1e-4, 16, "generic"),
    (96, 5, torch.float32, 2.0, 1e-4, 8, "generic"),
])
def test_lrn_path_rule(c, n, dtype, k, alpha, align, path):
    """The path ``lrn_bf16`` / ``lrn_f32`` take: 8 bf16 channels a thread
    only where d = k + alpha * (a sum of squares) is surely a normal
    number (the SFU's flushing power) and x and y are 16-byte aligned; 4
    channels a thread where a 4-channel load is aligned."""
    assert ops.lrn_path(c, n, dtype, k, alpha, align) == path


def test_backward_is_booked_apart():
    """The plain backward runs inside a ``lrn_bwd`` profiler range (a
    trace books its device time apart) and matches autograd through the
    plain forward."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(_x((2, 3, 3, 16), seed=4)).requires_grad_()
    dy = torch.from_numpy(_x((2, 3, 3, 16), seed=5, scale=1.0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, = torch.autograd.grad(ops.lrn(x), x, dy)
    assert any(e.name == "lrn_bwd" for e in prof.events())
    want, = torch.autograd.grad(ref.lrn_ref(x), x, dy)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


CUDA_SHAPES = [(2, 7, 7, 24), (8, 27, 27, 96), (8, 13, 13, 256),
               (3, 4, 4, 5), (2, 3, 3, 3), (4, 130), (5, 3000),
               (128, 27, 27, 96), (128, 13, 13, 256), (3, 5000)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES, ids=[str(s) for s in
                                                    CUDA_SHAPES])
@pytest.mark.parametrize("n,alpha,beta,k", [(5, 1e-4, 0.75, 2.0),
                                            (4, 2e-3, 0.6, 1.5)])
def test_cuda_kernel_matches_plain(cuda, shape, n, alpha, beta, k):
    x = torch.from_numpy(_x(shape, seed=3, scale=10.0)).to(cuda)
    before = ops.lrn.launches
    got = ops.lrn(x, n=n, alpha=alpha, beta=beta, k=k)
    torch.cuda.synchronize()
    assert ops.lrn.launches == before + 1
    torch.testing.assert_close(got, ref.lrn_ref(x, n=n, alpha=alpha,
                                                beta=beta, k=k),
                               rtol=TOL, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 9, 11])
def test_cuda_kernel_windows(cuda, n):
    """The vectorized path's narrowest and widest windows, and a window
    past it (the one-element path), against the plain version."""
    x = torch.from_numpy(_x((4, 9, 9, 96), seed=6, scale=10.0)).to(cuda)
    got = ops.lrn(x, n=n, alpha=1e-3)
    torch.testing.assert_close(got, ref.lrn_ref(x, n=n, alpha=1e-3),
                               rtol=TOL, atol=TOL)


# bf16 kernel vs its plain version (upcast, fp32 math, one rounding):
# chip_smoke.py's BF16_TOL, 2 bf16 ulps of max |y|
BF16_TOL = 8e-3


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2.0, 0.0], ids=["k2", "k0"])
@pytest.mark.parametrize("shape", [(8, 27, 27, 96), (8, 13, 13, 256),
                                   (128, 27, 27, 96), (3, 7, 7, 20),
                                   (2, 5, 5, 5), (7, 2048)],
                         ids=["C96", "C256", "C96-b128", "C20", "C5",
                              "C2048"])
def test_cuda_lrn_bf16_matches_plain(cuda, shape, k):
    """``lrn_bf16`` on each of its paths (8 channels a thread with the
    power on the SFU at C = 96, 256 and 2048 where k = 2; 4 channels a
    thread with the full-accuracy power at those C where k = 0, and at C
    = 20; one element at C = 5) against the plain version in bf16, and its
    launch counted."""
    x = torch.from_numpy(_x(shape, seed=7, scale=10.0)).to(cuda,
                                                           torch.bfloat16)
    before = ops.lrn.launches_bf16
    got = ops.lrn(x, k=k)
    torch.cuda.synchronize()
    assert ops.lrn.launches_bf16 == before + 1
    want = ref.lrn_ref(x, k=k)
    assert got.dtype == want.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_TOL * want.float().abs().max().item()


def _bf16_ulps(a, b):
    """bf16 ulps between a and b, elementwise (bit patterns on one ordered
    integer line)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return (ordered(a) - ordered(b)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 27, 27, 96), (8, 13, 13, 256)],
                         ids=["lrn1", "lrn2"])
def test_cuda_lrn_bf16_sfu_power_within_one_ulp(cuda, shape):
    """At AlexNet's LRNs the 8-channel path's SFU power and the
    full-accuracy one (the same values 8 bytes off a 16-byte boundary
    take the 4-channel path) round to the same bf16 or to neighbours."""
    x = torch.from_numpy(_x(shape, seed=11, scale=10.0)).to(cuda,
                                                            torch.bfloat16)
    x8 = torch.empty(x.numel() + 4, device=cuda, dtype=torch.bfloat16)[4:]
    x8 = x8.view(shape).copy_(x)
    assert x8.data_ptr() % 16 == 8
    assert ops.lrn_path(shape[-1], 5, torch.bfloat16, 2.0, 1e-4) == "vec8"
    assert ops.lrn_path(shape[-1], 5, torch.bfloat16, 2.0, 1e-4,
                        align=8) == "vec4"
    sfu, full = ops.lrn(x), ops.lrn(x8)
    assert _bf16_ulps(sfu, full).max().item() <= 1
