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
