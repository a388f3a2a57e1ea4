"""The port's LRN against the reference's Pallas kernel (interpret mode on
the CPU), on the same numpy inputs.  Tests marked ``cuda`` hold the CUDA
kernel against the plain version and skip on a host without a card."""
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


CUDA_SHAPES = [(2, 7, 7, 24), (8, 27, 27, 96), (8, 13, 13, 256),
               (3, 4, 4, 5), (2, 3, 3, 3), (4, 130), (5, 3000)]


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
