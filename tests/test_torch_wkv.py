"""The port's WKV6 recurrence against the reference's, and its CUDA
kernel against its plain versions.

On the CPU the port runs its plain versions (``ref.wkv_sequential``,
``ref.wkv_chunked``) and the ``WKV`` Function, whose forward is the
plain chunked form there and whose backward rebuilds one chunk's graph
at a time; the reference runs its XLA forms and its Pallas kernel in
interpret mode (``wkv_pallas(interpret=True)``), at the shapes of its
own tests.  Both take the same numpy inputs.  Tests marked ``cuda`` hold
the kernel against the plain versions on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.rwkv6 import ops, ref

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels.rwkv6 import ref as jax_ref
    from repro.kernels.rwkv6.rwkv6 import wkv_pallas
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

TOL = 2e-4               # the registry's (repro/kernels/rwkv6/ops.py:60)
# tests/kernels/test_grad_parity.py:178-182: the Pallas backward against
# the chunked form it pulls through
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-7
# dw passes through log(w): the reference's own sequential oracle misses
# the Pallas vjp there by up to 3e-6 at these shapes, so dw gets the
# tolerance the reference holds its Pallas grads to against that oracle
# (tests/kernels/test_grad_parity.py:184-187)
DW_RTOL, DW_ATOL = 3e-3, 1e-6
BF16_TOL = 1e-2          # one bf16 rounding of y (2^-7 relative)


def _inputs(b, t, h, k, seed=0):
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.normal(size=(b, t, h, k)).astype(np.float32)
                for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(b, t, h, k)) * 0.5)).astype(
        np.float32)
    u = (rng.normal(size=(h, k)) * 0.5).astype(np.float32)
    return r, kk, v, w, u


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,t,h,k,chunk", [
    (1, 64, 1, 16, 16), (2, 128, 3, 32, 32), (2, 128, 2, 64, 64),
    (1, 256, 4, 16, 64), (1, 100, 2, 16, 32)])
def test_plain_versions_match_reference(b, t, h, k, chunk):
    """Sequential and chunked, y and the final state, against the
    reference's (tests/kernels/test_rwkv6.py:23-35, plus ragged T)."""
    xs = _inputs(b, t, h, k)
    jx = [jnp.asarray(x) for x in xs]
    for mine, theirs in (
            (ref.wkv_sequential(*_t(xs)), jax_ref.wkv_sequential(*jx)),
            (ref.wkv_chunked(*_t(xs), chunk=chunk),
             jax_ref.wkv_chunked(*jx, chunk=chunk))):
        _close(mine[0], theirs[0])
        _close(mine[1], theirs[1])


@pytest.mark.parametrize("b,t,h,k", [
    (2, 128, 2, 32), (1, 128, 1, 64), (2, 64, 4, 16), (1, 100, 2, 16)])
def test_wrapper_matches_pallas_kernel(b, t, h, k):
    """``wkv_fwd``'s plain route against ``wkv_pallas`` in interpret mode
    (tests/kernels/test_rwkv6.py:38-47 and :112-123): y and the final
    state, ragged T included."""
    xs = _inputs(b, t, h, k, seed=1)
    y, s = ops.wkv_fwd(*_t(xs), backend="plain")
    want_y, want_s = wkv_pallas(*map(jnp.asarray, xs), chunk=min(64, t),
                                interpret=True, return_state=True)
    assert y.dtype == torch.float32 and s.shape == (b, h, k, k)
    _close(y, want_y)
    _close(s, want_s)


def test_bfloat16_inputs_match_reference():
    """bf16 r, k, v with fp32 w and u, as the model feeds them: the fp32
    chunked output and the final state at 2e-4 against the reference's
    chunked form on the same bf16 inputs; y in bf16 against the Pallas
    kernel's bf16 y within one bf16 rounding."""
    r, k, v, w, u = _inputs(1, 100, 2, 16, seed=2)
    bf = [torch.from_numpy(x).bfloat16() for x in (r, k, v)]
    jbf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (r, k, v)]
    tw, tu = torch.from_numpy(w), torch.from_numpy(u)
    y32, s = ref.wkv_chunked(*bf, tw, tu, chunk=64)
    want_y, want_s = jax_ref.wkv_chunked(*jbf, jnp.asarray(w),
                                         jnp.asarray(u), chunk=64)
    _close(y32, want_y)
    _close(s, want_s)
    y, s = ops.wkv_fwd(*bf, tw, tu, backend="plain")
    pal_y, pal_s = wkv_pallas(*jbf, jnp.asarray(w), jnp.asarray(u),
                              chunk=64, interpret=True, return_state=True)
    assert y.dtype == torch.bfloat16 and pal_y.dtype == jnp.bfloat16
    _close(y, np.asarray(pal_y.astype(jnp.float32)), BF16_TOL)
    _close(s, pal_s)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,t,h,k", [
    (2, 128, 2, 32), (1, 100, 1, 16), (2, 64, 4, 16)])
def test_function_grads_match_pallas_vjp(b, t, h, k, with_state):
    """The Function's grads for all five inputs against ``jax.vjp`` of
    ``wkv_pallas``, on the grad-parity loss ``mean(y * c)``
    (tests/kernels/test_grad_parity.py:160-182), plus ``mean(S * c')``
    on the final state."""
    xs = _inputs(b, t, h, k, seed=3)
    rng = np.random.default_rng(4)
    dy = (rng.normal(size=(b, t, h, k)) / (b * t * h * k)).astype(
        np.float32)
    ds = (rng.normal(size=(b, h, k, k)) / (b * h * k * k) * with_state
          ).astype(np.float32)
    _, pull = jax.vjp(lambda *a: wkv_pallas(*a, chunk=min(64, t),
                                            interpret=True,
                                            return_state=True),
                      *map(jnp.asarray, xs))
    want = pull((jnp.asarray(dy), jnp.asarray(ds)))
    leaves = [x.requires_grad_() for x in _t(xs)]
    y, s = ops.wkv(*leaves, backend="plain")
    got = torch.autograd.grad((y, s), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(ds)))
    for name, g, wv in zip("rkvwu", got, want):
        rtol, atol = (DW_RTOL, DW_ATOL) if name == "w" else \
            (GRAD_RTOL, GRAD_ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=rtol,
                                   atol=atol, err_msg=f"d{name}")


@pytest.mark.parametrize("t", [64, 100, 200])
def test_chunk_recompute_backward_matches_autograd(t):
    """The backward that rebuilds one chunk at a time against autograd
    through the whole plain chunked form, at 1e-5."""
    xs = _inputs(2, t, 2, 16, seed=5)
    rng = np.random.default_rng(6)
    dy = torch.from_numpy(rng.normal(size=(2, t, 2, 16)).astype(np.float32))
    ds = torch.from_numpy(rng.normal(size=(2, 2, 16, 16)).astype(
        np.float32))
    a = [x.requires_grad_() for x in _t(xs)]
    y, s = ops.wkv(*a, backend="plain")
    got = torch.autograd.grad((y, s), a, (dy, ds))
    b = [x.requires_grad_() for x in _t(xs)]
    y, s = ref.wkv_chunked(*b, chunk=min(64, t))
    want = torch.autograd.grad((y, s), b, (dy, ds))
    for g, wv in zip(got, want):
        torch.testing.assert_close(g, wv, rtol=1e-5, atol=1e-5)


def test_underflowed_decay_stays_finite_sequentially():
    """One w = 0 entry (w = exp(-exp(z)) underflows for z above about
    4.64, below the model's clamp at 8): the sequential version stays
    finite, while the chunked forms, the reference's and the port's,
    take log(0) and give NaN (ROADMAP.md section C)."""
    r, k, v, w, u = _inputs(1, 32, 1, 8, seed=7)
    w[0, 5, 0, 3] = 0.0
    y, s = ref.wkv_sequential(*_t((r, k, v, w, u)))
    want_y, want_s = jax_ref.wkv_sequential(*map(jnp.asarray,
                                                 (r, k, v, w, u)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y, want_y)
    _close(s, want_s)
    assert torch.isnan(ref.wkv_chunked(*_t((r, k, v, w, u)),
                                       chunk=32)[0]).any()
    assert np.isnan(np.asarray(jax_ref.wkv_chunked(
        *map(jnp.asarray, (r, k, v, w, u)), chunk=32)[0])).any()


def test_wrapper_checks_its_inputs():
    r, k, v, w, u = _t(_inputs(1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv_fwd(r, k, v, w, u, backend="cuda")
    with pytest.raises(ValueError, match="u must be"):
        ops.wkv_fwd(r, k, v, w, u[:1], backend="plain")
    with pytest.raises(ValueError, match="w must be"):
        ops.wkv(r, k, v, w[:, :4], u)


def test_policy_selects_the_wkv():
    assert common.KernelPolicy().rwkv6_backend() == "auto"
    assert common.KernelPolicy(backend="cuda").rwkv6_backend() == "cuda"
    assert common.KernelPolicy(rwkv6="chunked",
                               backend="cuda").rwkv6_backend() == "plain"
    with pytest.raises(ValueError, match="rwkv6"):
        common.KernelPolicy(rwkv6="pallas")


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(b, t, h, k, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r, k_, v = (torch.randn((b, t, h, k), generator=gen,
                            device="cuda").to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((b, t, h, k), generator=gen,
                                         device="cuda") * 0.5 - 1.0))
    u = torch.randn((h, k), generator=gen, device="cuda") * 0.5
    return r, k_, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,k,dtype", [
    (2, 64, 8, 32, torch.float32), (1, 100, 4, 16, torch.float32),
    (2, 128, 2, 128, torch.float32), (2, 64, 8, 32, torch.bfloat16),
    (4, 2048, 64, 64, torch.bfloat16)])
def test_kernel_matches_plain_chunked(cuda, b, t, h, k, dtype):
    """The kernel's y and final state against the plain chunked form on
    the same inputs: the smoke shapes (K 16, 32, 128, ragged T) and the
    full-width training shape (B 4, T 2048, H 64, K 64, bf16)."""
    xs = _card_inputs(b, t, h, k, dtype)
    before = ops.wkv_fwd.launches
    y, s = ops.wkv_fwd(*xs)
    torch.cuda.synchronize()
    assert ops.wkv_fwd.launches == before + 1 and y.dtype == dtype
    want_y, want_s = ref.wkv_chunked(*xs, chunk=min(64, t))
    tol = TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(y.float(), want_y.to(dtype).float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(s, want_s, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_kernel_stays_finite_where_decay_underflows(cuda):
    """One w = 0 entry: the kernel against the plain sequential form."""
    r, k, v, w, u = _card_inputs(1, 64, 2, 32, torch.float32, seed=1)
    w[0, 10, 1, 5] = 0.0
    y, s = ops.wkv_fwd(r, k, v, w, u)
    want_y, want_s = ref.wkv_sequential(r, k, v, w, u)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, want_y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s, want_s, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_function_on_the_card_matches_plain_route(cuda):
    """Grads of the Function with the kernel's forward against the same
    Function on the plain route."""
    xs = _card_inputs(2, 100, 4, 32, torch.float32, seed=2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    dy = torch.randn(xs[0].shape, generator=gen, device="cuda")
    ds = torch.randn((2, 4, 32, 32), generator=gen, device="cuda")
    grads = []
    for backend in ("cuda", "plain"):
        a = [x.clone().requires_grad_() for x in xs]
        y, s = ops.wkv(*a, backend=backend)
        grads.append(torch.autograd.grad((y, s), a, (dy, ds)))
    for g, wv in zip(*grads):
        torch.testing.assert_close(g, wv, rtol=1e-5, atol=1e-5)
