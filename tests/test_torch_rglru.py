"""The port's RG-LRU recurrence against the reference's, and its CUDA
kernel against its plain version.

On the CPU the port runs its plain loop and the ``RGLRU`` Function,
whose backward is the same recurrence run backwards through the same
wrapper; the reference runs its sequential oracle, its Pallas kernel in
interpret mode (``rglru_pallas(interpret=True)``) and the model's
``associative_scan``.  Both take the same numpy inputs.  Tests marked
``cuda`` hold the kernel, forward and reversed, against the plain
version on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.rglru import ops, ref

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels.rglru import ref as jax_ref
    from repro.kernels.rglru.rglru import rglru_pallas
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

TOL = 2e-4               # the registry's (repro/kernels/rglru/ops.py:50)
# tests/kernels/test_grad_parity.py:118-131
GRAD_RTOL, GRAD_ATOL = 3e-4, 1e-7


def _ab(b, t, d, seed=0, strong=False):
    """a in (0, 1) as exp(-c softplus(Lambda) r), or a ~ e^-10 with
    ``strong``; b normal."""
    rng = np.random.default_rng(seed)
    if strong:
        a = np.exp(-10.0 + 0.1 * rng.normal(size=(b, t, d)))
    else:
        a = 1.0 / (1.0 + np.exp(-(rng.normal(size=(b, t, d)) * 0.5 + 2.0)))
    return a.astype(np.float32), rng.normal(size=(b, t, d)).astype(
        np.float32)


def _assoc_scan(a, b):
    def combine(lt, rt):
        al, bl = lt
        ar, br = rt
        return al * ar, ar * bl + br

    return jax.lax.associative_scan(combine, (jnp.asarray(a),
                                              jnp.asarray(b)), axis=1)[1]


@pytest.mark.parametrize("b,t,d,strong", [
    (2, 256, 128, False), (1, 128, 256, False), (1, 100, 24, False),
    (3, 64, 32, False), (1, 100, 24, True)])
def test_plain_matches_reference(b, t, d, strong):
    """The plain loop (and ``rglru_fwd``'s plain route) against
    ``rglru_sequential``, ``rglru_pallas`` in interpret mode and the
    model's ``associative_scan``: ragged T and D, and strong decay."""
    a, bb = _ab(b, t, d, strong=strong)
    h, h_fin = ref.rglru_sequential(torch.from_numpy(a),
                                    torch.from_numpy(bb))
    torch.testing.assert_close(h_fin, h[:, -1])
    got = ops.rglru_fwd(torch.from_numpy(a), torch.from_numpy(bb),
                        backend="plain")
    torch.testing.assert_close(got, h, rtol=0, atol=0)
    for want in (jax_ref.rglru_sequential(a, bb)[0],
                 rglru_pallas(jnp.asarray(a), jnp.asarray(bb),
                              interpret=True),
                 _assoc_scan(a, bb)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("b,t,d", [(2, 128, 16), (1, 100, 24), (3, 64, 32)])
def test_function_grads_match_pallas(b, t, d):
    """The Function's (da, db) on its plain route against ``jax.grad``
    through ``rglru_pallas`` on the grad-parity loss ``mean(h * c)``
    (tests/kernels/test_grad_parity.py:118-131)."""
    a, bb = _ab(b, t, d, seed=1)
    c = np.random.default_rng(2).normal(size=(b, t, d)).astype(np.float32)
    want = jax.grad(lambda a_, b_: jnp.mean(
        rglru_pallas(a_, b_, interpret=True) * c), (0, 1))(
            jnp.asarray(a), jnp.asarray(bb))
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, bb))
    got = torch.autograd.grad(
        (ops.rglru_scan(ta, tb, backend="plain") * torch.from_numpy(c)
         ).mean(), (ta, tb))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_transpose_is_the_backward_of_the_loop():
    """``rglru_transpose`` against autograd through the plain loop."""
    a, bb = (torch.from_numpy(x) for x in _ab(2, 37, 5, seed=3))
    dh = torch.randn(a.shape, generator=torch.Generator().manual_seed(0))
    b_ = bb.clone().requires_grad_()
    want, = torch.autograd.grad(ref.rglru_sequential(a, b_)[0], b_, dh)
    torch.testing.assert_close(ref.rglru_transpose(a, dh), want)
    torch.testing.assert_close(
        ops.rglru_fwd(a, dh, reverse=True, backend="plain"), want)


def test_strong_decay_grads_stay_finite():
    """a ~ 5e-5 (the reference's test_rglru_grad_strong_decay_finite): no
    log is taken, so nothing overflows."""
    a = torch.full((1, 128, 8), 5e-5, requires_grad=True)
    b = torch.ones((1, 128, 8), requires_grad=True)
    da, db = torch.autograd.grad(ops.rglru_scan(a, b).sum(), (a, b))
    assert torch.isfinite(da).all() and torch.isfinite(db).all()


def test_wrapper_checks_its_inputs():
    a, b = (torch.from_numpy(x) for x in _ab(1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru_fwd(a, b, backend="cuda")
    with pytest.raises(ValueError, match="one"):
        ops.rglru_fwd(a, b[:, :4])


def test_policy_selects_the_scan():
    assert common.KernelPolicy().rglru_backend() == "auto"
    assert common.KernelPolicy(rglru="xla",
                               backend="cuda").rglru_backend() == "plain"
    with pytest.raises(ValueError, match="rglru"):
        common.KernelPolicy(rglru="pallas")


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _card_ab(b, t, d, seed=0, strong=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((b, t, d), generator=gen, device="cuda")
    a = torch.exp(-10.0 + 0.1 * z) if strong else torch.sigmoid(0.5 * z + 2)
    return a, torch.randn((b, t, d), generator=gen, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,d,strong", [
    (2, 128, 16, False), (1, 100, 24, False), (1, 1000, 4000, False),
    (1, 100, 24, True), (4, 2048, 4096, False)])
def test_kernel_matches_plain(cuda, b, t, d, strong):
    """Forward and reversed launches against the plain loop: the smoke
    shapes, ragged T and D, strong decay, and the full-width training
    shape (B 4, T 2048, D 4096)."""
    a, bb = _card_ab(b, t, d, strong=strong)
    before = ops.rglru_fwd.launches
    h = ops.rglru_fwd(a, bb)
    g = ops.rglru_fwd(a, bb, reverse=True)
    torch.cuda.synchronize()
    assert ops.rglru_fwd.launches == before + 2
    torch.testing.assert_close(h, ref.rglru_sequential(a, bb)[0],
                               rtol=TOL, atol=TOL)
    torch.testing.assert_close(g, ref.rglru_transpose(a, bb), rtol=TOL,
                               atol=TOL)


@pytest.mark.cuda
def test_backward_kernel_matches_plain_grads(cuda):
    """The Function's grads with the kernel, forward and backward,
    against the Function on the plain route."""
    a, bb = _card_ab(2, 300, 96, seed=1)
    dh = torch.randn(a.shape, generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda")
    grads = []
    for backend in ("cuda", "plain"):
        ta, tb = a.clone().requires_grad_(), bb.clone().requires_grad_()
        grads.append(torch.autograd.grad(
            ops.rglru_scan(ta, tb, backend=backend), (ta, tb), dh))
    for g, wv in zip(*grads):
        torch.testing.assert_close(g, wv, rtol=TOL, atol=TOL)
