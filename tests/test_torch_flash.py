"""The port's flash attention against the reference's, and its CUDA
kernels against their plain versions.

On the CPU the port runs the plain masked-softmax version (autograd
gives its grads); the reference runs its Pallas forward and backward
kernels in interpret mode (``repro.kernels.flash_attention.ops``).  Both
take the same numpy inputs.  The ``FlashAttention`` Function, whose
backward forms delta and calls the dq and dk/dv wrappers, runs here on
the wrappers' plain versions.  Tests marked ``cuda`` hold each kernel
against its plain version on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import ops, ref

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ops as jax_ops
    from repro.kernels.flash_attention import ref as jax_ref
except ImportError:      # a GPU host without JAX runs only the cuda tests
    jax = None

FWD_TOL = 2e-5           # tests/kernels/test_flash_attention.py:33
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6   # tests/kernels/test_grad_parity.py:72
BF16_TOL = 3e-2          # tests/kernels/test_flash_attention.py:36-43
# on the card: the registry tolerance (repro/kernels/flash_attention/ops.py
# :51) for the forward and its 10x for the grads
# (tests/kernels/test_grad_parity.py:203-205)
CUDA_FWD_TOL, CUDA_GRAD_TOL = 2e-4, 2e-3


def _inputs(b, s, hkv, g, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, hkv, g, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    do = rng.normal(size=q.shape).astype(np.float32)
    return q, k, v, do


def _reference(q, k, v, do, causal, window, scale):
    """The reference's Pallas kernels (interpret mode): o and (dq, dk,
    dv) for the cotangent do."""
    def f(q_, k_, v_):
        return jax_ops.flash_attention(q_, k_, v_, causal=causal,
                                       window=window, scale=scale,
                                       interpret=True)

    o, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(x) for x in vjp(jnp.asarray(do))]


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [64, 96])      # 96 pads the reference's tiles
def test_plain_matches_reference(s, causal, window, g, hd):
    q, k, v, do = _inputs(1, s, 2, g, hd, seed=s + hd + g)
    scale = hd ** -0.5
    want_o, want_grads = _reference(q, k, v, do, causal, window, scale)
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                            scale=scale)
    np.testing.assert_allclose(o.detach().numpy(), want_o, rtol=FWD_TOL,
                               atol=FWD_TOL)
    o.backward(torch.from_numpy(do))
    for name, t, want in zip("qkv", (qt, kt, vt), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"d{name}")


def _fold_q(x):
    """(B,S,Hkv,G,hd) -> (B*Hq,S,hd), the kernels' layout."""
    b, s, hkv, g, hd = x.shape
    return torch.as_tensor(x).permute(0, 2, 3, 1, 4).reshape(b * hkv * g, s,
                                                             hd)


def _fold_kv(x):
    """(B,S,Hkv,hd) -> (B*Hkv,S,hd)."""
    b, s, hkv, hd = x.shape
    return torch.as_tensor(x).permute(0, 2, 1, 3).reshape(b * hkv, s, hd)


@pytest.mark.parametrize("s,causal,window,g", [
    (64, True, None, 1), (96, True, 32, 2), (96, False, 32, 2),
    (64, False, None, 2)])
def test_function_on_plain_wrappers_matches_reference(s, causal, window, g):
    """The kernel path's plumbing (saved o and lse, delta, the dq and
    dk/dv wrappers, the GQA group sum) on the wrappers' plain versions."""
    q, k, v, do = _inputs(2, s, 2, g, 64, seed=7)
    scale = 0.125
    want_o, (dq, dk, dv) = _reference(q, k, v, do, causal, window, scale)
    qf = _fold_q(q).requires_grad_()
    kf, vf = (_fold_kv(x).requires_grad_() for x in (k, v))
    o = ops.FlashAttention.apply(qf, kf, vf, 2 * g, 2, causal, window,
                                 scale, "auto")
    o.backward(_fold_q(do))
    np.testing.assert_allclose(o.detach().numpy(), _fold_q(want_o).numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for got, want in ((qf.grad, _fold_q(dq)), (kf.grad, _fold_kv(dk)),
                      (vf.grad, _fold_kv(dv))):
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_bfloat16_forward_matches_reference():
    q, k, v, _ = _inputs(1, 128, 2, 2, 64, seed=1)
    want = jax_ops.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal=True,
        scale=0.125, bq=64, bk=64, interpret=True)
    got = ops.flash_attention(*(torch.tensor(a).bfloat16()
                                for a in (q, k, v)), causal=True,
                              scale=0.125)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_attention_ref_is_the_reference_oracle():
    q, k, v, _ = _inputs(2, 40, 2, 3, 16, seed=3)
    want = jax_ref.attention_ref(*map(jnp.asarray, (q, k, v)), causal=True,
                                 window=8, scale=0.25)
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                            window=8, scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_wrappers_check_their_inputs():
    q, k, v = (torch.zeros(4, 8, 64), torch.zeros(2, 8, 64),
               torch.zeros(2, 8, 64))
    kw = dict(n_q_heads=2, n_kv_heads=1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_fwd(q, k, v, backend="cuda", **kw)
    with pytest.raises(ValueError, match="k, v must be"):
        ops.flash_fwd(q, k[:1], v[:1], **kw)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_fwd(q, k, v, n_q_heads=3, n_kv_heads=2)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_folded(q, k, v, window=0, **kw)
    o, lse = ops.flash_fwd(q, k, v, **kw)           # plain on the CPU
    assert o.shape == q.shape and lse.shape == (4, 8)
    assert lse.dtype == torch.float32


def test_policy_selects_the_attention():
    assert common.KernelPolicy().attention_backend() == "auto"
    assert common.KernelPolicy(attention="flash",
                               backend="cuda").attention_backend() == "cuda"
    assert common.KernelPolicy(attention="xla").attention_backend() == \
        "plain"
    for impl in ("chunked", "qloop"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            common.KernelPolicy(attention=impl)
    with pytest.raises(ValueError, match="attention must be"):
        common.KernelPolicy(attention="sdpa")


# ------------------------------------------------------------ on the card --

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_inputs(b, hq, hkv, s, hd, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b * hq, s, hd), generator=gen, device="cuda")
    k = torch.randn((b * hkv, s, hd), generator=gen, device="cuda")
    v = torch.randn((b * hkv, s, hd), generator=gen, device="cuda")
    do = torch.randn((b * hq, s, hd), generator=gen, device="cuda")
    return [x.to(dtype) for x in (q, k, v, do)]


CARD_CASES = [  # (B, Hq, Hkv, S, hd, causal, window)
    (2, 4, 4, 256, 64, True, None),
    (1, 8, 2, 1000, 128, True, None),     # GQA, ragged S
    (1, 4, 4, 777, 128, True, 256),       # window, ragged S
    (1, 4, 2, 300, 256, False, 100),      # hd 256, no causal mask
    (2, 2, 1, 130, 64, False, None),
    (1, 16, 1, 333, 256, True, 100),      # MQA, G 16, window, ragged S
    (1, 16, 2, 517, 64, True, None),      # G 8 at hd 64, ragged S
    # hd 128 with a window, S off every 64- and 128-row tile: the window's
    # edge and the ragged end cut q and KV tiles of the bf16 dq kernel
    (1, 4, 2, 600, 128, True, 200),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_kernels_match_plain_versions(cuda, case, dtype):
    b, hq, hkv, s, hd, causal, window = case
    q, k, v, do = _card_inputs(b, hq, hkv, s, hd, dtype)
    kw = dict(n_q_heads=hq, n_kv_heads=hkv, causal=causal, window=window,
              scale=hd ** -0.5)
    fwd_tol = CUDA_FWD_TOL if dtype == torch.float32 else BF16_TOL
    grad_tol = CUDA_GRAD_TOL if dtype == torch.float32 else BF16_TOL
    o, lse = ops.flash_fwd(q, k, v, **kw)
    want_o, want_lse = ops.flash_fwd(q, k, v, backend="plain", **kw)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=fwd_tol,
                               atol=fwd_tol)
    torch.testing.assert_close(lse, want_lse, rtol=CUDA_FWD_TOL,
                               atol=CUDA_FWD_TOL)
    delta = (do.float() * want_o.float()).sum(-1)
    dq = ops.flash_dq(q, k, v, do, want_lse, delta, **kw)
    dk, dv = ops.flash_dkv(q, k, v, do, want_lse, delta, **kw)
    want_dq = ops.flash_dq(q, k, v, do, want_lse, delta, backend="plain",
                           **kw)
    want_dk, want_dv = ops.flash_dkv(q, k, v, do, want_lse, delta,
                                     backend="plain", **kw)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=grad_tol,
                                   atol=grad_tol)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 64])
def test_autograd_through_the_kernels(cuda, window):
    """Grads through ``FlashAttention`` on the card against autograd of
    the plain version, and the launch counts of one forward/backward."""
    q, k, v, do = _card_inputs(2, 4, 2, 200, 128, torch.float32, seed=1)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    kw = dict(n_q_heads=4, n_kv_heads=2, causal=True, window=window,
              scale=128 ** -0.5)
    counts = (ops.flash_fwd.launches, ops.flash_dq.launches,
              ops.flash_dkv.launches)
    ops.flash_attention_folded(*leaves, **kw).backward(do)
    assert (ops.flash_fwd.launches, ops.flash_dq.launches,
            ops.flash_dkv.launches) == tuple(c + 1 for c in counts)
    ops.flash_attention_folded(*plain, backend="plain", **kw).backward(do)
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=CUDA_GRAD_TOL,
                                   atol=CUDA_GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,window", [(256, 2048), (128, None)])
def test_split_dkv_is_deterministic(cuda, hd, window):
    """At G 16 the bf16 dk/dv kernel splits each group's heads over blocks
    and sums their fp32 partials in a fixed order: two calls agree bit
    for bit (a resumed run repeats an uninterrupted one)."""
    b, hq, hkv, s = 1, 16, 1, 640
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert ops.dkv_split(b, hkv, s, hq // hkv, hd, sms) > 1
    q, k, v, do = _card_inputs(b, hq, hkv, s, hd, torch.bfloat16, seed=2)
    kw = dict(n_q_heads=hq, n_kv_heads=hkv, causal=True, window=window,
              scale=hd ** -0.5)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    first = ops.flash_dkv(q, k, v, do, lse, delta, **kw)
    second = ops.flash_dkv(q, k, v, do, lse, delta, **kw)
    assert torch.equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,s,hd,window", [(16, 1, 640, 256, 2048),
                                                (4, 2, 640, 128, None)])
def test_dq_is_deterministic(cuda, hq, hkv, s, hd, window):
    """The bf16 dq kernel writes each dq element once, from the block that
    owns its q tile: two calls agree bit for bit (at G 16, hd 256 with
    the hybrid's window, and at hd 128)."""
    q, k, v, do = _card_inputs(1, hq, hkv, s, hd, torch.bfloat16, seed=3)
    kw = dict(n_q_heads=hq, n_kv_heads=hkv, causal=True, window=window,
              scale=hd ** -0.5)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    first = ops.flash_dq(q, k, v, do, lse, delta, **kw)
    second = ops.flash_dq(q, k, v, do, lse, delta, **kw)
    assert first.dtype == torch.bfloat16
    assert torch.equal(first, second)
