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
import re
from pathlib import Path

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


@pytest.mark.parametrize("t,bh,sms", [
    (2048, 256, 132),     # rwkv6-7b training: B 4 x H 64
    (1000, 64, 132),      # ragged T
    (4096, 4, 132),       # few sequences: the longest chunks
    (100, 8, 16),
    (5, 1, 132),          # T shorter than one chunk
    (1, 1, 132),
])
def test_wkv_chunk_covers_each_step_once(t, bh, sms):
    """The kernel's chunks take every step of [0, T) exactly once, in
    whole staged runs (WKV_STEP) between WKV_MIN_CHUNK and
    WKV_MAX_CHUNK steps, the last one short; T under one chunk is one
    chunk."""
    chunk = ops.wkv_chunk(t, bh, sms)
    runs = ops.wkv_chunks(t, chunk)
    assert chunk % ops.WKV_STEP == 0
    assert ops.WKV_MIN_CHUNK <= chunk <= ops.WKV_MAX_CHUNK
    assert [s for a, b in runs for s in range(a, b)] == list(range(t))
    assert all(b - a == chunk for a, b in runs[:-1])
    if t <= ops.WKV_MIN_CHUNK:
        assert runs == [(0, t)]


def test_wkv_chunk_by_shape_and_card():
    """256-step chunks at the training shape on 132 SMs (the last launch
    walks 7 chunks of each of 256 sequences: at least WKV_BLOCKS_PER_SM
    walks per SM), 64 at the ragged shape's 64 sequences; shorter on a
    card with more SMs, the longest for many sequences, the shortest for
    one."""
    train = ops.wkv_chunk(2048, 256, 132)
    assert train == 256
    assert 256 * (2048 // train - 1) >= ops.WKV_BLOCKS_PER_SM * 132
    assert 256 * (2048 // (2 * train) - 1) < ops.WKV_BLOCKS_PER_SM * 132
    assert ops.wkv_chunk(1000, 64, 132) == 64
    assert ops.wkv_chunk(2048, 256, 4 * 132) < train
    assert ops.wkv_chunk(2048, 4096, 132) == ops.WKV_MAX_CHUNK
    assert ops.wkv_chunk(2048, 1, 132) == ops.WKV_MIN_CHUNK


def _three_passes(r, k, v, w, u, chunk):
    """The kernel's chunk-parallel WKV in plain PyTorch, fp32, no log:
    (3) chunk 0 walked from a zero state, which gives its y and S_1; (1)
    each later chunk but the last from a zero state, L = sum_s (k_s * the
    product of the chunk's later w) v_s^T, walked backwards, and its decay
    D = prod w; (2) the carry S_{c+1} = D_c * S_c + L_c from S_1; (3) each
    later chunk walked from its S_c for y; the last walk ends in the final
    state."""
    b, t, h, kk = r.shape
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    runs = ops.wkv_chunks(t, chunk)

    def walk(t0, t1, state, ys):
        for s in range(t0, t1):
            kv = k[:, s, :, :, None] * v[:, s, :, None, :]
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, s],
                                   state + u[None, :, :, None] * kv))
            state = w[:, s, :, :, None] * state + kv
        return state

    ys = []
    state = walk(*runs[0], torch.zeros((b, h, kk, kk)), ys)
    parts = []
    for t0, t1 in runs[1:-1]:
        q = torch.ones((b, h, kk))
        chunk_state = torch.zeros((b, h, kk, kk))
        for s in reversed(range(t0, t1)):
            chunk_state = chunk_state + (k[:, s] * q)[..., None] * \
                v[:, s, :, None, :]
            q = q * w[:, s]
        parts.append((chunk_state, q))
    states = [state]
    for chunk_state, decay in parts:
        states.append(decay[..., None] * states[-1] + chunk_state)
    for (t0, t1), start in zip(runs[1:], states):
        state = walk(t0, t1, start, ys)
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("b,t,h,k,chunk", [
    (2, 100, 2, 16, 32),     # ragged: 3 full chunks and 4 steps
    (1, 70, 3, 32, 16),
    (2, 20, 1, 16, 32),      # T under one chunk
    (1, 64, 2, 64, 16)])
def test_three_passes_match_reference(b, t, h, k, chunk):
    """The three-pass mirror against the port's sequential form and the
    reference's Pallas kernel (interpret mode) on the same numpy
    inputs, ragged T included: y and the final state at 2e-4."""
    xs = _inputs(b, t, h, k, seed=8)
    y, s = _three_passes(*_t(xs), chunk)
    seq_y, seq_s = ref.wkv_sequential(*_t(xs))
    want_y, want_s = wkv_pallas(*map(jnp.asarray, xs), chunk=min(64, t),
                                interpret=True, return_state=True)
    for wy, ws in ((seq_y, seq_s), (want_y, want_s)):
        _close(y, wy)
        _close(s, ws)


def test_three_passes_stay_finite_where_decay_underflows():
    """w = 0 inside a later chunk and on the last step of a chunk (its
    decay product is 0 then): the mirror, which takes no log, stays
    finite and matches the sequential forms, the port's and the
    reference's."""
    r, k, v, w, u = _inputs(1, 100, 2, 16, seed=9)
    w[0, 70, 1, 3] = 0.0          # inside chunk 2 of 32-step chunks
    w[0, 63, 0, 5] = 0.0          # the last step of chunk 1
    y, s = _three_passes(*_t((r, k, v, w, u)), 32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    seq_y, seq_s = ref.wkv_sequential(*_t((r, k, v, w, u)))
    want_y, want_s = jax_ref.wkv_sequential(*map(jnp.asarray,
                                                 (r, k, v, w, u)))
    for wy, ws in ((seq_y, seq_s), (want_y, want_s)):
        _close(y, wy)
        _close(s, ws)


def test_wkv_constants_match_the_kernel():
    """The wrapper's WKV_STEP is the kernel's TS, its scratch of
    B * H * (nc - 1) * (K * K + K) floats the kernel's layout (the
    states, then the decays), and the kernel refuses a chunk that is no
    multiple of TS."""
    src = (Path(ops.__file__).parent / "csrc" / "wkv.cu").read_text()
    ts = re.search(r"constexpr int TS = (\d+);", src)
    assert ts and int(ts.group(1)) == ops.WKV_STEP
    assert "B * H * (nc - 1) * (K * K + K) floats" in src
    assert "part_d = part + (size_t)bh * (nc - 1) * K * K" in src
    # slot 0 of each (b, h) holds S_1, which the walk of chunk 0 leaves
    assert "part + (size_t)bh * (nc - 1) * K * K, rg, cg, S)" in src
    assert "chunk < TS || chunk % TS" in src
    assert ops.WKV_MIN_CHUNK % ops.WKV_STEP == 0


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
    (4, 2048, 64, 64, torch.bfloat16),
    # the chunk-parallel kernel's edges: T 1, T 5 (one short chunk), T
    # not a multiple of the chunk, K 128 over several chunks, a single
    # (b, h)
    (2, 1, 4, 64, torch.float32), (2, 5, 3, 32, torch.bfloat16),
    (2, 300, 4, 64, torch.float32), (1, 700, 2, 128, torch.bfloat16),
    (1, 777, 1, 64, torch.float32)])
def test_kernel_matches_plain_chunked(cuda, b, t, h, k, dtype):
    """The kernel's y and final state against the plain chunked form on
    the same inputs: the smoke shapes (K 16, 32, 128, ragged T), the
    full-width training shape (B 4, T 2048, H 64, K 64, bf16) and the
    chunking's edges."""
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
def test_kernel_stays_finite_where_decay_underflows_at_a_boundary(cuda):
    """w = 0 on the last step of a chunk and on the first of the next
    (the chunk's decay product is 0 there): the kernel against the plain
    sequential form."""
    r, k, v, w, u = _card_inputs(1, 256, 2, 32, torch.float32, seed=4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk = ops.wkv_chunk(256, 2, sms)
    assert chunk < 256
    w[0, chunk - 1, 1, 5] = 0.0
    w[0, chunk, 0, 3] = 0.0
    y, s = ops.wkv_fwd(r, k, v, w, u)
    want_y, want_s = ref.wkv_sequential(r, k, v, w, u)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, want_y, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s, want_s, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_wkv_is_deterministic(cuda):
    """At the training shape the kernel's chunks meet through a carry
    pass in chunk order, not atomics: two calls agree bit for bit."""
    xs = _card_inputs(4, 2048, 64, 64, torch.bfloat16, seed=5)
    first = ops.wkv_fwd(*xs)
    second = ops.wkv_fwd(*xs)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
