"""The port's RG-LRU recurrence against the reference's, and its CUDA
kernel against its plain version.

On the CPU the port runs its plain loop and the ``RGLRU`` Function,
whose backward is the same recurrence run backwards through the same
wrapper; the reference runs its sequential oracle, its Pallas kernel in
interpret mode (``rglru_pallas(interpret=True)``) and the model's
``associative_scan``.  Both take the same numpy inputs.  Tests marked
``cuda`` hold the kernel, forward and reversed, against the plain
version on the card.  The kernel's chunk decomposition is mirrored in
plain PyTorch (``_chunk_mirror``) and held against the reference on the
CPU.
"""
import re
from pathlib import Path

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


def test_transpose_grads_match_pallas_vjp():
    """``ref.rglru_transpose_grads`` (g = db, da_t = g_t h_{t-1}) and the
    wrapper's plain route against ``jax.vjp`` of ``rglru_pallas`` in
    interpret mode, at TOL."""
    a, bb = _ab(2, 45, 12, seed=4)
    dh = np.random.default_rng(5).normal(size=a.shape).astype(np.float32)
    h_j, vjp = jax.vjp(lambda a_, b_: rglru_pallas(a_, b_, interpret=True),
                       jnp.asarray(a), jnp.asarray(bb))
    want_da, want_db = vjp(jnp.asarray(dh))
    ta, tdh = torch.from_numpy(a), torch.from_numpy(dh)
    h = torch.from_numpy(np.array(h_j))
    for g, da in (ref.rglru_transpose_grads(ta, tdh, h),
                  ops.rglru_transpose_grads(ta, tdh, h, backend="plain")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_db), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(da.numpy(), np.asarray(want_da),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,n_rows,sms,want", [
    (2048, 2 * 4096, 132, 256),   # recurrentgemma-9b training: 256 tiles
    (1000, 4000, 132, 256),       # ragged T: 125 tiles x 4 chunks
    (1000, 4000, 4 * 132, 64),    # the same on a card with more SMs
    (1000, 4000, 2 * 132, 128),
    (1, 2 * 4096, 132, 64),       # T = 1: one chunk, the shortest
    (100, 24, 132, 64),           # one tile
])
def test_rglru_chunk_by_shape_and_card(t, n_rows, sms, want):
    """The longest chunk whose blocks still number RGLRU_BLOCKS_PER_SM
    per SM, else the shortest; and the grid covers every step and
    channel once."""
    chunk = ops.rglru_chunk(t, n_rows, sms)
    assert chunk == want and chunk in ops.RGLRU_CHUNKS
    tiles = -(-n_rows // ops.RGLRU_TILE)
    enough = tiles * -(-t // chunk) >= ops.RGLRU_BLOCKS_PER_SM * sms
    assert enough or chunk == min(ops.RGLRU_CHUNKS)
    longer = [c for c in ops.RGLRU_CHUNKS if c > chunk]
    assert all(tiles * -(-t // c) < ops.RGLRU_BLOCKS_PER_SM * sms
               for c in longer)
    n_tiles, n_chunks = ops.rglru_grid(1, t, n_rows, chunk)
    assert n_chunks * chunk >= t > (n_chunks - 1) * chunk
    assert n_tiles * ops.RGLRU_TILE >= n_rows > (n_tiles - 1) * \
        ops.RGLRU_TILE


def _chunk_mirror(a, b, chunk, rows, reverse=False, h=None):
    """The kernel's decomposition in plain PyTorch, fp32, no log: chunks
    of ``chunk`` steps in walk order (from the end with ``reverse``), each
    cut into ``rows`` sub-chunks.  Each sub-chunk walks from zero, keeping
    its end state E and the product P of its coefficients (a_t forward,
    a_{t+1} reversed, 0 past T); the chunk's rows fold in walk order,
    state = P state + E, from the state the chunk before left; then each
    row walks again from its entering state.  With ``h`` (reversed) it
    also returns da_t = g_t h_{t-1}."""
    a, b = a.float(), b.float()
    bsz, t, d = a.shape
    n_chunks = -(-t // chunk)
    steps = n_chunks * chunk
    pad = torch.zeros((bsz, steps + 1 - t, d))
    ap, bp = torch.cat([a, pad], 1), torch.cat([b, pad], 1)
    coef = ap[:, 1:] if reverse else ap[:, :-1]
    sub = chunk // rows
    out = torch.empty((bsz, steps, d))
    state = torch.zeros((bsz, d))
    order = range(n_chunks - 1, -1, -1) if reverse else range(n_chunks)
    for c in order:
        starts = [c * chunk + r * sub for r in range(rows)]
        walk = [list(range(s0, s0 + sub)) for s0 in starts]
        if reverse:
            walk = [ts[::-1] for ts in walk[::-1]]
        folds = []
        for ts in walk:
            p, e = torch.ones((bsz, d)), torch.zeros((bsz, d))
            for s in ts:
                p = p * coef[:, s]
                e = torch.addcmul(bp[:, s], coef[:, s], e)
            folds.append((p, e))
        entering = []
        for p, e in folds:
            entering.append(state)
            state = torch.addcmul(e, p, state)
        for ts, hin in zip(walk, entering):
            for s in ts:
                hin = torch.addcmul(bp[:, s], coef[:, s], hin)
                out[:, s] = hin
    out = out[:, :t]
    if h is None:
        return out
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    return out, out * h_prev


def _special_ab(kind, b, t, d, seed):
    a, bb = _ab(b, t, d, seed=seed, strong=kind == "strong")
    if kind == "a_zero":
        a[:, ::3] = 0.0
        a[0, 5] = 0.0
    elif kind == "a_above_1":
        a = 1.0 + 0.5 * np.abs(a)
    return a, bb


@pytest.mark.parametrize("kind,b,t,d,chunk,rows", [
    ("plain", 2, 100, 12, 32, 8),      # ragged: 3 full chunks and 4 steps
    ("plain", 1, 70, 5, 16, 4),
    ("plain", 2, 20, 3, 32, 8),        # T under one chunk
    ("a_zero", 1, 90, 6, 16, 8),
    ("a_above_1", 1, 40, 4, 16, 4),    # a in [1, 1.5]: h grows to ~1e5
    ("strong", 2, 64, 6, 16, 4),       # a ~ e^-10: P underflows to 0
])
def test_chunk_mirror_matches_reference(kind, b, t, d, chunk, rows):
    """The kernel's chunk decomposition, forward and reversed (with da),
    against the port's plain loops and the reference's sequential oracle
    and Pallas kernel (interpret mode) on the same numpy inputs, at TOL
    relative to the largest |h|; finite throughout."""
    a, bb = _special_ab(kind, b, t, d, seed=6)
    ta, tb = torch.from_numpy(a), torch.from_numpy(bb)
    h = _chunk_mirror(ta, tb, chunk, rows)
    assert torch.isfinite(h).all()
    scale = max(1.0, h.abs().max().item())
    for want in (ref.rglru_sequential(ta, tb)[0],
                 jax_ref.rglru_sequential(a, bb)[0],
                 rglru_pallas(jnp.asarray(a), jnp.asarray(bb),
                              interpret=True)):
        np.testing.assert_allclose(h.numpy() / scale,
                                   np.asarray(want) / scale, rtol=TOL,
                                   atol=TOL)
    dh = np.random.default_rng(7).normal(size=a.shape).astype(np.float32)
    g, da = _chunk_mirror(ta, torch.from_numpy(dh), chunk, rows,
                          reverse=True, h=h)
    assert torch.isfinite(g).all() and torch.isfinite(da).all()
    want_g, want_da = ref.rglru_transpose_grads(ta, torch.from_numpy(dh), h)
    for got, want in ((g, want_g), (da, want_da)):
        s = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got / s, want / s, rtol=TOL, atol=TOL)


def test_rglru_constants_match_the_kernel():
    """The wrapper's tile and chunks are the kernel's: TILE, the chunks
    ``by_chunk`` takes, and the grid ``launch`` runs."""
    src = (Path(ops.__file__).parent / "csrc" / "rglru.cu").read_text()
    tile = re.search(r"constexpr int TILE = (\d+);", src)
    assert tile and int(tile.group(1)) == ops.RGLRU_TILE
    cases = tuple(int(c) for c in re.findall(r"case (\d+):", src))
    assert cases == ops.RGLRU_CHUNKS
    assert "n_tiles = B * tiles_per_row" in src
    assert "n_chunks = (T + R * S - 1) / (R * S)" in src
    assert "1 + tile * n_chunks + chunk" in src


def test_wrapper_checks_its_inputs():
    a, b = (torch.from_numpy(x) for x in _ab(1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru_fwd(a, b, backend="cuda")
    with pytest.raises(ValueError, match="one"):
        ops.rglru_fwd(a, b[:, :4])
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru_transpose_grads(a, b, a, backend="cuda")
    with pytest.raises(ValueError, match="one"):
        ops.rglru_transpose_grads(a, b, a[:, :4])


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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [512, 99], ids=["vec4", "scalar"])
@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_kernel_at_many_chunks(cuda, chunk, d):
    """T 4096 (16 to 64 chunks chained), every chunk the kernel is built
    for, the 16-byte path and the one-channel path (D % 4 != 0): both
    directions and the reversed launch's da against the plain loops."""
    a, bb = _card_ab(2, 4096, d, seed=3)
    h, _ = ops._launch(a, bb, reverse=False, chunk=chunk)
    g, da = ops._launch(a, bb, reverse=True, h=h, chunk=chunk)
    g_only, none = ops._launch(a, bb, reverse=True, chunk=chunk)
    torch.cuda.synchronize()
    assert none is None
    want_h = ref.rglru_sequential(a, bb)[0]
    want_g, want_da = ref.rglru_transpose_grads(a, bb, h)
    torch.testing.assert_close(h, want_h, rtol=TOL, atol=TOL)
    torch.testing.assert_close(g, want_g, rtol=TOL, atol=TOL)
    torch.testing.assert_close(da, want_da, rtol=TOL, atol=TOL)
    assert torch.equal(g_only, g)


@pytest.mark.cuda
def test_kernel_is_deterministic(cuda):
    """Two calls of each direction agree bit for bit: the chain folds one
    predecessor in one order, whatever the blocks' timing."""
    a, bb = _card_ab(2, 2048, 4096, seed=4)
    h1, h2 = (ops.rglru_fwd(a, bb) for _ in range(2))
    (g1, da1), (g2, da2) = (ops.rglru_transpose_grads(a, bb, h1)
                            for _ in range(2))
    assert torch.equal(h1, h2)
    assert torch.equal(g1, g2) and torch.equal(da1, da2)


@pytest.mark.cuda
def test_reversed_da_is_g_times_h_prev(cuda):
    """The reversed launch's da is g_t h_{t-1} of its own g, with h_{-1} =
    0, bit for bit; and the special inputs stay finite (a = 0, strong
    decay, a > 1 over short T)."""
    a, bb = _card_ab(2, 1000, 4000, seed=5)
    h = ops.rglru_fwd(a, bb)
    g, da = ops.rglru_transpose_grads(a, bb, h)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    assert torch.equal(da, g * h_prev)
    for kind in ("a_zero", "a_above_1", "strong"):
        an, bn = _special_ab(kind, 2, 300 if kind == "a_above_1" else 3000,
                             64, seed=6)
        if kind == "a_above_1":
            an = 1.0 + 0.03 * (an - 1.0)
        ta, tb = (torch.from_numpy(x).to(cuda) for x in (an, bn))
        h = ops.rglru_fwd(ta, tb)
        g, da = ops.rglru_transpose_grads(ta, tb, h)
        assert all(torch.isfinite(x).all() for x in (h, g, da))
        scale = max(1.0, h.abs().max().item())
        torch.testing.assert_close(h / scale, ref.rglru_sequential(
            ta, tb)[0] / scale, rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_function_launches_once_per_direction(cuda):
    """The Function's forward and backward are one launch each; the
    backward runs no ``cat`` or separate multiply of its own."""
    a, bb = _card_ab(1, 512, 256, seed=7)
    ta, tb = a.clone().requires_grad_(), bb.clone().requires_grad_()
    before = ops.rglru_fwd.launches
    h = ops.rglru_scan(ta, tb)
    torch.autograd.grad(h, (ta, tb), torch.ones_like(h))
    torch.cuda.synchronize()
    assert ops.rglru_fwd.launches == before + 2
