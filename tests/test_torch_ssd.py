"""The port's SSD (``repro_torch.kernels.ssd``) against the JAX package on
the CPU, on inputs made with numpy: the plain chunked scan (the CPU path of
the kernel wrapper ``ops.ssd_chunked``) against the JAX ``ops.ssd_chunked``
with its Pallas kernel in interpret mode and against the JAX sequential
oracle ``ref.ssd_naive``; the plain within-chunk terms (K6's plain version)
against the interpret-mode Pallas kernel itself; forward, final state,
gradients with respect to x, dt, A, B and C, and a state carried from one
call to the next.

Tolerance: 2e-4 (rtol and atol) everywhere, the tolerance the JAX package
holds its own interpret-mode kernel to — float32 cumulative sums and
products taken in another order by two frameworks."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssd import kernel as jkernel  # noqa: E402
from repro.kernels.ssd import ops as jops  # noqa: E402
from repro.kernels.ssd import ref as jref  # noqa: E402
from repro_torch import counters  # noqa: E402
from repro_torch.core.planner import residual_bytes  # noqa: E402
from repro_torch.kernels.ssd import ops as pops  # noqa: E402
from repro_torch.kernels.ssd import ref as pref  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)

# (B, S, H, P, G, N, Q): the JAX package's SSD_CASES (tests/test_kernels.py)
# and one where two heads share each group
SSD_CASES = [
    (2, 64, 4, 16, 1, 32, 16),
    (1, 48, 2, 8, 2, 16, 16),   # grouped B/C
    (1, 40, 2, 8, 1, 16, 16),   # ragged: S is not a multiple of Q
    (1, 40, 4, 8, 2, 16, 8),    # heads 0, 1 read group 0; heads 2, 3 group 1
]


@pytest.fixture(autouse=True)
def interpret_mode():
    jops.set_interpret(True)
    yield
    jops.set_interpret(False)


def _inputs(B, S, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.1
          ).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _t(arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad)
            for a in arrays]


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SSD_CASES)
def test_forward_matches_jax(B, S, H, P, G, N, Q):
    args = _inputs(B, S, H, P, G, N)
    jy, jst = jops.ssd_chunked(*map(jnp.asarray, args), Q)
    ny, nst = jref.ssd_naive(*map(jnp.asarray, args))
    with torch.no_grad():
        for impl in (pref.ssd_chunked, pops.ssd_chunked):
            y, st = impl(*_t(args), Q)
            for want_y, want_st in ((jy, jst), (ny, nst)):
                np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                           **TOL)
                np.testing.assert_allclose(st.numpy(), np.asarray(want_st),
                                           **TOL)
        y, st = pref.ssd_naive(*_t(args))
    np.testing.assert_allclose(y.numpy(), np.asarray(ny), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(nst), **TOL)


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SSD_CASES)
def test_gradients_match_jax(B, S, H, P, G, N, Q):
    args = _inputs(B, S, H, P, G, N, seed=1)
    rng = np.random.default_rng(2)
    gy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    gst = rng.standard_normal((B, H, P, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jops.ssd_chunked(*a, Q),
                     *map(jnp.asarray, args))
    want = vjp((jnp.asarray(gy), jnp.asarray(gst)))
    for impl in (pops.ssd_chunked, pref.ssd_chunked):
        inputs = _t(args, grad=True)
        y, st = impl(*inputs, Q)
        got = torch.autograd.grad((y, st), inputs,
                                  (torch.from_numpy(gy), torch.from_numpy(gst)))
        for name, a, b in zip("x dt A B C".split(), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       err_msg=f"{impl.__module__} d{name}",
                                       **TOL)


@pytest.mark.parametrize("B,S,H,P,G,N,Q", SSD_CASES)
def test_chunk_terms_match_pallas_kernel(B, S, H, P, G, N, Q):
    """K6's plain version against the interpret-mode Pallas kernel, in the
    kernel's (B·H, nc, Q, ·) layout (time padded to whole chunks first)."""
    x, dt, A, Bm, Cm = _t(_inputs(B, S, H, P, G, N, seed=3))
    x, dt, Bm, Cm = pref.pad_to_chunks(Q, x, dt, Bm, Cm)
    nc = x.shape[1] // Q
    with torch.no_grad():
        y_diag, states = pops.ssd_chunk_blocks(x, dt, A, Bm, Cm, Q)
    assert y_diag.dtype == states.dtype == torch.float32
    assert states.shape == (B, nc, H, P, N)

    def per_head(t, width):      # (B, S, H or G, w) -> (B·H, nc, Q, w)
        a = np.repeat(t.numpy(), H // t.shape[2], axis=2)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, nc, Q,
                                                           width))

    jy, js = jkernel.ssd_chunk_blocks(
        per_head(x, P), jnp.asarray(dt.numpy().transpose(0, 2, 1).reshape(
            B * H, nc, Q)), jnp.asarray(np.tile(A.numpy(), B)),
        per_head(Bm, N), per_head(Cm, N), interpret=True)
    np.testing.assert_allclose(
        y_diag.numpy().reshape(B, nc, Q, H, P).transpose(0, 3, 1, 2, 4),
        np.asarray(jy).reshape(B, H, nc, Q, P), **TOL)
    np.testing.assert_allclose(states.numpy().transpose(0, 2, 1, 3, 4),
                               np.asarray(js).reshape(B, H, nc, P, N), **TOL)


def test_state_continuation():
    """One call over [0, S) equals two calls over [0, S/2) and [S/2, S) with
    the first call's final state passed on, in both packages (and the second
    call's gradient reaches the carried state)."""
    B, S, H, P, G, N, Q = 1, 48, 2, 8, 1, 16, 8
    args = _inputs(B, S, H, P, G, N, seed=4)
    h = S // 2

    def halves(a):
        return ([t[:, :h] if t.ndim > 1 else t for t in a],
                [t[:, h:] if t.ndim > 1 else t for t in a])

    first, second = halves(args)
    jy1, js1 = jops.ssd_chunked(*map(jnp.asarray, first), Q)
    jy2, js2 = jops.ssd_chunked(*map(jnp.asarray, second), Q, js1)
    y, st = pops.ssd_chunked(*_t(args), Q)
    y1, s1 = pops.ssd_chunked(*_t(first), Q)
    s1 = s1.detach().requires_grad_()
    y2, s2 = pops.ssd_chunked(*_t(second), Q, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).detach().numpy(),
                               y.detach().numpy(), **TOL)
    np.testing.assert_allclose(s2.detach().numpy(), st.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(y2.detach().numpy(), np.asarray(jy2), **TOL)
    np.testing.assert_allclose(s2.detach().numpy(), np.asarray(js2), **TOL)
    (g,) = torch.autograd.grad(y2.sum(), s1)
    _, vjp = jax.vjp(lambda s: jops.ssd_chunked(
        *map(jnp.asarray, second), Q, s)[0].sum(), js1)
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(1.0)[0]), **TOL)


def test_kernel_path_saves_only_inputs_on_meta():
    """On ``meta`` tensors (the planner's profile) the kernel wrapper's
    autograd function saves its inputs only, where the plain scan keeps its
    (Q × Q) decay and weight tensors: the residual the planner prices is
    the outputs alone."""
    B, S, H, P, G, N, Q = 2, 64, 4, 16, 1, 32, 16
    shapes = [(B, S, H, P), (B, S, H), (H,), (B, S, G, N), (B, S, G, N)]
    a = [torch.empty(s, device="meta", requires_grad=True) for s in shapes]
    out_bytes = 4 * (B * S * H * P + B * H * P * N)
    (y, st), kernel_res = residual_bytes(
        lambda p, a_: pops.ssd_chunked(*a_, Q), {}, a)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N)
    assert kernel_res == out_bytes
    _, plain_res = residual_bytes(lambda p, a_: pref.ssd_chunked(*a_, Q),
                                  {}, a)
    assert plain_res > out_bytes + 4 * B * (S // Q) * H * Q * Q


def test_cpu_path_counts_no_launch():
    counters.reset()
    args = _t(_inputs(1, 32, 2, 8, 1, 16))
    pops.ssd_chunk_blocks(*args, 16)
    pops.ssd_chunked(*args, 16)
    assert pops.NAME not in counters.snapshot()
