"""The arithmetic of K6's bf16 tensor-core kernel (``csrc/ssd_chunk.cu``,
``ssd_chunk_mma``), emulated in plain PyTorch on the CPU, against the
port's plain within-chunk terms (``ref.chunk_terms``, float32) and the JAX
package's Pallas ``ssd_chunk_blocks`` in interpret mode, on inputs made with
numpy.  Which kernel a dtype and a shape take is the C launcher's choice
(``ssd_chunk_head_slice``); the card tests pin it.

The emulation does what the kernel does: x, B and C are bf16 values (exact
in float32); each (batch, chunk, group) computes its scores C·Bᵀ once in
float32 and every head of each slice reuses them; W = S ⊙ exp(cs_i − cs_j)
⊙ dt_j below the diagonal and the state's scaled x are each split into
bf16 hi + lo; the products of bf16 values are exact in float32 and summed
in float32.

Tolerance: 2e-4 (rtol and atol), the one the kernel is held to on the card
and the JAX package holds its interpret-mode kernel to.  One case shows that
a single bf16 W (no lo term) misses it, so the split is needed."""

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssd import kernel as jkernel  # noqa: E402
from repro_torch.kernels.ssd import ref as pref  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
P_TC, Q_TC = 64, 256               # (P, Q) of the tensor-core kernel
N_TC, N_ZAMBA = 128, 64            # its states: Mamba2's and Zamba2's
MAX_SLICE = 8                      # its heads of one group per block


def _inputs(B, S, H, P, G, N, seed=0):
    """The mixer's ranges, with x, B and C rounded to bf16 (as the kernel
    reads them) and kept as float32."""
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float()

    x = bf16(rng.standard_normal((B, S, H, P)))
    dt = torch.from_numpy((np.log1p(np.exp(rng.standard_normal((B, S, H))))
                           * 0.1).astype(np.float32))
    A = torch.from_numpy(-np.exp(np.linspace(0.0, np.log(16.0), H))
                         .astype(np.float32))
    Bm = bf16(rng.standard_normal((B, S, G, N)) * 0.3)
    Cm = bf16(rng.standard_normal((B, S, G, N)) * 0.3)
    return x, dt, A, Bm, Cm


def _parts(t, split):
    """t as bf16 hi (+ lo = bf16(t − hi)), each exact in float32."""
    hi = t.bfloat16().float()
    return (hi, (t - hi).bfloat16().float()) if split else (hi,)


def emulate(x, dt, A, Bm, Cm, chunk, slice_, split=True):
    """The tensor-core kernel's y_diag and states, in its order of work."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R, nc = H // G, S // chunk
    y = torch.full((Bsz, S, H, P), float("nan"))
    states = torch.full((Bsz, nc, H, P, N), float("nan"))
    keep = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    for b in range(Bsz):
        for c in range(nc):
            t = slice(c * chunk, (c + 1) * chunk)
            for g in range(G):
                Bg, Cg = Bm[b, t, g], Cm[b, t, g]
                scores = Cg @ Bg.T                  # once for the group
                for h0 in range(g * R, (g + 1) * R, slice_):
                    for h in range(h0, min(h0 + slice_, (g + 1) * R)):
                        d = dt[b, t, h]
                        cs = torch.cumsum(d * A[h], 0)
                        w = torch.where(keep, scores * torch.exp(
                            cs[:, None] - cs[None, :]) * d[None, :], 0.0)
                        xh = x[b, t, h]
                        y[b, t, h] = sum(p @ xh for p in _parts(w, split))
                        xs = xh * (torch.exp(cs[-1] - cs) * d)[:, None]
                        states[b, c, h] = sum(p.T @ Bg
                                              for p in _parts(xs, split))
    return y, states


def _pallas(x, dt, A, Bm, Cm, chunk):
    """The JAX package's Pallas kernel in interpret mode, in the port's
    layouts."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc = S // chunk

    def per_head(t, width):      # (B, S, H or G, w) -> (B·H, nc, Q, w)
        a = np.repeat(t.numpy(), H // t.shape[2], axis=2)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, nc, chunk,
                                                           width))

    jy, js = jkernel.ssd_chunk_blocks(
        per_head(x, P), jnp.asarray(dt.numpy().transpose(0, 2, 1).reshape(
            B * H, nc, chunk)), jnp.asarray(np.tile(A.numpy(), B)),
        per_head(Bm, N), per_head(Cm, N), interpret=True)
    return (np.asarray(jy).reshape(B, H, nc, chunk, P).transpose(0, 2, 3, 1, 4)
            .reshape(B, S, H, P),
            np.asarray(js).reshape(B, H, nc, P, N).transpose(0, 2, 1, 3, 4))


def _padded(Q, x, dt, A, Bm, Cm):
    x, dt, Bm, Cm = pref.pad_to_chunks(Q, x, dt, Bm, Cm)
    return x, dt, A, Bm, Cm


# (B, S, H, P, G, N, Q): several heads of one group, four groups, a ragged
# S (padded to whole chunks), 12 heads in slices of 8 and 4, 10 in slices
# of 8 and 2, and at the tensor-core kernel's own (P, N, Q): one group,
# four groups of 2 heads, and a ragged S; at Zamba2's state 64, one group
# of 10 heads (slices of 8 and 2, as Zamba2's 80 heads are 10 slices of 8)
# and a ragged S
CASES = [
    (2, 64, 6, 16, 1, 32, 16),
    (1, 64, 8, 16, 4, 32, 16),
    (1, 40, 4, 8, 2, 16, 16),
    (1, 32, 12, 16, 1, 32, 16),
    (2, 48, 10, 16, 1, 32, 16),
    (1, 512, 3, P_TC, 1, N_TC, Q_TC),
    (1, 256, 8, P_TC, 4, N_TC, Q_TC),
    (1, 300, 2, P_TC, 1, N_TC, Q_TC),
    (1, 256, 10, P_TC, 1, N_ZAMBA, Q_TC),
    (1, 300, 2, P_TC, 1, N_ZAMBA, Q_TC),
]


@pytest.mark.parametrize("B,S,H,P,G,N,Q", CASES)
def test_emulation_matches_plain_and_pallas(B, S, H, P, G, N, Q):
    x, dt, A, Bm, Cm = _padded(Q, *_inputs(B, S, H, P, G, N))
    slice_ = min(MAX_SLICE, H // G)
    y, st = emulate(x, dt, A, Bm, Cm, Q, slice_)
    # every head of every slice was written (the outputs start as NaN)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    want_y, want_st = pref.chunk_terms(x, dt, A, Bm, Cm, Q)
    torch.testing.assert_close(y, want_y, **TOL)
    torch.testing.assert_close(st, want_st, **TOL)
    jy, js = _pallas(x, dt, A, Bm, Cm, Q)
    np.testing.assert_allclose(y.numpy(), jy, **TOL)
    np.testing.assert_allclose(st.numpy(), js, **TOL)


@pytest.mark.parametrize("N", [N_ZAMBA, N_TC])
def test_single_bf16_weights_miss_the_tolerance(N):
    """Without the lo terms (W and the scaled x rounded once to bf16, a
    relative error of up to 2^-9) the outputs leave 2e-4 at the paths'
    (P, N, Q), Zamba2's and Mamba2's; with them they stay well inside it."""
    x, dt, A, Bm, Cm = _inputs(1, Q_TC, 2, P_TC, 1, N, seed=1)
    want = pref.chunk_terms(x, dt, A, Bm, Cm, Q_TC)

    def worst(split):
        got = emulate(x, dt, A, Bm, Cm, Q_TC, 2, split=split)
        return max(float(((a - b).abs() / (2e-4 + 2e-4 * b.abs())).max())
                   for a, b in zip(got, want))

    assert worst(split=False) > 1.0
    assert worst(split=True) < 0.5
