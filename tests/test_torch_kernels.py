"""The plain versions of the port's flash-attention and RMSNorm kernels (what
their wrappers run on CPU tensors) against the JAX package's Pallas kernels
in interpret mode and its jnp oracles, forward and gradient, in float32
(bfloat16 for the RMSNorm rounding check).  Inputs come from numpy seeds.

Tolerances: float32 forward 1e-5 (attention: two einsums and a softmax in a
different summation order) and 1e-6 relative (RMSNorm: one reduction);
gradients 1e-4 (attention) and 1e-5 (RMSNorm); bfloat16 RMSNorm within one
bfloat16 ulp, since both sides round the same float32 value."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.kernels.flash_attention import ops as jflash  # noqa: E402
from repro.kernels.flash_attention import ref as jflash_ref  # noqa: E402
from repro.kernels.rmsnorm import ops as jrms  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch.kernels.flash_attention import ops as pflash  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as prms  # noqa: E402
from repro_torch.models import common as pcommon  # noqa: E402


@pytest.fixture(autouse=True)
def interpret_mode():
    jflash.set_interpret(True)
    jrms.set_interpret(True)
    yield
    jflash.set_interpret(False)
    jrms.set_interpret(False)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 ulp at each |x| (8 significand bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("B,S,H,K,D", [(1, 37, 4, 2, 16), (2, 64, 8, 1, 64),
                                       (1, 128, 4, 4, 128)])
def test_flash_attention_matches_jax(B, S, H, K, D):
    rng = np.random.default_rng(S * H + D)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    out = pflash.flash_attention(tq, tk, tv)
    out.backward(torch.from_numpy(g))
    got = out.detach().numpy()
    want_out, vjp = jax.vjp(jflash.flash_attention, q, k, v)
    np.testing.assert_allclose(got, np.asarray(want_out), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jflash_ref.attention(q, k, v)),
                               rtol=1e-5, atol=1e-5)
    for t, w in zip((tq, tk, tv), vjp(jnp.asarray(g))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("shape", [(4, 37, 256), (3, 128)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(len(shape) * 7 + shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    s = (rng.standard_normal(shape[-1:]) * 0.1 + 1).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)

    tx, ts = (torch.from_numpy(a).requires_grad_() for a in (x, s))
    x, s = jnp.asarray(x), jnp.asarray(s)
    out = prms.rms_norm(tx, ts)
    out.backward(torch.from_numpy(g))
    got = out.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jrms.rms_norm(x, s)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jcommon.rms_norm({"scale": s}, x)), rtol=1e-6)
    np.testing.assert_allclose(
        pcommon.rms_norm({"scale": ts}, tx).detach().numpy(), got, rtol=0)

    want = jax.grad(lambda x_, s_: jnp.sum(jrms.rms_norm(x_, s_) * g),
                    argnums=(0, 1))(x, s)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want[1]), atol=1e-5)


def test_rms_norm_bf16_within_one_ulp():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 512)).astype(np.float32)
    s = (rng.standard_normal(512) * 0.1 + 1).astype(np.float32)
    got = prms.rms_norm(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(s).bfloat16()).float().numpy()
    want = np.asarray(jrms.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                    jnp.asarray(s, jnp.bfloat16)),
                      dtype=np.float32)
    assert np.all(np.abs(got - want) <= _bf16_ulp(want))
