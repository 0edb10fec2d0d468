"""The port's Hopper kernels against their plain PyTorch versions on the
card (marked ``cuda``; skipped without one).  Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: the DP band-min is bit-equal (one add and one min per split);
flash attention 2e-2 in bf16 (and 2 bf16 ulps + 1e-5 from the float32 plain
version of the same inputs) and 1e-4 in f32 (another summation order, exp on
the device); RMSNorm within one bf16 ulp and rtol 1e-6 in f32."""

import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import counters  # noqa: E402
from repro_torch.core import dp_kernels  # noqa: E402
from repro_torch.core.chain import Chain  # noqa: E402
from repro_torch.kernels.dp_fill import ops as dp_ops  # noqa: E402
from repro_torch.kernels.dp_fill import ref as dp_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("d,ns,w", [(1, 1, 4), (3, 5, 17), (9, 2, 501),
                                    (7, 300, 33)])
def test_band_min_kernel_bit_equal(dev, d, ns, w):
    g = torch.Generator(device=dev).manual_seed(d + ns)
    r = torch.rand((d, ns, w), generator=g, device=dev) * 8
    r[torch.rand((d, ns, w), generator=g, device=dev) < 0.3] = math.inf
    lm = torch.rand((d, ns, w), generator=g, device=dev) * 8 - 4
    before = counters.snapshot().get(dp_ops.NAME, 0)
    got = dp_ops.band_min_two_tier(r, lm)
    assert counters.snapshot()[dp_ops.NAME] == before + 1
    assert torch.equal(got, dp_ref.band_min_two_tier(r, lm))


def test_cuda_fill_bit_equal_to_banded(dev):
    rng = np.random.default_rng(0)
    for _ in range(4):
        L = int(rng.integers(3, 12))
        ch = Chain.make(uf=rng.integers(1, 5, L + 1), ub=rng.integers(1, 5, L + 1),
                        wa=rng.integers(1, 4, L + 1),
                        wabar=rng.integers(1, 6, L + 1))
        m = math.ceil(ch.store_all_peak() * 0.6)
        dch = ch.discretize(m, int(m))
        a = dp_kernels.fill_tables(dch, int(m), impl="cuda").data
        b = dp_kernels.fill_tables(dch, int(m), impl="banded").data
        assert np.array_equal(a, b)


@pytest.mark.parametrize("B,S,H,K,D", [(1, 37, 4, 2, 16), (2, 64, 8, 1, 64),
                                       (1, 130, 4, 4, 128), (2, 96, 6, 2, 32)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(dev, B, S, H, K, D, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(S + D)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
               for h in (H, K, K))
    got = flash_ops.attention_fwd(q, k, v)
    torch.testing.assert_close(got, flash_ref.attention(q, k, v), rtol=tol,
                               atol=tol)
    if dtype == torch.bfloat16:
        # float32 inside, one rounding on the store: within 2 bf16 ulps of
        # the float32 plain version of the same inputs
        want = flash_ref.attention(q.float(), k.float(), v.float())
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30)))
                         - 7)
        assert bool(torch.all((got.float() - want).abs() <= 2 * ulp + 1e-5))


def test_flash_kernel_reads_strided_layout(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 50, 3, 4, 32), generator=g, device=dev)
    q, k, v = qkv.unbind(2)            # non-contiguous (B, S, H, D) views
    torch.testing.assert_close(flash_ops.attention_fwd(q, k, v),
                               flash_ref.attention(q, k, v), rtol=1e-4,
                               atol=1e-4)


def test_flash_kernel_rejects_other_head_dims(dev):
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.attention_fwd(q, q, q)


@pytest.mark.parametrize("shape", [(7, 2560), (3, 5, 100), (64, 16)])
def test_rms_norm_kernel_matches_plain(dev, shape):
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=dev)
    s = 1 + 0.1 * torch.randn(shape[-1:], generator=g, device=dev)
    torch.testing.assert_close(rms_ops.rms_norm_fwd(x, s),
                               rms_ref.rms_norm(x, s), rtol=1e-6, atol=0)
    xb, sb = x.bfloat16(), s.bfloat16()
    got = rms_ops.rms_norm_fwd(xb, sb).float()
    want = rms_ref.rms_norm(xb, sb).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    assert bool(torch.all((got - want).abs() <= ulp))


def test_rms_norm_kernel_strided_rows(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((6, 300), generator=g, device=dev)[:, :256]
    s = 1 + 0.1 * torch.randn((256,), generator=g, device=dev)
    torch.testing.assert_close(rms_ops.rms_norm_fwd(x, s),
                               rms_ref.rms_norm(x, s), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="contiguous last dimension"):
        rms_ops.rms_norm_fwd(x.t(), s[:6].contiguous())


def test_autograd_functions_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((1, 40, h, 16), generator=g, device=dev)
               .requires_grad_() for h in (4, 2, 2))
    flash_ops.flash_attention(q, k, v).square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    flash_ref.attention(q, k, v).square().sum().backward()
    for a, t in zip(got, (q, k, v)):
        torch.testing.assert_close(a, t.grad, rtol=1e-3, atol=1e-3)
