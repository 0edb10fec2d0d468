"""The port's Hopper kernels against their plain PyTorch versions on the
card (marked ``cuda``; skipped without one — except the check that a
missing ``nvcc`` makes the build raise, which needs no card).  Run on a GPU
machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where only PyTorch is installed.
Tolerances: the DP kernels (K1, K5a, K2, K5b) are bit-equal (adds, mins and
maxes only; every DP quantity of an integer chain is exact in float32);
flash attention 2e-2 in bf16, and 2 bf16 ulps + 2^-8 Σ p |v| / l + 1e-5
from the float32 plain version of the same inputs (the kernel rounds each
p <= 1 to bf16 before P·V, as the plain bf16 version rounds the
probabilities: a relative error of at most 2^-8, since bf16 keeps 8
significant bits; Σ p |v| / l is the plain attention of |v|, at most
max|v|), and 1e-4 in f32 (another summation order, exp on the device);
RMSNorm within one bf16 ulp and rtol 1e-6 in f32; the SSD kernel (K6) 2e-4
(rtol and atol) in f32 and with bf16 x, B, C alike (the scalar kernel
converts them to float32 exactly, as the plain version does; the
tensor-core kernel multiplies bf16 values exactly and splits W and the
scaled x into bf16 hi + lo, ~2^-17 relative), and the bf16 output of the
whole scan within 2 bf16 ulps + 2e-4."""

import math
import os
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import counters  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core import dp_kernels  # noqa: E402
from repro_torch.core.chain import Chain, HostTransferModel  # noqa: E402
from repro_torch.core.executor import reference_grads  # noqa: E402
from repro_torch.core.planner import (grad_with_peaks,  # noqa: E402
                                      measure_host_bandwidth,
                                      profile_stages_measured)
from repro_torch.core.schedule import Schedule, simulate  # noqa: E402
from repro_torch.core.solver import solve_min_memory  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dp_fill import ops as dp_ops  # noqa: E402
from repro_torch.kernels.dp_fill import ref as dp_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.offload.executor import execute_offload_schedule  # noqa: E402
from repro_torch.offload.host_buffer import HostBuffer  # noqa: E402
from repro_torch.launch.steps import plan_chain  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.offload.solver import (solve_min_device_memory,  # noqa: E402
                                        solve_optimal_offload)
from repro_torch.plan import resolve_policy  # noqa: E402
from repro_torch.tree import tensors_of  # noqa: E402

pytestmark = pytest.mark.cuda

TC_SHAPE = (64, 128, 256)   # (P, N, Q) of K6's tensor-core kernel


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().float().clamp(
        min=1e-30))) - 7)


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


@pytest.mark.parametrize("d,ns,w", [(1, 1, 4), (3, 5, 17), (9, 2, 501),
                                    (7, 300, 33)])
def test_band_min_offload_kernel_bit_equal(dev, d, ns, w):
    g = torch.Generator(device=dev).manual_seed(d + ns)

    def plane(lo, hi, p_inf=0.0):
        x = torch.rand((d, ns, w), generator=g, device=dev) * (hi - lo) + lo
        x[torch.rand((d, ns, w), generator=g, device=dev) < p_inf] = math.inf
        return x

    ops = (plane(0, 8, 0.3), plane(0, 8, 0.3), plane(-4, 4), plane(-4, 4),
           plane(-4, 4), torch.rand((ns, 1), generator=g, device=dev) * 6)
    before = counters.snapshot().get(dp_ops.NAME_OFFLOAD, 0)
    got = dp_ops.band_min_offload(*ops)
    assert counters.snapshot()[dp_ops.NAME_OFFLOAD] == before + 1
    for a, b in zip(got, dp_ref.band_min_offload(*ops)):
        assert torch.equal(a, b)


def _int_chain(rng, L, host=True, big_wa=False):
    wa = rng.integers(1, 4, L + 1)
    if big_wa:
        wa[L // 2] = 10_000                  # larger than any budget below
    return Chain.make(uf=rng.integers(1, 5, L + 1),
                      ub=rng.integers(1, 5, L + 1), wa=wa,
                      wabar=rng.integers(1, 6, L + 1),
                      of=rng.integers(0, 2, L + 1),
                      ob=rng.integers(0, 2, L + 1),
                      host=HostTransferModel(
                          bandwidth_d2h=float(rng.choice([0.5, 1.0, 4.0])),
                          latency=float(rng.choice([0.0, 0.25])))
                      if host else None)


@pytest.mark.parametrize("L", [1, 4, 11, 40, 64])
@pytest.mark.parametrize("allow_fall", [True, False])
def test_dp_fill_kernels_bit_equal_to_banded(dev, L, allow_fall):
    """K2 and K5b (``cuda_fused``) and K5a (``cuda``) against the numpy
    fills and the plain fused recursions, on chains with and without a host
    tier and one whose activation exceeds the budget."""
    rng = np.random.default_rng(L)
    for host, big in ((True, False), (False, False), (True, True)):
        ch = _int_chain(rng, L, host=host, big_wa=big)
        m = math.ceil(Chain.make(uf=ch.uf, ub=ch.ub, wa=np.minimum(ch.wa, 4),
                                 wabar=ch.wabar).store_all_peak() * 0.6)
        dch = ch.discretize(m, int(m))
        S = int(m)
        want = dp_kernels.fill_tables(dch, S, allow_fall=allow_fall).data
        for impl in ("cuda", "cuda_fused"):
            got = dp_kernels.fill_tables(dch, S, impl=impl,
                                         allow_fall=allow_fall).data
            assert np.array_equal(got, want), impl
        assert np.array_equal(dp_ops.fill_two_tier_fused(
            dch, S, allow_fall=allow_fall, device="cpu").data, want)
        tb, te = dp_kernels.fill_tables_offload(dch, S, allow_fall=allow_fall)
        runs = [dp_kernels.fill_tables_offload(dch, S, impl=impl,
                                               allow_fall=allow_fall)
                for impl in ("cuda", "cuda_fused")]
        runs.append(dp_ops.fill_offload_fused(dch, S, allow_fall=allow_fall,
                                              device="cpu"))
        for gb, ge in runs:
            assert np.array_equal(gb.data, tb.data)
            assert np.array_equal(ge.data, te.data)


def test_fused_kernels_match_plain_on_cuda_tensors(dev):
    rng = np.random.default_rng(7)
    ch = _int_chain(rng, 9)
    m = math.ceil(ch.store_all_peak() * 0.5)
    dch = ch.discretize(m, int(m))
    ops_ = dp_ops.FusedOperands(dch, int(m), True)
    toff, tpre = dp_kernels.offload_vectors(dch, ops_.v)
    tab = ops_.base_table()
    kw = dict(L=ops_.L, W=ops_.W, allow_fall=True)

    def run(device):
        t0 = ops_.initial(tab, device)
        ints = ops_.tensors(device, toff, tpre)
        two = dp_ops.fused_fill_two_tier(t0, *ints[:8], **kw)
        return (two,) + dp_ops.fused_fill_offload(t0, t0, *ints,
                                                  host_on=True, **kw)

    n0 = counters.snapshot().get(dp_ops.NAME_FUSED, 0)
    got = run(dev)
    assert counters.snapshot()[dp_ops.NAME_FUSED] == n0 + 1
    for a, b in zip(got, run(torch.device("cpu"))):
        assert torch.equal(a.cpu(), b)


def test_fused_fills_bit_equal_on_qwen_full_depth_chain(dev):
    """K2 and K5b on the chain users plan: Qwen1.5-4B at its 40 layers, one
    layer a chunk (L = 41, (903, 501) tables), profiled on meta tensors, at
    the two-tier midpoint and the offload budget, host tier on and off."""
    cfg = get_config("qwen1.5-4b", n_chunks=40, use_flash_attention=True)
    ch = plan_chain(StagedLM(cfg), input_specs(
        cfg, ShapeSpec("train", "train", 2048, 4)), 7.75e14)
    hch = ch.with_host(HostTransferModel(bandwidth_d2h=5e10))
    low = solve_min_memory(ch).mem_limit
    S = 500
    for m in ((low + ch.store_all_peak()) / 2,
              (solve_min_device_memory(hch).mem_limit + low) / 2):
        for c in (ch, hch):
            dch = c.discretize(m, S)
            want = dp_kernels.fill_tables(dch, S).data
            assert np.array_equal(dp_kernels.fill_tables(
                dch, S, impl="cuda_fused").data, want)
            tb, te = dp_kernels.fill_tables_offload(dch, S)
            gb, ge = dp_kernels.fill_tables_offload(dch, S, impl="cuda_fused")
            assert np.array_equal(gb.data, tb.data)
            assert np.array_equal(ge.data, te.data)


def _fused_case(dev, L=40):
    """K2's and K5b's operands for a random host-tier chain of L stages."""
    ch = _int_chain(np.random.default_rng(5), L)
    m = math.ceil(ch.store_all_peak() * 0.5)
    dch = ch.discretize(m, int(m))
    ops_ = dp_ops.FusedOperands(dch, int(m), True)
    toff, tpre = dp_kernels.offload_vectors(dch, ops_.v)
    return (ops_.initial(ops_.base_table(), dev),
            ops_.tensors(dev, toff, tpre),
            dict(L=ops_.L, W=ops_.W, allow_fall=True))


def test_fused_fill_is_one_kernel_launch(dev):
    """A whole fill of K2 or K5b runs exactly one device kernel (besides the
    copy of the staged table), seen by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0, ints, kw = _fused_case(dev)
    for run in (lambda: dp_ops.fused_fill_two_tier(t0, *ints[:8], **kw),
                lambda: dp_ops.fused_fill_offload(t0, t0, *ints,
                                                  host_on=True, **kw)):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        assert len(names) == 1 and "fused_fill" in names[0], names


def test_fused_fill_refuses_what_it_cannot_take(dev):
    """A chain longer than K2 and K5b take raises, in the wrapper and in the
    C launcher, and nothing runs in its place."""
    # operands of the right shapes for a chain one stage too long
    L, W = dp_ops.max_length() + 1, 1
    ncells = (L + 1) * (L + 2) // 2
    tl = torch.full((ncells, W), math.inf, device=dev)
    vi = torch.zeros(L + 1, dtype=torch.int32, device=dev)
    vf = torch.zeros(L + 1, device=dev)
    thr = torch.zeros((L, L), dtype=torch.int32, device=dev)
    long_ints = (torch.zeros(L + 2, dtype=torch.int32, device=dev), vi, vi,
                 vf, vf, vf, thr, thr)
    before = counters.snapshot()
    with pytest.raises(ValueError, match=f"up to {L - 1} stages"):
        dp_ops.fused_fill_two_tier(tl, *long_ints, L=L, W=W, allow_fall=True)
    with pytest.raises(ValueError, match=f"up to {L - 1} stages"):
        dp_ops.fused_fill_offload(tl, tl, *long_ints, vf, vf, L=L, W=W,
                                  allow_fall=True, host_on=True)
    assert counters.snapshot() == before
    t0, ints, kw = _fused_case(dev, L=4)
    t = t0.clone()
    fn = dp_ops._FUSED.fn or dp_ops._FUSED.load()
    status = fn(t.data_ptr(), *(x.data_ptr() for x in ints[:8]),
                dp_ops.max_length() + 1, kw["W"], 1,
                torch.cuda.current_stream().cuda_stream)
    assert status != 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(status, dp_ops.NAME_FUSED, dp_ops._FUSED_ERROR)
    torch.cuda.synchronize()
    assert torch.equal(t, t0)


def test_dp_wrappers_reject_bad_operands(dev):
    p = torch.zeros((2, 3, 4), device=dev)
    strided = torch.zeros((2, 3, 8), device=dev)[:, :, ::2]
    toff = torch.zeros((3, 1), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        dp_ops.band_min_two_tier(strided, p)
    with pytest.raises(ValueError, match="contiguous"):
        dp_ops.band_min_offload(p, strided, p, p, p, toff)
    with pytest.raises(TypeError):
        dp_ops.band_min_offload(p, p, p, p.double(), p, toff)
    rng = np.random.default_rng(1)
    ch = _int_chain(rng, 3)
    ops_ = dp_ops.FusedOperands(ch.discretize(12.0, 12), 12, True)
    t0 = ops_.initial(ops_.base_table(), dev)
    ints = ops_.tensors(dev)
    with pytest.raises(TypeError):
        dp_ops.fused_fill_two_tier(t0.double(), *ints, L=3, W=ops_.W,
                                   allow_fall=True)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((t0.shape[0], 2 * ops_.W), device=dev)
        dp_ops.fused_fill_two_tier(wide[:, ::2], *ints, L=3, W=ops_.W,
                                   allow_fall=True)


def _resident_tables(dev, L, mode, S=500, seed=0):
    """Random companion tables of an L-stage chain on ``dev`` as the
    per-band offload fill keeps them, and its vectors: (tables, wa, cum,
    toff); ``mode`` "slice" pads R by the widest shift, "gather" has one
    activation wider than the budget."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ncells = (L + 1) * (L + 2) // 2
    WA = torch.randint(1, 40, (L + 1,), generator=g, device=dev)
    if mode == "gather":
        WA[L // 2] = 10 * S
    wa = torch.clamp(WA, max=S + 1) if mode == "slice" else WA
    wcap = int(wa.max()) if mode == "slice" else 0

    def table(width, lo, hi, p_inf=0.0):
        t = torch.rand((ncells, width), generator=g, device=dev) * (hi - lo)
        t += lo
        t[torch.rand(t.shape, generator=g, device=dev) < p_inf] = math.inf
        return t

    cb = table(S + 2, 0, 8, 0.3)
    cb[:, 0] = math.inf
    tables = (table(S + 1 + wcap, 0, 8, 0.3), table(S + 1, -4, 4),
              table(S + 1, -4, 4), table(S + 1, -4, 4), cb)
    # CUM and the offload times in the tables' range, so that both sides
    # of max(X, toff) win somewhere
    return (tables, wa.to(torch.int32),
            torch.rand(L + 2, generator=g, device=dev) * 2,
            torch.rand(L + 1, generator=g, device=dev) * 10)


@pytest.mark.parametrize("L", [9, 41, 64])
def test_table_band_min_kernels_bit_equal(dev, L):
    """K1 and K5a on companion tables kept on the card (``TableBands``; no
    host tier, C3 by slice and by gather) against their plain versions on
    the same tensors, every band of chains of 9, 41 and 64 stages, d = L
    with one row, W a multiple of 32 and not; one counted launch a band."""
    S = 500
    for mode in ("two-tier", None, "slice", "gather"):
        tables, wa, cum, toff = _resident_tables(dev, L, mode, S, seed=L)
        out = torch.empty(3 * L * (S + 1), device=dev)
        if mode == "two-tier":
            bands = dp_ops.TableBands(tables[0], tables[1:2], out, L=L)
        else:
            bands = dp_ops.TableBands(tables[0], tables[1:4], out, L=L, S=S,
                                      c3=mode, cb=tables[4], wa=wa, cum=cum,
                                      toff=toff)
        for d in range(1, L + 1):
            W = (S + 1, 77, 256)[d % 3]
            before = counters.snapshot().get(bands.name, 0)
            n = bands.launch(d, W)
            assert counters.snapshot()[bands.name] == before + 1
            got, want = out[:n], bands.plain(d, W).reshape(-1)
            assert torch.equal(got, want), (mode, d, W)


def test_cuda_fill_is_one_band_kernel_launch_per_band(dev):
    """A ``cuda`` fill of an L-stage chain runs L device kernels, all of
    them the band-min kernel (the rest are copies), seen by the profiler,
    and counts L launches: two-tier, offload with the host tier (C3 by slice
    and by gather) and without."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(12)
    L = 12
    for host, big in ((False, False), (True, False), (True, True)):
        ch = _int_chain(rng, L, host=host, big_wa=big)
        m = math.ceil(Chain.make(uf=ch.uf, ub=ch.ub, wa=np.minimum(ch.wa, 4),
                                 wabar=ch.wabar).store_all_peak() * 0.6)
        dch, S = ch.discretize(m, int(m)), int(m)
        for name, fill in ((dp_ops.NAME, dp_ops.fill_two_tier),
                           (dp_ops.NAME_OFFLOAD, dp_ops.fill_offload)):
            fill(dch, S, device=dev)
            torch.cuda.synchronize()
            before = counters.snapshot().get(name, 0)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fill(dch, S, device=dev)
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset"))]
            assert len(names) == L and all("band_min" in n for n in names), \
                names
            assert counters.snapshot()[name] == before + L


def test_offload_walker_on_cuda_matches_store_all(dev):
    L = 5
    g = torch.Generator().manual_seed(0)
    params = [{"w": (torch.randn((16, 16), generator=g) * 0.3).to(dev)
               .requires_grad_(), "b": torch.zeros(16, device=dev)
               .requires_grad_()} for _ in range(L)] + [{}]
    stages = [lambda p, a: torch.tanh(a @ p["w"] + p["b"])] * L
    stages.append(lambda p, a: torch.mean(a ** 2))
    x = torch.randn((4, 16), generator=g).to(dev)
    ch = Chain.make(uf=[1.0] * L + [0.0], ub=[2.0] * L + [0.0],
                    wa=[1.0] * (L + 1), wabar=[2.0] * L + [0.0],
                    host=HostTransferModel(bandwidth_d2h=1.0))
    sol = solve_optimal_offload(ch, math.ceil(
        ch.store_all_peak() * 0.35), num_slots=64)
    assert sol.schedule.count("Foff") >= 1
    hb, stats = HostBuffer(), {}
    _, grads, dx = execute_offload_schedule(sol.schedule, stages, params, x,
                                            host_buffer=hb, stats=stats)
    assert hb.bytes_in_use == 0 and hb.peak_bytes > 0
    assert stats["prefetches"] == sol.schedule.count("Prefetch")
    _, want, wdx = reference_grads(stages, params, x)
    for a, b in zip(grads[:L], want[:L]):
        torch.testing.assert_close(a["w"], b["w"], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(a["b"], b["b"], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dx, wdx, rtol=1e-5, atol=1e-7)
    store_all = execute_offload_schedule(Schedule.store_all(L), stages,
                                         params, x)[1]
    for a, b in zip(grads[:L], store_all[:L]):
        torch.testing.assert_close(a["w"], b["w"], rtol=1e-5, atol=1e-7)


def test_host_bandwidth_on_the_card(dev):
    link = measure_host_bandwidth(1 << 24, repeats=5, device=dev)
    assert link.bandwidth_d2h > 0 and link.bandwidth_h2d > 0


class _Transient(torch.autograd.Function):
    """Identity-like stage op that allocates a known temporary in its
    forward (freed before it returns) and in its backward."""

    @staticmethod
    def forward(ctx, a, fwd_bytes, bwd_bytes):
        ctx.bwd_bytes = bwd_bytes
        tmp = torch.empty(fwd_bytes, dtype=torch.uint8, device=a.device)
        out = a.clone()
        del tmp
        return out

    @staticmethod
    def backward(ctx, g):
        tmp = torch.empty(ctx.bwd_bytes, dtype=torch.uint8, device=g.device)
        dx = g.clone()
        del tmp
        return dx, None, None


def test_measured_transients_recover_known_temporaries(dev):
    """``of`` is exactly the forward's temporary; ``ob`` the backward's
    temporary plus the input gradient it allocates (``δ^{l-1}``, which the
    simulator does not count during a backward).  Sizes under 1 MB come
    from the allocator's small pool, which rounds to 512 B: the bytes
    below are multiples of 512, so the counts are exact."""
    fwd_bytes, bwd_bytes = 512 * 600, 512 * 900
    # an input that requires grad: the chain differentiates it
    x = torch.randn(1 << 16, device=dev, requires_grad=True)
    w = torch.ones(1 << 16, device=dev, requires_grad=True)
    stages = [lambda p, a: _Transient.apply(a * p["w"], fwd_bytes,
                                            bwd_bytes),
              lambda p, a: a.sum()]
    chain = profile_stages_measured(stages, [{"w": w}, {}], x)
    nbytes = x.numel() * x.element_size()
    # stage 1's forward also holds the product a·w, an intermediate freed
    # once the op returns its clone
    assert chain.of[0] == fwd_bytes + nbytes
    assert chain.ob[0] >= bwd_bytes
    assert chain.of[1] == 0               # the loss: its output only
    assert list(chain.wa) == [nbytes, nbytes]
    assert np.all(chain.uf > 0) and np.all(chain.ub > 0)
    # without the product: the temporaries alone
    stages[0] = lambda p, a: _Transient.apply(a, fwd_bytes, bwd_bytes)
    chain = profile_stages_measured(stages, [{}, {}], x)
    assert chain.of[0] == fwd_bytes
    assert chain.ob[0] == bwd_bytes + nbytes
    # an input without grad and no parameters: the chain runs no backward
    # there, and the measure none either
    chain = profile_stages_measured(stages, [{}, {}], x.detach())
    assert chain.ob[0] == 0 and chain.ub[0] == 0


def test_grad_with_peaks_subtracts_only_gradients_already_made(dev):
    """The backward's peak lies in ``_Transient``'s backward.  A parameter
    gradient made after it (``x · w`` below the temporary) is not
    subtracted from the activation peak; one made before it (``· w``
    above) is.  All sizes are multiples of 512 B in the small pool."""
    tmp_bytes, n = 512 * 1000, 512 * 64       # temporary > a gradient
    x = torch.randn(n, device=dev, requires_grad=True)
    w = torch.randn(n, device=dev, requires_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    loss = _Transient.apply(x * w, 0, tmp_bytes).sum()
    _, peak, act = grad_with_peaks([loss], [w], params=[w])
    assert act == peak
    torch.cuda.reset_peak_memory_stats(dev)
    loss = (_Transient.apply(x, 0, tmp_bytes) * w).sum()
    grads, peak, act = grad_with_peaks([loss], [w, x], params=[w])
    assert act == peak - n * 4
    assert torch.equal(grads[0], x.detach())


def test_measured_sizes_count_the_allocator_bound(dev):
    """On CUDA the measured chain counts each tensor at the caching
    allocator's bound (``core.planner.allocator_bytes``), as the analytic
    chain does with ``allocator=True``: a 2 MiB activation counts 3 MiB,
    the 4-byte loss 512 B."""
    mib = 1 << 20
    x = torch.randn(mib // 2, device=dev)
    w = torch.ones(mib // 2, device=dev, requires_grad=True)
    stages = [lambda p, a: a * p["w"], lambda p, a: (a * a).sum()]
    chain = profile_stages_measured(stages, [{"w": w}, {}], x)
    assert list(chain.wa) == [3 * mib] * 2
    assert list(chain.wabar) == [3 * mib, 512]


N_TOY = 512 * 64                  # floats: every size a multiple of 512 B


def _toy_stages(fwd_bytes, bwd_bytes):
    """A 3-stage chain whose last stage holds most of the parameters
    (8 · N_TOY of N_TOY · 9 floats); stage 2 allocates known temporaries
    in its forward and backward."""
    return [lambda p, a: a * p["w"],
            lambda p, a: _Transient.apply(a, fwd_bytes, bwd_bytes),
            lambda p, a: (a.sum() * p["w"]).sum()]


def _toy_params(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    return [{"w": torch.randn(N_TOY, generator=g, device=dev)
             .requires_grad_()}, {},
            {"w": torch.randn(8 * N_TOY, generator=g, device=dev)
             .requires_grad_()}]


@pytest.mark.parametrize("fwd_mb,bwd_mb", [(16, 0), (0, 16)])
def test_offload_walker_peak_leaves_out_only_gradients_made(dev, fwd_mb,
                                                            bwd_mb):
    """The walker's activation peak against a hand count.  With the forward
    temporary the peak lies in stage 2's forward, where no gradient exists:
    nothing is subtracted, and the peak is stage 1's output, the temporary
    and stage 2's output.  With the backward temporary it lies in B^2,
    after B^3 made the last stage's gradient (8 · N_TOY floats): exactly
    that is subtracted."""
    stages = _toy_stages(fwd_mb << 20, bwd_mb << 20)
    params = _toy_params(dev)
    x = torch.randn(N_TOY, device=dev)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    stats = {}
    execute_offload_schedule(Schedule.store_all(2), stages, params, x,
                             stats=stats)
    peak, act = stats["peak_bytes"], stats["act_peak_bytes"]
    if fwd_mb:
        assert act == peak
        assert 0 <= peak - start - (8 * N_TOY + (fwd_mb << 20)) <= 4096
    else:
        assert act == peak - 4 * 8 * N_TOY
        assert peak - start >= (bwd_mb << 20) + 4 * 8 * N_TOY


def test_offload_walker_frees_what_the_schedule_frees(dev):
    """On a toy chain whose sizes are multiples of 512 B in the allocator's
    small pool, the walker's activation peak (plus the input ``a^0``,
    allocated before the call) is the simulator's on the measured chain,
    but for the loss value, which the simulator counts as 0 bytes and the
    allocator as one 512-B block.  The peak is B^1, with stage 1's backward
    temporary; a prefetched activation, a consumed input or the loss's
    graph held one op too long would put it one 128 KiB activation over."""
    stages = [lambda p, a: _Transient.apply(a * p["w"], 0, 512 * 1500),
              lambda p, a: a * p["w"], lambda p, a: a * p["w"],
              lambda p, a: (a * p["w"]).sum()]
    g = torch.Generator(device=dev).manual_seed(0)
    params = [{"w": torch.randn(N_TOY, generator=g, device=dev)
               .requires_grad_()} for _ in stages]
    x = torch.randn(N_TOY, device=dev)
    chain = profile_stages_measured(stages, params, x).with_host(
        HostTransferModel(bandwidth_d2h=1e10))
    sched = Schedule(3, [
        ("Fck", 1), ("Foff", 1), ("Fnone", 2), ("Fnone", 3), ("Fall", 4),
        ("B", 4), ("Prefetch", 1), ("Fall", 2), ("Fall", 3), ("B", 3),
        ("B", 2), ("Fall", 1), ("B", 1)])
    want = simulate(chain, sched)
    assert want.valid
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated(dev)
    stats = {}
    execute_offload_schedule(sched, stages, params, x, stats=stats)
    assert stats["act_peak_bytes"] - start + 4 * N_TOY <= want.peak_mem + 512


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_peak_leaves_out_only_gradients_made(dev, grad_accum):
    """``make_train_step``'s ``fwd_bwd_peak`` per microbatch, against the
    same hand count: the peak lies in stage 2's forward, before any
    gradient of the microbatch is made, so nothing is subtracted (the
    earlier fallback took every parameter gradient off), and the running
    float32 sums of the second microbatch are in the memory at its
    start."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    fwd_bytes = 16 << 20
    stages = _toy_stages(fwd_bytes, 0)
    sp = _toy_params(dev)
    params = {"s1": sp[0], "s3": sp[2]}

    class Toy:
        def loss_fn(self, params, batch, tree=None):
            a = batch["tokens"]
            for fn, p in zip(stages, (params["s1"], {}, params["s3"])):
                a = fn(p, a)
            return a

    step = make_train_step(Toy(), AdamWConfig(lr=1e-3), None,
                           grad_accum=grad_accum)
    batch = {"tokens": torch.randn((grad_accum, N_TOY), device=dev)}
    opt_state = adamw_init(tensors_of(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    m = step(params, opt_state, batch, 0)
    assert 0 <= m["fwd_bwd_peak"] - (8 * N_TOY + fwd_bytes) <= 4096
    assert m["grads_peak"] >= m["fwd_bwd_peak"]


def test_run_training_on_cuda_plans_on_the_measured_chain(dev):
    """With no chain given, ``run_training`` on CUDA measures one on its
    weights and first batch and plans on it: transients recorded, no
    ``peak_flops`` needed."""
    from repro_torch.configs import smoke_config
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    cfg = smoke_config("qwen1.5-4b", num_layers=2,
                       layer_kinds=("dense",) * 2, n_chunks=2)
    out = run_training(cfg, TrainLoopConfig(
        steps=1, global_batch=2, seq_len=64, policy="rotor:x0.8",
        solver_impl="cuda"), device=dev, log_fn=lambda *_: None)
    chain = out["chain"]
    assert out["plan"].chain is chain
    assert np.any(chain.of) and np.any(chain.ob)
    assert out["steps"][0]["fwd_bwd_peak_bytes"] > 0


@pytest.mark.parametrize("policy", ["rotor:x0.6", "optimal_offload:x0.4:1.0"])
def test_bound_plan_on_cuda_matches_reference_grads(dev, policy):
    L = 6
    g = torch.Generator().manual_seed(0)
    params = [{"w": (torch.randn((16, 16), generator=g) * 0.3).to(dev)
               .requires_grad_(), "b": torch.zeros(16, device=dev)
               .requires_grad_()} for _ in range(L)] + [{}]
    stages = [lambda p, a: torch.tanh(a @ p["w"] + p["b"])] * L
    stages.append(lambda p, a: torch.mean(a ** 2))
    x = torch.randn((4, 16), generator=g).to(dev)
    ch = Chain.make(uf=[1.0] * L + [0.0], ub=[2.0] * L + [0.0],
                    wa=[1.0] * (L + 1), wabar=[2.0] * L + [0.0])
    plan = resolve_policy(policy, ch, num_slots=64)
    bound = plan.bind(stages)
    assert bound.remat_expressible == policy.startswith("rotor")
    _, want, wdx = reference_grads(stages, params, x)
    for out, grads, dx in (bound.value_and_grad(params, x),
                           plan.execute(stages, params, x)):
        assert out.is_cuda
        for a, b in zip(grads[:L], want[:L]):
            torch.testing.assert_close(a["w"], b["w"], rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(a["b"], b["b"], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(dx, wdx, rtol=1e-5, atol=1e-7)


def _bf16_flash_bound(got, q, k, v):
    """|got − want| against the float32 plain version of the same bf16
    inputs: 2 bf16 ulps of want (the rounding of o, and float32 sums in
    another order) + 2^-8 Σ p |v| / l (each p rounded to bf16 before P·V,
    a relative error of at most 2^-8) + 1e-5."""
    qf, kf, vf = q.float(), k.float(), v.float()
    want = flash_ref.attention(qf, kf, vf)
    lim = (2 * _bf16_ulp(want) + 2.0 ** -8 * flash_ref.attention(qf, kf,
                                                                 vf.abs())
           + 1e-5)
    gap = (got.float() - want).abs()
    assert bool(torch.all(gap <= lim)), float((gap - lim).max())


@pytest.mark.parametrize("B,S,H,K,D", [
    (1, 37, 4, 2, 16), (2, 64, 8, 1, 64), (1, 130, 4, 4, 128),
    (2, 96, 6, 2, 32),
    # head dim 80 and ragged lengths around one tile, group 1 and group 4
    (2, 1, 4, 4, 80), (1, 63, 8, 2, 80), (2, 65, 4, 4, 80),
    (1, 1000, 8, 2, 80), (1, 1, 8, 2, 128), (2, 63, 4, 4, 64),
    (1, 65, 8, 2, 16), (1, 1000, 4, 4, 128),
    # head dim 256 on its 64-key tiles (K = 1: MQA), ragged and at
    # PaliGemma's prefill shape; MusicGen's 24 heads × 64
    (1, 300, 8, 1, 256), (2, 129, 4, 4, 256), (1, 64, 2, 1, 256),
    (8, 2048, 8, 1, 256), (4, 2048, 24, 24, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(dev, B, S, H, K, D, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(S + D)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device=dev).to(dtype)
               for h in (H, K, K))
    before = counters.snapshot().get(flash_ops.NAME, 0)
    got = flash_ops.attention_fwd(q, k, v)
    assert counters.snapshot()[flash_ops.NAME] == before + 1
    torch.testing.assert_close(got, flash_ref.attention(q, k, v), rtol=tol,
                               atol=tol)
    if dtype == torch.bfloat16:
        _bf16_flash_bound(got, q, k, v)


def test_flash_kernel_takes_the_tensor_cores_at_every_head_dim(dev):
    """Each bf16 instantiation of the flash kernel in the built library,
    one per head dim the wrapper takes (256 on its own tiles), runs its
    products as HGMMA (wgmma) instructions, as cuobjdump's SASS shows."""
    flash_ops._FWD.load()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(
        "flash_attn_fwd"))], capture_output=True, text=True,
        check=True).stdout
    bodies = {f.splitlines()[0]: f for f in sass.split("Function :")[1:]
              if "flash_fwd_sm90" in f.splitlines()[0]}
    dims = sorted(int(name.split("ILi")[1].split("E")[0]) for name in bodies)
    assert dims == sorted(flash_ops.HEAD_DIMS)
    for body in bodies.values():
        assert "HGMMA" in body


def test_flash_kernel_reads_strided_layout(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 50, 3, 4, 32), generator=g, device=dev)
    q, k, v = qkv.unbind(2)            # non-contiguous (B, S, H, D) views
    torch.testing.assert_close(flash_ops.attention_fwd(q, k, v),
                               flash_ref.attention(q, k, v), rtol=1e-4,
                               atol=1e-4)


def test_flash_kernel_reads_strided_layout_bf16(dev):
    """bf16 views of one fused tensor, 16-byte aligned: the TMA maps read
    them in place through their strides."""
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 50, 3, 4, 32), generator=g,
                      device=dev).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and k.data_ptr() % 16 == 0
    got = flash_ops.attention_fwd(q, k, v)
    torch.testing.assert_close(got, flash_ref.attention(q, k, v), rtol=2e-2,
                               atol=2e-2)
    _bf16_flash_bound(got, q, k, v)


def test_flash_kernel_rejects_unaligned_bf16(dev):
    buf = torch.zeros(2 * 8 * 2 * 16 + 1, device=dev, dtype=torch.bfloat16)
    shifted = buf[1:].view(2, 8, 2, 16)            # base 2 bytes off
    padded = torch.zeros((2, 8, 2, 20), device=dev,
                         dtype=torch.bfloat16)[..., :16]   # head stride 20
    ok = torch.zeros((2, 8, 2, 16), device=dev, dtype=torch.bfloat16)
    for bad in (shifted, padded):
        with pytest.raises(ValueError, match="TMA"):
            flash_ops.attention_fwd(bad, ok, ok)
        with pytest.raises(ValueError, match="TMA"):
            flash_ops.attention_fwd(ok, ok, bad)


def test_flash_kernel_rejects_other_head_dims(dev):
    q = torch.zeros((1, 8, 2, 48), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.attention_fwd(q, q, q)


@pytest.mark.parametrize("shape", [(7, 2560), (3, 5, 100), (64, 16),
                                   (33, 2048), (130, 2560), (16, 4096),
                                   (9, 1000), (5, 1001)])
def test_rms_norm_kernel_matches_plain(dev, shape):
    g = torch.Generator(device=dev).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=dev)
    s = 1 + 0.1 * torch.randn(shape[-1:], generator=g, device=dev)
    before = counters.snapshot().get(rms_ops.NAME, 0)
    torch.testing.assert_close(rms_ops.rms_norm_fwd(x, s),
                               rms_ref.rms_norm(x, s), rtol=1e-6, atol=0)
    assert counters.snapshot()[rms_ops.NAME] == before + 1
    xb, sb = x.bfloat16(), s.bfloat16()
    got = rms_ops.rms_norm_fwd(xb, sb).float()
    want = rms_ref.rms_norm(xb, sb).float()
    assert bool(torch.all((got - want).abs() <= _bf16_ulp(want)))
    # a float32 scale beside bf16 rows
    got = rms_ops.rms_norm_fwd(xb, s).float()
    want = rms_ref.rms_norm(xb, s).float()
    assert bool(torch.all((got - want).abs() <= _bf16_ulp(want)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_kernel_offset_base(dev, dtype):
    """Rows whose base is not 16-byte aligned take the scalar tail loop."""
    g = torch.Generator(device=dev).manual_seed(4)
    big = torch.randn((12, 1010), generator=g, device=dev).to(dtype)
    x = big[:, 1:1001]
    s = (1 + 0.1 * torch.randn((1000,), generator=g, device=dev)).to(dtype)
    got = rms_ops.rms_norm_fwd(x, s).float()
    want = rms_ref.rms_norm(x, s).float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert bool(torch.all((got - want).abs() <= _bf16_ulp(want)))


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


def _ssd_inputs(dev, B, S, H, P, G, N, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = randn(B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H)) * 0.1
    A = -torch.exp(randn(H) * 0.3)
    Bm, Cm = ((randn(B, S, G, N) * 0.3).to(dtype) for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,S,H,P,G,N,Q", [
    (2, 24, 4, 16, 1, 16, 8), (2, 24, 4, 16, 2, 16, 8),
    (1, 160, 4, 8, 1, 32, 64), (1, 160, 4, 8, 2, 32, 64),   # ragged S
    (2, 512, 4, 64, 1, 128, 256), (1, 600, 4, 64, 2, 128, 256),
    # bf16 takes the tensor-core kernel at (P, Q) = (64, 256), N = 128 or
    # 64: the Mamba path's shape (8 slices of 8 heads), four groups of 4
    # heads, 12 heads in slices of 8 and 4, groups of 10 heads in slices of
    # 8 and 2, and the Zamba2 path's full shape (state 64, 10 slices of 8)
    (4, 2048, 64, 64, 1, 128, 256), (1, 512, 16, 64, 4, 128, 256),
    (1, 512, 12, 64, 1, 128, 256), (2, 768, 20, 64, 2, 128, 256),
    (4, 2048, 80, 64, 1, 64, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(dev, B, S, H, P, G, N, Q, dtype):
    x, dt, A, Bm, Cm = _ssd_inputs(dev, B, S, H, P, G, N, dtype, seed=S + Q)
    xp, dtp, Bp, Cp = ssd_ref.pad_to_chunks(Q, x, dt, Bm, Cm)
    before = counters.snapshot().get(ssd_ops.NAME, 0)
    got = ssd_ops.ssd_chunk_blocks(xp, dtp, A, Bp, Cp, Q)
    assert counters.snapshot()[ssd_ops.NAME] == before + 1
    for a, b in zip(got, ssd_ref.chunk_terms(xp, dtp, A, Bp, Cp, Q)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    (y, st), (wy, wst) = (ssd_ops.ssd_chunked(x, dt, A, Bm, Cm, Q),
                          ssd_ref.ssd_chunked(x, dt, A, Bm, Cm, Q))
    torch.testing.assert_close(st, wst, rtol=2e-4, atol=2e-4)
    assert y.dtype == dtype and y.shape == (B, S, H, P)
    gap = (y.float() - wy.float()).abs()
    lim = (2 * _bf16_ulp(wy) if dtype == torch.bfloat16 else
           2e-4 * wy.abs()) + 2e-4
    assert bool(torch.all(gap <= lim)), float(gap.max())


@pytest.mark.parametrize("dtype,shape,heads,groups,want", [
    (torch.bfloat16, TC_SHAPE, 64, 1, 8),     # Mamba2-1.3B: 8 slices of 8
    (torch.bfloat16, TC_SHAPE, 12, 1, 8),     # slices of 8 and 4
    (torch.bfloat16, TC_SHAPE, 8, 4, 2),      # one slice of each group
    (torch.float32, TC_SHAPE, 64, 1, 0),      # float32: scalar kernel
    (torch.bfloat16, (32, 128, 256), 64, 1, 0),   # another head dim
    (torch.bfloat16, (64, 64, 256), 64, 1, 8),    # state 64: slices of 8
    (torch.bfloat16, (64, 64, 256), 80, 1, 8),    # Zamba2-2.7B: 10 of 8
    (torch.bfloat16, (64, 32, 256), 64, 1, 0),    # another state size
    (torch.bfloat16, (64, 128, 128), 64, 1, 0),   # another chunk
])
def test_ssd_head_slice_picks_the_kernel(dev, dtype, shape, heads, groups,
                                         want):
    """The library's choice of K6 kernel, and the tensor-core kernel's heads
    per block, for a dtype and a shape."""
    P, N, Q = shape
    assert ssd_ops.head_slice(dtype, P, N, Q, heads, groups) == want


def test_ssd_tensor_core_kernel_rejects_unaligned_rows(dev):
    P, N, Q = TC_SHAPE
    x, dt, A, Bm, Cm = _ssd_inputs(dev, 1, Q, 2, P, 1, N, torch.bfloat16)
    wide = torch.zeros((1, Q, 1, N + 4), dtype=torch.bfloat16, device=dev)
    odd = wide[..., 4:]                  # rows 8 bytes past 16-byte marks
    odd.copy_(Bm)
    with pytest.raises(ValueError, match="16 aligned bytes"):
        ssd_ops.ssd_chunk_blocks(x, dt, A, odd, Cm, Q)


def test_ssd_tensor_core_kernel_holds_tensor_core_instructions(dev):
    """Both instantiations of the bf16 kernel in the built library (state
    64 and 128) run their products as HMMA (or HGMMA) instructions, as
    cuobjdump's SASS shows."""
    from repro_torch.kernels import _build

    ssd_ops._FWD.load()
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(
        "ssd_chunk"))], capture_output=True, text=True, check=True).stdout
    bodies = [f for f in sass.split("Function :")[1:]
              if "ssd_chunk_mma" in f.splitlines()[0]]
    # the mangled names carry the template argument: ILi64E and ILi128E
    assert sorted("ILi64E" in f.splitlines()[0] for f in bodies) == [
        False, True], [f.splitlines()[0] for f in bodies]
    for body in bodies:
        assert "HMMA" in body or "HGMMA" in body


@pytest.mark.parametrize("B,S,H,P,G,N,Q,dtype", [
    (2, 128, 4, 32, 2, 64, 64, torch.float32),          # scalar kernel
    (2, 512, 8, *TC_SHAPE[:1], 1, *TC_SHAPE[1:], torch.bfloat16),  # mma
    (2, 512, 10, 64, 1, 64, 256, torch.bfloat16)])      # mma at state 64
def test_ssd_kernel_reads_model_layout(dev, B, S, H, P, G, N, Q, dtype):
    """x, B and C as the mixer hands them over: strided views into one
    (B, S, d_inner + 2·G·N) tensor."""
    g = torch.Generator(device=dev).manual_seed(5)
    xbc = torch.randn((B, S, H * P + 2 * G * N), generator=g,
                      device=dev).to(dtype)
    x, Bm, Cm = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
    x, Bm, Cm = (x.reshape(B, S, H, P), Bm.reshape(B, S, G, N),
                 Cm.reshape(B, S, G, N))
    assert not x.is_contiguous()
    dt = torch.rand((B, S, H), generator=g, device=dev) * 0.1
    A = -torch.rand((H,), generator=g, device=dev) * 4
    assert bool(ssd_ops.head_slice(dtype, P, N, Q, H, G)) == (
        dtype == torch.bfloat16)
    for a, b in zip(ssd_ops.ssd_chunk_blocks(x, dt, A, Bm, Cm, Q),
                    ssd_ref.chunk_terms(x.float(), dt, A, Bm.float(),
                                        Cm.float(), Q)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


def test_ssd_kernel_rejects_bad_operands(dev):
    x, dt, A, Bm, Cm = _ssd_inputs(dev, 1, 16, 2, 128, 1, 16, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_ops.ssd_chunk_blocks(x, dt, A, Bm, Cm, 8)
    x, dt, A, Bm, Cm = _ssd_inputs(dev, 1, 16, 2, 16, 1, 16, torch.float32)
    with pytest.raises(TypeError, match="float32 dt"):
        ssd_ops.ssd_chunk_blocks(x, dt.bfloat16(), A, Bm, Cm, 8)
    with pytest.raises(ValueError, match="chunk"):
        ssd_ops.ssd_chunk_blocks(x, dt, A, Bm, Cm, 5)


def test_ssd_autograd_on_the_card(dev):
    inputs = [t.requires_grad_() for t in _ssd_inputs(dev, 1, 40, 4, 16, 2,
                                                      16, torch.float32)]
    y, st = ssd_ops.ssd_chunked(*inputs, 16)
    got = torch.autograd.grad((y.square().sum() + st.sum()), inputs)
    y, st = ssd_ref.ssd_chunked(*inputs, 16)
    want = torch.autograd.grad((y.square().sum() + st.sum()), inputs)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_ssd_build_raises_without_nvcc(tmp_path, monkeypatch):
    """Needs no card: with no ``nvcc`` on PATH or in CUDA_HOME, building and
    loading the SSD kernel raises; nothing falls back to the plain version."""
    from repro_torch.kernels import _build

    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setenv("CUDA_HOME", str(empty))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_build._LIBS, "ssd_chunk", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("ssd_chunk")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ssd_ops._FWD.load()
    assert "ssd_chunk" not in _build._LIBS


def _smoke_step(cfg, params, batch, tree):
    """Loss, per-leaf gradients and the AdamW step's metrics of one
    ``make_train_step`` call on ``params`` (updated in place)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import StagedLM as _LM
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.tree import tensors_of

    model = _LM(cfg)
    leaves = tensors_of(params)
    loss = model.loss_fn(params, batch, tree=tree)
    grads = torch.autograd.grad(loss, leaves)
    metrics = make_train_step(model, AdamWConfig(lr=1e-3), tree)(
        params, adamw_init(leaves), batch, 0)
    return loss.item(), [g.cpu() for g in grads], metrics


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "moonshot-v1-16b-a3b"])
def test_smoke_step_on_the_card_matches_the_cpu(dev, arch):
    """One rotor-planned train step of the float32 smoke model (flash
    attention, the SSD kernel, per-layer remat) on the card against the
    same step on the CPU, where every wrapper takes its plain version: loss
    rtol 1e-4, gradients and gradient norm rtol 1e-3 / atol 1e-4 (the
    kernels' float32 tolerances are 1e-4 for K3 and 2e-4 for K6); the card
    run launches K3 and K4 (and K6 for Zamba2)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import plan_training
    from repro_torch.tree import tree_map

    cfg = smoke_config(arch, use_flash_attention=True, use_ssd_kernel=True,
                       scan_layer_remat="full", logits_chunk=8)
    model = StagedLM(cfg)
    plan, _ = plan_training(model, input_specs(cfg, ShapeSpec(
        "t", "train", 32, 2)), "rotor:x0.8", peak_flops=1e12)
    cpu = model.init(0, "cpu")
    card = tree_map(lambda t: t.detach().to(dev, copy=True).requires_grad_(),
                    cpu)
    data = SyntheticLMData(cfg, 2, 32, seed=0)
    want = _smoke_step(cfg, cpu, data.device_batch(0, "cpu"), plan.tree)
    counters.reset()
    got = _smoke_step(cfg, card, data.device_batch(0, dev), plan.tree)
    launched = counters.snapshot()
    kernels = [flash_ops.NAME, rms_ops.NAME] + (
        [ssd_ops.NAME] if arch.startswith("zamba") else [])
    assert all(launched.get(k, 0) > 0 for k in kernels), launched
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for a, b in zip(got[1], want[1]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[2]["grad_norm"].item(),
                               want[2]["grad_norm"].item(), rtol=1e-3)


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "starcoder2-7b",
                                  "qwen1.5-110b", "moonshot-v1-16b-a3b",
                                  "zamba2-2.7b"])
def test_published_chains_plan_alike_on_every_fill(dev, arch):
    """``chip_smoke.py`` phase 8 for the newer archs: each published-depth
    chain (batch 4 × 2048, profiled on meta tensors) planned under rotor at
    its midpoint budget and under the offload policy between its floors
    (a 1e10 B/s link) gives the same schedule on K1 (``cuda``) and K2/K5b
    (``cuda_fused``) as on ``banded``; the offload policy on K5a too."""
    from repro_torch.launch.steps import plan_training

    cfg = get_config(arch, use_flash_attention=True)
    model = StagedLM(cfg)
    specs = input_specs(cfg, ShapeSpec("train", "train", 2048, 4))
    chain = plan_chain(model, specs, 7e14)
    low = solve_min_memory(chain).mem_limit
    host = chain.with_host(HostTransferModel(bandwidth_d2h=1e10))
    low3 = solve_min_device_memory(host).mem_limit
    for policy in (f"rotor:{int((low + chain.store_all_peak()) / 2)}",
                   f"optimal_offload:{int((low3 + low) / 2)}:1e10"):
        want, _ = plan_training(model, specs, policy, impl="banded",
                                chain=chain)
        for impl in ("cuda", "cuda_fused"):
            got, _ = plan_training(model, specs, policy, impl=impl,
                                   chain=chain)
            assert got.schedule.ops == want.schedule.ops, (policy, impl)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "moonshot-v1-16b-a3b"])
def test_rotor_on_the_measured_chain_keeps_its_memory_promise(dev, arch):
    """``chip_smoke.py`` phases 11 and 12 at a small size: a float32 model
    of the family (width 256, batch 4 × 512, a vocab of 512, so that the
    activations outweigh the parameters), its chain measured on the card,
    rotor planned at the measured chain's midpoint budget; over two
    training steps the plan's predicted activation peak is at least the
    measured forward and backward's (``fwd_bwd_peak_bytes``)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import measure_chain
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    cfg = smoke_config(arch, d_model=256, d_ff=512, head_dim=64,
                       moe_d_ff=128, use_flash_attention=True,
                       use_ssd_kernel=True, scan_layer_remat="full",
                       logits_chunk=256, vocab_size=512)
    model = StagedLM(cfg)
    params = model.init(0, dev)
    batch = SyntheticLMData(cfg, 4, 512, seed=0).device_batch(0, dev)
    chain = measure_chain(model, params, batch)
    assert np.any(chain.of) and np.any(chain.ob)
    budget = (solve_min_memory(chain).mem_limit + chain.store_all_peak()) / 2
    out = run_training(cfg, TrainLoopConfig(
        steps=2, global_batch=4, seq_len=512, policy=f"rotor:{int(budget)}",
        solver_impl="cuda"), device=dev, params=params, chain=chain,
        log_fn=lambda *_: None)
    pred = out["plan"].peak_device_mem
    for rec in out["steps"]:
        assert pred >= rec["fwd_bwd_peak_bytes"] > 0, (pred, rec)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "moonshot-v1-16b-a3b",
                                  "deepseek-v2-lite-16b", "mamba2-1.3b",
                                  "zamba2-2.7b"])
def test_serving_on_the_card_matches_the_cpu(dev, arch):
    """The float32 smoke model's prefill and 4 decode steps (flash attention
    and the SSD kernel in prefill) on the card against the CPU, where every
    wrapper takes its plain version: logits and every cache tensor within
    rtol 1e-3 / atol 1e-4 (K3's float32 tolerance is 1e-4, K6's 2e-4);
    prefill launches K4, and K3 (GQA) or K6 (SSM)."""
    from repro_torch.configs import smoke_config
    from repro_torch.tree import tree_map

    cfg = smoke_config(arch, use_flash_attention=True, use_ssd_kernel=True,
                       moe_capacity_factor=16.0)
    model = StagedLM(cfg)
    cpu = model.init(0, "cpu")
    card = tree_map(lambda t: t.detach().to(dev, copy=True), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32))
    runs = []
    for params, where in ((cpu, "cpu"), (card, dev)):
        counters.reset()
        logits, cache = model.prefill(params, {"tokens": toks[:, :16].to(
            where)}, max_len=20)
        out = [logits]
        for t in range(16, 20):
            logits, cache = model.decode_step(params, cache,
                                              toks[:, t:t + 1].to(where))
            out.append(logits)
        runs.append((out, cache, counters.snapshot()))
    (want, wcache, _), (got, gcache, launched) = runs
    kernels = [rms_ops.NAME] + (
        [flash_ops.NAME] if cfg.attention_kind == "gqa"
        and "mamba" not in cfg.layer_kinds else []) + (
        [ssd_ops.NAME] if cfg.layer_kinds[0] in ("mamba", "zamba") else [])
    assert all(launched.get(k, 0) > 0 for k in kernels), launched
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)
    for a, b in zip(tensors_of([gcache["layers"], gcache["shared"]]),
                    tensors_of([wcache["layers"], wcache["shared"]])):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)


def test_planned_kv_leaves_the_card_between_uses(dev):
    """``run_serving(plan=)`` on a small float32 model with a ~2-MB block
    per layer: the staged blocks really leave the card between steps
    (``memory_allocated``: the device KV is at most the budget, and below
    the whole cache by the staged bytes), a step holds at most two staged
    blocks beyond the resident ones, the copies move the booked bytes plus
    the last step's write-back, and the tokens equal the whole-cache
    run's."""
    from repro_torch.configs import smoke_config
    from repro_torch.plan.serving import kv_residency_layers, plan_serving
    from repro_torch.runtime.serve_loop import ServeLoopConfig, run_serving

    cfg = smoke_config("qwen1.5-4b", d_model=256, n_heads=4, n_kv_heads=4,
                       head_dim=64, num_layers=6, layer_kinds=("dense",) * 6,
                       n_chunks=6, use_flash_attention=True)
    model = StagedLM(cfg)
    params = model.init(0, dev)
    B, S0, max_len = 4, 200, 256
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    loop = ServeLoopConfig(max_new_tokens=8, max_len=max_len)
    layout = model.cache_layout(B, max_len)
    budget = 0.5 * sum(layout.block_bytes)
    link = measure_host_bandwidth(1 << 24, device=dev)
    plan = plan_serving(cfg, budget, batch=B, prompt_len=S0, max_len=max_len,
                        host=link, impl="cuda_fused")
    staged = kv_residency_layers(plan, budget_bytes=budget)
    staged_bytes = sum(layout.block_bytes[j] for j in staged)
    whole = run_serving(cfg, params, prompts, loop, model=model)
    planned = run_serving(cfg, params, prompts, loop, model=model,
                          plan=plan, kv_budget=budget)
    np.testing.assert_array_equal(planned["generations"],
                                  whole["generations"])
    assert staged and max(planned["device_kv_bytes"]) <= budget
    assert max(planned["device_kv_bytes"]) <= \
        min(whole["device_kv_bytes"]) - staged_bytes
    assert max(planned["step_peak_bytes"]) <= (
        max(whole["step_peak_bytes"]) - staged_bytes
        + 2 * max(layout.block_bytes))
    assert planned["kv_copied_bytes"] == \
        planned["kv_transfer_bytes"] + staged_bytes
    assert planned["kv_wait_s"] >= 0


def test_conv_chain_isolated_ob_matches_in_chain(dev):
    """Each stage's backward transient measured in isolation
    (``profile_stages_measured``'s ``ob``) is within 5 % plus one allocator
    rounding of the same backward inside the chain
    (``chain_backward_transients``), on a small float32 conv chain."""
    from repro_torch.configs import paper_resnet
    from repro_torch.core.planner import chain_backward_transients

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        stages, params, x = paper_resnet.resnet_ish_chain(
            num_blocks=6, base_ch=32, image=96, batch=16, device=dev)
        chain = profile_stages_measured(stages, params, x)
        inchain = chain_backward_transients(stages, params, x)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert len(inchain) == chain.length + 1
    for iso, got in zip(chain.ob, inchain):
        assert abs(iso - got) <= 0.05 * got + (1 << 20) + 512, (
            list(chain.ob), inchain)


def test_traced_walker_on_the_card_spans_every_op(dev):
    """``bind(..., tracer=)`` on the card: one CUDA-event span per schedule
    op of a rotor plan, in order, none negative, none waiting for tracing
    to resolve until the spans are read; gradients equal the untraced
    nested-checkpoint run's (float32, 1e-4)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.obs.trace import Tracer, validate_perfetto

    cfg = smoke_config("qwen1.5-4b", num_layers=4, layer_kinds=("dense",) * 4,
                       n_chunks=4, use_flash_attention=True)
    model = StagedLM(cfg)
    params = model.init(0, dev)
    batch = SyntheticLMData(cfg, 2, 64, seed=0).device_batch(0, dev)
    chain = plan_chain(model, input_specs(cfg, ShapeSpec("t", "train", 64,
                                                         2)), 1e12)
    plan = resolve_policy("rotor:x0.6", chain)
    stages, sp = model.stage_fns(), model.stage_params(params)
    tr = Tracer()
    out, grads, _ = plan.bind(stages, tracer=tr).value_and_grad(sp, batch)
    assert tr._pending                   # nothing resolved while running
    spans = tr.spans
    assert [(s.op, s.arg) for s in spans] == list(plan.schedule.ops)
    assert all(s.duration >= 0 and s.t_start >= 0 for s in spans)
    validate_perfetto(tr.to_perfetto())
    ref_out, ref_grads, _ = plan.bind(stages).value_and_grad(sp, batch)
    torch.testing.assert_close(out, ref_out, rtol=1e-4, atol=1e-4)
    for a, b in zip(tensors_of(grads), tensors_of(ref_grads)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_program_spans_own_the_steps_kernels_on_the_card(dev):
    """Under ``torch.profiler`` on the card, the device time under
    ``step.forward``, ``step.backward`` and ``step.optimizer`` is at least
    97 % of the step's: the backward's ranges are opened on the autograd
    engine's device thread, which launches its kernels; the replays' ranges
    sit inside ``step.backward`` and count as the schedule's replays."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from torch.autograd import DeviceType

    cfg = smoke_config("qwen1.5-4b", num_layers=4, layer_kinds=("dense",) * 4,
                       n_chunks=4, use_flash_attention=True)
    model = StagedLM(cfg)
    params = model.init(0, dev)
    batch = SyntheticLMData(cfg, 2, 64, seed=0).device_batch(0, dev)
    chain = plan_chain(model, input_specs(cfg, ShapeSpec("t", "train", 64,
                                                         2)), 1e12)
    plan = resolve_policy("rotor:x0.6", chain)
    step = make_train_step(model, AdamWConfig(), plan.tree)
    opt = adamw_init(tensors_of(params))
    step(params, opt, batch, 0)
    torch.cuda.synchronize(dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(params, opt, batch, 1)
        torch.cuda.synchronize(dev)
    events = prof.events()
    ranges = {e.name for e in events if e.device_type != DeviceType.CUDA}
    total = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == DeviceType.CUDA and e.name not in ranges)
    under = {e.key: e for e in prof.key_averages()}
    owned = sum(under[k].device_time_total for k in
                ("step.forward", "step.backward", "step.optimizer"))
    assert total > 0 and owned >= 0.97 * total, (owned, total)
    assert under["remat.replay"].device_time_total > 0
    fc = plan.schedule.forward_counts()
    assert under["remat.replay"].count == sum(fc.values()) - len(fc)


def test_traced_offload_copies_run_on_the_side_stream(dev):
    """An offload plan traced on the card: the ``Foff``/``Prefetch`` spans
    are the side stream's copies (their bytes the activation's), every op
    has its span, and the copies' overlap with compute is a share in
    [0, 1]."""
    from repro_torch.obs.trace import Tracer, transfer_overlap

    L = 6
    ch = Chain.make(uf=[1.0] * L + [0.0], ub=[2.0] * L + [0.0],
                    wa=[1.0] * (L + 1), wabar=[2.0] * L + [0.0],
                    host=HostTransferModel(bandwidth_d2h=1.0))
    plan = resolve_policy("optimal_offload:x0.35:1.0", ch, num_slots=64)
    assert plan.uses_offload
    stages = [lambda p, a: torch.tanh(a @ p["w"])] * L + [
        lambda p, a: torch.mean(a ** 2)]
    g = torch.Generator(device=dev).manual_seed(0)
    params = [{"w": (torch.randn(1024, 1024, device=dev, generator=g)
                     * 0.03).requires_grad_()} for _ in range(L)] + [{}]
    x = torch.randn(2048, 1024, device=dev, generator=g)
    tr = Tracer()
    _, grads, _ = plan.execute(stages, params, x, tracer=tr)
    spans = tr.spans
    assert [(s.op, s.arg) for s in spans] == list(plan.schedule.ops)
    copies = [s for s in spans if s.op in ("Foff", "Prefetch")]
    assert copies and all(s.bytes == x.nbytes for s in copies)
    assert all(s.duration > 0 for s in copies)
    total, covered = transfer_overlap(spans)
    assert total > 0 and 0 <= covered <= total + 1e-9
    _, ref, _ = plan.execute(stages, params, x)
    for a, b in zip(tensors_of(grads), tensors_of(ref)):
        torch.testing.assert_close(a, b)


def test_cached_plan_launches_no_fill_kernel(dev):
    """With the solver cache on, the first plan on ``cuda_fused`` is a miss
    that launches K2 once; the same plan again is a hit that launches no
    fill kernel and gives the same schedule."""
    from repro_torch.core import solver_cache
    from repro_torch.plan import PlanRequest, Budget, build_plan

    rng = np.random.default_rng(3)
    n = 10
    ch = Chain.make(uf=rng.integers(1, 5, n).astype(float),
                    ub=rng.integers(1, 5, n).astype(float),
                    wa=rng.integers(1, 4, n).astype(float),
                    wabar=rng.integers(1, 6, n).astype(float))
    req = PlanRequest(strategy="optimal", impl="cuda_fused", num_slots=64,
                      budget=Budget.fraction(0.6))
    solver_cache.configure(directory=None)
    try:
        counters.reset()
        first = build_plan(req, ch)
        assert counters.snapshot() == {dp_ops.NAME_FUSED: 1}
        counters.reset()
        second = build_plan(req, ch)
        assert counters.snapshot() == {}
        assert second.schedule.ops == first.schedule.ops
        assert solver_cache.stats()["hits"] == 1
    finally:
        solver_cache.reset()


def test_measure_chain_times_stages_inside_the_chain_on_card(dev):
    """On the card the in-chain times come from CUDA-event spans of traced
    store-all steps; sizes, ``of`` and ``ob`` are the isolated passes'."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.steps import measure_chain

    cfg = smoke_config("qwen1.5-4b", use_flash_attention=True,
                       scan_layer_remat="full", logits_chunk=8)
    model = StagedLM(cfg)
    params = model.init(0, dev)
    batch = SyntheticLMData(cfg, 2, 64, seed=0).device_batch(0, dev)
    lines = []
    chain = measure_chain(model, params, batch, log_fn=lines.append)
    alone = profile_stages_measured(model.stage_fns(),
                                    model.stage_params(params), batch)
    for name in ("wa", "wabar", "wdelta"):
        np.testing.assert_array_equal(getattr(chain, name),
                                      getattr(alone, name))
    assert np.all(chain.uf > 0) and np.all(chain.ub > 0)
    assert "from store-all steps" in lines[0]


def test_checkpoint_roundtrip_on_card(dev, tmp_path):
    """Parameters (bf16) and moments on the card saved on a thread, restored
    onto the card and onto the CPU bit for bit."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.optim.adamw import adamw_init

    g = torch.Generator(device=dev).manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=g, device=dev)
              .to(torch.bfloat16).requires_grad_()}
    state = {"params": params, "opt": adamw_init(tensors_of(params)),
             "step": 5}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, state, blocking=False)
    mgr.wait()
    _, on_card = mgr.restore(state)
    w = on_card["params"]["w"]
    assert w.is_cuda and w.dtype == torch.bfloat16 and w.requires_grad
    assert torch.equal(w, params["w"])
    _, on_cpu = mgr.restore(state, device="cpu")
    assert torch.equal(on_cpu["params"]["w"], params["w"].cpu())


def _nccl_world1_rank(rank, world):
    """One NCCL rank on the card: the ZeRO-3 gather and reduction of a
    DTensor, the compressed mean, and the expert exchange of
    ``moe_apply_ep`` on a one-member group against the local MoE path."""
    import torch.distributed as dist

    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     ef_init)
    from repro_torch.distributed.sharding import (distribute, gather_one,
                                                  make_mesh, placements_for)
    from repro_torch.models import mlp as mlp_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    mesh = make_mesh((1, 1), "cuda")
    w = torch.randn(8, 6, device=dev).requires_grad_()
    d = distribute(w, mesh, placements_for(("embed", "mlp"), w.shape, mesh))
    g, = torch.autograd.grad((gather_one(d) * 3).sum(), [d])
    assert torch.equal(g.full_tensor(), torch.full_like(w, 3.0))
    grads = [torch.randn(1000, device=dev), torch.randn(7, 9, device=dev)]
    mean, err = compressed_psum_mean(grads, ef_init(grads), dist.group.WORLD,
                                     1)
    for a, m, e in zip(grads, mean, err):
        scale = float(a.abs().max()) / 127
        assert float((m - a).abs().max()) <= scale / 2 + 1e-6
        torch.testing.assert_close(m + e, a, rtol=1e-6, atol=1e-6)
    cfg = get_config("deepseek-v2-lite-16b", num_experts=8, moe_top_k=2,
                     moe_d_ff=64, d_model=128, num_shared_experts=1,
                     dtype=torch.float32, param_dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = mlp_mod.moe_init(gen, cfg, torch.float32, dev)
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=dev)
    mlp_mod.ALL_TO_ALL.update(forward=0, backward=0)
    xe = x.clone().requires_grad_()
    y_ep, aux_ep = mlp_mod.moe_apply_ep(p, cfg, xe, dist.group.WORLD)
    gx_ep, = torch.autograd.grad(y_ep.sum() + aux_ep, [xe])
    xl = x.clone().requires_grad_()
    y, aux = mlp_mod.moe_apply(p, cfg, xl)
    gx, = torch.autograd.grad(y.sum() + aux, [xl])
    torch.testing.assert_close(y_ep, y, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(aux_ep, aux, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(gx_ep, gx, rtol=2e-4, atol=2e-5)
    return dict(mlp_mod.ALL_TO_ALL)


def test_nccl_world1_group_and_expert_exchange(dev):
    """A world-1 NCCL process group on the card (spawned, with a timeout):
    DTensor's gather and Partial reduction, the compressed mean, and the
    expert-parallel path's all-to-alls on CUDA tensors."""
    from repro_torch.distributed.local import run_local

    exchanges, = run_local(_nccl_world1_rank, 1, backend="nccl",
                           timeout=180.0)
    assert exchanges == {"forward": 2, "backward": 2}


def _tp_ops_rank(rank, world):
    """Megatron's f and g and the gather / scatter along a dimension on CUDA
    tensors, two gloo ranks sharing the card at mesh (1, 2)."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp

    dev = torch.device("cuda", 0)
    mesh = shd.make_mesh((1, world), "cuda")
    axis = tp.model_axis(mesh)
    x = torch.full((2, 4), rank + 1.0, device=dev, requires_grad=True)
    y = tp.reduce_from_model(tp.copy_to_model(x, axis), axis)
    gx, = torch.autograd.grad((y * (rank + 1)).sum(), [x])
    g = tp.gather_from_model(x, 1, axis)
    back = tp.scatter_to_model(g * 2, 1, axis)
    gs, = torch.autograd.grad(back.sum(), [x])
    return {"y": y.detach().cpu().tolist(), "gx": gx.cpu().tolist(),
            "g": g.detach().cpu().tolist(), "gs": gs.cpu().tolist(),
            "slice": tp.model_slice(8, mesh)}


def test_tensor_parallel_operators_on_cuda_tensors(dev):
    from repro_torch.distributed.local import run_local

    ranks = run_local(_tp_ops_rank, 2, timeout=180.0)
    for rank, r in enumerate(ranks):
        assert r["y"] == [[3.0] * 4] * 2              # g: summed
        assert r["gx"] == [[3.0] * 4] * 2             # f: 1 + 2 summed
        assert r["g"] == [[1.0] * 4 + [2.0] * 4] * 2  # gathered in rank order
        # scatter's backward gathers the members' gradients, gather's
        # backward keeps this rank's slice of them
        assert r["gs"] == [[2.0] * 4] * 2
        assert r["slice"] == (4 * rank, 4 * rank + 4)
