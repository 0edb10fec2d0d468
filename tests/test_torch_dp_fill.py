"""The port's DP fill against the JAX package: the plain PyTorch band
minimum against the Pallas kernel (interpret mode) and its jnp oracle, the
port's banded and plain fills against ``repro.core.dp_kernels``, the fused
drivers' plain path (what K2 and K5b compute on the card) against the JAX
banded fills on chains of up to 48 stages and on the Qwen1.5-4B chain at
its 40 layers, with the per-band Pallas fill in interpret mode as a second
witness, and the solver's schedules — all **bit-equal**: on f32-exact chains
(integer stage costs and dyadic transfer times, so every DP quantity is
exact in float32 and min does not round), and on the analytic Qwen chain
because both sides do the same float32 adds in the same order."""

import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import dp_kernels as jdp  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core.chain import Chain as JChain  # noqa: E402
from repro.core.chain import HostTransferModel as JHost  # noqa: E402
from repro.core.schedule import Schedule, simulate  # noqa: E402
from repro.kernels.dp_fill import kernel as jkernel  # noqa: E402
from repro.kernels.dp_fill import ops as jops  # noqa: E402
from repro.kernels.dp_fill import ref as jref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core import dp_kernels as pdp  # noqa: E402
from repro_torch.core import solver as psolver  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.core.schedule import simulate as psimulate  # noqa: E402
from repro_torch import counters  # noqa: E402
from repro_torch.kernels.dp_fill import ops as pops  # noqa: E402
from repro_torch.kernels.dp_fill import ref as pref  # noqa: E402
from repro_torch.launch.steps import plan_chain  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.offload.solver import solve_min_device_memory  # noqa: E402

from helpers import random_chain  # noqa: E402


def _port_chain(ch) -> PChain:
    host = None if ch.host is None else PHost(
        bandwidth_d2h=ch.host.bandwidth_d2h,
        bandwidth_h2d=ch.host.bandwidth_h2d, latency=ch.host.latency)
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob, host=host)


def _jax_chain(ch) -> JChain:
    host = None if ch.host is None else JHost(
        bandwidth_d2h=ch.host.bandwidth_d2h,
        bandwidth_h2d=ch.host.bandwidth_h2d, latency=ch.host.latency)
    return JChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob, host=host)


def _budgets(ch, fracs):
    peak = simulate(ch, Schedule.store_all(ch.length)).peak_mem
    return [float(math.ceil(peak * f)) for f in fracs]


@pytest.mark.parametrize("d,ns,w", [(1, 1, 4), (3, 5, 17), (7, 300, 33)])
def test_plain_band_min_bit_equal_to_pallas(d, ns, w):
    rng = np.random.default_rng(d * 100 + ns)
    r = rng.uniform(0, 8, (d, ns, w)).astype(np.float32)
    lm = rng.uniform(-4, 4, (d, ns, w)).astype(np.float32)
    r[rng.uniform(size=r.shape) < 0.3] = np.inf   # out-of-budget sentinels
    got = pops.band_min_two_tier(torch.from_numpy(r),
                                 torch.from_numpy(lm)).numpy()
    assert np.array_equal(got, np.asarray(jref.band_min_two_tier(r, lm)))
    assert np.array_equal(
        got, np.asarray(jkernel.band_min_two_tier(r, lm, interpret=True)))


def test_band_min_wrapper_rejects_bad_stacks():
    r = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        pops.band_min_two_tier(r, torch.zeros(2, 3, 5))
    with pytest.raises(TypeError):
        pops.band_min_two_tier(r.double(), r.double())


@pytest.mark.parametrize("name", [pops.NAME, pops.NAME_OFFLOAD])
def test_band_min_wrappers_run_plain_off_the_card(name):
    """On CPU tensors K1's and K5a's wrappers return their plain versions'
    results and count no launch."""
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.uniform(0, 9, (3, 4, 5)).astype(
        np.float32)) for _ in range(5)]
    toff = torch.from_numpy(rng.uniform(0, 9, (4, 1)).astype(np.float32))
    before = counters.snapshot()
    if name == pops.NAME:
        got = (pops.band_min_two_tier(*planes[:2]),)
        want = (pref.band_min_two_tier(*planes[:2]),)
    else:
        got = pops.band_min_offload(*planes, toff)
        want = pref.band_min_offload(*planes, toff)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert counters.snapshot() == before


@pytest.mark.parametrize("bad", ["table dtype", "vector dtype", "table shape",
                                 "short vectors"])
def test_fused_fill_wrappers_reject_bad_operands(bad):
    """K2's and K5b's wrappers check their operands before choosing a
    device: every bad operand raises, on the CPU too."""
    ch = _port_chain(random_chain(np.random.default_rng(2), max_len=4))
    m = _budgets(ch, (0.7,))[0]
    ops_ = pops.FusedOperands(ch.discretize(m, int(m)), int(m), True)
    t0 = ops_.initial(ops_.base_table(), torch.device("cpu"))
    ints = list(ops_.tensors(torch.device("cpu"), np.zeros(ops_.L + 1,
                                                           np.float32),
                             np.zeros(ops_.L + 1, np.float32)))
    L, W, err = ops_.L, ops_.W, ValueError
    if bad == "table dtype":
        t0, err = t0.double(), TypeError
    elif bad == "vector dtype":
        ints[0], err = ints[0].long(), TypeError
    elif bad == "table shape":
        t0 = t0[:, :-1]
    else:
        L += 1
    with pytest.raises(err):
        pops.fused_fill_two_tier(t0, *ints[:8], L=L, W=W, allow_fall=True)
    with pytest.raises(err):
        pops.fused_fill_offload(t0, t0, *ints, L=L, W=W, allow_fall=True,
                                host_on=True)


def _long_chain(case: int):
    """(JAX chain, budget): an integer chain of 13 to 48 stages with a
    dyadic host link; in cases 1 and 3 one activation is wider than the
    budget (the C3 plane then gathers), the budget being sized on the chain
    with that activation capped."""
    L = (13, 24, 37, 48)[case]
    rng = np.random.default_rng(200 + case)
    n = L + 1
    wa = rng.integers(1, 4, n).astype(float)
    capped = JChain.make(uf=np.ones(n), ub=np.ones(n), wa=wa,
                         wabar=rng.integers(1, 6, n).astype(float))
    m = _budgets(capped, (0.6,))[0]
    if case % 2:
        wa = wa.copy()
        wa[L // 2] = 10 * m
    ch = JChain.make(uf=rng.integers(1, 5, n).astype(float),
                     ub=rng.integers(1, 5, n).astype(float), wa=wa,
                     wabar=capped.wabar,
                     of=rng.integers(0, 2, n).astype(float),
                     ob=rng.integers(0, 2, n).astype(float),
                     host=JHost(bandwidth_d2h=float(rng.choice([0.5, 1.0,
                                                                4.0])),
                                latency=float(rng.choice([0.0, 0.25]))))
    return ch, m


def _fused_fills_match(pdch, want_two, want_off, S, allow_fall=True):
    got = pops.fill_two_tier_fused(pdch, S, allow_fall=allow_fall,
                                   device="cpu")
    assert np.array_equal(got.data, want_two.data)
    gb, ge = pops.fill_offload_fused(pdch, S, allow_fall=allow_fall,
                                     device="cpu")
    assert np.array_equal(gb.data, want_off[0].data)
    assert np.array_equal(ge.data, want_off[1].data)


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("allow_fall", [True, False])
def test_fused_fills_bit_equal_to_jax_on_long_chains(case, allow_fall):
    """The fused drivers' plain path (K2's and K5b's arithmetic) against the
    JAX package's banded fills, host tier on and off."""
    ch, m = _long_chain(case)
    S = int(m)
    for jch in (ch, ch.with_host(None)):
        jd = jch.discretize(m, S)
        _fused_fills_match(_port_chain(jch).discretize(m, S),
                           jdp.fill_two_tier(jd, S, allow_fall=allow_fall),
                           jdp.fill_offload(jd, S, allow_fall=allow_fall), S,
                           allow_fall)


@pytest.mark.parametrize("case", [0, 1])
def test_fused_fills_bit_equal_to_jax_pallas_band_fill(case):
    """The second witness: JAX's per-band Pallas fill in interpret mode (its
    fused fill does not run under the installed jax) gives the tables the
    port's fused drivers give."""
    ch, m = _long_chain(case)
    S = int(m)
    jd = ch.discretize(m, S)
    jops.set_interpret(True)
    try:
        want_two = jops.fill_two_tier(jd, S)
        want_off = jops.fill_offload(jd, S)
    finally:
        jops.set_interpret(None)
    assert np.array_equal(want_two.data, jdp.fill_two_tier(jd, S).data)
    _fused_fills_match(_port_chain(ch).discretize(m, S), want_two, want_off,
                       S)


def test_fused_fills_bit_equal_to_jax_on_qwen_full_depth_chain():
    """Qwen1.5-4B at its published 40 layers, one layer a chunk (L = 41),
    profiled analytically on meta tensors (batch 4 × 2048) with a 50 GB/s
    host link, at S = 500 and two budgets: the two-tier midpoint and the
    midpoint between the three- and two-tier floors."""
    cfg = get_config("qwen1.5-4b", n_chunks=40, use_flash_attention=True)
    pch = plan_chain(StagedLM(cfg), input_specs(
        cfg, ShapeSpec("train", "train", 2048, 4)), 7.75e14,
        host=PHost(bandwidth_d2h=5e10))
    assert pch.length == 41
    low = psolver.solve_min_memory(pch).mem_limit
    budgets = ((low + pch.store_all_peak()) / 2,
               (solve_min_device_memory(pch).mem_limit + low) / 2)
    S = 500
    for m in budgets:
        jd = _jax_chain(pch).discretize(m, S)
        want_off = jdp.fill_offload(jd, S)
        pd = pch.discretize(m, S)
        assert pops.FusedOperands(pd, S, True).W == 501
        _fused_fills_match(pd, jdp.fill_two_tier(jd, S), want_off, S)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("allow_fall", [True, False])
def test_fill_tables_bit_equal_to_jax(seed, allow_fall):
    rng = np.random.default_rng(seed)
    ch = random_chain(rng, max_len=6)
    pch = _port_chain(ch)
    for m in _budgets(ch, (0.4, 0.7, 1.0)):
        S = int(m)
        want = jdp.fill_two_tier(ch.discretize(m, S), S,
                                 allow_fall=allow_fall).data
        for impl in ("banded", "plain"):
            got = pdp.fill_tables(pch.discretize(m, S), S, impl=impl,
                                  allow_fall=allow_fall).data
            assert np.array_equal(got, want), (impl, m)


def test_unknown_fill_impl_raises():
    ch = _port_chain(random_chain(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="unknown DP impl"):
        psolver.solve_optimal(ch, 10.0, impl="pallas")


@pytest.mark.parametrize("seed", range(4))
def test_solutions_match_jax(seed):
    rng = np.random.default_rng(seed)
    ch = random_chain(rng, max_len=6)
    pch = _port_chain(ch)
    for m in _budgets(ch, (0.4, 0.7, 1.0)):
        S = int(m)
        want = jsolver.solve_optimal(ch, m, num_slots=S, cache=False)
        for impl in ("banded", "plain"):
            got = psolver.solve_optimal(pch, m, num_slots=S, impl=impl)
            assert got.feasible == want.feasible
            if want.feasible:
                assert got.expected_time == want.expected_time
                assert got.schedule.ops == want.schedule.ops
                assert psimulate(pch, got.schedule, m + 1e-6).valid
    want = jsolver.solve_min_memory(ch, cache=False)
    got = psolver.solve_min_memory(pch, impl="plain")
    assert got.mem_limit == want.mem_limit
    assert got.schedule.ops == want.schedule.ops
