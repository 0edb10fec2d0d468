"""The port's DP fill against the JAX package: the plain PyTorch band
minimum against the Pallas kernel (interpret mode) and its jnp oracle, the
port's banded and plain fills against ``repro.core.dp_kernels``, and the
solver's schedules — all **bit-equal** on f32-exact chains (integer stage
costs: every DP quantity is exact in float32, and min does not round)."""

import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import dp_kernels as jdp  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core.schedule import Schedule, simulate  # noqa: E402
from repro.kernels.dp_fill import kernel as jkernel  # noqa: E402
from repro.kernels.dp_fill import ref as jref  # noqa: E402
from repro_torch.core import dp_kernels as pdp  # noqa: E402
from repro_torch.core import solver as psolver  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.schedule import simulate as psimulate  # noqa: E402
from repro_torch import counters  # noqa: E402
from repro_torch.kernels.dp_fill import ops as pops  # noqa: E402
from repro_torch.kernels.dp_fill import ref as pref  # noqa: E402

from helpers import random_chain  # noqa: E402


def _port_chain(ch) -> PChain:
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob)


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
