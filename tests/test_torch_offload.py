"""The port's three-tier (host-offload) path against the JAX package on the
same seeded numpy inputs: the simulator, the plain offload band minimum
(K5a) against the Pallas kernel in interpret mode, every offload and fused
fill against the numpy banded fills, the offload solvers' schedules, the
eager walker's gradients, and a 3-step training run.

DP quantities are compared **bit-equal** (f32-exact chains: integer stage
costs and dyadic transfer times, so every value is exact in float32 and
min/max do not round).  Gradients of the walker are held to JAX's at rtol
1e-4 (another library's float32 kernels) and to the port's own plain
autograd at rtol 1e-5; training losses to JAX's at rtol 1e-4."""

import gc
import math
import weakref

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.core import dp_kernels as jdp  # noqa: E402
from repro.core.chain import Chain, HostTransferModel  # noqa: E402
from repro.core.schedule import Schedule, simulate  # noqa: E402
from repro.kernels.dp_fill import kernel as jkernel  # noqa: E402
from repro.launch.mesh import PEAK_FLOPS_BF16  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro.offload import solver as jsolver  # noqa: E402
from repro.offload.executor import execute_offload_schedule as jexecute  # noqa: E402
from repro.runtime.train_loop import TrainLoopConfig as JLoop  # noqa: E402
from repro.runtime.train_loop import run_training as jrun  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.core import dp_kernels as pdp  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.core.executor import execute_schedule, reference_grads  # noqa: E402
from repro_torch.core.schedule import Schedule as PSchedule  # noqa: E402
from repro_torch.core.schedule import simulate as psimulate  # noqa: E402
from repro_torch.kernels.dp_fill import ops as pops  # noqa: E402
from repro_torch.offload import solver as psolver  # noqa: E402
from repro_torch.offload.executor import execute_offload_schedule  # noqa: E402
from repro_torch.offload.host_buffer import HostBuffer  # noqa: E402
from repro_torch.plan import resolve_policy  # noqa: E402
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training  # noqa: E402

from helpers import make_mlp_chain, random_chain  # noqa: E402


def _port_chain(ch) -> PChain:
    host = None
    if ch.host is not None:
        host = PHost(bandwidth_d2h=ch.host.bandwidth_d2h,
                     bandwidth_h2d=ch.host.bandwidth_h2d,
                     latency=ch.host.latency)
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob, host=host)


def _dyadic_host(rng) -> HostTransferModel:
    return HostTransferModel(bandwidth_d2h=float(rng.choice([0.5, 1.0, 4.0])),
                             latency=float(rng.choice([0.0, 0.25])))


def _budgets(ch, fracs):
    peak = simulate(ch, Schedule.store_all(ch.length)).peak_mem
    return [float(math.ceil(peak * f)) for f in fracs]


def _same_sim(a, b):
    assert a.valid == b.valid
    assert (a.time, a.peak_mem, a.host_peak_mem, a.transfer_stall) == \
        (b.time, b.peak_mem, b.host_peak_mem, b.transfer_stall)


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------

def test_simulate_hand_schedule_matches_jax():
    ch = Chain.homogeneous(3).with_host(HostTransferModel(bandwidth_d2h=1.0))
    ops = [("Foff", 0), ("Fnone", 1), ("Fall", 2), ("Fall", 3), ("Fall", 4),
           ("B", 4), ("B", 3), ("B", 2), ("Prefetch", 0), ("Fall", 1),
           ("B", 1)]
    pch = _port_chain(ch)
    want = simulate(ch, Schedule(3, ops))
    got = psimulate(pch, PSchedule(3, ops))
    assert got.valid
    _same_sim(got, want)
    assert got.host_peak_mem == float(ch.wa[0])
    # without a host tier, and with malformed host ops, both refuse
    assert not psimulate(_port_chain(Chain.homogeneous(3)),
                         PSchedule(3, ops)).valid
    for bad in ([("Prefetch", 0)], [("Foff", 0), ("Foff", 0)], [("Foff", 1)]):
        assert not psimulate(pch, PSchedule(3, bad)).valid
    assert not psimulate(pch, PSchedule(3, ops), host_mem_limit=0.5).valid


@pytest.mark.parametrize("seed", range(3))
def test_simulate_solver_schedules_match_jax(seed):
    rng = np.random.default_rng(40 + seed)
    ch = random_chain(rng, max_len=5).with_host(_dyadic_host(rng))
    pch = _port_chain(ch)
    for m in _budgets(ch, (0.4, 0.7)):
        sol = jsolver.solve_optimal_offload(ch, m, num_slots=int(m),
                                            cache=False)
        if sol.feasible:
            _same_sim(psimulate(pch, PSchedule(ch.length, sol.schedule.ops),
                                m + 1e-6),
                      simulate(ch, sol.schedule, m + 1e-6))


# ---------------------------------------------------------------------------
# K5a and the fills
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,ns,w", [(1, 1, 4), (3, 5, 17), (6, 40, 33)])
def test_plain_band_min_offload_bit_equal_to_pallas(d, ns, w):
    rng = np.random.default_rng(d * 100 + ns)

    def plane(lo, hi):
        return rng.uniform(lo, hi, (d, ns, w)).astype(np.float32)

    r, r3 = plane(0, 8), plane(0, 8)
    lmb, lme, lmb3 = plane(-4, 4), plane(-4, 4), plane(-4, 4)
    for a in (r, r3):
        a[rng.uniform(size=a.shape) < 0.3] = np.inf
    toff = rng.uniform(0, 6, (ns, 1)).astype(np.float32)
    toff[rng.uniform(size=toff.shape) < 0.2] = np.inf
    got = pops.band_min_offload(*(torch.from_numpy(a) for a in
                                  (r, r3, lmb, lme, lmb3, toff)))
    want = jkernel.band_min_offload(r, r3, lmb, lme, lmb3, toff,
                                    interpret=True)
    for g, wnt in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(wnt))


def test_band_min_offload_wrapper_rejects_bad_operands():
    p = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        pops.band_min_offload(p, p, p, p, torch.zeros(2, 3, 5),
                              torch.zeros(3, 1))
    with pytest.raises(ValueError):
        pops.band_min_offload(p, p, p, p, p, torch.zeros(3))
    with pytest.raises(TypeError):
        pops.band_min_offload(p, p, p, p, p.double(), torch.zeros(3, 1))


def _offload_chains():
    """(chain, budgets): hosted random chains, one without a host, and the
    chain whose middle activation exceeds the whole budget (the C3 plane
    then gathers instead of slicing: ``wa_uncapped`` false)."""
    out = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        ch = random_chain(rng, max_len=5)
        if seed < 2:
            ch = ch.with_host(_dyadic_host(rng))
        out.append((ch, _budgets(ch, (0.4, 0.8))))
    out.append((Chain.make(uf=[1.0, 1.0, 0.0], ub=[1.0, 1.0, 0.0],
                           wa=[1.0, 40.0, 1.0], wabar=[2.0, 2.0, 0.0],
                           host=HostTransferModel(bandwidth_d2h=1.0)), [8.0]))
    return out


OFFLOAD_CHAINS = _offload_chains()


@pytest.mark.parametrize("case", range(len(OFFLOAD_CHAINS)))
@pytest.mark.parametrize("allow_fall", [True, False])
def test_offload_fills_bit_equal_to_jax(case, allow_fall):
    ch, budgets = OFFLOAD_CHAINS[case]
    pch = _port_chain(ch)
    for m in budgets:
        S = int(m)
        dch = pch.discretize(m, S)
        tb, te = jdp.fill_offload(ch.discretize(m, S), S,
                                  allow_fall=allow_fall)
        assert pdp._FillCtx(pdp._views(dch), ch.length, S).wa_uncapped == \
            (case < 3)
        fills = {impl: pdp.fill_tables_offload(dch, S, impl=impl,
                                               allow_fall=allow_fall)
                 for impl in ("banded", "plain")}
        fills["fused"] = pops.fill_offload_fused(dch, S, allow_fall=allow_fall,
                                                 device="cpu")
        for name, (gb, ge) in fills.items():
            assert np.array_equal(gb.data, tb.data), (name, m)
            assert np.array_equal(ge.data, te.data), (name, m)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("allow_fall", [True, False])
def test_fused_two_tier_bit_equal_to_jax(seed, allow_fall):
    rng = np.random.default_rng(10 + seed)
    ch = random_chain(rng, max_len=7)
    pch = _port_chain(ch)
    for m in _budgets(ch, (0.4, 0.7, 1.0)):
        S = int(m)
        want = jdp.fill_two_tier(ch.discretize(m, S), S,
                                 allow_fall=allow_fall).data
        got = pops.fill_two_tier_fused(pch.discretize(m, S), S,
                                       allow_fall=allow_fall, device="cpu")
        assert np.array_equal(got.data, want), m


def test_fused_fills_single_stage_chain():
    ch = Chain.make(uf=[2.0, 1.0], ub=[3.0, 1.0], wa=[1.0, 2.0],
                    wabar=[2.0, 1.0], host=HostTransferModel(bandwidth_d2h=1.0))
    dch = _port_chain(ch).discretize(8.0, 8)
    assert np.array_equal(pops.fill_two_tier_fused(dch, 8, device="cpu").data,
                          jdp.fill_two_tier(ch.discretize(8.0, 8), 8).data)
    gb, ge = pops.fill_offload_fused(dch, 8, device="cpu")
    tb, te = jdp.fill_offload(ch.discretize(8.0, 8), 8)
    assert np.array_equal(gb.data, tb.data) and np.array_equal(ge.data,
                                                               te.data)


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_offload_solutions_match_jax(seed):
    rng = np.random.default_rng(20 + seed)
    ch = random_chain(rng, max_len=5).with_host(_dyadic_host(rng))
    pch = _port_chain(ch)
    for m in _budgets(ch, (0.3, 0.6)):
        S = int(m)
        want = jsolver.solve_optimal_offload(ch, m, num_slots=S, cache=False)
        for impl in ("banded", "plain"):
            got = psolver.solve_optimal_offload(pch, m, num_slots=S,
                                                impl=impl)
            assert got.feasible == want.feasible
            if want.feasible:
                assert got.schedule.ops == want.schedule.ops
                assert got.expected_time == want.expected_time
                assert psolver.tree_to_schedule(
                    got.tree, ch.length).ops == got.schedule.ops
    want = jsolver.solve_min_device_memory(ch, num_slots=64, cache=False)
    got = psolver.solve_min_device_memory(pch, num_slots=64)
    assert got.mem_limit == want.mem_limit
    assert got.schedule.ops == want.schedule.ops
    assert got.expected_time == want.expected_time
    assert psolver.tree_uses_offload(got.tree) == \
        jsolver.tree_uses_offload(want.tree)


def test_offload_policy_grammar():
    ch = random_chain(np.random.default_rng(3), max_len=4)
    pch = _port_chain(ch)
    for bad in ("optimal_offload", "optimal_offload:x0.5",
                "optimal_offload:x0.5:"):
        with pytest.raises(ValueError, match="optimal_offload:BUDGET:BW"):
            resolve_policy(bad, pch)
    # zero bandwidth: the two-tier plan of the same budget
    off = resolve_policy("optimal_offload:x0.7:0", pch)
    rot = resolve_policy("rotor:x0.7", pch)
    assert off.schedule.ops == rot.schedule.ops and not off.uses_offload
    fast = resolve_policy("optimal_offload:x0.7:1e12", pch)
    assert fast.chain.host.bandwidth_d2h == 1e12
    assert fast.expected_time <= rot.expected_time
    assert "host peak" in fast.summary()


def test_host_buffer_accounting():
    hb = HostBuffer(capacity_bytes=100)
    hb.put("a", None, nbytes=40)
    hb.put("b", None, nbytes=50)
    with pytest.raises(MemoryError, match="overflows"):
        hb.put("c", None, nbytes=20)
    assert (hb.bytes_in_use, hb.peak_bytes, len(hb)) == (90, 90, 2)
    hb.pop("a")
    hb.put("b", None, nbytes=60)          # replacing frees the old bytes
    assert (hb.bytes_in_use, hb.peak_bytes, "b" in hb) == (60, 90, True)
    with pytest.raises(KeyError):
        hb.pop("a")


# ---------------------------------------------------------------------------
# eager walker and training
# ---------------------------------------------------------------------------

def _torch_mlp(params, x):
    stages = [lambda p, a: torch.tanh(a @ p["w"] + p["b"])] * (len(params) - 1)
    stages.append(lambda p, a: torch.mean(a ** 2))
    pparams = [{k: torch.from_numpy(np.array(v)).requires_grad_()
                for k, v in p.items()} for p in params]
    return stages, pparams, torch.from_numpy(np.array(x))


def test_walker_grads_match_jax_and_autograd():
    L = 6
    stages, params, x = make_mlp_chain(L)
    ch = Chain.make(uf=[1.0] * L + [0.0], ub=[2.0] * L + [0.0],
                    wa=[1.0] * (L + 1), wabar=[2.0] * L + [0.0],
                    host=HostTransferModel(bandwidth_d2h=1.0))
    peak = simulate(ch, Schedule.store_all(L)).peak_mem
    sol = jsolver.solve_optimal_offload(ch, math.ceil(peak * 0.35),
                                        num_slots=64, cache=False)
    assert sol.schedule.count("Foff") >= 1
    _, jgrads, jdx = jexecute(sol.schedule, stages, params, x)
    pstages, pparams, px = _torch_mlp(params, x)
    sched = PSchedule(L, sol.schedule.ops)
    hb = HostBuffer()
    out, grads, dx, live = execute_offload_schedule(
        sched, pstages, pparams, px, host_buffer=hb, track_live_bytes=True)
    assert hb.bytes_in_use == 0 and hb.peak_bytes > 0 and live > 0
    _, rgrads, rdx = reference_grads(pstages, pparams, px)
    for l in range(L):
        for k in ("w", "b"):
            np.testing.assert_allclose(grads[l][k].numpy(),
                                       np.asarray(jgrads[l][k]), rtol=1e-4,
                                       atol=1e-7)
            np.testing.assert_allclose(grads[l][k].numpy(),
                                       rgrads[l][k].numpy(), rtol=1e-5,
                                       atol=1e-8)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(dx.numpy(), rdx.numpy(), rtol=1e-5, atol=1e-8)
    # the two-tier entry point runs the same walker
    _, g2, _ = execute_schedule(sched, pstages, pparams, px)
    assert torch.equal(g2[0]["w"], grads[0]["w"])


def test_walker_keeps_no_stage_input_after_its_backward():
    """The walker returns the loss as a value: held by the caller, it keeps
    no graph, so no stage's input leaf outlives that stage's backward (the
    loss's graph would keep the head's input alive through every later
    ``B``: one boundary activation over the plan's predicted peak)."""
    L = 6
    stages, params, x = make_mlp_chain(L)
    pstages, pparams, px = _torch_mlp(params, x)
    seen = []

    def watched(fn):
        def stage(p, a):
            seen.append(weakref.ref(a))
            return fn(p, a)
        return stage

    out, grads, dx = execute_offload_schedule(
        PSchedule.store_all(L), [watched(f) for f in pstages], pparams, px)
    gc.collect()
    assert out.grad_fn is None and len(seen) == L + 1
    assert all(r() is None for r in seen)


def test_offload_training_matches_jax():
    kw = dict(num_layers=8, layer_kinds=("dense",) * 8, n_chunks=8,
              scan_layer_remat="full")
    jcfg, pcfg = jsmoke("qwen1.5-4b", **kw), psmoke("qwen1.5-4b", **kw)
    # PyTorch's saved tensors are not XLA's residuals, so the two chains
    # differ: at x0.6 the port's plan needs no offload, at x0.5 JAX's is
    # infeasible.  Each package runs a budget where its plan offloads; any
    # valid schedule computes the same gradients.
    policy = "optimal_offload:x0.5:1e15"
    jparams = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0))
    jlogs = []
    want = jrun(jcfg, JLoop(steps=3, global_batch=2, seq_len=16, lr=1e-3,
                            policy="optimal_offload:x0.6:1e15",
                            log_every=100),
                log_fn=jlogs.append)["losses"]
    assert any(s.startswith("[offload]") for s in jlogs)
    logs = []
    out = run_training(
        pcfg, TrainLoopConfig(steps=3, global_batch=2, seq_len=16, lr=1e-3,
                              policy=policy, solver_impl="plain",
                              peak_flops=PEAK_FLOPS_BF16, log_every=100),
        device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                 torch.device("cpu")),
        log_fn=logs.append)
    assert any(s.startswith("[offload]") for s in logs)
    assert out["plan"].uses_offload
    assert all(r["host_bytes_after"] == 0 and r["host_peak_bytes"] > 0
               for r in out["steps"])
    np.testing.assert_allclose(out["losses"], want, rtol=1e-4)
    with pytest.raises(NotImplementedError, match="grad_accum"):
        run_training(pcfg, TrainLoopConfig(steps=1, global_batch=2,
                                           seq_len=16, policy=policy,
                                           grad_accum=2,
                                           peak_flops=PEAK_FLOPS_BF16),
                     device="cpu", log_fn=lambda *_: None)
