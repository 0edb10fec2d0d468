"""The paper's baselines in the port (``core.baselines``, the ``revolve:B``
policy) and the plan's inspection surface (``MemoryPlan.timeline`` /
``stats``) against the JAX package on the same seeded chains.

Chains are f32-exact (integer stage costs and sizes, ``of``/``ob`` included,
dyadic link times), so schedules are compared op for op and makespans,
peaks and every timeline and stats value **bit-equal**; the port's
``executor`` field names its own executor (``"nested-checkpoint"`` where
the JAX package says ``"jit-nested-remat"``).  Then the trade-off launcher
(``launch.tradeoff``) at the smoke width on the CPU."""

import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core.chain import Chain, HostTransferModel  # noqa: E402
from repro.plan import InfeasiblePlanError as JInfeasible  # noqa: E402
from repro.plan.compat import resolve_policy as jresolve  # noqa: E402
from repro_torch.core import baselines as pbase  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.core.rematerialize import periodic_tree  # noqa: E402
from repro_torch.core.solver import tree_to_schedule  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.launch import tradeoff  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.plan import InfeasiblePlanError, resolve_policy  # noqa: E402

from helpers import random_chain  # noqa: E402

SEEDS = range(8)


def _port(ch: Chain) -> PChain:
    host = None if ch.host is None else PHost(
        bandwidth_d2h=ch.host.bandwidth_d2h,
        bandwidth_h2d=ch.host.bandwidth_h2d, latency=ch.host.latency)
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob, host=host)


def _chain(seed: int) -> Chain:
    return random_chain(np.random.default_rng(seed), max_len=9)


def _budgets(ch: Chain, fracs=(0.3, 0.5, 0.75, 1.0)):
    peak = ch.store_all_peak()
    return [float(math.ceil(peak * f)) for f in fracs]


@pytest.mark.parametrize("seed", SEEDS)
def test_periodic_and_chen_sqrt_match_jax(seed):
    ch = _chain(seed)
    pch = _port(ch)
    for k in range(1, ch.length + 2):
        assert pbase.periodic(pch, k).ops == jbase.periodic(ch, k).ops
        # the baseline is the flattened tree the periodic:K policy runs
        assert pbase.periodic(pch, k).ops == tree_to_schedule(
            periodic_tree(ch.length, k), ch.length).ops
    assert pbase.chen_sqrt(pch).ops == jbase.chen_sqrt(ch).ops


@pytest.mark.parametrize("seed", SEEDS)
def test_best_periodic_matches_jax(seed):
    ch = _chain(seed)
    pch = _port(ch)
    for budget in _budgets(ch, (0.2, 0.4, 0.6, 0.8, 1.0)):
        want, got = jbase.best_periodic(ch, budget), \
            pbase.best_periodic(pch, budget)
        assert (want is None) == (got is None)
        if want is None:
            continue
        assert got[0] == want[0]
        assert got[2].ops == want[2].ops
        assert (got[1].time, got[1].peak_mem) == (want[1].time,
                                                  want[1].peak_mem)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("impl", ["banded", "plain"])
def test_revolve_matches_jax(seed, impl):
    ch = _chain(seed)
    pch = _port(ch)
    for budget in _budgets(ch):
        want = jbase.revolve(ch, budget, num_slots=64)
        got = pbase.revolve(pch, budget, num_slots=64, impl=impl)
        assert got.feasible == want.feasible
        if want.feasible:
            assert got.schedule.ops == want.schedule.ops
            assert got.expected_time == want.expected_time
            assert got.slots_used == want.slots_used


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("impl", ["banded", "plain"])
def test_revolve_policy_matches_jax(seed, impl):
    ch = _chain(seed)
    pch = _port(ch)
    feasible = 0
    for budget in _budgets(ch):
        policy = f"revolve:{int(budget)}"
        try:
            want = jresolve(policy, ch, num_slots=64)
        except JInfeasible:
            with pytest.raises(InfeasiblePlanError, match="no feasible"):
                resolve_policy(policy, pch, num_slots=64, impl=impl)
            continue
        feasible += 1
        got = resolve_policy(policy, pch, num_slots=64, impl=impl)
        assert got.schedule.ops == want.schedule.ops
        assert got.expected_time == want.expected_time
        assert got.peak_device_mem == want.peak_device_mem
        assert got.remat_expressible and want.remat_expressible
        # revolve checkpoints bare activations only: every stage but the
        # loss runs its forward at least twice
        fc = got.schedule.forward_counts()
        assert all(fc[l] >= 2 for l in range(1, ch.length + 1)) or \
            ch.length == 1
    assert feasible >= 1
    # an 'auto' budget that does not fit falls back to revolve's own
    # min-memory schedule in both packages
    want = jresolve("revolve:auto", ch, num_slots=64, auto_budget=1.0)
    got = resolve_policy("revolve:auto", pch, num_slots=64, impl=impl,
                         auto_budget=1.0)
    assert got.schedule.ops == want.schedule.ops
    assert got.expected_time == want.expected_time


def test_revolve_policy_errors():
    pch = _port(_chain(0))
    with pytest.raises(InfeasiblePlanError, match="revolve:1"):
        resolve_policy("revolve:1", pch)
    with pytest.raises(ValueError, match="cannot parse"):
        resolve_policy("revolve:lots", pch)
    with pytest.raises(ValueError, match="needs a profiled chain"):
        resolve_policy("revolve:x0.5", None, length=4)
    with pytest.raises(ValueError, match="auto budget needs"):
        resolve_policy("revolve:auto", pch)


POLICIES = ["none", "full", "periodic:2", "rotor:x0.6", "rotor:x1.0",
            "revolve:x0.8", "optimal_offload:x0.5:1.0",
            "optimal_offload:x0.6:0"]


@pytest.mark.parametrize("seed", SEEDS)
def test_timeline_and_stats_match_jax(seed):
    ch = _chain(seed)
    hch = Chain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                     of=ch.of, ob=ch.ob)
    pch = _port(hch)
    compared = 0
    for policy in POLICIES:
        try:
            want = jresolve(policy, hch)
        except JInfeasible:
            continue
        got = resolve_policy(policy, pch)
        assert got.timeline() == want.timeline(), policy
        stats, jstats = got.stats(), want.stats()
        assert stats.pop("executor") == {
            "jit-nested-remat": "nested-checkpoint",
            "eager-offload": "eager-offload"}[jstats.pop("executor")]
        assert stats == jstats, policy
        assert got.recompute_factor() == want.recompute_factor()
        assert got.remat_expressible == want.remat_expressible
        compared += 1
    assert compared >= 4


def test_timeline_needs_a_chain():
    plan = resolve_policy("full", None, length=3)
    with pytest.raises(ValueError, match="profiled chain"):
        plan.timeline()
    assert plan.stats()["chain_hash"] is None
    assert plan.stats()["strategy"] == "full_remat"


def test_offload_timeline_matches_jax():
    L = 6
    ch = Chain.make(uf=[1.0] * L + [0.0], ub=[2.0] * L + [0.0],
                    wa=[1.0] * (L + 1), wabar=[2.0] * L + [0.0],
                    host=HostTransferModel(bandwidth_d2h=1.0))
    policy = "optimal_offload:x0.35:1.0"
    want = jresolve(policy, ch, num_slots=64)
    got = resolve_policy(policy, _port(ch), num_slots=64)
    assert got.uses_offload and want.uses_offload
    assert not got.remat_expressible
    assert got.timeline() == want.timeline()
    stats, jstats = got.stats(), want.stats()
    assert stats == jstats
    assert stats["tiers"] == "device+host"


def test_tradeoff_launcher_on_the_cpu():
    """``python -m repro_torch.launch.tradeoff`` at the smoke width: every
    strategy it runs computes store-all's loss and gradient norm (rtol
    1e-5, float32), its predictions are the simulator's on the measured
    chain, and it names the skipped points."""
    lines = []
    out = tradeoff.run_lm_tradeoff(*_smoke_model(), impl="plain",
                                   repeats=1, emit=lines.append)
    rows, chain = out["rows"], out["chain"]
    assert rows[0]["strategy"] == "store-all"
    assert {r["strategy"].split("(")[0] for r in rows} >= {
        "store-all", "sequential", "revolve", "rotor"}
    for r in rows:
        np.testing.assert_allclose(r["loss"], rows[0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], rows[0]["grad_norm"],
                                   rtol=1e-5)
        assert r["measured_s"] > 0 and r["measured_peak_bytes"] is None
    assert rows[0]["predicted_peak_bytes"] == chain.store_all_peak()
    points = 1 + 3 * len(tradeoff.BUDGETS)
    skipped = [s for s in lines if "skipped" in s]
    assert len(rows) + len(skipped) == points
    assert np.isfinite(out["mape_percent"])
    assert any(s.startswith("time prediction MAPE") for s in lines)


def _smoke_model():
    cfg = smoke_config("qwen1.5-4b", num_layers=3,
                       layer_kinds=("dense",) * 3, n_chunks=3)
    model = StagedLM(cfg)
    batch = SyntheticLMData(cfg, 2, 16, seed=0).device_batch(0, "cpu")
    return model, model.init(0, torch.device("cpu")), batch
