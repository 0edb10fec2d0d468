"""The port's typed planning surface (``repro_torch.plan``: ``PlanRequest``,
``Budget``, the tier registry, ``build_plan``, ``sweep``,
``min_memory_plan``, ``two_tier_fallback`` and the policy strings through
``policy_to_request``) against the JAX package's ``repro.plan`` on the same
seeded chains.

Chains are f32-exact (integer stage costs and sizes, ``of``/``ob``
included, a dyadic host link given explicitly to both packages), so
schedules are compared op for op and the predicted makespan, device and
host peaks and transfer stall within a relative 1e-12 (float64).  The
port's one deliberate difference — a host tier needs a measured link, with
no PCIe-3 default — is checked on its own."""

import dataclasses
import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.chain import Chain, HostTransferModel  # noqa: E402
from repro.plan import Budget as JBudget  # noqa: E402
from repro.plan import PlanRequest as JRequest  # noqa: E402
from repro.plan import build_plan as jbuild  # noqa: E402
from repro.plan import min_memory_plan as jmin_plan  # noqa: E402
from repro.plan import parse_size as jparse_size  # noqa: E402
from repro.plan import sweep as jsweep  # noqa: E402
from repro.plan import two_tier_fallback as jfallback  # noqa: E402
from repro.plan.compat import resolve_policy as jresolve  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.plan import (Budget, DOCUMENTED_POLICIES,  # noqa: E402
                              InfeasiblePlanError, PlanRequest,
                              available_solvers, build_plan, min_memory_plan,
                              parse_size, policy_to_request, register_solver,
                              resolve_policy, solver_for, sweep,
                              two_tier_fallback)
from repro_torch.plan import registry  # noqa: E402

from helpers import random_chain  # noqa: E402

SEEDS = range(6)
LINK = 0.5           # host link, size units per second (dyadic)
SLOTS = 40
STRATEGIES = ("store_all", "full_remat", "periodic", "optimal", "revolve",
              "min_memory")
TIERS = (("device",), ("device", "host"))
FRACTIONS = (0.25, 0.45, 0.7, 1.0)


def _port(ch: Chain) -> PChain:
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob)


def _chain(seed: int) -> Chain:
    return random_chain(np.random.default_rng(seed), max_len=7)


def _requests(ch: Chain, tiers):
    """Pairs of equal (JAX, port) requests: every strategy, and for the
    budgeted ones bytes / fraction / auto budgets under both infeasibility
    policies; ``auto`` resolves to the value passed beside it."""
    host = {"host": HostTransferModel(bandwidth_d2h=LINK),
            "port": PHost(bandwidth_d2h=LINK)} if "host" in tiers else None
    peak = ch.store_all_peak()
    for strategy in STRATEGIES:
        kw = dict(strategy=strategy, tiers=tiers, num_slots=SLOTS,
                  segments=2 if strategy == "periodic" else 0)
        budgets = [None]
        if strategy in ("optimal", "revolve"):
            budgets = ([("bytes", float(math.ceil(peak * f)), None)
                        for f in FRACTIONS]
                       + [("fraction", f, None) for f in FRACTIONS]
                       + [("auto", 0.0, float(math.ceil(peak * f)))
                          for f in (0.2, 0.6)])
        for b in budgets:
            for on_inf in (("raise", "min_memory") if b else ("raise",)):
                jb = pb = None
                auto = None
                if b is not None:
                    kind, value, auto = b
                    jb, pb = JBudget(kind, value), Budget(kind, value)
                yield (JRequest(budget=jb, on_infeasible=on_inf,
                                host=host and host["host"], **kw),
                       PlanRequest(budget=pb, on_infeasible=on_inf,
                                   host=host and host["port"], **kw),
                       auto)


def _same_plan(got, want):
    assert got.schedule.ops == list(want.schedule.ops)
    for name in ("expected_time", "peak_device_mem", "peak_host_mem",
                 "transfer_stall"):
        a, b = getattr(got, name), getattr(want, name)
        assert math.isclose(a, b, rel_tol=1e-12), (name, a, b)
    assert got.budget_bytes == want.budget_bytes
    assert got.chain_hash == want.chain_hash
    assert got.uses_offload == want.uses_offload
    stats, jstats = got.stats(), want.stats()
    assert stats.pop("executor") == {
        "jit-nested-remat": "nested-checkpoint",
        "eager-offload": "eager-offload"}[jstats.pop("executor")]
    assert stats == jstats


@pytest.mark.parametrize("tiers", TIERS, ids="+".join)
@pytest.mark.parametrize("seed", SEEDS)
def test_build_plan_matches_jax(seed, tiers):
    ch = _chain(seed)
    pch = _port(ch)
    built = infeasible = 0
    for jreq, preq, auto in _requests(ch, tiers):
        try:
            want = jbuild(jreq, ch, auto_budget=auto)
        except MemoryError:
            with pytest.raises(InfeasiblePlanError, match="no feasible"):
                build_plan(preq, pch, auto_budget=auto)
            infeasible += 1
            continue
        got = build_plan(preq, pch, auto_budget=auto)
        _same_plan(got, want)
        assert got.request == preq
        assert got.verify().ok
        built += 1
    assert built >= 10


@pytest.mark.parametrize("seed", SEEDS)
def test_infeasible_budgets_raise_in_both(seed):
    ch = _chain(seed)
    for tiers in TIERS:
        kw = dict(budget=None, tiers=tiers, num_slots=SLOTS)
        jh = HostTransferModel(bandwidth_d2h=LINK) if "host" in tiers else None
        ph = PHost(bandwidth_d2h=LINK) if "host" in tiers else None
        for strategy in ("optimal", "revolve"):
            jreq = JRequest(strategy=strategy, host=jh,
                            **{**kw, "budget": JBudget.bytes(0.5)})
            preq = PlanRequest(strategy=strategy, host=ph,
                               **{**kw, "budget": Budget.bytes(0.5)})
            with pytest.raises(MemoryError):
                jbuild(jreq, ch)
            with pytest.raises(InfeasiblePlanError,
                               match=f"{strategy}: no feasible"):
                build_plan(preq, _port(ch))


@pytest.mark.parametrize("tiers", TIERS, ids="+".join)
@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_matches_jax(seed, tiers):
    ch = _chain(seed)
    fracs = (0.2, 0.35, 0.5, 0.75, 1.0)
    jh = HostTransferModel(bandwidth_d2h=LINK) if "host" in tiers else None
    ph = PHost(bandwidth_d2h=LINK) if "host" in tiers else None
    want = jsweep(ch, fracs, JRequest(tiers=tiers, host=jh, num_slots=SLOTS),
                  use_frontier=False)
    got = sweep(_port(ch), fracs,
                PlanRequest(tiers=tiers, host=ph, num_slots=SLOTS))
    assert [p.fraction for p in got] == [p.fraction for p in want]
    assert [p.budget_bytes for p in got] == [p.budget_bytes for p in want]
    assert [p.feasible for p in got] == [p.feasible for p in want]
    assert any(p.feasible for p in got)
    for g, w in zip(got, want):
        if w.feasible:
            _same_plan(g.plan, w.plan)


@pytest.mark.parametrize("seed", SEEDS)
def test_min_memory_plan_and_two_tier_fallback_match_jax(seed):
    ch = _chain(seed)
    pch = _port(ch)
    hch, phch = (ch.with_host(HostTransferModel(bandwidth_d2h=LINK)),
                 pch.with_host(PHost(bandwidth_d2h=LINK)))
    for tiers in TIERS:
        _same_plan(min_memory_plan(phch, tiers=tiers, num_slots=SLOTS),
                   jmin_plan(hch, tiers=tiers, num_slots=SLOTS))
    # an offload plan's two-tier fallback: the same budget on two tiers,
    # or the min-memory schedule where that does not fit
    floor3 = min_memory_plan(phch, tiers=("device", "host"),
                             num_slots=SLOTS)
    for budget in (floor3.budget_bytes, 0.6 * ch.store_all_peak()):
        try:
            want = jbuild(JRequest(budget=JBudget.bytes(budget),
                                   tiers=("device", "host"), num_slots=SLOTS),
                          hch)
        except MemoryError:
            continue
        got = build_plan(PlanRequest(budget=Budget.bytes(budget),
                                     tiers=("device", "host"),
                                     num_slots=SLOTS), phch)
        _same_plan(two_tier_fallback(got), jfallback(want))
        assert not two_tier_fallback(got).uses_offload


POLICIES = ("none", "full", "periodic:2", "periodic:3", "rotor:x0.8",
            "rotor:x0.5", "rotor:auto", "revolve:x0.8", "revolve:auto",
            "optimal_offload:x0.5:0.5", "optimal_offload:x0.6:0")


@pytest.mark.parametrize("seed", SEEDS)
def test_resolve_policy_is_build_plan_of_policy_to_request(seed):
    ch = _chain(seed)
    pch = _port(ch)
    auto = float(math.ceil(0.3 * ch.store_all_peak()))
    assert DOCUMENTED_POLICIES[-1] == "optimal_offload:BUDGET:BW"
    compared = 0
    for policy in POLICIES:
        try:
            want = jresolve(policy, ch, num_slots=SLOTS, auto_budget=auto)
        except MemoryError:
            with pytest.raises(InfeasiblePlanError):
                resolve_policy(policy, pch, num_slots=SLOTS, auto_budget=auto)
            continue
        got = resolve_policy(policy, pch, num_slots=SLOTS, auto_budget=auto)
        req = policy_to_request(policy, num_slots=SLOTS)
        direct = build_plan(req, pch, auto_budget=auto, policy=policy)
        assert got.request == req
        _same_plan(got, want)
        _same_plan(direct, want)
        compared += 1
    assert compared >= 8


def test_policy_to_request_table():
    assert policy_to_request("none").strategy == "store_all"
    assert policy_to_request("full").strategy == "full_remat"
    assert policy_to_request("periodic:3").segments == 3
    r = policy_to_request("rotor:x0.6")
    assert (r.strategy, r.budget, r.on_infeasible) == (
        "optimal", Budget.fraction(0.6), "raise")
    assert policy_to_request("rotor:auto").on_infeasible == "min_memory"
    assert policy_to_request("revolve:8G").budget == Budget.bytes(8e9)
    r = policy_to_request("optimal_offload:8G:12G", impl="cuda_fused")
    assert r.tiers == ("device", "host") and r.impl == "cuda_fused"
    assert r.host == PHost(bandwidth_d2h=12e9)
    assert policy_to_request("optimal_offload:8G:0").tiers == ("device",)
    for bad in ("optimal_offload:8G", "optimal_offload:8G:"):
        with pytest.raises(ValueError, match="optimal_offload:BUDGET:BW"):
            policy_to_request(bad)
    for bad, msg in (("periodic:two", "integer segment"),
                     ("periodic:0", "segments >= 1"),
                     ("rotor:lots", "cannot parse"),
                     ("sometimes", "unknown remat policy")):
        with pytest.raises(ValueError, match=msg):
            policy_to_request(bad)
    with pytest.raises(ValueError, match="unknown DP impl"):
        policy_to_request("rotor:x0.5", impl="pallas")


def test_host_tier_needs_a_measured_link():
    ch = _port(_chain(0))
    req = PlanRequest(budget=Budget.fraction(0.5), tiers=("device", "host"),
                      num_slots=SLOTS)
    with pytest.raises(ValueError, match="no default link"):
        build_plan(req, ch)
    # the chain's own link serves when the request has none
    linked = ch.with_host(PHost(bandwidth_d2h=LINK))
    plan = build_plan(req, linked)
    assert plan.chain.host == PHost(bandwidth_d2h=LINK)
    assert plan.tiers == "device+host"


def test_registry_known_unknown_and_custom_tiers(monkeypatch):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    assert set(available_solvers()) == {"device", "device+host", "device+kv"}
    assert solver_for(("device",)).key == "device"
    with pytest.raises(ValueError, match="no solver registered"):
        solver_for(("device", "nvme"))
    with pytest.raises(ValueError, match="no solver registered"):
        build_plan(PlanRequest(budget=Budget.fraction(1.0),
                               tiers=("device", "nvme")), _port(_chain(1)))
    calls = []

    def solve(chain, budget, **kw):
        calls.append(("solve", budget))
        return solver_for(("device",)).solve(chain, budget, **kw)

    def solve_min(chain, **kw):
        calls.append(("solve_min", None))
        return solver_for(("device",)).solve_min(chain, **kw)

    register_solver("device+nvme", solve, solve_min, "a test tier")
    with pytest.raises(ValueError, match="already registered"):
        register_solver("device+nvme", solve, solve_min)
    ch = _port(_chain(1))
    req = PlanRequest(budget=Budget.fraction(1.0), tiers=("device", "nvme"),
                      num_slots=SLOTS)
    plan = build_plan(req, ch)
    two = build_plan(dataclasses.replace(req, tiers=("device",)), ch)
    assert plan.schedule.ops == two.schedule.ops
    assert plan.tiers == "device+nvme"
    assert calls == [("solve", plan.budget_bytes)]
    build_plan(PlanRequest(strategy="min_memory", tiers=("device", "nvme")),
               ch)
    assert calls[-1] == ("solve_min", None)


def test_parse_size_documented_forms_match_jax():
    for spec in ("1.5G", "800M", "2e9", "1.5e9", "123", "0", ".5K", " 4G ",
                 "3T", "1.5E-3"):
        assert parse_size(spec) == jparse_size(spec), spec


@pytest.mark.parametrize("garbage", ["1e", "--5G", "", "G", "1..5", "x",
                                     "e9", "+5G", "-5G", "1.5GG", "nan",
                                     "inf", "0x10", "1,5G"])
def test_parse_size_rejects_the_garbage_jax_rejects(garbage):
    with pytest.raises(ValueError, match="expected a number|cannot parse"):
        jparse_size(garbage)
    with pytest.raises(ValueError, match="expected a number|cannot parse"):
        parse_size(garbage)


def test_budget_forms_match_jax():
    for spec in ("x0.25", "8G", "auto", "0", "x1", "123"):
        got, want = Budget.parse(spec), JBudget.parse(spec)
        assert (got.kind, got.value) == (want.kind, want.value), spec
        assert got.describe() == want.describe()
    for bad in ("x", "x--5", "xG"):
        with pytest.raises(ValueError, match="'x' followed by a number"):
            JBudget.parse(bad)
        with pytest.raises(ValueError, match="'x' followed by a number"):
            Budget.parse(bad)
    assert Budget.bytes(10).resolve() == 10.0
    assert Budget.fraction(0.5).resolve(store_all_peak=100.0) == 50.0
    assert Budget.auto().resolve(auto_budget=7.0) == 7.0
    assert Budget.auto().resolve(auto_budget=lambda: 9.0) == 9.0
    with pytest.raises(ValueError, match="auto budget needs"):
        Budget.auto().resolve()
    with pytest.raises(ValueError, match="profiled chain"):
        Budget.fraction(0.5).resolve()
    with pytest.raises(ValueError):
        Budget("parsecs", 1.0)
    with pytest.raises(ValueError):
        Budget.bytes(-1.0)


def test_plan_request_validation():
    for kw, msg in ((dict(strategy="fastest"), "unknown plan strategy"),
                    (dict(strategy="periodic"), "segments >= 1"),
                    (dict(tiers=("host",)), "start with 'device'"),
                    (dict(on_infeasible="shrug"), "on_infeasible"),
                    (dict(impl="pallas_fused"), "unknown DP impl"),
                    (dict(num_slots=0), "num_slots")):
        with pytest.raises(ValueError, match=msg):
            PlanRequest(**kw)
    req = PlanRequest(budget=Budget.fraction(0.5), tiers=["device", "host"],
                      impl="cuda")
    assert req.tiers == ("device", "host")
    assert req.resolved_num_slots == 500 and req.allow_fall
    assert not PlanRequest(strategy="revolve").allow_fall
    want = JRequest(budget=JBudget.fraction(0.5), tiers=("device", "host"),
                    impl="banded").describe()
    assert dataclasses.replace(req, impl="banded").describe() == want
