"""The port's last public planning functions against the JAX package's, on
the CPU: ``core/schedule.py::assert_valid`` (and ``ScheduleViolationError``),
``plan/compat.py::parse_budget``, ``core/policies.py`` (``PolicyPlan``,
``make_policy_plan``, ``make_policy_tree``), ``core/bruteforce.py::
optimal_time``, ``launch/steps.py::plan_rotor_tree``,
``core/rematerialize.py::tree_stage_span``, ``data/pipeline.py::
make_batch_specs`` and ``models/common.py::rope_freqs``.

Chains are f32-exact (small integer sizes and times, a dyadic link), so
every makespan and schedule is compared exactly."""

import math

import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.core import bruteforce as jbruteforce  # noqa: E402
from repro.core import policies as jpolicies  # noqa: E402
from repro.core import rematerialize as jremat  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core.chain import Chain, HostTransferModel  # noqa: E402
from repro.data.pipeline import make_batch_specs as jbatch_specs  # noqa: E402
from repro.models.common import rope_freqs as jrope_freqs  # noqa: E402
from repro.plan.compat import parse_budget as jparse_budget  # noqa: E402
from repro_torch.check import Violation, verify_schedule  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import bruteforce, policies, schedule  # noqa: E402
from repro_torch.core import rematerialize  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.core.solver import solve_optimal  # noqa: E402
from repro_torch.data.pipeline import make_batch_specs  # noqa: E402
from repro_torch.launch.steps import plan_rotor_tree, plan_training  # noqa: E402
from repro_torch.models.common import rope_freqs  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.plan import two_tier_fallback  # noqa: E402
from repro_torch.plan.compat import parse_budget  # noqa: E402

from helpers import random_chain  # noqa: E402

LINK = 0.5           # host link, size units per second (dyadic)


def _port(ch: Chain, host: bool = False) -> PChain:
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob,
                       host=PHost(bandwidth_d2h=LINK) if host else None)


def _pair(seed: int, max_len: int = 5, host: bool = False):
    ch = random_chain(np.random.default_rng(seed), max_len=max_len)
    if host:
        ch = ch.with_host(HostTransferModel(bandwidth_d2h=LINK))
    return ch, _port(ch, host)


# -- assert_valid ----------------------------------------------------------------


def _broken(L: int, how: str):
    """A schedule of an L-stage chain broken one way, and the limit it
    runs under."""
    ops = list(jschedule.Schedule.store_all(L).ops)
    if how == "missing-input":
        return ops[1:], None
    if how == "device-budget":
        return ops, 1.0
    if how == "free-not-live":
        return [(jschedule.FREE, ("a", 3 + L))] + ops, None
    if how == "no-host-tier":
        return [("Foff", 0)] + ops, None
    if how == "no-output":
        return ops[:-1], None
    if how == "bad-op":
        return [("Fwd", 1)] + ops, None
    if how == "missing-residual":
        return [op for op in ops if op != ("Fall", L + 1)], None
    if how == "bad-stage":
        return [("Fnone", L + 2)] + ops, None
    raise ValueError(how)


@pytest.mark.parametrize("seed", range(3))
def test_assert_valid_returns_the_references_result(seed):
    ch, pch = _pair(seed)
    want = jschedule.assert_valid(ch, jschedule.Schedule.store_all(ch.length))
    got = schedule.assert_valid(pch, schedule.Schedule.store_all(ch.length))
    assert got.valid and (got.time, got.peak_mem) == (want.time,
                                                       want.peak_mem)


@pytest.mark.parametrize("how", ["missing-input", "device-budget",
                                 "free-not-live", "no-host-tier",
                                 "no-output", "bad-op", "missing-residual",
                                 "bad-stage"])
def test_assert_valid_raises_the_references_violation(how):
    ch, pch = _pair(4, max_len=4)
    ops, limit = _broken(ch.length, how)
    with pytest.raises(jschedule.ScheduleViolationError) as jerr:
        jschedule.assert_valid(ch, jschedule.Schedule(ch.length, ops), limit)
    with pytest.raises(schedule.ScheduleViolationError) as perr:
        schedule.assert_valid(pch, schedule.Schedule(ch.length, ops), limit)
    want, got = jerr.value.violation, perr.value.violation
    assert isinstance(perr.value, AssertionError)
    assert isinstance(got, Violation)      # MemoryPlan.verify's type
    assert (got.kind, got.op_index, got.op, got.state) == \
        (want.kind, want.op_index, want.op, want.state) == \
        (how, got.op_index, got.op, got.state)
    if how not in ("bad-op", "free-not-live"):
        # the static verifier names the same first rule
        report = verify_schedule(schedule.Schedule(ch.length, ops), pch,
                                 device_budget=limit)
        assert report.violations[0].kind == how


# -- parse_budget -----------------------------------------------------------------


@pytest.mark.parametrize("spec", ["1.5G", "800M", "2e9", "123", "0", "64K",
                                  "x0.5", "x1", "x0.25", " x0.75 "])
def test_parse_budget_documented_forms(spec):
    ch, pch = _pair(1)
    assert parse_budget(spec, pch) == jparse_budget(spec, ch)


@pytest.mark.parametrize("spec", ["auto", "abc", "x", "xfoo", "1.5Q", "",
                                  "-x0.5", "x0.5x"])
def test_parse_budget_refuses_garbage(spec):
    ch, pch = _pair(1)
    with pytest.raises(ValueError):
        jparse_budget(spec, ch)
    with pytest.raises(ValueError):
        parse_budget(spec, pch)


def test_parse_budget_fraction_needs_a_chain():
    with pytest.raises(ValueError):
        jparse_budget("x0.5", None)
    with pytest.raises(ValueError):
        parse_budget("x0.5", None)
    assert parse_budget("2G", None) == jparse_budget("2G", None) == 2e9


# -- policies ---------------------------------------------------------------------


POLICIES = ("none", "full", "periodic:2", "rotor:x0.8", "rotor:x0.5",
            "revolve:x0.7", "optimal_offload:x0.5:0.5",
            "optimal_offload:x0.6:0")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", range(3))
def test_make_policy_plan_matches_the_reference(policy, seed):
    ch, pch = _pair(seed, max_len=6, host=True)
    try:
        want = jpolicies.make_policy_plan(policy, ch, num_slots=40)
    except MemoryError as e:      # no schedule fits: the port says so too
        with pytest.raises(MemoryError) as err:
            policies.make_policy_plan(policy, pch, num_slots=40)
        assert type(err.value).__name__ == type(e).__name__
        return
    got = policies.make_policy_plan(policy, pch, num_slots=40)
    assert isinstance(got, policies.PolicyPlan)
    assert got.policy == policy and got.uses_offload == want.uses_offload
    assert got.schedule.ops == want.schedule.ops
    assert (got.tree is None) == (want.tree is None)
    if got.tree is not None:
        assert rematerialize.tree_stage_span(got.tree) == \
            jremat.tree_stage_span(want.tree)
    if got.uses_offload:
        with pytest.raises(ValueError, match="host-offload"):
            policies.make_policy_tree(policy, pch, num_slots=40)
    elif got.tree is not None:
        assert policies.make_policy_tree(policy, pch, num_slots=40) \
            == got.tree


def _offloading_policy():
    """A policy and chain pair whose plan copies an activation to the host:
    the three-tier floor of a chain whose two-tier floor lies above it."""
    from repro_torch.plan import min_memory_plan

    for seed in range(40):
        ch, pch = _pair(seed, max_len=7, host=True)
        floor = min_memory_plan(pch, tiers=("device", "host"), num_slots=40)
        policy = f"optimal_offload:{floor.budget_bytes!r}:{LINK}"
        try:
            plan = policies.make_policy_plan(policy, pch, num_slots=40)
        except MemoryError:
            continue
        if plan.uses_offload:
            return policy, ch, pch
    raise AssertionError("no chain of 40 seeds offloads at its floor")


def test_make_policy_tree_refuses_an_offload_plan():
    policy, ch, pch = _offloading_policy()
    want = jpolicies.make_policy_plan(policy, ch, num_slots=40)
    got = policies.make_policy_plan(policy, pch, num_slots=40)
    assert want.uses_offload and got.uses_offload
    assert got.schedule.ops == want.schedule.ops
    with pytest.raises(ValueError, match="host-offload"):
        jpolicies.make_policy_tree(policy, ch, num_slots=40)
    with pytest.raises(ValueError, match="host-offload"):
        policies.make_policy_tree(policy, pch, num_slots=40)


def test_policies_reexport_the_grammar():
    for name in policies.__all__:
        assert hasattr(policies, name)
    assert policies.DOCUMENTED_POLICIES[-1] == "optimal_offload:BUDGET:BW"
    assert policies.parse_budget is parse_budget


# -- bruteforce -------------------------------------------------------------------


def _budgets(ch, fracs=(0.5, 0.75, 1.0)):
    peak = schedule.simulate(ch, schedule.Schedule.store_all(ch.length)
                             ).peak_mem
    return [float(math.ceil(peak * f)) for f in fracs]


@pytest.mark.parametrize("seed", range(8))
def test_bruteforce_matches_the_dp_and_the_reference(seed):
    """On small f32-exact chains the persistent optimum equals the port's
    DP (slots of exactly one unit) and the reference oracle's, and the
    schedule it returns simulates to that time within the limit."""
    ch, pch = _pair(seed, max_len=4)
    for m in _budgets(pch):
        bf = bruteforce.optimal_time(pch, m + 1e-6, persistent_only=True)
        assert bf == jbruteforce.optimal_time(ch, m + 1e-6,
                                              persistent_only=True)
        sol = solve_optimal(pch, m, num_slots=int(m))
        if not sol.feasible:
            assert not np.isfinite(bf)
            continue
        assert abs(sol.expected_time - bf) < 1e-9
        t, sched = bruteforce.optimal_time(pch, m + 1e-6,
                                           persistent_only=True,
                                           return_schedule=True)
        res = schedule.simulate(pch, sched, m + 1e-6)
        assert res.valid and abs(res.time - t) < 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_bruteforce_non_persistent_runs_on_the_simulator(seed):
    """Without the persistence restriction the oracle may drop values
    (``Free``): never slower than the persistent optimum, equal to the
    reference's, and its schedule (Free ops included) runs on the port's
    simulator in that time."""
    ch, pch = _pair(seed, max_len=3)
    for m in _budgets(pch, (0.6, 1.0)):
        t, sched = bruteforce.optimal_time(pch, m + 1e-6,
                                           return_schedule=True)
        assert t == jbruteforce.optimal_time(ch, m + 1e-6)
        assert t <= bruteforce.optimal_time(pch, m + 1e-6,
                                            persistent_only=True)
        if np.isfinite(t):
            res = schedule.simulate(pch, sched, m + 1e-6)
            assert res.valid and abs(res.time - t) < 1e-9


# -- plan_rotor_tree and tree_stage_span -------------------------------------------


@pytest.fixture(scope="module")
def smoke_model():
    cfg = smoke_config("qwen1.5-4b")
    return StagedLM(cfg)


@pytest.mark.parametrize("policy", ["none", "rotor:x0.6", "full",
                                    "periodic:2"])
def test_plan_rotor_tree_matches_the_reference_tree(smoke_model, policy):
    ch, pch = _pair(7, max_len=6, host=True)
    specs = make_batch_specs(smoke_model.cfg, 2, 16)
    tree, chain = plan_rotor_tree(smoke_model, specs, policy, chain=pch,
                                  num_slots=40)
    if policy == "none":
        assert tree is None and chain is None
        return
    want = jpolicies.make_policy_tree(policy, ch, num_slots=40)
    assert chain is pch
    assert rematerialize.tree_stage_span(tree) == \
        jremat.tree_stage_span(want) == (1, ch.length + 1)
    plan, _ = plan_training(smoke_model, specs, policy, chain=pch,
                            num_slots=40)
    assert tree == plan.tree


def test_plan_rotor_tree_degrades_an_offload_plan(smoke_model):
    policy, ch, pch = _offloading_policy()
    specs = make_batch_specs(smoke_model.cfg, 2, 16)
    tree, _ = plan_rotor_tree(smoke_model, specs, policy, chain=pch,
                              num_slots=40)
    plan, _ = plan_training(smoke_model, specs, policy, chain=pch,
                            num_slots=40)
    assert plan.uses_offload
    assert tree == two_tier_fallback(plan, pch).tree
    assert rematerialize.tree_stage_span(tree) == (1, ch.length + 1)


@pytest.mark.parametrize("L,k", [(1, 1), (5, 2), (8, 3), (12, 4)])
def test_tree_stage_span_of_structural_trees(L, k):
    for name in ("sequential_tree", "full_remat_tree"):
        got = getattr(rematerialize, name)(L)
        want = getattr(jremat, name)(L)
        assert rematerialize.tree_stage_span(got) == \
            jremat.tree_stage_span(want)
    assert rematerialize.tree_stage_span(rematerialize.periodic_tree(L, k)) \
        == jremat.tree_stage_span(jremat.periodic_tree(L, k))


# -- make_batch_specs and rope_freqs -----------------------------------------------


_DTYPES = {"int32": torch.int32, "float32": torch.float32,
           "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "musicgen-medium",
                                  "paligemma-3b"])
def test_make_batch_specs_matches_the_reference(arch):
    cfg, jcfg = smoke_config(arch), jsmoke_config(arch)
    seq = 2 * jcfg.prefix_len + 8 if jcfg.modality == "vlm" else 24
    got, want = make_batch_specs(cfg, 3, seq), jbatch_specs(jcfg, 3, seq)
    assert list(got) == list(want)
    for key, spec in want.items():
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == tuple(spec.shape), key
        assert got[key].dtype == _DTYPES[jnp.dtype(spec.dtype).name], key


@pytest.mark.parametrize("head_dim,theta", [(64, 1e4), (128, 1e4),
                                            (80, 1e6), (256, 5e5)])
def test_rope_freqs_matches_the_reference(head_dim, theta):
    """float32 ``theta ** -x`` in two libraries: within 2 ulps."""
    got = rope_freqs(head_dim, theta)
    want = np.asarray(jrope_freqs(head_dim, theta))
    assert got.dtype == torch.float32 and got.shape == (head_dim // 2,)
    np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0)
