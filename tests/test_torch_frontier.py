"""The port's warm-start frontier (``repro_torch.store.frontier``): the
zero-solve answer paths (exact hit, infeasibility monotonicity,
equal-makespan interpolation), the one-refinement-solve fallback, the
verify-before-serve gate, the ``sweep()`` integration (no solves on a
revisited chain, through the default store too), and its answers against
the JAX package's frontier on the same chains.

The property test asserts the frontier's core contract: whatever it
answers is *indistinguishable* from a direct solve — same feasibility,
same optimal makespan — it only ever saves work, never changes results.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.chain import Chain as JChain  # noqa: E402
from repro.plan import Budget as JBudget  # noqa: E402
from repro.plan import InfeasiblePlanError as JInfeasible  # noqa: E402
from repro.plan import PlanRequest as JRequest  # noqa: E402
from repro.plan import build_plan as jbuild  # noqa: E402
from repro.store import MemoryBackend as JMemoryBackend  # noqa: E402
from repro.store import ObjectStore as JObjectStore  # noqa: E402
from repro.store import WarmStartFrontier as JFrontier  # noqa: E402
from repro_torch.core.chain import Chain  # noqa: E402
from repro_torch.plan import (Budget, InfeasiblePlanError,  # noqa: E402
                              PlanRequest, build_plan)
from repro_torch.plan.api import sweep  # noqa: E402
from repro_torch.store import (MemoryBackend, ObjectStore,  # noqa: E402
                               WarmStartFrontier)

from hypothesis import given, settings, strategies as st  # noqa: E402

NUM_SLOTS = 64


def _arrays(L: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = L + 1
    return dict(
        uf=rng.integers(1, 5, n).astype(float),
        ub=rng.integers(1, 5, n).astype(float),
        wa=rng.integers(1, 4, n).astype(float),
        wabar=rng.integers(1, 6, n).astype(float),
    )


def _chain(L: int = 10, seed: int = 0) -> Chain:
    return Chain.make(**_arrays(L, seed))


def _template() -> PlanRequest:
    return PlanRequest(strategy="optimal", num_slots=NUM_SLOTS)


def _solver(chain, template, counter):
    def solve(budget):
        counter[0] += 1
        try:
            return build_plan(
                dataclasses.replace(template, budget=Budget.bytes(budget)),
                chain,
            )
        except InfeasiblePlanError:
            return None

    return solve


def _frontier() -> WarmStartFrontier:
    return WarmStartFrontier(ObjectStore(MemoryBackend()))


def test_exact_hit_zero_solves():
    ch, tmpl, fr = _chain(), _template(), _frontier()
    budget = ch.store_all_peak() * 0.6
    solves = [0]
    first = fr.query(ch, tmpl, budget, solve=_solver(ch, tmpl, solves))
    assert first.source == "solved" and solves[0] == 1
    again = fr.query(ch, tmpl, budget, solve=_solver(ch, tmpl, solves))
    assert again.source == "exact" and again.solves == 0 and solves[0] == 1
    assert again.plan.expected_time == first.plan.expected_time


def test_infeasibility_is_monotone():
    ch, tmpl, fr = _chain(), _template(), _frontier()
    # find an infeasible budget by recording a tiny one
    solves = [0]
    tiny = fr.query(ch, tmpl, 1.0, solve=_solver(ch, tmpl, solves))
    assert not tiny.feasible and solves[0] == 1
    # anything at or below a recorded infeasible budget: zero solves
    below = fr.query(ch, tmpl, 0.5, solve=_solver(ch, tmpl, solves))
    assert not below.feasible
    assert below.solves == 0 and solves[0] == 1
    assert below.source == "infeasible"


def test_equal_time_bracket_interpolates():
    ch, tmpl, fr = _chain(), _template(), _frontier()
    peak = ch.store_all_peak()
    solves = [0]
    solve = _solver(ch, tmpl, solves)
    # both budgets clear the store-all peak *plus* the worst-case slot
    # rounding slack (one slot per stage), so both plans are recompute-free
    # with the identical optimal makespan
    lo = fr.query(ch, tmpl, peak * 1.5, solve=solve)
    hi = fr.query(ch, tmpl, peak * 2.5, solve=solve)
    assert lo.feasible and hi.feasible and solves[0] == 2
    assert lo.plan.expected_time == hi.plan.expected_time
    mid = fr.query(ch, tmpl, peak * 2.0, solve=solve)
    assert mid.source == "interpolated" and mid.solves == 0
    assert solves[0] == 2, "bracketed query must not re-solve"
    assert mid.plan.expected_time == lo.plan.expected_time
    assert mid.plan.verify().ok


def test_undecided_query_costs_exactly_one_solve():
    ch, tmpl, fr = _chain(), _template(), _frontier()
    peak = ch.store_all_peak()
    solves = [0]
    solve = _solver(ch, tmpl, solves)
    fr.query(ch, tmpl, peak * 0.4, solve=solve)
    fr.query(ch, tmpl, peak * 0.9, solve=solve)
    assert solves[0] == 2
    # 0.6x sits between two points with different makespans: the bracket
    # does not pinch, so this costs exactly one more solve — never two
    answer = fr.query(ch, tmpl, peak * 0.6, solve=solve)
    assert answer.solves == 1 and solves[0] == 3
    # ... and the refinement was recorded: asking again is free
    again = fr.query(ch, tmpl, peak * 0.6, solve=solve)
    assert again.solves == 0 and solves[0] == 3


def test_served_plans_are_verified_and_tamper_is_quarantined():
    ch, tmpl, fr = _chain(), _template(), _frontier()
    budget = ch.store_all_peak() * 0.7
    solves = [0]
    fr.query(ch, tmpl, budget, solve=_solver(ch, tmpl, solves))
    # doctor the *stored* plan: forged makespan = metadata drift on verify
    points = fr.points(ch, tmpl)
    points[0]["plan"].expected_time += 1.0
    fr._save(fr._key(ch, tmpl), points)
    answer = fr.query(ch, tmpl, budget, solve=_solver(ch, tmpl, solves))
    # the tampered plan never crosses the boundary — the query fell back to
    # a fresh solve and the entry was quarantined
    assert answer.source == "solved" and solves[0] == 2
    assert answer.plan.verify().ok
    assert fr.points(ch, tmpl) == [] or all(
        p["plan"] is None or p["plan"].verify().ok
        for p in fr.points(ch, tmpl)
    )


def test_sweep_routes_through_frontier_o1_solves():
    ch, tmpl, fr = _chain(), _template(), _frontier()
    fracs = [0.4, 0.6, 0.8, 1.0]
    first = sweep(ch, fracs, tmpl, frontier=fr)
    solves = [0]
    # the same sweep again: every point answered from the stored frontier
    again = sweep(ch, fracs, tmpl, frontier=fr)
    assert solves[0] == 0
    for a, b in zip(first, again):
        assert a.feasible == b.feasible
        if a.feasible:
            assert a.plan.expected_time == b.plan.expected_time
    # an off-grid budget above the store-all peak interpolates for free
    wide = sweep(ch, [1.5, 2.5], tmpl, frontier=fr)
    assert all(p.feasible for p in wide)
    mid = fr.query(ch, tmpl, ch.store_all_peak() * 2.0)
    assert mid.source == "interpolated" and mid.solves == 0


def test_sweep_without_frontier_matches_with(tmp_path):
    ch, tmpl = _chain(), _template()
    fracs = [0.5, 0.75, 1.0]
    direct = sweep(ch, fracs, tmpl, use_frontier=False)
    warm = sweep(ch, fracs, tmpl, frontier=_frontier())
    for d, w in zip(direct, warm):
        assert d.feasible == w.feasible
        if d.feasible:
            assert d.plan.expected_time == w.plan.expected_time


def test_frontier_answers_match_direct_solve_property():
    @settings(max_examples=25, deadline=None)
    @given(
        seed=st.integers(0, 50),
        length=st.integers(2, 8),
        seed_fracs=st.lists(
            st.floats(0.2, 1.6), min_size=1, max_size=4, unique=True
        ),
        query_frac=st.floats(0.2, 1.6),
    )
    def prop(seed, length, seed_fracs, query_frac):
        ch = _chain(length, seed=seed)
        tmpl = PlanRequest(strategy="optimal", num_slots=24)
        fr = _frontier()
        peak = ch.store_all_peak()
        solves = [0]
        solve = _solver(ch, tmpl, solves)
        for frac in seed_fracs:
            fr.query(ch, tmpl, peak * frac, solve=solve)
        seeded = solves[0]
        answer = fr.query(ch, tmpl, peak * query_frac, solve=solve)
        # at most one refinement solve, whatever the frontier held
        assert solves[0] - seeded <= 1
        # never infeasible-when-feasible, never a worse (or better) time
        # than the direct solve: the frontier only saves work
        try:
            direct = build_plan(
                dataclasses.replace(
                    tmpl, budget=Budget.bytes(peak * query_frac)
                ),
                ch,
            )
        except InfeasiblePlanError:
            direct = None
        if direct is None:
            assert not answer.feasible
        else:
            assert answer.feasible
            rel = abs(answer.plan.expected_time - direct.expected_time)
            assert rel <= 1e-9 * max(direct.expected_time, 1.0)
            assert answer.plan.verify().ok

    prop()


def test_sweep_uses_the_default_store_frontier(monkeypatch):
    """Without ``frontier=``, ``sweep`` answers through the default store's
    frontier: the second identical sweep makes no solve."""
    from repro_torch.plan import api
    from repro_torch.store import config

    monkeypatch.setenv("REPRO_STORE", "memory://")
    config.reset()
    try:
        ch, tmpl = _chain(seed=3), _template()
        calls = [0]
        real = api.build_plan

        def counting(*a, **k):
            calls[0] += 1
            return real(*a, **k)

        monkeypatch.setattr(api, "build_plan", counting)
        fracs = [0.4, 0.55, 0.7, 0.85, 1.0]
        first = sweep(ch, fracs, tmpl)
        assert calls[0] == len(fracs)
        again = sweep(ch, fracs, tmpl)
        assert calls[0] == len(fracs), "the second sweep solved"
        for a, b in zip(first, again):
            assert a.feasible == b.feasible
            if a.feasible:
                assert a.plan.schedule.ops == b.plan.schedule.ops
        sweep(ch, fracs, tmpl, use_frontier=False)
        assert calls[0] == 2 * len(fracs)
    finally:
        config.reset()


@pytest.mark.parametrize("seed", range(4))
def test_frontier_answers_equal_jax(seed):
    """The same query sequence against both packages' frontiers gives the
    same source, solve count, feasibility, schedule and makespan."""
    arrays = _arrays(8, seed)
    ch, jch = Chain.make(**arrays), JChain.make(**arrays)
    tmpl = PlanRequest(strategy="optimal", num_slots=32)
    jtmpl = JRequest(strategy="optimal", num_slots=32)
    fr = _frontier()
    jfr = JFrontier(JObjectStore(JMemoryBackend()))

    def jsolve(budget):
        try:
            return jbuild(dataclasses.replace(
                jtmpl, budget=JBudget.bytes(budget)), jch)
        except JInfeasible:
            return None

    peak = ch.store_all_peak()
    assert peak == jch.store_all_peak()
    for frac in (0.5, 1.5, 2.5, 0.1, 0.05, 2.0, 0.75, 0.5, 0.6):
        got = fr.query(ch, tmpl, peak * frac, solve=_solver(ch, tmpl, [0]))
        want = jfr.query(jch, jtmpl, peak * frac, solve=jsolve)
        assert (got.source, got.solves, got.feasible) == (
            want.source, want.solves, want.feasible), frac
        if want.feasible:
            assert got.plan.schedule.ops == list(want.plan.schedule.ops)
            assert got.plan.expected_time == want.plan.expected_time
