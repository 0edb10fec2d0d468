"""``build_plan`` (request → plan) and ``sweep`` (the time-vs-budget
frontier) — the port of ``repro.plan.api``.

``build_plan`` is the one place a planning decision is made: it resolves
the budget, picks the solver from the tier registry, runs it, applies the
infeasibility policy and wraps the result into a
:class:`~repro_torch.plan.plan.MemoryPlan` with simulator-exact predicted
numbers.  The policy strings (:mod:`.compat`), the launcher, the train and
serve paths and the trade-off only ever hand it requests.

The port has no solver cache or plan store yet, so every call solves, and
:func:`sweep` answers each point by a solve unless a ``frontier`` object is
passed in.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, List, Optional, Sequence, Union

from ..core.chain import Chain
from ..core.schedule import Schedule, simulate
from ..core.solver import Solution, tree_to_schedule
from .plan import InfeasiblePlanError, MemoryPlan, chain_fingerprint
from .registry import solver_for
from .request import STRUCTURAL_STRATEGIES, Budget, PlanRequest


def _structural_tree(request: PlanRequest, length: int):
    from ..core.rematerialize import (full_remat_tree, periodic_tree,
                                      sequential_tree)
    if request.strategy == "store_all":
        return sequential_tree(length)
    if request.strategy == "full_remat":
        return full_remat_tree(length)
    return periodic_tree(length, request.segments)


def _resolve_host(request: PlanRequest, chain: Chain) -> Chain:
    """For a host-backed tier (``"host"`` for training activations, ``"kv"``
    for serving-time KV blocks), attach the link: the request's, else the
    chain's.  The port keeps no default link."""
    if not {"host", "kv"} & set(request.tiers):
        return chain
    host = request.host or chain.host
    if host is None:
        raise ValueError(
            f"tiers {'+'.join(request.tiers)!r} need the host link's "
            f"measured rate: pass PlanRequest(host=HostTransferModel(...)) "
            f"or a chain priced with one (the port has no default link)")
    return chain.with_host(host)


def _finalize(request: PlanRequest, chain: Optional[Chain], tree,
              schedule: Schedule, solution: Optional[Solution],
              budget_bytes: Optional[float], policy: Optional[str],
              fallback: bool = False) -> MemoryPlan:
    nan = float("nan")
    expected, peak_dev, peak_host, stall = nan, nan, nan, nan
    chain_hash = None
    if chain is not None:
        res = simulate(chain, schedule)
        if not res.valid:
            raise AssertionError(
                f"planned schedule does not simulate: {res.error}")
        expected, peak_dev = res.time, res.peak_mem
        peak_host, stall = res.host_peak_mem, res.transfer_stall
        chain_hash = chain_fingerprint(chain)
    plan = MemoryPlan(request=request, schedule=schedule, tree=tree,
                      solution=solution, chain=chain, chain_hash=chain_hash,
                      budget_bytes=budget_bytes, expected_time=expected,
                      peak_device_mem=peak_dev, peak_host_mem=peak_host,
                      transfer_stall=stall, policy=policy,
                      fallback=fallback)
    if os.environ.get("REPRO_CHECK") == "1":
        plan._verify_or_raise("refusing to return an invalid plan")
    return plan


def build_plan(request: PlanRequest, chain: Optional[Chain] = None, *,
               length: Optional[int] = None,
               auto_budget: Union[float, Callable[[], float], None] = None,
               policy: Optional[str] = None) -> MemoryPlan:
    """Resolve a :class:`PlanRequest` into a :class:`MemoryPlan`.

    Structural strategies (``store_all``/``full_remat``/``periodic``) take a
    bare ``length`` when no profiled chain is at hand (the plan's predicted
    numbers are then NaN).  Solver strategies need ``chain``; ``auto``
    budgets also need ``auto_budget`` (a float or a zero-argument callable
    from the launch path).  ``policy`` tags the plan with the policy string
    it came from (:mod:`.compat`) and heads the infeasibility message.

    Raises :class:`InfeasiblePlanError` when no feasible schedule exists and
    ``request.on_infeasible == "raise"``; with ``"min_memory"`` it falls
    back to the smallest-memory feasible schedule (reporting its budget).
    Under ``REPRO_CHECK=1`` every plan is verified before it is returned
    (:meth:`MemoryPlan.verify`; ``PlanVerificationError`` if it fails).
    """
    num_slots = request.resolved_num_slots

    if request.strategy in STRUCTURAL_STRATEGIES:
        if chain is not None:
            length = chain.length
        if length is None:
            raise ValueError("need chain or length")
        tree = _structural_tree(request, length)
        schedule = tree_to_schedule(tree, length)
        return _finalize(request, chain, tree, schedule, None, None, policy)

    if chain is None:
        raise ValueError(f"strategy {request.strategy!r} needs a profiled "
                         f"chain")
    entry = solver_for(request.tiers)
    hchain = _resolve_host(request, chain)

    if request.strategy == "min_memory":
        sol = entry.solve_min(hchain, num_slots=num_slots,
                              allow_fall=request.allow_fall,
                              impl=request.impl)
        if not sol.feasible:
            raise InfeasiblePlanError(
                f"no feasible persistent schedule exists for this chain at "
                f"any budget (tiers {'+'.join(request.tiers)})")
        return _finalize(request, hchain, sol.tree, sol.schedule, sol,
                         sol.mem_limit, policy)

    if request.budget is None:
        raise ValueError(f"strategy {request.strategy!r} needs a budget")
    budget = request.budget.resolve(chain, auto_budget=auto_budget)
    sol = entry.solve(hchain, budget, num_slots=num_slots,
                      allow_fall=request.allow_fall, impl=request.impl)
    if not sol.feasible:
        if request.on_infeasible == "min_memory":
            least = entry.solve_min(hchain, num_slots=num_slots,
                                    allow_fall=request.allow_fall,
                                    impl=request.impl)
            if least.feasible:
                print(f"[plan] budget {budget / 2**30:.2f} GiB infeasible; "
                      f"min-memory schedule needs "
                      f"{least.mem_limit / 2**30:.2f} GiB of activations",
                      flush=True)
                return _finalize(request, hchain, least.tree, least.schedule,
                                 least, least.mem_limit, policy,
                                 fallback=True)
        tiers = "+".join(request.tiers)
        raise InfeasiblePlanError(
            f"{policy or request.strategy}: no feasible persistent schedule "
            f"within {budget:.3e} bytes for this chain (tiers {tiers})")
    return _finalize(request, hchain, sol.tree, sol.schedule, sol, budget,
                     policy)


def two_tier_fallback(plan: MemoryPlan, chain: Optional[Chain] = None
                      ) -> MemoryPlan:
    """The best plan without host copies for an offload-bearing plan: the
    two-tier optimum at the same device budget, degrading to the min-memory
    schedule where that budget does not fit two tiers."""
    if not plan.uses_offload:
        return plan
    chain = chain if chain is not None else plan.chain
    request = dataclasses.replace(
        plan.request, tiers=("device",), host=None,
        budget=Budget.bytes(plan.solution.mem_limit),
        on_infeasible="min_memory")
    return build_plan(request, chain, policy=plan.policy)


@dataclasses.dataclass
class SweepPoint:
    """One point of a time-vs-budget frontier: ``plan`` is None when the
    budget is infeasible for the requested strategy/tiers."""
    fraction: float
    budget_bytes: float
    plan: Optional[MemoryPlan]

    @property
    def feasible(self) -> bool:
        return self.plan is not None


def sweep(chain: Chain, fractions: Sequence[float],
          request: Optional[PlanRequest] = None, *,
          store_all_peak: Optional[float] = None,
          frontier: Optional[Any] = None) -> List[SweepPoint]:
    """The time-vs-budget frontier: one plan per budget fraction of the
    store-all peak (an infeasible point has ``plan=None`` instead of
    raising).  ``request`` is the template — its ``budget`` is replaced per
    point; it defaults to the two-tier optimal strategy.  ``frontier``, if
    given, answers points through its ``query(chain, request, budget,
    solve=)``, as the JAX package's warm-start frontier does; without one,
    every point solves."""
    if request is None:
        request = PlanRequest(strategy="optimal")
    if store_all_peak is None:
        store_all_peak = chain.store_all_peak()

    def _solve(budget: float) -> Optional[MemoryPlan]:
        req = dataclasses.replace(request, budget=Budget.bytes(budget),
                                  on_infeasible="raise")
        try:
            return build_plan(req, chain)
        except InfeasiblePlanError:
            return None

    points: List[SweepPoint] = []
    for frac in fractions:
        budget = store_all_peak * frac
        if frontier is not None:
            plan = frontier.query(chain, request, budget, solve=_solve).plan
        else:
            plan = _solve(budget)
        points.append(SweepPoint(float(frac), budget, plan))
    return points


def min_memory_plan(chain: Chain, *, tiers: Sequence[str] = ("device",),
                    num_slots: Optional[int] = None,
                    impl: Optional[str] = None) -> MemoryPlan:
    """The smallest-feasible-budget plan for a tier combination (the memory
    floor; with the host tier, priced by the chain's link, it drops below
    the two-tier floor)."""
    request = PlanRequest(strategy="min_memory", tiers=tuple(tiers),
                          num_slots=num_slots, impl=impl)
    return build_plan(request, chain)
