"""The memory-planning API — the port of ``repro.plan``.

A typed :class:`PlanRequest` (strategy, budget as bytes / fraction /
auto, storage tiers, host link, slot discretization, DP fill) resolves
through :func:`build_plan` into a :class:`MemoryPlan`: the schedule, the
recursion tree, the solver's solution, the simulator's predicted makespan
and peaks, the static verifier (:meth:`MemoryPlan.verify`) and the
executor binding (:meth:`MemoryPlan.bind` / :meth:`MemoryPlan.execute`).
:func:`sweep` gives the time-vs-budget frontier, :func:`min_memory_plan`
the floor of a tier combination; :mod:`.registry` maps tier combinations
to solvers.  The policy strings (``"rotor:x0.6"``, ...) map onto requests
in :mod:`.compat`, the one place they are parsed.
"""

from ..check import PlanVerificationError
from .api import (SweepPoint, build_plan, min_memory_plan, sweep,
                  two_tier_fallback)
from .compat import DOCUMENTED_POLICIES, policy_to_request, resolve_policy
from .plan import BoundPlan, InfeasiblePlanError, MemoryPlan
from .registry import (SolverEntry, available_solvers, register_solver,
                       solver_for)
from .request import (DEFAULT_NUM_SLOTS, SOLVER_STRATEGIES,
                      STRUCTURAL_STRATEGIES, Budget, PlanRequest, parse_size)

__all__ = [
    "Budget", "PlanRequest", "MemoryPlan", "BoundPlan", "SweepPoint",
    "SolverEntry", "InfeasiblePlanError", "PlanVerificationError",
    "build_plan", "sweep", "min_memory_plan", "two_tier_fallback",
    "register_solver", "solver_for", "available_solvers",
    "DOCUMENTED_POLICIES", "policy_to_request", "resolve_policy",
    "parse_size", "DEFAULT_NUM_SLOTS", "SOLVER_STRATEGIES",
    "STRUCTURAL_STRATEGIES",
]
