"""Back-compat shim: remat policy *strings* → :mod:`repro_torch.plan`
requests (the port of ``repro.core.policies``).

The planning surface is :mod:`repro_torch.plan` — a typed
:class:`~repro_torch.plan.PlanRequest` in, an inspectable, serializable
:class:`~repro_torch.plan.MemoryPlan` out.  This module keeps the string
grammar working: every string maps onto exactly one request
(:func:`repro_torch.plan.compat.policy_to_request`) and resolves through the
one path :func:`repro_torch.plan.compat.resolve_policy`; no policy prefix is
dispatched outside :mod:`repro_torch.plan`.

``make_policy_tree(policy, chain)`` takes the documented forms
(``DOCUMENTED_POLICIES``): ``none``, ``full``, ``periodic:K``,
``rotor:BUDGET``, ``revolve:BUDGET`` and ``optimal_offload:BUDGET:BW`` (the
host link's measured rate is required: the port has no default link;
``BW = 0`` plans two tiers).  The tree feeds
:func:`repro_torch.core.rematerialize.build_remat_fn`, which is why
``make_policy_tree`` refuses a plan that copies activations to the host
(nested checkpointing cannot express the copies): use
:func:`make_policy_plan` (or :func:`repro_torch.plan.build_plan`) and run
the plan through ``plan.bind(...)`` or the offload walker instead.

Solver-backed policies are memoized through
:mod:`repro_torch.core.solver_cache`: resolving the same policy on the same
chain returns the cached ``Solution`` without filling DP tables.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..plan import MemoryPlan
from ..plan.compat import (DOCUMENTED_POLICIES, parse_budget,
                           policy_to_request, resolve_policy)
from .chain import Chain
from .schedule import Schedule
from .solver import Solution, Tree

__all__ = ["DOCUMENTED_POLICIES", "PolicyPlan", "make_policy_plan",
           "make_policy_tree", "parse_budget", "policy_to_request",
           "resolve_policy"]


@dataclasses.dataclass
class PolicyPlan:
    """A resolved policy (a back-compat wrapper of :class:`MemoryPlan`):
    the recursion tree (when the plan is expressible as nested remat) and
    the op schedule (always).  ``uses_offload`` marks plans that need the
    offload walker; ``plan`` is the underlying planning artifact."""

    policy: str
    tree: Optional[Tree]
    schedule: Optional[Schedule]
    solution: Optional[Solution]
    chain: Optional[Chain]
    uses_offload: bool = False
    plan: Optional[MemoryPlan] = None


def make_policy_plan(policy: str, chain: Optional[Chain],
                     length: Optional[int] = None,
                     num_slots: Optional[int] = None,
                     impl: Optional[str] = None) -> PolicyPlan:
    """Resolve any policy string — ``optimal_offload`` included — into a
    :class:`PolicyPlan`."""
    plan = resolve_policy(policy, chain, length=length, num_slots=num_slots,
                          impl=impl)
    return PolicyPlan(policy, plan.tree, plan.schedule, plan.solution,
                      plan.chain, uses_offload=plan.uses_offload, plan=plan)


def make_policy_tree(policy: str, chain: Optional[Chain],
                     length: Optional[int] = None,
                     num_slots: Optional[int] = None,
                     impl: Optional[str] = None) -> Tree:
    """Resolve a policy string into a remat-expressible recursion tree
    (raises for a plan that needs the host tier: nested checkpointing cannot
    run it)."""
    plan = resolve_policy(policy, chain, length=length, num_slots=num_slots,
                          impl=impl)
    if plan.uses_offload:
        raise ValueError(
            f"{policy!r} resolved to a host-offload plan, which nested "
            f"remat cannot express — use make_policy_plan() and run its plan "
            f"through plan.bind(...) or repro_torch.offload.executor")
    return plan.tree
