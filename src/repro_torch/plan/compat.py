"""Policy strings → :class:`~repro_torch.plan.plan.MemoryPlan`: the one place
the policy grammar is parsed.

=====================  ====================================================
policy                 plan
=====================  ====================================================
``none``               store all (plain autograd)
``full``               checkpoint every stage
``periodic:K``         K equal segments (``checkpoint_sequential``)
``rotor:B``            the optimal persistent schedule within budget ``B``
                       (bytes, ``x0.6`` of the store-all peak, or ``auto``;
                       an infeasible ``auto`` budget falls back to the
                       min-memory schedule, any other raises)
``revolve:B``          the paper's revolve comparator within budget ``B``
                       (the same grammar and fallback): the same DP with
                       the ``F_all``-first branch off, so only bare
                       activations are checkpointed
``optimal_offload:B:BW``  the optimal three-tier (device / host / recompute)
                       schedule within device budget ``B``, with a host link
                       of ``BW`` bytes/s each way (a measured rate, e.g.
                       ``24e9``; ``0`` turns the host tier off and plans two
                       tiers).  ``BW`` is required: the port has no default
                       link.
=====================  ====================================================
"""

from __future__ import annotations

from typing import Callable, Optional, Union

from ..core.chain import Chain, HostTransferModel
from ..core.rematerialize import full_remat_tree, periodic_tree, sequential_tree
from ..core.solver import solve_min_memory, solve_optimal, tree_to_schedule
from ..offload.solver import solve_optimal_offload
from .plan import (DEFAULT_NUM_SLOTS, Budget, InfeasiblePlanError, MemoryPlan,
                   parse_size)


def _offload_spec(policy: str):
    """``(budget spec, host model or None)`` of ``optimal_offload:B:BW``."""
    parts = policy.split(":")
    if len(parts) != 3 or not parts[1].strip() or not parts[2].strip():
        raise ValueError(
            f"{policy!r}: the offload policy is 'optimal_offload:BUDGET:BW' "
            f"— a device budget and the host link's measured rate in bytes/s "
            f"(e.g. 'optimal_offload:x0.5:24e9'; BW=0 plans two tiers)")
    bw = parse_size(parts[2])
    return parts[1], (HostTransferModel(bandwidth_d2h=bw) if bw > 0
                      else None)


def resolve_policy(policy: str, chain: Optional[Chain],
                   length: Optional[int] = None,
                   num_slots: Optional[int] = None,
                   impl: Optional[str] = None,
                   auto_budget: Union[float, Callable[[], float], None] = None
                   ) -> MemoryPlan:
    """Resolve a policy string on a profiled chain (structural policies also
    take a bare ``length``)."""
    num_slots = DEFAULT_NUM_SLOTS if num_slots is None else num_slots
    if policy in ("none", "full") or policy.startswith("periodic:"):
        if chain is not None:
            length = chain.length
        if length is None:
            raise ValueError("need chain or length")
        if policy == "none":
            tree = sequential_tree(length)
        elif policy == "full":
            tree = full_remat_tree(length)
        else:
            spec = policy.split(":", 1)[1]
            try:
                k = int(spec)
            except ValueError:
                raise ValueError(f"periodic policy needs an integer segment "
                                 f"count, got {spec!r}") from None
            if k < 1:
                raise ValueError("periodic policy needs segments >= 1")
            tree = periodic_tree(length, k)
        return MemoryPlan.build(policy, chain, tree,
                                tree_to_schedule(tree, length),
                                num_slots=num_slots)
    offload = policy.startswith("optimal_offload")
    allow_fall = not policy.startswith("revolve:")
    if not (offload or policy.startswith("rotor:") or not allow_fall):
        raise ValueError(f"unknown remat policy {policy!r}")
    budget_spec, host = (_offload_spec(policy) if offload
                         else (policy.split(":", 1)[1], None))
    if chain is None:
        raise ValueError(f"{policy!r} needs a profiled chain")
    spec = Budget.parse(budget_spec)
    budget = spec.resolve(chain, auto_budget=auto_budget)
    if host is not None:
        chain = chain.with_host(host)
        sol = solve_optimal_offload(chain, budget, num_slots=num_slots,
                                    impl=impl)
    else:
        sol = solve_optimal(chain, budget, num_slots=num_slots,
                            allow_fall=allow_fall, impl=impl)
    if not sol.feasible and spec.kind == "auto" and not offload:
        sol = solve_min_memory(chain, num_slots=num_slots,
                               allow_fall=allow_fall, impl=impl)
        if sol.feasible:
            print(f"[plan] budget {budget / 2**30:.2f} GiB infeasible; "
                  f"min-memory schedule needs "
                  f"{sol.mem_limit / 2**30:.2f} GiB of activations",
                  flush=True)
            budget = sol.mem_limit
    if not sol.feasible:
        raise InfeasiblePlanError(
            f"{policy}: no feasible persistent schedule within "
            f"{budget:.3e} bytes for this chain")
    return MemoryPlan.build(policy, chain, sol.tree, sol.schedule, sol,
                            budget, num_slots,
                            "device+host" if host is not None else "device")
