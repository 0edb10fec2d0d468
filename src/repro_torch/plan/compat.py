"""Policy strings → :class:`~repro_torch.plan.PlanRequest`: the one place
the policy grammar is parsed (the port of ``repro.plan.compat``).

Each policy maps onto exactly one request (:func:`policy_to_request`), and
:func:`resolve_policy` resolves it through
:func:`~repro_torch.plan.build_plan`:

=========================  ================================================
policy                     request
=========================  ================================================
``none``                   ``strategy="store_all"`` (plain autograd)
``full``                   ``strategy="full_remat"``
``periodic:K``             ``strategy="periodic", segments=K``
                           (``checkpoint_sequential``)
``rotor:B``                ``strategy="optimal", budget=Budget.parse(B)``
                           (bytes, ``x0.6`` of the store-all peak, or
                           ``auto``: an infeasible ``auto`` budget falls
                           back to the min-memory schedule, any other
                           raises)
``revolve:B``              ``strategy="revolve"`` (the same DP with the
                           ``F_all``-first branch off, so only bare
                           activations are checkpointed), the same grammar
                           and fallback
``optimal_offload:B:BW``   ``strategy="optimal", tiers=("device",
                           "host")``, the host link ``BW`` bytes/s each way
                           (a measured rate, e.g. ``24e9``; ``0`` turns the
                           host tier off: ``tiers=("device",)``).  ``BW``
                           is required: the port has no default link.
=========================  ================================================
"""

from __future__ import annotations

from typing import Callable, Optional, Union

from ..core.chain import Chain, HostTransferModel
from .api import build_plan
from .plan import MemoryPlan
from .request import Budget, PlanRequest, parse_size

#: Every documented policy form.
DOCUMENTED_POLICIES = ("none", "full", "periodic:K", "rotor:BUDGET",
                       "revolve:BUDGET", "optimal_offload:BUDGET:BW")


def policy_to_request(policy: str, num_slots: Optional[int] = None,
                      impl: Optional[str] = None) -> PlanRequest:
    """The translation table (module docstring): one policy string → one
    typed request.  ``num_slots`` and ``impl`` ride along unchanged;
    :class:`PlanRequest` validates ``impl`` against the port's fills."""
    kw = dict(num_slots=num_slots, impl=impl)
    if policy == "none":
        return PlanRequest(strategy="store_all", **kw)
    if policy == "full":
        return PlanRequest(strategy="full_remat", **kw)
    if policy.startswith("periodic:"):
        spec = policy.split(":", 1)[1]
        try:
            k = int(spec)
        except ValueError:
            raise ValueError(f"periodic policy needs an integer segment "
                             f"count, got {spec!r}") from None
        return PlanRequest(strategy="periodic", segments=k, **kw)
    if policy.startswith(("rotor:", "revolve:")):
        kind, spec = policy.split(":", 1)
        budget = Budget.parse(spec)
        return PlanRequest(
            strategy="optimal" if kind == "rotor" else "revolve",
            budget=budget,
            on_infeasible="min_memory" if budget.kind == "auto" else "raise",
            **kw)
    if policy.startswith("optimal_offload"):
        parts = policy.split(":")
        if len(parts) != 3 or not parts[1].strip() or not parts[2].strip():
            raise ValueError(
                f"{policy!r}: the offload policy is "
                f"'optimal_offload:BUDGET:BW' — a device budget and the host "
                f"link's measured rate in bytes/s (e.g. "
                f"'optimal_offload:x0.5:24e9'; BW=0 plans two tiers)")
        budget = Budget.parse(parts[1])
        bw = parse_size(parts[2])
        if bw > 0:
            return PlanRequest(strategy="optimal", budget=budget,
                               tiers=("device", "host"),
                               host=HostTransferModel(bandwidth_d2h=bw), **kw)
        # zero host bandwidth: the third tier does not exist
        return PlanRequest(strategy="optimal", budget=budget, **kw)
    raise ValueError(f"unknown remat policy {policy!r}")


def resolve_policy(policy: str, chain: Optional[Chain],
                   length: Optional[int] = None,
                   num_slots: Optional[int] = None,
                   impl: Optional[str] = None,
                   auto_budget: Union[float, Callable[[], float], None] = None
                   ) -> MemoryPlan:
    """Resolve a policy string on a profiled chain (structural policies also
    take a bare ``length``): :func:`policy_to_request` then
    :func:`~repro_torch.plan.build_plan`."""
    request = policy_to_request(policy, num_slots=num_slots, impl=impl)
    if request.strategy in ("optimal", "revolve") and chain is None:
        raise ValueError(f"{policy!r} needs a profiled chain")
    return build_plan(request, chain, length=length, auto_budget=auto_budget,
                      policy=policy)
