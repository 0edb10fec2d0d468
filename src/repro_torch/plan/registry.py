"""Storage-tier combinations → solver entry points — the port of
``repro.plan.registry``.

A :class:`SolverEntry` gives a budgeted solve and a minimum-memory solve
for one tier combination, keyed by the ``"+"``-joined tier tuple
(``"device"``, ``"device+host"``, ``"device+kv"``).
:func:`repro_torch.plan.build_plan` looks the entry up from
``PlanRequest.tiers``; a new tier or planning backend plugs in through
:func:`register_solver`.

The built-in entries wrap the port's two-tier DP
(:func:`repro_torch.core.solver.solve_optimal` / ``solve_min_memory``) and
its three-tier offload DP
(:func:`repro_torch.offload.solver.solve_optimal_offload` /
``solve_min_device_memory``); the serving tier reuses the latter.  The
solver modules are imported when an entry is called, not when it is
registered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

# solve(chain, budget_bytes, *, num_slots, allow_fall, impl) -> Solution
SolveFn = Callable[..., "object"]
# solve_min(chain, *, num_slots, allow_fall, impl) -> Solution
SolveMinFn = Callable[..., "object"]


@dataclasses.dataclass(frozen=True)
class SolverEntry:
    key: str
    solve: SolveFn
    solve_min: SolveMinFn
    description: str = ""


_REGISTRY: Dict[str, SolverEntry] = {}


def tier_key(tiers: Sequence[str]) -> str:
    """Canonical registry key for a tier combination."""
    return "+".join(tiers)


def register_solver(key: str, solve: SolveFn, solve_min: SolveMinFn,
                    description: str = "", overwrite: bool = False
                    ) -> SolverEntry:
    """Register a solver for a tier combination."""
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"solver for tiers {key!r} already registered; "
                         f"pass overwrite=True to replace it")
    entry = SolverEntry(key, solve, solve_min, description)
    _REGISTRY[key] = entry
    return entry


def solver_for(tiers: Sequence[str]) -> SolverEntry:
    key = tier_key(tiers)
    entry = _REGISTRY.get(key)
    if entry is None:
        raise ValueError(
            f"no solver registered for storage tiers {key!r}; known combos: "
            f"{sorted(_REGISTRY)} (see repro_torch.plan.registry"
            f".register_solver)")
    return entry


def available_solvers() -> Dict[str, SolverEntry]:
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# built-in entries
# ---------------------------------------------------------------------------

def _two_tier_solve(chain, budget: float, *, num_slots: int, allow_fall: bool,
                    impl: Optional[str]):
    from ..core.solver import solve_optimal
    return solve_optimal(chain, budget, num_slots=num_slots,
                         allow_fall=allow_fall, impl=impl)


def _two_tier_solve_min(chain, *, num_slots: int, allow_fall: bool,
                        impl: Optional[str]):
    from ..core.solver import solve_min_memory
    return solve_min_memory(chain, num_slots=num_slots,
                            allow_fall=allow_fall, impl=impl)


def _three_tier_solve(chain, budget: float, *, num_slots: int,
                      allow_fall: bool, impl: Optional[str]):
    from ..offload.solver import solve_optimal_offload
    return solve_optimal_offload(chain, budget, num_slots=num_slots,
                                 allow_fall=allow_fall, impl=impl)


def _three_tier_solve_min(chain, *, num_slots: int, allow_fall: bool,
                          impl: Optional[str]):
    from ..offload.solver import solve_min_device_memory
    return solve_min_device_memory(chain, num_slots=num_slots,
                                   allow_fall=allow_fall, impl=impl)


register_solver(
    "device", _two_tier_solve, _two_tier_solve_min,
    "paper two-tier DP (device activations + device full-history residuals)")
register_solver(
    "device+host", _three_tier_solve, _three_tier_solve_min,
    "three-tier DP with asynchronous host-RAM activation offload")
register_solver(
    "device+kv", _three_tier_solve, _three_tier_solve_min,
    "serving-path KV-cache residency: per-layer decode KV blocks as chain "
    "activations, staged to pinned host RAM over the measured link (the "
    "three-tier offload DP; see repro_torch.plan.serving)")
