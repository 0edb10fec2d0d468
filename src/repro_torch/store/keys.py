"""Content addressing for plans and solutions.

A plan is fully identified by three fingerprints:

- **chain** — :func:`repro_torch.core.solver_cache.chain_fingerprint`: the
  profiled cost/size arrays + host link of the chain being planned;
- **request** — :func:`request_digest`: a canonical hash of the
  :class:`repro_torch.plan.PlanRequest` (strategy, budget, tiers, slots, impl,
  fallback policy);
- **code** — :func:`repro_torch.core.solver_cache.code_fingerprint`: the solver
  implementation sources, so a solver fix invalidates every stale entry
  fleet-wide without any version bookkeeping.

:class:`PlanKey` bundles the three, renders the store key
(``<namespace>/<chain>.<request>.<code>``), and — for staleness
diagnostics — names exactly which component diverged between two keys
(:meth:`PlanKey.diff`), which is what `MemoryPlan.load` reports instead of
a bare "hash mismatch".
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional

from ..core import solver_cache as _sc

#: Hex digits of each fingerprint kept in rendered store keys (96 bits per
#: component — collision-safe for fleet-scale stores, short enough for one
#: filename).
KEY_HEX = 24
PLAN_NAMESPACE = "plans"
FRONTIER_NAMESPACE = "frontiers"


def request_digest(request) -> str:
    """Canonical content hash of a :class:`repro_torch.plan.PlanRequest`.

    Hashes the *semantic* fields only, each tagged by name so field
    reordering can't alias two requests.  ``num_slots`` is hashed resolved
    (``None`` → the default) so an explicit ``num_slots=500`` and the
    default are the same request — they produce bit-identical plans.
    """
    h = hashlib.sha256()
    h.update(b"repro-plan-request\0")
    budget = request.budget
    parts = [
        ("strategy", request.strategy),
        ("budget.kind", "none" if budget is None else budget.kind),
        ("budget.value",
         "" if budget is None or budget.kind == "auto"
         else repr(float(budget.value))),
        ("segments", str(request.segments)),
        ("tiers", "+".join(request.tiers)),
        ("num_slots", str(request.resolved_num_slots)),
        ("impl", request.impl or ""),
        ("on_infeasible", request.on_infeasible),
    ]
    if request.host is None:
        parts.append(("host", "chain-default"))
    else:
        parts.append(("host", repr((
            float(request.host.bandwidth_d2h),
            None if request.host.bandwidth_h2d is None
            else float(request.host.bandwidth_h2d),
            float(request.host.latency),
        ))))
    for name, value in parts:
        h.update(f"{name}={value}".encode())
        h.update(b"\0")
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """The chain × request × code content address of a plan."""

    chain: str
    request: str
    code: str

    @staticmethod
    def for_plan(chain, request, *, code: Optional[str] = None) -> "PlanKey":
        return PlanKey(
            chain=_sc.chain_fingerprint(chain),
            request=request_digest(request),
            code=code if code is not None else _sc.code_fingerprint(),
        )

    def key(self, namespace: str = PLAN_NAMESPACE) -> str:
        return (
            f"{namespace}/{self.chain[:KEY_HEX]}"
            f".{self.request[:KEY_HEX]}.{self.code[:KEY_HEX]}"
        )

    def diff(self, other: "PlanKey") -> List[str]:
        """Which fingerprint components diverge (``chain`` / ``request`` /
        ``code``) — the staleness diagnosis surfaced by plan loads."""
        out = []
        for component in ("chain", "request", "code"):
            a, b = getattr(self, component), getattr(other, component)
            # compare on the shorter prefix so a rendered (truncated) key
            # can be diffed against a freshly computed full-width one
            n = min(len(a), len(b))
            if a[:n] != b[:n] or n == 0:
                out.append(component)
        return out
