"""Warm-start frontier: persisted ``sweep()`` results that answer *any*
budget query with at most one refinement solve.

The paper's DP returns, for one chain, the optimal makespan as a function
of the memory budget — a non-increasing step function ``t*(B)``.  A sweep
samples that frontier at a handful of budgets; this module persists those
samples (keyed chain × request-template × code, like every store entry)
and exploits two exact monotonicity facts to answer later queries without
re-running the fill:

- **feasibility is monotone**: if budget ``b`` is infeasible, every
  ``B <= b`` is infeasible — recorded infeasible points answer all queries
  at or below them with zero solves;
- **makespan is non-increasing and bracketable**: for a queried ``B``
  between recorded feasible budgets ``b_lo <= B <= b_hi`` with *equal*
  optimal times, ``t*(B)`` is pinched to that same value, and the
  ``b_lo`` plan (peak ``<= b_lo <= B``) achieves it — so the stored plan
  *is* the optimum at ``B``, returned with zero solves ("interpolation").

Any query the two facts do not decide costs exactly one refinement solve,
whose result is folded back into the stored frontier — the frontier only
ever gets denser.  Plans served from the frontier are statically verified
(:meth:`repro_torch.plan.MemoryPlan.verify`) before they are handed out; an
entry that fails is quarantined and the query falls back to a fresh solve.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from ..obs import metrics as _metrics

from .keys import FRONTIER_NAMESPACE, PlanKey, request_digest
from .objects import ObjectStore

_ENTRY_VERSION = 1
_KIND = "frontier"

#: Relative tolerance for "same budget" / "same optimal time".  Budgets and
#: DP makespans are float64 arithmetic on identical inputs, so true
#: revisits compare exactly; the epsilon only absorbs benign re-resolution
#: noise (e.g. ``peak * frac`` computed in a different order).
_REL_TOL = 1e-12


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= _REL_TOL * max(abs(a), abs(b), 1.0)


def template_digest(request) -> str:
    """The request digest with the budget blanked — all sweep points of one
    template share it, whatever their per-point budget."""
    return request_digest(
        dataclasses.replace(request, budget=None, on_infeasible="raise")
    )


@dataclasses.dataclass
class FrontierAnswer:
    """One answered budget query: the plan (None = provably infeasible),
    how many refinement solves it cost, and how it was decided
    (``exact`` / ``interpolated`` / ``infeasible`` / ``solved``)."""

    plan: Optional[Any]
    solves: int
    source: str

    @property
    def feasible(self) -> bool:
        return self.plan is not None


class WarmStartFrontier:
    """Persisted time-vs-budget frontier over an :class:`ObjectStore`."""

    def __init__(self, store: ObjectStore,
                 namespace: str = FRONTIER_NAMESPACE):
        self.store = store
        self.namespace = namespace

    # -- storage -----------------------------------------------------------

    def _key(self, chain, request) -> str:
        pk = PlanKey.for_plan(chain, request)
        return dataclasses.replace(
            pk, request=template_digest(request)
        ).key(self.namespace)

    def _load(self, key: str) -> List[Dict[str, Any]]:
        entry = self.store.get(key, kind=_KIND)
        if (
            not isinstance(entry, dict)
            or entry.get("version") != _ENTRY_VERSION
            or not isinstance(entry.get("points"), list)
        ):
            return []
        return entry["points"]

    def _save(self, key: str, points: List[Dict[str, Any]]) -> None:
        points.sort(key=lambda p: p["budget_bytes"])
        self.store.put(
            key, {"version": _ENTRY_VERSION, "points": points}, kind=_KIND
        )

    def points(self, chain, request) -> List[Dict[str, Any]]:
        """The recorded ``{"budget_bytes", "feasible", "expected_time",
        "plan"}`` points for this chain × request template (sorted)."""
        return self._load(self._key(chain, request))

    def _merge(self, points: List[Dict[str, Any]], budget: float,
               plan: Optional[Any]) -> List[Dict[str, Any]]:
        kept = [p for p in points if not _close(p["budget_bytes"], budget)]
        kept.append({
            "budget_bytes": float(budget),
            "feasible": plan is not None,
            "expected_time": None if plan is None else plan.expected_time,
            "plan": plan,
        })
        return kept

    def record(self, chain, request, sweep_points) -> str:
        """Fold a sweep's points (objects with ``budget_bytes`` / ``plan``,
        e.g. :class:`repro_torch.plan.SweepPoint`) into the stored frontier;
        returns the store key."""
        key = self._key(chain, request)
        points = self._load(key)
        for sp in sweep_points:
            points = self._merge(points, sp.budget_bytes, sp.plan)
        self._save(key, points)
        return key

    def record_point(self, chain, request, budget_bytes: float,
                     plan: Optional[Any]) -> str:
        key = self._key(chain, request)
        self._save(key, self._merge(self._load(key), budget_bytes, plan))
        return key

    # -- queries -----------------------------------------------------------

    def _serve(self, point: Dict[str, Any], key: str) -> Optional[Any]:
        """A stored plan, verified before crossing back into the caller;
        None (after quarantining the entry) when verification fails."""
        plan = point.get("plan")
        if plan is None:
            return None
        report = plan.verify()
        if not report.ok:
            self.store.backend.quarantine(key)
            return None
        return plan

    def query(self, chain, request, budget_bytes: float, *,
              solve: Optional[Callable[[float], Optional[Any]]] = None,
              ) -> FrontierAnswer:
        """Answer one budget query from the stored frontier.

        Decides from recorded points when the monotonicity facts allow it
        (zero solves); otherwise runs ``solve(budget_bytes)`` — which must
        return a plan or None for infeasible — exactly once and records the
        result.  With ``solve=None`` an undecidable query returns
        ``FrontierAnswer(None, 0, "unknown")``.
        """
        budget = float(budget_bytes)
        key = self._key(chain, request)
        points = self._load(key)

        exact = next(
            (p for p in points if _close(p["budget_bytes"], budget)), None
        )
        if exact is not None:
            if not exact["feasible"]:
                return FrontierAnswer(None, 0, "exact")
            plan = self._serve(exact, key)
            if plan is not None:
                return FrontierAnswer(plan, 0, "exact")
            points = []  # quarantined: below logic must not reuse it

        infeasible_above = [
            p["budget_bytes"] for p in points
            if not p["feasible"] and p["budget_bytes"] >= budget
        ]
        if infeasible_above:
            return FrontierAnswer(None, 0, "infeasible")

        feas = [p for p in points if p["feasible"]]
        lower = [p for p in feas if p["budget_bytes"] <= budget]
        upper = [p for p in feas if p["budget_bytes"] >= budget]
        if lower and upper:
            lo = max(lower, key=lambda p: p["budget_bytes"])
            hi = min(upper, key=lambda p: p["budget_bytes"])
            if _close(lo["expected_time"], hi["expected_time"]):
                plan = self._serve(lo, key)
                if plan is not None:
                    return FrontierAnswer(plan, 0, "interpolated")

        if solve is None:
            return FrontierAnswer(None, 0, "unknown")
        plan = solve(budget)
        _metrics.counter("frontier.solves").inc()
        self.record_point(chain, request, budget, plan)
        return FrontierAnswer(plan, 1, "solved")
