"""The :class:`MemoryPlan` artifact and its executor binding
(:class:`BoundPlan`) — the port of ``repro.plan.plan``, without the store
(``save``/``load`` come with the plan store).

A plan carries the op :class:`~repro_torch.core.schedule.Schedule`, the
recursion tree (run as nested checkpoints, or by the eager walker when it
holds offload nodes), the solver :class:`~repro_torch.core.solver.Solution`
(solver-backed strategies), the :class:`~repro_torch.plan.request.PlanRequest`
it answers, the chain's content hash, and the float64 simulator's
predicted makespan, device and host peaks and transfer stall (NaN without
a profiled chain).  It answers:

- *is it sound?* — :meth:`MemoryPlan.verify`, the static verifier
  (:mod:`repro_torch.check`); under ``REPRO_CHECK=1``, ``build_plan``
  runs it on every plan it returns and ``bind``/``execute`` before they
  run, and each refuses a plan that fails (the JAX package gates only
  ``bind``/``execute``, and its store's ``save``/``load``);
- *how do I run it?* — :meth:`MemoryPlan.bind` (nested checkpoints, or the
  walker for offload plans; with ``tracer=`` always the walker, one span
  per op) and :meth:`MemoryPlan.execute` (the walker);
- *what does it cost, and did it?* — :meth:`summary`, :meth:`stats`,
  :meth:`timeline`, and :meth:`drift` of a trace against the prediction.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.chain import Chain
from ..core.schedule import Schedule, simulate, uses_offload
from ..core.solver import Solution
from .request import PlanRequest


class InfeasiblePlanError(MemoryError):
    """No feasible schedule exists for the request (budget too small)."""


def chain_fingerprint(chain: Chain) -> str:
    """Content hash of a chain: every cost and size array and the host link
    (the JAX package's ``solver_cache.chain_fingerprint``, byte for byte)."""
    h = hashlib.sha256()
    h.update(b"repro-chain\0")
    for arr in (chain.uf, chain.ub, chain.wa, chain.wabar, chain.wdelta,
                chain.of, chain.ob):
        h.update(np.ascontiguousarray(arr, dtype=np.float64).tobytes())
        h.update(b"\0")
    host = chain.host
    if host is None:
        h.update(b"nohost")
    else:
        h.update(np.array(
            [host.bandwidth_d2h,
             -1.0 if host.bandwidth_h2d is None else host.bandwidth_h2d,
             host.latency], dtype=np.float64).tobytes())
    return h.hexdigest()




@dataclasses.dataclass
class MemoryPlan:
    """A resolved memory plan for one chain (built by
    :func:`~repro_torch.plan.build_plan`).

    ``tree`` is the recursion tree (two-tier nodes, plus
    :class:`~repro_torch.offload.solver.OffNode` for host-tier plans);
    ``schedule`` the equivalent flat op sequence.  ``expected_time`` and the
    peaks are float64-simulator numbers (NaN for a plan built from a bare
    length); ``policy`` is the policy string the plan came from, if any;
    ``fallback`` marks the min-memory schedule that ``on_infeasible=
    "min_memory"`` put in place of an infeasible budget.
    """

    request: PlanRequest
    schedule: Schedule
    tree: Optional[Any]
    solution: Optional[Solution]
    chain: Optional[Chain]
    chain_hash: Optional[str]
    budget_bytes: Optional[float]
    expected_time: float
    peak_device_mem: float
    peak_host_mem: float
    transfer_stall: float
    policy: Optional[str] = None
    # the min-memory schedule that stood in for an infeasible budget
    fallback: bool = False

    # -- introspection -----------------------------------------------------

    @property
    def length(self) -> int:
        return self.schedule.length

    @property
    def tiers(self) -> str:
        """The request's tiers, ``"+"``-joined (``"device+host"``)."""
        return "+".join(self.request.tiers)

    @property
    def num_slots(self) -> int:
        return self.request.resolved_num_slots

    @property
    def uses_offload(self) -> bool:
        """True if the schedule needs the host tier (Foff/Prefetch ops)."""
        return uses_offload(self.schedule)

    @property
    def remat_expressible(self) -> bool:
        """True if the plan runs as nested checkpoints (host copies cannot
        be expressed by a remat tree)."""
        return self.tree is not None and not self.uses_offload

    def op_counts(self) -> dict:
        counts: dict = {}
        for k, _ in self.schedule.ops:
            counts[k] = counts.get(k, 0) + 1
        return counts

    def recompute_factor(self) -> float:
        """Mean number of forward executions per stage (1.0 = none)."""
        fc = self.schedule.forward_counts()
        return sum(fc.values()) / max(len(fc), 1)

    def timeline(self) -> List[dict]:
        """Per-op records ``{"op", "arg", "t_start", "t_end", "device_mem",
        "host_mem"}`` from the float64 simulator (needs a profiled
        chain)."""
        if self.chain is None:
            raise ValueError("timeline() needs a plan built from a profiled "
                             "chain, not a bare length")
        rows: List[dict] = []
        res = simulate(self.chain, self.schedule, trace=rows)
        if not res.valid:
            raise AssertionError(f"plan schedule does not simulate: "
                                 f"{res.error}")
        return rows

    def stats(self) -> dict:
        """JSON-serializable description, with the JAX package's fields;
        ``executor`` is ``"nested-checkpoint"`` or ``"eager-offload"``."""
        return {
            "strategy": self.request.strategy,
            "tiers": self.tiers,
            "policy": self.policy,
            "num_slots": self.num_slots,
            "slots_used": (self.solution.slots_used
                           if self.solution is not None else None),
            "budget_bytes": self.budget_bytes,
            "expected_time_s": self.expected_time,
            "peak_device_mem": self.peak_device_mem,
            "peak_host_mem": self.peak_host_mem,
            "transfer_stall_s": self.transfer_stall,
            "ops": self.op_counts(),
            "recompute_factor": self.recompute_factor(),
            "uses_offload": self.uses_offload,
            "executor": ("eager-offload" if self.uses_offload
                         else "nested-checkpoint"),
            "chain_hash": self.chain_hash,
        }

    def summary(self) -> str:
        c = self.op_counts()
        ops = " ".join(f"{k}:{c[k]}" for k in
                       ("Fall", "Fck", "Fnone", "B", "Foff", "Prefetch")
                       if k in c)
        lines = [f"MemoryPlan[{self.request.describe()}]"
                 + (f" (policy {self.policy!r})" if self.policy else "")
                 + f" L={self.length} stages",
                 f"  ops: {len(self.schedule)} ({ops})"]
        if self.budget_bytes is not None:
            lines.append(f"  budget: {self.budget_bytes:.6e} B")
        if self.expected_time == self.expected_time:  # not NaN
            lines.append(f"  predicted: {self.expected_time:.6e} s/iter, "
                         f"activation peak {self.peak_device_mem:.6e} B, "
                         f"host peak {self.peak_host_mem:.6e} B, "
                         f"transfer stall {self.transfer_stall:.6e} s")
        lines.append("  executor: " + ("eager offload walker (host copies)"
                                       if self.uses_offload
                                       else "nested checkpoints"))
        return "\n".join(lines)

    # -- static verification ----------------------------------------------

    def verify(self, max_violations: int = 64):
        """Statically verify the schedule against the liveness,
        offload-protocol and budget rules (:mod:`repro_torch.check`);
        returns a :class:`~repro_torch.check.VerificationReport`.

        Nothing runs: the abstract interpreter proves every backward has its
        state, nothing is used after it is freed, the offload protocol
        holds and (with a profiled chain and a budget) the symbolic device
        peak stays within ``budget_bytes``.  A solver-backed two-tier
        ``optimal`` plan is also re-checked slot by slot against the
        solver's discretization, and a sound schedule's stored makespan and
        peaks against the simulator (:meth:`_verify_metadata`).

        One deliberate difference from the JAX package: the slot pass
        skips a min-memory ``fallback``, whose solver discretized against
        the store-all peak, not the budget it reports; re-quantized at that
        budget, a schedule that fits it byte for byte can exceed ``S``
        slots, and the JAX package refuses such a sound plan.  Each call's
        time lands in the ``plan.verify_seconds`` histogram."""
        from ..check import verify_schedule, verify_slot_discipline
        from ..obs import metrics
        with metrics.histogram("plan.verify_seconds").time():
            report = verify_schedule(
                self.schedule, chain=self.chain,
                device_budget=self.budget_bytes,
                max_violations=max_violations)
            if (self.chain is not None and self.solution is not None
                    and self.budget_bytes is not None
                    and self.request.strategy == "optimal"
                    and not self.fallback and not self.uses_offload):
                # re-quantizing against the plan budget is only sound for
                # the budget-driven two-tier solver
                report.merge(verify_slot_discipline(
                    self.schedule, self.chain, self.budget_bytes,
                    self.num_slots, max_violations=max_violations))
            if (report.ok and self.chain is not None
                    and self.expected_time == self.expected_time):  # not NaN
                report.merge(self._verify_metadata())
        return report

    def _verify_metadata(self):
        """The stored makespan and peaks against the float64 cost model: a
        corruption that leaves the schedule valid but changes what it
        costs (a duplicated forward) still fails."""
        from ..check import VerificationReport, Violation
        res = simulate(self.chain, self.schedule)
        report = VerificationReport(rules=["metadata"])

        def drift(name, stored, got):
            if abs(got - stored) > 1e-9 * max(1.0, abs(stored)):
                report.violations.append(Violation(
                    kind="metadata-drift",
                    message=f"stored {name} {stored!r} but the schedule "
                            f"simulates to {got!r}"))

        drift("expected_time", self.expected_time, res.time)
        drift("peak_device_mem", self.peak_device_mem, res.peak_mem)
        drift("peak_host_mem", self.peak_host_mem, res.host_peak_mem)
        return report

    def _verify_or_raise(self, context: str) -> None:
        report = self.verify()
        if not report.ok:
            from ..check import PlanVerificationError
            raise PlanVerificationError(report, context=context)

    # -- execution ---------------------------------------------------------

    def bind(self, stages: Sequence[Callable], tracer=None) -> "BoundPlan":
        """Bind per-stage callables (``stages[l-1]`` is paper-stage ``l``):
        the one call surface for both executors.  ``tracer`` (a
        :class:`repro_torch.obs.trace.Tracer`, opt-in) runs every call on
        the op walker, whatever the plan, with one span per schedule op —
        the measured timeline for :meth:`drift`; without it nothing
        changes.  Under ``REPRO_CHECK=1`` the plan is verified first."""
        if os.environ.get("REPRO_CHECK") == "1":
            self._verify_or_raise("refusing to bind an invalid plan")
        return BoundPlan(self, stages, tracer=tracer)

    def execute(self, stages: Sequence[Callable], params: Sequence[Any],
                x: Any, **kwargs) -> Tuple[Any, List[Any], Any]:
        """Run the exact op sequence on the eager walker
        (``core.executor.execute_schedule``; host copies included);
        returns ``(out, param_grads, input_grad)``.  Pass ``tracer=`` to
        record one span per op.  Under ``REPRO_CHECK=1`` the plan is
        verified first."""
        if os.environ.get("REPRO_CHECK") == "1":
            self._verify_or_raise("refusing to execute an invalid plan")
        from ..core.executor import execute_schedule
        return execute_schedule(self.schedule, stages, params, x, **kwargs)

    def drift(self, trace):
        """Plan-vs-actual drift of a trace recorded while running this plan
        (:func:`repro_torch.obs.drift.compare`)."""
        from ..obs.drift import compare
        return compare(self, trace)


class BoundPlan:
    """A plan bound to stage callables.

    - ``remat_expressible`` — the calls run as nested checkpoints
      (:func:`~repro_torch.core.rematerialize.build_remat_fn`); otherwise
      on the eager walker with a fresh host buffer per call — always so
      when bound with a tracer (``traced``).
    - ``forward(params, x)`` — the chain's output.
    - ``value_and_grad(params, x)`` — ``(out, param_grads, input_grad)``
      for a cotangent of ones on the output, shaped as
      :func:`~repro_torch.core.executor.reference_grads` shapes them.
    """

    def __init__(self, plan: MemoryPlan, stages: Sequence[Callable],
                 tracer=None):
        self.plan = plan
        self.stages = list(stages)
        self.tracer = tracer
        self.traced = tracer is not None and tracer.enabled
        self.remat_expressible = plan.remat_expressible and not self.traced
        self._fn = None
        if self.remat_expressible:
            from ..core.rematerialize import build_remat_fn
            self._fn = build_remat_fn(plan.tree, self.stages)

    def forward(self, params: Sequence[Any], x: Any) -> Any:
        if self.remat_expressible:
            return self._fn(params, x)
        return self._run_eager(params, x)[0]

    def value_and_grad(self, params: Sequence[Any], x: Any
                       ) -> Tuple[Any, List[Any], Any]:
        if self.remat_expressible:
            from ..core.executor import value_and_grads
            return value_and_grads(self._fn, params, x)
        return self._run_eager(params, x)

    def _run_eager(self, params, x):
        from ..offload.executor import execute_offload_schedule
        from ..offload.host_buffer import HostBuffer
        return execute_offload_schedule(self.plan.schedule, self.stages,
                                        params, x, host_buffer=HostBuffer(),
                                        tracer=self.tracer)

    def __repr__(self):
        mode = ("traced-walker" if self.traced else "nested-checkpoint"
                if self.remat_expressible else "eager-offload")
        return f"BoundPlan({mode}, L={self.plan.length})"
