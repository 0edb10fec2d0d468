"""The :class:`MemoryPlan` artifact and its executor binding
(:class:`BoundPlan`) — the port of ``repro.plan.plan``.

A plan carries the op :class:`~repro_torch.core.schedule.Schedule`, the
recursion tree (run as nested checkpoints, or by the eager walker when it
holds offload nodes), the solver :class:`~repro_torch.core.solver.Solution`
(solver-backed strategies), the :class:`~repro_torch.plan.request.PlanRequest`
it answers, the chain's content hash, and the float64 simulator's
predicted makespan, device and host peaks and transfer stall (NaN without
a profiled chain).  It answers:

- *is it sound?* — :meth:`MemoryPlan.verify`, the static verifier
  (:mod:`repro_torch.check`); ``save``/``load`` and the plan store
  always run it, and under ``REPRO_CHECK=1`` ``build_plan`` runs it on
  every plan it returns and ``bind``/``execute`` before they run, and each
  refuses a plan that fails (the JAX package gates only ``bind``/
  ``execute``, ``save``/``load`` and its store);
- *how do I run it?* — :meth:`MemoryPlan.bind` (nested checkpoints, or the
  walker for offload plans; with ``tracer=`` either records one span per
  op) and :meth:`MemoryPlan.execute` (the walker);
- *what does it cost, and did it?* — :meth:`summary`, :meth:`stats`,
  :meth:`timeline`, and :meth:`drift` of a trace against the prediction;
- *can I reuse it?* — :meth:`MemoryPlan.save` / :meth:`MemoryPlan.load`
  round-trip the plan through a path, ``file://<path>`` or
  ``store://<namespace>/<key>`` (the process default
  :mod:`repro_torch.store`).  The :mod:`repro_torch.store.codec` envelope
  carries the chain × request × code fingerprints, so a load against a
  diverged chain raises :class:`StalePlanError` naming the component that
  moved, and both ends verify the schedule.  Only the ``MemoryPlan`` is
  pickled (its schedule, tree, Solution, request and chain: host objects
  only), never a :class:`BoundPlan` or its stages, so a plan saved next to
  the card loads on a host without one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..core.chain import Chain
from ..core.schedule import Schedule, simulate, uses_offload
from ..core.solver import Solution
from ..core.solver_cache import chain_fingerprint, code_fingerprint
from ..store.codec import CorruptEntryError, decode, encode
from .request import PlanRequest

__all__ = ["BoundPlan", "InfeasiblePlanError", "MemoryPlan",
           "StalePlanError", "chain_fingerprint"]

_PLAN_VERSION = 2
_PLAN_KIND = "memory-plan"
#: Envelope key for path-backed saves (store-backed saves use the store
#: key, which the codec cross-checks against renames).
_PLAN_FILE_KEY = "plan"
_STORE_SCHEME = "store://"
_FILE_SCHEME = "file://"


class StalePlanError(ValueError):
    """A saved plan was loaded against a chain it was not solved for."""


class InfeasiblePlanError(MemoryError):
    """No feasible schedule exists for the request (budget too small)."""


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
        :class:`repro_torch.obs.trace.Tracer`, opt-in) records one span per
        schedule op of every call, on the executor the plan runs on (the
        nested checkpoints of a two-tier plan: its stage forwards, replays
        and backwards; no detour to the walker) — the measured timeline for
        :meth:`drift`.  Under ``REPRO_CHECK=1`` the plan is verified
        first."""
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

    # -- persistence -------------------------------------------------------

    def validate_chain(self, chain: Chain) -> None:
        """Raise :class:`StalePlanError` unless ``chain`` is content-identical
        to the chain this plan was solved for."""
        got = chain_fingerprint(chain)
        if self.chain_hash is None:
            raise StalePlanError(
                "plan carries no chain hash (built from a bare length); "
                "cannot validate it against a profiled chain")
        if got != self.chain_hash:
            raise StalePlanError(
                f"plan was solved for chain {self.chain_hash[:12]}… but the "
                f"given chain hashes to {got[:12]}… — re-plan (costs, sizes "
                f"or the host link changed)")

    def to_payload(self) -> Dict[str, Any]:
        """The serialized form: the plan plus its full content address
        (chain × request × code fingerprints), so any later load can name
        exactly which component diverged."""
        from ..store.keys import request_digest
        return {
            "version": _PLAN_VERSION,
            "chain_hash": self.chain_hash,
            "request": request_digest(self.request),
            "code": code_fingerprint(),
            "plan": self,
        }

    def save(self, target: str) -> None:
        """Serialize the plan to ``target`` — a filesystem path,
        ``file://<path>``, or ``store://<namespace>/<key>`` (written into
        the process default :mod:`repro_torch.store`).  The codec envelope
        embeds the chain/request/code fingerprints so :meth:`load` can
        refuse a mismatched chain and say why.  The plan is statically
        verified first: an invalid schedule never reaches disk
        (:class:`~repro_torch.check.PlanVerificationError`).  A path is
        written atomically (a temporary file, then ``os.replace``)."""
        self._verify_or_raise(f"refusing to save invalid plan to {target!r}")
        if target.startswith(_STORE_SCHEME):
            from ..store.config import default_store
            key = target[len(_STORE_SCHEME):]
            store = default_store(required=True)
            store.backend.put(key, encode(_PLAN_KIND, key, self.to_payload()))
            return
        path = (target[len(_FILE_SCHEME):]
                if target.startswith(_FILE_SCHEME) else target)
        data = encode(_PLAN_KIND, _PLAN_FILE_KEY, self.to_payload())
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    @staticmethod
    def load(target: str, chain: Optional[Chain] = None,
             request: Optional[PlanRequest] = None) -> "MemoryPlan":
        """Load a saved plan from a path or URI (as :meth:`save`).

        With ``chain`` given, the plan is validated against it — always
        pass the chain you are about to execute on.  Staleness is reported
        per fingerprint component: the :class:`StalePlanError` names
        whether the *chain* (costs/sizes/host link), the *code* (solver
        sources) or, when ``request`` is given, the *request* diverged.
        The schedule is statically re-verified (a truncated or hand-edited
        file fails with :class:`~repro_torch.check.PlanVerificationError`
        or ``ValueError``, not at execution time)."""
        if target.startswith(_STORE_SCHEME):
            from ..store.config import default_store
            key = target[len(_STORE_SCHEME):]
            store = default_store(required=True)
            data = store.backend.get(key)
            if data is None:
                raise FileNotFoundError(f"no stored plan at {target!r}")
            envelope_key = key
        else:
            path = (target[len(_FILE_SCHEME):]
                    if target.startswith(_FILE_SCHEME) else target)
            with open(path, "rb") as f:
                data = f.read()
            envelope_key = _PLAN_FILE_KEY
        try:
            _, _, payload = decode(data, kind=_PLAN_KIND, key=envelope_key)
        except CorruptEntryError as e:
            raise ValueError(
                f"{target!r} is not a saved MemoryPlan ({e})") from e
        if not isinstance(payload, dict) or not isinstance(
                payload.get("plan"), MemoryPlan):
            raise ValueError(f"{target!r} does not contain a MemoryPlan")
        if payload.get("version") != _PLAN_VERSION:
            raise ValueError(
                f"saved plan {target!r} has payload version "
                f"{payload.get('version')!r}, this build reads "
                f"{_PLAN_VERSION}")
        plan: MemoryPlan = payload["plan"]
        if chain is not None:
            plan._check_staleness(target, payload, chain, request)
        plan._verify_or_raise(f"loaded plan {target!r} fails verification")
        return plan

    def _check_staleness(self, target: str, payload: Dict[str, Any],
                         chain: Chain,
                         request: Optional[PlanRequest]) -> None:
        """Component-wise fingerprint comparison: which of chain / code /
        request moved since the plan was saved."""
        from ..store.keys import request_digest
        if self.chain_hash is None:
            raise StalePlanError(
                "plan carries no chain hash (built from a bare length); "
                "cannot validate it against a profiled chain")
        diverged: List[str] = []
        if chain_fingerprint(chain) != self.chain_hash:
            diverged.append(
                "chain (costs, sizes or the host link changed)")
        stored_code = payload.get("code")
        if stored_code is not None and stored_code != code_fingerprint():
            diverged.append(
                "code (the solver sources changed since this plan was "
                "solved)")
        if request is not None:
            stored_req = payload.get("request")
            if stored_req is not None and (
                    stored_req != request_digest(request)):
                diverged.append(
                    "request (strategy/budget/tiers/slots/impl differ)")
        if diverged:
            raise StalePlanError(
                f"plan {target!r} is stale — fingerprint diverged in: "
                + "; ".join(diverged) + " — re-plan")


class BoundPlan:
    """A plan bound to stage callables.

    - ``remat_expressible`` — the calls run as nested checkpoints
      (:func:`~repro_torch.core.rematerialize.build_remat_fn`); otherwise
      on the eager walker with a fresh host buffer per call.  Bound with a
      tracer (``traced``), either records one span per schedule op.
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
        self.remat_expressible = plan.remat_expressible
        self._fn = None
        if self.remat_expressible:
            from ..core.rematerialize import build_remat_fn
            self._fn = build_remat_fn(plan.tree, self.stages,
                                      tracer=tracer if self.traced else None)

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
        mode = ("nested-checkpoint" if self.remat_expressible
                else "eager-offload")
        return (f"BoundPlan({mode}, L={self.plan.length}"
                + (", traced)" if self.traced else ")"))
