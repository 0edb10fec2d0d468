"""Static verification of plans — the port of ``repro.check``'s schedule
verifier (:mod:`.schedule_verifier`): an abstract interpreter over a
schedule's ops that proves liveness, the offload protocol, the budgets and
the slot discipline without running anything.  Surfaced as
:meth:`repro_torch.plan.MemoryPlan.verify`, which ``bind``/``execute`` run
under ``REPRO_CHECK=1`` and ``run_serving`` runs on every kv plan.
"""

from .schedule_verifier import verify_schedule, verify_slot_discipline
from .violations import (VIOLATION_KINDS, PlanVerificationError,
                         VerificationReport, Violation)

__all__ = [
    "VIOLATION_KINDS",
    "PlanVerificationError",
    "VerificationReport",
    "Violation",
    "verify_schedule",
    "verify_slot_discipline",
]
