"""Structured violation reports of the static schedule verifier — the port
of ``repro.check.violations``, with the same closed set of kinds (some,
such as ``store-corrupt``, name parts of the JAX package the port does not
have yet).  Stdlib only: nothing here imports back into ``repro_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# The closed set of violation kinds (the JAX package's, in its order).
# Tests key on these — add, never rename.
VIOLATION_KINDS = (
    "bad-stage",        # stage/activation index outside 1..L+1 (or 0..L)
    "bad-op",           # unknown op kind
    "missing-input",    # forward/backward needs a^{l-1}, neither a nor ā live
    "missing-grad",     # B^l needs δ^l
    "missing-residual", # B^l needs ā^l
    "free-not-live",    # Free of an item that is not live
    "no-host-tier",     # Foff/Prefetch on a chain without an enabled host tier
    "offload-not-bare", # Foff of a^i that is not live as a bare activation
    "double-offload",   # Foff of a^i that already has a host copy
    "prefetch-no-copy", # Prefetch of a^i with no (completed-or-launched) Foff
    "prefetch-resident",# Prefetch of a^i that is already on device
    "device-budget",    # during-op device memory exceeds the budget
    "host-budget",      # host-tier memory exceeds the host budget
    "slot-discipline",  # discretized (slot-granular) accounting exceeds S slots
    "no-output",        # schedule ends without δ^0 live
    "non-persistent",   # a checkpointed value was dropped before its B use
    "metadata-drift",   # plan's stored makespan/peaks disagree with the model
    "store-corrupt",    # stored plan failed the envelope/fingerprint check
)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One rule failure, anchored to an op position and the lattice state.

    ``op_index`` is the 0-based position in ``schedule.ops`` (-1 for
    whole-schedule violations such as ``no-output``); ``state`` is a short
    human-readable residency summary (device items, host copies) at the
    moment the rule fired.
    """

    kind: str
    message: str
    op_index: int = -1
    op: Optional[Tuple[str, object]] = None
    state: str = ""

    def __post_init__(self):
        if self.kind not in VIOLATION_KINDS:
            raise ValueError(f"unknown violation kind {self.kind!r}")

    def __str__(self) -> str:
        where = f" at op[{self.op_index}]={self.op}" if self.op_index >= 0 else ""
        lattice = f" [{self.state}]" if self.state else ""
        return f"{self.kind}: {self.message}{where}{lattice}"


@dataclasses.dataclass
class VerificationReport:
    """The result of one static verification pass over a schedule.

    ``rules`` names the rule families that actually ran (budget rules are
    skipped when the plan has no profiled chain); ``truncated`` is set when
    violation collection stopped at the cap.
    """

    violations: List[Violation] = dataclasses.field(default_factory=list)
    rules: List[str] = dataclasses.field(default_factory=list)
    truncated: bool = False

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def first_kind(self) -> Optional[str]:
        return self.violations[0].kind if self.violations else None

    def merge(self, other: "VerificationReport") -> "VerificationReport":
        self.violations.extend(other.violations)
        for r in other.rules:
            if r not in self.rules:
                self.rules.append(r)
        self.truncated = self.truncated or other.truncated
        return self

    def summary(self) -> str:
        head = (f"{len(self.violations)} violation(s)"
                + (" (truncated)" if self.truncated else "")
                if self.violations else "ok")
        lines = [f"schedule verification: {head} "
                 f"(rules: {', '.join(self.rules) or 'none'})"]
        lines += [f"  - {v}" for v in self.violations]
        return "\n".join(lines)


class PlanVerificationError(ValueError):
    """A :class:`~repro_torch.plan.MemoryPlan` failed static verification.

    Raised by ``bind``/``execute`` when ``REPRO_CHECK=1`` and by
    ``run_serving`` on a kv plan that does not verify.  Carries the full
    report.
    """

    def __init__(self, report: VerificationReport, context: str = ""):
        self.report = report
        prefix = f"{context}: " if context else ""
        super().__init__(prefix + report.summary())
