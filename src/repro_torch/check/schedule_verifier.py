"""Static schedule verifier — the port of ``repro.check.schedule_verifier``:
an abstract interpreter over ``Schedule`` ops.

It walks the op stream once, tracking a liveness-and-residency lattice per
activation — absent / bare (``a^i``) / full-history (``ā^i``) / gradient
(``δ^i``) on the device, plus a host-copy set for the offload protocol —
and symbolic device/host memory.  It proves, without executing or timing
anything, that:

- every forward/backward op has its inputs live (``ā^i`` includes ``a^i``,
  paper §3.1);
- nothing is used after an explicit ``Free``;
- the offload protocol holds: ``Foff`` only on a live *bare* activation
  with no host copy yet, ``Prefetch`` only of an activation with a host
  copy that is not on the device;
- the symbolic device/host peaks stay within the plan's budgets (the
  simulator's accounting: a forward charges ``mem + new + of``, a backward
  ``mem + ob``);
- the schedule ends with ``δ^0`` live, and (optionally) no checkpointed
  value is dropped before its backward (persistence, §4.1).

Unlike :func:`repro_torch.core.schedule.simulate`, which stops at the first
error, this pass collects *all* violations (repairing the state so that one
fault does not cascade) into a
:class:`~repro_torch.check.violations.VerificationReport`.  The accounting
mirrors the simulator op for op, in the same order and with the same
``1e-9`` budget epsilon, so ``simulate(...).valid`` iff
``verify_schedule(...).ok``.

:func:`verify_slot_discipline` is the second, discretized pass: it re-walks
the schedule with sizes quantized to the solver's memory slots
(``chain.discretize(budget, S)``) and proves the slot count never exceeds
``S``.  It is only sound for ``strategy="optimal"`` plans: the min-memory
solvers discretize against the store-all peak and report a *derived* byte
budget.
"""

from __future__ import annotations

from typing import Optional, Tuple

from .violations import VerificationReport, Violation

# Op vocabulary, as repro_torch.core.schedule names it (kept in sync by
# tests/test_torch_verifier.py); this module imports nothing of the solver.
F_NONE, F_CK, F_ALL, BWD, FREE = "Fnone", "Fck", "Fall", "B", "Free"
F_OFF, PREFETCH = "Foff", "Prefetch"
_FORWARD_KINDS = (F_NONE, F_CK, F_ALL)
_OFFLOAD_KINDS = (F_OFF, PREFETCH)

_EPS = 1e-9  # budget comparison epsilon — must match simulate()


class _Model:
    """Size/overhead oracle for one verification pass.

    Wraps either a :class:`~repro_torch.core.chain.Chain` (byte-exact pass)
    or a :class:`~repro_torch.core.chain.DiscreteChain` (slot pass);
    ``None`` sizes everything at 0 so structural rules still run for
    bare-length plans.
    """

    def __init__(self, sized, host_enabled: Optional[bool]):
        self._sized = sized
        self.host_enabled = host_enabled  # None = unknown (skip the rule)

    def size(self, item: Tuple[str, int]) -> float:
        if self._sized is None:
            return 0.0
        kind, i = item
        c = self._sized
        L = c.length
        if kind == "a":
            return 0.0 if i == L + 1 else float(c.wa[i])
        if kind == "abar":
            return float(c.wabar[i - 1])  # ā^i stored at array index i-1
        if kind == "delta":
            return 0.0 if i == L + 1 else float(c.wdelta[i])
        raise ValueError(f"unknown item {item}")

    def of(self, l: int) -> float:
        return 0.0 if self._sized is None else float(self._sized.of[l - 1])

    def ob(self, l: int) -> float:
        return 0.0 if self._sized is None else float(self._sized.ob[l - 1])


def residency_summary(live, host_copies) -> str:
    """Compact lattice state: ``dev a{0,3} ā{5} δ{6} | host{2}``."""
    parts = []
    for kind, tag in (("a", "a"), ("abar", "ā"), ("delta", "δ")):
        idxs = sorted(i for (k, i) in live if k == kind)
        if idxs:
            parts.append(tag + "{" + ",".join(map(str, idxs)) + "}")
    dev = "dev " + " ".join(parts) if parts else "dev empty"
    if host_copies:
        dev += " | host{" + ",".join(map(str, sorted(host_copies))) + "}"
    return dev


def _walk(
    schedule,
    model: _Model,
    device_budget: Optional[float],
    host_budget: Optional[float],
    check_persistent: bool,
    budget_kind: str,
    host_budget_kind: str,
    max_violations: int,
) -> VerificationReport:
    """One lattice walk.  Mirrors ``simulate()`` check-for-check (same order,
    same epsilon) but repairs state after each violation and keeps going."""
    L = schedule.length
    report = VerificationReport()
    live: dict = {("a", 0): True, ("delta", L + 1): True}
    ckpt: set = {("a", 0)}
    mem = model.size(("a", 0))
    peak = mem
    persistent = True
    host_copies: set = set()
    host_mem = 0.0
    host_peak = 0.0

    def fail(kind: str, message: str, idx: int, op) -> None:
        if len(report.violations) >= max_violations:
            report.truncated = True
            return
        report.violations.append(
            Violation(
                kind=kind,
                message=message,
                op_index=idx,
                op=op,
                state=residency_summary(live, host_copies),
            )
        )

    for idx, op in enumerate(schedule.ops):
        kind, arg = op
        if kind == FREE:
            item = arg
            if item not in live:
                fail("free-not-live", f"Free of non-live {item}", idx, op)
                continue  # repair: skip the free
            if item in ckpt:
                persistent = False
            mem -= model.size(item)
            del live[item]
            continue

        if kind in _OFFLOAD_KINDS:
            i = int(arg)
            if model.host_enabled is False:
                fail(
                    "no-host-tier",
                    f"{kind} a^{i}: chain has no host tier",
                    idx,
                    op,
                )
                # repair: pretend the tier exists and keep walking
            if not (0 <= i <= L):
                fail("bad-stage", f"{kind}: bad activation {i}", idx, op)
                continue
            w = model.size(("a", i))
            if kind == F_OFF:
                if ("a", i) not in live:
                    fail(
                        "offload-not-bare",
                        f"Foff: a^{i} not live as a bare activation",
                        idx,
                        op,
                    )
                if i in host_copies:
                    fail(
                        "double-offload",
                        f"Foff: a^{i} already offloaded",
                        idx,
                        op,
                    )
                    continue  # repair: don't double-charge the host
                host_copies.add(i)
                host_mem += w
                host_peak = max(host_peak, host_mem)
                if host_budget is not None and host_mem > host_budget + _EPS:
                    fail(
                        host_budget_kind,
                        f"Foff: host mem {host_mem} > limit {host_budget}",
                        idx,
                        op,
                    )
                ckpt.discard(("a", i))
            else:  # PREFETCH
                if i not in host_copies:
                    fail(
                        "prefetch-no-copy",
                        f"Prefetch: a^{i} has no host copy",
                        idx,
                        op,
                    )
                if ("a", i) in live:
                    fail(
                        "prefetch-resident",
                        f"Prefetch: a^{i} already on device",
                        idx,
                        op,
                    )
                    if i in host_copies:  # repair: consume the host copy only
                        host_copies.discard(i)
                        host_mem -= w
                    continue
                during = mem + w
                peak = max(peak, during)
                if device_budget is not None and during > device_budget + _EPS:
                    fail(
                        budget_kind,
                        f"Prefetch: mem {during} > limit {device_budget}",
                        idx,
                        op,
                    )
                live[("a", i)] = True
                mem += w
                ckpt.add(("a", i))
                if i in host_copies:
                    host_copies.discard(i)
                    host_mem -= w
            continue

        l = int(arg)
        if kind in _FORWARD_KINDS:
            if not (1 <= l <= L + 1):
                fail("bad-stage", f"bad stage {l}", idx, op)
                continue
            have_input = ("a", l - 1) in live or (
                l - 1 >= 1 and ("abar", l - 1) in live
            )
            src = (
                ("a", l - 1)
                if ("a", l - 1) in live
                else ("abar", l - 1)
                if l - 1 >= 1 and ("abar", l - 1) in live
                else None
            )
            if not have_input:
                fail(
                    "missing-input",
                    f"{kind}^{l}: a^{l - 1} not live",
                    idx,
                    op,
                )
                # repair: run the forward anyway so later ops can be checked
            out = ("abar", l) if kind == F_ALL else ("a", l)
            new_bytes = 0.0 if out in live else model.size(out)
            during = mem + new_bytes + model.of(l)
            peak = max(peak, during)
            if device_budget is not None and during > device_budget + _EPS:
                fail(
                    budget_kind,
                    f"{kind}^{l}: mem {during} > limit {device_budget}",
                    idx,
                    op,
                )
            if kind == F_NONE and src == ("a", l - 1):
                if src in ckpt:
                    persistent = False
                mem -= model.size(src)
                del live[src]
            if out not in live:
                live[out] = True
                mem += new_bytes
            if kind in (F_CK, F_ALL) and ("a", l - 1) in live:
                ckpt.add(("a", l - 1))
            if kind == F_ALL:
                ckpt.add(out)
        elif kind == BWD:
            if not (1 <= l <= L + 1):
                fail("bad-stage", f"bad stage {l}", idx, op)
                continue
            for item, vkind in (
                (("delta", l), "missing-grad"),
                (("abar", l), "missing-residual"),
            ):
                if item not in live:
                    fail(vkind, f"B^{l}: {item} not live", idx, op)
            have_input = ("a", l - 1) in live or (
                l - 1 >= 1 and ("abar", l - 1) in live
            )
            src = ("a", l - 1) if ("a", l - 1) in live else None
            if not have_input:
                fail(
                    "missing-input",
                    f"B^{l}: a^{l - 1} not live",
                    idx,
                    op,
                )
            during = mem + model.ob(l)
            peak = max(peak, during)
            if device_budget is not None and during > device_budget + _EPS:
                fail(
                    budget_kind,
                    f"B^{l}: mem {during} > limit {device_budget}",
                    idx,
                    op,
                )
            for item in (("delta", l), ("abar", l)):
                if item in live:  # repair: consume only what exists
                    mem -= model.size(item)
                    del live[item]
                    ckpt.discard(item)
            if src == ("a", l - 1):
                mem -= model.size(src)
                del live[src]
                ckpt.discard(src)
            out = ("delta", l - 1)
            if out not in live:
                live[out] = True
                mem += model.size(out)
        else:
            fail("bad-op", f"unknown op kind {kind}", idx, op)

    if ("delta", 0) not in live:
        fail("no-output", "schedule did not produce δ^0", -1, None)
    if check_persistent and not persistent:
        fail("non-persistent", "non-persistent", -1, None)
    return report


def verify_schedule(
    schedule,
    chain=None,
    device_budget: Optional[float] = None,
    host_budget: Optional[float] = None,
    check_persistent: bool = False,
    max_violations: int = 64,
) -> VerificationReport:
    """Statically verify one schedule; returns a
    :class:`~repro_torch.check.violations.VerificationReport` (never raises on
    invalid schedules — raising is the caller's policy, see
    ``MemoryPlan.verify``).

    ``chain=None`` runs the structural rules only (liveness, offload
    protocol, output) with all sizes 0 — the budget rules need a profiled
    chain to mean anything.
    """
    host_enabled: Optional[bool]
    if chain is None:
        host_enabled = None
    else:
        host_enabled = chain.host is not None and chain.host.enabled
    model = _Model(chain, host_enabled)
    rules = ["liveness", "offload-protocol", "output"]
    if chain is not None and device_budget is not None:
        rules.append("device-budget")
    if chain is not None and host_budget is not None:
        rules.append("host-budget")
    if check_persistent:
        rules.append("persistence")
    report = _walk(
        schedule,
        model,
        device_budget if chain is not None else None,
        host_budget if chain is not None else None,
        check_persistent,
        budget_kind="device-budget",
        host_budget_kind="host-budget",
        max_violations=max_violations,
    )
    report.rules = rules
    return report


def verify_slot_discipline(
    schedule,
    chain,
    budget: float,
    num_slots: int,
    max_violations: int = 64,
) -> VerificationReport:
    """Prove the schedule fits ``num_slots`` memory slots after quantizing
    sizes exactly the way the DP solver did (``chain.discretize``; paper
    §5.2).  Only sound for plans whose solver discretized against ``budget``
    itself — i.e. ``strategy="optimal"``."""
    dchain = chain.discretize(budget, num_slots)
    model = _Model(dchain, chain.host is not None and chain.host.enabled)
    report = _walk(
        schedule,
        model,
        device_budget=float(num_slots),
        host_budget=None,
        check_persistent=False,
        budget_kind="slot-discipline",
        host_budget_kind="slot-discipline",
        max_violations=max_violations,
    )
    # structural violations are already reported by the byte pass; keep only
    # the slot-granular budget findings from this one
    report.violations = [
        v for v in report.violations if v.kind == "slot-discipline"
    ]
    report.rules = ["slot-discipline"]
    return report
