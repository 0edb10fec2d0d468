"""Content-addressed, verification-gated storage of MemoryPlans.

:class:`PlanStore` is the trust boundary of plan sharing: every plan read
back from a backend — in particular a *shared* backend other hosts and
tenants write to — is admitted only after

1. the codec envelope check (byte tampering, truncation, key renames →
   quarantined, reported as ``store-corrupt``),
2. the fingerprint cross-check (the entry's recorded chain × request ×
   code address must match the one it is served under),
3. the full static gate :meth:`repro_torch.plan.MemoryPlan.verify` — liveness,
   slot discipline, metadata cross-check — so a semantically tampered but
   well-encoded plan (a re-encoded entry with a doctored schedule or
   forged makespan) is rejected with the usual :mod:`repro_torch.check`
   violation kinds and never reaches ``bind``/``execute``.

Rejections quarantine the entry; with ``strict=True`` they raise
:class:`repro_torch.check.PlanVerificationError` instead of reporting a
miss.

Keys are per-tenant: ``<namespace>[/<tenant>]/<chain>.<request>.<code>``,
so quotas and eviction (:mod:`repro_torch.runtime.plan_service`) operate on
plain key prefixes.
"""

from __future__ import annotations

from typing import Any, List, Optional

from .backend import StoreError
from .codec import CorruptEntryError, decode, encode
from .keys import PLAN_NAMESPACE, PlanKey
from .objects import ObjectStore

_KIND = "memory-plan"


def _corrupt_error(context: str, detail: str):
    from ..check import (PlanVerificationError, VerificationReport,
                             Violation)
    report = VerificationReport(rules=["store"])
    report.violations.append(Violation(kind="store-corrupt", message=detail))
    return PlanVerificationError(report, context=context)


class PlanStore:
    """Typed plan storage over an :class:`ObjectStore`'s backend."""

    def __init__(self, store: ObjectStore, namespace: str = PLAN_NAMESPACE):
        self.store = store
        self.namespace = namespace

    def _ns(self, tenant: Optional[str]) -> str:
        return f"{self.namespace}/{tenant}" if tenant else self.namespace

    def key_for(self, chain, request, *,
                tenant: Optional[str] = None) -> str:
        return PlanKey.for_plan(chain, request).key(self._ns(tenant))

    # -- write -------------------------------------------------------------

    def put(self, plan, *, chain=None, request=None,
            tenant: Optional[str] = None) -> str:
        """Admit a plan into the store (verified first — an invalid plan
        raises and never lands); returns the store key."""
        chain = chain if chain is not None else plan.chain
        request = request if request is not None else plan.request
        if chain is None:
            raise StoreError("cannot store a plan with no profiled chain")
        plan._verify_or_raise("refusing to store an invalid plan")
        pk = PlanKey.for_plan(chain, request)
        key = pk.key(self._ns(tenant))
        payload = {
            "chain": pk.chain,
            "request": pk.request,
            "code": pk.code,
            "plan": plan,
        }
        self.store.backend.put(key, encode(_KIND, key, payload))
        return key

    # -- read --------------------------------------------------------------

    def get(self, chain, request, *, tenant: Optional[str] = None,
            strict: bool = False) -> Optional[Any]:
        """The stored plan for this chain × request × current code, fully
        re-verified; None on miss/rejection (or raises when ``strict``)."""
        pk = PlanKey.for_plan(chain, request)
        return self.get_key(pk.key(self._ns(tenant)), expect=pk,
                            strict=strict)

    def get_key(self, key: str, *, expect: Optional[PlanKey] = None,
                strict: bool = False) -> Optional[Any]:
        data = self.store.backend.get(key)
        if data is None:
            return None
        try:
            _, _, payload = decode(data, kind=_KIND, key=key)
            if not isinstance(payload, dict) or "plan" not in payload:
                raise CorruptEntryError("plan entry payload malformed")
        except CorruptEntryError as e:
            self.store.backend.quarantine(key)
            if strict:
                raise _corrupt_error(
                    f"stored plan {key!r} failed integrity check", str(e)
                ) from e
            return None
        plan = payload["plan"]
        if expect is not None:
            got = PlanKey(chain=str(payload.get("chain", "")),
                          request=str(payload.get("request", "")),
                          code=str(payload.get("code", "")))
            diverged = expect.diff(got)
            if diverged:
                self.store.backend.quarantine(key)
                if strict:
                    raise _corrupt_error(
                        f"stored plan {key!r} failed integrity check",
                        f"fingerprint mismatch in: {', '.join(diverged)}")
                return None
        report = plan.verify()
        if not report.ok:
            self.store.backend.quarantine(key)
            if strict:
                from ..check import PlanVerificationError
                raise PlanVerificationError(
                    report, context=f"stored plan {key!r} failed verification")
            return None
        return plan

    # -- maintenance -------------------------------------------------------

    def keys(self, *, tenant: Optional[str] = None) -> List[str]:
        return self.store.backend.keys(self._ns(tenant))

    def delete(self, key: str) -> bool:
        return self.store.backend.delete(key)

    def clear(self, *, tenant: Optional[str] = None) -> None:
        self.store.backend.clear(self._ns(tenant))
