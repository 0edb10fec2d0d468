"""Multi-tenant plan service: one process answering plan requests for a
fleet ("plan once, bind anywhere") — the port of
``repro.runtime.plan_service``.

:class:`PlanService` fronts a :class:`repro_torch.store.PlanStore` with the
operational pieces a shared planning endpoint needs:

- a **request queue** drained by worker threads — callers get a
  :class:`concurrent.futures.Future` immediately and solves proceed in the
  background (``plan()`` is the blocking convenience wrapper);
- **per-tenant namespaces**: tenants address disjoint key prefixes
  (``plans/<tenant>/…``), so one tenant's plans and quota pressure are
  invisible to another's;
- **per-tenant quotas** (:class:`TenantQuota`): ``max_inflight`` bounds
  queued-plus-running requests (excess submissions raise
  :class:`QuotaExceededError` instead of queueing without bound) and
  ``max_plans`` bounds stored plans (oldest admitted-by-this-service entry
  evicted first);
- **single-flight dedup**: concurrent requests for the same
  chain × request × code content key share one solve — later submitters
  receive the same Future;
- a **verification gate**: every plan crossing the service boundary goes
  through :meth:`repro_torch.plan.MemoryPlan.verify` — on the way in via
  :meth:`PlanStore.put` (an invalid plan is never admitted) and on the way
  out via :meth:`PlanStore.get` in strict mode (a tampered stored entry is
  quarantined, counted, and transparently re-solved; it never reaches
  ``bind``/``execute``).

Every outcome ticks the :mod:`repro_torch.obs` registry:
``plan_service.hits`` / ``misses`` / ``solves`` / ``deduped`` /
``verify_rejects`` / ``evictions`` / ``quota_rejections``.

The module is importable and runs on hosts without a card — a plan service
can run on a CPU-only coordinator node; a plan it solves on ``impl="cuda"``
or ``"cuda_fused"`` needs the card only while the fill runs.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional

from ..obs import metrics as _metrics
from ..store.config import default_store
from ..store.objects import ObjectStore
from ..store.plans import PlanStore

DEFAULT_TENANT = "default"


class QuotaExceededError(RuntimeError):
    """A tenant submitted more concurrent requests than its quota allows."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant resource bounds.

    ``max_inflight`` — queued + running requests at any moment (further
    submissions raise); ``max_plans`` — plans this service keeps stored for
    the tenant (oldest evicted on overflow).
    """

    max_inflight: int = 8
    max_plans: int = 64


class PlanService:
    """Queue-fed, quota-bounded, verification-gated planning endpoint."""

    def __init__(self, store: Optional[ObjectStore] = None, *,
                 workers: int = 2,
                 default_quota: TenantQuota = TenantQuota(),
                 quotas: Optional[Dict[str, TenantQuota]] = None):
        if store is None:
            store = default_store(required=True)
        self.plans = PlanStore(store)
        self.default_quota = default_quota
        self.quotas = dict(quotas or {})
        self._workers_wanted = max(1, workers)
        self._queue: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._inflight: Dict[str, Future] = {}
        self._inflight_tenant: Dict[str, str] = {}
        self._admitted: Dict[str, Deque[str]] = {}
        self._closed = False

    # -- lifecycle ---------------------------------------------------------

    def _ensure_workers(self) -> None:
        while len(self._threads) < self._workers_wanted:
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"plan-service-{len(self._threads)}")
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        """Drain the queue and stop the workers (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            threads = list(self._threads)
        for _ in threads:
            self._queue.put(None)
        for t in threads:
            t.join()

    def __enter__(self) -> "PlanService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- quota accounting --------------------------------------------------

    def quota_for(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def _tenant_inflight(self, tenant: str) -> int:
        return sum(1 for t in self._inflight_tenant.values() if t == tenant)

    def _enforce_plan_quota(self, tenant: str) -> None:
        """Evict this tenant's oldest service-admitted plans beyond
        ``max_plans`` (storage the service never wrote is left alone)."""
        quota = self.quota_for(tenant)
        with self._lock:
            admitted = self._admitted.setdefault(tenant, deque())
            evict = []
            while len(admitted) > max(1, quota.max_plans):
                evict.append(admitted.popleft())
        for key in evict:
            if self.plans.delete(key):
                _metrics.counter("plan_service.evictions").inc()

    # -- the request path --------------------------------------------------

    def submit(self, chain, request, *,
               tenant: str = DEFAULT_TENANT) -> "Future":
        """Enqueue one plan request; returns a Future resolving to the
        verified :class:`~repro_torch.plan.MemoryPlan` (or raising the solve's
        error, e.g. :class:`~repro_torch.plan.InfeasiblePlanError`).

        Requests for a content key already queued or running are deduped
        onto the existing Future, regardless of tenant quota pressure.
        """
        key = self.plans.key_for(chain, request, tenant=tenant)
        with self._lock:
            if self._closed:
                raise RuntimeError("PlanService is closed")
            existing = self._inflight.get(key)
            if existing is not None:
                _metrics.counter("plan_service.deduped").inc()
                return existing
            quota = self.quota_for(tenant)
            if self._tenant_inflight(tenant) >= max(1, quota.max_inflight):
                _metrics.counter("plan_service.quota_rejections").inc()
                raise QuotaExceededError(
                    f"tenant {tenant!r} already has "
                    f"{quota.max_inflight} requests in flight")
            fut: Future = Future()
            self._inflight[key] = fut
            self._inflight_tenant[key] = tenant
            self._ensure_workers()
        self._queue.put((key, chain, request, tenant, fut))
        return fut

    def plan(self, chain, request, *, tenant: str = DEFAULT_TENANT) -> Any:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(chain, request, tenant=tenant).result()

    # -- workers -----------------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            key, chain, request, tenant, fut = item
            try:
                fut.set_result(self._resolve(key, chain, request, tenant))
            except BaseException as e:  # propagate to the submitter
                fut.set_exception(e)
            finally:
                with self._lock:
                    self._inflight.pop(key, None)
                    self._inflight_tenant.pop(key, None)

    def _resolve(self, key: str, chain, request, tenant: str) -> Any:
        from ..check import PlanVerificationError
        from ..store.keys import PlanKey

        try:
            plan = self.plans.get_key(
                key, expect=PlanKey.for_plan(chain, request), strict=True)
        except PlanVerificationError:
            # tampered / semantically invalid stored entry: PlanStore has
            # already quarantined it; the service answers with a fresh solve
            _metrics.counter("plan_service.verify_rejects").inc()
            plan = None
        if plan is not None:
            _metrics.counter("plan_service.hits").inc()
            return plan
        _metrics.counter("plan_service.misses").inc()
        plan = self._solve(chain, request)
        _metrics.counter("plan_service.solves").inc()
        stored_key = self.plans.put(plan, chain=chain, request=request,
                                    tenant=tenant)
        with self._lock:
            self._admitted.setdefault(tenant, deque()).append(stored_key)
        self._enforce_plan_quota(tenant)
        return plan

    @staticmethod
    def _solve(chain, request) -> Any:
        from ..plan import build_plan
        return build_plan(request, chain)
