"""The port's plan service and plan persistence: hit/miss flow,
single-flight dedup, per-tenant namespaces and quotas, and the
verification gate of ``repro_torch.runtime.PlanService`` /
``repro_torch.store.PlanStore`` — a tampered plan in a shared store
(byte-level or semantic) is quarantined and re-solved; it never crosses
the service boundary into ``bind``/``execute``.  Then ``MemoryPlan.save``
/ ``load`` (a path, ``file://``, ``store://``): verified on both ends,
staleness named per component (chain, code, request), a plan that loads
where torch cannot be imported, and a plan saved, loaded and executed on
the CPU whose loss and gradients equal the unsaved plan's and the JAX
package's.

Every wait on a future and every worker join has a timeout.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.core.chain import Chain as JChain  # noqa: E402
from repro.core.chain import HostTransferModel as JHost  # noqa: E402
from repro.plan.compat import resolve_policy as jresolve  # noqa: E402
from repro_torch.check import PlanVerificationError  # noqa: E402
from repro_torch.core import solver_cache  # noqa: E402
from repro_torch.core.chain import Chain, HostTransferModel  # noqa: E402
from repro_torch.plan import (Budget, MemoryPlan, PlanRequest,  # noqa: E402
                              StalePlanError, build_plan, resolve_policy)
from repro_torch.runtime import (PlanService,  # noqa: E402
                                 QuotaExceededError, TenantQuota)
from repro_torch.store import (  # noqa: E402
    LocalDirectoryBackend,
    MemoryBackend,
    ObjectStore,
    PlanStore,
    decode,
    encode,
)

from helpers import make_mlp_chain  # noqa: E402

WAIT = 30  # seconds: every future and join in this file is bounded


@contextlib.contextmanager
def _service(*args, **kwargs):
    svc = PlanService(*args, **kwargs)
    try:
        yield svc
    finally:
        _close(svc)


def _close(svc: PlanService) -> None:
    """``svc.close()`` on a thread of the test's own, joined within WAIT."""
    closer = threading.Thread(target=svc.close, daemon=True)
    closer.start()
    closer.join(WAIT)
    assert not closer.is_alive(), f"PlanService.close took over {WAIT} s"


NUM_SLOTS = 48


def _chain(L: int = 8, seed: int = 0) -> Chain:
    rng = np.random.default_rng(seed)
    n = L + 1
    return Chain.make(
        uf=rng.integers(1, 5, n).astype(float),
        ub=rng.integers(1, 5, n).astype(float),
        wa=rng.integers(1, 4, n).astype(float),
        wabar=rng.integers(1, 6, n).astype(float),
    )


def _request(chain: Chain, frac: float = 0.6) -> PlanRequest:
    return PlanRequest(
        strategy="optimal",
        budget=Budget.bytes(chain.store_all_peak() * frac),
        num_slots=NUM_SLOTS,
    )


def _counts():
    from repro_torch.obs import metrics

    snap = metrics.registry().snapshot()
    return {k: int(v.get("count", 0)) for k, v in snap.items()}


def test_miss_solve_then_verified_hit():
    ch = _chain()
    req = _request(ch)
    before = _counts()
    svc = PlanService(ObjectStore(MemoryBackend()))
    first = svc.submit(ch, req).result(timeout=WAIT)
    second = svc.submit(ch, req).result(timeout=WAIT)
    _close(svc)
    after = _counts()
    assert first.expected_time == second.expected_time
    assert first.verify().ok and second.verify().ok
    delta = lambda k: after.get(k, 0) - before.get(k, 0)  # noqa: E731
    assert delta("plan_service.misses") == 1
    assert delta("plan_service.solves") == 1
    assert delta("plan_service.hits") == 1


def test_single_flight_dedup(monkeypatch):
    release = threading.Event()
    orig = PlanService._solve

    def slow_solve(chain, request):
        assert release.wait(WAIT)
        return orig(chain, request)

    monkeypatch.setattr(PlanService, "_solve", staticmethod(slow_solve))
    ch = _chain()
    req = _request(ch)
    with _service(ObjectStore(MemoryBackend()), workers=1) as svc:
        f1 = svc.submit(ch, req)
        f2 = svc.submit(ch, req)
        assert f2 is f1, "same content key must share one solve"
        release.set()
        assert f1.result(timeout=WAIT).verify().ok


def test_inflight_quota_rejects_excess(monkeypatch):
    release = threading.Event()
    orig = PlanService._solve

    def slow_solve(chain, request):
        assert release.wait(WAIT)
        return orig(chain, request)

    monkeypatch.setattr(PlanService, "_solve", staticmethod(slow_solve))
    ch = _chain()
    quota = TenantQuota(max_inflight=1)
    with _service(
        ObjectStore(MemoryBackend()), workers=1, default_quota=quota
    ) as svc:
        f1 = svc.submit(ch, _request(ch, 0.5))
        with pytest.raises(QuotaExceededError):
            svc.submit(ch, _request(ch, 0.9))
        # a different tenant is unaffected by this tenant's pressure
        f3 = svc.submit(ch, _request(ch, 0.9), tenant="other")
        release.set()
        assert f1.result(timeout=WAIT) is not None
        assert f3.result(timeout=WAIT) is not None


def test_max_plans_evicts_oldest():
    ch = _chain()
    store = ObjectStore(MemoryBackend())
    quota = TenantQuota(max_inflight=64, max_plans=2)
    with _service(store, default_quota=quota) as svc:
        for frac in (0.5, 0.7, 0.9):
            svc.submit(ch, _request(ch, frac)).result(timeout=WAIT)
    remaining = PlanStore(store).keys(tenant="default")
    assert len(remaining) == 2, remaining


def test_tenant_namespaces_are_disjoint():
    ch = _chain()
    req = _request(ch)
    store = ObjectStore(MemoryBackend())
    with _service(store) as svc:
        svc.submit(ch, req, tenant="alice").result(timeout=WAIT)
        svc.submit(ch, req, tenant="bob").result(timeout=WAIT)
    plans = PlanStore(store)
    assert len(plans.keys(tenant="alice")) == 1
    assert len(plans.keys(tenant="bob")) == 1
    a, b = plans.keys(tenant="alice")[0], plans.keys(tenant="bob")[0]
    assert a != b and a.startswith("plans/alice/")


# -- the verification gate ---------------------------------------------------


def _store_one_plan(tmp_path, tenant=None):
    backend = LocalDirectoryBackend(tmp_path)
    store = ObjectStore(backend)
    plans = PlanStore(store)
    ch = _chain()
    req = _request(ch)
    plan = build_plan(req, ch)
    key = plans.put(plan, chain=ch, request=req, tenant=tenant)
    (entry,) = [
        p
        for p in tmp_path.iterdir()
        if p.suffix == ".pkl" and p.name.startswith("plans__")
    ]
    return backend, plans, ch, req, key, entry


def test_byte_tampered_plan_rejected_as_store_corrupt(tmp_path):
    _, plans, ch, req, key, entry = _store_one_plan(tmp_path)
    data = bytearray(entry.read_bytes())
    data[len(data) // 2] ^= 0xFF
    entry.write_bytes(bytes(data))
    with pytest.raises(PlanVerificationError) as ei:
        plans.get(ch, req, strict=True)
    assert [v.kind for v in ei.value.report.violations] == ["store-corrupt"]
    # quarantined on first contact: now a plain miss, and never served
    assert plans.get(ch, req) is None
    assert (tmp_path / "_quarantine").exists()


def test_semantically_tampered_plan_fails_verify(tmp_path):
    backend, plans, ch, req, key, entry = _store_one_plan(tmp_path)
    # a *well-encoded* forgery: doctor the makespan and re-envelope with the
    # correct kind/key — the codec accepts it, MemoryPlan.verify() must not
    _, _, payload = decode(entry.read_bytes(), key=key)
    payload["plan"].expected_time += 5.0
    backend.put(key, encode("memory-plan", key, payload))
    with pytest.raises(PlanVerificationError) as ei:
        plans.get(ch, req, strict=True)
    kinds = {v.kind for v in ei.value.report.violations}
    assert "metadata-drift" in kinds
    assert plans.get(ch, req) is None  # quarantined


def test_service_never_serves_tampered_plan(tmp_path):
    backend, plans, ch, req, key, entry = _store_one_plan(
        tmp_path, tenant="default"
    )
    data = bytearray(entry.read_bytes())
    data[-10] ^= 0xFF
    entry.write_bytes(bytes(data))
    before = _counts()
    with _service(ObjectStore(backend)) as svc:
        served = svc.submit(ch, req).result(timeout=WAIT)
    after = _counts()
    # the tampered entry was rejected and the service re-solved: the caller
    # still gets a plan, and it is a verified fresh one
    assert served.verify().ok
    assert after.get("plan_service.verify_rejects", 0) - before.get(
        "plan_service.verify_rejects", 0
    ) == 1
    assert after.get("plan_service.solves", 0) - before.get(
        "plan_service.solves", 0
    ) == 1


def test_wrong_chain_fingerprint_rejected(tmp_path):
    backend, plans, ch, req, key, entry = _store_one_plan(tmp_path)
    # re-home the entry under a different chain's address: the fingerprint
    # cross-check must refuse to serve it there
    other = _chain(seed=99)
    other_key = plans.key_for(other, req)
    _, _, payload = decode(entry.read_bytes(), key=key)
    backend.put(other_key, encode("memory-plan", other_key, payload))
    assert plans.get(other, req) is None


def test_concurrent_identical_requests_make_one_solve():
    """Eight threads submit the same request (two tenants, four each) while
    the solve is held back: one solve per tenant's content key, the other
    submissions deduped onto its future, every answer the same verified
    schedule."""
    release = threading.Event()
    solves = []
    orig = PlanService._solve

    def slow_solve(chain, request):
        solves.append(1)
        assert release.wait(WAIT)
        return orig(chain, request)

    ch = _chain()
    req = _request(ch)
    futures, errors = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PlanService, "_solve", staticmethod(slow_solve))
        with _service(ObjectStore(MemoryBackend()), workers=2) as svc:
            def submit(tenant):
                try:
                    futures.append(svc.submit(ch, req, tenant=tenant))
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=submit,
                                        args=("alice" if i % 2 else "bob",))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
                assert not t.is_alive()
            release.set()
            plans = [f.result(timeout=WAIT) for f in futures]
    assert not errors, errors
    assert len(plans) == 8 and len(solves) == 2
    assert len({id(f) for f in futures}) == 2
    for p in plans:
        assert p.verify().ok and p.schedule.ops == plans[0].schedule.ops


# -- MemoryPlan.save / load ----------------------------------------------------


def _plan_and_chain(seed=0, frac=0.6):
    ch = _chain(seed=seed)
    return build_plan(_request(ch, frac), ch), ch


@pytest.mark.parametrize("scheme", ["path", "file", "store"])
def test_save_load_roundtrip(tmp_path, monkeypatch, scheme):
    from repro_torch.store import config

    plan, ch = _plan_and_chain()
    if scheme == "store":
        monkeypatch.setenv("REPRO_STORE", f"file://{tmp_path / 'store'}")
        config.reset()
        target = "store://plans/saved/qwen-rotor"
    else:
        path = tmp_path / "p.plan"
        target = str(path) if scheme == "path" else f"file://{path}"
    try:
        plan.save(target)
        got = MemoryPlan.load(target, chain=ch, request=plan.request)
    finally:
        config.reset()
    assert got.schedule.ops == plan.schedule.ops
    assert got.expected_time == plan.expected_time
    assert got.chain_hash == plan.chain_hash and got.verify().ok


def test_load_names_the_stale_component(tmp_path, monkeypatch):
    plan, ch = _plan_and_chain()
    path = str(tmp_path / "p.plan")
    plan.save(path)
    edited = dataclasses.replace(ch, uf=np.asarray(ch.uf) * 1.5)
    with pytest.raises(StalePlanError, match=r"diverged in: chain"):
        MemoryPlan.load(path, chain=edited)
    other = dataclasses.replace(plan.request, num_slots=plan.num_slots + 1)
    with pytest.raises(StalePlanError, match=r"diverged in: request"):
        MemoryPlan.load(path, chain=ch, request=other)
    monkeypatch.setattr(solver_cache, "_code_fingerprint", "0" * 64)
    with pytest.raises(StalePlanError, match=r"diverged in: code"):
        MemoryPlan.load(path, chain=ch)
    with pytest.raises(StalePlanError, match="chain .*; code"):
        MemoryPlan.load(path, chain=edited)
    with pytest.raises(StalePlanError):
        plan.validate_chain(edited)
    plan.validate_chain(ch)


def test_tampered_and_invalid_plans_are_refused(tmp_path):
    plan, ch = _plan_and_chain()
    path = tmp_path / "p.plan"
    plan.save(str(path))
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    bad = tmp_path / "bad.plan"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="not a saved MemoryPlan"):
        MemoryPlan.load(str(bad), chain=ch)
    # a well-encoded forgery (a doctored makespan) fails verification
    _, _, payload = decode(path.read_bytes(), key="plan")
    payload["plan"].expected_time += 1.0
    path.write_bytes(encode("memory-plan", "plan", payload))
    with pytest.raises(PlanVerificationError):
        MemoryPlan.load(str(path), chain=ch)
    # and an invalid plan never reaches the disk
    broken = dataclasses.replace(plan, expected_time=plan.expected_time + 1)
    with pytest.raises(PlanVerificationError):
        broken.save(str(tmp_path / "never.plan"))
    assert not (tmp_path / "never.plan").exists()


def test_saved_plan_loads_where_torch_cannot_be_imported(tmp_path):
    """Only the MemoryPlan is pickled — host objects — so a plan saved here
    loads, verifies and checks its chain in a process that cannot import
    torch (a host without a card)."""
    plan, ch = _plan_and_chain(frac=0.5)
    path = tmp_path / "p.plan"
    plan.save(str(path))
    arrays = {k: np.asarray(getattr(ch, k)).tolist()
              for k in ("uf", "ub", "wa", "wabar")}
    code = f"""
import sys
sys.modules["torch"] = None
from repro_torch.core.chain import Chain
from repro_torch.plan import MemoryPlan
ch = Chain.make(**{arrays!r})
plan = MemoryPlan.load({str(path)!r}, chain=ch)
print(plan.schedule.ops)
"""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(plan.schedule.ops)


@pytest.mark.parametrize("policy", ["rotor:x0.6", "optimal_offload:x0.4:1.0"])
def test_saved_plan_executes_as_the_unsaved_one_and_jax(tmp_path, policy):
    """On the tanh MLP chain: the plan saved and loaded runs through
    ``bind(...).value_and_grad`` with the unsaved plan's loss and gradients
    (bit for bit) and the JAX package's plan's (rtol 1e-5)."""
    L = 6
    jch = JChain.make(uf=[1.0] * L + [0.0], ub=[2.0] * L + [0.0],
                      wa=[1.0] * (L + 1), wabar=[2.0] * L + [0.0],
                      host=JHost(bandwidth_d2h=1.0))
    ch = Chain.make(uf=jch.uf, ub=jch.ub, wa=jch.wa, wabar=jch.wabar,
                    host=HostTransferModel(bandwidth_d2h=1.0))
    plan = resolve_policy(policy, ch, num_slots=64)
    jplan = jresolve(policy, jch, num_slots=64)
    assert plan.schedule.ops == jplan.schedule.ops
    path = str(tmp_path / "p.plan")
    plan.save(path)
    loaded = MemoryPlan.load(path, chain=ch)

    stages, params, x = make_mlp_chain(L)
    jout, jgrads, _ = jplan.execute(stages, params, x)
    pstages = [lambda p, a: torch.tanh(a @ p["w"] + p["b"])] * L
    pstages.append(lambda p, a: torch.mean(a ** 2))
    pparams = [{k: torch.from_numpy(np.array(v)).requires_grad_()
                for k, v in p.items()} for p in params]
    px = torch.from_numpy(np.array(x))
    want = plan.bind(pstages).value_and_grad(pparams, px)
    got = loaded.bind(pstages).value_and_grad(pparams, px)
    assert torch.equal(got[0], want[0])
    np.testing.assert_allclose(got[0].item(), float(jout), rtol=1e-5)
    for l in range(L):
        for k in ("w", "b"):
            assert torch.equal(got[1][l][k], want[1][l][k])
            np.testing.assert_allclose(got[1][l][k].numpy(),
                                       np.asarray(jgrads[l][k]),
                                       rtol=1e-5, atol=1e-7)
