"""The port's static schedule verifier (``repro_torch.check``,
``MemoryPlan.verify``) against the JAX package's ``repro.check`` on the same
seeded chains and schedules:

- the solver's (``optimal``, ``revolve``), offload, min-memory and baseline
  plans verify in both packages, with the same rules run;
- the JAX package's mutation suite (every single-op drop, duplicate, swap
  and stage shift of a solved schedule) gives the same ``ok``, the same
  violations (kind and op index, in order) and the same slot-discipline
  findings in both, and the port's verdict equals its simulator's;
- the metadata cross-check catches a valid schedule whose cost changed;
- ``REPRO_CHECK=1`` makes ``bind``/``execute`` refuse a corrupted plan;
- ``run_serving`` refuses a tampered kv plan with ``PlanVerificationError``
  and serves the untampered one (a 2-layer narrow model on the CPU)."""

import dataclasses

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.check import verify_schedule as jverify  # noqa: E402
from repro.check import verify_slot_discipline as jverify_slots  # noqa: E402
from repro.core.chain import Chain, HostTransferModel  # noqa: E402
from repro.core.schedule import Schedule as JSchedule  # noqa: E402
from repro.plan import Budget as JBudget  # noqa: E402
from repro.plan import PlanRequest as JRequest  # noqa: E402
from repro.plan import build_plan as jbuild  # noqa: E402
from repro_torch.check import (VIOLATION_KINDS,  # noqa: E402
                               PlanVerificationError, verify_schedule,
                               verify_slot_discipline)
from repro_torch.check import schedule_verifier  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import schedule as pschedule  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.core.schedule import Schedule, simulate  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.plan import Budget, PlanRequest, build_plan  # noqa: E402
from repro_torch.plan.serving import plan_serving  # noqa: E402
from repro_torch.runtime.serve_loop import (ServeLoopConfig,  # noqa: E402
                                            run_serving)

from helpers import random_chain  # noqa: E402

SEEDS = range(4)
LINK = 0.5
SLOTS = 25


def _port(ch: Chain) -> PChain:
    host = None if ch.host is None else PHost(
        bandwidth_d2h=ch.host.bandwidth_d2h)
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob, host=host)


def _mutations(rng, ops):
    """Single-op corruptions of an op list (the JAX package's suite,
    ``tests/test_check_verifier.py``): drop, duplicate, swap with the next
    op, shift a stage index."""
    out = []
    for i in range(len(ops)):
        out.append(("drop", ops[:i] + ops[i + 1:]))
        out.append(("dup", ops[:i] + [ops[i]] + ops[i:]))
    for i in range(len(ops) - 1):
        if ops[i] != ops[i + 1]:
            swapped = list(ops)
            swapped[i], swapped[i + 1] = swapped[i + 1], swapped[i]
            out.append(("swap", swapped))
    for i in range(len(ops)):
        kind, arg = ops[i]
        shifted = list(ops)
        shifted[i] = (kind, arg + int(rng.choice([-1, 1])))
        out.append(("shift", shifted))
    return out


def _plans(ch: Chain):
    """Equal (JAX, port) plans of every kind on ``ch`` (host link given to
    both for the three-tier ones); infeasible requests are skipped."""
    hch = ch.with_host(HostTransferModel(bandwidth_d2h=LINK))
    reqs = [dict(strategy="store_all"), dict(strategy="full_remat"),
            dict(strategy="periodic", segments=2),
            dict(strategy="min_memory"),
            dict(strategy="min_memory", tiers=("device", "host"))]
    for f in (0.5, 0.7, 1.0):
        reqs += [dict(strategy="optimal", budget=f),
                 dict(strategy="revolve", budget=f),
                 dict(strategy="optimal", budget=f,
                      tiers=("device", "host"))]
    for kw in reqs:
        f = kw.pop("budget", None)
        host = "host" in kw.get("tiers", ())
        jch = hch if host else ch
        try:
            want = jbuild(JRequest(num_slots=SLOTS, budget=f and
                                   JBudget.fraction(f), **kw), jch)
        except MemoryError:
            continue
        got = build_plan(PlanRequest(num_slots=SLOTS, budget=f and
                                     Budget.fraction(f), **kw), _port(jch))
        assert got.schedule.ops == list(want.schedule.ops)
        yield jch, want, got


def _same_report(got, want):
    assert got.ok == want.ok
    assert got.rules == want.rules
    assert [(v.kind, v.op_index, v.op) for v in got.violations] == \
        [(v.kind, v.op_index, v.op) for v in want.violations]
    assert [v.state for v in got.violations] == \
        [v.state for v in want.violations]


def test_vocabulary_matches_the_schedule_module_and_jax():
    from repro.check import VIOLATION_KINDS as JKINDS
    assert VIOLATION_KINDS == JKINDS
    for name in ("F_NONE", "F_CK", "F_ALL", "BWD", "F_OFF", "PREFETCH"):
        assert getattr(schedule_verifier, name) == getattr(pschedule, name)


@pytest.mark.parametrize("seed", SEEDS)
def test_every_kind_of_plan_verifies_in_both(seed):
    ch = random_chain(np.random.default_rng(seed), max_len=6)
    kinds = set()
    for _, want, got in _plans(ch):
        rep, jrep = got.verify(), want.verify()
        assert rep.ok, rep.summary()
        assert jrep.ok, jrep.summary()
        assert rep.rules == jrep.rules
        kinds.add((got.request.strategy, got.uses_offload))
    assert {"store_all", "full_remat", "periodic", "optimal",
            "min_memory"} <= {k for k, _ in kinds}


@pytest.mark.parametrize("seed", SEEDS)
def test_mutation_suite_matches_jax(seed):
    rng = np.random.default_rng(300 + seed)
    total = rejected = 0
    for draw in range(3):
        ch = random_chain(rng, max_len=4)
        for jch, want, got in _plans(ch):
            if got.request.strategy not in ("optimal", "min_memory"):
                continue
            pch, budget = got.chain, got.budget_bytes
            for tag, ops in _mutations(rng, list(got.schedule.ops)):
                bad = Schedule(ops=ops, length=got.length)
                jbad = JSchedule(ops=ops, length=got.length)
                rep = verify_schedule(bad, chain=pch, device_budget=budget)
                jrep = jverify(jbad, chain=jch, device_budget=budget)
                _same_report(rep, jrep)
                # the verifier and the port's simulator agree on validity
                assert simulate(pch, bad, budget).valid == rep.ok, tag
                if got.request.strategy == "optimal" and not got.uses_offload:
                    _same_report(
                        verify_slot_discipline(bad, pch, budget, SLOTS),
                        jverify_slots(jbad, jch, budget, SLOTS))
                plan_rep = dataclasses.replace(got, schedule=bad).verify()
                jplan_rep = dataclasses.replace(want, schedule=jbad).verify()
                assert plan_rep.ok == jplan_rep.ok, tag
                assert plan_rep.first_kind == jplan_rep.first_kind, tag
                total += 1
                rejected += not plan_rep.ok
    assert total > 200
    assert rejected / total >= 0.95


def test_structural_pass_without_a_chain():
    sched = Schedule(ops=[("Fall", 1), ("Fall", 2), ("B", 1)], length=1)
    rep = verify_schedule(sched)
    assert not rep.ok and rep.violations[0].kind == "missing-grad"
    assert rep.rules == ["liveness", "offload-protocol", "output"]
    jrep = jverify(JSchedule(ops=list(sched.ops), length=1))
    _same_report(rep, jrep)


def test_metadata_check_catches_a_changed_cost():
    ch = random_chain(np.random.default_rng(5), max_len=5)
    _, want, got = next(p for p in _plans(ch)
                        if p[2].request.strategy == "optimal"
                        and not p[2].uses_offload)
    for name in ("expected_time", "peak_device_mem", "peak_host_mem"):
        bad = dataclasses.replace(got, **{name: getattr(got, name) + 1.0})
        jbad = dataclasses.replace(want, **{name: getattr(want, name) + 1.0})
        rep, jrep = bad.verify(), jbad.verify()
        assert rep.first_kind == jrep.first_kind == "metadata-drift"
        assert rep.rules == jrep.rules
    # a duplicated leading forward: still a valid schedule, another cost
    ops = list(got.schedule.ops)
    dup = dataclasses.replace(
        got, schedule=Schedule(ops=[ops[0]] + ops, length=got.length))
    assert simulate(got.chain, dup.schedule).valid
    assert dup.verify().first_kind == "metadata-drift"


def test_min_memory_fallback_verifies_in_the_port():
    """A min-memory fallback fits its budget byte for byte; the port skips
    the slot pass on it (its solver discretized against the store-all
    peak).  Where the JAX package's slot pass refuses it, the port's
    ``verify_slot_discipline`` on the same inputs reports the same
    finding: only the gate differs."""
    differing = 0
    for seed in range(40):
        ch = random_chain(np.random.default_rng(seed), max_len=7)
        kw = dict(budget=1.0, num_slots=40, on_infeasible="min_memory")
        try:
            want = jbuild(JRequest(**{**kw, "budget": JBudget.bytes(1.0)}),
                          ch)
        except MemoryError:
            continue
        got = build_plan(PlanRequest(**{**kw, "budget": Budget.bytes(1.0)}),
                         _port(ch))
        assert got.fallback and got.schedule.ops == list(want.schedule.ops)
        assert got.verify().ok
        jrep = want.verify()
        if not jrep.ok:
            assert jrep.first_kind == "slot-discipline"
            _same_report(
                verify_slot_discipline(got.schedule, got.chain,
                                       got.budget_bytes, 40),
                jverify_slots(want.schedule, ch, want.budget_bytes, 40))
            differing += 1
    assert differing >= 1


def _corrupt(plan):
    ops = list(plan.schedule.ops)
    del ops[len(ops) // 2]
    return dataclasses.replace(
        plan, schedule=Schedule(ops=ops, length=plan.schedule.length))


def test_repro_check_gates_bind_and_execute(monkeypatch):
    ch = _port(random_chain(np.random.default_rng(7), max_len=5))
    plan = build_plan(PlanRequest(budget=Budget.fraction(0.8),
                                  num_slots=SLOTS), ch)
    bad = _corrupt(plan)
    assert not bad.verify().ok
    stages = [lambda p, a: a * 2.0] * plan.length + [lambda p, a: a.sum()]
    stages = stages[:plan.length + 1]
    params = [{}] * (plan.length + 1)
    x = torch.ones(3)
    monkeypatch.delenv("REPRO_CHECK", raising=False)
    bad.bind(stages)                    # not verified without the gate
    monkeypatch.setenv("REPRO_CHECK", "1")
    with pytest.raises(PlanVerificationError, match="refusing to bind"):
        bad.bind(stages)
    with pytest.raises(PlanVerificationError, match="refusing to execute"):
        bad.execute(stages, params, x)
    out, _, _ = plan.bind(stages).value_and_grad(params, x)
    assert float(out) == 3 * 2.0 ** plan.length
    plan.execute(stages, params, x)
    # the gate also verifies every plan build_plan returns
    from repro_torch.obs import metrics
    metrics.reset()
    again = build_plan(plan.request, ch)
    assert again.schedule.ops == plan.schedule.ops
    assert metrics.registry().get("plan.verify_seconds").count == 1
    metrics.reset()


def test_run_serving_refuses_a_tampered_kv_plan():
    cfg = smoke_config("qwen1.5-4b", num_layers=2, layer_kinds=("dense",) * 2,
                       n_chunks=2)
    model = StagedLM(cfg)
    params = model.init(0, "cpu")
    B, S0, max_len = 2, 6, 12
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S0)).astype(np.int32)
    total = sum(model.cache_layout(B, max_len).block_bytes)
    plan = plan_serving(cfg, 0.5 * total, batch=B, prompt_len=S0,
                        max_len=max_len, host=PHost(12e9), impl="plain")
    assert plan.verify().ok
    loop = ServeLoopConfig(max_new_tokens=4, max_len=max_len)
    with pytest.raises(PlanVerificationError,
                       match="refusing to serve an unverified kv plan"):
        run_serving(cfg, params, prompts, loop, model=model, device="cpu",
                    plan=_corrupt(plan), kv_budget=0.5 * total)
    stale = dataclasses.replace(plan, expected_time=plan.expected_time * 2)
    with pytest.raises(PlanVerificationError, match="metadata-drift"):
        run_serving(cfg, params, prompts, loop, model=model, device="cpu",
                    plan=stale, kv_budget=0.5 * total)
    got = run_serving(cfg, params, prompts, loop, model=model, device="cpu",
                      plan=plan, kv_budget=0.5 * total)
    want = run_serving(cfg, params, prompts, loop, model=model, device="cpu")
    np.testing.assert_array_equal(got["generations"], want["generations"])
    assert got["kv_host_layers"]
