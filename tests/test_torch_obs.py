"""The port's observability (``repro_torch.obs``) against the JAX package's
``repro.obs``, on the CPU:

- the metrics registry: its kinds, the no-op mode and the snapshot's JSON
  schema, equal to the JAX package's for the same operations;
- on identical span lists, ``measured_stage_times``, ``compare``,
  ``calibrate_from_trace`` and ``Chain.calibrate`` equal the JAX package's
  (relative 1e-12), and ``to_perfetto`` passes both packages'
  ``validate_perfetto``;
- a traced run of a 2-layer narrow ``StagedLM`` under a rotor plan gives
  one span per schedule op, in order, and the untraced nested-checkpoint
  run's gradients (float32, 1e-5); an offload plan's walker spans carry
  the copies' bytes and the host buffer's occupancy;
- ``run_training(trace_path=...)`` writes a file ``validate_trace_file``
  accepts; the traced ``run_serving`` has one ``Decode`` span per decode
  step, and its ``serve.*`` metrics equal its returned dict;
- the traced trade-off (``launch.tradeoff``, ``trace=True``) calibrates on
  its points' spans and prices the schedules that ran on that chain.

The CUDA tracer (event pairs on two streams) is held on the card by
``tests/test_torch_cuda.py``."""

import json
import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core.chain import Chain as JChain  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs.drift import calibrate_from_trace as jcalibrate  # noqa: E402
from repro.obs.drift import compare as jcompare  # noqa: E402
from repro.obs.trace import Span as JSpan  # noqa: E402
from repro.obs.trace import measured_stage_times as jstage_times  # noqa: E402
from repro.obs.trace import validate_perfetto as jvalidate  # noqa: E402
from repro.plan import Budget as JBudget  # noqa: E402
from repro.plan import PlanRequest as JRequest  # noqa: E402
from repro.plan import build_plan as jbuild  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.chain import Chain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.core.schedule import simulate  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.launch.steps import plan_chain  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.obs.drift import calibrate_from_trace, compare  # noqa: E402
from repro_torch.obs.trace import (Span, Tracer, category_of,  # noqa: E402
                                   measured_stage_times, transfer_overlap,
                                   validate_perfetto, validate_trace_file)
from repro_torch.offload.host_buffer import HostBuffer  # noqa: E402
from repro_torch.plan import (Budget, PlanRequest, build_plan,  # noqa: E402
                              resolve_policy)
from repro_torch.plan.serving import plan_serving  # noqa: E402
from repro_torch.runtime.serve_loop import (ServeLoopConfig,  # noqa: E402
                                            run_serving)
from repro_torch.runtime.train_loop import (TrainLoopConfig,  # noqa: E402
                                            run_training)
from repro_torch.tree import tensors_of  # noqa: E402

from helpers import random_chain  # noqa: E402

CFG = dict(num_layers=2, layer_kinds=("dense",) * 2, n_chunks=2)
B, S = 2, 16


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def _exercise(m):
    m.counter("a.b").inc()
    m.counter("a.b").inc(5)
    m.gauge("g.x").set(3.0)
    m.gauge("g.x").set(1.5)
    h = m.histogram("h.y")
    for v in (0.5, 2.0, 1.0):
        h.observe(v)
    m.histogram("h.empty")


def test_metrics_registry_kinds_and_schema_match_jax():
    reg = metrics.MetricsRegistry(enabled=True)
    jreg = jmetrics.MetricsRegistry(enabled=True)
    _exercise(reg)
    _exercise(jreg)
    assert reg.snapshot() == jreg.snapshot()
    snap = reg.snapshot()
    assert snap["a.b"] == {"type": "counter", "count": 2, "total": 6.0}
    assert snap["g.x"] == {"type": "gauge", "value": 1.5, "max": 3.0,
                           "updates": 2}
    assert snap["h.y"]["min"] == 0.5 and snap["h.y"]["last"] == 1.0
    assert snap["h.empty"]["min"] is None
    assert reg.value("a.b") == 2 and reg.value("g.x") == 1.5
    assert reg.value("h.y") == 3 and reg.value("nope", 7.0) == 7.0
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("a.b")
    with reg.histogram("t.z").time():
        pass
    assert reg.get("t.z").count == 1
    reg.reset()
    assert reg.snapshot() == {}


def test_metrics_disabled_is_noop(monkeypatch):
    reg = metrics.MetricsRegistry(enabled=False)
    _exercise(reg)
    with reg.histogram("t").time():
        pass
    assert reg.snapshot() == {} and reg.get("a.b") is None
    monkeypatch.setenv("REPRO_METRICS", "0")
    metrics.reset()
    metrics.counter("x").inc()
    assert metrics.snapshot() == {}
    assert not metrics.registry().enabled


def test_metrics_snapshot_round_trip(tmp_path):
    _exercise(metrics.registry())
    path = tmp_path / "metrics.json"
    metrics.save(str(path))
    doc = json.loads(path.read_text())
    assert doc == metrics.snapshot()
    assert doc["a.b"]["total"] == 6.0


def test_host_buffer_publishes_occupancy_and_evictions():
    hb = HostBuffer(capacity_bytes=100)
    hb.put("a", None, nbytes=60)
    hb.put("b", None, nbytes=30)
    assert metrics.value("host_buffer.bytes_in_use") == 90
    hb.pop("a")
    assert metrics.value("host_buffer.bytes_in_use") == 30
    hb.put("c", None, nbytes=50)
    hb.put("d", None, nbytes=80, evict=True)    # evicts b and c
    gauge = metrics.registry().get("host_buffer.bytes_in_use")
    assert gauge.value == 80 and gauge.max == 90
    assert metrics.counter("host_buffer.evictions").total == 2


# ---------------------------------------------------------------------------
# spans, drift and calibration against the JAX package
# ---------------------------------------------------------------------------

def _port(ch: JChain) -> Chain:
    return Chain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                      wdelta=ch.wdelta, of=ch.of, ob=ch.ob)


def _random_spans(rng, plan, steps=2):
    """Span pairs (JAX, port) timing ``plan``'s ops over ``steps`` steps
    with random durations, some ops unsampled."""
    js, ps = [], []
    t = 0.0
    for _ in range(steps):
        for op, arg in plan.schedule.ops:
            if rng.random() < 0.1:
                continue
            d = float(rng.uniform(1e-4, 5e-2))
            kw = dict(bytes=int(rng.integers(0, 1000)),
                      device_mem=float(rng.integers(1, 100)),
                      host_mem=(float(rng.integers(0, 50))
                                if op in ("Foff", "Prefetch") else None))
            js.append(JSpan(op, arg, t, t + d, **kw))
            ps.append(Span(op, arg, t, t + d, **kw))
            t += d * float(rng.uniform(0.5, 1.0))
    return js, ps


def _close(a, b):
    if isinstance(a, float) and math.isnan(a):
        assert math.isnan(b)
    elif isinstance(a, float):
        assert math.isclose(a, b, rel_tol=1e-12), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(4))
def test_drift_and_calibration_match_jax(seed):
    rng = np.random.default_rng(seed)
    jch = random_chain(rng, max_len=6)
    for tiers, host in ((("device",), None),
                        (("device", "host"), 0.5)):
        kw = dict(budget=0.7, tiers=tiers, num_slots=40)
        jhost = None
        if host:
            from repro.core.chain import HostTransferModel
            jhost, phost = HostTransferModel(bandwidth_d2h=host), PHost(host)
        try:
            want = jbuild(JRequest(**{**kw, "budget": JBudget.fraction(0.7)},
                                   host=jhost), jch)
        except MemoryError:
            continue
        got = build_plan(PlanRequest(**{**kw, "budget": Budget.fraction(0.7)},
                                     host=phost if host else None),
                         _port(jch))
        js, ps = _random_spans(rng, got)
        for a, b in zip(measured_stage_times(ps, got.length),
                        jstage_times(js, want.length)):
            for x, y in zip(a, b):
                _close(x, y)
        rep, jrep = compare(got, ps), jcompare(want, js)
        doc, jdoc = rep.to_json(), jrep.to_json()
        layers, jlayers = doc.pop("layers"), jdoc.pop("layers")
        for k in jdoc:
            _close(doc[k], jdoc[k])
        for row, jrow in zip(layers, jlayers):
            for k in jrow:
                _close(row[k], jrow[k])
        _close(rep.layer_mape, jrep.layer_mape)
        assert rep.summary() == jrep.summary()
        assert json.dumps(got.drift(ps).to_json()) == json.dumps(
            rep.to_json())
        cal, jcal = calibrate_from_trace(got.chain, ps), jcalibrate(
            want.chain, js)
        for name in ("uf", "ub"):
            np.testing.assert_allclose(getattr(cal, name),
                                       getattr(jcal, name), rtol=1e-12)
        for name in ("wa", "wabar", "of", "ob"):
            np.testing.assert_array_equal(getattr(cal, name),
                                          getattr(got.chain, name))
        assert cal.host == got.chain.host
        uf, ub = measured_stage_times(ps, got.length)
        for blend in (0.0, 0.25, 1.0):
            c, jc = (got.chain.calibrate(uf=uf, ub=ub, blend=blend),
                     want.chain.calibrate(uf=uf, ub=ub, blend=blend))
            np.testing.assert_allclose(c.uf, jc.uf, rtol=1e-12)
            np.testing.assert_allclose(c.ub, jc.ub, rtol=1e-12)


def test_chain_calibrate_validation_and_zero_drift_replay():
    ch = _port(random_chain(np.random.default_rng(0), max_len=5))
    n = ch.length + 1
    with pytest.raises(ValueError, match="blend"):
        ch.calibrate(uf=ch.uf, blend=1.5)
    with pytest.raises(ValueError, match="shape"):
        ch.calibrate(uf=np.ones(n - 1))
    with pytest.raises(ValueError, match="non-negative"):
        ch.calibrate(ub=np.full(n, -1.0))
    plan = build_plan(PlanRequest(budget=Budget.fraction(0.8),
                                  num_slots=40), ch)
    rep = compare(plan, Tracer.from_timeline(plan.timeline()))
    assert rep.makespan_ratio == 1.0
    assert rep.layer_mape < 1e-9 or math.isnan(rep.layer_mape)


def test_perfetto_export_passes_both_validators(tmp_path):
    ch = _port(random_chain(np.random.default_rng(2), max_len=5))
    plan = build_plan(PlanRequest(budget=Budget.fraction(0.8),
                                  num_slots=40), ch)
    tr = Tracer.from_timeline(plan.timeline(), name="predicted")
    # a span opened earlier but recorded later (a side-stream copy)
    tr.record("Foff", 0, 0.0, 0.5, bytes=8)
    doc = tr.to_perfetto()
    assert len(validate_perfetto(doc)) == len(jvalidate(doc)) == len(tr)
    assert [s.op for s in tr.spans][-1] == "Foff"     # op order kept
    tr.save(str(tmp_path / "t.json"))
    assert validate_trace_file(str(tmp_path / "t.json")) == len(tr)
    for bad in ({}, {"traceEvents": []},
                {"traceEvents": [{"name": "a", "ph": "X", "pid": 1,
                                  "tid": 1, "ts": 0.0, "dur": -1.0}]}):
        with pytest.raises(ValueError):
            validate_perfetto(bad)
    assert category_of("Prefetch") == "transfer"
    assert category_of("whatever") == "misc"


def test_transfer_overlap():
    spans = [Span("Fall", 1, 0.0, 1.0), Span("B", 1, 1.0, 2.0),
             Span("Foff", 0, 0.5, 1.5), Span("Prefetch", 0, 1.8, 2.4),
             Span("Fck", 2, 3.0, 4.0)]
    total, covered = transfer_overlap(spans)
    assert math.isclose(total, 1.6) and math.isclose(covered, 1.2)
    assert transfer_overlap(spans[:2]) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# traced execution on the CPU
# ---------------------------------------------------------------------------

def _model():
    cfg = smoke_config("qwen1.5-4b", **CFG)
    model = StagedLM(cfg)
    params = model.init(0, "cpu")
    batch = SyntheticLMData(cfg, B, S, seed=0).device_batch(0, "cpu")
    chain = plan_chain(model, input_specs(cfg, ShapeSpec("t", "train", S, B)),
                       peak_flops=1e12)
    return model, params, batch, chain


def test_traced_rotor_step_one_span_per_op_and_same_gradients():
    model, params, batch, chain = _model()
    plan = resolve_policy("rotor:x0.6", chain)
    assert plan.remat_expressible and plan.recompute_factor() > 1
    stages, sp = model.stage_fns(), model.stage_params(params)
    tr = Tracer(name="test")
    bound = plan.bind(stages, tracer=tr)
    assert bound.traced and not bound.remat_expressible
    out, grads, _ = bound.value_and_grad(sp, batch)
    assert [(s.op, s.arg) for s in tr.spans] == list(plan.schedule.ops)
    assert all(s.t_end >= s.t_start >= 0 for s in tr.spans)
    assert all(s.bytes > 0 for s in tr.spans if s.op != "B")
    ref_out, ref_grads, _ = plan.bind(stages).value_and_grad(sp, batch)
    assert float(out) == pytest.approx(float(ref_out), rel=1e-5)
    for a, b in zip(tensors_of(model.combine_stage_grads(grads)),
                    tensors_of(model.combine_stage_grads(ref_grads))):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # execute() with a tracer: one more step's spans, the same op order
    plan.execute(stages, sp, batch, tracer=tr)
    assert len(tr) == 2 * len(plan.schedule)
    rep = plan.drift(tr.spans[-len(plan.schedule):])
    assert rep.span_count == len(plan.schedule)
    assert not any(math.isnan(ld.uf_measured) for ld in rep.layers)
    assert validate_perfetto(tr.to_perfetto())
    disabled = Tracer(enabled=False)
    plan.execute(stages, sp, batch, tracer=disabled)
    assert len(disabled) == 0


def test_traced_offload_walker_spans_copies():
    L = 6
    ch = Chain.make(uf=[1.0] * L + [0.0], ub=[2.0] * L + [0.0],
                    wa=[1.0] * (L + 1), wabar=[2.0] * L + [0.0],
                    host=PHost(bandwidth_d2h=1.0))
    plan = resolve_policy("optimal_offload:x0.35:1.0", ch, num_slots=64)
    assert plan.uses_offload
    stages = [lambda p, a: torch.tanh(a @ p["w"])] * L + [
        lambda p, a: torch.mean(a ** 2)]
    g = torch.Generator().manual_seed(0)
    params = [{"w": (torch.randn(8, 8, generator=g) * 0.3).requires_grad_()}
              for _ in range(L)] + [{}]
    x = torch.randn(4, 8, generator=g)
    tr = Tracer()
    out, grads, dx = plan.execute(stages, params, x, tracer=tr)
    assert [(s.op, s.arg) for s in tr.spans] == list(plan.schedule.ops)
    copies = [s for s in tr.spans if s.op in ("Foff", "Prefetch")]
    assert copies and all(s.bytes == x.nbytes for s in copies)
    assert all(s.host_mem is not None for s in copies)
    ref = plan.execute(stages, params, x)
    for a, b in zip(tensors_of(grads), tensors_of(ref[1])):
        torch.testing.assert_close(a, b)
    rep = compare(plan, tr)
    assert rep.measured_stall is not None and rep.measured_stall >= 0


def test_run_training_writes_a_valid_trace(tmp_path):
    cfg = smoke_config("qwen1.5-4b", **CFG)
    path = tmp_path / "trace.json"
    loop = TrainLoopConfig(steps=2, global_batch=B, seq_len=S,
                           policy="rotor:x0.6", peak_flops=1e12,
                           log_every=100, trace_path=str(path))
    out = run_training(cfg, loop, device="cpu", log_fn=lambda s: None)
    n_ops = len(out["plan"].schedule)
    from repro.obs.trace import validate_trace_file as jvalidate_file
    assert validate_trace_file(str(path)) == 2 * n_ops
    assert jvalidate_file(str(path)) == 2 * n_ops
    assert out["drift"].span_count == n_ops
    hist = metrics.registry().get("train.step_seconds")
    assert hist.count == 2 and hist.last == out["steps"][-1]["seconds"]
    assert hist.total == pytest.approx(sum(r["seconds"]
                                           for r in out["steps"]))
    assert metrics.value("train.loss") == out["losses"][-1]
    # the untraced run takes the same losses on the nested checkpoints
    plain = run_training(cfg, TrainLoopConfig(
        steps=2, global_batch=B, seq_len=S, policy="rotor:x0.6",
        peak_flops=1e12, log_every=100), device="cpu",
        log_fn=lambda s: None)
    assert "drift" not in plain
    np.testing.assert_allclose(out["losses"], plain["losses"], rtol=1e-5)
    # store-all has no plan: one Step span per step
    none = tmp_path / "none.json"
    run_training(cfg, TrainLoopConfig(
        steps=2, global_batch=B, seq_len=S, policy="none", log_every=100,
        trace_path=str(none)), device="cpu", log_fn=lambda s: None)
    assert validate_trace_file(str(none)) == 2


def test_traced_run_serving_spans_and_gauges():
    cfg = smoke_config("qwen1.5-4b", **CFG)
    model = StagedLM(cfg)
    params = model.init(0, "cpu")
    Bs, S0, max_len, new = 2, 6, 14, 5
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (Bs, S0)).astype(np.int32)
    total = sum(model.cache_layout(Bs, max_len).block_bytes)
    plan = plan_serving(cfg, 0.5 * total, batch=Bs, prompt_len=S0,
                        max_len=max_len, host=PHost(12e9), impl="plain")
    tr = Tracer(name="serve")
    out = run_serving(cfg, params, prompts, ServeLoopConfig(
        max_new_tokens=new, max_len=max_len), model, tr, device="cpu",
        plan=plan, kv_budget=0.5 * total)
    decodes = [s for s in tr.spans if s.op == "Decode"]
    assert [s.arg for s in decodes] == list(range(1, new))
    span_bytes = [s.bytes for s in decodes]
    assert span_bytes == sorted(span_bytes) and len(set(span_bytes)) == new - 1
    assert span_bytes[-1] == out["kv_bytes"]
    assert [s.op for s in tr.spans if s.op == "Step"] == ["Step"]
    moved = sum(s.bytes for s in tr.spans if s.op in ("Foff", "Prefetch"))
    assert moved == out["kv_transfer_bytes"] > 0
    validate_perfetto(tr.to_perfetto())
    jvalidate(tr.to_perfetto())
    assert metrics.value("serve.kv_bytes") == out["kv_bytes"] > 0
    assert (metrics.value("serve.kv_bytes_allocated")
            == out["kv_bytes_allocated"] > out["kv_bytes"])
    assert metrics.counter("serve.decode_tokens").total == \
        out["decode_tokens"] == Bs * (new - 1)
    assert metrics.counter("serve.kv_transfer_bytes").total == \
        out["kv_transfer_bytes"]
    assert metrics.registry().get("serve.kv_stall_seconds").last == \
        out["kv_stall_s"]
    assert metrics.registry().get("serve.prefill_seconds").last == \
        out["prefill_s"]


def test_traced_tradeoff_calibrates_on_its_spans():
    from repro_torch.launch.tradeoff import run_lm_tradeoff

    model, params, batch, _ = _model()
    lines = []
    out = run_lm_tradeoff(model, params, batch, impl="plain", repeats=1,
                          budgets=(0.7, 1.0), trace=True, emit=lines.append)
    for r in out["rows"]:
        assert [(s.op, s.arg) for s in r["spans"]] == \
            list(r["plan"].schedule.ops)
        assert r["traced_s"] > 0
        assert r["traced_loss"] == pytest.approx(r["loss"], rel=1e-5)
        assert r["traced_grad_norm"] == pytest.approx(r["grad_norm"],
                                                      rel=1e-4)
    cal = out["calibration"]
    spans = [s for r in out["rows"] for s in r["spans"]]
    uf, ub = measured_stage_times(spans, out["chain"].length)
    np.testing.assert_array_equal(cal["chain"].uf, uf)
    np.testing.assert_array_equal(cal["chain"].ub, ub)
    want = 100 * np.mean([
        abs(simulate(cal["chain"], r["plan"].schedule).time
            - r["measured_s"])
        / r["measured_s"] for r in out["rows"]])
    assert cal["mape_percent"] == pytest.approx(want, rel=1e-12)
    assert any("on the calibrated chain" in s for s in lines)
    assert any("largest forward share" in s for s in lines)
