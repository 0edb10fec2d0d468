"""The readers of the program's spans and counters
(``bench/metrics/<name>.py``), on a synthetic run: a trace whose
``under`` holds the program's span names, a plan, and the program's
metrics registry.  Each returns its value, and ``None`` where its input is
missing (as on a program without the spans)."""

import types

import pytest

from bench import registry
from bench.profiling import Trace

NEW = ("step.optimizer_share", "remat.replay_share",
       "remat.forward_runs_ratio", "plan.time_error", "measure.in_chain_s")


@pytest.fixture(autouse=True)
def _fresh_metrics():
    from repro_torch.obs import metrics

    metrics.reset()
    yield
    metrics.reset()


def trace(under):
    # two kernels of 1 s each: 2 s of device time in the shaped step
    return Trace(steps=2, window_s=4.0, busy_s=3.8, device_ops=[],
                 idle_gaps=[], kernels=[("a", 0.0, 1.0), ("b", 1.0, 2.0)],
                 op_shapes={}, under=under)


def plan(expected=1.5):
    from repro_torch.core.schedule import Schedule

    sched = Schedule(2, [("Fck", 1), ("Fnone", 2), ("Fall", 3), ("B", 3),
                         ("Fall", 1), ("Fall", 2), ("B", 2), ("B", 1)])
    return types.SimpleNamespace(schedule=sched, expected_time=expected)


def run(**kw):
    base = dict(trace=None, plan=None, timings={})
    return types.SimpleNamespace(**{**base, **kw})


def read(name, r):
    return registry.module("metrics", name).read(r)


UNDER = {"step.forward": 0.5, "step.backward": 1.1, "step.optimizer": 0.3,
         "remat.replay": 0.08}


def test_each_reader_reads_its_spans_and_counters():
    from repro_torch.obs import metrics

    for v in (7.0, 5.0):
        metrics.histogram("remat.forward_runs").observe(v)
    metrics.histogram("measure.in_chain_s").observe(6.25)
    r = run(trace=trace(UNDER), plan=plan())
    assert read("step.optimizer_share", r) == pytest.approx(15.0)
    assert read("remat.replay_share", r) == pytest.approx(5.0)
    assert read("remat.forward_runs_ratio", r) == pytest.approx(1.0)
    assert read("plan.time_error", r) == pytest.approx(100 * 0.1 / 1.5)
    assert read("measure.in_chain_s", r) == 6.25


@pytest.mark.parametrize("name", NEW)
def test_a_reader_without_its_input_reads_nothing(name):
    # the parent program: no span in the trace, no counter in the registry
    for r in (run(), run(plan=plan()), run(trace=trace({}), plan=plan()),
              run(trace=trace({"aten::mm": 1.0}), plan=plan())):
        assert read(name, r) is None


def test_readers_need_their_plan_and_its_prediction():
    from repro_torch.obs import metrics

    metrics.histogram("remat.forward_runs").observe(5.0)
    assert read("remat.forward_runs_ratio", run(trace=trace(UNDER))) is None
    assert read("plan.time_error",
                run(trace=trace(UNDER), plan=plan(float("nan")))) is None
    # a step whose forward ran but not its backward's span
    assert read("plan.time_error", run(trace=trace(
        {"step.forward": 0.5}), plan=plan())) is None
    assert read("remat.replay_share", run(trace=trace(
        {"remat.replay": 0.1}), plan=plan())) is None


@pytest.mark.parametrize("name", NEW)
def test_every_new_reader_is_a_declared_metric(name):
    declared = {m["name"]: m for m in registry.benchmark()["per_layer"]}
    assert declared[name]["workloads"] == ["qwen1.5-4b.rotor_auto"]
