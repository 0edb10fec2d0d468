"""Checkpoints and resume in the port: ``repro_torch.ckpt.CheckpointManager``
over the port's parameter and AdamW trees (bf16 leaves, scalars, the
embedded plan), the train loop's ``ckpt_dir`` flow (the JAX package's
``test_runtime.py`` counterparts: the loss drops with checkpoints on, and
8 straight steps equal 4 + restore + 4 — bit for bit here, the learning
rate being in its warm-up, where it does not depend on the run's length —
and the resumed losses held against the JAX package's 8 straight steps at
rtol 1e-4, the tolerance of ``test_torch_train.py``), the straggler
watchdog, and ``measure_chain``'s stage times taken inside
the chain."""

import json
import os
import statistics

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.distributed import StragglerWatchdog  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402
from repro_torch.plan import StalePlanError, resolve_policy  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.runtime.train_loop import (TrainLoopConfig,  # noqa: E402
                                            run_training)
from repro_torch.tree import tensors_of  # noqa: E402

QWEN = dict(num_layers=2, layer_kinds=("dense",) * 2, n_chunks=2)
BASE = dict(global_batch=2, seq_len=16, lr=3e-3, warmup=8, log_every=100,
            policy="rotor:x0.7", peak_flops=1e12)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": {"table": torch.randn(6, 4, generator=g)
                        .to(torch.bfloat16).requires_grad_()},
              "chunks": [{"w": torch.randn(3, 4, 4, generator=g)
                          .requires_grad_()}],
              "norm": torch.ones(4, dtype=torch.bfloat16).requires_grad_()}
    opt = adamw_init(tensors_of(params))
    opt["count"] = 7
    for m in opt["mu"]:
        m.uniform_(-1, 1, generator=g)
    return {"params": params, "opt": opt, "step": 3}


def _equal(a, b):
    ta, tb = tensors_of(a), tensors_of(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _plan():
    from repro_torch.core.chain import Chain
    ch = Chain.make(uf=[1.0] * 6 + [0.0], ub=[2.0] * 6 + [0.0],
                    wa=[1.0] * 7, wabar=[2.0] * 6 + [0.0])
    return resolve_policy("rotor:x0.6", ch, num_slots=64), ch


def test_save_restore_roundtrip_bf16_scalars_and_plan(tmp_path):
    state = _state()
    plan, ch = _plan()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(3, state, plan=plan)
    assert mgr.all_steps() == [3]
    step, got = mgr.restore(_state(seed=1))
    assert step == 3 and got["step"] == 3 and got["opt"]["count"] == 7
    _equal(got, state)
    assert got["params"]["norm"].requires_grad
    assert mgr.last_save["bytes"] == sum(t.numel() * t.element_size()
                                         for t in tensors_of(state)) + 16
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["params/embed/table"]["dtype"] == "bfloat16"
    assert manifest["plan"] == "memory.plan"
    assert mgr.restore_plan(chain=ch).schedule.ops == plan.schedule.ops


def test_restore_into_the_targets_dtype_and_device(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    meta = {"params": {"embed": {"table": torch.empty(
        6, 4, dtype=torch.float32, device="meta")},
        "chunks": [{"w": torch.empty(3, 4, 4, device="meta")}],
        "norm": torch.empty(4, dtype=torch.bfloat16, device="meta")},
        "opt": adamw_init([torch.empty(s, device="meta") for s in
                           ((6, 4), (3, 4, 4), (4,))]), "step": 0}
    _, got = mgr.restore(meta, device="cpu")
    table = got["params"]["embed"]["table"]
    assert table.device.type == "cpu" and table.dtype == torch.float32
    assert torch.equal(table, state["params"]["embed"]["table"].float())
    assert got["opt"]["count"] == 7


def test_torn_newest_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    old, new = _state(0), _state(1)
    mgr.save(1, old)
    mgr.save(2, new)
    # tear the newest: flip bytes in one leaf file
    leaf = tmp_path / "step_00000002" / "opt__mu__1.npy"
    data = bytearray(leaf.read_bytes())
    data[-3] ^= 0xFF
    leaf.write_bytes(bytes(data))
    step, got = mgr.restore(_state(5))
    assert step == 1
    _equal(got, old)
    # a truncated newest file walks back too
    mgr.save(3, new)
    leaf = tmp_path / "step_00000003" / "params__chunks__0__w.npy"
    leaf.write_bytes(leaf.read_bytes()[:40])
    assert mgr.restore(_state(5))[0] == 1
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(5), step=3)


def test_keep_k_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_async_save_equals_blocking(tmp_path):
    state = _state()
    a = CheckpointManager(str(tmp_path / "a"))
    b = CheckpointManager(str(tmp_path / "b"))
    a.save(4, state, blocking=True)
    b.save(4, state, blocking=False)
    # the host copy is taken before save returns: later in-place updates
    # (the optimizer's) do not reach the checkpoint being written
    with torch.no_grad():
        for t in tensors_of(state):
            t.add_(1)
    b.wait()
    assert b.last_save["write_s"] >= 0 and not b.last_save["blocking"]
    for name in sorted(os.listdir(tmp_path / "a" / "step_00000004")):
        if name.endswith(".npy"):
            assert ((tmp_path / "a" / "step_00000004" / name).read_bytes()
                    == (tmp_path / "b" / "step_00000004" / name)
                    .read_bytes()), name
    _equal(a.restore(_state(2))[1], b.restore(_state(2))[1])


def test_restore_plan_refuses_a_stale_chain(tmp_path):
    plan, ch = _plan()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _state(), plan=plan)
    mgr.save(1, _state())  # no plan: the newest step with one is found
    assert mgr.restore_plan().schedule.ops == plan.schedule.ops
    stale = ch.calibrate(uf=[2.0] + [float("nan")] * 6)
    with pytest.raises(StalePlanError, match="chain"):
        mgr.restore_plan(chain=stale)
    assert CheckpointManager(str(tmp_path / "empty")).restore_plan() is None


# -- the train loop ------------------------------------------------------------


def test_train_loop_loss_drops(tmp_path):
    cfg = smoke_config("qwen1.5-4b", **QWEN)
    loop = TrainLoopConfig(steps=12, global_batch=4, seq_len=32, lr=3e-3,
                           warmup=2, log_every=100, policy="rotor:x0.7",
                           peak_flops=1e12, ckpt_dir=str(tmp_path),
                           ckpt_every=5)
    out = run_training(cfg, loop, device="cpu", log_fn=lambda *_: None)
    assert len(out["losses"]) == 12
    assert out["losses"][-1] < out["losses"][0]
    # saved after steps 4 and 9 (every 5 steps) and at the end
    assert [s["step"] for s in out["ckpt_saves"]] == [4, 9, 11]
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 9, 11]


def test_train_loop_restart_is_exact(tmp_path):
    """4 steps with checkpoints, then a run to 8 resumes at step 4: the
    restored state equals the first run's end state bit for bit, and the
    losses of 4 + 4 equal 8 straight steps'; the checkpoint carries the
    plan."""
    cfg = smoke_config("qwen1.5-4b", **QWEN)
    d = str(tmp_path / "ck")
    r1 = run_training(cfg, TrainLoopConfig(steps=4, ckpt_dir=d, ckpt_every=0,
                                           **BASE), device="cpu",
                      log_fn=lambda *_: None)
    model = StagedLM(cfg)
    params = model.init(9, "cpu")
    target = {"params": params, "opt": adamw_init(tensors_of(params)),
              "step": 0}
    s, st = CheckpointManager(d).restore(target)
    assert s == 3 and st["step"] == 3 and st["opt"]["count"] == 4
    _equal(st["params"], r1["params"])
    _equal(st["opt"], r1["opt_state"])
    plan = CheckpointManager(d).restore_plan(chain=r1["chain"])
    assert plan.schedule.ops == r1["plan"].schedule.ops

    r2 = run_training(cfg, TrainLoopConfig(steps=8, ckpt_dir=d, ckpt_every=0,
                                           **BASE), device="cpu",
                      log_fn=lambda *_: None)
    assert r2["start_step"] == 4 and r2["last_step"] == 7
    assert len(r2["losses"]) == 4
    straight = run_training(cfg, TrainLoopConfig(steps=8, **BASE),
                            device="cpu", log_fn=lambda *_: None)
    assert r1["losses"] + r2["losses"] == straight["losses"]
    _equal(r2["params"], straight["params"])


def test_resumed_losses_match_jax(tmp_path):
    """The port's 4 + restore + 4 steps from the JAX package's seeded
    weights against the JAX package's 8 straight steps (rtol 1e-4, as the
    straight 3-step comparison in ``test_torch_train.py``)."""
    import jax

    from repro.configs import smoke_config as jsmoke
    from repro.models.lm import StagedLM as JLM
    from repro.runtime.train_loop import TrainLoopConfig as JLoop
    from repro.runtime.train_loop import run_training as jrun

    jcfg, cfg = jsmoke("qwen1.5-4b", **QWEN), smoke_config("qwen1.5-4b",
                                                             **QWEN)
    keys = ("global_batch", "seq_len", "lr", "warmup", "log_every", "policy")
    want = jrun(jcfg, JLoop(steps=8, **{k: BASE[k] for k in keys}),
                log_fn=lambda *_: None)["losses"]
    jparams = jax.tree.map(np.asarray,
                           jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0)))
    d = str(tmp_path / "ck")
    got = []
    for steps in (4, 8):
        out = run_training(
            cfg, TrainLoopConfig(steps=steps, ckpt_dir=d, ckpt_every=0,
                                 **BASE),
            device="cpu", params=params_from_numpy(jparams, cfg,
                                                   torch.device("cpu")),
            log_fn=lambda *_: None)
        got += out["losses"]
    assert out["start_step"] == 4 and len(got) == 8
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_async_checkpoints_in_the_loop_resume_alike(tmp_path):
    """Saves on a thread after every step, then a resume: the same losses
    as with blocking saves."""
    cfg = smoke_config("qwen1.5-4b", **QWEN)
    runs = {}
    for name, asynchronous in (("async", True), ("blocking", False)):
        d = str(tmp_path / name)
        loop = dict(BASE, ckpt_dir=d, ckpt_every=1, ckpt_keep=1,
                    async_ckpt=asynchronous)
        a = run_training(cfg, TrainLoopConfig(steps=2, **loop),
                         device="cpu", log_fn=lambda *_: None)
        assert [s["blocking"] for s in a["ckpt_saves"]] == \
            [not asynchronous] * 2
        b = run_training(cfg, TrainLoopConfig(steps=3, **loop),
                         device="cpu", log_fn=lambda *_: None)
        runs[name] = a["losses"] + b["losses"]
        assert CheckpointManager(d).all_steps() == [2]
    assert runs["async"] == runs["blocking"]


def test_straggler_restart_checkpoints_and_stops(tmp_path, monkeypatch):
    """A persistent straggler (steps 5 and 6 ten times the median) makes
    the loop save and stop; the next run resumes after that step."""
    durations = iter([1.0] * 5 + [10.0] * 2 + [1.0] * 20)
    now = [0.0]

    def clock():
        return now[0]

    class Watchdog(StragglerWatchdog):
        def __init__(self, threshold):
            super().__init__(threshold=threshold, max_flags=2, clock=clock)

        def step_end(self, step):
            now[0] += next(durations)
            return super().step_end(step)

    monkeypatch.setattr(train_loop, "StragglerWatchdog", Watchdog)
    cfg = smoke_config("qwen1.5-4b", **QWEN)
    d = str(tmp_path)
    lines = []
    out = run_training(cfg, TrainLoopConfig(steps=10, ckpt_dir=d,
                                            ckpt_every=0, **BASE),
                       device="cpu", log_fn=lines.append)
    assert out["last_step"] == 6 and out["straggler_events"] == 2
    assert any("persistent straggler" in s for s in lines)
    assert CheckpointManager(d).all_steps() == [6]
    monkeypatch.setattr(train_loop, "StragglerWatchdog", StragglerWatchdog)
    again = run_training(cfg, TrainLoopConfig(steps=10, ckpt_dir=d,
                                              ckpt_every=0, **BASE),
                         device="cpu", log_fn=lambda *_: None)
    assert again["start_step"] == 7 and len(again["losses"]) == 3


def test_straggler_without_checkpoints_runs_every_step(monkeypatch):
    """With no ``ckpt_dir`` there is nothing to resume from: a persistent
    straggler is logged, and the run still takes all its steps."""
    durations = iter([1.0] * 5 + [10.0] * 4 + [1.0] * 20)
    now = [0.0]

    class Watchdog(StragglerWatchdog):
        def __init__(self, threshold):
            super().__init__(threshold=threshold, max_flags=2,
                             clock=lambda: now[0])

        def step_end(self, step):
            now[0] += next(durations)
            return super().step_end(step)

    monkeypatch.setattr(train_loop, "StragglerWatchdog", Watchdog)
    cfg = smoke_config("qwen1.5-4b", **QWEN)
    lines = []
    out = run_training(cfg, TrainLoopConfig(steps=10, **BASE),
                       device="cpu", log_fn=lines.append)
    assert len(out["losses"]) == len(out["steps"]) == 10
    assert out["last_step"] == 9 and out["straggler_events"] == 4
    assert sum("[watchdog] straggler" in s for s in lines) == 4
    assert not any("persistent straggler" in s for s in lines)


def test_straggler_watchdog_fake_clock():
    t = [0.0]
    wd = StragglerWatchdog(threshold=2.0, max_flags=2, clock=lambda: t[0])

    def run_step(dur, step):
        wd.step_begin()
        t[0] += dur
        return wd.step_end(step)

    for i in range(8):
        assert run_step(1.0, i) is None
    ev = run_step(5.0, 8)
    assert ev is not None and ev.duration == 5.0
    assert not wd.should_restart
    run_step(5.0, 9)
    assert wd.should_restart
    with pytest.raises(RuntimeError):
        wd.step_end(10)


def test_launcher_checkpoint_flags(tmp_path):
    _, loop, _ = train.parse(["--arch", "qwen1.5-4b", "--smoke",
                              "--ckpt-dir", str(tmp_path),
                              "--ckpt-every", "7"])
    assert loop.ckpt_dir == str(tmp_path) and loop.ckpt_every == 7
    _, loop, _ = train.parse(["--arch", "qwen1.5-4b"])
    assert loop.ckpt_dir is None


def test_launcher_defaults_match_the_reference(capsys):
    """``--ckpt-every`` defaults to 25 and ``--model-parallel`` to 1, as in
    ``repro.launch.train``."""
    _, loop, _ = train.parse(["--arch", "qwen1.5-4b"])
    assert loop.ckpt_every == 25
    args = train._parser().parse_args(["--arch", "qwen1.5-4b"])
    assert args.model_parallel == 1 and args.dist_backend == "auto"
    with pytest.raises(SystemExit):
        train.parse(["--help"])
    text = capsys.readouterr().out
    assert "default: 25" in text and "default: 1" in text


# -- stage times inside the chain ------------------------------------------------


def test_measure_chain_times_stages_inside_the_chain(monkeypatch):
    """On the CPU, ``measure_chain`` takes ``uf``/``ub`` from traced
    store-all steps of the walker (host-clock spans): after one warm-up
    step, the median over ``repeats`` steps of each step's per-stage
    times; sizes, ``of`` and ``ob`` are the isolated measurement's."""
    from repro_torch.core import planner
    from repro_torch.launch import steps
    from repro_torch.obs import trace

    tracers = []

    class Recording(trace.Tracer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            tracers.append(self)

    monkeypatch.setattr(trace, "Tracer", Recording)
    alone = []
    real = planner.profile_stages_measured

    def keep(*a, **k):
        alone.append(real(*a, **k))
        return alone[-1]

    monkeypatch.setattr(steps, "profile_stages_measured", keep)
    cfg = smoke_config("qwen1.5-4b", **QWEN)
    model = StagedLM(cfg)
    params = model.init(0, "cpu")
    batch = SyntheticLMData(cfg, 2, 16, seed=0).device_batch(0, "cpu")
    lines = []
    chain = steps.measure_chain(model, params, batch, repeats=3,
                                log_fn=lines.append)
    (iso,) = alone
    for name in ("wa", "wabar", "wdelta", "of", "ob"):
        np.testing.assert_array_equal(getattr(chain, name),
                                      getattr(iso, name))
    assert not chain.of.any() and not chain.ob.any()
    L = chain.length
    assert len(tracers) == 4  # one warm-up and three timed steps
    want = [trace.measured_stage_times(t.spans, L) for t in tracers[1:]]
    for t in tracers:
        assert [(s.op, s.arg) for s in t.spans] == \
            [("Fall", l) for l in range(1, L + 2)] + \
            [("B", l) for l in range(L + 1, 0, -1)]
    for j in range(L + 1):
        assert chain.uf[j] == statistics.median(w[0][j] for w in want)
        assert chain.ub[j] == statistics.median(w[1][j] for w in want)
    assert not np.array_equal(chain.uf, iso.uf)
    assert "from store-all steps" in lines[0]
    assert len(lines) == L + 2
