"""The port's multi-device pieces over ``torch.distributed`` on gloo, on the
CPU, held against the JAX package:

- host-sharded data: each host's batch bit-equal to the JAX package's
  ``batch_at`` for the same (seed, host, step), text, audio and VLM;
- ``elastic_plan`` (mesh, axis names, accumulation, its ``ValueError``) and
  ``HeartbeatRegistry.dead()`` on a fake clock, against the reference;
- int8 compression with error feedback: 4 gloo ranks against the JAX
  ``compressed_psum_mean`` under ``shard_map`` on 4 forced CPU devices
  (mean and each member's new error, rtol 1e-6), and the accumulated drift
  within one quantization step;
- ZeRO-3 training (``run_training(mesh=...)``) at meshes (2, 1) and (1, 2):
  losses, gradient norms, the first step's gradients and the final
  parameters of 3 AdamW steps equal to the single-process run on the two
  hosts' batches concatenated, which is itself held against the JAX
  package on the same batch; each rank holds ``1/shard_factor`` of each
  sharded parameter;
- a checkpoint saved at world 4 (mesh (4, 1)) restored at world 2 bit-equal,
  each rank holding half; a run resumed at world 1 from a world-2
  checkpoint continues with the uninterrupted world-2 run's losses;
- the launcher's backend choice (NCCL refused on a shared card).

The multi-process checks share two spawned process groups, one at world 4
(the compressed means, the checkpoint's save) and one at world 2 (the
sharded runs, the restore, the resumed run, the plans that disagree), each
run once for the module with a timeout
(``repro_torch.distributed.local.run_local``), so a hang fails its tests.
The JAX package is imported inside the tests only: the spawned ranks
import this module and nothing of JAX.

Tolerances: the sharded runs sum float32 gradients over ranks in another
order than one process does, so losses and gradient norms are held at
rtol 1e-5 and gradients at rtol 1e-4 / atol 1e-6; parameters after 3 AdamW
steps at rtol 1e-4 / atol 1e-5, 1 % of one step at lr 1e-3 (Adam scales a
gradient that is zero up to rounding — the key bias, which softmax ignores
— to a step of about lr, whatever its sign); the port against the JAX
package at rtol 1e-4, as ``tests/test_torch_train.py``."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.distributed.local import run_local  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen1.5-4b"
B, S, STEPS, LR = 4, 16, 3, 1e-3
TIMEOUT = 300.0
SHAPES = [(2, 1), (1, 2)]


def _loop(**kw):
    from repro_torch.runtime.train_loop import TrainLoopConfig

    base = dict(steps=STEPS, global_batch=B, seq_len=S, lr=LR, warmup=1,
                policy="rotor:x0.8", solver_impl="plain", peak_flops=1e12,
                log_every=100)
    base.update(kw)
    return TrainLoopConfig(**base)


def _numpy_tree(tree):
    from repro_torch.distributed.sharding import full_value
    from repro_torch.tree import leaves_with_paths

    return {k: full_value(v).detach().float().numpy()
            for k, v in leaves_with_paths(tree)
            if isinstance(v, torch.Tensor)}


def _jax_params():
    import jax

    from repro.configs import smoke_config as jsmoke
    from repro.models.lm import StagedLM as JLM

    return jax.tree.map(np.asarray, jax.jit(JLM(jsmoke(ARCH)).init)(
        jax.random.PRNGKey(0)))


# -- host-sharded data ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-4b", "musicgen-medium",
                                  "paligemma-3b"])
def test_host_batches_match_jax(arch):
    from repro.configs import smoke_config as jsmoke
    from repro.data.pipeline import SyntheticLMData as JData

    pcfg, jcfg = smoke_config(arch), jsmoke(arch)
    for count in (1, 2, 4):
        for host in range(count):
            ours = SyntheticLMData(pcfg, 8, S, seed=3, host_index=host,
                                   host_count=count)
            ref = JData(jcfg, 8, S, seed=3, host_index=host, host_count=count)
            for step in (0, 5):
                got, want = ours.batch_at(step), ref.batch_at(step)
                assert got.keys() == want.keys()
                for k in want:
                    assert got[k].dtype == want[k].dtype
                    np.testing.assert_array_equal(got[k], want[k])
    # a process reading both hosts' slices sees them concatenated
    both = SyntheticLMData(pcfg, 8, S, seed=3, host_count=2, hosts=2)
    halves = [SyntheticLMData(pcfg, 8, S, seed=3, host_index=h, host_count=2)
              for h in range(2)]
    for k, v in both.batch_at(1).items():
        np.testing.assert_array_equal(
            v, np.concatenate([h.batch_at(1)[k] for h in halves]))


# -- elastic plan and heartbeats -----------------------------------------------------

@pytest.mark.parametrize("n_chips", [1, 2, 3, 4, 6, 8, 12, 16])
def test_elastic_plan_matches_reference(n_chips):
    from repro.distributed.fault_tolerance import elastic_plan as jplan
    from repro_torch.distributed.fault_tolerance import elastic_plan

    for mp_width in (1, 2, 4, 8):
        for batch in (1, 4, 6, 8, 12, 64):
            if n_chips < mp_width:
                for fn in (elastic_plan, jplan):
                    with pytest.raises(ValueError, match="model-parallel"):
                        fn(n_chips, mp_width, batch)
                continue
            assert (elastic_plan(n_chips, mp_width, batch)
                    == jplan(n_chips, mp_width, batch))


def test_heartbeat_registry_matches_reference():
    from repro.distributed.fault_tolerance import HeartbeatRegistry as JReg
    from repro_torch.distributed.fault_tolerance import HeartbeatRegistry

    now = [0.0]
    ours = HeartbeatRegistry(4, timeout=10.0, clock=lambda: now[0])
    ref = JReg(4, timeout=10.0, clock=lambda: now[0])
    seen = []
    for t, beats in [(3.0, [0, 1]), (9.0, [2]), (12.5, [0]), (14.0, []),
                     (21.0, [3]), (30.0, [1, 2]), (45.0, [])]:
        now[0] = t
        for reg in (ours, ref):
            for h in beats:
                reg.beat(h)
        assert ours.dead() == ref.dead()
        seen.append(ours.dead())
    assert seen == [[], [], [3], [1, 3], [1, 2], [0], [0, 1, 2, 3]]


def test_launcher_backend_choice():
    from repro_torch.launch.train import backend_for

    assert backend_for("cpu", "auto", 4, 0) == "gloo"
    assert backend_for("cuda", "auto", 1, 1) == "nccl"
    assert backend_for("cuda", "auto", 2, 1) == "gloo"
    assert backend_for("cuda", "gloo", 2, 1) == "gloo"
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        backend_for("cuda", "nccl", 2, 1)
    with pytest.raises(ValueError, match="CUDA devices only"):
        backend_for("cpu", "nccl", 1, 0)


# -- gradient compression ------------------------------------------------------------

_G_SHAPES = [(8,), (3, 5)]
_EF_STEPS = 3


def _member_grads(member: int, step: int):
    rng = np.random.default_rng([member, step])
    return [(rng.standard_normal(s) * (member + 1) ** 2).astype(np.float32)
            for s in _G_SHAPES]


def _compression_rank(rank, world):
    import torch.distributed as dist

    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     ef_init)

    grads = [torch.from_numpy(g) for g in _member_grads(rank, 0)]
    err = ef_init(grads)
    out = []
    for step in range(_EF_STEPS):
        grads = [torch.from_numpy(g) for g in _member_grads(rank, step)]
        mean, err = compressed_psum_mean(grads, err, dist.group.WORLD, world)
        out.append(([m.numpy() for m in mean], [e.numpy() for e in err]))
    return out


_JAX_COMPRESSION = """
import sys, jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map_unchecked
from repro.distributed.compression import compressed_psum_mean
shapes, steps, out = eval(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh = jax.make_mesh((4,), ("data",))

def grads(member, step):
    rng = np.random.default_rng([member, step])
    return [(rng.standard_normal(s) * (member + 1) ** 2).astype(np.float32)
            for s in shapes]

def per_member(g, e):
    m, e2 = compressed_psum_mean([x[0] for x in g], [x[0] for x in e],
                                 axes=("data",), n_members=4)
    return [x[None] for x in m], [x[None] for x in e2]

spec = [P("data")] * len(shapes)
fn = jax.jit(shard_map_unchecked(per_member, mesh=mesh, in_specs=(spec, spec),
                                 out_specs=(spec, spec)))
err = [jnp.zeros((4,) + s, jnp.float32) for s in shapes]
res = {}
for step in range(steps):
    g = [jnp.asarray(np.stack([grads(m, step)[i] for m in range(4)]))
         for i in range(len(shapes))]
    mean, err = fn(g, err)
    for i in range(len(shapes)):
        res[f"mean_{step}_{i}"] = np.asarray(mean[i])
        res[f"err_{step}_{i}"] = np.asarray(err[i])
np.savez(out, **res)
"""


def test_compression_matches_jax_shard_map(world4):
    want = world4["jax"]
    ranks = [r["compression"] for r in world4["ranks"]]
    for step in range(_EF_STEPS):
        for rank, per_step in enumerate(ranks):
            means, errs = per_step[step]
            for i in range(len(_G_SHAPES)):
                np.testing.assert_allclose(
                    means[i], want[f"mean_{step}_{i}"][rank], rtol=1e-6)
                np.testing.assert_allclose(
                    errs[i], want[f"err_{step}_{i}"][rank], rtol=1e-6,
                    atol=1e-7)
    # every member applies the same mean, within one step of the true one
    g0 = np.stack([_member_grads(m, 0)[0] for m in range(4)])
    scale = np.abs(g0).max() / 127.0
    assert np.abs(ranks[0][0][0][0] - g0.mean(axis=0)).max() <= scale + 1e-6


def test_compression_error_feedback_drift_bounded():
    from repro_torch.distributed.compression import (compressed_psum_mean,
                                                     compression_ratio,
                                                     ef_init)

    rng = np.random.default_rng(0)
    g_seq = rng.standard_normal((50, 16)).astype(np.float32)
    err = ef_init([torch.zeros(16)])
    true_sum, sent_sum = np.zeros(16), np.zeros(16)
    for g in g_seq:
        out, err = compressed_psum_mean([torch.from_numpy(g)], err, None, 1)
        true_sum += g
        sent_sum += out[0].numpy()
    drift = np.abs(true_sum - sent_sum).max()
    assert drift <= 2 * np.abs(g_seq).max() / 127.0 + 1e-6
    # what is applied plus the new error is exactly what was quantized
    g = torch.tensor([0.013, -0.27, 3.1, 0.0])
    out, e2 = compressed_psum_mean([g], ef_init([g]), None, 1)
    assert not torch.equal(out[0], g)
    np.testing.assert_allclose((out[0] + e2[0]).numpy(), g.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert compression_ratio() == 2.0
    assert compression_ratio(from_dtype=torch.float32) == 4.0


# -- ZeRO-3 training on a mesh -------------------------------------------------------

def _first_step_grads(model, params, batch, mesh, dp):
    """The first step's gradients the sharded train step takes: the rank's
    loss over the data-parallel factor, its DTensor gradients summed over
    the batch-sharded mesh dimensions."""
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.tree import tensors_of, with_tensors

    leaves = tensors_of(params)
    with axis_rules(mesh):
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss / dp, leaves)
    assert all(g.placements == p.placements for g, p in zip(grads, leaves))
    return _numpy_tree(with_tensors(params, grads))


def _sharded_rank(rank, world, shape, jparams):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.distributed.sharding import (axis_rules, data_position,
                                                  make_mesh, shard_factor)
    from repro_torch.launch.steps import axes_at, shard_tree
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.train_loop import run_training
    from repro_torch.tree import leaves_with_paths

    cfg = smoke_config(ARCH)
    mesh = make_mesh(shape, "cpu")
    cpu = torch.device("cpu")
    model = StagedLM(cfg)
    model.gather = lambda _: "full"
    params = shard_tree(params_from_numpy(jparams, cfg, cpu),
                        model.param_axes(), mesh)
    dp, index = data_position(mesh)
    per = 2 // dp      # every rank reads the two hosts' slices it runs
    batch = SyntheticLMData(cfg, B, S, host_index=index * per, host_count=2,
                            hosts=per).device_batch(0, cpu)
    grads = _first_step_grads(model, params, batch, mesh, dp)
    # the same gradients from the blocks run tensor-parallel, as
    # run_training runs them on a model axis of more than one member
    model.gather = model.gather_modes(mesh)
    split_grads = (_first_step_grads(model, params, batch, mesh, dp)
                   if shape[1] > 1 else None)
    # each rank holds 1/shard_factor of each parameter
    axes = model.param_axes()
    held = []
    with axis_rules(mesh):
        for path, t in leaves_with_paths(params):
            f = shard_factor(*axes_at(axes, path), shape=t.shape)
            held.append((path, t.to_local().numel(), t.numel(), f))
    out = run_training(cfg, _loop(data_hosts_per_process=per), device="cpu",
                       mesh=mesh,
                       params=params_from_numpy(jparams, cfg, cpu),
                       log_fn=lambda *_: None)
    return {"grads": grads, "split_grads": split_grads, "held": held,
            "losses": out["losses"],
            "gnorms": [r["grad_norm"] for r in out["steps"]],
            "params": _numpy_tree(out["params"]),
            "digest": out["plan_digest"], "slices": out["data_slices"],
            "comm": out["collective_bytes"]}


@pytest.fixture(scope="module")
def reference_run():
    """The single-process port on the two hosts' batches concatenated (the
    first step's gradients, 3 AdamW steps), held here against the JAX
    package's train step on the same batches and bridged weights."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.launch.steps import make_train_step as jstep
    from repro.models.lm import StagedLM as JLM
    from repro.optim.adamw import AdamWConfig as JAdam
    from repro.optim.adamw import adamw_init as jadam_init
    from repro.optim.schedules import linear_warmup_cosine as jlr
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import StagedLM
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import linear_warmup_cosine
    from repro_torch.tree import tensors_of

    cfg = smoke_config(ARCH)
    jparams = _jax_params()
    hosts = [SyntheticLMData(cfg, B, S, host_index=h, host_count=2)
             for h in range(2)]

    def batch(step):
        parts = [h.batch_at(step) for h in hosts]
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    model = StagedLM(cfg)
    params = params_from_numpy(jparams, cfg, torch.device("cpu"))
    first = {k: torch.from_numpy(v) for k, v in batch(0).items()}
    leaves = tensors_of(params)
    from repro_torch.tree import with_tensors
    grads = _numpy_tree(with_tensors(params, torch.autograd.grad(
        model.loss_fn(params, first), leaves)))
    step_fn = make_train_step(model, AdamWConfig(lr=LR), None,
                              linear_warmup_cosine(LR, 1, STEPS))
    opt = adamw_init(leaves)
    losses, gnorms = [], []
    for s in range(STEPS):
        m = step_fn(params, opt, {k: torch.from_numpy(v)
                                  for k, v in batch(s).items()}, s)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))

    jm = JLM(jsmoke(ARCH))
    jf = jax.jit(jstep(jm, JAdam(lr=LR), None, jlr(LR, 1, STEPS)))
    jp, jo = jparams, jadam_init(jparams)
    jl, jg = [], []
    for s in range(STEPS):
        jp, jo, m = jf(jp, jo, jax.tree.map(jnp.asarray, batch(s)),
                       jnp.asarray(s, jnp.int32))
        jl.append(float(m["loss"]))
        jg.append(float(m["grad_norm"]))
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    np.testing.assert_allclose(gnorms, jg, rtol=1e-4)
    return {"jparams": jparams, "grads": grads, "losses": losses,
            "gnorms": gnorms, "params": _numpy_tree(params)}


@pytest.mark.parametrize("shape", SHAPES, ids=["data2", "model2"])
def test_sharded_run_matches_single_process(reference_run, world2, shape):
    ranks = [r["sharded"][shape] for r in world2["ranks"]]
    dp = shape[0]
    assert len({r["digest"] for r in ranks}) == 1
    assert [r["slices"] for r in ranks] == (
        [(0, 1), (1, 1)] if dp == 2 else [(0, 2), (0, 2)])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], reference_run["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["gnorms"], reference_run["gnorms"],
                                   rtol=1e-5)
        checks = [("grads", "grads", 1e-6), ("params", "params", 1e-5)]
        if shape[1] > 1:
            checks.append(("split_grads", "grads", 1e-6))
        rounding = 0
        for which, ref, atol in checks:
            assert r[which].keys() == reference_run[ref].keys()
            for k, want in reference_run[ref].items():
                got = r[which][k]
                if which == "params" and shape[1] > 1:
                    # tensor parallel: the blocks split their products, so
                    # an entry whose gradient is zero up to rounding (a
                    # RoPE pair of the key bias that barely turns, which
                    # softmax ignores) takes Adam steps whose sign comes
                    # from other rounding: each such entry is held to the
                    # largest drift three steps allow, the rest as all are
                    g = np.abs(reference_run["grads"][k])
                    noise = (g > 0) & (g <= 1e-5 * g.max())
                    rounding += int(noise.sum())
                    assert np.all(np.abs(got[noise] - want[noise])
                                  <= 2 * LR * STEPS), f"params {k}"
                    got, want = got[~noise], want[~noise]
                np.testing.assert_allclose(got, want, rtol=1e-4,
                                           atol=atol, err_msg=f"{which} {k}")
        # few such entries: 105 of the 197,952 in this configuration
        entries = sum(v.size for v in reference_run["params"].values())
        assert rounding <= entries // 1000, (rounding, entries)
        sharded = 0
        for path, local, full, factor in r["held"]:
            assert local * factor == full, (path, local, full, factor)
            sharded += factor > 1
        assert sharded > 0
        if shape[1] > 1:
            # the blocks ran tensor-parallel: their outputs reduced over
            # the model group, no parameter gathered along it
            assert r["comm"]["calls"].get("tp_all_reduce")
        else:
            assert r["comm"]["calls"].get("all_gather")
        if dp == 2:
            assert r["comm"]["calls"].get("reduce_scatter")


# -- elastic checkpoints -------------------------------------------------------------

def _ckpt_rank(rank, world, shape, directory, seed, save):
    from repro_torch.ckpt import CheckpointManager, restore_to_sharding
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.launch.steps import shard_tree, sharding_of
    from repro_torch.models.lm import StagedLM
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import leaves_with_paths, tensors_of

    mesh = make_mesh(shape, "cpu")
    model = StagedLM(smoke_config(ARCH))
    params = shard_tree(model.init(seed, "cpu"), model.param_axes(), mesh)
    opt = adamw_init(tensors_of(params))
    with torch.no_grad():
        for m in opt["mu"]:
            m.add_(0.5 + seed)
    state = {"params": params, "opt": opt, "step": 7 if save else 0}
    manager = CheckpointManager(directory, keep=1, writer=rank == 0)
    if save:
        manager.save(7, state)
        return manager.last_save["bytes"]
    step, got = restore_to_sharding(manager, state, sharding_of(state))
    return {"step": step, "got_step": got["step"],
            "local": {k: (v.to_local().detach().numpy().copy(),
                          [repr(p) for p in v.placements])
                      for k, v in leaves_with_paths(got)
                      if isinstance(v, torch.Tensor)},
            "full": _numpy_tree(got)}


def test_checkpoint_saved_at_world4_restores_at_world2(world4, world2):
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.models.lm import StagedLM

    d = world4["ckpt"]
    ranks = [r["restored"] for r in world2["ranks"]]
    # only the writer copies the gathered leaves to host memory
    copied = [r["saved"] for r in world4["ranks"]]
    assert copied[0] > 0 and copied[1:] == [0, 0, 0]
    # the files hold every leaf whole: restored on one process, untouched
    model = StagedLM(smoke_config(ARCH))
    ref = model.init(0, "cpu")
    step, whole = CheckpointManager(d).restore(
        {"params": model.init(1, "cpu"), "step": 0}, device="cpu")
    assert step == 7 and whole["step"] == 7
    want = _numpy_tree(whole)
    for k, v in _numpy_tree({"params": ref}).items():
        np.testing.assert_array_equal(want[k], v)
    halves = 0
    for r in ranks:
        assert r["step"] == 7 and r["got_step"] == 7
        for k, v in want.items():
            np.testing.assert_array_equal(r["full"][k], v)
        for k, (local, placements) in r["local"].items():
            if "Shard" in placements[0]:
                halves += 1
                assert local.size * 2 == r["full"][k].size, k
    assert halves > 0
    # each rank's shard is its half of the saved leaf
    for k, (local, placements) in ranks[1]["local"].items():
        if placements[0].startswith("Shard"):
            dim = int(placements[0].split("=")[1].rstrip(")"))
            part = np.split(ranks[1]["full"][k], 2, axis=dim)[1]
            np.testing.assert_array_equal(local.astype(np.float32), part)


def _resume_rank(rank, world, directory):
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.runtime.train_loop import run_training

    cfg = smoke_config(ARCH)
    mesh = make_mesh((2, 1), "cpu")
    whole = run_training(cfg, _loop(steps=4, policy="none"), device="cpu",
                         mesh=mesh, log_fn=lambda *_: None)["losses"]
    first = run_training(cfg, _loop(steps=2, policy="none", ckpt_dir=directory,
                                    ckpt_every=0), device="cpu", mesh=mesh,
                         log_fn=lambda *_: None)
    return whole, first["losses"]


def test_world1_resumes_a_world2_checkpoint(world2):
    from repro_torch.runtime.train_loop import run_training

    d = world2["resume"]
    whole, first = world2["ranks"][0]["resume"]
    np.testing.assert_allclose(first, whole[:2], rtol=1e-5)
    # one process reads both hosts' slices: the global batch is kept
    out = run_training(smoke_config(ARCH),
                       _loop(steps=4, policy="none", ckpt_dir=d,
                             data_hosts_per_process=2),
                       device="cpu", log_fn=lambda *_: None)
    assert out["start_step"] == 2
    np.testing.assert_allclose(out["losses"], whole[2:], rtol=1e-4)


def _diverging_rank(rank, world):
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.runtime.train_loop import run_training

    try:
        run_training(smoke_config(ARCH),
                     _loop(steps=1, policy=f"rotor:x{0.8 - 0.2 * rank}"),
                     device="cpu", mesh=make_mesh((2, 1), "cpu"),
                     log_fn=lambda *_: None)
    except RuntimeError as e:
        return str(e)
    return None


def test_ranks_that_plan_differently_raise(world2):
    for r in world2["ranks"]:
        assert "the ranks planned differently" in (r["diverged"] or "")


# -- the two spawned groups ----------------------------------------------------------

def _world4_rank(rank, world, directory):
    return {"compression": _compression_rank(rank, world),
            "saved": _ckpt_rank(rank, world, (4, 1), directory, 0, True)}


def _world2_rank(rank, world, jparams, ckpt_dir, resume_dir):
    return {"sharded": {shape: _sharded_rank(rank, world, shape, jparams)
                        for shape in SHAPES},
            "restored": _ckpt_rank(rank, world, (2, 1), ckpt_dir, 1, False),
            "resume": _resume_rank(rank, world, resume_dir),
            # last: its ranks raise, each after the same collectives
            "diverged": _diverging_rank(rank, world)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """Four gloo ranks: the compressed means of 3 steps and a checkpoint
    saved at mesh (4, 1); beside them, the JAX ``compressed_psum_mean``
    under ``shard_map`` on 4 forced CPU devices, in a subprocess."""
    tmp = tmp_path_factory.mktemp("world4")
    out = tmp / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_COMPRESSION),
         repr(_G_SHAPES), str(_EF_STEPS), str(out)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ranks = run_local(_world4_rank, 4, (str(tmp / "ck"),),
                          timeout=TIMEOUT)
        _, err_text = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    assert proc.returncode == 0, err_text
    return {"ranks": ranks, "jax": dict(np.load(out)),
            "ckpt": str(tmp / "ck")}


@pytest.fixture(scope="module")
def world2(reference_run, world4, tmp_path_factory):
    """Two gloo ranks: the sharded runs at (2, 1) and (1, 2), world 4's
    checkpoint restored at (2, 1), a world-2 run that checkpoints (for the
    world-1 resume) and one whose ranks plan differently."""
    resume = str(tmp_path_factory.mktemp("world2") / "ck")
    ranks = run_local(_world2_rank, 2, (reference_run["jparams"],
                                        world4["ckpt"], resume),
                      timeout=TIMEOUT)
    return {"ranks": ranks, "resume": resume}
