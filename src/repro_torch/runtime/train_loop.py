"""Training loop on one device or on a mesh of processes: rotor-planned
remat or an eager three-tier (host-offload) schedule, AdamW, deterministic
synthetic data (each host its slice of the global batch), per-step time and
memory, checkpoints and resume (:mod:`repro_torch.ckpt`) and the straggler
watchdog.  Every step reports ``train.step_seconds`` and ``train.loss`` to
:mod:`repro_torch.obs.metrics`; tracing (a tracer, or
``TrainLoopConfig.trace_path``) is opt-in."""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..ckpt.manager import CheckpointManager
from ..configs.shapes import ShapeSpec, input_specs
from ..core.chain import Chain
from ..core.rematerialize import count_checkpoint_scopes
from ..data.pipeline import SyntheticLMData
from ..device import resolve_device
from ..distributed import sharding as shd
from ..distributed.fault_tolerance import StragglerWatchdog
from ..launch.steps import (local_bytes, make_offload_step, make_train_step,
                            measure_chain, plan_digest, plan_training,
                            shard_tree)
from ..models.lm import StagedLM
from ..obs import metrics as obs_metrics
from ..optim.adamw import AdamWConfig, adamw_init
from ..optim.schedules import linear_warmup_cosine
from ..tree import tensors_of

# a step this many times the rolling median is a straggler
STRAGGLER_THRESHOLD = 3.0

@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    lr: float = 3e-4
    warmup: int = 10
    ckpt_dir: Optional[str] = None      # checkpoint here and resume from it
    ckpt_every: int = 50                # save after every this many steps
    ckpt_keep: int = 3                  # checkpoints retained
    async_ckpt: bool = True             # periodic saves write on a thread
    log_every: int = 10
    policy: Optional[str] = None        # remat policy override
    num_slots: Optional[int] = None     # DP discretization (None = default)
    solver_impl: Optional[str] = None   # DP fill (dp_kernels.KNOWN_IMPLS)
    grad_accum: int = 1                 # microbatch accumulation factor
    peak_flops: Optional[float] = None  # prices the chain's stage times
    trace_path: Optional[str] = None    # write a Perfetto trace.json here
    # this host's slice of the global batch and how many consecutive slices
    # from it this process reads (None: from the rank's place on the mesh's
    # batch axes, each rank reading data_hosts_per_process slices; 1 and 0
    # without a mesh); a run resumed on fewer processes keeps the global
    # batch of the run that wrote its checkpoint by reading more slices
    data_host_count: Optional[int] = None
    data_host_index: Optional[int] = None
    data_hosts_per_process: int = 1


def _agree(flag: bool, device) -> bool:
    """``flag`` on any rank of the default process group."""
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def run_training(cfg, loop: TrainLoopConfig, device=None,
                 params: Optional[Dict[str, Any]] = None,
                 log_fn: Callable[[str], None] = print,
                 chain: Optional[Chain] = None,
                 tracer=None, mesh=None) -> Dict[str, Any]:
    """Train a :class:`StagedLM` on ``device`` (CUDA unless the caller says
    otherwise).  ``params`` (e.g. bridged from the JAX package) replaces the
    seeded initialization.  The plan is solved on ``chain`` if one is given
    (e.g. a calibrated one); otherwise, on CUDA, on the chain measured on
    these parameters and the first batch (``launch.steps.measure_chain``,
    the paper's §5.1 measurement, its stage times taken inside the chain),
    and elsewhere on the analytic chain
    priced at ``loop.peak_flops``.  A plan with host offloads runs on the
    eager offload step (``grad_accum`` must be 1).  Returns the losses, the
    plan and chain, the final state, and per-step records ``{"loss",
    "seconds", "tokens_per_s", "activation_peak_bytes",
    "fwd_bwd_peak_bytes", "host_peak_bytes", "host_bytes_after",
    "prefetch_wait_s"}``.  ``activation_peak_bytes`` is the step's
    allocator peak less parameters, gradients and moments, the optimizer's
    temporaries included; ``fwd_bwd_peak_bytes`` the peak of the loss and
    gradients alone above the memory at the step's start (at each
    microbatch's start with ``grad_accum`` > 1), less the parameter
    gradients made by then — what the plan's predicted activation peak
    describes.  Both are ``None`` off CUDA, the host fields ``None``
    without offloads.  A loss that is not finite raises
    ``FloatingPointError``.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`; one is made when
    ``loop.trace_path`` is set) is threaded into the step, which runs where
    it runs untraced (a two-tier plan on the nested checkpoints, an offload
    plan on the walker) and records one span per schedule op (on CUDA,
    event pairs on the stream that runs each op) and, on the nested
    checkpoints and in store-all (no plan), the step's ``step.forward``,
    ``step.backward`` and ``step.optimizer`` spans.  The spans are written to
    ``loop.trace_path`` as a Perfetto file, and with a plan the result
    gains ``drift``, the plan's prediction against the last step's spans
    (:func:`repro_torch.obs.drift.compare`).

    With ``loop.ckpt_dir`` the run resumes from the newest valid
    checkpoint there (parameters, moments, the step count) at the step
    after it — ``batch_at`` and the learning rate are functions of the
    step, so the resumed steps see what an uninterrupted run would — and
    saves after every ``ckpt_every`` steps (on a thread with
    ``async_ckpt``), when the straggler watchdog asks for a restart (then
    it stops, so the restart resumes there), and at the end; each checkpoint carries the plan
    (:meth:`CheckpointManager.restore_plan`).  The result adds
    ``start_step``, ``last_step``, ``straggler_events`` and ``ckpt_saves``
    (each save's :attr:`CheckpointManager.last_save`).  Without
    ``ckpt_dir`` the watchdog only logs stragglers: with nothing to resume
    from, the run takes all ``loop.steps`` steps.

    ``mesh`` (a ``(data, model)`` ``DeviceMesh`` over the default process
    group, every rank calling ``run_training`` alike; ``None``: one device)
    runs ZeRO-3 (:mod:`repro_torch.distributed.sharding`): parameters and
    moments as DTensors placed by ``StagedLM.param_axes``, each stage
    gathering its own (a MoE's routed experts stay local under expert
    parallelism), each rank on its slice of the global batch.  A model axis
    of more than one member runs the blocks tensor-parallel over it
    (``StagedLM.gather_modes``: the model-sharded weights stay this rank's
    shards, :mod:`repro_torch.distributed.tensor_parallel`).  All ranks
    run one plan: rank 0 measures the chain on CUDA (on its slice of the
    batch; under tensor parallelism every rank measures with it in
    lockstep, since the split stages issue collectives, so the chain's
    sizes are one rank's) and sends it to the others, every rank solves on
    it, and the plans' digests must agree.  Rank 0 alone logs and writes checkpoints.
    A two-tier plan only (no offload walker, no tracer).  The result adds
    ``plan_digest``, ``param_bytes_local`` (this rank's parameter bytes)
    and ``collective_bytes``: the collectives of the first step, counted
    by the helpers of :mod:`repro_torch.distributed.sharding` (calls and
    bytes by op, :func:`~repro_torch.distributed.sharding.collectives`)."""
    dev = resolve_device(device)
    rank = dist.get_rank() if mesh is not None else 0
    if rank:
        log_fn = lambda *_: None  # noqa: E731
    if tracer is None and loop.trace_path:
        from ..obs.trace import Tracer
        tracer = Tracer(name="train")
    traced = tracer is not None and tracer.enabled
    model = StagedLM(cfg)
    if params is None:
        params = model.init(loop.seed, dev)
    per = loop.data_hosts_per_process
    hosts = shd.data_position(mesh) if mesh is not None else (1, 0)
    data = SyntheticLMData(
        cfg, loop.global_batch, loop.seq_len, seed=loop.seed,
        host_count=(hosts[0] * per if loop.data_host_count is None
                    else loop.data_host_count),
        host_index=(hosts[1] * per if loop.data_host_index is None
                    else loop.data_host_index),
        hosts=per)
    policy = loop.policy if loop.policy is not None else cfg.remat_policy
    split = mesh is not None and shd.mesh_shape(mesh).get(shd.MODEL, 1) > 1
    measure = chain is None and dev.type == "cuda" and policy != "none"

    def measured(p):
        t0 = time.perf_counter()
        out = measure_chain(model, p, data.device_batch(0, dev),
                            log_fn=log_fn)
        log_fn(f"[plan] chain of {out.length + 1} stages measured on "
               f"{dev} in {time.perf_counter() - t0:.2f}s, its stage times "
               f"inside the chain" + (" (every rank of the model group in "
                                      "lockstep, tensor-parallel)"
                                      if split else ""))
        return out

    if measure and rank == 0 and not split:
        chain = measured(params)
    if mesh is not None:
        params = shard_tree(params, model.param_axes(), mesh)
        model.gather = model.gather_modes(mesh)
        if measure and split:
            # the split stages issue collectives: every rank measures
            with shd.axis_rules(mesh):
                chain = measured(params)
        if measure:
            sent = [chain]
            dist.broadcast_object_list(sent, src=0)
            chain = sent[0]
    shape = ShapeSpec("train", "train", loop.seq_len, loop.global_batch)
    plan, chain = plan_training(model, input_specs(cfg, shape), policy,
                                peak_flops=loop.peak_flops,
                                num_slots=loop.num_slots,
                                impl=loop.solver_impl, device=dev,
                                chain=chain, log_fn=log_fn, mesh=mesh)
    offload = plan is not None and plan.uses_offload
    tree = plan.tree if plan is not None and not offload else None
    if (offload or traced) and loop.grad_accum != 1:
        raise NotImplementedError(
            "grad_accum > 1 with an offload schedule or a tracer")
    digest = plan_digest(plan)
    if mesh is not None:
        if offload or traced:
            raise NotImplementedError(
                "on a mesh only a two-tier plan runs (no offload walker, no "
                "tracer)")
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, digest)
        if len(set(digests)) != 1:
            raise RuntimeError(f"the ranks planned differently: plan "
                               f"digests {digests}")
        log_fn(f"[mesh] {shd.mesh_shape(mesh)}: {len(digests)} ranks run "
               f"one plan (digest {digest[:16]}); rank 0 reads {data.hosts} "
               f"of {loop.global_batch // data.host_batch} batch slices from "
               f"slice {data.host}")
    if offload:
        log_fn(f"[offload] three-tier plan: "
               f"{plan.schedule.count('Foff')} host offloads, predicted "
               f"{plan.expected_time:.4f}s model time/step — eager executor "
               f"engaged\n{plan.summary()}")
    elif plan is not None:
        log_fn(f"[rotor] {count_checkpoint_scopes(tree)} checkpoint scopes "
               f"over {model.n_stages()} stages"
               + (", one span per schedule op" if traced else "")
               + f"\n{plan.summary()}")
    opt_state = adamw_init(tensors_of(params))
    manager = (CheckpointManager(loop.ckpt_dir, keep=loop.ckpt_keep,
                                 writer=rank == 0)
               if loop.ckpt_dir else None)
    start_step = 0
    if manager is not None and manager.latest_step() is not None:
        s, state = manager.restore({"params": params, "opt": opt_state,
                                    "step": 0})
        params, opt_state = state["params"], state["opt"]
        start_step = state["step"] + 1
        log_fn(f"[ckpt] restored step {s} from {loop.ckpt_dir}; resuming "
               f"at step {start_step}")
    opt_cfg = AdamWConfig(lr=loop.lr)
    lr_fn = linear_warmup_cosine(loop.lr, loop.warmup, loop.steps)
    if offload:
        step_fn = make_offload_step(model, opt_cfg, plan.schedule, lr_fn,
                                    tracer=tracer)
    else:
        step_fn = make_train_step(model, opt_cfg, tree, lr_fn,
                                  grad_accum=loop.grad_accum, mesh=mesh,
                                  tracer=tracer)
    # parameters + gradients + the two float32 moments (this rank's shards)
    param_bytes = local_bytes(params)
    static_bytes = 2 * param_bytes + local_bytes(opt_state["mu"]) * 2
    cuda = dev.type == "cuda"
    tokens = loop.global_batch * loop.seq_len
    losses, records, saves = [], [], []
    watchdog = StragglerWatchdog(threshold=STRAGGLER_THRESHOLD)
    saved_step = None

    def save(step: int, blocking: bool) -> None:
        nonlocal saved_step
        manager.save(step, {"params": params, "opt": opt_state,
                            "step": step}, blocking=blocking, plan=plan)
        saves.append(manager.last_save)
        saved_step = step
        log_fn(f"[ckpt] step {step}: {manager.last_save['bytes']} B copied "
               f"to host in {manager.last_save['snapshot_s']:.3f}s, "
               + ("written" if blocking else "writing on a thread"))

    comm = None
    t_begin = time.perf_counter()
    step = start_step - 1
    last_spans = 0      # the tracer's spans before the last step
    try:
        for step in range(start_step, loop.steps):
            batch = data.device_batch(step, dev)
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            watchdog.step_begin()
            if traced:
                last_spans = len(tracer)
            t0 = time.perf_counter()
            shd.reset_collectives()
            with (shd.axis_rules(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                metrics = step_fn(params, opt_state, batch, step)
            if mesh is not None and comm is None:
                comm = shd.collectives()
            loss = float(metrics["loss"])  # waits for the step
            if cuda:
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            # the forward and backward's spans reset the peak counter
            peak = (max(torch.cuda.max_memory_allocated(dev),
                        metrics["grads_peak"]) - static_bytes
                    if cuda else None)
            if not math.isfinite(loss):
                raise FloatingPointError(f"step {step}: loss {loss}")
            obs_metrics.histogram("train.step_seconds").observe(seconds)
            obs_metrics.gauge("train.loss").set(loss)
            losses.append(loss)
            rec = {"loss": loss, "seconds": seconds,
                   "grad_norm": float(metrics["grad_norm"]),
                   "tokens_per_s": tokens / seconds,
                   "activation_peak_bytes": peak,
                   "fwd_bwd_peak_bytes": metrics["fwd_bwd_peak"],
                   "t_start": t0, "t_end": t0 + seconds}
            for key in ("host_peak_bytes", "host_bytes_after",
                        "prefetch_wait_s"):
                rec[key] = metrics.get(key)
            records.append(rec)
            if step % loop.log_every == 0:
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"gnorm {float(metrics['grad_norm']):.3f} "
                       f"{seconds:.3f}s {tokens / seconds:.0f} tok/s"
                       + (f" act-peak {peak / 2**30:.3f} GiB" if cuda else "")
                       + (f" host-peak {rec['host_peak_bytes'] / 2**30:.3f} "
                          f"GiB prefetch-wait {rec['prefetch_wait_s']:.4f}s"
                          if offload else ""))
            ev = watchdog.step_end(step)
            if ev is not None:
                log_fn(f"[watchdog] straggler at step {ev.step}: "
                       f"{ev.duration:.2f}s vs median {ev.median:.2f}s")
            restart = watchdog.should_restart
            if manager is not None and mesh is not None:
                restart = _agree(restart, dev)
            if manager is not None and restart:
                log_fn("[watchdog] persistent straggler — checkpointing for "
                       "restart")
                save(step, blocking=True)
                break
            if (manager is not None and loop.ckpt_every
                    and (step + 1) % loop.ckpt_every == 0):
                save(step, blocking=not loop.async_ckpt)
    finally:
        if manager is not None:
            manager.wait()
    wall = time.perf_counter() - t_begin
    if manager is not None and step >= start_step and saved_step != step:
        save(step, blocking=True)
    result = {"losses": losses, "steps": records, "params": params,
              "opt_state": opt_state, "plan": plan, "chain": chain,
              "wall_s": wall,
              "tokens_per_s": tokens * max(len(losses), 1) / max(wall, 1e-9),
              "start_step": start_step, "last_step": step,
              "straggler_events": len(watchdog.events), "ckpt_saves": saves,
              "plan_digest": digest, "param_bytes_local": param_bytes,
              "data_slices": (data.host, data.hosts),
              "collective_bytes": comm}
    if traced and tracer.spans:
        if loop.trace_path:
            tracer.save(loop.trace_path)
            log_fn(f"[obs] wrote {len(tracer.spans)} spans to "
                   f"{loop.trace_path}")
        if plan is not None:
            # the last (warmest) step's spans against the prediction
            from ..obs.drift import compare
            report = compare(plan, tracer.spans[last_spans:])
            log_fn(f"[obs] {report.summary()}")
            result["drift"] = report
    return result
