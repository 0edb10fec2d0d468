"""Training loop on one device: rotor-planned remat or an eager three-tier
(host-offload) schedule, AdamW, deterministic synthetic data, and per-step
time and memory.  Every step reports ``train.step_seconds`` and
``train.loss`` to :mod:`repro_torch.obs.metrics`; tracing (a tracer, or
``TrainLoopConfig.trace_path``) is opt-in."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.shapes import ShapeSpec, input_specs
from ..core.chain import Chain
from ..core.rematerialize import count_checkpoint_scopes
from ..data.pipeline import SyntheticLMData
from ..device import resolve_device
from ..launch.steps import (make_offload_step, make_train_step,
                            measure_chain, plan_training)
from ..models.lm import StagedLM
from ..obs import metrics as obs_metrics
from ..optim.adamw import AdamWConfig, adamw_init
from ..optim.schedules import linear_warmup_cosine
from ..tree import tensors_of, tree_bytes


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    lr: float = 3e-4
    warmup: int = 10
    log_every: int = 10
    policy: Optional[str] = None        # remat policy override
    num_slots: Optional[int] = None     # DP discretization (None = default)
    solver_impl: Optional[str] = None   # DP fill (dp_kernels.KNOWN_IMPLS)
    grad_accum: int = 1                 # microbatch accumulation factor
    peak_flops: Optional[float] = None  # prices the chain's stage times
    trace_path: Optional[str] = None    # write a Perfetto trace.json here


def run_training(cfg, loop: TrainLoopConfig, device=None,
                 params: Optional[Dict[str, Any]] = None,
                 log_fn: Callable[[str], None] = print,
                 chain: Optional[Chain] = None,
                 tracer=None) -> Dict[str, Any]:
    """Train a :class:`StagedLM` on ``device`` (CUDA unless the caller says
    otherwise).  ``params`` (e.g. bridged from the JAX package) replaces the
    seeded initialization.  The plan is solved on ``chain`` if one is given
    (e.g. a calibrated one); otherwise, on CUDA, on the chain measured on
    these parameters and the first batch (``launch.steps.measure_chain``,
    the paper's §5.1 measurement), and elsewhere on the analytic chain
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
    ``loop.trace_path`` is set) is threaded into the plan: every step runs
    on the op walker, whatever the plan, with one span per schedule op (on
    CUDA, event pairs on the stream that runs each op); store-all (no plan)
    gets one ``Step`` span per step.  The spans are written to
    ``loop.trace_path`` as a Perfetto file, and with a plan the result
    gains ``drift``, the plan's prediction against the last step's spans
    (:func:`repro_torch.obs.drift.compare`)."""
    dev = resolve_device(device)
    if tracer is None and loop.trace_path:
        from ..obs.trace import Tracer
        tracer = Tracer(name="train")
    traced = tracer is not None and tracer.enabled
    model = StagedLM(cfg)
    if params is None:
        params = model.init(loop.seed, dev)
    data = SyntheticLMData(cfg, loop.global_batch, loop.seq_len,
                           seed=loop.seed)
    policy = loop.policy if loop.policy is not None else cfg.remat_policy
    if chain is None and dev.type == "cuda" and policy != "none":
        t0 = time.perf_counter()
        chain = measure_chain(model, params, data.device_batch(0, dev))
        log_fn(f"[plan] chain of {chain.length + 1} stages measured on "
               f"{dev} in {time.perf_counter() - t0:.2f}s")
    shape = ShapeSpec("train", "train", loop.seq_len, loop.global_batch)
    plan, chain = plan_training(model, input_specs(cfg, shape), policy,
                                peak_flops=loop.peak_flops,
                                num_slots=loop.num_slots,
                                impl=loop.solver_impl, device=dev,
                                chain=chain)
    offload = plan is not None and plan.uses_offload
    walker = plan is not None and (offload or traced)
    tree = plan.tree if plan is not None and not walker else None
    if walker and loop.grad_accum != 1:
        raise NotImplementedError(
            "grad_accum > 1 with an offload schedule or a tracer")
    if offload:
        log_fn(f"[offload] three-tier plan: "
               f"{plan.schedule.count('Foff')} host offloads, predicted "
               f"{plan.expected_time:.4f}s model time/step — eager executor "
               f"engaged\n{plan.summary()}")
    elif walker:
        log_fn(f"[trace] two-tier plan on the op walker, one span per op\n"
               f"{plan.summary()}")
    elif plan is not None:
        log_fn(f"[rotor] {count_checkpoint_scopes(tree)} checkpoint scopes "
               f"over {model.n_stages()} stages\n{plan.summary()}")
    leaves = tensors_of(params)
    opt_state = adamw_init(leaves)
    opt_cfg = AdamWConfig(lr=loop.lr)
    lr_fn = linear_warmup_cosine(loop.lr, loop.warmup, loop.steps)
    if walker:
        step_fn = make_offload_step(model, opt_cfg, plan.schedule, lr_fn,
                                    tracer=tracer)
    else:
        step_fn = make_train_step(model, opt_cfg, tree, lr_fn,
                                  grad_accum=loop.grad_accum)
    # parameters + gradients + the two float32 moments
    param_bytes = tree_bytes(params)
    static_bytes = 2 * param_bytes + tree_bytes(opt_state["mu"]) * 2
    cuda = dev.type == "cuda"
    tokens = loop.global_batch * loop.seq_len
    losses, records = [], []
    t_begin = time.perf_counter()
    for step in range(loop.steps):
        batch = data.device_batch(step, dev)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        metrics = step_fn(params, opt_state, batch, step)
        loss = float(metrics["loss"])  # waits for the step
        if cuda:
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        # the forward and backward's spans reset the peak counter
        peak = (max(torch.cuda.max_memory_allocated(dev),
                    metrics["grads_peak"]) - static_bytes if cuda else None)
        if not math.isfinite(loss):
            raise FloatingPointError(f"step {step}: loss {loss}")
        obs_metrics.histogram("train.step_seconds").observe(seconds)
        obs_metrics.gauge("train.loss").set(loss)
        if traced and plan is None:
            t1 = tracer.now()
            tracer.record("Step", step, t1 - seconds, t1)
        losses.append(loss)
        rec = {"loss": loss, "seconds": seconds,
               "tokens_per_s": tokens / seconds,
               "activation_peak_bytes": peak,
               "fwd_bwd_peak_bytes": metrics["fwd_bwd_peak"]}
        for key in ("host_peak_bytes", "host_bytes_after", "prefetch_wait_s"):
            rec[key] = metrics.get(key)
        records.append(rec)
        if step % loop.log_every == 0:
            log_fn(f"step {step:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f} "
                   f"{seconds:.3f}s {tokens / seconds:.0f} tok/s"
                   + (f" act-peak {peak / 2**30:.3f} GiB" if cuda else "")
                   + (f" host-peak {rec['host_peak_bytes'] / 2**30:.3f} GiB"
                      f" prefetch-wait {rec['prefetch_wait_s']:.4f}s"
                      if offload else ""))
    wall = time.perf_counter() - t_begin
    result = {"losses": losses, "steps": records, "params": params,
              "opt_state": opt_state, "plan": plan, "chain": chain,
              "wall_s": wall,
              "tokens_per_s": tokens * max(len(losses), 1) / max(wall, 1e-9)}
    if traced and tracer.spans:
        if loop.trace_path:
            tracer.save(loop.trace_path)
            log_fn(f"[obs] wrote {len(tracer.spans)} spans to "
                   f"{loop.trace_path}")
        if plan is not None:
            # the last (warmest) step's spans against the prediction
            from ..obs.drift import compare
            report = compare(plan, tracer.spans[-len(plan.schedule):])
            log_fn(f"[obs] {report.summary()}")
            result["drift"] = report
    return result
