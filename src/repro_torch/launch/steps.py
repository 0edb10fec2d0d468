"""Planning for a (model × shape) on one device — on the analytic chain or
on a chain measured on real tensors — and the train steps: the
nested-checkpoint step of a two-tier plan and the eager step of an offload
plan."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..core.chain import Chain, HostTransferModel
from ..core.planner import (grad_with_peaks, profile_stages_analytic,
                            profile_stages_measured)
from ..data.pipeline import sequence_shape
from ..models.flops import stage_flops
from ..models.lm import StagedLM
from ..offload.executor import execute_offload_schedule
from ..offload.host_buffer import HostBuffer
from ..optim.adamw import AdamWConfig, adamw_update
from ..plan import MemoryPlan, resolve_policy
from ..tree import tensors_of, tree_bytes


def activation_budget_bytes(param_bytes: int, device: torch.device,
                            slack: float = 0.9) -> float:
    """Activation budget of one device: its memory less parameters, gradients
    (both in the parameter dtype) and the two float32 AdamW moments, which
    for bf16 parameters is ``param_bytes * (1 + 1 + 4)``."""
    total = torch.cuda.get_device_properties(device).total_memory
    return max(total * slack - param_bytes * (1 + 1 + 4), total * 0.05)


def plan_chain(model: StagedLM, batch_specs: Dict[str, torch.Tensor],
               peak_flops: float,
               host: Optional[HostTransferModel] = None,
               allocator: bool = False) -> Chain:
    """Analytic rotor chain for (model × shape): activation and residual
    sizes from a forward on ``meta`` tensors (each tensor at the CUDA
    allocator's bound with ``allocator``, as :func:`measure_chain` counts
    on CUDA), times from analytic FLOPs over ``peak_flops``, the host tier
    priced by ``host`` (a measured link)."""
    B, S = sequence_shape(batch_specs)
    fwd, bwd = stage_flops(model.cfg, B, S)
    params = model.init(device="meta")
    return profile_stages_analytic(
        model.stage_fns(), model.stage_params(params), batch_specs,
        flops_fwd=fwd, flops_bwd=bwd, peak_flops=peak_flops, host=host,
        allocator=allocator)


def measure_chain(model: StagedLM, params: Any, batch: Dict[str, torch.Tensor],
                  host: Optional[HostTransferModel] = None,
                  repeats: int = 3) -> Chain:
    """Measured rotor chain for (model × batch) on the device ``params``
    and ``batch`` live on (:func:`profile_stages_measured` on the model's
    stages): measured times and, on CUDA, each stage's transient memory;
    the sizes equal :func:`plan_chain`'s (with ``allocator=True`` on
    CUDA)."""
    return profile_stages_measured(model.stage_fns(),
                                   model.stage_params(params), batch,
                                   repeats=repeats, host=host)


def _allocated(leaves) -> Optional[int]:
    """The CUDA allocator's bytes in use now (``None`` off CUDA)."""
    dev = leaves[0].device
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


def plan_training(model: StagedLM, batch_specs: Dict[str, torch.Tensor],
                  policy: Optional[str] = None, *,
                  peak_flops: Optional[float] = None,
                  num_slots: Optional[int] = None,
                  impl: Optional[str] = None,
                  device: Optional[torch.device] = None,
                  chain: Optional[Chain] = None,
                  host: Optional[HostTransferModel] = None
                  ) -> Tuple[Optional[MemoryPlan], Optional[Chain]]:
    """Resolve the remat policy into a :class:`MemoryPlan` (``None`` =
    store-all, no remat).  The chain is profiled with :func:`plan_chain`
    (priced with ``host``) unless one is given (a measured or calibrated
    chain); an ``optimal_offload:B:BW`` policy prices the host tier with its
    own ``BW``.  ``auto`` budgets are sized from ``device``'s memory."""
    policy = policy if policy is not None else model.cfg.remat_policy
    if policy == "none":
        return None, None
    if chain is None:
        if peak_flops is None:
            raise ValueError(f"policy {policy!r} needs peak_flops to price "
                             f"the analytic chain's stages, or a chain")
        chain = plan_chain(model, batch_specs, peak_flops, host=host)

    def auto_budget() -> float:
        if device is None or device.type != "cuda":
            raise ValueError("an 'auto' budget needs a CUDA device")
        return activation_budget_bytes(
            tree_bytes(model.init(device="meta")), device)

    plan = resolve_policy(policy, chain, num_slots=num_slots, impl=impl,
                          auto_budget=auto_budget)
    return plan, plan.chain


def make_train_step(model: StagedLM, opt_cfg: AdamWConfig, tree,
                    lr_fn: Optional[Callable[[int], float]] = None,
                    grad_accum: int = 1):
    """``train_step(params, opt_state, batch, step) -> metrics``: loss and
    gradients through the plan's tree, then one AdamW step in place.
    ``grad_accum > 1`` splits the batch along its leading axis into
    microbatches and accumulates float32 gradients before the step.  On
    CUDA, ``metrics["grads_peak"]`` is the allocator's peak before the
    optimizer runs and ``metrics["fwd_bwd_peak"]`` the largest, over the
    microbatches, of each one's peak less the memory at its start and less
    the parameter gradients it has made by then
    (``core.planner.grad_with_peaks``; the running float32 sums are part
    of the memory at its start); both ``None`` off CUDA.  The caller
    resets the peak counter before the step."""

    def train_step(params, opt_state, batch, step: int) -> dict:
        leaves = tensors_of(params)
        dev = leaves[0].device
        cuda = dev.type == "cuda"
        peaks = {"all": 0, "fwd_bwd": 0}

        def loss_and_grads(micro):
            if cuda:
                # the peak since the last reading (the gradient sums'
                # temporaries), then this microbatch's own
                peaks["all"] = max(peaks["all"],
                                   torch.cuda.max_memory_allocated(dev))
                start = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            loss = model.loss_fn(params, micro, tree=tree)
            grads, peak, act = grad_with_peaks([loss], leaves, params=leaves)
            if cuda:
                peaks["all"] = max(peaks["all"], peak)
                peaks["fwd_bwd"] = max(peaks["fwd_bwd"], act - start)
            return loss, grads

        if grad_accum == 1:
            loss, grads = loss_and_grads(batch)
        else:
            n = sequence_shape(batch)[0]
            if n % grad_accum:
                raise ValueError(f"batch {n} does not split into "
                                 f"{grad_accum} microbatches")
            mb = n // grad_accum
            lsum, gsum = 0.0, None
            for i in range(grad_accum):
                l, g = loss_and_grads(
                    {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
                if gsum is None:
                    gsum = [x.float() for x in g]
                else:
                    for s, x in zip(gsum, g):
                        s.add_(x.float())
                lsum = lsum + l.detach()
                del l, g
            loss = lsum / grad_accum
            grads = [(s / grad_accum).to(p.dtype)
                     for s, p in zip(gsum, leaves)]
        grads_peak = fwd_bwd = None
        if cuda:
            grads_peak = max(peaks["all"],
                             torch.cuda.max_memory_allocated(dev))
            fwd_bwd = peaks["fwd_bwd"]
        lr = lr_fn(step) if lr_fn is not None else None
        metrics = adamw_update(opt_cfg, grads, opt_state, leaves, lr)
        metrics.update(loss=loss.detach(), grads_peak=grads_peak,
                       fwd_bwd_peak=fwd_bwd)
        return metrics

    return train_step


def make_offload_step(model: StagedLM, opt_cfg: AdamWConfig, schedule,
                      lr_fn: Optional[Callable[[int], float]] = None,
                      tracer=None):
    """``train_step(params, opt_state, batch, step) -> metrics`` for a
    three-tier (host-offload) schedule, or any schedule when traced:
    gradients come from the eager op walker — real copies to host memory
    and back — then one AdamW step in place.  The metrics add the step's
    ``host_peak_bytes``, the host bytes still parked after it
    (``host_bytes_after``, 0 for a sound schedule), ``prefetch_wait_s``
    and, on CUDA, ``grads_peak`` and ``fwd_bwd_peak`` (as
    :func:`make_train_step`, from the walker's per-op peaks).  ``tracer``
    records one span per schedule op of every step."""
    stage_fns = model.stage_fns()

    def train_step(params, opt_state, batch, step: int) -> dict:
        leaves = tensors_of(params)
        start = _allocated(leaves)
        hb, stats = HostBuffer(), {}
        loss, stage_grads, _ = execute_offload_schedule(
            schedule, stage_fns, model.stage_params(params), batch,
            host_buffer=hb, stats=stats, tracer=tracer)
        lr = lr_fn(step) if lr_fn is not None else None
        grads = tensors_of(model.combine_stage_grads(stage_grads))
        metrics = adamw_update(opt_cfg, grads, opt_state, leaves, lr)
        metrics.update(loss=loss.detach(), host_peak_bytes=hb.peak_bytes,
                       host_bytes_after=hb.bytes_in_use,
                       prefetch_wait_s=stats["prefetch_wait_s"],
                       grads_peak=stats.get("peak_bytes"),
                       fwd_bwd_peak=(None if start is None
                                     else stats["act_peak_bytes"] - start))
        return metrics

    return train_step
