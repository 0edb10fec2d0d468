"""Planning for a (model × shape × mesh) — on the analytic chain or on a
chain measured on real tensors — the train steps (the nested-checkpoint
step of a two-tier plan, the eager step of an offload plan), the serving
steps (prefill and decode, on a mesh under ``DECODE_RULES``), and the
sharding trees of a mesh run: parameters and moments placed by their
logical axes (:func:`shard_tree`), the batch's axes, and the mesh terms of
planning (per-device activation sizes and budget)."""

from __future__ import annotations

import hashlib
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..core import solver_cache
from ..core.chain import Chain, HostTransferModel
from ..core.planner import (grad_with_peaks, profile_stages_analytic,
                            profile_stages_measured, time_stages_in_chain)
from ..data.pipeline import sequence_shape
from ..distributed import sharding as shd
from ..models.flops import stage_flops
from ..models.lm import StagedLM
from ..offload.executor import execute_offload_schedule
from ..offload.host_buffer import HostBuffer
from ..optim.adamw import AdamWConfig, adamw_update
from ..plan import MemoryPlan, resolve_policy, two_tier_fallback
from ..tree import map_with_paths, tensors_of, tree_bytes, tree_map


# ---------------------------------------------------------------------------
# sharding trees
# ---------------------------------------------------------------------------

def axes_at(axes_tree: Any, path: str) -> Tuple[Any, ...]:
    """The logical axes of the leaf at ``path`` (as
    :func:`repro_torch.tree.leaves_with_paths` names it) in an axes tree
    (dicts and lists down to one tuple per leaf)."""
    node = axes_tree
    for key in path.split("/") if path else []:
        node = node[int(key)] if isinstance(node, list) else node[key]
    if not isinstance(node, tuple):
        raise ValueError(f"no logical axes at {path!r}")
    return node


def shard_tree(tree: Any, axes_tree: Any, mesh, rules=None) -> Any:
    """Every tensor of ``tree`` (the same full value on every rank) as a
    DTensor on ``mesh`` with its logical axes' placements; each rank keeps
    its shards.  Other leaves (the optimizer's step count) stay as they
    are."""

    def place(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        return shd.distribute(t, mesh, shd.placements_for(
            axes_at(axes_tree, path), t.shape, mesh, rules))

    return map_with_paths(place, tree)


def sharding_of(tree: Any) -> Any:
    """The :class:`~repro_torch.distributed.sharding.MeshSharding` of every
    DTensor leaf (``None`` for the others)."""
    from torch.distributed.tensor import DTensor

    return map_with_paths(
        lambda _, t: (shd.MeshSharding(t.device_mesh, tuple(t.placements))
                      if isinstance(t, DTensor) else None), tree)


def batch_axes(cfg, kind: str) -> Dict[str, tuple]:
    """Logical axes of a batch's arrays (``kind``: train, prefill or
    decode)."""
    if kind == "decode":
        tok = (("act_batch", None, None) if cfg.modality == "audio_embed"
               else ("act_batch", None))
        return {"tokens": tok}
    ax: Dict[str, tuple] = {}
    if cfg.modality == "text":
        ax["tokens"] = ("act_batch", "act_seq")
    elif cfg.modality == "audio_embed":
        ax["embeds"] = ("act_batch", "act_seq", None)
    else:
        ax["image_embeds"] = ("act_batch", None, None)
        ax["tokens"] = ("act_batch", "act_seq")
    if kind == "train":
        ax["labels"] = ("act_batch", "act_seq")
        ax["loss_mask"] = ("act_batch", "act_seq")
    return ax


def opt_axes(param_axes: Any) -> Dict[str, Any]:
    """Logical axes of the AdamW state: the moments as the parameters."""
    return {"mu": param_axes, "nu": param_axes, "count": ()}


def local_bytes(tree: Any) -> int:
    """The bytes this rank holds of ``tree``'s tensors (a DTensor's
    shard)."""
    return tree_bytes([shd.local_tensor(t) for t in tensors_of(tree)])


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------

def activation_budget_bytes(param_bytes: int,
                            device: Optional[torch.device] = None,
                            slack: float = 0.9, n_devices: int = 1,
                            total: Optional[int] = None) -> float:
    """Activation budget of one device: its memory less parameters, gradients
    (both in the parameter dtype) and the two float32 AdamW moments, which
    for bf16 parameters is ``param_bytes * (1 + 1 + 4)``, the three sharded
    over ``n_devices`` (ZeRO-3).  The memory is ``total`` bytes if given
    (a dry-run's ``Hardware.hbm_bytes``, no card present), else the CUDA
    ``device``'s."""
    if total is None:
        total = torch.cuda.get_device_properties(device).total_memory
    return max(total * slack - param_bytes * (1 + 1 + 4) / n_devices,
               total * 0.05)


def plan_chain(model: StagedLM, batch_specs: Dict[str, torch.Tensor],
               peak_flops: float,
               host: Optional[HostTransferModel] = None,
               allocator: bool = False, mesh=None) -> Chain:
    """Analytic rotor chain for (model × shape × mesh): activation and
    residual sizes from a forward on ``meta`` tensors (each tensor at the
    CUDA allocator's bound with ``allocator``, as :func:`measure_chain`
    counts on CUDA), times from analytic FLOPs over ``peak_flops``, the
    host tier priced by ``host`` (a measured link).  ``batch_specs`` hold
    the global batch; on a ``mesh`` (anything :func:`..distributed.sharding.
    mesh_shape` reads) the sizes are one device's: divided by the
    data-parallel factor when it divides the batch, and the head's
    residuals (the logits) also by the model axis when it divides the
    vocabulary, as ``repro.launch.steps.plan_chain`` has them."""
    B, S = sequence_shape(batch_specs)
    fwd, bwd = stage_flops(model.cfg, B, S)
    params = model.init(device="meta")
    sizes = shd.mesh_shape(mesh) if mesh is not None else {}
    dp = math.prod(sizes.get(a, 1) for a in (shd.POD, shd.DATA))
    chain = profile_stages_analytic(
        model.stage_fns(), model.stage_params(params), batch_specs,
        flops_fwd=fwd, flops_bwd=bwd, peak_flops=peak_flops, host=host,
        allocator=allocator,
        activation_shard_factor=dp if B % dp == 0 else 1)
    tp = sizes.get(shd.MODEL, 1)
    if tp > 1 and model.cfg.vocab_size % tp == 0:
        chain.wabar[-1] /= tp
    return chain


def plan_digest(plan: Optional[MemoryPlan]) -> str:
    """What every rank of a mesh run must agree on: the chain's content
    hash, the schedule and its predicted time (``"store-all"`` without a
    plan)."""
    if plan is None:
        return "store-all"
    h = hashlib.sha256(solver_cache.chain_fingerprint(plan.chain).encode())
    h.update(repr((list(plan.schedule.ops), plan.expected_time)).encode())
    return h.hexdigest()


def measure_chain(model: StagedLM, params: Any, batch: Dict[str, torch.Tensor],
                  host: Optional[HostTransferModel] = None,
                  repeats: int = 3,
                  log_fn: Optional[Callable[[str], None]] = None) -> Chain:
    """Measured rotor chain for (model × batch) on the device ``params``
    and ``batch`` live on: each stage's isolated passes
    (:func:`profile_stages_measured`) give the sizes, which equal
    :func:`plan_chain`'s (with ``allocator=True`` on CUDA), and on CUDA each
    stage's transient memory (``of``/``ob``); the stage times ``uf``/``ub``
    are then taken inside the chain (:func:`time_stages_in_chain`: the
    median of ``repeats`` traced store-all steps, or min-memory steps where
    store-all does not fit).  ``log_fn`` gets which schedule timed the chain
    and, stage by stage, the isolated and in-chain times side by side."""
    stages, sp = model.stage_fns(), model.stage_params(params)
    alone = profile_stages_measured(stages, sp, batch, repeats=repeats,
                                    host=host)
    chain, which = time_stages_in_chain(stages, sp, batch, alone, repeats)
    if log_fn is not None:
        for line in in_chain_lines(alone, chain, which):
            log_fn(f"[measured] {line}")
    return chain


def in_chain_lines(alone: Chain, chain: Chain, which: str) -> List[str]:
    """Stage by stage, the isolated ``uf``/``ub`` beside the in-chain ones
    and their ratio (in-chain / isolated), headed by the schedule that
    timed the chain."""
    lines = [f"stage times inside the chain from {which} steps "
             f"(median over the traced steps); stage: uf isolated s, in "
             f"the chain s (ratio); ub the same"]
    for i in range(chain.length + 1):
        a, b = alone.uf[i], chain.uf[i]
        c, d = alone.ub[i], chain.ub[i]
        lines.append(f"{i + 1}: uf {a:.6e}, {b:.6e} "
                     f"({b / a if a else float('nan'):.4f}); ub {c:.6e}, "
                     f"{d:.6e} ({d / c if c else float('nan'):.4f})")
    return lines


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
                  host: Optional[HostTransferModel] = None,
                  log_fn: Optional[Callable[[str], None]] = None,
                  mesh=None, hbm_bytes: Optional[int] = None
                  ) -> Tuple[Optional[MemoryPlan], Optional[Chain]]:
    """Resolve the remat policy into a :class:`MemoryPlan` (``None`` =
    store-all, no remat).  The chain is profiled with :func:`plan_chain`
    (priced with ``host``, one device's sizes on ``mesh``) unless one is
    given (a measured or calibrated chain); an ``optimal_offload:B:BW``
    policy prices the host tier with its own ``BW``.  ``auto`` budgets are
    sized from ``device``'s memory, or from ``hbm_bytes`` where given (a
    dry-run's device, no card present), the states sharded over the mesh.
    ``log_fn`` gets one line with the solver cache's hits and misses for
    this plan (a hit ran no fill)."""
    policy = policy if policy is not None else model.cfg.remat_policy
    if policy == "none":
        return None, None
    if chain is None:
        if peak_flops is None:
            raise ValueError(f"policy {policy!r} needs peak_flops to price "
                             f"the analytic chain's stages, or a chain")
        chain = plan_chain(model, batch_specs, peak_flops, host=host,
                           mesh=mesh)

    def auto_budget() -> float:
        if hbm_bytes is None and (device is None or device.type != "cuda"):
            raise ValueError("an 'auto' budget needs a CUDA device or "
                             "hbm_bytes")
        return activation_budget_bytes(
            tree_bytes(model.init(device="meta")), device,
            n_devices=math.prod(shd.mesh_shape(mesh).values())
            if mesh is not None else 1, total=hbm_bytes)

    before = solver_cache.stats()
    plan = resolve_policy(policy, chain, num_slots=num_slots, impl=impl,
                          auto_budget=auto_budget)
    if log_fn is not None:
        after = solver_cache.stats()
        log_fn(f"[plan] solver cache: "
               f"{after['hits'] - before['hits']} hits / "
               f"{after['misses'] - before['misses']} misses for this plan "
               f"({after['hits']} / {after['misses']} in this process)")
    return plan, plan.chain


def plan_rotor_tree(model: StagedLM, batch_specs: Dict[str, torch.Tensor],
                    policy: Optional[str] = None, **kwargs):
    """Back-compat wrapper: ``(tree, chain)``, the policy's recursion tree
    (``None`` = store-all) and the chain it was planned on.  A tree runs as
    nested checkpoints, which cannot copy to the host, so a plan that
    offloads degrades to the best two-tier plan at the same device budget
    (``two_tier_fallback``), as the JAX package's jitted path does.  New code
    should call :func:`plan_training` (``kwargs`` go to it) and keep the
    whole :class:`MemoryPlan`."""
    plan, chain = plan_training(model, batch_specs, policy, **kwargs)
    if plan is None:
        return None, chain
    if plan.uses_offload:
        plan = two_tier_fallback(plan, chain)
    return plan.tree, chain


def make_train_step(model: StagedLM, opt_cfg: AdamWConfig, tree,
                    lr_fn: Optional[Callable[[int], float]] = None,
                    grad_accum: int = 1, mesh=None):
    """``train_step(params, opt_state, batch, step) -> metrics``: loss and
    gradients through the plan's tree, then one AdamW step in place.
    ``grad_accum > 1`` splits the batch along its leading axis into
    microbatches and accumulates float32 gradients before the step.  On a
    ``mesh`` the parameters and moments are DTensors (ZeRO-3, the model's
    stages gathering theirs): each rank runs its own slice of the batch and
    backpropagates its loss over the data-parallel factor, so that the
    gradients, summed over the batch-sharded mesh dimensions, are the global
    batch's; ``loss`` is the ranks' mean.  On CUDA, ``metrics["grads_peak"]`` is the allocator's peak before the
    optimizer runs and ``metrics["fwd_bwd_peak"]`` the largest, over the
    microbatches, of each one's peak less the memory at its start and less
    the parameter gradients it has made by then
    (``core.planner.grad_with_peaks``; the running float32 sums are part
    of the memory at its start); both ``None`` off CUDA.  The caller
    resets the peak counter before the step."""

    dp, dp_groups = 1, []
    if mesh is not None:
        if grad_accum != 1:
            raise NotImplementedError("grad_accum > 1 on a mesh")
        dp = shd.data_position(mesh)[0]
        # the loss is summed over each batch-sharded axis in turn (pod, then
        # data)
        dp_groups = [mesh.get_group(a) for a in shd.batch_mesh_dims(mesh)]

    def train_step(params, opt_state, batch, step: int) -> dict:
        leaves = tensors_of(params)
        dev = shd.local_tensor(leaves[0]).device
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
            grads, peak, act = grad_with_peaks(
                [loss / dp if dp > 1 else loss], leaves, params=leaves)
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
        loss = loss.detach()
        if dp_groups:
            loss = loss.clone()
            for group in dp_groups:
                loss = shd.all_reduce(loss, group)
            loss = loss / dp
        metrics.update(loss=loss, grads_peak=grads_peak,
                       fwd_bwd_peak=fwd_bwd)
        return metrics

    return train_step


# ---------------------------------------------------------------------------
# serving steps (prefill, decode) on one device or a mesh
# ---------------------------------------------------------------------------

def serving_params(model: StagedLM, params: Any, mesh) -> Any:
    """This rank's parameters for serving on ``mesh`` (plain tensors, no
    collective): every leaf whole, but for the model shard that a
    tensor-parallel block keeps (``StagedLM.gather_modes`` ``data``, and a
    routed expert stack's ``local``), cut out of it as ``spec_for``'s
    ``Shard`` on the model axis cuts it."""
    from ..distributed import tensor_parallel as tp

    mode_of, axes = model.gather_modes(mesh), model.param_axes()

    def one(path, t):
        if not isinstance(t, torch.Tensor) or mode_of(path) in ("full",
                                                                "partial"):
            return t
        spec = shd.spec_for(axes_at(axes, path), t.shape, mesh)
        for dim, entry in enumerate(spec):
            if entry == shd.MODEL:
                a, b = tp.model_slice(t.shape[dim], mesh)
                t = t.narrow(dim, a, b - a)
        return t.contiguous()

    with torch.no_grad():
        return map_with_paths(one, params)


def _on_mesh(mesh, rules):
    import contextlib

    return (shd.axis_rules(mesh, rules) if mesh is not None
            else contextlib.nullcontext())


def make_prefill_step(model: StagedLM, mesh=None, rules=None):
    """``prefill_step(params, batch, max_len=None) -> (logits, cache)``:
    :meth:`StagedLM.prefill`, on ``mesh`` under ``rules``
    (``DECODE_RULES`` by default) with :func:`serving_params`' parameters:
    the blocks split over the model axis, each rank keeping its shard of
    the cache."""
    rules = rules or shd.DECODE_RULES

    def prefill_step(params, batch, max_len=None):
        with _on_mesh(mesh, rules):
            return model.prefill(params, batch, max_len=max_len)

    return prefill_step


def make_serve_step(model: StagedLM, mesh=None, rules=None):
    """``serve_step(params, cache, tokens) -> (logits, cache)``: one
    :meth:`StagedLM.decode_step` on ``mesh`` under ``rules``
    (``DECODE_RULES`` by default): this rank's rows of ``tokens``, its shard
    of the cache written in place."""
    rules = rules or shd.DECODE_RULES

    def serve_step(params, cache, tokens, residency=None):
        with _on_mesh(mesh, rules):
            return model.decode_step(params, cache, tokens,
                                     residency=residency)

    return serve_step


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


# ---------------------------------------------------------------------------
# one (arch × shape) cell on a mesh, for a dry-run
# ---------------------------------------------------------------------------

def cell_rules(shape) -> Dict[str, Tuple[str, ...]]:
    """The rules table a cell runs under: ``LONG_CONTEXT_RULES`` for
    long_500k, ``DECODE_RULES`` for serving, the defaults for training."""
    if shape.name == "long_500k":
        return shd.LONG_CONTEXT_RULES
    if shape.kind in ("decode", "prefill"):
        return shd.DECODE_RULES
    return shd.DEFAULT_RULES


def _local_specs(tree: Any, axes_tree: Any, mesh, rules) -> Any:
    """Uninitialized tensors of this rank's shard of every ``meta`` leaf of
    ``tree`` (cut as ``spec_for`` its logical axes cuts it)."""
    from ..models.lm import _local_shape

    return map_with_paths(
        lambda path, t: torch.empty(
            _local_shape(t.shape, axes_at(axes_tree, path), mesh, rules),
            dtype=t.dtype), tree)


def plan_cell(model: StagedLM, shape, mesh, policy: Optional[str], hw
              ) -> Tuple[Optional[MemoryPlan], Chain]:
    """A train cell's plan on one device of ``mesh`` (``None``: store-all)
    and the analytic chain it was planned on, priced at ``hw``: ``policy``
    (the config's own if ``None``), an ``auto`` budget against
    ``hw.hbm_bytes``; an offload plan is replaced by its two-tier fallback
    (a mesh runs two-tier plans only)."""
    from ..configs.shapes import input_specs
    from ..plan import two_tier_fallback

    specs = input_specs(model.cfg, shape)
    plan, chain = plan_training(model, specs, policy,
                                peak_flops=hw.peak_bf16, mesh=mesh,
                                hbm_bytes=hw.hbm_bytes)
    if plan is not None and plan.uses_offload:
        plan = two_tier_fallback(plan, chain)
    if chain is None:  # store-all: the chain still prices the terms
        chain = plan_chain(model, specs, hw.peak_bf16, mesh=mesh)
    return plan, chain


def build_cell(cfg, shape, mesh, policy: Optional[str] = None, hw=None):
    """``(step, args, rules, extra)`` for one (arch × shape) cell on
    ``mesh``, rank 0's view: ``step(*args)`` runs the cell's whole step
    (train: loss, gradients and the AdamW update; prefill; one decode step
    over a full cache) under ``rules`` (:func:`cell_rules`).  The arguments
    are uninitialized tensors on the CPU: the dry-run calls this under a
    ``FakeTensorMode``, so nothing is allocated.  Parameters and moments of
    a train cell are DTensors placed by ``StagedLM.param_axes`` (ZeRO-3,
    each stage gathering its own); the train and decode batches and the
    decode cache are rank 0's shards (``batch_axes``,
    ``StagedLM.cache_axes``), a prefill's batch the whole one (``prefill``
    cuts the rank's rows); the serving parameters :func:`serving_params`'.
    A train cell is planned by :func:`plan_cell` at ``hw``
    (:data:`.mesh.H100_SXM` if ``None``).  ``extra``: ``{"tree", "chain",
    "plan"}`` for training, ``{}`` otherwise."""
    from ..configs.shapes import input_specs
    from ..optim.adamw import adamw_init
    from .mesh import H100_SXM

    hw = hw or H100_SXM
    model = StagedLM(cfg)
    rules = cell_rules(shape)
    meta = model.init(device="meta")

    def under_rules(fn):
        def step(*args):
            with shd.axis_rules(mesh, rules):
                return fn(*args)
        return step

    batch = _local_specs(input_specs(cfg, shape), batch_axes(cfg, shape.kind),
                         mesh, rules)
    if shape.kind == "train":
        plan, chain = plan_cell(model, shape, mesh, policy, hw)
        tree = plan.tree if plan is not None else None
        params = shard_tree(
            tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype)
                     .requires_grad_(), meta), model.param_axes(), mesh,
            rules)
        model.gather = model.gather_modes(mesh)
        opt_state = adamw_init(tensors_of(params))
        fn = make_train_step(model, AdamWConfig(), tree, mesh=mesh)
        return (under_rules(fn), (params, opt_state, batch, 0), rules,
                {"tree": tree, "chain": chain, "plan": plan})
    params = serving_params(model, tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype), meta), mesh)
    if shape.kind == "prefill":   # the whole batch: each rank cuts its rows
        fn = make_prefill_step(model, mesh, rules)
        whole = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                         input_specs(cfg, shape))
        return under_rules(fn), (params, whole), rules, {}
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="cpu", mesh=mesh, rules=rules)
    cache["pos"] = shape.seq_len - 1   # the step attends over the whole cache
    fn = make_serve_step(model, mesh, rules)
    return under_rules(fn), (params, cache, batch["tokens"]), rules, {}
