"""Batched serving loop — the port of ``repro.runtime.serve_loop``: prefill
a batch of prompts, then greedy-decode one token a step (finished
sequences keep decoding into padding).

KV-cache residency is pluggable: pass a :func:`..plan.serving.plan_serving`
plan (``plan=``) to stage the planner's layer set through pinned host
memory around every step, or ``kv_policy="lru"`` with a byte budget for
the on-demand baseline the planner is measured against
(:mod:`.kv_residency`); a plan must pass the static verifier
(:meth:`MemoryPlan.verify`) or the run is refused.  The run reports to
:mod:`repro_torch.obs.metrics` — ``serve.kv_bytes`` (the cache's logical
bytes at its position), ``serve.kv_bytes_allocated``,
``serve.prefill_seconds`` and ``serve.decode_tokens`` (live tokens), and
through the residency policy ``serve.kv_transfer_bytes`` and
``serve.kv_stall_seconds`` — each equal to its entry in the returned dict.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.lm import StagedLM
from ..obs import metrics as obs_metrics
from ..tree import tensors_of


@dataclasses.dataclass
class ServeLoopConfig:
    max_new_tokens: int = 16
    max_len: int = 256
    greedy: bool = True
    eos_id: Optional[int] = None


def _make_residency(model, layout, tracer, *, plan, kv_policy, kv_budget,
                    host, host_buffer):
    """The KV-residency policy of this run (None: the whole cache stays on
    the device)."""
    if plan is not None and kv_policy is not None:
        raise ValueError("pass either plan= or kv_policy=, not both")
    if plan is None and kv_policy is None:
        return None
    from ..offload.host_buffer import HostBuffer
    from .kv_residency import LRUKV, PlannedKV
    buffer = host_buffer if host_buffer is not None else HostBuffer(None)
    if plan is not None:
        from ..plan.serving import kv_residency_layers
        plan._verify_or_raise("refusing to serve an unverified kv plan")
        layers = kv_residency_layers(plan, budget_bytes=kv_budget)
        link = host or (plan.chain.host if plan.chain is not None else None)
        if link is None:
            raise ValueError("the plan has no host link; pass host=")
        return PlannedKV(model, layout, layers, link=link, buffer=buffer,
                         tracer=tracer)
    if kv_policy != "lru":
        raise ValueError(f"unknown kv_policy {kv_policy!r}; expected 'lru' "
                         f"(or pass plan= for the planned policy)")
    if kv_budget is None:
        raise ValueError("kv_policy='lru' needs kv_budget= (device KV bytes)")
    if host is None:
        raise ValueError("kv_policy='lru' needs host= (the host link that "
                         "prices its copies; the port keeps no default)")
    return LRUKV(model, layout, kv_budget, link=host, buffer=buffer,
                 tracer=tracer)


def _whole_batch(rows: np.ndarray, batch: int, mesh, rules) -> np.ndarray:
    """This rank's generated rows → the whole batch's, gathered over the
    ranks that ``act_batch`` cuts it over (unchanged when it is not)."""
    import torch.distributed as dist

    from ..distributed import tensor_parallel as tp

    block = tp.batch_shard(batch, mesh, rules)
    if block is None:
        return rows
    parts: List[Any] = [None] * block.count
    dist.all_gather_object(parts, (block.index, rows), group=block.group)
    return np.concatenate([r for _, r in sorted(parts, key=lambda x: x[0])])


def run_serving(cfg, params, prompts: np.ndarray, loop: ServeLoopConfig,
                model: Optional[StagedLM] = None, tracer=None, *, plan=None,
                kv_policy: Optional[str] = None,
                kv_budget: Optional[float] = None, host=None,
                host_buffer=None, device=None, mesh=None,
                rules=None) -> Dict[str, Any]:
    """Serve ``prompts`` ((B, S0) int token batch) with ``params`` on
    ``device`` (CUDA unless the caller says otherwise; the parameters must
    live there).  Returns the JAX package's keys — ``generations`` (B, T),
    ``prefill_s``, ``decode_s``, ``decode_tokens`` (live tokens only: a
    sequence finished by ``eos_id`` stops counting), ``decode_tokens_per_s``,
    ``kv_bytes`` (the cache's logical bytes at the end), ``kv_bytes_allocated``
    — and, with a residency policy, its transfer counts (``kv_*``,
    :mod:`.kv_residency`).  On CUDA the clocks follow
    ``torch.cuda.synchronize``, and two readings of the allocator over the
    memory before prefill (the prompts on the card) are added:
    ``device_kv_bytes`` after prefill and after each step (the cache and its
    residency's blocks on the card: the next token's few bytes left out)
    and ``step_peak_bytes``, each decode step's peak.

    KV residency: ``plan=`` (a :func:`..plan.serving.plan_serving` plan;
    ``kv_budget=`` re-clamps its layer set to the requested budget) or
    ``kv_policy="lru"`` with ``kv_budget=`` and ``host=`` (the link, which
    ``plan=`` takes from its chain).  A ``plan`` that fails
    :meth:`MemoryPlan.verify` raises ``PlanVerificationError``.
    ``host_buffer`` supplies the host pool (default: unbounded).

    ``mesh`` (a ``(data, model)`` ``DeviceMesh`` over the default process
    group, every rank calling ``run_serving`` alike with the whole
    ``prompts`` and the whole ``params``) serves under ``rules``
    (``DECODE_RULES`` by default; ``LONG_CONTEXT_RULES`` for a batch too
    small to cut): each rank keeps its shard of the parameters
    (:func:`..launch.steps.serving_params`: the model-sharded weights of a
    tensor-parallel block) and of the whole cache (the KV sequence over
    the model axis under ``DECODE_RULES``), runs its rows of the batch
    where ``act_batch`` cuts it, and every rank returns the whole
    ``generations``.  The result adds ``kv_bytes_local``, the bytes of this
    rank's cache.  A residency plan or policy on a mesh raises
    ``NotImplementedError``: the JAX package plans no residency on a mesh.

    ``tracer`` (a :class:`repro_torch.obs.trace.Tracer`, opt-in) records a
    ``Step`` span for the prefill and one ``Decode`` span per decode step,
    on the host clock after the step's tokens reached the host, each with
    the cache's logical bytes at that point; a residency policy adds its
    booked ``Foff``/``Prefetch`` transfers at their modeled length."""
    dev = resolve_device(device)
    model = model or StagedLM(cfg)
    if mesh is not None:
        if plan is not None or kv_policy is not None:
            raise NotImplementedError(
                "run_serving on a mesh keeps the whole cache on the devices: "
                "the JAX package plans no KV residency on a mesh, so plan= "
                "and kv_policy= are single-device only")
        from ..distributed import sharding as shd
        from ..launch.steps import make_prefill_step, make_serve_step, \
            serving_params
        params = serving_params(model, params, mesh)
        rules = rules or shd.DECODE_RULES
        prefill = make_prefill_step(model, mesh, rules)
        step = make_serve_step(model, mesh, rules)
    else:
        def prefill(p, batch, max_len):
            return model.prefill(p, batch, max_len=max_len)

        step = model.decode_step
    if any(t.device.type != dev.type for t in tensors_of(params)):
        raise ValueError(f"run_serving on {dev}: the parameters live "
                         f"elsewhere")
    B, S0 = prompts.shape
    if S0 + loop.max_new_tokens > loop.max_len:
        raise ValueError(
            f"prompt length {S0} + max_new_tokens {loop.max_new_tokens} "
            f"exceeds max_len {loop.max_len}; raise ServeLoopConfig.max_len")
    layout = model.cache_layout(B, loop.max_len)
    rec = tracer is not None and tracer.enabled
    residency = _make_residency(model, layout, tracer, plan=plan,
                                kv_policy=kv_policy, kv_budget=kv_budget,
                                host=host, host_buffer=host_buffer)
    cuda = dev.type == "cuda"
    kv_held: List[int] = []
    step_peaks: List[int] = []

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(dev)

    def held() -> int:
        """The bytes allocated over ``base`` less the next token's: the
        cache and the residency's blocks on the card."""
        sync()
        return (torch.cuda.memory_allocated(dev) - base
                - -(-next_tok.nbytes // 512) * 512)

    tokens = torch.as_tensor(np.asarray(prompts), device=dev)
    sync()
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    ts0 = tracer.now() if rec else 0.0
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": tokens}, loop.max_len)
    next_tok = torch.argmax(logits[:, -1], dim=-1)
    sync()
    t_prefill = time.perf_counter() - t0
    del logits
    pos0 = cache["pos"]
    kv_bytes = layout.logical_bytes(pos0)
    obs_metrics.gauge("serve.kv_bytes").set(float(kv_bytes))
    obs_metrics.gauge("serve.kv_bytes_allocated").set(
        float(layout.allocated_bytes))
    obs_metrics.histogram("serve.prefill_seconds").observe(t_prefill)
    if rec:
        tracer.record("Step", 0, ts0, tracer.now(), bytes=kv_bytes)
    if residency is not None:
        residency.stage_initial(cache)
        residency.settle()
    if cuda:
        kv_held.append(held())

    out_tokens: List[np.ndarray] = [next_tok.cpu().numpy()]
    done = np.zeros((next_tok.shape[0],), bool)
    if loop.eos_id is not None:
        done |= out_tokens[0] == loop.eos_id
    decode_tokens = 0
    t0 = time.perf_counter()
    for tok_idx in range(loop.max_new_tokens - 1):
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        td0 = tracer.now() if rec else 0.0
        ts = time.perf_counter()
        if residency is not None:
            residency.begin_step(cache)
        logits, cache = step(params, cache, next_tok[:, None],
                             residency=residency)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        del logits
        toks = next_tok.cpu().numpy()
        step_wall = time.perf_counter() - ts
        if cuda:
            step_peaks.append(torch.cuda.max_memory_allocated(dev) - base)
        kv_bytes = layout.logical_bytes(pos0 + tok_idx + 1)
        obs_metrics.gauge("serve.kv_bytes").set(float(kv_bytes))
        if rec:
            tracer.record("Decode", tok_idx + 1, td0, tracer.now(),
                          bytes=kv_bytes)
        decode_tokens += int((~done).sum())
        if loop.eos_id is not None:
            done |= toks == loop.eos_id
        out_tokens.append(toks)
        finished = loop.eos_id is not None and bool(done.all())
        last = finished or tok_idx == loop.max_new_tokens - 2
        if residency is not None:
            if not last:   # no step follows the last one: nothing to book
                residency.end_step(cache, step_wall)
            residency.settle()
        if cuda:
            kv_held.append(held())
        if finished:
            break
    if residency is not None:
        residency.finish()
    sync()
    t_decode = time.perf_counter() - t0
    obs_metrics.counter("serve.decode_tokens").inc(decode_tokens)
    generations = np.stack(out_tokens, axis=1)
    if mesh is not None:
        generations = _whole_batch(generations, B, mesh, rules)
    out = {
        "generations": generations,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tokens": decode_tokens,
        "decode_tokens_per_s": decode_tokens / max(t_decode, 1e-9),
        "kv_bytes": kv_bytes,
        "kv_bytes_allocated": layout.allocated_bytes,
    }
    if mesh is not None:
        out["kv_bytes_local"] = sum(t.numel() * t.element_size()
                                    for t in tensors_of(cache))
    if cuda:
        out["device_kv_bytes"] = kv_held
        out["step_peak_bytes"] = step_peaks
    if residency is not None:
        out.update(residency.result_stats())
    return out
