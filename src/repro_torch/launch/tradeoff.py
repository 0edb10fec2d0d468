"""The paper's trade-off (Figs 3–13) and its cost-model check (§5.3) on one
device: ``python -m repro_torch.launch.tradeoff --arch <id> [...]``.

For one chain of stages — a :class:`StagedLM` at a batch, or the paper's
heterogeneous conv chain (``--arch paper-resnet``,
:mod:`repro_torch.configs.paper_resnet`) — the chain is measured once
(:func:`~repro_torch.core.planner.profile_stages_measured`).  Then, at
budgets of ``0.45``, ``0.7`` and ``1.0`` times the measured store-all peak
(for the conv chain the JAX package's list, ``paper_resnet.BUDGETS``), four strategies are planned on that chain and run through
``MemoryPlan.bind(...).value_and_grad``:

- store-all (autograd's default; once, at its own peak);
- the best *sequential* (``checkpoint_sequential``) segment count that fits
  (``core.baselines.best_periodic``);
- ``revolve:B`` and ``rotor:B`` on the chosen DP fill.

Each point is timed with CUDA events (the host clock off CUDA): one warm-up
call, then the median of ``repeats``.  Its activation peak (on CUDA only)
comes from one more untimed call between them: the allocator's peak less
the memory before the call and less the parameter gradients made by then
(``core.planner.grad_with_peaks`` over the bound forward; the offload
walker's own figure for a plan with host copies).  Each row prints the
predicted time and peak (the simulator on the measured chain) beside the
measured ones and the items (tokens, images) per second; an infeasible
point is printed as skipped.  Two summary lines follow: the mean absolute
percentage error of the predicted against the measured times (paper §5.3:
7.8 %), and rotor's gain over the best sequential point at equal memory,
from measured times at each budget and, as the JAX package's benchmark
computes it, from predicted times with rotor planned at each sequential
point's own predicted peak (paper §5.4: mean +17.2 %).

With ``trace``, each point also runs one traced step through
``MemoryPlan.bind(stages, tracer=)`` — the op walker, one span per
schedule op (CUDA-event pairs on the card) — printed beside the untraced
step.  The spans of all points then give the measured per-stage ``uf`` /
``ub`` against the chain's, with each stage's share of the time miss summed
over the points, and the chain calibrated on them
(:func:`~repro_torch.obs.drift.calibrate_from_trace`) re-plans every point
at its budget: the schedules that ran, priced on the calibrated chain,
against the untraced measured times give the calibrated MAPE, printed
beside the uncalibrated one.

    # the conv chain on the CPU, then at the paper's size on the card
    python -m repro_torch.launch.tradeoff --arch paper-resnet --device cpu \\
        --override '{"num_blocks": 6, "base_ch": 8, "image": 16}' \\
        --global-batch 2 --solver-impl plain
    python -m repro_torch.launch.tradeoff --arch paper-resnet \\
        --override '{"num_blocks": 12, "base_ch": 64, "image": 224}' \\
        --global-batch 64 --solver-impl cuda
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..configs import get_config, paper_resnet, smoke_config
from ..core.baselines import best_periodic
from ..core.chain import Chain
from ..core.planner import (_fresh_input, grad_with_peaks,
                            profile_stages_measured)
from ..core.schedule import simulate
from ..core.solver import solve_min_memory
from ..data.pipeline import SyntheticLMData, sequence_shape
from ..device import resolve_device
from ..models.lm import StagedLM
from ..obs.drift import calibrate_from_trace
from ..obs.trace import Tracer, measured_stage_times
from ..offload.executor import execute_offload_schedule
from ..optim.adamw import global_norm
from ..plan import InfeasiblePlanError, MemoryPlan, build_plan, resolve_policy
from ..tree import tensors_of

BUDGETS = (0.45, 0.7, 1.0)


def _activation_peak(plan: MemoryPlan, bound, stages: Sequence[Callable],
                     params: Sequence[Any], x: Any,
                     dev: torch.device) -> int:
    """One untimed call's activation peak on CUDA: the allocator's peak less
    the memory before the call and the parameter gradients made by then."""
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    if bound.remat_expressible:
        inp = _fresh_input(x)
        with torch.enable_grad():
            out = bound.forward(params, inp)
        # a tensor several stages hold (a shared block) is one input
        flat = list({id(t): t for t in tensors_of(list(params))}.values())
        ins = [t for t in tensors_of(inp) if t.is_floating_point()]
        _, _, act = grad_with_peaks([out], ins + flat, [torch.ones_like(out)],
                                    params=flat, allow_unused=True)
    else:
        stats: dict = {}
        execute_offload_schedule(plan.schedule, stages, params, x,
                                 stats=stats)
        act = stats["act_peak_bytes"]
    return act - before


def time_point(plan: MemoryPlan, stages: Sequence[Callable],
               params: Sequence[Any], x: Any, repeats: int = 3) -> dict:
    """``plan.bind(stages).value_and_grad(params, x)`` timed after one
    warm-up call: ``{"seconds" (median of ``repeats``), "peak" (activation
    bytes of one more untimed call; None off CUDA), "loss", "grads"}`` (the
    last two of the last call, read outside the timed region; ``grads`` per
    stage, as ``value_and_grad`` returns them)."""
    bound = plan.bind(stages)
    dev = tensors_of([list(params), x])[0].device
    cuda = dev.type == "cuda"
    bound.value_and_grad(params, x)
    peak = (_activation_peak(plan, bound, stages, params, x, dev) if cuda
            else None)
    times, out, grads = [], None, None
    for _ in range(repeats):
        out = grads = None       # the previous call's results are freed
        if cuda:
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out, grads, _ = bound.value_and_grad(params, x)
        if cuda:
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            times.append(time.perf_counter() - t0)
    return {"seconds": statistics.median(times), "peak": peak,
            "loss": float(out), "grads": grads}


def trace_point(plan: MemoryPlan, stages: Sequence[Callable],
                params: Sequence[Any], x: Any) -> dict:
    """One traced call of ``plan.bind(stages, tracer=).value_and_grad``
    (the op walker): ``{"seconds" (CUDA events; the host clock off CUDA),
    "spans", "loss", "grads"}``.  Raises unless the trace holds one span
    per schedule op, in order, none negative."""
    tracer = Tracer(name="tradeoff")
    bound = plan.bind(stages, tracer=tracer)
    dev = tensors_of([list(params), x])[0].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out, grads, _ = bound.value_and_grad(params, x)
    if cuda:
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) * 1e-3
    else:
        seconds = time.perf_counter() - t0
    spans = tracer.spans
    if [(s.op, s.arg) for s in spans] != list(plan.schedule.ops):
        raise AssertionError(f"{len(spans)} spans for "
                             f"{len(plan.schedule)} schedule ops")
    if any(not s.duration >= 0 for s in spans):
        raise AssertionError("a span of negative length")
    return {"seconds": seconds, "spans": spans, "loss": float(out),
            "grads": grads}


def calibration_report(chain: Chain, rows: List[dict],
                       emit: Callable[[str], None]) -> Dict[str, Any]:
    """The traced spans of ``rows`` against ``chain``: per stage the
    predicted and measured ``uf``/``ub`` and each one's share of the time
    miss (the measured less the predicted time of each op, summed over the
    points' schedules); then the chain calibrated on the spans, every point
    re-planned on it at its budget (its own request: the same fill), and
    the schedules that ran priced on it against their untraced measured
    times (the calibrated MAPE).  Returns the calibrated ``chain`` and
    ``mape_percent``."""
    spans = [s for r in rows for s in r["spans"]]
    uf, ub = measured_stage_times(spans, chain.length)
    fwd_miss, bwd_miss = [0.0] * len(uf), [0.0] * len(ub)
    for r in rows:
        for op, l in r["plan"].schedule.ops:
            if op in ("Fall", "Fck", "Fnone") and not math.isnan(uf[l - 1]):
                fwd_miss[l - 1] += uf[l - 1] - chain.uf[l - 1]
            elif op == "B" and not math.isnan(ub[l - 1]):
                bwd_miss[l - 1] += ub[l - 1] - chain.ub[l - 1]
    emit("stage: uf predicted s, measured s (ratio), its miss summed over "
         "the points s; ub the same")
    for i in range(chain.length + 1):
        emit(f"stage {i + 1}: uf {chain.uf[i]:.6e}, {uf[i]:.6e} "
             f"({uf[i] / chain.uf[i] if chain.uf[i] else math.nan:.4f}), "
             f"{fwd_miss[i]:+.6e}; ub {chain.ub[i]:.6e}, {ub[i]:.6e} "
             f"({ub[i] / chain.ub[i] if chain.ub[i] else math.nan:.4f}), "
             f"{bwd_miss[i]:+.6e}")
    worst_f = max(range(len(uf)), key=lambda i: abs(fwd_miss[i]))
    worst_b = max(range(len(ub)), key=lambda i: abs(bwd_miss[i]))
    miss = sum(r["measured_s"] - r["predicted_s"] for r in rows)
    emit(f"the points' summed miss (measured - predicted) {miss:+.6e} s; "
         f"largest forward share: stage {worst_f + 1}'s uf "
         f"{fwd_miss[worst_f]:+.6e} s, largest backward share: stage "
         f"{worst_b + 1}'s ub {bwd_miss[worst_b]:+.6e} s (traced op times)")
    calibrated = calibrate_from_trace(chain, spans)
    errs, same = [], 0
    for r in rows:
        plan = r["plan"]
        priced = simulate(calibrated, plan.schedule).time
        replanned = (plan.schedule.ops if plan.budget_bytes is None else
                     build_plan(plan.request, calibrated,
                                policy=plan.policy).schedule.ops)
        same += replanned == plan.schedule.ops
        errs.append(abs(priced - r["measured_s"]) / r["measured_s"])
        emit(f"calibrated {r['strategy']} at {r['budget_frac']:g} x "
             f"store-all: predicted {priced:.6e} s (uncalibrated "
             f"{r['predicted_s']:.6e}), measured {r['measured_s']:.6e} s; "
             f"re-planned schedule "
             f"{'the same' if replanned == plan.schedule.ops else 'differs'}")
    mape = 100 * statistics.fmean(errs)
    emit(f"time prediction MAPE on the calibrated chain {mape:.2f} % over "
         f"{len(rows)} points ({same} re-planned to the same schedule)")
    return {"chain": calibrated, "mape_percent": mape}


def run_tradeoff(stages: Sequence[Callable], params: Sequence[Any], x: Any,
                 *, items: int, impl: Optional[str] = None,
                 chain: Optional[Chain] = None, repeats: int = 3,
                 budgets: Sequence[float] = BUDGETS,
                 combine_grads: Optional[Callable[[List[Any]], Any]] = None,
                 emit: Callable[[str], None] = print,
                 trace: bool = False) -> Dict[str, Any]:
    """Plan and run the four strategies at ``budgets`` × the store-all peak
    of ``chain`` (measured here on ``stages``, ``params`` and ``x`` when
    not given); ``items`` (tokens, images) are processed per call, and
    ``combine_grads`` turns the per-stage gradients into the tree whose
    norm is reported (e.g. a shared block's parts summed).  Returns the
    chain, the rows, the MAPE, both gains (``nan`` where no point allows
    one) and the measured gain at each budget where both ran; with
    ``trace``, each row also holds its traced step (``traced_s``,
    ``traced_loss``, ``traced_grad_norm``, ``spans``) and the result the
    :func:`calibration_report` (``calibration``)."""
    if chain is None:
        chain = profile_stages_measured(stages, params, x, repeats=repeats)
    peak = chain.store_all_peak()
    rows: List[dict] = []

    def norm(grads) -> float:
        return float(global_norm(tensors_of(
            combine_grads(grads) if combine_grads is not None else grads)))

    def row(strategy: str, frac: float, plan: MemoryPlan) -> dict:
        got = time_point(plan, stages, params, x, repeats)
        gnorm = norm(got.pop("grads"))
        seconds, measured_peak = got["seconds"], got["peak"]
        r = dict(strategy=strategy, budget_frac=frac,
                 budget_bytes=plan.budget_bytes,
                 predicted_s=plan.expected_time,
                 predicted_peak_bytes=plan.peak_device_mem,
                 measured_s=seconds, measured_peak_bytes=measured_peak,
                 items_per_s=items / seconds, loss=got["loss"],
                 grad_norm=gnorm, plan=plan)
        rows.append(r)
        emit(f"{strategy} at {frac:g} x store-all: predicted "
             f"{r['predicted_s']:.6e} s, peak "
             f"{r['predicted_peak_bytes']:.6e} B; measured "
             f"{seconds:.6e} s, peak {measured_peak} B; "
             f"{r['items_per_s']:.1f} items/s")
        if trace:
            t = trace_point(plan, stages, params, x)
            r.update(traced_s=t["seconds"], traced_loss=t["loss"],
                     traced_grad_norm=norm(t["grads"]), spans=t["spans"])
            emit(f"{strategy} at {frac:g} x store-all traced: "
                 f"{len(t['spans'])} spans (one per op), step "
                 f"{t['seconds']:.6e} s on the op walker against "
                 f"{seconds:.6e} s untraced (x{t['seconds'] / seconds:.4f})")
        return r

    def plan_or_skip(policy: str, frac: float) -> Optional[MemoryPlan]:
        try:
            return resolve_policy(policy, chain, impl=impl)
        except InfeasiblePlanError:
            emit(f"{policy.split(':')[0]} at {frac:g} x store-all "
                 f"({int(frac * peak)} B): infeasible, skipped")
            return None

    floor = solve_min_memory(chain, impl=impl).mem_limit
    emit(f"chain L={chain.length}, store-all peak {peak:.6e} B, two-tier "
         f"min-memory {floor:.6e} B ({floor / peak:.4f} x store-all), "
         f"budgets {list(budgets)} x store-all, fill {impl or 'banded'}")
    row("store-all", 1.0, resolve_policy("none", chain))
    at: Dict[tuple, dict] = {}
    for frac in budgets:
        budget = frac * peak
        got = best_periodic(chain, budget)
        if got is None:
            emit(f"sequential at {frac:g} x store-all ({int(budget)} B): "
                 f"no segment count fits, skipped")
        else:
            at["sequential", frac] = row(
                f"sequential(k={got[0]})", frac,
                resolve_policy(f"periodic:{got[0]}", chain))
        for name in ("revolve", "rotor"):
            plan = plan_or_skip(f"{name}:{int(budget)}", frac)
            if plan is not None:
                at[name, frac] = row(name, frac, plan)

    mape = 100 * statistics.fmean(
        abs(r["predicted_s"] - r["measured_s"]) / r["measured_s"]
        for r in rows)
    gain_at = {f: at["sequential", f]["measured_s"]
               / at["rotor", f]["measured_s"] - 1 for f in budgets
               if ("sequential", f) in at and ("rotor", f) in at}
    # the JAX package's headline: rotor planned at each sequential point's
    # predicted peak, with one slot per live value of slack for the DP's
    # ceil-discretization (§5.2)
    slack = 1 + (chain.length + 4) / 500
    predicted = []
    for (name, _), r in at.items():
        if name != "sequential":
            continue
        try:
            plan = resolve_policy(
                f"rotor:{math.ceil(r['predicted_peak_bytes'] * slack)}",
                chain, impl=impl)
        except InfeasiblePlanError:
            continue
        predicted.append(r["predicted_s"] / plan.expected_time - 1)
    measured = list(gain_at.values())
    gain_m = statistics.fmean(measured) if measured else math.nan
    gain_p = statistics.fmean(predicted) if predicted else math.nan
    emit(f"time prediction MAPE {mape:.2f} % over {len(rows)} points "
         f"(paper §5.3: 7.8 %)")
    emit(f"rotor over best sequential at equal memory: measured "
         f"{100 * gain_m:+.2f} % over {len(measured)} budgets ("
         + ", ".join(f"{f:g}: {100 * g:+.2f} %" for f, g in gain_at.items())
         + f"), predicted {100 * gain_p:+.2f} % over {len(predicted)} points "
         f"(paper §5.4: mean +17.2 %)")
    out = {"chain": chain, "rows": rows, "mape_percent": mape,
           "gain_measured": gain_m, "gain_predicted": gain_p,
           "gain_measured_at": gain_at}
    if trace:
        out["calibration"] = calibration_report(chain, rows, emit)
        emit(f"time prediction MAPE {mape:.2f} % uncalibrated, "
             f"{out['calibration']['mape_percent']:.2f} % on the chain "
             f"calibrated on the traced steps")
    return out


def run_lm_tradeoff(model: StagedLM, params: Any,
                    batch: Dict[str, torch.Tensor], **kwargs
                    ) -> Dict[str, Any]:
    """:func:`run_tradeoff` on a :class:`StagedLM`'s stages at ``batch``:
    items are the sequence's positions (tokens, audio frames, a VLM's image
    prefix and tokens), and the norm sums a shared block's per-stage
    parts."""
    B, S = sequence_shape(batch)
    return run_tradeoff(model.stage_fns(), model.stage_params(params), batch,
                        items=B * S,
                        combine_grads=model.combine_stage_grads, **kwargs)


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True,
                    help="an LM arch id, or paper-resnet (the paper's "
                         "heterogeneous conv chain)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family LM config (CPU-sized)")
    ap.add_argument("--override", default=None,
                    help="JSON config overrides (paper-resnet: num_blocks, "
                         "base_ch, image)")
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--solver-impl", default=None,
                    choices=("banded", "plain", "cuda", "cuda_fused"),
                    help="DP fill of the revolve and rotor plans "
                         "(default: banded)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ov = {k: tuple(v) if isinstance(v, list) else v
          for k, v in json.loads(args.override or "{}").items()}
    dev = resolve_device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    kw = dict(impl=args.solver_impl,
              emit=lambda s: print(f"[tradeoff] {s}", flush=True))
    if args.arch == paper_resnet.ARCH:
        stages, params, x = paper_resnet.config(
            batch=args.global_batch, seed=args.seed, device=dev, **ov)
        print(f"[tradeoff] {args.arch} {len(stages) - 1} blocks, input "
              f"{tuple(x.shape)} on {where}", flush=True)
        return run_tradeoff(stages, params, x, items=x.shape[0],
                            budgets=paper_resnet.BUDGETS, **kw)
    cfg = (smoke_config(args.arch, **ov) if args.smoke
           else get_config(args.arch, **ov))
    model = StagedLM(cfg)
    params = model.init(args.seed, dev)
    batch = SyntheticLMData(cfg, args.global_batch, args.seq_len,
                            seed=args.seed).device_batch(0, dev)
    print(f"[tradeoff] {cfg.name} {cfg.num_layers} layers, batch "
          f"{args.global_batch} x {args.seq_len} on {where}", flush=True)
    return run_lm_tradeoff(model, params, batch, **kw)


if __name__ == "__main__":
    main()
