"""The paper's trade-off (Figs 3–13) and its cost-model check (§5.3) on one
device: ``python -m repro_torch.launch.tradeoff --arch <id> [...]``.

For one :class:`StagedLM`, batch and device, the chain is measured once
(:func:`~repro_torch.launch.steps.measure_chain`).  Then, at budgets of
``0.45``, ``0.7`` and ``1.0`` times the measured store-all peak, four
strategies are planned on that chain and run through
``MemoryPlan.bind(...).value_and_grad``:

- store-all (autograd's default; once, at its own peak);
- the best *sequential* (``checkpoint_sequential``) segment count that fits
  (``core.baselines.best_periodic``);
- ``revolve:B`` and ``rotor:B`` on the chosen DP fill.

Each point is timed with CUDA events (the host clock off CUDA): one warm-up
call, then the median of ``repeats``; its activation peak is the
allocator's peak less the memory before the call and less the parameter
gradients it returns (on CUDA only).  Each row prints the predicted time and
peak (the simulator on the measured chain) beside the measured ones and the
tokens per second; an infeasible point is printed as skipped.  Two summary
lines follow: the mean absolute percentage error of the predicted against
the measured times (paper §5.3: 7.8 %), and rotor's gain over the best
sequential point at equal memory, from measured times at each budget and,
as the JAX package's benchmark computes it, from predicted times with rotor
planned at each sequential point's own predicted peak (paper §5.4: mean
+17.2 %).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..configs import get_config, smoke_config
from ..core.baselines import best_periodic
from ..core.chain import Chain
from ..core.solver import solve_min_memory
from ..data.pipeline import SyntheticLMData
from ..device import resolve_device
from ..models.lm import StagedLM
from ..optim.adamw import global_norm
from ..plan import InfeasiblePlanError, MemoryPlan, resolve_policy
from ..tree import tensors_of, tree_bytes
from .steps import measure_chain

BUDGETS = (0.45, 0.7, 1.0)


def time_point(plan: MemoryPlan, stages: Sequence[Callable],
               params: Sequence[Any], x: Any, repeats: int = 3) -> dict:
    """``plan.bind(stages).value_and_grad(params, x)`` timed after one
    warm-up call: ``{"seconds" (median of ``repeats``), "peak" (activation bytes, the largest; None off CUDA),
    "loss", "grads"}`` (the last two of the last call, read outside the
    timed region; ``grads`` per stage, as ``value_and_grad`` returns
    them)."""
    bound = plan.bind(stages)
    dev = tensors_of([list(params), x])[0].device
    cuda = dev.type == "cuda"
    bound.value_and_grad(params, x)
    times, peaks, out, grads = [], [], None, None
    for _ in range(repeats):
        out = grads = None       # the previous call's results are freed
        if cuda:
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out, grads, _ = bound.value_and_grad(params, x)
        if cuda:
            end.record()
            peaks.append(torch.cuda.max_memory_allocated(dev) - before
                         - tree_bytes(grads))
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            times.append(time.perf_counter() - t0)
    return {"seconds": statistics.median(times),
            "peak": max(peaks) if cuda else None, "loss": float(out),
            "grads": grads}


def run_tradeoff(model: StagedLM, params: Any, batch: Dict[str, torch.Tensor],
                 impl: Optional[str] = None, chain: Optional[Chain] = None,
                 repeats: int = 3,
                 emit: Callable[[str], None] = print) -> Dict[str, Any]:
    """Plan and run the four strategies at :data:`BUDGETS` × the store-all
    peak of ``chain`` (measured here when not given); returns the chain,
    the rows, the MAPE and both gains (``nan`` where no point allows
    one)."""
    if chain is None:
        chain = measure_chain(model, params, batch, repeats=repeats)
    stages, sp = model.stage_fns(), model.stage_params(params)
    tokens = batch["tokens"].numel()
    peak = chain.store_all_peak()
    rows: List[dict] = []

    def row(strategy: str, frac: float, plan: MemoryPlan) -> dict:
        got = time_point(plan, stages, sp, batch, repeats)
        # a shared block's per-stage parts are summed before the norm
        gnorm = float(global_norm(tensors_of(
            model.combine_stage_grads(got.pop("grads")))))
        seconds, measured_peak = got["seconds"], got["peak"]
        r = dict(strategy=strategy, budget_frac=frac,
                 budget_bytes=plan.budget_bytes,
                 predicted_s=plan.expected_time,
                 predicted_peak_bytes=plan.peak_device_mem,
                 measured_s=seconds, measured_peak_bytes=measured_peak,
                 tokens_per_s=tokens / seconds, loss=got["loss"],
                 grad_norm=gnorm)
        rows.append(r)
        emit(f"{strategy} at {frac:g} x store-all: predicted "
             f"{r['predicted_s']:.6e} s, peak "
             f"{r['predicted_peak_bytes']:.6e} B; measured "
             f"{seconds:.6e} s, peak {measured_peak} B; "
             f"{r['tokens_per_s']:.1f} tok/s")
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
         f"budgets {list(BUDGETS)} x store-all, fill {impl or 'banded'}")
    row("store-all", 1.0, resolve_policy("none", chain))
    at: Dict[tuple, dict] = {}
    for frac in BUDGETS:
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
    measured = [at["sequential", f]["measured_s"] / at["rotor", f]["measured_s"]
                - 1 for f in BUDGETS
                if ("sequential", f) in at and ("rotor", f) in at]
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
    gain_m = statistics.fmean(measured) if measured else math.nan
    gain_p = statistics.fmean(predicted) if predicted else math.nan
    emit(f"time prediction MAPE {mape:.2f} % over {len(rows)} points "
         f"(paper §5.3: 7.8 %)")
    emit(f"rotor over best sequential at equal memory: measured "
         f"{100 * gain_m:+.2f} % over {len(measured)} budgets, predicted "
         f"{100 * gain_p:+.2f} % over {len(predicted)} points (paper §5.4: "
         f"mean +17.2 %)")
    return {"chain": chain, "rows": rows, "mape_percent": mape,
            "gain_measured": gain_m, "gain_predicted": gain_p}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--override", default=None, help="JSON config overrides")
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
    cfg = (smoke_config(args.arch, **ov) if args.smoke
           else get_config(args.arch, **ov))
    dev = resolve_device(args.device)
    model = StagedLM(cfg)
    params = model.init(args.seed, dev)
    batch = SyntheticLMData(cfg, args.global_batch, args.seq_len,
                            seed=args.seed).device_batch(0, dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else str(dev))
    print(f"[tradeoff] {cfg.name} {cfg.num_layers} layers, batch "
          f"{args.global_batch} x {args.seq_len} on {where}", flush=True)
    return run_tradeoff(model, params, batch, impl=args.solver_impl,
                        emit=lambda s: print(f"[tradeoff] {s}", flush=True))


if __name__ == "__main__":
    main()
