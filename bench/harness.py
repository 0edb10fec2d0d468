"""One run of one cell: set-up, the measured window, the traced steps, and
the comparison that decides ``correct``.

Set-up builds the training step as ``repro_torch.runtime.train_loop.
run_training`` builds it on CUDA, without calling it: the benchmark makes
the weights and every batch from ``--seed`` (``bench/reference/<family>``,
``bench/inputs/<modality>``); a rotor cell measures the chain on the first
batch (``launch.steps.measure_chain``) and plans it at the cell's frozen
budget on the CUDA DP (``launch.steps.plan_training``); AdamW's state is
made; then the step (``launch.steps.make_train_step``) runs three times
through the window's own call and feed.  The reference follows those three
steps once the window has closed and the program's state is freed.

The window runs whole steps with no synchronisation between them until
``--seconds`` have passed, and ends with one ``torch.cuda.synchronize()``.
A step's whole peak is the larger of the step's ``grads_peak`` and the
allocator's peak read after it returns; a step fails if its loss is not
finite or, in a rotor cell, its ``fwd_bwd_peak`` exceeds the budget.  With
``--trace 1`` three more steps run under ``torch.profiler``
(:mod:`bench.profiling`), and the per-layer metrics are read from the
window, the plan and the trace.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import subprocess
import sys
import time
import types
from typing import Callable, Dict, Optional

import torch

from bench import correct, registry
from bench import profiling
from bench.flops import train_flops_per_step
from bench.reference.common import (follow_steps, leaves, make_tree,
                                    rebuild)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
FOLLOWED = 3            # steps the reference follows
TIMED_STEPS = 2         # traced on the device alone, then one with host ops
GiB = 2 ** 30
DTYPE_KEYS = ("dtype", "param_dtype")
# keys a configuration file shares with the program's ModelConfig
CHECKED = ("num_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
           "d_ff", "vocab_size", "mlp_kind", "modality", "qkv_bias",
           "rope_theta", "ssm_expand", "ssm_state", "ssm_head_dim",
           "ssm_groups", "ssm_conv", "ssm_chunk")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def program_config(conf: Dict):
    """The port's ModelConfig for ``conf``: its registry's architecture with
    the file's overrides, held to the file's sizes and dtype and to one
    ``layers_per_stage`` per rotor stage."""
    from repro_torch.configs.archs import get_config

    overrides = {k: (getattr(torch, v) if k in DTYPE_KEYS
                     else tuple(v) if isinstance(v, list) else v)
                 for k, v in conf["program_overrides"].items()}
    cfg = get_config(conf["arch"], **overrides)
    for key in CHECKED:
        if key in conf and getattr(cfg, key) != conf[key]:
            raise ValueError(f"{conf['name']}: the program's {key} is "
                             f"{getattr(cfg, key)!r}, the file's {conf[key]!r}")
    dtype = getattr(torch, conf["dtype"])
    if cfg.dtype != dtype or cfg.param_dtype != dtype:
        raise ValueError(f"{conf['name']}: the program runs {cfg.dtype} "
                         f"with {cfg.param_dtype} weights, the file states "
                         f"{dtype}")
    if {n for _, _, n in cfg.chunks} != {conf["layers_per_stage"]}:
        raise ValueError(f"{conf['name']}: the program's stages hold "
                         f"{[n for _, _, n in cfg.chunks]} layers")
    return cfg


def card_budget(chain, params, device) -> float:
    """The program's own ``rotor:auto`` budget on ``device``
    (``launch.steps.activation_budget_bytes``: 0.9 of the card's memory
    less the weights, gradients and AdamW moments), how a ``rotor_auto``
    cell's frozen budget was set; logged with the weights' bytes and the
    measured chain's min-memory and store-all activation peaks."""
    from repro_torch.core.solver import solve_min_memory
    from repro_torch.launch.steps import activation_budget_bytes
    from repro_torch.tree import tree_bytes

    weights = tree_bytes(params)
    budget = activation_budget_bytes(weights, device)
    total = torch.cuda.get_device_properties(device).total_memory
    low, high = solve_min_memory(chain).mem_limit, chain.store_all_peak()
    fits = "fits" if high + 6 * weights <= total else "does not fit"
    log(f"[bench] card {total!r} B, weights {weights!r} B (states "
        f"{6 * weights!r} B), budget {budget!r} B; measured chain: "
        f"min-memory peak {low!r} B, store-all peak {high!r} B; store-all "
        f"with the states {fits} on the card")
    return budget


def kernel_ops():
    """The CPU op of every kernel module (``bench/kernels/*.py``): the
    trace keeps their input shapes."""
    return tuple(registry.module("kernels", p.stem).OP
                 for p in sorted((registry.BENCH / "kernels").glob("*.py"))
                 if p.stem != "__init__")


class Training:
    """The system under test of one cell: the port's training step, its
    weights, optimizer state and plan, and the feed of batches."""

    def __init__(self, cell: registry.Cell, seed: int, device: torch.device,
                 impl: str = "cuda", budget=None,
                 feed_fault: Optional[Callable] = None):
        from repro_torch.data.pipeline import make_batch_specs
        from repro_torch.launch.steps import (make_train_step, measure_chain,
                                              plan_digest, plan_training)
        from repro_torch.models.lm import StagedLM
        from repro_torch.optim.adamw import AdamWConfig, adamw_init

        self.cell, self.seed, self.device = cell, seed, device
        conf, traffic = cell.conf, cell.traffic
        self.B, self.S = traffic["batch"], traffic["seq_len"]
        self.cfg = program_config(conf)
        self.model = StagedLM(self.cfg)
        self.family = registry.module("reference", conf["family"])
        self.inputs = registry.module("inputs", conf["modality"])
        self.feed_fault = feed_fault
        self.load(seed)
        self.timings: Dict[str, float] = {}
        self.plan = self.chain = self.budget = None
        tree = None
        if traffic["policy"] == "rotor":
            t = time.perf_counter()
            chain = measure_chain(self.model, self.params, self.batch(0))
            self.sync()
            self.timings["measure_chain_s"] = time.perf_counter() - t
            self.budget = float(
                card_budget(chain, self.params, device) if budget == "card"
                else cell.spec["budget_bytes"] if budget is None else budget)
            t = time.perf_counter()
            self.plan, self.chain = plan_training(
                self.model, make_batch_specs(self.cfg, self.B, self.S),
                f"rotor:{int(self.budget)}", impl=impl, chain=chain)
            self.timings["plan_s"] = time.perf_counter() - t
            tree = self.plan.tree
        elif traffic["policy"] != "none":
            raise ValueError(f"unknown policy {traffic['policy']!r}")
        self.digest = plan_digest(self.plan)
        self.opt_cfg = AdamWConfig()
        self.opt_state = adamw_init(self.leaves)
        self.step_fn = make_train_step(self.model, self.opt_cfg, tree)

    def load(self, seed: int) -> None:
        """The weights of ``seed``, made anew, and step 0 (the optimizer's
        state is made after the plan, as ``run_training`` makes it)."""
        from repro_torch.tree import tensors_of

        self.seed, self.step = seed, 0
        self.params = make_tree(self.family.weight_spec(self.cell.conf),
                                seed, self.device)
        self.leaves = tensors_of(self.params)

    def reset(self, seed: int) -> None:
        """The weights of ``seed`` and a fresh optimizer, on the same plan
        and step function."""
        from repro_torch.optim.adamw import adamw_init

        self.drop_state()
        self.load(seed)
        self.opt_state = adamw_init(self.leaves)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        return self.inputs.make_batch(self.cell.conf, self.B, self.S,
                                      self.seed, step, self.device)

    def one_step(self):
        """One step through the window's call and feed: ``(loss on the
        device, whole peak, forward+backward peak)`` (peaks ``None`` off
        CUDA)."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        batch = self.batch(self.step)
        if self.feed_fault is not None:
            batch = self.feed_fault(batch)
        m = self.step_fn(self.params, self.opt_state, batch, self.step)
        peak = (max(m["grads_peak"], torch.cuda.max_memory_allocated(
            self.device)) if cuda else None)
        self.step += 1
        return m["loss"], peak, m["fwd_bwd_peak"]

    def first_steps(self) -> Dict:
        """The first :data:`FOLLOWED` steps and what the reference is held
        to: each step's loss, each leaf's first gradient as the optimizer
        got it (its first moment over 1 − β1 after one step, kept on the
        host) and its norm, and each leaf's change over the steps (against
        the weights made anew from the seed)."""
        losses, grads = [], None
        for i in range(FOLLOWED):
            losses.append(self.one_step()[0])
            if i == 0:
                with torch.no_grad():
                    first = [(m / (1.0 - self.opt_cfg.b1)).cpu()
                             for m in self.opt_state["mu"]]
                grads = [float(torch.linalg.vector_norm(g)) for g in first]
        made = make_tree(self.family.weight_spec(self.cell.conf), self.seed,
                         self.device)
        with torch.no_grad():
            change = [float(torch.linalg.vector_norm(p.float() - q.float()))
                      for p, (_, q) in zip(self.leaves, leaves(made))]
        del made
        return {"losses": [float(x) for x in losses], "grad_norms": grads,
                "change_norms": change, "first_grads": first}

    def window(self, seconds: float) -> Dict:
        out = {"losses": [], "peaks": [], "fwd_bwd": []}
        pauses = collector_pauses()
        gc.callbacks.append(pauses)
        try:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                loss, peak, fb = self.one_step()
                out["losses"].append(loss)
                out["peaks"].append(peak)
                out["fwd_bwd"].append(fb)
            self.sync()
            out["seconds"] = time.perf_counter() - t0
        finally:
            gc.callbacks.remove(pauses)
        out["steps"] = len(out["losses"])
        out["gc"] = pauses.seen
        return out

    def drop_state(self) -> None:
        """Drop the weights and the optimizer's state (the plan and the
        step function stay)."""
        self.params = self.leaves = self.opt_state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def free(self) -> None:
        """Drop the program's state (weights, moments, step, tree)."""
        self.step_fn = self.model = None
        self.drop_state()


def collector_pauses():
    """A ``gc.callbacks`` entry that sums, by generation, how many
    collections ran and the seconds they held the host."""
    seen: Dict[int, list] = {}
    began = [0.0]

    def pauses(phase, info):
        if phase == "start":
            began[0] = time.perf_counter()
        else:
            n = seen.setdefault(info["generation"], [0, 0.0])
            n[0] += 1
            n[1] += time.perf_counter() - began[0]

    pauses.seen = seen
    return pauses


def host_line() -> str:
    """The host's processor and core count (the window's host share
    depends on it)."""
    import os
    import platform

    model = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), model)
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} cores"


def reference(cell: registry.Cell, seed: int, device: torch.device,
              precision: str = "float32", **kw) -> Dict:
    """The plain reference's first :data:`FOLLOWED` steps on the weights
    and batches of ``seed`` (``kw`` to :func:`follow_steps`)."""
    conf, traffic = cell.conf, cell.traffic
    family = registry.module("reference", conf["family"])
    inputs = registry.module("inputs", conf["modality"])
    made = make_tree(family.weight_spec(conf), seed, device)
    # the weights as made wait on the host: the device holds the float32
    # copy, its gradients and moments
    tree = rebuild(made, [t.detach().cpu() for _, t in leaves(made)])
    del made
    batches = [inputs.make_batch(conf, traffic["batch"], traffic["seq_len"],
                                 seed, i, device) for i in range(FOLLOWED)]
    return follow_steps(lambda t, b, mm: family.loss(t, b, conf, mm), tree,
                        batches, precision, **kw)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(device: torch.device) -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i",
                              str(device.index or 0)],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(cell: registry.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, **kw) -> Dict:
    """One whole run; returns the result line's object."""
    card = card_line(device) if device.type == "cuda" else "cpu"
    run = Training(cell, seed, device, **kw)
    prog = run.first_steps()
    if run.plan is not None:
        schedule = hashlib.sha256(
            repr(list(run.plan.schedule.ops)).encode()).hexdigest()[:16]
        print(f"[bench] plan digest {run.digest}, schedule {schedule}, "
              f"expected_time "
              f"{run.plan.expected_time!r} s, predicted activation peak "
              f"{run.plan.peak_device_mem!r} B, budget {run.budget!r} B, "
              f"ops {run.plan.op_counts()}", flush=True)
    else:
        print(f"[bench] plan digest {run.digest} (store-all)", flush=True)
    setup_s = time.perf_counter() - t_start
    win = run.window(seconds)
    trace = None
    steps, fwd_bwd = list(win["losses"]), list(win["fwd_bwd"])
    peaks = list(win["peaks"])
    if traced:
        extra = []
        trace = profiling.record(lambda: extra.append(run.one_step()),
                                 TIMED_STEPS, kernel_ops(), run.sync)
        steps += [e[0] for e in extra]
        peaks += [e[1] for e in extra]
        fwd_bwd += [e[2] for e in extra]
    losses = torch.stack([x.float() for x in steps]).cpu()
    failed = int((~torch.isfinite(losses)).sum())
    if run.budget is not None and fwd_bwd[0] is not None:
        failed += sum(1 for fb, ok in zip(fwd_bwd, torch.isfinite(losses))
                      if ok and fb > run.budget)
    peak = max(peaks) if peaks[0] is not None else None
    tokens = run.B * run.S
    e2e = {"train_tokens_per_s": (tokens * win["steps"] / win["seconds"],
                                  "tokens/s"),
           "peak_mem_gib": (None if peak is None else peak / GiB, "GiB"),
           "setup_s": (setup_s, "s")}
    ctx = types.SimpleNamespace(
        conf=cell.conf, cfg=run.cfg, plan=run.plan, budget=run.budget,
        timings=run.timings, window=win, fwd_bwd=fwd_bwd, trace=trace,
        flops_per_step=train_flops_per_step(cell.conf, run.B, run.S),
        log=log)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = registry.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                log(f"[bench] {m['name']}: nothing to read")
    else:
        for m in cell.end_to_end:
            value, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": peak}
    if trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
    log(f"[bench] {cell.name} seed {seed}: {win['steps']} steps in "
        f"{win['seconds']:.6f} s, set-up {setup_s:.6f} s "
        f"({json.dumps(run.timings)}), peak {peak} B, failed {failed}; "
        f"card {card}; host {host_line()}; collections in the window "
        f"(generation: count, s) {win['gc']}; step peaks {peaks}, "
        f"forward+backward {fwd_bwd}")
    run.free()
    t = time.perf_counter()
    ref = reference(cell, seed, device, against=prog.pop("first_grads"))
    numbers = correct.readings(prog, ref)
    table = correct.checks(numbers, cell.spec["limits"])
    log(f"[bench] reference {time.perf_counter() - t:.3f} s; program losses "
        f"{prog['losses']}, reference {ref['losses']}; worst grad leaf "
        f"{numbers['worst_grad_leaf']}, worst change leaf "
        f"{numbers['worst_change_leaf']}, {numbers['leaves_left_out']} "
        f"leaves left out of the change")
    result = {"correct": correct.passed(table),
              "attempted": len(steps), "failed": failed, "metrics": metrics,
              "device": dev}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    result["checks"] = table
    return result


def parse(argv):
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = registry.cell(args.workload)
    except registry.UnknownWorkload as e:
        log(str(e))
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" available")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t_start)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark runs the port alone")
        return 4
    print(json.dumps(result), flush=True)
    for line in correct.summary(result["checks"]):
        log(line)
    return 0
