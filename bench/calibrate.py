"""The readings that set a cell's limits, and its frozen budget, at the
cell's own size on the card: ``python3 bench/calibrate.py --workload
<cell> --seeds 1,2,... [--control-seeds ...] [--fault-seeds ...]
[--budget card]``; and ``python3 bench/calibrate.py --workload <cell>
--judge <log>``, which holds the rows of such a log to the limits in the
cell's file now.

It builds the cell's step once (the chain measured and planned on the
first seed), then for each seed gives it that seed's weights and a fresh
optimizer, runs the first three steps through the window's call and feed,
frees the program's state, and compares the steps with the float32
reference on that seed: one line ``[calibrate] {json}`` per reading, with
``correct``, the verdict of the cell file's limits on it.
``--control-seeds`` also read the control (the reference in fp8 put in
the program's place) and ``--fault-seeds`` the program with half of each
batch left out (the loss the mean over the rest).  A step that leaves the
state unchanged reads 1 on ``change_gap`` by its definition and needs no
run.  The benchmark's own runs run none of this.  ``--budget card`` plans
at the program's own ``rotor:auto`` budget on the card and prints it with
the weights' bytes and the chain's two ends (how a ``rotor_auto`` cell's
budget is frozen)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    del sys.path[0]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def half_batch(batch):
    """Half of the batch's rows: the program's loss is then the mean over
    the rest."""
    n = next(iter(batch.values())).shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def verdict(cell, numbers) -> bool:
    """Whether ``numbers`` pass the limits of the cell's file."""
    from bench import correct

    return correct.passed(correct.checks(numbers, cell.spec["limits"]))


def calibrate(cell, every, control, faults, device, budget=None,
              impl="cuda", emit_line=print):
    """The readings of ``cell`` on the seeds ``every`` (``control`` and
    ``faults`` among them also read the control and the half-batch
    fault), each passed to ``emit_line`` as one line; returns the rows."""
    import torch

    from bench import correct, harness
    from bench.reference.common import diff_norms

    run = harness.Training(cell, every[0], device, impl=impl, budget=budget)
    emit_line(f"[calibrate] {cell.name}: budget {run.budget!r} B, timings "
              f"{json.dumps(run.timings)}, card {harness.card_line(device)}")
    rows = []

    def emit(kind, seed, numbers, extra=None):
        row = {"cell": cell.name, "kind": kind, "seed": seed,
               "correct": verdict(cell, numbers),
               **{k: v for k, v in numbers.items()}, **(extra or {})}
        rows.append(row)
        emit_line(f"[calibrate] {json.dumps(row)}")

    def program_steps(seed, fault=None):
        run.reset(seed)
        run.feed_fault = fault
        try:
            out = run.first_steps()
        finally:
            run.feed_fault = None
            run.drop_state()
        return out

    for seed in every:
        t = time.perf_counter()
        prog = program_steps(seed)
        t_prog = time.perf_counter() - t
        t = time.perf_counter()
        ref = harness.reference(cell, seed, device,
                                against=prog.pop("first_grads"),
                                keep_first=True)
        t_ref = time.perf_counter() - t
        emit("program", seed, correct.readings(prog, ref),
             {"program_s": t_prog, "reference_s": t_ref,
              "losses": prog["losses"], "ref_losses": ref["losses"]})
        del prog
        if seed in control:
            ctl = harness.reference(cell, seed, device, precision="fp8",
                                    against=ref["first_grads"])
            emit("control_fp8", seed, correct.readings(ctl, ref),
                 {"losses": ctl["losses"]})
        if seed in faults:
            bad = program_steps(seed, half_batch)
            bad["grad_diff_norms"] = diff_norms(bad.pop("first_grads"),
                                                ref["first_grads"], device)
            emit("fault_half_batch", seed, correct.readings(bad, ref),
                 {"losses": bad["losses"]})
        del ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def judge(cell, path) -> int:
    """Each ``[calibrate]`` row of the log at ``path`` for ``cell``, held
    to the limits of the cell's file now: one line a row, then the largest
    reading of each number by kind.  Exits 1 if a program row fails or a
    control or fault row passes."""
    from bench import correct

    rows = []
    for line in Path(path).read_text().splitlines():
        if line.startswith("[calibrate] {"):
            row = json.loads(line[len("[calibrate] "):])
            if row["cell"] == cell.name:
                rows.append(row)
    wrong = 0
    for row in rows:
        ok = verdict(cell, row)
        wrong += ok != (row["kind"] == "program")
        print(f"{row['kind']} seed {row['seed']}: correct {ok}; " + ", ".join(
            f"{k} {row[k]:.6e}" for k in correct.NUMBERS))
    for kind in sorted({r["kind"] for r in rows}):
        of = [r for r in rows if r["kind"] == kind]
        print(f"{kind}, {len(of)} seeds: " + ", ".join(
            f"{k} {min(r[k] for r in of):.6e}..{max(r[k] for r in of):.6e}"
            for k in correct.NUMBERS))
    return 1 if wrong else 0


def main(argv=None) -> int:
    from bench import registry

    ap = argparse.ArgumentParser(prog="bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--budget", default=None)
    ap.add_argument("--judge", default=None)
    args = ap.parse_args(argv)
    cell = registry.cell(args.workload)
    if args.judge:
        return judge(cell, args.judge)

    import torch

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    calibrate(cell, seeds(args.seeds), seeds(args.control_seeds),
              seeds(args.fault_seeds), torch.device("cuda", 0),
              budget=args.budget,
              emit_line=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
