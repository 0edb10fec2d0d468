"""Dry-run of the production cells: does each (arch × shape) cell fit one
device of the production mesh under the planned schedule, and what bounds
its step?  The port of ``repro.launch.dryrun``.

Each cell brings up a ``fake`` process group of the mesh's size (its
collectives move nothing), builds rank 0's step (``launch.steps
.build_cell``) and runs it once under ``FakeTensorMode`` on CPU fake
tensors: nothing is allocated and no card is needed.  On tensors that are
not CUDA the port's kernel ops take their plain versions, as on every CPU
path.  The step is read as it runs (``launch.roofline.trace_step``: FLOPs,
bytes, collective bytes, the tracked memory peak) and priced beside the
analytic terms (``launch.analytic``) on :data:`.mesh.H100_SXM`.

The record (``<arch>__<shape>__<mesh><tag>.json`` in ``--out``) holds the
reference's keys — ``arch``, ``shape``, ``mesh``, ``n_devices``,
``analytic`` (with ``dominant``), ``policy``, ``overrides``, ``memory``,
``model_memory``, ``roofline`` — with ``trace_s`` (the whole cell's
seconds) in place of ``lower_s``/``compile_s``, and ``fits``: the tracked
peak, and for a train cell the plan's activation peak plus the ZeRO-3
states (``p_bytes · 6 / n``), each within ``hbm_bytes``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
      --shape train_4k [--multi-pod] [--policy rotor:auto] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

``REPRO_DRYRUN_DEVICES`` sets the world size (default 256, 512 with
``--multi-pod``); it must equal the production mesh's size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

DEFAULT_OUT = "build/dryrun"


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``fake`` default process group of ``world_size`` ranks, this
    process rank 0, torn down after the block."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy: Optional[str], out_dir: str,
             overrides: Optional[dict] = None, tag: str = "") -> dict:
    """Trace one cell on the production mesh, write its record to
    ``out_dir`` and return it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..configs import get_config
    from ..configs.shapes import SHAPES, applicable
    from ..core.schedule import Schedule, simulate
    from ..models.flops import model_flops_per_step
    from ..models.lm import StagedLM
    from ..obs import metrics as obs_metrics
    from ..tree import tree_bytes
    from . import mesh as mesh_mod
    from .analytic import cell_terms
    from .roofline import analyze, trace_step
    from .steps import build_cell

    if not applicable(arch, shape_name):
        raise ValueError(f"{arch} × {shape_name} is not an assigned cell")
    hw = mesh_mod.H100_SXM
    n = int(os.environ.get("REPRO_DRYRUN_DEVICES",
                           512 if multi_pod else 256))
    sizes = mesh_mod.production_shape(multi_pod)
    if math.prod(sizes.values()) != n:
        raise ValueError(f"REPRO_DRYRUN_DEVICES={n} is not the production "
                         f"mesh's {sizes}")
    t0 = time.perf_counter()
    cfg = get_config(arch, **{k: tuple(v) if isinstance(v, list) else v
                              for k, v in (overrides or {}).items()})
    shape = SHAPES[shape_name]
    model = StagedLM(cfg)
    with fake_group(n):
        mesh = mesh_mod.make_production_mesh(multi_pod)
        with FakeTensorMode():
            step, args, _, extra = build_cell(cfg, shape, mesh,
                                              policy=policy, hw=hw)
            trace = trace_step(step, args)
        del step, args
        mf = model_flops_per_step(
            cfg, shape.global_batch,
            1 if shape.kind == "decode" else shape.seq_len,
            train=shape.kind == "train")
        roof = analyze(trace, mesh, n, mf, hw)
        plan, chain = extra.get("plan"), extra.get("chain")
        analytic = cell_terms(cfg, shape, mesh, model, chain,
                              plan.schedule if plan is not None else None,
                              hw)
    trace_s = time.perf_counter() - t0

    model_mem = None
    if chain is not None:
        sched = (plan.schedule if plan is not None
                 else Schedule.store_all(chain.length))
        act_peak = simulate(chain, sched).peak_mem
        states = tree_bytes(model.init(device="meta")) * 6 / n
        model_mem = {"activation_peak_bytes": float(act_peak),
                     "param_opt_grad_bytes": float(states),
                     "total_bytes": float(act_peak + states)}
    fits = trace.peak_bytes <= hw.hbm_bytes and (
        model_mem is None or model_mem["total_bytes"] <= hw.hbm_bytes)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
        "n_devices": n,
        "hardware": hw.name,
        "analytic": analytic,
        "policy": policy or cfg.remat_policy,
        "overrides": overrides or {},
        "trace_s": trace_s,
        "memory": {"peak_bytes": trace.peak_bytes,
                   "hbm_bytes": hw.hbm_bytes,
                   "kernel_bytes": trace.kernel_bytes,
                   "model_peak": model_mem},
        "model_memory": model_mem,
        "fits": bool(fits),
        "roofline": roof.to_json(),
        "plan": plan.stats() if plan is not None else None,
        "metrics": obs_metrics.snapshot(),
    }
    if extra.get("tree") is not None:
        from ..core.rematerialize import count_checkpoint_scopes
        rec["rotor"] = {"ck_scopes": count_checkpoint_scopes(extra["tree"])}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{rec['mesh']}"
                                 f"{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']}: tracked peak "
          f"{trace.peak_bytes / 2**30:.2f} GiB/dev"
          + (f", plan {model_mem['total_bytes'] / 2**30:.2f} GiB/dev"
             if model_mem else "")
          + f" ({'FITS' if fits else 'OVER'} {hw.hbm_bytes / 2**30:.2f} "
          f"GiB) analytic dominant={analytic['dominant']} "
          f"terms(c/m/x)=({analytic['compute_s']:.4f}/"
          f"{analytic['memory_s']:.4f}/{analytic['collective_s']:.4f})s "
          f"traced dominant={roof.dominant} "
          f"terms(c/m/x)=({roof.compute_s:.4f}/{roof.memory_s:.4f}/"
          f"{roof.collective_s:.4f})s trace={trace_s:.1f}s", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--policy", default="rotor:auto",
                    help="remat policy for train cells (rotor:auto = the "
                         "paper's optimal persistent schedule under the "
                         "per-device activation budget; none|full|periodic:K)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--override", default=None,
                    help="JSON dict of ModelConfig overrides")
    ap.add_argument("--tag", default="", help="suffix for the output file")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    overrides = json.loads(args.override) if args.override else None
    from ..configs import ARCHS
    from ..configs.shapes import cells

    todo = cells(ARCHS) if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape in todo:
        try:
            run_cell(arch, shape, args.multi_pod, args.policy, args.out,
                     overrides, args.tag)
        except Exception:  # noqa: BLE001 — report the cell, go on
            failures += 1
            print(f"[dryrun] FAILED {arch} × {shape}", flush=True)
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
