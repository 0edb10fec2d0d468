"""Rewrite the analytic roofline terms into existing dry-run records (no
trace needed — the analytic model is config-derived): the port of
``repro.launch.backfill_analytic``.

A record's ``mesh`` string (``32x8``, ``2x32x8``) gives the mesh's axes as
the production mesh orders them; a train cell is planned again under its
``policy`` on the analytic chain of one device of that mesh, an ``auto``
budget against ``H100_SXM.hbm_bytes``, as the dry-run planned it.

Usage: PYTHONPATH=src python -m repro_torch.launch.backfill_analytic [DIR]
"""

from __future__ import annotations

import glob
import json
import math
import sys
from types import SimpleNamespace

from ..distributed.sharding import DATA, MODEL, POD


def mesh_stub(mesh_str: str):
    """A mesh of the record's axis sizes: ``shape`` maps names to sizes."""
    sizes = [int(n) for n in mesh_str.split("x")]
    names = (POD, DATA, MODEL)[-len(sizes):]
    shape = dict(zip(names, sizes))
    return SimpleNamespace(shape=shape, size=math.prod(sizes))


def backfill(path: str) -> dict:
    """Recompute ``analytic`` (and, for a train cell, ``model_memory``'s
    activation peak) of the record at ``path`` and write it back."""
    from ..configs import get_config
    from ..configs.shapes import SHAPES
    from ..core.schedule import Schedule, simulate
    from ..models.lm import StagedLM
    from .analytic import cell_terms
    from .mesh import H100_SXM
    from .steps import plan_cell

    hw = H100_SXM
    with open(path) as f:
        rec = json.load(f)
    ov = {k: tuple(v) if isinstance(v, list) else v
          for k, v in (rec.get("overrides") or {}).items()}
    cfg = get_config(rec["arch"], **ov)
    shape = SHAPES[rec["shape"]]
    mesh = mesh_stub(rec["mesh"])
    model = StagedLM(cfg)
    chain = schedule = None
    if shape.kind == "train":
        plan, chain = plan_cell(model, shape, mesh,
                                rec.get("policy") or "none", hw)
        schedule = plan.schedule if plan is not None else None
        peak = simulate(chain, schedule or Schedule.store_all(chain.length)
                        ).peak_mem
        mm = rec.get("model_memory")
        if mm is not None:
            mm["activation_peak_bytes"] = float(peak)
            mm["total_bytes"] = float(peak + mm["param_opt_grad_bytes"])
    rec["analytic"] = cell_terms(cfg, shape, mesh, model, chain, schedule,
                                 hw)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from .dryrun import DEFAULT_OUT

    d = argv[0] if argv else DEFAULT_OUT
    n = failed = 0
    for path in sorted(glob.glob(f"{d}/*.json")):
        try:
            backfill(path)
            n += 1
        except (KeyError, ValueError, OSError) as e:
            failed += 1
            print(f"[backfill] {path}: {type(e).__name__}: {e}")
    print(f"[backfill] updated {n} records")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
