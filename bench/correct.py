"""How ``correct`` is decided for a training cell: the program's first
three steps against the plain reference's, on the same weights and
batches.

Four numbers, each against the cell's limit:

- ``loss_gap``: the largest gap, over the three steps, between the
  program's loss and the reference's (nats);
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first gradient as its optimizer got it (clipped; worked out
  from the first moment after one step) and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same for the norm of each leaf's change over the
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (the others move by round-off alone);
- ``grad_diff``: over the leaves, the norm of the difference between the
  program's first gradient and the reference's, over the same
  denominator.  The gaps of norms are second-order in an error that is
  random from element to element, such as the fp8 control's, and may not
  tell it from the program; the difference is first-order.

Beside them, for the record and not compared, each gap over the leaf's
own reference norm (``<number>_own``): the median leaf's norm sets the
denominator of the small leaves (biases, norm scales).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "grad_diff")
MOVED = 1e-3     # a leaf whose reference gradient is under this × median


def _finite(x: float) -> float:
    """``x``, or infinity where it is NaN (a NaN compares as passing)."""
    return x if x == x else float("inf")


def _worst(gaps: Sequence[float], ref: Sequence[float],
           keep: Sequence[int], own: bool = False) -> (float, int):
    """The largest of ``gaps[i]`` over the reference's norm of leaf ``i``
    or of the median kept leaf, whichever is larger (with ``own``, over
    leaf ``i``'s alone), and its leaf."""
    med = 0.0 if own else statistics.median(ref[i] for i in keep)
    worst, at = 0.0, -1
    for i in keep:
        g = _finite(gaps[i] / max(ref[i], med, 1e-30))
        if g > worst:
            worst, at = g, i
    return worst, at


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers (and, for the log, the worst leaves' paths) of the
    program's readings ``prog`` against the reference's ``ref``: each a
    dict of ``losses`` and, per leaf in one order, ``grad_norms`` and
    ``change_norms``; ``ref`` also ``paths``, and one of them the norms of
    the first gradients' differences, ``grad_diff_norms``."""
    if len(prog["grad_norms"]) != len(ref["grad_norms"]):
        raise ValueError("the program and the reference hold different "
                         "numbers of leaves")
    loss_gap = max(_finite(abs(a - b))
                   for a, b in zip(prog["losses"], ref["losses"]))
    every = range(len(ref["grad_norms"]))
    gr = ref["grad_norms"]
    grad_gap, gi = _worst([abs(a - b) for a, b in zip(prog["grad_norms"], gr)],
                          gr, every)
    moved = [i for i in every if gr[i] >= MOVED * statistics.median(gr)]
    cr = ref["change_norms"]
    change_gap, ci = _worst(
        [abs(a - b) for a, b in zip(prog["change_norms"], cr)], cr, moved)
    diffs = prog.get("grad_diff_norms") or ref["grad_diff_norms"]
    grad_diff, di = _worst(diffs, gr, every)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap,
           "change_gap": change_gap, "grad_diff": grad_diff,
           "worst_grad_leaf": ref["paths"][gi],
           "worst_diff_leaf": ref["paths"][di],
           "worst_change_leaf": ref["paths"][ci],
           "leaves_left_out": len(ref["grad_norms"]) - len(moved)}
    # for the record, not compared: each leaf's gaps over its own norm
    for name, gaps, norms, keep in (
            ("grad_gap", [abs(a - b) for a, b in
                          zip(prog["grad_norms"], gr)], gr, every),
            ("change_gap", [abs(a - b) for a, b in
                            zip(prog["change_norms"], cr)], cr, moved),
            ("grad_diff", diffs, gr, every)):
        value, at = _worst(gaps, norms, keep, own=True)
        out[f"{name}_own"] = value
        out[f"{name}_own_leaf"] = ref["paths"][at]
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """``{name: {"value", "limit"}}`` for each compared number."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}


def passed(table: Dict) -> bool:
    return all(v["value"] <= v["limit"] for v in table.values())


def summary(table: Dict) -> List[str]:
    return [f"check {k} {v['value']:.6e} limit {v['limit']:.6e}"
            for k, v in table.items()]
