"""What decides ``correct``, at a size a CPU test can hold: a sound run of
each cell passes its limits; the control (the reference in fp8 put in the
program's place) fails them, on three seeds; and a run with its timed path
broken underneath (the state left unchanged, half of each batch left out)
comes out not correct."""

import time

import pytest
import torch

from bench import calibrate, correct, harness, registry
from bench.tests.cells import small_cell

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


def run(name, seed, **kw):
    cell = small_cell(name)
    if cell.traffic["policy"] == "rotor":
        kw.update(impl="plain", budget=1e12)
    return harness.run_cell(cell, seed, 0.1, False, torch.device("cpu"),
                            time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = run(name, SEEDS[0])
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name, dtype=registry.cell(name).conf["dtype"])
    for seed in SEEDS:
        ref = harness.reference(cell, seed, torch.device("cpu"),
                                keep_first=True)
        ctl = harness.reference(cell, seed, torch.device("cpu"), "fp8",
                                against=ref["first_grads"])
        table = correct.checks(correct.readings(ctl, ref),
                               cell.spec["limits"])
        assert not correct.passed(table), (seed, table)


def unchanged(cfg, grads, state, params, lr=None):
    """An optimizer step that leaves the state as it was."""
    return {"grad_norm": torch.zeros(()), "param_norm": torch.zeros(())}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    kw = {}
    if fault == "unchanged":
        monkeypatch.setattr("repro_torch.launch.steps.adamw_update",
                            unchanged)
    else:
        kw["feed_fault"] = calibrate.half_batch
    res = run(name, SEEDS[1], **kw)
    assert res["correct"] is False, res["checks"]


def test_small_leaves_are_also_read_against_their_own_norms():
    prog = {"losses": [1.0], "grad_norms": [1.0, 0.01, 1.0],
            "change_norms": [1.0, 1.0, 1.0],
            "grad_diff_norms": [0.0, 0.001, 0.0]}
    ref = {"losses": [1.0], "grad_norms": [1.0, 0.02, 1.0],
           "change_norms": [1.0, 1.0, 1.0], "paths": ["a", "b", "c"]}
    n = correct.readings(prog, ref)
    assert n["grad_gap"] == pytest.approx(0.01)       # over the median leaf
    assert n["grad_gap_own"] == pytest.approx(0.5)    # over its own
    assert n["grad_gap_own_leaf"] == "b"
    assert n["grad_diff_own"] == pytest.approx(0.05)


def test_a_calibration_log_is_judged_by_the_cell_files_limits(tmp_path):
    import json

    cell = registry.cell(CELLS[0])
    limits = cell.spec["limits"]
    under = {k: v / 2 for k, v in limits.items()}
    over = dict(under, loss_gap=2 * limits["loss_gap"])
    log = tmp_path / "calibrate.log"

    def write(*rows):
        log.write_text("\n".join(
            "[calibrate] " + json.dumps({"cell": cell.name, "seed": 1,
                                         "kind": kind, **numbers})
            for kind, numbers in rows) + "\n")

    write(("program", under), ("control_fp8", over))
    assert calibrate.judge(cell, log) == 0
    write(("program", under), ("fault_half_batch", under))
    assert calibrate.judge(cell, log) == 1
    write(("program", over))
    assert calibrate.judge(cell, log) == 1
