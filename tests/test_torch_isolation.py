"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports ``jax`` or anything of the JAX package ``repro`` — checked by
importing everything with both blocked, and by an AST scan — and its entry
points run on CUDA unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_imports_with_jax_and_repro_blocked():
    code = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(json.dumps(names))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.kernels.rmsnorm.kernel" in names
    assert "repro_torch.launch.train" in names
    for name in ("compression", "fault_tolerance", "local", "sharding",
                 "tensor_parallel"):
        assert f"repro_torch.distributed.{name}" in names


def test_scan_covers_the_multi_device_modules():
    scanned = {str(p.relative_to(PORT)) for p in FILES if PORT in p.parents}
    for name in ("compression", "fault_tolerance", "local", "sharding",
                 "tensor_parallel"):
        assert f"distributed/{name}.py" in scanned
    for name in ("attention", "lm", "mamba2", "mlp"):
        assert f"models/{name}.py" in scanned


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_entry_points_need_cuda_unless_cpu_asked(monkeypatch):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import profile, train
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config("qwen1.5-4b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StagedLM(cfg).init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training(cfg, TrainLoopConfig(steps=1, global_batch=2,
                                          seq_len=8, policy="none"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "1",
                    "--policy", "none"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile.main(["--arch", "mamba2-1.3b", "--policy", "none"])
    with pytest.raises(ValueError, match="runs on CUDA"):
        profile.main(["--arch", "mamba2-1.3b", "--device", "cpu"])
    out = train.main(["--arch", "qwen1.5-4b", "--smoke", "--steps", "1",
                      "--global-batch", "2", "--seq-len", "8",
                      "--policy", "none", "--device", "cpu"])
    assert len(out["losses"]) == 1 and out["steps"][0]["tokens_per_s"] > 0
    json.dumps(out["steps"])  # per-step records are plain data


def test_cuda_fill_raises_without_a_card():
    """``impl="cuda"`` never turns into another fill when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from repro_torch.core.chain import Chain
    from repro_torch.core.dp_kernels import fill_tables

    ch = Chain.make(uf=[1, 1, 1], ub=[1, 1, 1], wa=[1, 1, 1],
                    wabar=[1, 1, 1])
    with pytest.raises((RuntimeError, AssertionError)):
        fill_tables(ch.discretize(8, 8), 8, impl="cuda")
