"""The harness's own rules: what it imports, how it finds cells,
configurations and metrics by name, where a run writes, and how it
refuses."""

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from bench import registry

ROOT = registry.ROOT
FORBIDDEN = {"jax", "jaxlib", "repro"}
CELL = registry.benchmark()["workloads"][0]["name"]


def imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(registry.BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not set(imported(f)) & FORBIDDEN, f
    for f in sorted((registry.BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in set(imported(f)), f


def test_the_run_refuses_jax_modules(monkeypatch):
    from bench import harness

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]


def copy_checkout(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(registry.BENCH, dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def test_new_files_are_found_by_name(tmp_path):
    root = copy_checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "bench/configs/qwen1.5-4b.json").read_text())
    conf["name"] = "qwen1.5-4b-copy"
    (root / "bench/configs/qwen1.5-4b-copy.json").write_text(
        json.dumps(conf))
    (root / "bench/traffic/short.json").write_text(json.dumps(
        {"batch": 1, "seq_len": 512, "policy": "none"}))
    (root / "bench/workloads/qwen1.5-4b-copy.short.json").write_text(
        json.dumps({"name": "qwen1.5-4b-copy.short",
                    "limits": {"loss_gap": 1}}))
    (root / "bench/metrics/steps_seen.py").write_text(textwrap.dedent("""
        def read(run):
            return float(run.window["steps"])
        """))
    bench["configs"].append({"name": "qwen1.5-4b-copy", "source": "s",
                             "file": "bench/configs/qwen1.5-4b-copy.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "qwen1.5-4b-copy.short",
                               "config": "qwen1.5-4b-copy",
                               "traffic": "short", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves":
                               "train_tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.cell("qwen1.5-4b-copy.short", root)
    assert cell.conf["name"] == "qwen1.5-4b-copy"
    assert cell.traffic["seq_len"] == 512
    assert "steps_seen" in [m["name"] for m in cell.per_layer]
    assert "k3_roofline" not in [m["name"] for m in cell.per_layer]
    metric = registry.module("metrics", "steps_seen", root)
    assert metric.read(type("R", (), {"window": {"steps": 3}})) == 3.0
    with pytest.raises(registry.UnknownWorkload):
        registry.cell("qwen1.5-4b.nothing", root)


def run_py(cwd: Path, *args, env=None):
    return subprocess.run(
        [sys.executable, "bench/run.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_unknown_workload_fails():
    out = run_py(ROOT, "--workload", "no.such.cell", "--seed", "1",
                 "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and not out.stdout.strip()
    assert "no workload" in out.stderr


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_py(ROOT, "--workload", CELL, "--seed",
                 str(2 ** 31 + 5), "--seconds", "1", "--trace", "0", env=env)
    assert out.returncode != 0 and not out.stdout.strip()


def test_the_benchmark_alone_does_not_run(tmp_path):
    root = copy_checkout(tmp_path)
    out = run_py(root, "--workload", CELL, "--seed", "3",
                 "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and not out.stdout.strip()


WRITES = textwrap.dedent("""
    import json, os, runpy, sys, time
    from pathlib import Path
    written = []
    def hook(event, args):
        if event == "open" and args[0] is not None and not isinstance(
                args[0], int):
            mode, flags = args[1] or "", args[2] or 0
            if any(c in mode for c in "wax+") or flags & (
                    os.O_WRONLY | os.O_RDWR | os.O_CREAT):
                written.append(os.path.abspath(os.fsdecode(args[0])))
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove",
                       "shutil.rmtree", "os.symlink"):
            written.append(os.path.abspath(os.fsdecode(args[0])))
    sys.addaudithook(hook)
    root = Path(sys.argv[1])
    runpy.run_path(str(root / "bench" / "run.py"), run_name="bench_run")
    caches = {v: os.environ[v] for v in (
        "TORCH_EXTENSIONS_DIR", "TORCHINDUCTOR_CACHE_DIR",
        "TRITON_CACHE_DIR", "CUDA_CACHE_PATH")}
    import torch
    from bench import harness
    from bench.tests.cells import small_cell
    cell = small_cell(sys.argv[2])
    res = harness.run_cell(cell, 2 ** 31 + 77, 0.2, False,
                           torch.device("cpu"), time.perf_counter(),
                           impl="plain", budget=1e12)
    print(json.dumps({"written": written, "caches": caches,
                      "correct": res["correct"]}))
""")


def test_a_run_writes_only_where_it_may(tmp_path):
    root = ROOT
    home, cache, tmp = (tmp_path / n for n in ("home", "cache", "tmp"))
    for d in (home, cache, tmp):
        d.mkdir()
    # a clean environment: this process's torch may have set cache
    # variables of its own
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TORCH", "TRITON", "CUDA_CACHE"))}
    env.update(HOME=str(home), XDG_CACHE_HOME=str(cache), TMPDIR=str(tmp),
               PYTHONPATH=str(root / "src"), PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run([sys.executable, "-c", WRITES, str(root), CELL],
                         env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    allowed = [str(root), str(home), str(cache), str(tmp), os.devnull]
    for path in got["written"]:
        assert any(path == a or path.startswith(a + os.sep)
                   for a in allowed), (path, allowed)
    for var, path in got["caches"].items():
        assert path.startswith(str(root / "build") + os.sep), (var, path)
