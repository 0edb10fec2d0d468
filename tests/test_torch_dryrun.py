"""The port's dry-run (``repro_torch.launch.dryrun`` and
``backfill_analytic``), its static-checks gate (``python -m
repro_torch.check``) and the vocab-chunked cross-entropy
(``kernels/xent``).

The dry-run runs a tiny override of qwen1.5-4b in a subprocess (the
``fake`` process group is process-wide) at ``REPRO_DRYRUN_DEVICES=8``, the
production mesh swapped for (4, 2) and for (2, 2, 2), as the JAX package's
own dry-run test swaps its mesh.  The lint's five rules each fire on a
seeded file under ``tmp_path``, as ``tests/test_check_lint.py`` seeds the
reference's.  ``blockwise_xent`` is held against the reference's, the
full-logits oracle and ``token_chunked_xent``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.xent import ops as ref_xent
from repro.kernels.xent import ref as ref_oracle
from repro_torch.check.lint import lint_file, lint_repo
from repro_torch.kernels.xent import ops as xent
from repro_torch.kernels.xent import ref as oracle

ROOT = Path(__file__).resolve().parents[1]
TINY = {"num_layers": 2, "layer_kinds": ["dense"] * 2, "d_model": 32,
        "n_heads": 4, "n_kv_heads": 2, "head_dim": 8, "d_ff": 64,
        "vocab_size": 128, "n_chunks": 2, "attn_block_q": 4096,
        "logits_chunk": 0}
CELLS = ("train_4k", "decode_32k")
MESHES = {"4x2": {"data": 4, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
KEYS = {"arch", "shape", "mesh", "n_devices", "analytic", "policy",
        "overrides", "memory", "model_memory", "roofline", "trace_s", "fits"}
ROOFLINE_KEYS = {"flops", "bytes_accessed", "collective_bytes", "compute_s",
                 "memory_s", "collective_s", "dominant", "model_flops",
                 "useful_ratio", "per_device_peak_bytes",
                 "collective_breakdown"}

DRYRUN = """
import json, sys
import repro_torch.launch.mesh as m
sizes = json.loads(sys.argv[1])
m.production_shape = lambda multi_pod=False: sizes
from repro_torch.launch import dryrun
from repro_torch.launch.backfill_analytic import backfill
out = {}
for shape in sys.argv[4:]:
    rec = dryrun.run_cell("qwen1.5-4b", shape, "pod" in sizes, "rotor:auto",
                          sys.argv[2], overrides=json.loads(sys.argv[3]))
    path = f"{sys.argv[2]}/qwen1.5-4b__{shape}__{rec['mesh']}.json"
    out[shape] = {"rec": rec, "backfilled": backfill(path)}
with dryrun.fake_group(8):
    hm = m.make_host_mesh(2)
    out["host_mesh"] = [list(hm.mesh_dim_names), list(hm.shape)]
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module", params=list(MESHES))
def dryrun_records(request, tmp_path_factory):
    out_dir = tmp_path_factory.mktemp(f"dryrun_{request.param}")
    env = dict(os.environ, REPRO_DRYRUN_DEVICES="8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", DRYRUN, json.dumps(MESHES[request.param]),
         str(out_dir), json.dumps(TINY), *CELLS],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return request.param, json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("cell", CELLS)
def test_dryrun_record(dryrun_records, cell):
    mesh, recs = dryrun_records
    rec = recs[cell]["rec"]
    assert KEYS <= set(rec)
    assert rec["mesh"] == mesh and rec["n_devices"] == 8
    assert rec["shape"] == cell and rec["overrides"] == TINY
    assert rec["analytic"]["dominant"] in ("compute", "memory", "collective")
    roof = rec["roofline"]
    assert ROOFLINE_KEYS <= set(roof)
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert set(roof["collective_breakdown"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute", "ragged-all-to-all", "total"}
    assert roof["flops"] > 0 and roof["bytes_accessed"] > 0
    assert roof["per_device_peak_bytes"] > 0 and rec["trace_s"] > 0
    assert rec["fits"] is True
    if cell == "train_4k":
        mm = rec["model_memory"]
        assert mm["total_bytes"] == pytest.approx(
            mm["activation_peak_bytes"] + mm["param_opt_grad_bytes"])
        # ZeRO-3: the gathers and the gradients' reduce-scatters
        assert roof["collective_breakdown"]["all-gather"] > 0
        assert roof["collective_breakdown"]["reduce-scatter"] > 0
    else:
        assert rec["model_memory"] is None


@pytest.mark.parametrize("cell", CELLS)
def test_backfill_rewrites_the_same_terms(dryrun_records, cell):
    _, recs = dryrun_records
    assert recs[cell]["backfilled"]["analytic"] == recs[cell]["rec"][
        "analytic"]
    if cell == "train_4k":
        assert recs[cell]["backfilled"]["model_memory"] == recs[cell][
            "rec"]["model_memory"]


def test_host_mesh_over_the_group_that_is_up(dryrun_records):
    _, recs = dryrun_records
    assert recs["host_mesh"] == [["data", "model"], [4, 2]]


def test_dryrun_cli_needs_a_cell():
    from repro_torch.launch import dryrun

    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "qwen1.5-4b"])


# -- python -m repro_torch.check --------------------------------------------


def test_check_gate_is_clean_on_the_tree():
    assert lint_repo() == []
    proc = subprocess.run([sys.executable, "-m", "repro_torch.check"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lint: ok" in proc.stdout
    assert "kernel-analysis: not run" in proc.stdout


def _lint(tmp_path, rel, code):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    return [v.rule for v in lint_file(str(path), str(tmp_path))]


@pytest.mark.parametrize("rel,code,rules", [
    ("core/foo.py", "import torch\n", ["torch-import"]),
    ("obs/foo.py", "from ..core import planner\n", ["torch-import"]),
    ("check/foo.py", "from repro_torch.kernels import _build\n",
     ["torch-import"]),
    ("core/foo.py", "def f():\n    import torch\n    return torch\n", []),
    ("core/executor.py", "import torch\n", []),
    ("launch/foo.py", "import torch\n", []),
    ("plan/plan.py", "def f(p):\n    return p.startswith('rotor:')\n",
     ["policy-parse"]),
    ("plan/compat.py", "def f(p):\n    return p.startswith('rotor:')\n", []),
    ("obs/foo.py", "def f(metrics):\n    metrics.counter('BadName')\n",
     ["metric-name"]),
    ("obs/foo.py", "def f(metrics):\n    metrics.counter('train.steps')\n",
     []),
    ("plan/plan.py", "def f():\n    import pickle\n", ["pickle-confinement"]),
    ("store/codec.py", "import pickle\n", []),
    ("kernels/foo.py", "def f():\n    import jax\n", ["port-isolation"]),
    ("launch/foo.py", "from repro.core import solver\n", ["port-isolation"]),
    ("models/foo.py", "import jaxlib.xla_client\n", ["port-isolation"]),
    ("models/foo.py", "from repro_torch.core import solver\n", []),
])
def test_lint_rule_fires_on_a_seeded_file(tmp_path, rel, code, rules):
    assert _lint(tmp_path, rel, code) == rules


# -- the vocab-chunked cross-entropy -----------------------------------------


def _xent_inputs(seed, masked):
    rng = np.random.default_rng(seed)
    B, S, d, V = 2, 6, 16, 96
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) / 4).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = ((rng.random((B, S)) > 0.3).astype(np.float32) if masked
            else None)
    return h, w, labels, mask


def _torch_loss_grads(fn, h, w, labels, mask, **kw):
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = fn(ht, wt, torch.tensor(labels),
              None if mask is None else torch.tensor(mask), **kw)
    dh, dw = torch.autograd.grad(loss, [ht, wt])
    return loss.item(), dh.numpy(), dw.numpy()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_blockwise_xent_against_the_reference(masked, z_loss):
    """V = 96 in blocks of 40 (the last one 16 wide), f32: the loss within
    rtol 1e-5 and dh, dW within rtol 1e-4 / atol 1e-5 of the reference's
    ``blockwise_xent``, of the full-logits oracle and of
    ``token_chunked_xent``."""
    h, w, labels, mask = _xent_inputs(0, masked)
    got = _torch_loss_grads(xent.blockwise_xent, h, w, labels, mask,
                            block=40, z_loss=z_loss)
    jm = None if mask is None else jnp.asarray(mask)
    ref_loss, (ref_dh, ref_dw) = jax.value_and_grad(
        lambda a, b: ref_xent.blockwise_xent(a, b, jnp.asarray(labels), jm,
                                             40, z_loss),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    wants = [(float(ref_loss), np.asarray(ref_dh), np.asarray(ref_dw)),
             _torch_loss_grads(oracle.xent_from_hidden, h, w, labels, mask,
                               z_loss=z_loss),
             _torch_loss_grads(xent.token_chunked_xent, h, w, labels, mask,
                               block=5, z_loss=z_loss)]
    for want in wants:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_oracle_equals_the_reference_oracle(masked):
    h, w, labels, mask = _xent_inputs(1, masked)
    got = oracle.xent_from_hidden(
        torch.tensor(h), torch.tensor(w), torch.tensor(labels),
        None if mask is None else torch.tensor(mask), z_loss=1e-3)
    want = ref_oracle.xent_from_hidden(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), z_loss=1e-3)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_blockwise_xent_bf16_weights_give_bf16_grads():
    h, w, labels, mask = _xent_inputs(2, True)
    ht = torch.tensor(h).bfloat16().requires_grad_()
    wt = torch.tensor(w).bfloat16().requires_grad_()
    loss = xent.blockwise_xent(ht, wt, torch.tensor(labels),
                               torch.tensor(mask), block=40)
    dh, dw = torch.autograd.grad(loss, [ht, wt])
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert dh.dtype == dw.dtype == torch.bfloat16
