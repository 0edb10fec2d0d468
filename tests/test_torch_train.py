"""The port's planning and training loop against the JAX package on the
smoke Qwen: the profiled chain (``wa``/``uf``/``ub``; ``wabar`` differs by
design — PyTorch's saved tensors are not XLA's residuals), the schedule chosen
for the JAX chain, the forward counts under the nested checkpoints, and a
3-step loss trajectory from the same bridged weights and data (rtol 1e-4)."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.shapes import ShapeSpec as JShape  # noqa: E402
from repro.configs.shapes import input_specs as jinput_specs  # noqa: E402
from repro.distributed.sharding import DEFAULT_RULES, axis_rules  # noqa: E402
from repro.launch.mesh import PEAK_FLOPS_BF16  # noqa: E402
from repro.launch.steps import plan_training as jplan_training  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro.runtime.train_loop import TrainLoopConfig as JLoop  # noqa: E402
from repro.runtime.train_loop import run_training as jrun  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.launch.steps import plan_chain, plan_training  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training  # noqa: E402

B, S = 2, 16
CFG = dict(num_layers=4, layer_kinds=("dense",) * 4, n_chunks=4)


@pytest.fixture(scope="module")
def jax_plan():
    cfg = jsmoke("qwen1.5-4b", **CFG)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with axis_rules(mesh, DEFAULT_RULES):
        specs = jinput_specs(cfg, JShape("train", "train", S, B))
        return jplan_training(JLM(cfg), specs, mesh, DEFAULT_RULES,
                              "rotor:x0.8")


def test_plan_chain_matches_jax(jax_plan):
    _, jchain = jax_plan
    pm = PLM(psmoke("qwen1.5-4b", **CFG))
    chain = plan_chain(pm, input_specs(pm.cfg, ShapeSpec("t", "train", S, B)),
                       PEAK_FLOPS_BF16)
    np.testing.assert_array_equal(chain.wa, jchain.wa)
    np.testing.assert_array_equal(chain.uf, jchain.uf)
    np.testing.assert_array_equal(chain.ub, jchain.ub)


def test_plan_training_on_jax_chain_picks_same_schedule(jax_plan):
    jplan, jchain = jax_plan
    pm = PLM(psmoke("qwen1.5-4b", **CFG))
    chain = PChain.make(uf=jchain.uf, ub=jchain.ub, wa=jchain.wa,
                        wabar=jchain.wabar, wdelta=jchain.wdelta,
                        of=jchain.of, ob=jchain.ob)
    for impl in ("banded", "plain"):
        plan, _ = plan_training(
            pm, input_specs(pm.cfg, ShapeSpec("t", "train", S, B)),
            "rotor:x0.8", impl=impl, chain=chain)
        assert plan.schedule.ops == jplan.schedule.ops
        assert plan.expected_time == jplan.expected_time


def test_stage_forwards_within_schedule_counts():
    """Under the nested checkpoints each stage's forward runs at most as
    often as the plan's schedule has forward ops for it."""
    cfg = psmoke("qwen1.5-4b", num_layers=6, layer_kinds=("dense",) * 6,
                 n_chunks=6)
    pm = PLM(cfg)
    plan, _ = plan_training(pm, input_specs(cfg, ShapeSpec("t", "train", S, B)),
                            "rotor:x0.5", peak_flops=1e12)
    want = plan.schedule.forward_counts()
    assert max(want.values()) > 1      # the plan recomputes something
    calls = {}
    fns = pm.stage_fns()

    def counted(l, fn):
        def run(p, a):
            calls[l] = calls.get(l, 0) + 1
            return fn(p, a)
        return run

    pm.stage_fns = lambda: [counted(l, fn) for l, fn in enumerate(fns, 1)]
    params = pm.init(seed=0, device="cpu")
    batch = SyntheticLMData(cfg, B, S).device_batch(0, "cpu")
    pm.loss_fn(params, batch, tree=plan.tree).backward()
    assert calls.keys() == want.keys()
    for l, n in calls.items():
        assert n <= want[l], (l, n, want[l])
    # recorded on this tree: the recomputed stages run exactly as planned
    assert calls == want


def test_three_step_losses_match_jax():
    jcfg, pcfg = jsmoke("qwen1.5-4b"), psmoke("qwen1.5-4b")
    jparams = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0))
    want = jrun(jcfg, JLoop(steps=3, global_batch=B, seq_len=S, lr=1e-3,
                            policy="rotor:x0.8", solver_impl="banded",
                            log_every=100),
                log_fn=lambda *_: None)["losses"]
    got = run_training(
        pcfg, TrainLoopConfig(steps=3, global_batch=B, seq_len=S, lr=1e-3,
                              policy="rotor:x0.8", solver_impl="plain",
                              peak_flops=PEAK_FLOPS_BF16, log_every=100),
        device="cpu",
        params=params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                 torch.device("cpu")),
        log_fn=lambda *_: None)["losses"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
