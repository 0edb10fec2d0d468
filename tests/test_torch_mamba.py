"""The port's staged Mamba2 (smoke width, the SSD kernel wrapper, per-layer
remat, token-chunked loss) against the JAX ``StagedLM`` with the same
weights, bridged through numpy, in float32 on the CPU: the mixer alone, every
stage output, the loss, every parameter gradient (store-all and through a
rotor plan's nested checkpoints) and one AdamW step; the full-width
``mamba2-1.3b`` parameter tree, dtypes and count; the planner's FLOPs.  The
JAX side runs its Pallas SSD kernel in interpret mode.

Tolerances, as ``tests/test_torch_model.py`` states them: stage outputs and
losses rtol 1e-5 (atol 1e-6 for entries near zero), gradients rtol 1e-4 /
atol 1e-5 — float32 sums taken in another order by two frameworks."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.kernels.ssd import ops as jssd  # noqa: E402
from repro.models import flops as jflops  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config as pget  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.rematerialize import count_checkpoint_scopes  # noqa: E402
from repro_torch.launch.steps import plan_training  # noqa: E402
from repro_torch.models import flops as pflops  # noqa: E402
from repro_torch.models import mamba2 as pm2  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.tree import tensors_of, tree_map  # noqa: E402

ARCH = "mamba2-1.3b"
OVERRIDES = dict(use_ssd_kernel=True, scan_layer_remat="full",
                 logits_chunk=8)
B, S = 2, 16


@pytest.fixture(autouse=True)
def interpret_mode():
    jssd.set_interpret(True)
    yield
    jssd.set_interpret(False)


@pytest.fixture(scope="module")
def setup():
    jcfg = jsmoke(ARCH, **OVERRIDES)
    pcfg = psmoke(ARCH, **OVERRIDES)
    jparams = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                "cpu")
    batch = SyntheticLMData(jcfg, B, S, seed=0).batch_at(0)
    return jcfg, pcfg, jparams, pparams, batch


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got_tree, want_tree, **tol):
    got = params_to_numpy(got_tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    assert len(flat) == len(tensors_of(got_tree))
    for path, want in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_allclose(node, np.asarray(want), err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mixer_matches_jax(setup, use_kernel):
    """One Mamba2 mixer (the first layer's weights) on a ragged sequence
    (20 steps, chunks of 8), forward and input gradient, on the plain scan
    and on the kernel path of both packages."""
    import dataclasses

    jcfg, pcfg, jparams, pparams, _ = setup
    jcfg = dataclasses.replace(jcfg, use_ssd_kernel=use_kernel)
    pcfg = dataclasses.replace(pcfg, use_ssd_kernel=use_kernel)
    jp = jax.tree.map(lambda a: a[0], jparams["chunks"][0]["mixer"])
    pp = tree_map(lambda t: t[0].detach(), pparams["chunks"][0]["mixer"])
    x = np.random.default_rng(0).standard_normal(
        (2, 20, pcfg.d_model)).astype(np.float32)
    want, vjp = jax.vjp(lambda x_: jm2.mamba2_apply(jp, jcfg, x_),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = pm2.mamba2_apply(pp, pcfg, xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    g = np.random.default_rng(1).standard_normal(got.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(gx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-4, atol=1e-5)


def test_stage_outputs_and_loss_match(setup):
    jcfg, pcfg, jparams, pparams, batch = setup
    jm, pm = JLM(jcfg), PLM(pcfg)
    a_j, a_p = batch, _port_batch(batch)
    stages = zip(jm.stage_fns(), jm.stage_params(jparams), pm.stage_fns(),
                 pm.stage_params(pparams))
    with torch.no_grad():
        for i, (jf, jp, pf, pp) in enumerate(stages):
            a_j, a_p = jf(jp, a_j), pf(pp, a_p)
            if isinstance(a_j, dict):
                np.testing.assert_allclose(a_p["h"].numpy(),
                                           np.asarray(a_j["h"]), rtol=1e-5,
                                           atol=1e-6, err_msg=f"stage {i}")
    np.testing.assert_allclose(float(a_p), float(a_j), rtol=1e-5)


def test_gradients_match_store_all_and_rotor(setup):
    jcfg, pcfg, jparams, pparams, batch = setup
    jm, pm = JLM(jcfg), PLM(pcfg)
    jloss, jgrads = jax.value_and_grad(jm.loss_fn)(jparams, batch)
    plan, _ = plan_training(pm, input_specs(pcfg, ShapeSpec("t", "train", S, B)),
                            "rotor:x0.8", peak_flops=1e12)
    assert count_checkpoint_scopes(plan.tree) >= 1
    leaves = tensors_of(pparams)
    for tree in (None, plan.tree):
        loss = pm.loss_fn(pparams, _port_batch(batch), tree=tree)
        grads = iter(torch.autograd.grad(loss, leaves))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        _assert_tree_close(tree_map(lambda _: next(grads), pparams), jgrads,
                           rtol=1e-4, atol=1e-5)


def test_train_step_matches_jax(setup):
    """One AdamW step of ``make_train_step`` at the tolerances of the Qwen
    step test: loss rtol 1e-5, gradient norm rtol 1e-4, updated parameters
    rtol 2e-4 / atol 1e-4 (lr 1e-3)."""
    from repro.launch.steps import make_train_step as jmake
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.adamw import adamw_init as jinit
    from repro_torch.launch.steps import make_train_step as pmake
    from repro_torch.optim.adamw import AdamWConfig as POpt
    from repro_torch.optim.adamw import adamw_init as pinit

    jcfg, pcfg, jparams, _, batch = setup
    opt = dict(lr=1e-3, weight_decay=0.0)
    jstep = jax.jit(jmake(JLM(jcfg), JOpt(**opt), None))
    jnew, _, jmetrics = jstep(jparams, jinit(jparams), batch,
                              jnp.zeros((), jnp.int32))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg, "cpu")
    pstep = pmake(PLM(pcfg), POpt(**opt), None)
    metrics = pstep(pparams, pinit(tensors_of(pparams)), _port_batch(batch), 0)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    _assert_tree_close(pparams, jnew, rtol=2e-4, atol=1e-4)


def test_full_width_tree_dtypes_and_count():
    """The port's full-width ``meta`` init has JAX's tree paths, shapes and
    dtypes (``A_log``, ``D`` and ``dt_bias`` float32 under bf16 parameters,
    so the bridge never rounds them); its weight matrices count
    ``ModelConfig.total_params()`` and all its leaves as many numbers as
    JAX's tree."""
    jcfg, pcfg = jget(ARCH), pget(ARCH)
    want = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    got = PLM(pcfg).init(device="meta")
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert len(flat) == len(tensors_of(got))
    total = matrices = 0
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name, path
        total += node.numel()
        if path[-1].key in ("kernel", "table"):
            matrices += node.numel()
    for chunk in got["chunks"]:
        for name in ("A_log", "D", "dt_bias"):
            assert chunk["mixer"][name].dtype == torch.float32
        assert chunk["mixer"]["in_proj"]["kernel"].dtype == torch.bfloat16
    assert matrices == jcfg.total_params()
    assert total == sum(int(np.prod(leaf.shape)) for _, leaf in flat)
    bridged = params_from_numpy(jax.tree.map(
        np.asarray, jax.jit(JLM(jsmoke(ARCH, param_dtype=jnp.bfloat16)).init)(
            jax.random.PRNGKey(1))), psmoke(ARCH, param_dtype=torch.bfloat16),
        "cpu")
    assert bridged["chunks"][0]["mixer"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("smoke", [True, False])
def test_stage_flops_match_jax(smoke):
    jcfg = jsmoke(ARCH, **OVERRIDES) if smoke else jget(ARCH)
    pcfg = psmoke(ARCH, **OVERRIDES) if smoke else pget(ARCH)
    for b, s in ((2, 16), (4, 2048)):
        assert pflops.stage_flops(pcfg, b, s) == jflops.stage_flops(jcfg, b, s)


def test_train_cli_on_cpu():
    """``python -m repro_torch.launch.train --arch mamba2-1.3b --smoke
    --device cpu`` plans a rotor schedule over the Mamba stages and trains:
    finite, falling losses."""
    from repro_torch.launch import train

    out = train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--steps", "4", "--global-batch", "2", "--seq-len", "20",
                      "--lr", "3e-3", "--policy", "rotor:x0.7",
                      "--peak-flops", "1e12", "--override",
                      '{"use_ssd_kernel": true, "scan_layer_remat": "full"}'])
    assert count_checkpoint_scopes(out["plan"].tree) >= 1
    assert all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
