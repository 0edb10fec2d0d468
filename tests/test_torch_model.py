"""The port's staged Qwen (smoke width, flash attention, per-layer remat,
token-chunked loss) against the JAX ``StagedLM`` with the same weights,
bridged through numpy, in float32 on the CPU: every stage output, the loss,
every parameter gradient (store-all and through a rotor plan's nested
checkpoints), and the token-chunked cross-entropy.

Tolerances: stage outputs and losses rtol 1e-5 (atol 1e-6 for entries near
zero), gradients rtol 1e-4 / atol 1e-5 — float32 sums taken in another
order by two frameworks."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.kernels.flash_attention import ops as jflash  # noqa: E402
from repro.kernels.xent import ops as jxent  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.rematerialize import count_checkpoint_scopes  # noqa: E402
from repro_torch.kernels.xent import ops as pxent  # noqa: E402
from repro_torch.launch.steps import plan_training  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.tree import tensors_of, tree_map  # noqa: E402

OVERRIDES = dict(use_flash_attention=True, scan_layer_remat="full",
                 logits_chunk=8)
B, S = 2, 16


@pytest.fixture(autouse=True)
def interpret_mode():
    jflash.set_interpret(True)
    yield
    jflash.set_interpret(False)


@pytest.fixture(scope="module")
def setup():
    jcfg = jsmoke("qwen1.5-4b", **OVERRIDES)
    pcfg = psmoke("qwen1.5-4b", **OVERRIDES)
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


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(setup, accum):
    """One AdamW step of ``make_train_step`` (microbatched when ``accum`` >
    1): the loss rtol 1e-5, the gradient norm rtol 1e-4, the updated
    parameters at the step-size scale
    (rtol 2e-4 / atol 1e-4, lr 1e-3) as the JAX package's own accumulation
    test compares them — Adam's normalised step is not robust to summation
    order where gradients are float32 noise."""
    from repro.launch.steps import make_train_step as jmake
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.adamw import adamw_init as jinit
    from repro_torch.launch.steps import make_train_step as pmake
    from repro_torch.optim.adamw import AdamWConfig as POpt
    from repro_torch.optim.adamw import adamw_init as pinit

    jcfg, pcfg, jparams, _, batch = setup
    opt = dict(lr=1e-3, weight_decay=0.0)
    jstep = jax.jit(jmake(JLM(jcfg), JOpt(**opt), None, grad_accum=accum))
    jnew, _, jmetrics = jstep(jparams, jinit(jparams), batch,
                              jnp.zeros((), jnp.int32))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg, "cpu")
    pstep = pmake(PLM(pcfg), POpt(**opt), None, grad_accum=accum)
    metrics = pstep(pparams, pinit(tensors_of(pparams)), _port_batch(batch), 0)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    _assert_tree_close(pparams, jnew, rtol=2e-4, atol=1e-4)


def test_token_chunked_xent_matches_jax():
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 13, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 96)) * 0.2).astype(np.float32)
    labels = rng.integers(0, 96, (2, 13)).astype(np.int32)
    mask = (rng.uniform(size=(2, 13)) < 0.8).astype(np.float32)
    want, (gh, gw) = jax.value_and_grad(
        lambda h_, w_: jxent.token_chunked_xent(h_, w_, labels, mask, block=8),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    got = pxent.token_chunked_xent(th, tw, torch.from_numpy(labels),
                                   torch.from_numpy(mask), block=8)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), rtol=1e-4,
                               atol=1e-5)
