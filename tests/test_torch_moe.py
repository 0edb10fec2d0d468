"""The port's MoE (the single-device path of ``repro.models.mlp.moe_apply``)
and its staged moonshot-v1-16b-a3b against the JAX package, in float32 on
the CPU, with the same weights bridged through numpy and inputs drawn from a
numpy seed:

- ``moe_apply`` alone at capacity factor 16 (no pair dropped) and 0.5
  (pairs dropped, which the test asserts): ``y`` and the aux loss, and the
  gradients with respect to x and every parameter (router, stacked experts,
  shared experts);
- the smoke model (one dense layer, then MoE layers; per-layer remat,
  token-chunked loss): every stage output, the loss with
  the MoE aux summed along the chain, every gradient under store-all and a
  rotor plan, and one AdamW step.

Tolerances, as ``tests/test_torch_model.py`` states them: outputs, aux and
losses rtol 1e-5 (atol 1e-6 for entries near zero), gradients rtol 1e-4 /
atol 1e-5 — float32 sums taken in another order by two frameworks; the AdamW
step's parameters rtol 2e-4 / atol 1e-4 (lr 1e-3)."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config as pget  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.rematerialize import count_checkpoint_scopes  # noqa: E402
from repro_torch.launch.steps import plan_training  # noqa: E402
from repro_torch.models import mlp as pmlp  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.tree import tensors_of, tree_map  # noqa: E402

ARCH = "moonshot-v1-16b-a3b"
# the plain attention on both sides (flash attention is held against the
# JAX package in tests/test_torch_model.py): the JAX programs then need no
# interpreted kernel
OVERRIDES = dict(scan_layer_remat="full", logits_chunk=8)
B, S = 2, 16


def _assert_tree_close(got, want_tree, **tol):
    flat, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    assert len(flat) == len(tensors_of(got))
    got = params_to_numpy(got)
    for path, want in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_allclose(node, np.asarray(want), err_msg=str(path),
                                   **tol)


@pytest.mark.parametrize("capacity_factor,drops", [(16.0, False),
                                                   (0.5, True)])
def test_moe_apply_matches_jax(capacity_factor, drops):
    jcfg = jsmoke(ARCH, moe_capacity_factor=capacity_factor)
    pcfg = psmoke(ARCH, moe_capacity_factor=capacity_factor)
    jp = jmlp.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    pp = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(),
                  jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(0).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    T, E, k = 64, jcfg.num_experts, jcfg.moe_top_k
    cap = pmlp.moe_capacity(pcfg, T)
    # how many (token, choice) pairs overflow their expert's queue
    _, _, idx = pmlp._route(pp, pcfg, torch.from_numpy(x).reshape(T, -1))
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    dropped = int(torch.clamp(counts - cap, min=0).sum())
    assert (dropped > 0) == drops, (cap, counts.tolist())

    rng = np.random.default_rng(1)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gaux = np.float32(rng.standard_normal())

    @jax.jit
    def forward_and_vjp(p, x_):
        out, vjp = jax.vjp(lambda p_, x__: jmlp.moe_apply(p_, jcfg, x__),
                           p, x_)
        return out, vjp((jnp.asarray(gy), jnp.asarray(gaux)))

    (want_y, want_aux), (want_gp, want_gx) = forward_and_vjp(jp,
                                                             jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = pmlp.moe_apply(pp, pcfg, xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)
    leaves = tensors_of(pp)
    got = torch.autograd.grad((y, aux), [xt] + leaves,
                              (torch.from_numpy(gy), torch.tensor(gaux)))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_gx),
                               rtol=1e-4, atol=1e-5)
    it = iter(got[1:])
    _assert_tree_close(tree_map(lambda _: next(it), pp), want_gp, rtol=1e-4,
                       atol=1e-5)


def test_router_is_float32_under_bf16_parameters():
    """The router stays float32 whatever the parameter dtype, as in the JAX
    package, so the bridge never rounds it; the full-width tree has JAX's
    paths, shapes and dtypes."""
    jcfg, pcfg = jget(ARCH, num_layers=2, layer_kinds=("dense", "moe"),
                      n_chunks=2), pget(ARCH, num_layers=2,
                                        layer_kinds=("dense", "moe"),
                                        n_chunks=2)
    want = jax.eval_shape(JLM(jcfg).init, jax.random.PRNGKey(0))
    got = PLM(pcfg).init(device="meta")
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert len(flat) == len(tensors_of(got))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name, path
    moe = got["chunks"][1]["moe"]
    assert moe["router"]["kernel"].dtype == torch.float32
    assert moe["we_gate"]["kernel"].shape == (1, 64, 2048, 1408)
    # the JAX smoke tree's leaves in their own dtypes, values from a seed
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype),
        jax.eval_shape(JLM(jsmoke(ARCH, param_dtype=jnp.bfloat16)).init,
                       jax.random.PRNGKey(1)))
    bridged = params_from_numpy(tree, psmoke(ARCH,
                                             param_dtype=torch.bfloat16),
                                "cpu")
    moe = bridged["chunks"][-1]["moe"]
    assert moe["router"]["kernel"].dtype == torch.float32
    assert moe["we_down"]["kernel"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def setup():
    jcfg = jsmoke(ARCH, **OVERRIDES)
    jparams = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0))
    batch = SyntheticLMData(jcfg, B, S, seed=0).batch_at(0)
    jm, a, outs = JLM(jcfg), batch, []
    for fn, p in zip(jm.stage_fns(), jm.stage_params(jparams)):
        a = fn(p, a)
        outs.append((np.asarray(a["h"]), float(a["aux"]))
                    if isinstance(a, dict) else float(a))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jparams, batch)
    pcfg = psmoke(ARCH, **OVERRIDES)
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                "cpu")
    return jcfg, pcfg, jparams, pparams, batch, outs, float(jloss), jgrads


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_stage_outputs_aux_and_loss_match(setup):
    _, pcfg, _, pparams, batch, outs, jloss, _ = setup
    assert [k for k, _, _ in pcfg.chunks] == ["dense", "moe", "moe"]
    pm = PLM(pcfg)
    a = _port_batch(batch)
    with torch.no_grad():
        for i, (fn, p, want) in enumerate(zip(pm.stage_fns(),
                                              pm.stage_params(pparams), outs)):
            a = fn(p, a)
            if isinstance(a, dict):
                np.testing.assert_allclose(a["h"].numpy(), want[0],
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=f"stage {i}")
                np.testing.assert_allclose(a["aux"].item(), want[1],
                                           rtol=1e-5, err_msg=f"stage {i}")
    assert outs[-2][1] > 0          # the aux loss reaches the head
    np.testing.assert_allclose(a.item(), jloss, rtol=1e-5)


@pytest.mark.parametrize("policy", ["none", "rotor:x0.8"])
def test_gradients_match(setup, policy):
    _, pcfg, _, pparams, batch, _, jloss, jgrads = setup
    pm = PLM(pcfg)
    tree = None
    if policy != "none":
        plan, _ = plan_training(
            pm, input_specs(pcfg, ShapeSpec("t", "train", S, B)), policy,
            peak_flops=1e12)
        assert count_checkpoint_scopes(plan.tree) >= 1
        tree = plan.tree
    loss = pm.loss_fn(pparams, _port_batch(batch), tree=tree)
    it = iter(torch.autograd.grad(loss, tensors_of(pparams)))
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    _assert_tree_close(tree_map(lambda _: next(it), pparams), jgrads,
                       rtol=1e-4, atol=1e-5)


def test_train_step_matches_jax(setup):
    """One AdamW step of ``make_train_step``: loss rtol 1e-5, gradient norm
    rtol 1e-4, updated parameters rtol 2e-4 / atol 1e-4 (lr 1e-3)."""
    from repro.launch.steps import make_train_step as jmake
    from repro.optim.adamw import AdamWConfig as JOpt
    from repro.optim.adamw import adamw_init as jinit
    from repro_torch.launch.steps import make_train_step as pmake
    from repro_torch.optim.adamw import AdamWConfig as POpt
    from repro_torch.optim.adamw import adamw_init as pinit

    jcfg, pcfg, jparams, _, batch, *_ = setup
    opt = dict(lr=1e-3, weight_decay=0.0)
    jstep = jax.jit(jmake(JLM(jcfg), JOpt(**opt), None))
    jnew, _, jmetrics = jstep(jparams, jinit(jparams), batch,
                              jnp.zeros((), jnp.int32))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg, "cpu")
    metrics = pmake(PLM(pcfg), POpt(**opt), None)(
        pparams, pinit(tensors_of(pparams)), _port_batch(batch), 0)
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    _assert_tree_close(pparams, jnew, rtol=2e-4, atol=1e-4)
