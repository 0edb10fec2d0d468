"""The port's MLA (``models/attention.py::mla_apply``, the DeepSeek-V2
multi-head latent attention of ``repro.models.attention``) and its staged
deepseek-v2-lite-16b against the JAX package, in float32 on the CPU, with
the same weights bridged through numpy and inputs from a numpy seed:

- ``mla_apply`` alone: its output and the gradients of x and of every
  parameter for a random cotangent, causal and with a sliding window;
- the smoke model (one dense layer, then MoE layers, every attention MLA):
  every stage output, the loss, and every gradient under store-all and a
  rotor plan, without and with per-layer remat and the token-chunked loss;
- the chunked path past ``DIRECT_ATTEND_MAX`` runs (it raised before the
  serving slice; ``tests/test_torch_serve.py`` holds it against the JAX
  package);
- the full-width tree has the JAX package's paths, shapes and dtypes.

Tolerances, as ``tests/test_torch_archs.py`` states them: outputs and
losses rtol 1e-5 (atol 1e-6 for entries near zero), gradients rtol 1e-4 /
atol 1e-5 — float32 sums taken in another order by two frameworks.  The
planner's FLOPs of the MLA config are held in ``test_torch_archs.py``."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config as pget  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.rematerialize import count_checkpoint_scopes  # noqa: E402
from repro_torch.launch.steps import plan_training  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.tree import tensors_of, tree_map  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
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


@pytest.mark.parametrize("window", [None, 5])
def test_mla_apply_matches_jax(window):
    jcfg, pcfg = jsmoke(ARCH), psmoke(ARCH)
    jp = jattn.mla_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    pp = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(),
                  jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jspec = jattn.MaskSpec(causal=True, window=window)
    pspec = pattn.MaskSpec(causal=True, window=window)

    @jax.jit
    def forward_and_vjp(p, x_):
        out, vjp = jax.vjp(lambda p_, x__: jattn.mla_apply(
            p_, jcfg, x__, jnp.asarray(pos), jspec), p, x_)
        return out, vjp(jnp.asarray(gy))

    want_y, (want_gp, want_gx) = forward_and_vjp(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = pattn.mla_apply(pp, pcfg, xt, torch.from_numpy(pos.copy()), pspec)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    leaves = tensors_of(pp)
    got = torch.autograd.grad(y, [xt] + leaves, torch.from_numpy(gy))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_gx),
                               rtol=1e-4, atol=1e-5)
    it = iter(got[1:])
    _assert_tree_close(tree_map(lambda _: next(it), pp), want_gp, rtol=1e-4,
                       atol=1e-5)


def test_mla_chunked_path_still_raises():
    """The name is from before the chunked path was ported: past
    ``DIRECT_ATTEND_MAX`` MLA no longer raises but runs in q blocks."""
    cfg = psmoke(ARCH)
    p = pattn.mla_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                       "meta")
    Sq = pattn.DIRECT_ATTEND_MAX + 1
    x = torch.empty((1, Sq, cfg.d_model), device="meta")
    pos = torch.zeros((1, Sq), dtype=torch.int32, device="meta")
    y = pattn.mla_apply(p, cfg, x, pos, pattn.MaskSpec())
    assert tuple(y.shape) == (1, Sq, cfg.d_model)


def test_full_width_tree_matches_jax():
    kw = dict(num_layers=2, layer_kinds=("dense", "moe"), n_chunks=2)
    want = jax.eval_shape(JLM(jget(ARCH, **kw)).init, jax.random.PRNGKey(0))
    got = PLM(pget(ARCH, **kw)).init(device="meta")
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert len(flat) == len(tensors_of(got))
    for path, leaf in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).removeprefix("torch.") == leaf.dtype.name, path
    assert got["chunks"][0]["attn"]["wkv_a"]["kernel"].shape == (1, 2048,
                                                                 576)


OVERRIDES = {"plain": {},
             "remat-xent": dict(scan_layer_remat="full", logits_chunk=8)}


@pytest.fixture(scope="module", params=list(OVERRIDES))
def setup(request):
    ov = OVERRIDES[request.param]
    jcfg = jsmoke(ARCH, **ov)
    jparams = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0))
    batch = SyntheticLMData(jcfg, B, S, seed=0).batch_at(0)
    jm, a, outs = JLM(jcfg), batch, []
    for fn, p in zip(jm.stage_fns(), jm.stage_params(jparams)):
        a = fn(p, a)
        outs.append(np.asarray(a["h"]) if isinstance(a, dict) else float(a))
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jparams, batch)
    pcfg = psmoke(ARCH, **ov)
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                "cpu")
    return pcfg, pparams, batch, outs, float(jloss), jgrads


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_stage_outputs_and_loss_match(setup):
    pcfg, pparams, batch, outs, jloss, _ = setup
    assert pcfg.attention_kind == "mla"
    assert [k for k, _, _ in pcfg.chunks] == ["dense", "moe", "moe"]
    pm = PLM(pcfg)
    a = _port_batch(batch)
    with torch.no_grad():
        for i, (fn, p, want) in enumerate(zip(pm.stage_fns(),
                                              pm.stage_params(pparams), outs)):
            a = fn(p, a)
            if isinstance(a, dict):
                np.testing.assert_allclose(a["h"].numpy(), want, rtol=1e-5,
                                           atol=1e-6, err_msg=f"stage {i}")
    np.testing.assert_allclose(a.item(), jloss, rtol=1e-5)


@pytest.mark.parametrize("policy", ["none", "rotor:x0.8"])
def test_gradients_match(setup, policy):
    pcfg, pparams, batch, _, jloss, jgrads = setup
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
