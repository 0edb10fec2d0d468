"""``MemoryPlan.bind(...).value_and_grad`` and ``MemoryPlan.execute`` in
the port against the JAX package's ``BoundPlan`` / ``execute``, for a
two-tier plan (nested checkpoints) and an offload plan (the eager walker).

- The quickstart-style tanh MLP chain in float32, weights from one JAX
  seed: the port within rtol 1e-5 (atol 1e-7) of the JAX package, and
  within rtol 1e-5 of its own plain autograd.
- The smoke Qwen with bridged weights: the JAX ``BoundPlan``'s pure
  ``forward`` differentiated with ``jax.value_and_grad`` (its
  ``value_and_grad`` also differentiates the integer batch, which JAX
  refuses), against the port's bound plans; the loss within rtol 1e-4
  (``test_torch_train.py``) and gradients within rtol 1e-4 / atol 1e-5
  (``test_torch_model.py``)."""

import math

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.core.chain import Chain, HostTransferModel  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro.plan.compat import resolve_policy as jresolve  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.core.executor import reference_grads  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.plan import BoundPlan, resolve_policy  # noqa: E402

from helpers import make_mlp_chain  # noqa: E402

L = 6
POLICIES = {"two-tier": "rotor:x0.6", "offload": "optimal_offload:x0.4:1.0"}


def _cost_chain(length):
    """A chain whose plans recompute (two-tier) and offload (with a link)."""
    return Chain.make(uf=[1.0] * length + [0.0], ub=[2.0] * length + [0.0],
                      wa=[1.0] * (length + 1), wabar=[2.0] * length + [0.0],
                      host=HostTransferModel(bandwidth_d2h=1.0))


def _port(ch):
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       host=PHost(bandwidth_d2h=ch.host.bandwidth_d2h))


def _plans(kind, length):
    ch = _cost_chain(length)
    want = jresolve(POLICIES[kind], ch, num_slots=64)
    got = resolve_policy(POLICIES[kind], _port(ch), num_slots=64)
    assert got.schedule.ops == want.schedule.ops
    assert got.uses_offload == (kind == "offload")
    assert got.remat_expressible == (kind == "two-tier")
    if kind == "two-tier":
        assert max(got.schedule.forward_counts().values()) > 1
    return want, got


def _torch_mlp(params, x):
    stages = [lambda p, a: torch.tanh(a @ p["w"] + p["b"])] * (len(params) - 1)
    stages.append(lambda p, a: torch.mean(a ** 2))
    pparams = [{k: torch.from_numpy(np.array(v)).requires_grad_()
                for k, v in p.items()} for p in params]
    return stages, pparams, torch.from_numpy(np.array(x))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["two-tier", "offload"])
def test_mlp_bound_plan_and_execute_match_jax(kind):
    stages, params, x = make_mlp_chain(L)
    jplan, plan = _plans(kind, L)
    jbound = jplan.bind(stages)
    vg = jax.jit(jbound.value_and_grad) if jbound.jittable else \
        jbound.value_and_grad
    jout, jgrads, jdx = vg(params, x)
    eout, egrads, edx = jplan.execute(stages, params, x)
    pstages, pparams, px = _torch_mlp(params, x)
    bound = plan.bind(pstages)
    assert isinstance(bound, BoundPlan)
    assert bound.remat_expressible == (kind == "two-tier")
    _, rgrads, rdx = reference_grads(pstages, pparams, px)
    for out, grads, dx in (bound.value_and_grad(pparams, px),
                           plan.execute(pstages, pparams, px)):
        _close(out, jout, 1e-5, 1e-7)
        _close(out, eout, 1e-5, 1e-7)
        for l in range(L):
            for k in ("w", "b"):
                _close(grads[l][k], jgrads[l][k], 1e-5, 1e-7)
                _close(grads[l][k], egrads[l][k], 1e-5, 1e-7)
                torch.testing.assert_close(grads[l][k], rgrads[l][k],
                                           rtol=1e-5, atol=1e-8)
        _close(dx, jdx, 1e-5, 1e-7)
        _close(dx, edx, 1e-5, 1e-7)
    _close(bound.forward(pparams, px), jbound.forward(params, x), 1e-5, 1e-7)


@pytest.fixture(scope="module")
def qwen():
    kw = dict(num_layers=3, layer_kinds=("dense",) * 3, n_chunks=3,
              scan_layer_remat="full")
    jcfg, pcfg = jsmoke("qwen1.5-4b", **kw), psmoke("qwen1.5-4b", **kw)
    jm, pm = JLM(jcfg), PLM(pcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                torch.device("cpu"))
    batch = SyntheticLMData(jcfg, 2, 16, seed=0).batch_at(0)
    jplan = _plans("two-tier", pm.n_stages() - 1)[0]
    jbound = jplan.bind(jm.stage_fns())
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda sp: jbound.forward(sp, batch)))(jm.stage_params(jparams))
    return pm, pparams, {k: torch.from_numpy(v) for k, v in batch.items()}, \
        float(jloss), jgrads


@pytest.mark.parametrize("kind", ["two-tier", "offload"])
def test_qwen_bound_plan_and_execute_match_jax(qwen, kind):
    pm, pparams, batch, jloss, jgrads = qwen
    _, plan = _plans(kind, pm.n_stages() - 1)
    sp = pm.stage_params(pparams)
    for loss, grads, dx in (plan.bind(pm.stage_fns()).value_and_grad(sp,
                                                                     batch),
                            plan.execute(pm.stage_fns(), sp, batch)):
        np.testing.assert_allclose(loss.item(), jloss, rtol=1e-4)
        assert dx["tokens"] is None and dx["labels"] is None
        got = params_to_numpy(grads)
        flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
        assert len(flat) == sum(len(jax.tree.leaves(g)) for g in got)
        for path, want in flat:
            node = got
            for key in path:
                node = node[key.key if hasattr(key, "key") else key.idx]
            np.testing.assert_allclose(node, np.asarray(want), rtol=1e-4,
                                       atol=1e-5, err_msg=str(path))
        assert math.isfinite(loss.item())
