"""The port's staged Zamba2 (smoke width: 4 layers, period 2, so 2 chunks
that each open with the shared attention+MLP block; the SSD kernel wrapper,
per-layer remat, token-chunked loss) against the JAX
``StagedLM`` with the same weights, bridged through numpy, in float32 on the
CPU: every stage output, the loss, every parameter gradient under store-all,
under a rotor plan's nested checkpoints and through the eager offload walker
(per-stage gradients combined by ``combine_stage_grads``).  The JAX side
runs its Pallas SSD kernel in interpret mode.  (The planner's FLOPs are
held in ``tests/test_torch_archs.py``.)

The shared block's parameters belong to both chunk stages, so its gradient
is the sum of two non-zero parts: autograd sums them on the store-all and
rotor paths (the leaf appears once), ``combine_stage_grads`` on the walker.

Tolerances, as ``tests/test_torch_model.py`` states them: stage outputs and
losses rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 — float32 sums taken in
another order by two frameworks.  For entries of a stage output near zero,
atol 1e-6 per unit of the output's largest magnitude: Zamba2's residual
stream reaches ~5 after a chunk (two Mamba2 layers and the shared block),
where one float32 ulp is ~5e-7."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.kernels.ssd import ops as jssd  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.rematerialize import count_checkpoint_scopes  # noqa: E402
from repro_torch.core.chain import Chain, HostTransferModel  # noqa: E402
from repro_torch.launch.steps import plan_chain, plan_training  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.offload.executor import execute_offload_schedule  # noqa: E402
from repro_torch.offload.host_buffer import HostBuffer  # noqa: E402
from repro_torch.plan import resolve_policy  # noqa: E402
from repro_torch.tree import tensors_of, tree_map  # noqa: E402

ARCH = "zamba2-2.7b"
# the plain attention on both sides (flash attention is held against the
# JAX package in tests/test_torch_model.py)
OVERRIDES = dict(use_ssd_kernel=True, scan_layer_remat="full",
                 logits_chunk=8)
B, S = 2, 16


@pytest.fixture(scope="module")
def setup():
    jssd.set_interpret(True)
    try:
        jcfg = jsmoke(ARCH, **OVERRIDES)
        pcfg = psmoke(ARCH, **OVERRIDES)
        jparams = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0))
        batch = SyntheticLMData(jcfg, B, S, seed=0).batch_at(0)
        jm, a, outs = JLM(jcfg), batch, []
        for fn, p in zip(jm.stage_fns(), jm.stage_params(jparams)):
            a = jax.jit(fn)(p, a)
            outs.append(np.asarray(a["h"]) if isinstance(a, dict)
                        else float(a))
        jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jparams,
                                                                batch)
    finally:
        jssd.set_interpret(False)
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                "cpu")
    return pcfg, pparams, batch, outs, float(jloss), jgrads


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


def test_structure_two_chunks_each_with_the_shared_block(setup):
    pcfg, pparams, *_ = setup
    assert pcfg.chunks == [("zamba", 0, 2), ("zamba", 2, 2)]
    sp = PLM(pcfg).stage_params(pparams)
    assert all(p["shared"] is pparams["shared_attn"] for p in sp[1:-1])


def test_stage_outputs_and_loss_match(setup):
    pcfg, pparams, batch, outs, jloss, _ = setup
    pm = PLM(pcfg)
    a = _port_batch(batch)
    with torch.no_grad():
        for i, (fn, p, want) in enumerate(zip(pm.stage_fns(),
                                              pm.stage_params(pparams), outs)):
            a = fn(p, a)
            if isinstance(a, dict):
                np.testing.assert_allclose(
                    a["h"].numpy(), want, rtol=1e-5,
                    atol=1e-6 * max(1.0, float(np.abs(want).max())),
                    err_msg=f"stage {i}")
    np.testing.assert_allclose(float(a), want, rtol=1e-5)
    np.testing.assert_allclose(float(a), jloss, rtol=1e-5)


def _offload_plan(pm, pcfg):
    """A three-tier plan of the smoke chain that parks an activation on the
    host: at 0.55 × store-all, with the forward times repriced 100× (on the
    chain as profiled, the host tier lowers no floor of a 4-stage chain, so
    the plan would only recompute)."""
    chain = plan_chain(pm, input_specs(pcfg, ShapeSpec("t", "train", S, B)),
                       1e12)
    dear = Chain.make(uf=chain.uf * 100, ub=chain.ub, wa=chain.wa,
                      wabar=chain.wabar,
                      host=HostTransferModel(bandwidth_d2h=1e15))
    plan = resolve_policy("optimal_offload:x0.55:1e15", dear)
    assert plan.schedule.count("Foff") >= 1
    return plan


@pytest.fixture(scope="module")
def walker(setup):
    """Loss and per-stage gradients of the eager offload walker."""
    pcfg, pparams, batch, *_ = setup
    pm = PLM(pcfg)
    plan = _offload_plan(pm, pcfg)
    hb = HostBuffer()
    loss, stage_grads, _ = execute_offload_schedule(
        plan.schedule, pm.stage_fns(), pm.stage_params(pparams),
        _port_batch(batch), host_buffer=hb)
    assert hb.peak_bytes > 0 and hb.bytes_in_use == 0
    return plan, loss, stage_grads


@pytest.mark.parametrize("path", ["store_all", "rotor", "offload"])
def test_gradients_match_with_shared_block_summed(setup, walker, path):
    pcfg, pparams, batch, _, jloss, jgrads = setup
    pm = PLM(pcfg)
    _, wloss, stage_grads = walker
    if path == "offload":
        loss, grads = wloss, pm.combine_stage_grads(stage_grads)
    else:
        tree = None
        if path == "rotor":
            plan, _ = plan_training(
                pm, input_specs(pcfg, ShapeSpec("t", "train", S, B)),
                "rotor:x0.8", peak_flops=1e12)
            assert count_checkpoint_scopes(plan.tree) >= 1
            tree = plan.tree
        loss = pm.loss_fn(pparams, _port_batch(batch), tree=tree)
        it = iter(torch.autograd.grad(loss, tensors_of(pparams)))
        grads = tree_map(lambda _: next(it), pparams)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    assert list(grads) == list(pparams)
    _assert_tree_close(grads, jgrads, rtol=1e-4, atol=1e-5)
    # the shared block's gradient is the sum of the two chunk stages' parts
    # (each non-zero, and each alone far from the sum)
    parts = [tensors_of(g["shared"]) for g in stage_grads[1:-1]]
    assert len(parts) == 2
    for got, p0, p1 in zip(tensors_of(grads["shared_attn"]), *parts):
        torch.testing.assert_close(got, p0 + p1, rtol=1e-5, atol=1e-6)
        for part in (p0, p1):
            assert float((got - part).abs().max()) > 1e-3 * float(
                got.abs().max())


def test_offload_step_updates_like_the_nested_checkpoint_step(setup, walker):
    """``make_offload_step`` (per-stage gradients from the walker, combined)
    and ``make_train_step`` (autograd over the leaves) take the same AdamW
    step: the shared block's update uses the summed gradient."""
    from repro_torch.launch.steps import make_offload_step, make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    pcfg, pparams, batch, *_ = setup
    pm = PLM(pcfg)
    plan = walker[0]
    opt = AdamWConfig(lr=1e-3, weight_decay=0.0)
    new = []
    for make in (lambda: make_train_step(pm, opt, None),
                 lambda: make_offload_step(pm, opt, plan.schedule)):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          pparams)
        metrics = make()(params, adamw_init(tensors_of(params)),
                         _port_batch(batch), 0)
        new.append((params, metrics))
    (a, ma), (b, mb) = new
    np.testing.assert_allclose(mb["grad_norm"].item(), ma["grad_norm"].item(),
                               rtol=1e-5)
    for x, y in zip(tensors_of(a), tensors_of(b)):
        torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-6)
    assert not torch.equal(a["shared_attn"]["mlp"]["wo"]["kernel"],
                           pparams["shared_attn"]["mlp"]["wo"]["kernel"])


@pytest.mark.parametrize("path", ["reference", "rotor", "offload"])
def test_bound_plan_gradients_combine_to_the_jax_ones(setup, walker, path):
    """``MemoryPlan.bind(...).value_and_grad`` returns one part per chunk
    stage on both of its executors (nested checkpoints for a rotor plan,
    the eager walker for an offload plan), as ``reference_grads`` does;
    ``combine_stage_grads`` sums them to the JAX package's gradient."""
    from repro_torch.core.executor import reference_grads

    pcfg, pparams, batch, _, jloss, jgrads = setup
    pm = PLM(pcfg)
    stages, sp = pm.stage_fns(), pm.stage_params(pparams)
    if path == "reference":
        loss, stage_grads, _ = reference_grads(stages, sp, _port_batch(batch))
    else:
        if path == "rotor":
            plan, _ = plan_training(
                pm, input_specs(pcfg, ShapeSpec("t", "train", S, B)),
                "rotor:x0.8", peak_flops=1e12)
        else:
            plan = walker[0]
        bound = plan.bind(stages)
        assert bound.remat_expressible == (path == "rotor")
        loss, stage_grads, _ = bound.value_and_grad(sp, _port_batch(batch))
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    _assert_tree_close(pm.combine_stage_grads(stage_grads), jgrads,
                       rtol=1e-4, atol=1e-5)
    # each chunk stage holds its own part, as the walker gives it
    for got, want in zip(tensors_of([g["shared"] for g in stage_grads[1:-1]]),
                         tensors_of([g["shared"] for g in walker[2][1:-1]])):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
