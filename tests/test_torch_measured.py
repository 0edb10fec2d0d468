"""The port's measured chain (``core.planner.profile_stages_measured`` via
``launch.steps.measure_chain``) on the CPU, against the port's analytic
chain and the JAX package's measured chain, on the same seeded weights and
batch: ``wa``/``wabar`` equal the analytic chain's (the same saved-tensor
hook), ``wa`` equals the JAX measured chain's, times are positive and the
transients ``of``/``ob`` are 0 off CUDA.  Also the host-link probe on the
host clock, and ``run_training(chain=...)`` planning on the chain it is
given.  Sizes are compared exactly (byte counts)."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.core.planner import profile_stages_measured as jmeasured  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.chain import HostTransferModel  # noqa: E402
from repro_torch.core.planner import (_grad_consumers,  # noqa: E402
                                      allocator_bytes, grad_with_peaks,
                                      measure_host_bandwidth,
                                      profile_stages_analytic)
from repro_torch.core.solver import solve_min_memory  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.launch.steps import (measure_chain, plan_chain,  # noqa: E402
                                     plan_training)
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.runtime.train_loop import TrainLoopConfig, run_training  # noqa: E402
from repro_torch.tree import tensors_of  # noqa: E402

B, S = 2, 16
QWEN = dict(num_layers=2, layer_kinds=("dense",) * 2, n_chunks=2,
            use_flash_attention=False, logits_chunk=0)


def _measured(arch, **kw):
    cfg = psmoke(arch, **kw)
    model = PLM(cfg)
    params = model.init(0, "cpu")
    batch = SyntheticLMData(cfg, B, S, seed=0).device_batch(0, "cpu")
    return model, params, batch, measure_chain(model, params, batch)


@pytest.mark.parametrize("arch,kw", [
    ("qwen1.5-4b", dict(QWEN)),
    ("qwen1.5-4b", dict(use_flash_attention=True, scan_layer_remat="full",
                        logits_chunk=8)),
    ("mamba2-1.3b", dict(use_ssd_kernel=True)),
    ("zamba2-2.7b", dict(use_flash_attention=True, use_ssd_kernel=True,
                         scan_layer_remat="full", logits_chunk=8)),
    ("moonshot-v1-16b-a3b", dict(use_flash_attention=True,
                                 scan_layer_remat="full", logits_chunk=8)),
    ("deepseek-v2-lite-16b", dict(scan_layer_remat="full", logits_chunk=8)),
], ids=["qwen", "qwen-flash-remat-xent", "mamba2", "zamba2", "moe", "mla"])
def test_measured_chain_sizes_equal_analytic(arch, kw):
    model, _, _, chain = _measured(arch, **kw)
    analytic = plan_chain(model, input_specs(
        model.cfg, ShapeSpec("t", "train", S, B)), 1e12)
    np.testing.assert_array_equal(chain.wa, analytic.wa)
    np.testing.assert_array_equal(chain.wabar, analytic.wabar)
    assert np.all(chain.uf > 0) and np.all(chain.ub > 0)
    assert not np.any(chain.of) and not np.any(chain.ob)
    assert chain.length == model.n_stages() - 1


def test_allocator_bound_of_the_chain_sizes():
    """With ``allocator=True`` each tensor of ``wa`` and each storage of
    ``wabar`` counts at the CUDA caching allocator's bound: rounded up to
    512 B, plus 1 MiB above 1 MiB (the allocator serves such a request
    from a free block it does not split when at most 1 MiB would remain).
    The measured chain counts its sizes so on CUDA; times are unchanged."""
    mib = 1 << 20
    assert [allocator_bytes(n) for n in (0, 1, 512, 513, mib, mib + 1)] == [
        0, 512, 512, 1024, mib, 2 * mib + 512]
    x = torch.empty(mib // 2, device="meta")          # 2 MiB of float32
    w = torch.empty(mib // 2, device="meta", requires_grad=True)
    stages = [lambda p, a: a * p["w"], lambda p, a: (a * a).sum()]
    kw = dict(flops_fwd=[1.0, 1.0], flops_bwd=[2.0, 2.0], peak_flops=1.0)
    nominal = profile_stages_analytic(stages, [{"w": w}, {}], x, **kw)
    bound = profile_stages_analytic(stages, [{"w": w}, {}], x, **kw,
                                    allocator=True)
    # ā^1 is the product (unsaved, added as a^1), ā^2 the 4-byte loss
    assert list(nominal.wa) == [2 * mib] * 2
    assert list(nominal.wabar) == [2 * mib, 4]
    assert list(bound.wa) == [3 * mib] * 2
    assert list(bound.wabar) == [3 * mib, 512]
    np.testing.assert_array_equal(bound.uf, nominal.uf)
    model = PLM(psmoke("qwen1.5-4b", **QWEN))
    specs = input_specs(model.cfg, ShapeSpec("t", "train", S, B))
    got = plan_chain(model, specs, 1e12, allocator=True)
    want = plan_chain(model, specs, 1e12)
    assert got.wa[0] == sum(allocator_bytes(t.numel() * t.element_size())
                            for t in tensors_of(specs))
    assert np.all(got.wa >= want.wa) and np.all(got.wabar >= want.wabar)


def test_measured_wa_equals_jax_measured_chain():
    jcfg, pcfg = jsmoke("qwen1.5-4b", **QWEN), psmoke("qwen1.5-4b", **QWEN)
    jm, pm = JLM(jcfg), PLM(pcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    batch = JData(jcfg, B, S, seed=0).batch_at(0)
    want = jmeasured(jm.stage_fns(), jm.stage_params(jparams), batch,
                     repeats=1)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                               torch.device("cpu"))
    got = measure_chain(pm, params, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, repeats=1)
    np.testing.assert_array_equal(got.wa, want.wa)
    assert not np.any(got.of) and not np.any(want.of)


def test_measured_chain_takes_the_host_model():
    model, params, batch, _ = _measured("qwen1.5-4b", **QWEN)
    host = HostTransferModel(bandwidth_d2h=1e9)
    chain = measure_chain(model, params, batch, host=host, repeats=1)
    assert chain.host is host


def test_host_bandwidth_on_the_host_clock():
    link = measure_host_bandwidth(1 << 16, repeats=3, device="cpu")
    assert link.bandwidth_d2h > 0 and link.bandwidth_h2d > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            measure_host_bandwidth(1 << 16)


def test_run_training_plans_on_the_given_chain():
    model, _, _, chain = _measured("qwen1.5-4b", **QWEN)
    budget = int((solve_min_memory(chain).mem_limit
                  + chain.store_all_peak()) / 2)
    out = run_training(model.cfg, TrainLoopConfig(
        steps=1, global_batch=B, seq_len=S, policy=f"rotor:{budget}",
        solver_impl="plain"), device="cpu", chain=chain,
        log_fn=lambda *_: None)
    assert out["chain"] is chain and out["plan"].chain is chain
    assert out["steps"][0]["fwd_bwd_peak_bytes"] is None
    assert np.isfinite(out["losses"][0])


def test_run_training_plans_on_the_analytic_chain_off_cuda():
    """Off CUDA, with no chain given, the plan is solved on the analytic
    chain (times = FLOPs over ``peak_flops``, no transients), so the CPU
    runs compare like with like against the JAX package."""
    cfg = psmoke("qwen1.5-4b", **QWEN)
    out = run_training(cfg, TrainLoopConfig(
        steps=1, global_batch=B, seq_len=S, policy="rotor:x0.8",
        solver_impl="plain", peak_flops=1e12), device="cpu",
        log_fn=lambda *_: None)
    want = plan_chain(PLM(cfg), input_specs(cfg, ShapeSpec("t", "train", S,
                                                           B)), 1e12)
    for field in ("uf", "ub", "wa", "wabar", "of", "ob"):
        np.testing.assert_array_equal(getattr(out["chain"], field),
                                      getattr(want, field), err_msg=field)
    with pytest.raises(ValueError, match="peak_flops"):
        run_training(cfg, TrainLoopConfig(steps=1, global_batch=B,
                                          seq_len=S, policy="rotor:x0.8"),
                     device="cpu", log_fn=lambda *_: None)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "moonshot-v1-16b-a3b"],
                         ids=["zamba2", "moe"])
def test_grad_consumers_reach_every_parameter(arch):
    """``grad_with_peaks`` hooks the nodes that return a share of a
    parameter's gradient: under a rotor plan's nested checkpoints they
    cover every parameter of the step, and Zamba2's shared block has one
    share per chunk stage."""
    cfg = psmoke(arch, use_flash_attention=True, use_ssd_kernel=True,
                 scan_layer_remat="full", logits_chunk=8)
    model = PLM(cfg)
    params = model.init(0, "cpu")
    batch = SyntheticLMData(cfg, B, S, seed=0).device_batch(0, "cpu")
    plan, _ = plan_training(model, input_specs(
        cfg, ShapeSpec("t", "train", S, B)), "rotor:x0.7", peak_flops=1e12,
        impl="plain")
    leaves = tensors_of(params)
    loss = model.loss_fn(params, batch, tree=plan.tree)
    found = _grad_consumers([loss], leaves)
    shares = [i for slots in found.values() for _, i in slots]
    assert sorted(set(shares)) == list(range(len(leaves)))
    if arch == "zamba2-2.7b":
        for t in tensors_of(params["shared_attn"]):
            i = next(k for k, p in enumerate(leaves) if p is t)
            assert shares.count(i) >= len(cfg.chunks)


def test_grad_with_peaks_off_cuda_is_autograd_grad():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 8, generator=g).requires_grad_()
    x = torch.randn(4, 8, generator=g).requires_grad_()
    loss = torch.tanh(x @ w).pow(2).sum()
    grads, peak, act = grad_with_peaks([loss], [w, x], params=[w])
    want = torch.autograd.grad(torch.tanh(x @ w).pow(2).sum(), [w, x])
    assert peak is None and act is None
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def _frees_after_measuring(cfg, paths):
    """Whether the embedding table and the parameters at ``paths`` are
    freed once ``measure_chain`` has run and the caller drops them."""
    import gc
    import weakref

    model = PLM(cfg)
    params = model.init(0, "cpu")
    batch = SyntheticLMData(cfg, B, S, seed=0).device_batch(0, "cpu")
    leaves = [params["embed"]["table"]]
    for path in paths:
        t = params
        for k in path:
            t = t[k]
        leaves.append(t)
    refs = [weakref.ref(t) for t in leaves]
    measure_chain(model, params, batch, repeats=1)
    del params, batch, leaves, t
    gc.collect()
    return all(r() is None for r in refs)


def test_measuring_a_chain_keeps_no_tensor_alive():
    """``measure_chain`` counts saved tensors through a pack hook; once it
    returns, nothing of the stages' graphs may outlive it: the parameters
    and the batch are freed when the caller drops them (the hook's record
    of saved tensors would otherwise form a cycle with the graph that the
    garbage collector cannot see, holding every parameter)."""
    assert _frees_after_measuring(psmoke("qwen1.5-4b", **QWEN),
                                  [("head", "kernel")])


@pytest.mark.parametrize("arch,leaf", [
    ("zamba2-2.7b", ("shared_attn", "mlp", "wo", "kernel")),
    ("moonshot-v1-16b-a3b", ("chunks", 1, "moe", "we_down", "kernel")),
], ids=["zamba2", "moe"])
def test_measuring_zamba2_and_moe_chains_keeps_no_tensor_alive(arch, leaf):
    """As for Qwen above, on the two heterogeneous chains: Zamba2's (every
    chunk stage holds the shared block) and the MoE's (the dispatch buffers
    are transients of a stage)."""
    assert _frees_after_measuring(
        psmoke(arch, use_flash_attention=True, use_ssd_kernel=True,
               scan_layer_remat="full", logits_chunk=8), [leaf])
