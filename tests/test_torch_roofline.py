"""The port's shape cells, model FLOPs and analytic roofline terms
(``repro_torch.configs.shapes``, ``models.flops``, ``launch.analytic``,
``launch.mesh``) against the JAX package's, and the FLOPs a step counts
against the analytic count.

The reference's terms run on a mesh stub (``shape`` maps axis names to
sizes, ``size`` their product), as its ``backfill_analytic`` builds one;
both packages get the same chain arrays and schedule.  Priced on a
``Hardware`` built here from ``repro.launch.mesh``'s constants with both
links at its ``ICI_BW``, every term equals the reference's (rtol 1e-12).
"""

import dataclasses
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import shapes as ref_shapes
from repro.launch import analytic as ref_analytic
from repro.launch import mesh as ref_mesh
from repro.models.flops import model_flops_per_step as ref_model_flops
from repro.models.lm import StagedLM as RefLM
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs import shapes
from repro_torch.configs.shapes import ShapeSpec, input_specs
from repro_torch.core.schedule import Schedule
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.launch import analytic
from repro_torch.launch.mesh import H100_SXM, Hardware, production_shape
from repro_torch.launch.steps import plan_chain
from repro_torch.models.flops import model_flops_per_step
from repro_torch.models.lm import StagedLM
from repro_torch.plan import resolve_policy
from repro_torch.core.solver import solve_min_memory
from repro_torch.tree import tensors_of, tree_map

ROOT = Path(__file__).resolve().parents[1]

#: the reference's TPU v5e constants, both links at its one ICI rate
V5E = Hardware(name="v5e (the reference's constants)",
               peak_bf16=ref_mesh.PEAK_FLOPS_BF16, hbm_bw=ref_mesh.HBM_BW,
               hbm_bytes=ref_mesh.HBM_BYTES, nvlink_bw=ref_mesh.ICI_BW,
               network_bw=ref_mesh.ICI_BW)

TINY = dict(num_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, n_chunks=2)
ARCH_OVERRIDES = {
    "dense": ("qwen1.5-4b", dict(layer_kinds=("dense",) * 4)),
    "moe": ("moonshot-v1-16b-a3b", dict(
        layer_kinds=("dense", "moe", "moe", "moe"), num_experts=8,
        moe_d_ff=32)),
    "mamba2": ("mamba2-1.3b", dict(layer_kinds=("mamba",) * 4, ssm_state=16,
                                   ssm_head_dim=16, ssm_chunk=8)),
    "zamba2": ("zamba2-2.7b", dict(layer_kinds=("zamba",) * 4,
                                   hybrid_period=2, ssm_state=16,
                                   ssm_head_dim=16, ssm_chunk=8)),
}
MESHES = {
    "2x2": SimpleNamespace(shape={"data": 2, "model": 2}, size=4),
    "2x2x2": SimpleNamespace(shape={"pod": 2, "data": 2, "model": 2},
                             size=8),
}
TERMS = ("compute_s", "memory_s", "collective_s", "flops_per_device",
         "hbm_bytes_per_device", "collective_bytes_per_device")


def _configs(name):
    arch, extra = ARCH_OVERRIDES[name]
    ov = dict(TINY, **extra)
    return ref_config(arch, **ov), get_config(arch, **ov)


# -- shape cells and model FLOPs ----------------------------------------------


def test_shapes_equal_the_reference():
    assert list(shapes.SHAPES) == list(ref_shapes.SHAPES)
    for name, s in shapes.SHAPES.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            ref_shapes.SHAPES[name])
    assert shapes.LONG_CONTEXT_ARCHS == ref_shapes.LONG_CONTEXT_ARCHS
    assert set(ARCHS) == set(REF_ARCHS)
    for arch in ARCHS:
        for s in shapes.SHAPES:
            assert shapes.applicable(arch, s) == ref_shapes.applicable(arch, s)
    assert shapes.cells(REF_ARCHS) == ref_shapes.cells(REF_ARCHS)
    assert sorted(shapes.cells(ARCHS)) == sorted(ref_shapes.cells(REF_ARCHS))
    assert len(shapes.cells(ARCHS)) == 32


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for train in (True, False):
        for B, S in ((256, 4096), (128, 1)):
            assert model_flops_per_step(cfg, B, S, train) == ref_model_flops(
                rcfg, B, S, train)


# -- the analytic terms against the reference's --------------------------------


def _assert_terms_equal(got, want):
    for k in TERMS:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(ARCH_OVERRIDES))
def test_train_terms_equal_the_reference(name, mesh):
    rcfg, cfg = _configs(name)
    m = MESHES[mesh]
    shape = ShapeSpec("t", "train", 64, 8)
    model = StagedLM(cfg)
    chain = plan_chain(model, input_specs(cfg, shape), 1e12, mesh=m)
    lo, hi = solve_min_memory(chain).mem_limit, chain.store_all_peak()
    for sched in (Schedule.store_all(chain.length),
                  resolve_policy(f"rotor:{int((lo + hi) / 2)}",
                                 chain).schedule):
        got = analytic.train_terms(cfg, shape, m, model, chain, sched, V5E)
        want = ref_analytic.train_terms(rcfg, shape, m, RefLM(rcfg), chain,
                                        sched)
        _assert_terms_equal(got, want)
    if name == "moe" and mesh == "2x2x2":
        assert got["collective_bytes_per_device"] > 0


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(ARCH_OVERRIDES))
def test_serving_terms_equal_the_reference(name, mesh, kind):
    rcfg, cfg = _configs(name)
    m = MESHES[mesh]
    shape = ShapeSpec("s", kind, 64, 8)
    ours = (analytic.decode_terms if kind == "decode"
            else analytic.prefill_terms)
    theirs = (ref_analytic.decode_terms if kind == "decode"
              else ref_analytic.prefill_terms)
    _assert_terms_equal(ours(cfg, shape, m, StagedLM(cfg), V5E),
                        theirs(rcfg, shape, m, RefLM(rcfg)))


def test_moe_all_to_all_crosses_the_model_link():
    """Under H100_SXM a term is its count over the constant of its link:
    the MoE exchange (model axis) on NVLink, the FSDP traffic (data and
    pod) on the network."""
    _, cfg = _configs("moe")
    m = MESHES["2x2x2"]
    shape = ShapeSpec("t", "train", 64, 8)
    model = StagedLM(cfg)
    chain = plan_chain(model, input_specs(cfg, shape), 1e12, mesh=m)
    t = analytic.train_terms(cfg, shape, m, model, chain, None, H100_SXM)
    net_only = analytic.train_terms(cfg, shape, m, model, chain, None,
                                    dataclasses.replace(H100_SXM,
                                                        nvlink_bw=math.inf))
    nvl_only = analytic.train_terms(cfg, shape, m, model, chain, None,
                                    dataclasses.replace(H100_SXM,
                                                        network_bw=math.inf))
    net_bytes = net_only["collective_s"] * H100_SXM.network_bw
    nvl_bytes = nvl_only["collective_s"] * H100_SXM.nvlink_bw
    assert net_bytes > 0 and nvl_bytes > 0
    np.testing.assert_allclose(net_bytes + nvl_bytes,
                               t["collective_bytes_per_device"], rtol=1e-12)
    np.testing.assert_allclose(t["collective_s"],
                               net_bytes / 50e9 + nvl_bytes / 450e9,
                               rtol=1e-12)


@pytest.mark.parametrize("kind", ["train", "decode", "prefill"])
def test_h100_terms_are_counts_over_the_right_constant(kind):
    _, cfg = _configs("dense")
    m = MESHES["2x2"]
    shape = ShapeSpec("t", kind, 64, 8)
    model = StagedLM(cfg)
    if kind == "train":
        chain = plan_chain(model, input_specs(cfg, shape), 1e12, mesh=m)
        t = analytic.train_terms(cfg, shape, m, model, chain, None)
    else:
        t = (analytic.decode_terms if kind == "decode"
             else analytic.prefill_terms)(cfg, shape, m, model)
    assert t["compute_s"] == t["flops_per_device"] / 989e12
    assert t["memory_s"] == t["hbm_bytes_per_device"] / 3.35e12
    link = 450e9 if kind == "decode" else 50e9  # TP all-reduce; FSDP
    assert t["collective_bytes_per_device"] > 0
    assert t["collective_s"] == pytest.approx(
        t["collective_bytes_per_device"] / link, rel=1e-12)
    t["dominant"] = analytic.dominant(t)
    assert t["dominant"] in ("compute", "memory", "collective")


def test_h100_constants_and_the_production_mesh():
    assert (H100_SXM.peak_bf16, H100_SXM.hbm_bw) == (989e12, 3.35e12)
    assert (H100_SXM.nvlink_bw, H100_SXM.network_bw) == (450e9, 50e9)
    assert H100_SXM.link_bw("model") == 450e9
    assert H100_SXM.link_bw("data") == H100_SXM.link_bw("pod") == 50e9
    assert math.prod(production_shape().values()) == 256
    assert math.prod(production_shape(True).values()) == 512
    assert production_shape()["model"] == 8


# -- counted FLOPs against the analytic count ----------------------------------


@pytest.mark.parametrize("remat,window", [("full", (0.955, 0.965)),
                                          ("none", (0.995, 1.0))])
def test_counted_flops_of_a_cpu_step(remat, window):
    """One CPU step of smoke Qwen (batch 2 × 256, store-all) under
    ``FlopCounterMode`` against ``train_terms``' count (0.9603 with
    per-layer remat, 0.9998 without).  The analytic count prices the
    embedding lookup (no product) and, with per-layer remat, replays every
    stage; the checkpoint's recompute stops once the saved tensors are
    back, so each layer's last product (the MLP's down projection) is not
    replayed, and the head is not under a layer checkpoint."""
    cfg = smoke_config("qwen1.5-4b", scan_layer_remat=remat)
    model = StagedLM(cfg)
    B, S = 2, 256
    params = model.init(0, "cpu")
    batch = SyntheticLMData(cfg, B, S, seed=0).device_batch(
        0, torch.device("cpu"))
    with FlopCounterMode(display=False) as fc:
        loss = model.loss_fn(params, batch)
        torch.autograd.grad(loss, tensors_of(params))
    shape = ShapeSpec("t", "train", S, B)
    chain = plan_chain(model, input_specs(cfg, shape), 1e12)
    want = analytic.train_terms(cfg, shape, None, model, chain,
                                None)["flops_per_device"]
    ratio = fc.get_total_flops() / want
    assert window[0] <= ratio <= window[1], ratio


def test_card_flop_ratio_prediction(monkeypatch):
    """``chip_smoke.py`` phase 23's window, from the same count on fake CPU
    tensors: Qwen1.5-4B at 8 layers, batch 4 × 2048, K3 on (its forward
    and each layer replay's; FlopCounterMode cannot see it on the card, so
    the phase adds its causal count per launch, as this does), store-all
    and rotor at the analytic chain's midpoint."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    L, B, S = chip_smoke.LAYERS, chip_smoke.BATCH, chip_smoke.SEQ
    cfg = get_config(chip_smoke.ARCH, num_layers=L,
                     layer_kinds=("dense",) * L, n_chunks=L,
                     use_flash_attention=True)
    model = StagedLM(cfg)
    shape = ShapeSpec("t", "train", S, B)
    chain = plan_chain(model, input_specs(cfg, shape), 989e12,
                       allocator=True)
    calls = [0]
    plain = flash_ref.attention

    def counted(*a):
        calls[0] += 1
        return plain(*a)

    monkeypatch.setattr(flash_ref, "attention", counted)
    full = 4 * B * cfg.n_heads * S * S * cfg.head_dim
    causal = flash_ops.kernel_flops(B, S, cfg.n_heads, cfg.head_dim)
    mid = (solve_min_memory(chain).mem_limit + chain.store_all_peak()) / 2
    ratios = []
    for plan in (None, resolve_policy(f"rotor:{int(mid)}", chain)):
        calls[0] = 0
        with FakeTensorMode():
            params = tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype).requires_grad_(),
                model.init(device="meta"))
            batch = {"tokens": torch.zeros(B, S, dtype=torch.int32),
                     "labels": torch.zeros(B, S, dtype=torch.int32),
                     "loss_mask": torch.ones(B, S)}
            with FlopCounterMode(display=False) as fc:
                loss = model.loss_fn(params, batch,
                                     tree=plan.tree if plan else None)
                torch.autograd.grad(loss, tensors_of(params))
        # every call but each layer's one backward recompute is a K3 launch
        k3 = calls[0] - L
        card = fc.get_total_flops() - k3 * (full - causal)
        want = analytic.train_terms(cfg, shape, None, model, chain,
                                    plan.schedule if plan else None)
        ratios.append(card / want["flops_per_device"])
    lo, hi = chip_smoke.FLOP_RATIO_WINDOW
    assert all(lo <= r <= hi for r in ratios)


def test_byte_counter_books_kernel_ops_as_the_kernel_moves_them():
    """Off CUDA a kernel op runs its plain version; an active ByteCounter
    books it as its kernel moves it (arguments read once, outputs written
    once, as ``chip_smoke.py`` phase 5's bounds count them) and counts no
    op of the plain version; it is not a launch."""
    from repro_torch import counters
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.launch.roofline import ByteCounter

    q, k = torch.randn(2, 64, 4, 16), torch.randn(2, 64, 2, 16)
    x, scale = torch.randn(8, 32), torch.ones(32)
    counters.reset()
    counter = ByteCounter()
    with counter, counters.byte_sink(counter):
        flash_ops.attention_fwd(q, k, k)
        rms_ops.rms_norm_fwd(x, scale)
    assert counter.kernel_bytes == {
        flash_ops.NAME: 4 * (2 * q.numel() + 2 * k.numel()),
        rms_ops.NAME: 4 * (2 * x.numel() + scale.numel())}
    assert counter.total == sum(counter.kernel_bytes.values())
    assert counters.snapshot() == {}
    # without a counter the plain version runs as before
    assert torch.equal(flash_ops.attention_fwd(q, k, k),
                       flash_ref.attention(q, k, k))
