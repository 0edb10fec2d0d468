"""The port's serving path against the JAX package's, in float32 on the CPU,
with the same weights bridged through numpy and prompts from a numpy seed,
on the smoke configs of the five ported families (MoE capacity factor 16,
so that no token is dropped at either batch shape, as
``tests/test_arch_smoke.py::test_decode_matches_forward`` does):

- ``prefill`` (logits and every cache tensor) and 4 ``decode_step``\\ s
  within rtol/atol 1e-4 of the JAX package's;
- decode against the port's own ``forward_logits`` within the reference's
  2e-3;
- ``cache_layout`` field by field, ``kv_chain`` array by array;
- ``plan_serving``'s schedule and ``kv_residency_layers`` at 0.5× and 2×
  the cache (the port on ``impl="plain"``);
- ``run_serving``: generations token-identical with no residency, with
  ``plan=`` and with ``kv_policy="lru"``, and the byte, stall, hit and miss
  counts equal;
- the argument errors, the q-block chunked attention (GQA and MLA) past a
  monkeypatched ``DIRECT_ATTEND_MAX`` (forward and gradients), and the
  launcher on the CPU.

Both packages price the KV chain with the JAX package's figures: a 12e9
B/s link (its PCIe-3 default; the port keeps none), 50e12 FLOP/s and
800e9 B/s (the port defaults to the H100's)."""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.core.chain import HostTransferModel as JHost  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro.plan import kv_chain as jkv_chain  # noqa: E402
from repro.plan import kv_residency_layers as jkv_layers  # noqa: E402
from repro.plan import plan_serving as jplan_serving  # noqa: E402
from repro.runtime.serve_loop import ServeLoopConfig as JLoop  # noqa: E402
from repro.runtime.serve_loop import run_serving as jrun_serving  # noqa: E402
from repro_torch.bridge import (cache_from_numpy, cache_to_numpy,  # noqa: E402
                                params_from_numpy, params_to_numpy)
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.plan.serving import kv_chain as pkv_chain  # noqa: E402
from repro_torch.plan.serving import (  # noqa: E402
    kv_residency_layers as pkv_layers)
from repro_torch.plan.serving import plan_serving as pplan_serving  # noqa: E402
from repro_torch.runtime.serve_loop import ServeLoopConfig  # noqa: E402
from repro_torch.runtime.serve_loop import run_serving  # noqa: E402
from repro_torch.tree import tensors_of, with_tensors  # noqa: E402

ARCHS = ["qwen1.5-4b", "moonshot-v1-16b-a3b", "deepseek-v2-lite-16b",
         "mamba2-1.3b", "zamba2-2.7b"]
B, S0, N = 2, 8, 4
MAX_LEN = 14
LINK = 12e9                      # the JAX package's pcie_gen3 default
PRICES = dict(device_flops=50e12, hbm_bandwidth=800e9)
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch, **kw):
    """(JAX model, its params, port model, bridged params, configs)."""
    kw = {"moe_capacity_factor": 16.0, **kw}
    jcfg, pcfg = jsmoke(arch, **kw), psmoke(arch, **kw)
    jm = JLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    return jm, jp, PLM(pcfg), pp, jcfg, pcfg


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close_trees(got, want, **tol):
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat] == [p for p, _ in got_flat]
    for (path, w), (_, g) in zip(flat, got_flat):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   err_msg=str(path), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jm, jp, pm, pp, jcfg, pcfg = _pair(arch)
    toks = _tokens(pcfg, (B, S0 + N))
    jprefill = jax.jit(jm.prefill, static_argnums=2)
    jdecode = jax.jit(jm.decode_step)
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :S0])}, MAX_LEN)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S0])},
                        max_len=MAX_LEN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _close_trees(cache_to_numpy(pc, pcfg), jc, **TOL)
    assert pc["pos"] == S0
    for t in range(N):
        nxt = toks[:, S0 + t][:, None]
        jl, jc = jdecode(jp, jc, jnp.asarray(nxt))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(nxt))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {t}")
    _close_trees(cache_to_numpy(pc, pcfg), jc, **TOL)
    # the bridge carries a cache both ways
    back = cache_to_numpy(cache_from_numpy(jax.tree.map(np.asarray, jc),
                                           pcfg, "cpu"), pcfg)
    _close_trees(back, jc, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_logits(arch):
    """Prefill + N decode steps reproduce the full forward's logits
    position by position (the reference's check and tolerance)."""
    _, _, pm, pp, _, pcfg = _pair(arch)
    toks = torch.from_numpy(_tokens(pcfg, (B, S0 + N), seed=2))
    ref = pm.forward_logits(pp, {"tokens": toks})
    logits, cache = pm.prefill(pp, {"tokens": toks[:, :S0]},
                               max_len=S0 + N)
    np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, S0 - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(N):
        logits, cache = pm.decode_step(pp, cache, toks[:, S0 + t][:, None])
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   ref[:, S0 + t].numpy(), rtol=2e-3,
                                   atol=2e-3)
    picked = pm.forward_logits(pp, {"tokens": toks}, at=[S0 - 1, S0 + 1])
    np.testing.assert_allclose(picked.numpy(), ref[:, [S0 - 1, S0 + 1]],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_matches_jax(arch):
    for jkw, pkw in (({}, {}),
                     ({"kv_cache_dtype": jnp.float8_e4m3fn},
                      {"kv_cache_dtype": torch.float8_e4m3fn})):
        want = JLM(jsmoke(arch, **jkw)).cache_layout(3, 20)
        got = PLM(psmoke(arch, **pkw)).cache_layout(3, 20)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), pkw
        assert got.logical_bytes(20) == got.allocated_bytes
    # the layout is what a prefilled cache holds, byte for byte
    _, _, pm, pp, _, pcfg = _pair(arch)
    _, cache = pm.prefill(pp, {"tokens": torch.from_numpy(
        _tokens(pcfg, (3, 6)))}, max_len=20)
    lay = pm.cache_layout(3, 20)
    assert [sum(t.nbytes for d in pm.cache_block(cache, j)
                for t in d.values()) for j in range(pcfg.num_layers)] == \
        list(lay.block_bytes)


def _chains(arch, max_len=MAX_LEN):
    kw = {"moe_capacity_factor": 16.0}
    jc = jkv_chain(jsmoke(arch, **kw), batch=B, prompt_len=S0,
                   max_len=max_len, host=JHost(LINK))
    pc = pkv_chain(psmoke(arch, **kw), batch=B, prompt_len=S0,
                   max_len=max_len, host=PHost(LINK), **PRICES)
    return jc, pc


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_chain_matches_jax(arch):
    jc, pc = _chains(arch)
    for name in ("uf", "ub", "wa", "wabar", "wdelta", "of", "ob"):
        np.testing.assert_array_equal(getattr(pc, name), getattr(jc, name),
                                      err_msg=name)
    assert pc.host == PHost(LINK)


@pytest.mark.parametrize("arch", ARCHS)
def test_plan_serving_matches_jax(arch):
    kw = {"moe_capacity_factor": 16.0}
    jcfg, pcfg = jsmoke(arch, **kw), psmoke(arch, **kw)
    total = sum(PLM(pcfg).cache_layout(B, MAX_LEN).block_bytes)
    for frac in (0.5, 2.0):
        budget = frac * total
        want = jplan_serving(jcfg, budget, batch=B, prompt_len=S0,
                             max_len=MAX_LEN, host=JHost(LINK))
        got = pplan_serving(pcfg, budget, batch=B, prompt_len=S0,
                            max_len=MAX_LEN, host=PHost(LINK), impl="plain",
                            **PRICES)
        assert got.schedule.ops == list(want.schedule.ops), frac
        assert got.tiers == "device+kv"
        assert got.budget_bytes == want.budget_bytes
        layers = pkv_layers(got, budget_bytes=budget)
        assert layers == jkv_layers(want, budget_bytes=budget), frac
        assert pkv_layers(got) == jkv_layers(want)
        if frac > 1:
            assert layers == []


def _serve_both(arch, policy):
    jm, jp, pm, pp, jcfg, pcfg = _pair(arch)
    prompts = _tokens(pcfg, (B, S0), seed=3)
    total = sum(pm.cache_layout(B, MAX_LEN).block_bytes)
    budget = 0.5 * total
    jkw, pkw = {}, {}
    if policy == "plan":
        jkw = dict(plan=jplan_serving(jcfg, budget, batch=B, prompt_len=S0,
                                      max_len=MAX_LEN, host=JHost(LINK)),
                   kv_budget=budget)
        pkw = dict(plan=pplan_serving(pcfg, budget, batch=B, prompt_len=S0,
                                      max_len=MAX_LEN, host=PHost(LINK),
                                      impl="plain", **PRICES),
                   kv_budget=budget)
    elif policy == "lru":
        jkw = dict(kv_policy="lru", kv_budget=budget, host=JHost(LINK))
        pkw = dict(kv_policy="lru", kv_budget=budget, host=PHost(LINK))
    want = jrun_serving(jcfg, jp, prompts, JLoop(max_new_tokens=6,
                                                 max_len=MAX_LEN),
                        model=jm, **jkw)
    got = run_serving(pcfg, pp, prompts, ServeLoopConfig(
        max_new_tokens=6, max_len=MAX_LEN), model=pm, device="cpu", **pkw)
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_matches_jax(arch):
    """Token-identical generations under each residency mode; the
    policies' transfer bytes, stall, hits and misses equal the JAX
    package's, event for event."""
    base = None
    for policy in ("none", "plan", "lru"):
        want, got = _serve_both(arch, policy)
        np.testing.assert_array_equal(got["generations"],
                                      want["generations"], err_msg=policy)
        base = got["generations"] if base is None else base
        np.testing.assert_array_equal(got["generations"], base)
        for key in ("decode_tokens", "kv_bytes", "kv_bytes_allocated"):
            assert got[key] == want[key], (policy, key)
        keys = {"none": (), "plan": (
            "kv_policy", "kv_host_layers", "kv_offload_bytes",
            "kv_prefetch_bytes", "kv_transfer_bytes", "kv_stall_s"),
            "lru": ("kv_policy", "kv_offload_bytes", "kv_prefetch_bytes",
                    "kv_transfer_bytes", "kv_stall_s", "kv_lru_hits",
                    "kv_lru_misses", "kv_budget_bytes")}[policy]
        for key in keys:
            assert got[key] == want[key], (policy, key)
        if policy == "plan":
            assert got["kv_host_layers"]
            planned = got
        if policy == "lru":
            assert 0 < planned["kv_transfer_bytes"] <= got["kv_transfer_bytes"]
            assert got["kv_stall_s"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_argument_errors(arch):
    _, _, pm, pp, _, pcfg = _pair(arch)
    loop = ServeLoopConfig(max_new_tokens=10, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        run_serving(pcfg, pp, np.zeros((1, 8), np.int32), loop, model=pm,
                    device="cpu")
    loop = ServeLoopConfig(max_new_tokens=3, max_len=8)
    prompts = np.zeros((1, 4), np.int32)
    plan = pplan_serving(pcfg, "x0.5", batch=1, prompt_len=4, max_len=8,
                         host=PHost(LINK), impl="plain")
    with pytest.raises(ValueError, match="not both"):
        run_serving(pcfg, pp, prompts, loop, model=pm, device="cpu",
                    plan=plan, kv_policy="lru", kv_budget=1.0)
    with pytest.raises(ValueError, match="kv_budget"):
        run_serving(pcfg, pp, prompts, loop, model=pm, device="cpu",
                    kv_policy="lru", host=PHost(LINK))
    with pytest.raises(ValueError, match="host="):
        run_serving(pcfg, pp, prompts, loop, model=pm, device="cpu",
                    kv_policy="lru", kv_budget=1.0)
    with pytest.raises(ValueError, match="unknown kv_policy"):
        run_serving(pcfg, pp, prompts, loop, model=pm, device="cpu",
                    kv_policy="fifo", kv_budget=1.0)
    with pytest.raises(TypeError):
        pkv_chain(pcfg, batch=1, prompt_len=4)        # no default link


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_attention_matches_jax(arch, monkeypatch):
    """Past ``DIRECT_ATTEND_MAX`` (set to 8 in both packages) attention runs
    in q blocks of 4 (``_attend`` for GQA and the Zamba2 shared block,
    ``_mla_attend`` for MLA): the full forward's logits match the JAX
    package's, and so do the loss's gradients through the blocks'
    checkpoints."""
    monkeypatch.setattr(jattn, "DIRECT_ATTEND_MAX", 8)
    monkeypatch.setattr(pattn, "DIRECT_ATTEND_MAX", 8)
    jm, jp, pm, pp, _, pcfg = _pair(arch, attn_block_q=4)
    toks = _tokens(pcfg, (B, 18), seed=4)
    want = jax.jit(jm.forward_logits)(jp, {"tokens": jnp.asarray(toks)})
    got = pm.forward_logits(pp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jgrads = jax.grad(jm.loss_fn)(jp, jax.tree.map(jnp.asarray, batch))
    loss = pm.loss_fn(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    got = torch.autograd.grad(loss, tensors_of(pp))
    _close_trees(params_to_numpy(with_tensors(pp, got)), jgrads, rtol=1e-4,
                 atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_the_cpu(arch, capsys, monkeypatch):
    out = serve_launcher.main(["--arch", arch, "--smoke", "--device", "cpu",
                               "--batch", "2", "--prompt-len", "8",
                               "--max-new-tokens", "4"])
    text = capsys.readouterr().out
    assert "prefill" in text and "tok/s" in text and "sample generation" \
        in text
    assert out["generations"].shape == (2, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_launcher.main(["--arch", arch, "--smoke"])
