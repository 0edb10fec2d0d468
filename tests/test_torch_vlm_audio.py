"""The port's VLM (paligemma-3b) and audio decoder (musicgen-medium) against
the JAX package's, in float32 on the CPU, with the same weights bridged
through numpy and inputs from a numpy seed: both configs field by field
(published depth's chunks and FLOPs, input specs), ``batch_at`` bit-equal,
loss and gradients, attention under the bidirectional image-prefix mask,
the head's FLOPs on the text positions, the rotor-planned and offload
steps equal to store-all, prefill and decode (a VLM prompt with its image
prefix; audio frames with their sinusoidal positions) against the JAX
package's, and Gemma's embedding scale in a text-only forward (the port
without it differs).

Tolerances as ``tests/test_torch_model.py`` states them: losses and
outputs rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 (float32 sums in another
order by two frameworks); prefill and decode rtol/atol 1e-4 and decode
against the full forward 2e-3, as ``tests/test_torch_serve.py``."""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.shapes import ShapeSpec as JShape  # noqa: E402
from repro.configs.shapes import input_specs as jinput_specs  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import flops as jflops  # noqa: E402
from repro.models.common import sinusoidal_positions as jsinus  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.bridge import (cache_to_numpy, params_from_numpy,  # noqa: E402
                                params_to_numpy)
from repro_torch.configs import get_config as pget  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core.rematerialize import count_checkpoint_scopes  # noqa: E402
from repro_torch.core.solver import solve_min_memory  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.data.pipeline import sequence_shape  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.steps import (make_train_step,  # noqa: E402
                                      measure_chain, plan_chain,
                                      plan_training)
from repro_torch.launch.tradeoff import run_lm_tradeoff  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402
from repro_torch.models import flops as pflops  # noqa: E402
from repro_torch.models.common import sinusoidal_positions  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime.train_loop import (TrainLoopConfig,  # noqa: E402
                                            run_training)
from repro_torch.tree import tensors_of, tree_map  # noqa: E402

VLM, AUDIO = "paligemma-3b", "musicgen-medium"
ARCHS = [VLM, AUDIO]
B, S = 2, 16            # S counts the VLM's image prefix (4 at smoke size)
MAX_LEN, N = 24, 4


def _same_value(p, j) -> bool:
    if isinstance(p, torch.dtype):
        return str(p).removeprefix("torch.") == jnp.dtype(j).name
    return p == j


def _pair(arch, **kw):
    """(JAX model, its params, port model, bridged params)."""
    jcfg, pcfg = jsmoke(arch, **kw), psmoke(arch, **kw)
    jm = JLM(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(1))
    pp = params_from_numpy(jax.tree.map(np.asarray, jp), pcfg, "cpu")
    return jm, jp, PLM(pcfg), pp


def _grads(loss, params):
    it = iter(torch.autograd.grad(loss, tensors_of(params)))
    return params_to_numpy(tree_map(lambda _: next(it), params))


def _assert_grads_close(got, want, **tol):
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, w in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_allclose(node, np.asarray(w), err_msg=str(path),
                                   **tol)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    for pc, jc in ((pget(arch), jget(arch)), (psmoke(arch), jsmoke(arch))):
        for f in dataclasses.fields(pc):
            assert _same_value(getattr(pc, f.name), getattr(jc, f.name)), \
                f.name
    jcfg, pcfg = jget(arch), pget(arch)
    assert pcfg.chunks == jcfg.chunks
    chain = plan_chain(PLM(pcfg), input_specs(
        pcfg, ShapeSpec("t", "train", 512, 1)), 1e15)
    assert chain.length + 1 == JLM(jcfg).n_stages() == len(jcfg.chunks) + 2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_jax(arch, kind):
    for cfg_of in (pget, psmoke):
        pcfg = cfg_of(arch)
        jcfg = (jget if cfg_of is pget else jsmoke)(arch)
        got = input_specs(pcfg, ShapeSpec("c", kind, 300, 3))
        want = jinput_specs(jcfg, JShape("c", kind, 300, 3))
        assert list(got) == list(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), k
            assert _same_value(got[k].dtype, w.dtype), k
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_flops_match_jax(arch):
    for pc, jc, shapes in ((pget(arch), jget(arch), ((2, 300), (4, 2048))),
                           (psmoke(arch), jsmoke(arch), ((2, 16), (3, 40)))):
        for b, s in shapes:
            assert pflops.stage_flops(pc, b, s) == jflops.stage_flops(jc, b,
                                                                      s)


def test_vlm_head_flops_count_text_positions():
    """The head runs on S - prefix_len positions: its FLOPs are the text
    config's at that length, the chunks' those at the whole length."""
    cfg = pget(VLM)
    text = dataclasses.replace(cfg, modality="text", prefix_len=0)
    fwd, bwd = pflops.stage_flops(cfg, 4, 2048)
    tfwd, tbwd = pflops.stage_flops(text, 4, 2048)
    assert fwd[:-1] == tfwd[:-1]
    assert fwd[-1] == 2 * 4 * (2048 - 256) * cfg.d_model * cfg.vocab_size
    assert fwd[-1] == pflops.stage_flops(text, 4, 2048 - 256)[0][-1]
    assert bwd[-1] == 2 * fwd[-1] and tbwd[-1] == 2 * tfwd[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_at_bit_equal(arch):
    for cfg_of, jcfg_of in ((psmoke, jsmoke), (pget, jget)):
        got = SyntheticLMData(cfg_of(arch), 2, 300, seed=3).batch_at(5)
        want = JData(jcfg_of(arch), 2, 300, seed=3).batch_at(5)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    P = pget(arch).prefix_len          # got: the published config's batch
    assert sequence_shape(got) == (2, 300)
    if arch == VLM:
        assert got["tokens"].shape == got["labels"].shape == (2, 300 - P)
        assert got["image_embeds"].shape == (2, P, pget(arch).d_model)
    else:
        assert got["embeds"].shape == (2, 300, pget(arch).d_model)
    dev = SyntheticLMData(pget(arch), 1, 300).device_batch(0, "cpu")
    for k, t in dev.items():
        want = torch.bfloat16 if k in ("embeds", "image_embeds") else None
        assert want is None or t.dtype == want, k


def test_sinusoidal_positions_match_jax():
    """Within two float32 ulps of the largest angle, position x 1 (the two
    frameworks' ``exp`` of the frequencies may differ by an ulp, which the
    position multiplies), + 1e-6."""
    for n, d, off in ((16, 64, 0), (1, 1536, 2047), (7, 10, 3)):
        got = sinusoidal_positions(n, d, offset=off)
        assert got.dtype == torch.float32 and got.shape == (n, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(jsinus(n, d, off)),
                                   rtol=0, atol=1e-6 + (off + n) * 2.0 ** -22)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_loss_and_gradients_match_jax(arch, remat):
    jm, jp, pm, pp = _pair(arch, scan_layer_remat=remat,
                           logits_chunk=8 if remat == "full" else 0)
    batch = JData(jm.cfg, B, S, seed=0).batch_at(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(jp, batch)
    loss = pm.loss_fn(pp, _torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    got = _grads(loss, pp)
    _assert_grads_close(got, jgrads, rtol=1e-4, atol=1e-5)
    if arch == AUDIO:
        assert pp["embed"] == {} and got["embed"] == {}
        assert jax.tree.map(np.asarray, jp)["embed"] == {}


@pytest.mark.parametrize("window", [None, 3])
def test_prefix_attention_matches_jax(window):
    """GQA under the bidirectional prefix mask (and a window), forward and
    gradients, against the JAX package's ``gqa_apply``."""
    jcfg, pcfg = jsmoke(VLM), psmoke(VLM)
    P = jcfg.prefix_len
    jp = jattn.gqa_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    pp = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(),
                  jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jspec = jattn.MaskSpec(causal=True, prefix_len=P, window=window)
    pspec = pattn.MaskSpec(causal=True, prefix_len=P, window=window)

    @jax.jit
    def forward_and_vjp(p, x_):
        out, vjp = jax.vjp(lambda p_, x__: jattn.gqa_apply(
            p_, jcfg, x__, jnp.asarray(pos), jspec), p, x_)
        return out, vjp(jnp.asarray(gy))

    want_y, (want_gp, want_gx) = forward_and_vjp(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = pattn.gqa_apply(pp, pcfg, xt, torch.from_numpy(pos.copy()), pspec)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    got = torch.autograd.grad(y, [xt] + tensors_of(pp),
                              torch.from_numpy(gy))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want_gx),
                               rtol=1e-4, atol=1e-5)
    it = iter(got[1:])
    _assert_grads_close(params_to_numpy(tree_map(lambda _: next(it), pp)),
                        want_gp, rtol=1e-4, atol=1e-5)
    # the prefix positions see each other: the first query attends to them
    causal = pattn.gqa_apply(pp, pcfg, xt, torch.from_numpy(pos.copy()),
                             pattn.MaskSpec(causal=True, window=window))
    assert not torch.allclose(causal[:, :P - 1], y[:, :P - 1])
    torch.testing.assert_close(causal[:, P:], y[:, P:])


def test_vlm_never_reaches_the_causal_flash_kernel(monkeypatch):
    """With ``use_flash_attention`` the image prefix's mask still takes the
    plain path in training and prefill, as the JAX package's does."""
    def refuse(*args):
        raise AssertionError("the causal flash kernel under a prefix mask")

    monkeypatch.setattr(flash_ops, "flash_attention", refuse)
    _, _, pm, pp = _pair(VLM, use_flash_attention=True)
    batch = _torch_batch(SyntheticLMData(pm.cfg, B, S).batch_at(0))
    assert torch.isfinite(pm.loss_fn(pp, batch))
    pm.prefill(pp, {k: batch[k] for k in ("image_embeds", "tokens")})
    # without the prefix (text-only serving) the kernel's path is taken
    text = PLM(dataclasses.replace(pm.cfg, modality="text", prefix_len=0))
    with pytest.raises(AssertionError, match="causal flash"):
        text.prefill(pp, {"tokens": batch["tokens"]})


def _jbatch(arch, cfg, seed, prompt_len, steps):
    """Prompt and fed inputs from numpy: ``(prompt, feed)`` where the feed
    is (B, steps, 1) tokens or (B, steps, 1, d) frames."""
    rng = np.random.default_rng(seed)
    if arch == AUDIO:
        prompt = {"embeds": rng.standard_normal(
            (B, prompt_len, cfg.d_model)).astype(np.float32)}
        feed = rng.standard_normal(
            (B, steps, 1, cfg.d_model)).astype(np.float32)
        return prompt, feed
    P = cfg.prefix_len
    prompt = {"image_embeds": rng.standard_normal(
        (B, P, cfg.d_model)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size,
                               (B, prompt_len - P)).astype(np.int32)}
    feed = rng.integers(0, cfg.vocab_size, (B, steps, 1)).astype(np.int32)
    return prompt, feed


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """The VLM's prompt with its image prefix, then token steps; MusicGen's
    frames, then frame steps with the sinusoidal code of each position."""
    jm, jp, pm, pp = _pair(arch)
    S0 = 10
    prompt, feed = _jbatch(arch, jm.cfg, 0, S0, N)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in prompt.items()}, MAX_LEN)
    pl, pc = pm.prefill(pp, _torch_batch(prompt), max_len=MAX_LEN)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    assert pc["pos"] == S0
    jdecode = jax.jit(jm.decode_step)
    for t in range(N):
        jl, jc = jdecode(jp, jc, jnp.asarray(feed[:, t]))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(feed[:, t]))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"decode step {t}")
    got = cache_to_numpy(pc, pm.cfg)
    want = jax.tree.map(np.asarray, jc)
    assert int(got["pos"]) == int(want["pos"]) == S0 + N
    for g, w in zip(got["chunks"], want["chunks"]):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_logits(arch):
    _, _, pm, pp = _pair(arch)
    S0 = 9
    prompt, feed = _jbatch(arch, pm.cfg, 2, S0, N)
    whole = dict(prompt)
    key = "embeds" if arch == AUDIO else "tokens"
    whole[key] = np.concatenate(
        [prompt[key]] + [feed[:, t] for t in range(N)], axis=1)
    ref = pm.forward_logits(pp, _torch_batch(whole))
    assert ref.shape[1] == S0 + N
    logits, cache = pm.prefill(pp, _torch_batch(prompt), max_len=S0 + N)
    np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, S0 - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    for t in range(N - 1):
        logits, cache = pm.decode_step(pp, cache,
                                       torch.from_numpy(feed[:, t]))
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   ref[:, S0 + t].numpy(), rtol=2e-3,
                                   atol=2e-3)
    picked = pm.forward_logits(pp, _torch_batch(whole), at=[S0 - 1, S0 + 1])
    np.testing.assert_allclose(picked.numpy(), ref[:, [S0 - 1, S0 + 1]],
                               rtol=1e-6, atol=1e-6)


def test_text_only_paligemma_needs_the_embedding_scale():
    """Gemma's decoder served text-only (as both launchers serve a VLM):
    forward, prefill and decode equal the JAX package's, and the same
    forward without ``embed_scale`` does not."""
    kw = dict(modality="text", prefix_len=0)
    jm, jp, pm, pp = _pair(VLM, **kw)
    assert pm.cfg.embed_scale and jm.cfg.embed_scale
    toks = np.random.default_rng(4).integers(
        0, pm.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    want = np.asarray(jax.jit(jm.forward_logits)(
        jp, {"tokens": jnp.asarray(toks[:, :S])}))
    got = pm.forward_logits(pp, {"tokens": torch.from_numpy(toks[:, :S])})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    unscaled = PLM(dataclasses.replace(pm.cfg, embed_scale=False))
    off = unscaled.forward_logits(pp, {"tokens": torch.from_numpy(
        toks[:, :S])}).numpy()
    assert not np.allclose(off, want, rtol=1e-3, atol=1e-3)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks[:, :S])}, S + 1)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S])},
                        max_len=S + 1)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    jl, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(toks[:, S:]))
    pl, _ = pm.decode_step(pp, pc, torch.from_numpy(toks[:, S:]))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def _plan(pm, pcfg, frac=0.5):
    """A rotor plan between the analytic chain's floor and store-all."""
    chain = plan_chain(pm, input_specs(pcfg, ShapeSpec("t", "train", S, B)),
                       1e12)
    low, high = solve_min_memory(chain).mem_limit, chain.store_all_peak()
    plan, _ = plan_training(pm, None, f"rotor:{int(low + frac * (high - low))}",
                            chain=chain)
    return plan


@pytest.mark.parametrize("arch", ARCHS)
def test_rotor_step_equals_store_all(arch):
    """The nested checkpoints of a rotor plan give store-all's loss and
    gradients; the audio chain's first stage has no parameters and an
    input that needs no gradient."""
    kw = dict(num_layers=4, layer_kinds=("dense",) * 4, n_chunks=4,
              scan_layer_remat="full")
    jm, jp, pm, pp = _pair(arch, **kw)
    plan = _plan(pm, pm.cfg)
    assert count_checkpoint_scopes(plan.tree) > 0
    batch = _torch_batch(JData(jm.cfg, B, S, seed=1).batch_at(0))
    want = pm.loss_fn(pp, batch)
    wgrads = _grads(want, pp)
    got = pm.loss_fn(pp, batch, tree=plan.tree)
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)
    ggrads = _grads(got, pp)
    _assert_grads_close(ggrads, wgrads, rtol=1e-5, atol=1e-7)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss_fn))(
        jp, JData(jm.cfg, B, S, seed=1).batch_at(0))
    np.testing.assert_allclose(got.item(), float(jloss), rtol=1e-5)
    _assert_grads_close(ggrads, jgrads, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_policies_agree(arch):
    """``run_training`` under store-all, rotor and (the audio chain copies
    its frame embeddings, ``a^0``) the offload walker: the same losses."""
    cfg = psmoke(arch, num_layers=4, layer_kinds=("dense",) * 4, n_chunks=4,
                 scan_layer_remat="full")
    loop = dict(steps=2, global_batch=B, seq_len=S, peak_flops=1e12)
    ref = run_training(cfg, TrainLoopConfig(**loop, policy="none"),
                       device="cpu", log_fn=lambda s: None)
    chain = plan_chain(PLM(cfg), input_specs(
        cfg, ShapeSpec("t", "train", S, B)), 1e12)
    low = solve_min_memory(chain).mem_limit
    pols = [f"rotor:{int((low + chain.store_all_peak()) / 2)}"]
    if arch == AUDIO:
        pols.append(f"optimal_offload:{int(0.9 * low)}:1e9")
    for pol in pols:
        out = run_training(cfg, TrainLoopConfig(**loop, policy=pol),
                           device="cpu", log_fn=lambda s: None)
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-5)
        if pol.startswith("optimal_offload"):
            assert out["plan"].uses_offload
            assert ("Foff", 0) in out["plan"].schedule.ops
        assert out["steps"][0]["tokens_per_s"] == pytest.approx(
            B * S / out["steps"][0]["seconds"])


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_accum_splits_the_batch(arch):
    """Microbatches split along the batch whatever input it holds."""
    _, _, pm, pp = _pair(arch)
    batch = _torch_batch(SyntheticLMData(pm.cfg, 4, S).batch_at(0))
    leaves = tensors_of(pp)
    out = {}
    for accum in (1, 2):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(), pp)
        state = adamw_init(tensors_of(params))
        m = make_train_step(pm, AdamWConfig(lr=1e-3), None,
                            grad_accum=accum)(params, state, batch, 0)
        out[accum] = (float(m["loss"]), tensors_of(params))
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-5)
    for a, b in zip(out[2][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert len(leaves) == len(out[1][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_measured_chain_sizes_equal_the_analytic(arch):
    cfg = psmoke(arch)
    model = PLM(cfg)
    params = model.init(0, "cpu")
    batch = SyntheticLMData(cfg, B, S).device_batch(0, "cpu")
    measured = measure_chain(model, params, batch, repeats=1)
    analytic = plan_chain(model, input_specs(
        cfg, ShapeSpec("t", "train", S, B)), 1e12)
    np.testing.assert_array_equal(measured.wa, analytic.wa)
    np.testing.assert_array_equal(measured.wabar, analytic.wabar)
    if arch == AUDIO:       # the embed stage has no backward to time
        assert measured.ub[0] == 0.0


def test_tradeoff_counts_every_position():
    cfg = psmoke(AUDIO, num_layers=2, layer_kinds=("dense",) * 2,
                 n_chunks=2)
    model = PLM(cfg)
    batch = SyntheticLMData(cfg, B, S).device_batch(0, "cpu")
    lines = []
    out = run_lm_tradeoff(model, model.init(0, "cpu"), batch, budgets=(1.0,),
                          impl="plain", repeats=1, emit=lines.append)
    assert out["rows"] and lines
    for r in out["rows"]:     # items: the B x S frames
        assert r["items_per_s"] == pytest.approx(B * S / r["measured_s"])
    assert sequence_shape({"image_embeds": np.zeros((3, 4, 8)),
                           "tokens": np.zeros((3, 12))}) == (3, 16)


def test_launchers_on_the_cpu(capsys):
    for arch in ARCHS:
        out = train_launcher.main([
            "--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--global-batch", "2", "--seq-len", "16", "--policy",
            "rotor:x0.9", "--peak-flops", "1e12"])
        assert len(out["losses"]) == 2
        assert all(np.isfinite(out["losses"]))
    assert serve_launcher.main(["--arch", AUDIO, "--smoke", "--device",
                                "cpu"]) is None
    out = serve_launcher.main(["--arch", VLM, "--smoke", "--device", "cpu",
                               "--max-new-tokens", "4"])
    assert out["generations"].shape == (4, 4)
    text = capsys.readouterr().out
    assert "audio arch: skipping" in text and "text-only" in text
