"""Model-axis tensor parallelism and serving under a mesh, on the CPU over
gloo at float32, held against the single-process port and the JAX package:

- training at meshes (1, 2) and (2, 2) for small-width Qwen (GQA and the
  vocab-parallel head, with and without ``logits_chunk``), MusicGen (gelu
  MLP, audio frames), PaliGemma (MQA: one KV head the two model ranks both
  slice, the image prefix), deepseek-v2-lite (MLA with expert parallelism)
  and Zamba2 (the split Mamba2 mixer and the shared block): 3 AdamW steps
  of ``run_training(mesh=)`` give the single-process run's losses (rtol
  1e-5), and the first step's gradient of every parameter equals the
  single-process one (rtol 1e-4 / atol 1e-6); the single-process losses
  equal the JAX package's train step on the same weights (rtol 1e-4);
- every gradient of a leaf replicated on the model axis (norm scales,
  MLA's latent projection, the router, the conv) is equal on the model
  ranks;
- a block's saved-for-backward q / k / v, attention output, MLP hidden and
  SSM ``x`` are cut by the model axis: their whole shapes never appear
  under tensor parallelism, their shares do;
- decode on a mesh, Zamba2 at batch 1: ``DECODE_RULES`` at (1, 2) (the
  KV sequence on the model axis) and ``LONG_CONTEXT_RULES`` at (2, 2) (on
  the data and model axes): the greedy tokens equal the single-process
  decode's and the JAX package's ``decode_step``'s, each rank's cache is
  ``spec_for``'s shard of the single-process cache, and ``run_serving``
  on the mesh gives the same tokens;
- ``model_slice`` agrees with ``spec_for``; at model axis 1 every operator
  is the identity and issues nothing; a checkpoint's recompute on another
  thread runs under its first run's mesh; a residency plan or policy on a
  mesh raises.

deepseek-v2-lite runs at capacity factor 8 (no pair dropped, as
``tests/test_torch_moe_ep.py``), and at (2, 2) without the Switch aux term:
the expert dispatch, and so the capacity and the aux loss, are per data
group there, as in the JAX package, so they differ from one process's by
design.  The checks share two spawned process groups, run once for the
module with a timeout: world 2 (mesh (1, 2)) and world 4 (mesh (2, 2)).
The JAX package runs in this process only."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.distributed.local import run_local  # noqa: E402

B, S, STEPS, LR = 4, 16, 3, 1e-3
TIMEOUT = 240.0
SHAPES = [(1, 2), (2, 2)]
# name -> (arch, overrides shared with the JAX config, port-only flags)
CASES = {
    "qwen": ("qwen1.5-4b", {}, {"use_flash_attention": True}),
    "qwen-chunked": ("qwen1.5-4b", {"logits_chunk": 16},
                     {"use_flash_attention": True}),
    "musicgen": ("musicgen-medium", {}, {"use_flash_attention": True}),
    "paligemma": ("paligemma-3b", {}, {}),
    "deepseek": ("deepseek-v2-lite-16b", {"moe_capacity_factor": 8.0}, {}),
    "zamba2": ("zamba2-2.7b", {}, {"use_flash_attention": True,
                                   "use_ssd_kernel": True}),
}
DECODE_ARCH, PROMPT, NEW, MAX_LEN = "zamba2-2.7b", 8, 4, 16


def _overrides(name, shape):
    arch, both, port = CASES[name]
    both = dict(both)
    if name == "deepseek" and shape[0] > 1:
        both["moe_aux_loss"] = 0.0
    return arch, both, port


def _ref_key(name, shape):
    return (name, shape[0] > 1) if name == "deepseek" else (name, False)


def _cfg(name, shape):
    arch, both, port = _overrides(name, shape)
    return smoke_config(arch, **both, **port)


def _loop(**kw):
    from repro_torch.runtime.train_loop import TrainLoopConfig

    base = dict(steps=STEPS, global_batch=B, seq_len=S, lr=LR, warmup=1,
                policy="rotor:x0.8", solver_impl="plain", peak_flops=1e12,
                log_every=100)
    base.update(kw)
    return TrainLoopConfig(**base)


def _weights(cfg):
    from repro_torch.bridge import params_to_numpy
    from repro_torch.models.lm import StagedLM

    return params_to_numpy(StagedLM(cfg).init(0, "cpu"))


def _numpy(tree):
    from repro_torch.distributed.sharding import full_value
    from repro_torch.tree import leaves_with_paths

    return {k: full_value(v).detach().float().numpy()
            for k, v in leaves_with_paths(tree)
            if isinstance(v, torch.Tensor)}


# -- the ranks -----------------------------------------------------------------------

def _train_case(name, shape, weights):
    """One rank of a training case: 3 steps of ``run_training(mesh=)``, the
    first step's gradients (whole) and this rank's gradients of the leaves
    the model axis replicates."""
    from torch.distributed.tensor import Replicate

    from repro_torch.bridge import params_from_numpy
    from repro_torch.distributed.sharding import (axis_rules, data_position,
                                                  make_mesh)
    from repro_torch.launch.steps import shard_tree
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.train_loop import run_training
    from repro_torch.tree import leaves_with_paths, tensors_of, with_tensors

    cfg = _cfg(name, shape)
    mesh = make_mesh(shape, "cpu")
    dp, index = data_position(mesh)
    per = 2 // dp
    model = StagedLM(cfg)
    model.gather = model.gather_modes(mesh)
    params = shard_tree(params_from_numpy(weights, cfg, "cpu"),
                        model.param_axes(), mesh)
    batch = SyntheticLMData(cfg, B, S, host_index=index * per, host_count=2,
                            hosts=per).device_batch(0, "cpu")
    leaves = tensors_of(params)
    with axis_rules(mesh):
        grads = torch.autograd.grad(model.loss_fn(params, batch) / dp, leaves)
    gtree = with_tensors(params, grads)
    model_dim = mesh.mesh_dim_names.index("model")
    replicated = {k: g.to_local().detach().numpy().copy()
                  for (k, g), p in zip(leaves_with_paths(gtree), leaves)
                  if isinstance(p.placements[model_dim], Replicate)}
    out = run_training(cfg, _loop(data_hosts_per_process=per), device="cpu",
                       mesh=mesh, params=params_from_numpy(weights, cfg,
                                                           "cpu"),
                       log_fn=lambda *_: None)
    return {"losses": out["losses"], "grads": _numpy(gtree),
            "replicated": replicated, "comm": out["collective_bytes"],
            "coords": (mesh.get_local_rank("data"),
                       mesh.get_local_rank("model"))}


def _saved_shapes(fn, *args):
    """The shapes of every tensor autograd saves in ``fn(*args)``."""
    shapes = set()

    def pack(t):
        shapes.add(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    return shapes


def _activation_shapes(name, shape, weights):
    """The shapes saved for the backward by the first layer of chunk 0,
    split at ``shape`` and in one process."""
    import functools

    from repro_torch.bridge import params_from_numpy
    from repro_torch.distributed.sharding import axis_rules, make_mesh
    from repro_torch.launch.steps import serving_params
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    cfg = _cfg(name, shape)
    mesh = make_mesh(shape, "cpu")
    model = lm.StagedLM(cfg)
    kind = cfg.chunks[0][0]
    h = torch.randn((B, S, cfg.d_model), generator=torch.Generator(
    ).manual_seed(0), requires_grad=True)
    fn = functools.partial(lm._apply_block, cfg=cfg, kind=kind,
                           mask=lm._train_mask(cfg), positions=torch.arange(
                               S, dtype=torch.int32)[None].expand(B, S))
    full = params_from_numpy(weights, cfg, "cpu")

    def layer(p):
        return tree_map(lambda t: t[0].detach().requires_grad_(),
                        p["chunks"][0])

    with axis_rules(mesh):
        tp_shapes = _saved_shapes(fn, layer(serving_params(model, full,
                                                           mesh)), h)
    return {"tp": tp_shapes, "whole": _saved_shapes(fn, layer(full), h)}


def _decode_case(shape, rules_name, weights, prompts):
    """One rank of the sharded decode: prefill and greedy decode through
    ``make_prefill_step`` / ``make_serve_step``, then ``run_serving`` on
    the same mesh."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          serving_params)
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.serve_loop import ServeLoopConfig, run_serving

    rules = getattr(shd, rules_name)
    cfg = smoke_config(DECODE_ARCH, use_flash_attention=True,
                       use_ssd_kernel=True)
    mesh = shd.make_mesh(shape, "cpu")
    model = StagedLM(cfg)
    full = params_from_numpy(weights, cfg, "cpu")
    params = serving_params(model, full, mesh)
    prefill, step = (make_prefill_step(model, mesh, rules),
                     make_serve_step(model, mesh, rules))
    logits, cache = prefill(params, {"tokens": torch.from_numpy(prompts)},
                            MAX_LEN)
    tokens = [logits[:, -1].argmax(-1)]
    for _ in range(NEW - 1):
        logits, cache = step(params, cache, tokens[-1][:, None])
        tokens.append(logits[:, -1].argmax(-1))
    served = run_serving(cfg, full, prompts, ServeLoopConfig(
        max_new_tokens=NEW, max_len=MAX_LEN), model=model, device="cpu",
        mesh=mesh, rules=rules)
    return {"tokens": torch.stack(tokens, 1).numpy(),
            "cache": {f"{k}/{i}/{n}": t.float().numpy()
                      for k in ("layers", "shared")
                      for i, c in enumerate(cache[k]) for n, t in c.items()},
            "served": served["generations"],
            "kv_bytes_local": served["kv_bytes_local"],
            "coords": {a: mesh.get_local_rank(a) for a in ("data", "model")}}


def _group_rank(rank, world, shape, weights, decode, jobs):
    out = {"train": {name: _train_case(name, shape, weights[_ref_key(
        name, shape)]) for name in CASES}}
    for name in jobs:
        out[name] = _activation_shapes(name, shape, weights[_ref_key(
            name, shape)])
    if decode is not None:
        out["decode"] = _decode_case(shape, *decode)
    return out


# -- the references, in this process -------------------------------------------------

def _single_process(name, shape, weights):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.lm import StagedLM
    from repro_torch.runtime.train_loop import run_training
    from repro_torch.tree import tensors_of, with_tensors

    cfg = _cfg(name, shape)
    model = StagedLM(cfg)
    params = params_from_numpy(weights, cfg, "cpu")
    batch = SyntheticLMData(cfg, B, S, host_count=2, hosts=2
                            ).device_batch(0, "cpu")
    leaves = tensors_of(params)
    grads = torch.autograd.grad(model.loss_fn(params, batch), leaves)
    out = run_training(cfg, _loop(data_hosts_per_process=2,
                                  data_host_count=2, data_host_index=0),
                       device="cpu", params=params_from_numpy(weights, cfg,
                                                              "cpu"),
                       log_fn=lambda *_: None)
    return {"losses": out["losses"],
            "grads": _numpy(with_tensors(params, grads))}


def _jax_losses(name, shape, weights):
    """3 AdamW steps of the JAX package's train step on the same weights
    and batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.launch.steps import make_train_step as jstep
    from repro.models.lm import StagedLM as JLM
    from repro.optim.adamw import AdamWConfig as JAdam
    from repro.optim.adamw import adamw_init as jadam_init
    from repro.optim.schedules import linear_warmup_cosine as jlr

    arch, both, _ = _overrides(name, shape)
    data = SyntheticLMData(_cfg(name, shape), B, S, host_count=2, hosts=2)
    fn = jax.jit(jstep(JLM(jsmoke(arch, **both)), JAdam(lr=LR), None,
                       jlr(LR, 1, STEPS)))
    p = jax.tree.map(jnp.asarray, weights)
    o = jadam_init(p)
    losses = []
    for step in range(STEPS):
        p, o, m = fn(p, o, jax.tree.map(jnp.asarray, data.batch_at(step)),
                     jnp.asarray(step, jnp.int32))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def weights():
    keys = {_ref_key(n, s) for n in CASES for s in SHAPES}
    return {key: _weights(_cfg(key[0], (2, 2) if key[1] else (1, 2)))
            for key in keys}


@pytest.fixture(scope="module")
def references(weights):
    return {key: _single_process(key[0], (2, 2) if key[1] else (1, 2), w)
            for key, w in weights.items()}


def _prompts():
    return np.random.default_rng(7).integers(
        0, 256, size=(1, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def decode_weights():
    return _weights(smoke_config(DECODE_ARCH))


@pytest.fixture(scope="module")
def groups(weights, decode_weights):
    prompts = _prompts()
    world2 = run_local(_group_rank, 2, ((1, 2), weights, (
        "DECODE_RULES", decode_weights, prompts), ("qwen", "zamba2")),
        timeout=TIMEOUT)
    world4 = run_local(_group_rank, 4, ((2, 2), weights, (
        "LONG_CONTEXT_RULES", decode_weights, prompts), ()),
        timeout=TIMEOUT)
    return {(1, 2): world2, (2, 2): world4}


# -- training ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=["model2", "data2-model2"])
@pytest.mark.parametrize("name", list(CASES))
def test_tp_losses_match_single_process(groups, references, name, shape):
    want = references[_ref_key(name, shape)]["losses"]
    for r in groups[shape]:
        got = r["train"][name]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        # the blocks ran split: the model group reduced their outputs
        assert got["comm"]["calls"].get("tp_all_reduce"), got["comm"]


@pytest.mark.parametrize("shape", SHAPES, ids=["model2", "data2-model2"])
@pytest.mark.parametrize("name", list(CASES))
def test_tp_gradients_match_single_process(groups, references, name, shape):
    want = references[_ref_key(name, shape)]["grads"]
    for r in groups[shape]:
        got = r["train"][name]["grads"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("shape", SHAPES, ids=["model2", "data2-model2"])
@pytest.mark.parametrize("name", list(CASES))
def test_replicated_gradients_equal_across_model_ranks(groups, name, shape):
    ranks = [r["train"][name] for r in groups[shape]]
    by_data = {}
    for r in ranks:
        by_data.setdefault(r["coords"][0], []).append(r["replicated"])
    for members in by_data.values():
        assert len(members) == shape[1] and members[0]
        for other in members[1:]:
            assert other.keys() == members[0].keys()
            for k, g in members[0].items():
                np.testing.assert_array_equal(other[k], g, err_msg=k)


@pytest.mark.parametrize("key", sorted({_ref_key(n, s) for n in CASES
                                        for s in SHAPES}),
                         ids=lambda k: f"{k[0]}{'-noaux' if k[1] else ''}")
def test_single_process_matches_jax(references, weights, key):
    shape = (2, 2) if key[1] else (1, 2)
    np.testing.assert_allclose(references[key]["losses"],
                               _jax_losses(key[0], shape, weights[key]),
                               rtol=1e-4)


@pytest.mark.parametrize("name,whole,share", [
    ("qwen", "q", lambda c: (B, S, c.n_heads // 2, c.head_dim)),
    ("qwen", "mlp", lambda c: (B, S, c.d_ff // 2)),
    ("zamba2", "ssm_x", lambda c: (B, S, 2 * c.d_model // c.ssm_head_dim // 2,
                                   c.ssm_head_dim)),
], ids=["attention", "mlp", "ssm"])
def test_block_activations_are_split(groups, name, whole, share):
    cfg = _cfg(name, (1, 2))
    full = {"q": (B, S, cfg.n_heads, cfg.head_dim),
            "mlp": (B, S, cfg.d_ff),
            "ssm_x": (B, S, 2 * cfg.d_model // cfg.ssm_head_dim,
                      cfg.ssm_head_dim)}[whole]
    for r in groups[(1, 2)]:
        got = r[name]
        assert full in got["whole"], (whole, sorted(got["whole"]))
        assert full not in got["tp"], (whole, sorted(got["tp"]))
        assert share(cfg) in got["tp"], (whole, sorted(got["tp"]))


# -- serving on a mesh ---------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_reference(decode_weights):
    """The single-process decode and the JAX package's, on the same
    weights and prompt."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.models.lm import StagedLM as JLM
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models.lm import StagedLM

    prompts = _prompts()
    cfg = smoke_config(DECODE_ARCH, use_flash_attention=True,
                       use_ssd_kernel=True)
    model = StagedLM(cfg)
    params = params_from_numpy(decode_weights, cfg, "cpu")
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
        prompts)}, max_len=MAX_LEN)
    tokens = [logits[:, -1].argmax(-1)]
    for _ in range(NEW - 1):
        logits, cache = model.decode_step(params, cache, tokens[-1][:, None])
        tokens.append(logits[:, -1].argmax(-1))
    jm = JLM(jsmoke(DECODE_ARCH))
    jp = jax.tree.map(jnp.asarray, decode_weights)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(prompts)}, MAX_LEN)
    jdecode = jax.jit(jm.decode_step)
    jtok = [np.asarray(jnp.argmax(jl[:, -1], -1))]
    for _ in range(NEW - 1):
        jl, jc = jdecode(jp, jc, jnp.asarray(jtok[-1])[:, None])
        jtok.append(np.asarray(jnp.argmax(jl[:, -1], -1)))
    return {"tokens": torch.stack(tokens, 1).numpy(),
            "jax": np.stack(jtok, 1), "cache": cache, "model": model}


@pytest.mark.parametrize("shape", SHAPES, ids=["decode-rules",
                                               "long-context-rules"])
def test_sharded_decode_matches(groups, decode_reference, shape):
    want = decode_reference["tokens"]
    np.testing.assert_array_equal(decode_reference["jax"], want)
    for r in groups[shape]:
        np.testing.assert_array_equal(r["decode"]["tokens"], want)
        np.testing.assert_array_equal(r["decode"]["served"], want)


@pytest.mark.parametrize("shape", SHAPES, ids=["decode-rules",
                                               "long-context-rules"])
def test_sharded_cache_is_spec_shard(groups, decode_reference, shape):
    from repro_torch.distributed import sharding as shd

    rules = shd.DECODE_RULES if shape == (1, 2) else shd.LONG_CONTEXT_RULES
    mesh = SimpleNamespace(shape={"data": shape[0], "model": shape[1]})
    model, cache = decode_reference["model"], decode_reference["cache"]
    axes = model.cache_axes()
    whole_bytes = sum(t.numel() * t.element_size() for k in ("layers",
                                                             "shared")
                      for c in cache[k] for t in c.values())
    cut = 0
    for r in groups[shape]:
        coords = r["decode"]["coords"]
        for k in ("layers", "shared"):
            for i, c in enumerate(cache[k]):
                for n, t in c.items():
                    part = t.float().numpy()
                    spec = shd.spec_for(axes[k][i][n], t.shape, mesh, rules)
                    for dim, entry in enumerate(spec):
                        if entry is None:
                            continue
                        names = entry if isinstance(entry, tuple) else (entry,)
                        count, index = 1, 0
                        for a in names:
                            count *= shape[["data", "model"].index(a)]
                            index = (index * shape[["data", "model"].index(a)]
                                     + coords[a])
                        part = np.split(part, count, axis=dim)[index]
                        cut += dim == 1
                    np.testing.assert_allclose(
                        r["decode"]["cache"][f"{k}/{i}/{n}"], part,
                        rtol=1e-5, atol=1e-6, err_msg=f"{k}/{i}/{n}")
        assert r["decode"]["kv_bytes_local"] < whole_bytes
    assert cut > 0     # some cache is cut along its sequence


def test_cache_bytes_split_by_the_ranks(groups):
    """Under ``DECODE_RULES`` at (1, 2) the two ranks' caches hold the
    whole one between them, each its half."""
    from repro_torch.models.lm import StagedLM

    model = StagedLM(smoke_config(DECODE_ARCH))
    spec = model.init_cache(1, MAX_LEN, device="meta")
    whole = sum(t.numel() * t.element_size() for k in ("layers", "shared")
                for c in spec[k] for t in c.values())
    got = [r["decode"]["kv_bytes_local"] for r in groups[(1, 2)]]
    assert got == [whole // 2, whole // 2]


# -- the operators -------------------------------------------------------------------

def test_model_slice_agrees_with_spec_for():
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp

    for size in (1, 2, 4):
        for rank in range(size):
            mesh = SimpleNamespace(
                shape={"data": 1, "model": size}, get_group=lambda a: None,
                get_local_rank=lambda a, r=rank: r if a == "model" else 0)
            for n in (6, 8, 12, 20, 7):
                spec = shd.spec_for(("heads",), (n,), mesh)
                start, stop = tp.model_slice(n, mesh)
                if spec[0] is None:
                    assert (start, stop) == (0, n)
                else:
                    blocks = np.array_split(np.arange(n), size)
                    assert list(range(start, stop)) == list(blocks[rank])


def test_operators_are_identity_at_model_axis_1():
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed import tensor_parallel as tp

    mesh = SimpleNamespace(shape={"data": 2, "model": 1})
    x = torch.randn(3, 4, requires_grad=True)
    shd.reset_collectives()
    with shd.axis_rules(mesh):
        assert tp.model_axis() is None
        axis = tp.model_axis()
        y = tp.reduce_from_model(tp.copy_to_model(x, axis), axis)
        y = tp.scatter_to_model(tp.gather_from_model(y, 1, axis), 1, axis)
        assert y is x
        assert tp.split_by(4, 4) is None
        assert tp.model_slice(8) == (0, 8)
        with pytest.raises(ValueError, match="not one rank's share"):
            tp.split_by(2, 4)
    assert shd.collectives() == {"calls": {}, "bytes": {}}


def test_recompute_runs_under_the_first_runs_mesh_on_another_thread():
    """A checkpoint's recompute runs the split blocks again on autograd's
    backward thread (its own on CUDA): it sees the mesh and rules its first
    run saw, and leaves that thread's stack as it found it."""
    import threading

    from repro_torch.core.rematerialize import remat
    from repro_torch.distributed import sharding as shd

    mesh = SimpleNamespace(shape={"data": 1, "model": 2})
    seen, after, errors = [], [], []

    def fn(x):
        seen.append((shd.current_mesh(), shd.current_rules()))
        return x.sin()

    x = torch.ones(3, requires_grad=True)
    with shd.axis_rules(mesh, shd.DECODE_RULES):
        y = remat(fn, x).sum()

    def backward():
        try:
            y.backward()
            after.append(shd.current_mesh())
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert not errors, errors
    assert after == [None] and shd.current_mesh() is None
    assert [m for m, _ in seen] == [mesh, mesh]
    assert all(r == dict(shd.DECODE_RULES) for _, r in seen)
    torch.testing.assert_close(x.grad, torch.ones(3).cos())


def test_residency_on_a_mesh_raises():
    from repro_torch.runtime.serve_loop import ServeLoopConfig, run_serving

    cfg = smoke_config(DECODE_ARCH)
    with pytest.raises(NotImplementedError, match="no KV residency on a mesh"):
        run_serving(cfg, {}, _prompts(), ServeLoopConfig(max_len=MAX_LEN),
                    device="cpu", kv_policy="lru", kv_budget=1.0,
                    mesh=SimpleNamespace(shape={"data": 1, "model": 2}))
