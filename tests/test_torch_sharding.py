"""Logical-axis sharding in the port against the JAX package, on duck-typed
meshes (``SimpleNamespace(shape={...})``, as
``tests/test_sharding_and_plan.py`` uses them): every parameter of all ten
archs (at their published sizes, shapes from ``meta`` tensors and
``jax.eval_shape``) has the same logical axes in ``StagedLM.param_axes``
and resolves to the same partition spec and shard factor under meshes
(1, 1), (2, 1), (1, 2), (2, 2) and (4, 2) and all three rule tables; the
mesh terms of planning (``plan_chain``'s per-device sizes) equal the JAX
``plan_chain``'s on the same mesh; ``placements_for`` turns a spec into
DTensor placements (checked on a mesh stand-in); and the decode cache's
logical axes (``StagedLM.cache_axes``, one dict per layer and per shared
invocation) are the JAX package's per-chunk ones without their stacked
dimension, for all ten archs."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.archs import ARCHS  # noqa: E402
from repro.configs.shapes import ShapeSpec as JShape  # noqa: E402
from repro.configs.shapes import input_specs as jinput_specs  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch.mesh import PEAK_FLOPS_BF16  # noqa: E402
from repro.launch.steps import batch_axes as jbatch_axes  # noqa: E402
from repro.launch.steps import plan_chain as jplan_chain  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.configs import get_config as pget  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.distributed import sharding as pshd  # noqa: E402
from repro_torch.launch.steps import axes_at, batch_axes, plan_chain  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]
RULES = {"default": (jshd.DEFAULT_RULES, pshd.DEFAULT_RULES),
         "decode": (jshd.DECODE_RULES, pshd.DECODE_RULES),
         "long_context": (jshd.LONG_CONTEXT_RULES, pshd.LONG_CONTEXT_RULES)}


def _mesh(shape):
    return SimpleNamespace(shape={"data": shape[0], "model": shape[1]})


def _jax_leaves(arch):
    """``{port path: (shape, logical axes)}`` of the JAX package's params."""
    model = JLM(jget(arch))
    spec = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    sflat = jax.tree_util.tree_flatten_with_path(spec)[0]
    aflat = jax.tree_util.tree_flatten_with_path(
        model.param_axes(), is_leaf=lambda x: isinstance(x, tuple))[0]
    assert len(sflat) == len(aflat)
    out = {}
    for (path, leaf), (apath, ax) in zip(sflat, aflat):
        assert path == apath
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), tuple(ax))
    return out


def test_rule_tables_match():
    for jr, pr in RULES.values():
        assert jr == pr


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_axes_and_specs_match_jax(arch):
    want = _jax_leaves(arch)
    model = PLM(pget(arch))
    axes = model.param_axes()
    got = {k: (tuple(v.shape), axes_at(axes, k))
           for k, v in leaves_with_paths(model.init(device="meta"))}
    assert got == want
    for shape in MESHES:
        mesh = _mesh(shape)
        for jr, pr in RULES.values():
            for path, (dims, ax) in want.items():
                jspec = tuple(jshd.spec_for(ax, dims, mesh, jr))
                assert pshd.spec_for(ax, dims, mesh, pr) == jspec, (
                    path, shape)
                with jshd.axis_rules(mesh, jr):
                    jf = jshd.shard_factor(*ax, shape=dims)
                with pshd.axis_rules(mesh, pr):
                    assert pshd.shard_factor(*ax, shape=dims) == jf, (
                        path, shape)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "musicgen-medium",
                                  "paligemma-3b"])
def test_batch_axes_match_jax(arch):
    for kind in ("train", "prefill", "decode"):
        assert batch_axes(pget(arch), kind) == jbatch_axes(jget(arch), kind)


@pytest.mark.parametrize("shape", MESHES[1:])
def test_sharded_plan_chain_matches_jax(shape):
    B, S = 4, 16
    mesh = _mesh(shape)
    jcfg, pcfg = jsmoke("qwen1.5-4b"), psmoke("qwen1.5-4b")
    jchain = jplan_chain(JLM(jcfg), jinput_specs(
        jcfg, JShape("t", "train", S, B)), mesh, jshd.DEFAULT_RULES)
    model = PLM(pcfg)
    specs = input_specs(pcfg, ShapeSpec("t", "train", S, B))
    chain = plan_chain(model, specs, PEAK_FLOPS_BF16, mesh=mesh)
    np.testing.assert_array_equal(chain.wa, jchain.wa)
    np.testing.assert_array_equal(chain.uf, jchain.uf)
    np.testing.assert_array_equal(chain.ub, jchain.ub)
    # the residuals (which differ between the frameworks by design) are
    # one device's: over the data factor, the head's also over the model
    # axis (the vocabulary divides it)
    whole = plan_chain(model, specs, PEAK_FLOPS_BF16)
    dp, tp = shape
    ratio = np.full(len(whole.wabar), float(dp))
    ratio[-1] *= tp
    np.testing.assert_allclose(whole.wabar / chain.wabar, ratio)
    np.testing.assert_allclose(whole.wa / chain.wa, dp)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(shape=(2, 2), mesh_dim_names=("data", "model"))
    assert pshd.mesh_shape(mesh) == {"data": 2, "model": 2}
    assert pshd.placements_for(("vocab", "embed"), (8, 6), mesh) == (
        Shard(1), Shard(0))
    # 3 heads do not divide the model axis: replicated there
    assert pshd.placements_for(("embed", "heads", None), (6, 3, 4), mesh) == (
        Shard(0), Replicate())
    assert pshd.placements_for(("stack", "experts", None, None),
                               (2, 8, 4, 4), mesh) == (Replicate(), Shard(1))
    assert pshd.spec_for(("embed",), (6,), None) == ()
    assert pshd.sharding_for(("embed",), (6,), None) is None


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_axes_match_jax(arch):
    cfg = pget(arch)
    got = PLM(cfg).cache_axes()
    want = JLM(jget(arch)).cache_axes()

    def unstack(tree):
        assert all(ax[0] == "stack" for ax in tree.values())
        return {k: tuple(ax[1:]) for k, ax in tree.items()}

    assert got["pos"] == want["pos"] == ()
    assert len(got["layers"]) == cfg.num_layers
    for j, (ci, _) in enumerate(cfg.layer_slices):
        assert got["layers"][j] == unstack(want["chunks"][ci]), (arch, j)
    if "shared" in want:
        assert got["shared"]
        for one in got["shared"]:
            assert one == unstack(want["shared"])
    else:
        assert got["shared"] == []
    # the port's init_cache has the layout cache_axes describes
    spec = PLM(cfg).init_cache(2, 8, device="meta")
    for k in ("layers", "shared"):
        for c, ax in zip(spec[k], got[k]):
            assert c.keys() == ax.keys()
            for n, t in c.items():
                assert t.ndim == len(ax[n]), (arch, k, n)
