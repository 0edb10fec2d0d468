"""Expert parallelism (``models.mlp.moe_apply_ep`` on ``all_to_all_single``
over the model axis' gloo group, in spawned processes) against the local
MoE path, on ``smoke_config("deepseek-v2-lite-16b",
moe_capacity_factor=8.0)`` (8 experts, top-2, one shared expert; no pair
dropped), with the JAX package's weights bridged through numpy:

- at meshes (1, 2), (1, 4) and (2, 2) the EP output equals the JAX
  package's and the port's local ``moe_apply`` on the same input, the aux
  loss too where the data axis is 1 (with two data ranks each rank's aux is
  its own tokens', valued at their mean over the data group); rtol 2e-4 /
  atol 2e-5, as ``tests/test_multidevice.py`` holds the reference's own EP
  path;
- the gradients through EP (input, router, shared expert, each rank's
  expert blocks, which are never gathered) equal the local path's, summed
  over the data ranks where the batch is split (rtol 1e-4 / atol 1e-5);
- ``scan_layer_remat="save_moe"`` in a ZeRO-3 training run at (1, 2): the
  losses equal the single-process run's, and the exchange counter shows
  the all-to-alls run in the forward only (two per MoE layer per step),
  where ``full`` runs them again in the backward's recompute.

The JAX package's own shard_map EP test fails under jax 0.9.0, so the
reference here is its local path.  The checks share two spawned gloo
groups, run once for the module: world 2 (mesh (1, 2) and the training
runs) and world 4 (meshes (1, 4) and (2, 2))."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.distributed.local import run_local  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
B, S = 4, 8
TIMEOUT = 300.0
SHAPES = [(1, 2), (1, 4), (2, 2)]
EXPERTS = ("we_gate", "we_up", "we_down")


def _cfg(**kw):
    return smoke_config(ARCH, moe_capacity_factor=8.0, **kw)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _objective(p, x, cot, aux_coef, cfg):
    from repro_torch.models.mlp import moe_apply

    y, aux = moe_apply(p, cfg, x)
    loss = (y * cot).sum() + aux_coef * aux
    names = sorted(_flat(p))
    grads = torch.autograd.grad(loss, [x] + [_flat(p)[n] for n in names])
    return (y.detach().numpy(), float(aux),
            {"x": grads[0].numpy(),
             **{n: g.numpy() for n, g in zip(names, grads[1:])}})


def _ep_rank(rank, world, shape, weights, x, cot, aux_coef):
    from repro_torch.distributed.sharding import axis_rules, make_mesh
    from repro_torch.models.mlp import ALL_TO_ALL

    ALL_TO_ALL.update(forward=0, backward=0)
    cfg = _cfg()
    mesh = make_mesh(shape, "cpu")
    d_i, m_i = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    e_loc = cfg.num_experts // shape[1]
    p = _tensors({k: (v if k not in EXPERTS else
                      {"kernel": v["kernel"][m_i * e_loc:(m_i + 1) * e_loc]})
                  for k, v in weights.items()})
    rows = slice(d_i * B // shape[0], (d_i + 1) * B // shape[0])
    xl = torch.from_numpy(x[rows]).requires_grad_()
    with axis_rules(mesh):
        y, aux, grads = _objective(p, xl, torch.from_numpy(cot[rows]),
                                   aux_coef, cfg)
    return {"y": y, "aux": aux, "grads": grads, "rows": rows,
            "data": d_i, "model": m_i, "exchanges": dict(ALL_TO_ALL)}


@pytest.fixture(scope="module")
def local():
    """The JAX package's local MoE (weights and output) and the port's local
    path on the same input: output, aux and gradients."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke
    from repro.models import mlp as jmlp

    jcfg = jsmoke(ARCH, moe_capacity_factor=8.0)
    key = jax.random.PRNGKey(0)
    weights = jax.tree.map(np.asarray, jmlp.moe_init(key, jcfg, jnp.float32))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jy, jaux = jmlp.moe_apply(weights, jcfg, jnp.asarray(x))
    y, aux, grads = _objective(_tensors(weights),
                               torch.from_numpy(x).requires_grad_(),
                               torch.from_numpy(cot), 1.0, _cfg())
    np.testing.assert_allclose(y, np.asarray(jy), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(aux, float(jaux), rtol=2e-4)
    _, _, grads_noaux = _objective(_tensors(weights),
                                   torch.from_numpy(x).requires_grad_(),
                                   torch.from_numpy(cot), 0.0, _cfg())
    return {"weights": weights, "x": x, "cot": cot, "y": np.asarray(jy),
            "aux": float(jaux), "grads": grads, "grads_noaux": grads_noaux}


class _Doubled(torch.autograd.Function):
    """``2·x`` through :func:`kept` (as the expert exchange is), counting
    the times it computes."""

    calls = 0

    @staticmethod
    def forward(ctx, x):
        from repro_torch.core.rematerialize import kept

        def compute():
            _Doubled.calls += 1
            return 2 * x

        return kept(compute)

    @staticmethod
    def backward(ctx, grad):
        return 2 * grad


@pytest.mark.parametrize("keep", [True, False])
def test_keep_region_replays_its_kept_values(keep):
    """``remat(..., keep=True)`` hands the recompute what the first run
    passed through ``kept``; the gradient is the plain function's.  Without
    ``keep`` (and on the local MoE path, where nothing is kept) it is a
    plain checkpoint that computes again."""
    from repro_torch.core.rematerialize import remat

    def fn(x):
        return (torch.sin(_Doubled.apply(x)) * x).sum()

    x = torch.linspace(-1.0, 1.0, 7, requires_grad=True)
    want, = torch.autograd.grad(fn(x), [x])
    _Doubled.calls = 0
    got, = torch.autograd.grad(remat(fn, x, keep=keep), [x])
    assert _Doubled.calls == (1 if keep else 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _aux_coef(shape):
    return 1.0 if shape[0] == 1 else 0.0


@pytest.mark.parametrize("shape", SHAPES,
                         ids=["model2", "model4", "data2_model2"])
def test_ep_matches_local(local, groups, shape):
    aux_coef = _aux_coef(shape)
    ranks = [r["ep"][shape] for r in groups[shape[0] * shape[1]]]
    want = local["grads"] if aux_coef else local["grads_noaux"]
    e_loc = _cfg().num_experts // shape[1]
    summed = {}
    for r in ranks:
        rows = r["rows"]
        np.testing.assert_allclose(r["y"], local["y"][rows], rtol=2e-4,
                                   atol=2e-5)
        if shape[0] == 1:
            np.testing.assert_allclose(r["aux"], local["aux"], rtol=2e-4)
        np.testing.assert_allclose(r["grads"]["x"], want["x"][rows],
                                   rtol=1e-4, atol=1e-5)
        # one forward: the dispatch and the return exchange, and their
        # reverse exchanges in the backward
        assert r["exchanges"] == {"forward": 2, "backward": 2}
        for name, g in r["grads"].items():
            if name == "x":
                continue
            key = (name, r["model"] if name.split("/")[0] in EXPERTS else 0)
            summed[key] = summed.get(key, 0) + g
    # the routed experts' gradients: each rank's own blocks, summed over the
    # data ranks; the rest summed over the data ranks of one model column
    for (name, m), g in summed.items():
        full = want[name]
        if name.split("/")[0] in EXPERTS:
            full = full[m * e_loc:(m + 1) * e_loc]
        else:
            g = g / shape[1]
        np.testing.assert_allclose(g, full, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _train_rank(rank, world, remat):
    from repro_torch.distributed.sharding import make_mesh
    from repro_torch.models.mlp import ALL_TO_ALL
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    ALL_TO_ALL.update(forward=0, backward=0)
    out = run_training(_cfg(scan_layer_remat=remat),
                       TrainLoopConfig(steps=2, global_batch=2, seq_len=S,
                                       lr=1e-3, warmup=1, policy="none",
                                       log_every=100),
                       device="cpu", mesh=make_mesh((1, 2), "cpu"),
                       log_fn=lambda *_: None)
    return out["losses"], dict(ALL_TO_ALL)


def _group_rank(rank, world, weights, x, cot):
    """Every EP mesh of this world size, then (world 2) the training runs
    under ``save_moe`` and ``full``."""
    out = {"ep": {shape: _ep_rank(rank, world, shape, weights, x, cot,
                                  _aux_coef(shape))
                  for shape in SHAPES if shape[0] * shape[1] == world}}
    if world == 2:
        out["train"] = {remat: _train_rank(rank, world, remat)
                        for remat in ("save_moe", "full")}
    return out


@pytest.fixture(scope="module")
def groups(local):
    """``{world: [each rank's results]}`` for worlds 2 and 4."""
    return {world: run_local(_group_rank, world,
                             (local["weights"], local["x"], local["cot"]),
                             timeout=TIMEOUT)
            for world in (2, 4)}


def test_save_moe_runs_the_exchanges_in_the_forward_only(groups):
    from repro_torch.runtime.train_loop import TrainLoopConfig, run_training

    want = run_training(_cfg(scan_layer_remat="full"),
                        TrainLoopConfig(steps=2, global_batch=2, seq_len=S,
                                        lr=1e-3, warmup=1, policy="none",
                                        log_every=100),
                        device="cpu", log_fn=lambda *_: None)["losses"]
    n_moe = _cfg().layer_kinds.count("moe")
    for remat, forward in (("save_moe", 2), ("full", 4)):
        for r in groups[2]:
            losses, exchanges = r["train"][remat]
            np.testing.assert_allclose(losses, want, rtol=1e-5)
            assert exchanges == {"forward": forward * n_moe * 2,
                                 "backward": 2 * n_moe * 2}, (remat,
                                                              exchanges)
