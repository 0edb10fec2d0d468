"""The port's heterogeneous conv chain (``repro_torch.configs.paper_resnet``)
against the JAX package's (``repro.configs.paper_resnet``, the paper's own
workload family), on the CPU with the same weights bridged through numpy
(``bridge.chain_params_from_numpy``: HWIO kernels → OIHW) and the same input
(NHWC → NCHW):

- every stage output, the loss and every stage's parameter gradients at 6
  blocks, base width 8, image 16, batch 2 (two stride-2 blocks, skip
  convolutions at a channel change and at each stride 2); float32,
  tolerance rtol 1e-4 / atol 1e-5 (sums in another order, convolutions by
  another library);
- the port's own initialization: the same stages, keys and shapes;
- the measured chain's activation sizes ``wa`` equal the JAX measured
  chain's (``ā`` differs by design: PyTorch's saved tensors are not XLA's
  residuals);
- ``rotor:``, ``revolve:`` and ``periodic:`` plans on the port's measured
  chain, run through ``MemoryPlan.bind(...).value_and_grad``, give
  store-all's loss and gradients (rtol 1e-5 / atol 1e-7: the same
  operations, recomputed);
- ``launch.tradeoff`` on the chain, through ``run_tradeoff`` and through
  its command line, prints every row, the MAPE and the gain line."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import paper_resnet as jresnet  # noqa: E402
from repro.core.planner import profile_stages_measured as jmeasured  # noqa: E402
from repro_torch.bridge import (chain_grads_to_numpy,  # noqa: E402
                                chain_params_from_numpy)
from repro_torch.configs import paper_resnet as presnet  # noqa: E402
from repro_torch.core.executor import reference_grads  # noqa: E402
from repro_torch.core.planner import profile_stages_measured  # noqa: E402
from repro_torch.launch import tradeoff  # noqa: E402
from repro_torch.plan import resolve_policy  # noqa: E402

SIZE = dict(num_blocks=6, base_ch=8, image=16, batch=2)
TOL = dict(rtol=1e-4, atol=1e-5)


def _both():
    """The JAX chain and the port's chain with the JAX weights and input."""
    jstages, jparams, jx = jresnet.config(**SIZE)
    pstages, _, _ = presnet.config(**SIZE, device="cpu")
    jparams = jax.tree.map(np.asarray, jparams)
    pparams = chain_params_from_numpy(jparams, "cpu")
    px = torch.from_numpy(np.asarray(jx).transpose(0, 3, 1, 2).copy())
    return (jstages, jparams, jx), (pstages, pparams, px)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach().numpy()
    return t.transpose(0, 2, 3, 1) if t.ndim == 4 else t


def test_stages_loss_and_gradients_match_jax():
    (jstages, jparams, jx), (pstages, pparams, px) = _both()
    assert len(pstages) == len(jstages) == SIZE["num_blocks"] + 1
    assert [sorted(p) for p in pparams] == [sorted(p) for p in jparams]
    # the chain is heterogeneous: two stride-2 blocks, skips where needed
    assert ["skip" in p for p in jparams[:-1]] == [True, False, True, True,
                                                   False, True]
    a, b = jx, px
    for i, (jf, jp, pf, pp) in enumerate(zip(jstages, jparams, pstages,
                                             pparams)):
        a, b = jf(jp, a), pf(pp, b)
        np.testing.assert_allclose(_nhwc(b), np.asarray(a), err_msg=str(i),
                                   **TOL)
    assert tuple(np.shape(a)) == ()

    def composed(ps, x):
        for f, p in zip(jstages, ps):
            x = f(p, x)
        return x

    jloss, jgrads = jax.value_and_grad(composed)(
        jax.tree.map(jnp.asarray, jparams), jx)
    loss, grads, _ = reference_grads(pstages, pparams, px)
    np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    for i, (g, want) in enumerate(zip(chain_grads_to_numpy(grads), jgrads)):
        assert sorted(g) == sorted(want)
        for k in g:
            np.testing.assert_allclose(g[k], np.asarray(want[k]),
                                       err_msg=f"stage {i} {k}", **TOL)


def test_port_initialization_has_the_reference_layout():
    _, jparams, jx = jresnet.config(**SIZE)
    _, pparams, px = presnet.config(**SIZE, device="cpu")
    assert tuple(px.shape) == tuple(np.shape(jx)[i] for i in (0, 3, 1, 2))
    for jp, pp in zip(jparams, pparams):
        assert sorted(jp) == sorted(pp)
        for k in jp:
            assert tuple(pp[k].shape) == tuple(np.shape(jp[k])[i]
                                               for i in (3, 2, 0, 1))
            assert pp[k].dtype == torch.float32 and pp[k].requires_grad


def test_measured_wa_equals_jax_measured_chain():
    (jstages, jparams, jx), (pstages, pparams, px) = _both()
    want = jmeasured(jstages, jax.tree.map(jnp.asarray, jparams), jx,
                     repeats=1)
    got = profile_stages_measured(pstages, pparams, px, repeats=1)
    np.testing.assert_array_equal(got.wa, want.wa)
    assert got.length == want.length == SIZE["num_blocks"]
    assert np.all(got.uf > 0) and np.all(got.ub > 0)


@pytest.mark.parametrize("policy", ["rotor:x0.6", "revolve:x0.6",
                                    "periodic:2"])
def test_plans_on_the_chain_give_store_all_results(policy):
    _, (stages, params, x) = _both()
    chain = profile_stages_measured(stages, params, x, repeats=1)
    plan = resolve_policy(policy, chain, impl="plain")
    assert plan.remat_expressible and plan.recompute_factor() > 1
    out, grads, dx = plan.bind(stages).value_and_grad(params, x)
    want, wgrads, wdx = reference_grads(stages, params, x)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-7)
    for g, w in zip(grads, wgrads):
        for k in w:
            torch.testing.assert_close(g[k], w[k], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(dx, wdx, rtol=1e-5, atol=1e-7)


def test_tradeoff_on_the_chain_prints_every_row():
    _, (stages, params, x) = _both()
    lines = []
    out = tradeoff.run_tradeoff(stages, params, x, items=x.shape[0],
                                impl="plain", repeats=1, emit=lines.append)
    rows = out["rows"]
    skipped = [s for s in lines if "skipped" in s]
    assert len(rows) + len(skipped) == 1 + 3 * len(tradeoff.BUDGETS)
    assert rows[0]["strategy"] == "store-all"
    for r in rows:
        np.testing.assert_allclose(r["loss"], rows[0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], rows[0]["grad_norm"],
                                   rtol=1e-5)
        assert r["items_per_s"] > 0 and r["measured_peak_bytes"] is None
    assert sum(s.endswith("items/s") for s in lines) == len(rows)
    assert any(s.startswith("time prediction MAPE") for s in lines)
    assert any(s.startswith("rotor over best sequential") for s in lines)
    assert np.isfinite(out["mape_percent"])


def test_tradeoff_command_line_takes_the_conv_chain(capsys):
    out = tradeoff.main([
        "--arch", "paper-resnet", "--device", "cpu", "--override",
        '{"num_blocks": 6, "base_ch": 8, "image": 16}', "--global-batch",
        "2", "--solver-impl", "plain"])
    assert out["chain"].length == 6
    assert {r["budget_frac"] for r in out["rows"]} <= set(presnet.BUDGETS)
    text = capsys.readouterr().out
    assert "[tradeoff] paper-resnet 6 blocks, input (2, 3, 16, 16)" in text
    assert "rotor over best sequential" in text
