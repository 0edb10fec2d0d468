"""The port's six newer arch configs — codeqwen1.5-7b, starcoder2-7b,
qwen1.5-110b (dense), moonshot-v1-16b-a3b (MoE), zamba2-2.7b (Mamba2 +
shared attention) and deepseek-v2-lite-16b (MoE on MLA) — against the JAX
package's: every config field (dtypes
mapped by name), the chunking and stage count of the published-depth chain
(the port's profiled on ``meta`` tensors), the planner's analytic FLOPs per
stage (published and smoke size), and for the dense three the smoke
model's loss and gradients with weights bridged through numpy (float32 on
the CPU; loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5, as
``tests/test_torch_model.py``).  The VLM and the audio decoder are held in
``tests/test_torch_vlm_audio.py``."""

import dataclasses

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data.pipeline import SyntheticLMData  # noqa: E402
from repro.models import flops as jflops  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_config as pget  # noqa: E402
from repro_torch.configs import smoke_config as psmoke  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.launch.steps import plan_chain  # noqa: E402
from repro_torch.models import flops as pflops  # noqa: E402
from repro_torch.models.lm import StagedLM as PLM  # noqa: E402
from repro_torch.tree import tensors_of, tree_map  # noqa: E402

DENSE = ("codeqwen1.5-7b", "starcoder2-7b", "qwen1.5-110b")
NEW = DENSE + ("moonshot-v1-16b-a3b", "zamba2-2.7b",
               "deepseek-v2-lite-16b")
B, S = 2, 16


def _same_value(p, j) -> bool:
    if isinstance(p, torch.dtype):
        return str(p).removeprefix("torch.") == jnp.dtype(j).name
    return p == j


@pytest.mark.parametrize("arch", NEW)
def test_arch_matches_jax(arch):
    jcfg, pcfg = jget(arch), pget(arch)
    for f in dataclasses.fields(pcfg):
        assert _same_value(getattr(pcfg, f.name), getattr(jcfg, f.name)), \
            f.name
    # the published-depth chain: the JAX package's chunks, stage count and
    # the planner's analytic FLOPs (so its uf / ub), also at smoke size
    assert pcfg.chunks == jcfg.chunks
    for pc, jc in ((pcfg, jcfg), (psmoke(arch), jsmoke(arch))):
        for b, s in ((2, 16), (4, 2048)):
            assert pflops.stage_flops(pc, b, s) == jflops.stage_flops(jc, b,
                                                                      s)
    chain = plan_chain(PLM(pcfg), input_specs(
        pcfg, ShapeSpec("t", "train", 64, 1)), 1e15)
    assert chain.length + 1 == JLM(jcfg).n_stages() == len(jcfg.chunks) + 2
    if arch not in DENSE:
        return       # test_torch_{moe,zamba,mla}.py hold these
    jcfg, pcfg = jsmoke(arch), psmoke(arch)
    jparams = jax.jit(JLM(jcfg).init)(jax.random.PRNGKey(0))
    batch = SyntheticLMData(jcfg, B, S, seed=0).batch_at(0)
    jloss, jgrads = jax.jit(jax.value_and_grad(JLM(jcfg).loss_fn))(jparams,
                                                                   batch)
    pparams = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                                "cpu")
    loss = PLM(pcfg).loss_fn(pparams, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    it = iter(torch.autograd.grad(loss, tensors_of(pparams)))
    got = params_to_numpy(tree_map(lambda _: next(it), pparams))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    flat, _ = jax.tree_util.tree_flatten_with_path(jgrads)
    assert len(flat) == len(tensors_of(pparams))
    for path, want in flat:
        node = got
        for key in path:
            node = node[key.key if hasattr(key, "key") else key.idx]
        np.testing.assert_allclose(node, np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=str(path))

