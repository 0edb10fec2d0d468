"""Three AdamW steps of the port against the JAX package at published widths,
cut in depth: musicgen-medium's (d 1536, 24 heads, d_ff 6144, vocab 2048,
GELU, no RoPE) and Qwen1.5-4B's (d 2560, 20 heads, d_ff 6912, dense GQA
with RoPE; the vocabulary cut from 151936 to 4096 to keep the CPU's
memory), both in the configs' bf16, from the same seed, the same batches
(``batch_at``), ``linear_warmup_cosine(3e-4, 10, steps)`` and weights
bridged through numpy.  The loss and the global gradient norm of every
step agree within rtol 2e-3: two frameworks round bf16 activations and
products differently (the measured gap is ~2e-4).

MusicGen's loss jumps at its third step on the card (phase 18, 48 layers:
7.98 → 8.00 → 25.19); the JAX package jumps the same way on the CPU, so
the jump belongs to the configuration's first AdamW steps, not to the
port.  Run this file as a script to print both trajectories at any depth::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py \\
        musicgen-medium 12 64
"""

import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.data.pipeline import SyntheticLMData as JData  # noqa: E402
from repro.launch.steps import make_train_step as jstep  # noqa: E402
from repro.models.lm import StagedLM as JLM  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdam  # noqa: E402
from repro.optim.adamw import adamw_init as jadam_init  # noqa: E402
from repro.optim.schedules import linear_warmup_cosine as jlr  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config as pget  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMData  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.schedules import linear_warmup_cosine  # noqa: E402
from repro_torch.tree import tensors_of  # noqa: E402

STEPS, BATCH, LR, WARMUP = 3, 2, 3e-4, 10


def trajectories(arch: str, layers: int, seq: int, **overrides):
    """``(jax, port)``: each a list of ``(loss, grad_norm)`` per step."""
    ov = dict(num_layers=layers, layer_kinds=("dense",) * layers,
              n_chunks=min(8, layers), **overrides)
    jcfg, pcfg = jget(arch, **ov), pget(arch, **ov)
    jmodel = JLM(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), pcfg,
                               torch.device("cpu"))
    jf = jax.jit(jstep(jmodel, JAdam(lr=LR), None, jlr(LR, WARMUP, STEPS)))
    jopt, jdata, jout = jadam_init(jparams), JData(jcfg, BATCH, seq), []
    for s in range(STEPS):
        jparams, jopt, m = jf(jparams, jopt,
                              jax.tree.map(jnp.asarray, jdata.batch_at(s)),
                              jnp.asarray(s, jnp.int32))
        jout.append((float(m["loss"]), float(m["grad_norm"])))
    del jparams, jopt
    step = make_train_step(StagedLM(pcfg), AdamWConfig(lr=LR), None,
                           linear_warmup_cosine(LR, WARMUP, STEPS))
    opt, data, out = adamw_init(tensors_of(params)), SyntheticLMData(
        pcfg, BATCH, seq), []
    for s in range(STEPS):
        m = step(params, opt, data.device_batch(s, "cpu"), s)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return jout, out


@pytest.mark.parametrize("arch,layers,overrides", [
    ("musicgen-medium", 2, {}),
    ("qwen1.5-4b", 2, {"vocab_size": 4096}),
], ids=["musicgen-width", "qwen-width"])
def test_three_adamw_steps_match_jax(arch, layers, overrides):
    want, got = trajectories(arch, layers, 16, **overrides)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=2e-3)


if __name__ == "__main__":
    arch, layers, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    for name, traj in zip(("jax", "port"), trajectories(arch, layers, seq)):
        for s, (loss, gnorm) in enumerate(traj):
            print(f"{name} {arch} {layers} layers seq {seq} step {s}: "
                  f"loss {loss:.6f} grad norm {gnorm:.6f}", flush=True)
