"""The yardstick's frozen arithmetic: the model-FLOP count against the
port's per-stage count it was copied from, and each kernel's bytes and
operations on a shape worked by hand."""

import math

import pytest

from bench import flops, peaks, registry

CONFIGS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CONFIGS)
def test_count_is_three_forwards_less_the_lookup(name):
    from bench.harness import program_config
    from repro_torch.models.flops import stage_flops

    cell = registry.cell(name)
    B, S = cell.traffic["batch"], cell.traffic["seq_len"]
    fwd, _ = stage_flops(program_config(cell.conf), B, S)
    want = 3.0 * sum(fwd[1:])
    assert math.isclose(flops.train_flops_per_step(cell.conf, B, S), want,
                        rel_tol=1e-12)


def test_dense_count_by_hand():
    conf = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "d_ff": 8,
            "mlp_kind": "gelu", "vocab_size": 10, "layer_kinds": ["dense"]}
    B, S = 1, 3
    # q 4x4, k and v 4x2, o 4x4; scores and values 3x3 per head of 2
    attn = 2 * 3 * (16 + 8 + 8 + 16) + 2 * 3 * 3 * 2 * 2 * 2
    mlp = 2 * 3 * 4 * 8 * 2
    head = 2 * 3 * 4 * 10
    assert flops.train_flops_per_step(conf, B, S) == 3 * (attn + mlp + head)


def work(kernel, shapes, conf=None):
    return registry.module("kernels", kernel).work(shapes, conf or {})


def test_k3_by_hand():
    # q (1, 4, 2, 16), k and v (1, 4, 1, 16): bf16, read and written once;
    # 4 · 16 operations per unmasked entry, 10 entries a head of 2
    nbytes, ops, peak = work("k3", [[1, 4, 2, 16], [1, 4, 1, 16],
                                    [1, 4, 1, 16]])
    assert (nbytes, ops, peak) == (2 * (256 + 128), 1280,
                                   peaks.BF16_TENSOR_FLOPS)


def test_k4_by_hand():
    nbytes, ops, peak = work("k4", [[2, 3, 8], [8], []])
    assert (nbytes, ops, peak) == (4 * 48 + 16, 192, peaks.F32_FLOPS)
