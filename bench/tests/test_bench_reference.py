"""The plain references against the port's plain path (its CPU branch) at
small widths: loss and every gradient, on the weights and batch the
benchmark makes."""

import pytest
import torch

from bench import registry
from bench.reference.common import leaves, make_tree, matmul
from bench.tests.cells import small_cell

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port(name):
    from bench.harness import program_config
    from repro_torch.models.lm import StagedLM

    cell = small_cell(name)
    conf = cell.conf
    family = registry.module("reference", conf["family"])
    inputs = registry.module("inputs", conf["modality"])
    batch = inputs.make_batch(conf, 2, 32, 4321, 0, "cpu")
    params = make_tree(family.weight_spec(conf), 1234, "cpu")
    named = leaves(params)
    loss = StagedLM(program_config(conf)).loss_fn(params, batch)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    ref_tree = make_tree(family.weight_spec(conf), 1234, "cpu")
    ref_leaves = [t for _, t in leaves(ref_tree)]
    ref_loss = family.loss(ref_tree, batch, conf, matmul("float32"))
    ref_grads = torch.autograd.grad(ref_loss, ref_leaves)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 1e-5
    for (path, _), g, r in zip(named, grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6, msg=path)


def test_weights_follow_the_seed():
    conf = small_cell(CELLS[0]).conf
    spec = registry.module("reference", conf["family"]).weight_spec(conf)
    a, b, c = (make_tree(spec, s, "cpu") for s in (7, 7, 8))
    for (_, x), (_, y), (_, z) in zip(leaves(a), leaves(b), leaves(c)):
        assert torch.equal(x, y)
    assert not all(torch.equal(x, z) for (_, x), (_, z)
                   in zip(leaves(a), leaves(c)) if x.numel() > 64)


@pytest.mark.parametrize("name", CELLS)
def test_batches_follow_the_seed_and_step(name):
    conf = small_cell(name).conf
    make = registry.module("inputs", conf["modality"]).make_batch
    one, again = make(conf, 2, 16, 3, 5, "cpu"), make(conf, 2, 16, 3, 5, "cpu")
    other = make(conf, 2, 16, 3, 6, "cpu")
    for k in one:
        assert torch.equal(one[k], again[k])
    assert not torch.equal(one["labels"], other["labels"])
