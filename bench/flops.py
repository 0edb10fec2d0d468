"""The yardstick's model-FLOP count of one training step, frozen here so
that a change to the program cannot move it.

Each layer's forward count comes from the module of its kind
(``bench/layers/<kind>.py``, a copy of the port's per-stage arithmetic);
the head's logits product is counted here.  A training step counts three
times the forward (the backward as twice the forward), the embedding
lookup as 0 and no recompute.  The count reads the benchmark's own
configuration file (the keys of ``bench/configs/<config>.json``), never
the program's config.

A multiply-add is 2 FLOPs.
"""

from __future__ import annotations

from typing import Dict, List

from bench import registry


def forward_flops(conf: Dict, B: int, S: int) -> List[float]:
    """Forward FLOPs of each layer, then the head's logits product."""
    per = [registry.module("layers", kind).forward_flops(conf, B, S)
           for kind in conf["layer_kinds"]]
    return per + [2 * B * S * conf["d_model"] * conf["vocab_size"]]


def train_flops_per_step(conf: Dict, B: int, S: int) -> float:
    """Model FLOPs of one training step: 3 × the forward, lookup at 0, no
    recompute."""
    return 3.0 * sum(forward_flops(conf, B, S))
