"""The paper's own workload family: a heterogeneous convolutional chain
(ResNet-style; the paper evaluates ResNet, DenseNet and Inception, §5.3),
the port of the JAX package's ``paper-resnet`` chain.

Block ``i`` is two 3×3 convolutions with a ReLU between them, a 1×1 skip
convolution where the channels change or the stride is 2, and
``relu(y + a)``; the stride is 2 at ``i % 3 == 2`` while the resolution is
above 4, and the channels double after each such block.  A last stage
reduces the activation to the loss ``mean(mean(a, (H, W))²)``.  So the
stages differ in activation size and time, as in the paper's chains.

Activations are NCHW; kernels are OIHW (the JAX package's are HWIO, its
activations NHWC: ``bridge.chain_params_from_numpy`` converts).  Padding is
the JAX package's ``"SAME"``: at stride 2 on an even size it pads one row
and column after the input and none before.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device

ARCH = "paper-resnet"
# the budgets (× the store-all peak) at which the JAX package's trade-off
# benchmark runs this chain at full size
BUDGETS = (0.35, 0.5, 0.65, 0.8, 1.0)


def _same_conv(a: torch.Tensor, k: torch.Tensor, stride: int) -> torch.Tensor:
    """``conv2d`` with the JAX package's ``"SAME"`` padding."""
    pads = []
    for size, kk in zip(a.shape[-2:], k.shape[-2:]):
        total = max((math.ceil(size / stride) - 1) * stride + kk - size, 0)
        pads.append((total // 2, total - total // 2))
    if all(lo == hi for lo, hi in pads):
        return F.conv2d(a, k, stride=stride, padding=(pads[0][0], pads[1][0]))
    (top, bottom), (left, right) = pads
    return F.conv2d(F.pad(a, (left, right, top, bottom)), k, stride=stride)


def _block(p: Dict[str, torch.Tensor], a: torch.Tensor,
           stride: int) -> torch.Tensor:
    y = torch.relu(_same_conv(a, p["k1"], stride))
    y = _same_conv(y, p["k2"], 1)
    if "skip" in p:
        a = _same_conv(a, p["skip"], stride)
    return torch.relu(y + a)


def _loss(p: Dict[str, torch.Tensor], a: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.mean(a, dim=(2, 3)) ** 2)


def resnet_ish_chain(num_blocks: int = 8, base_ch: int = 16,
                     image: int = 32, batch: int = 8, seed: int = 0,
                     device=None
                     ) -> Tuple[List[Callable], List[Dict[str, Any]],
                                torch.Tensor]:
    """``(stages, params, x)``: ``num_blocks`` blocks and the loss stage,
    float32 kernels drawn from ``seed`` (normal, times 0.4/√c_in for
    ``k1``, 0.4/√c for ``k2`` and 1/√c_in for the skip convolution) and an
    input ``x`` of shape ``(batch, 3, image, image)`` from the same
    generator, on ``device`` (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev if dev.type == "cuda" else "cpu")
    gen.manual_seed(seed)

    def normal(*shape, scale):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).requires_grad_()

    stages: List[Callable] = []
    params: List[Dict[str, Any]] = []
    ch_in, ch, res = 3, base_ch, image
    for i in range(num_blocks):
        stride = 2 if (i % 3 == 2 and res > 4) else 1
        p = {"k1": normal(ch, ch_in, 3, 3, scale=0.4 / ch_in ** 0.5),
             "k2": normal(ch, ch, 3, 3, scale=0.4 / ch ** 0.5)}
        if ch_in != ch or stride > 1:
            p["skip"] = normal(ch, ch_in, 1, 1, scale=1.0 / ch_in ** 0.5)
        stages.append(lambda p, a, stride=stride: _block(p, a, stride))
        params.append(p)
        ch_in = ch
        if stride == 2:
            res //= 2
            ch *= 2
    stages.append(_loss)
    params.append({})
    x = torch.randn((batch, 3, image, image), generator=gen, device=dev)
    return stages, params, x


def config(num_blocks: int = 8, image: int = 32, batch: int = 8, **kw):
    """``(stages, params, x)`` of :func:`resnet_ish_chain`: a rotor chain,
    not an LM config."""
    return resnet_ish_chain(num_blocks=num_blocks, image=image, batch=batch,
                            **kw)
