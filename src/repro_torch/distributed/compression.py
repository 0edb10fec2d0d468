"""Gradient compression for the data-parallel all-reduce: int8 quantization
with error feedback (the port of ``repro.distributed.compression``).

Each data-parallel member quantizes ``gradient + error`` to int8 on a
per-tensor scale that every member shares (the ``all_reduce`` MAX of the
members' own scales), dequantizes, and the dequantized float32 values are
summed over the members (``all_reduce`` SUM) and divided by their count.
What the quantizer dropped, ``x - deq``, is the member's new error, added
back into its next step's gradient, so the sum of the applied means tracks
the sum of the true means to within one quantization step.

``group`` is the data axes' process group (``None``: the member is alone
and nothing is communicated).  The collectives move float32 here, as the
reference's ``psum`` of ``deq`` does; :func:`compression_ratio` is the
byte ratio a wire format of int8 values would give.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import all_reduce


def ef_init(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-member error-feedback accumulators: float32 zeros shaped like
    each gradient."""
    return [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in params]


def quantize_int8(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 of float32 ``x``: ``(q, scale)``, the scale
    the largest of the members' ``max|x| / 127`` (at least 1e-12)."""
    # times the reciprocal: XLA evaluates the reference's ``/ 127.0`` so,
    # and both packages then quantize on the same grid, bit for bit
    scale = torch.max(torch.abs(x)) * (1.0 / 127.0)
    if group is not None:
        scale = all_reduce(scale, group, op="max")
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def compressed_psum_mean(grads: Sequence[torch.Tensor],
                         error: Sequence[torch.Tensor],
                         group: Optional[dist.ProcessGroup], n_members: int
                         ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """This member's ``(grads, error)`` → ``(the members' mean of the
    dequantized gradients, in each gradient's dtype; the new error)``."""
    means, new_error = [], []
    for g, e in zip(grads, error):
        x = g.float() + e
        q, scale = quantize_int8(x, group)
        deq = q.float() * scale
        total = deq if group is None else all_reduce(deq.clone(), group)
        means.append((total / n_members).to(g.dtype))
        # x - q·scale rounded once (exact in float64), as the reference's
        # compiled residual, a fused multiply-add, has it
        new_error.append((x.double() - q.double() * scale.double()).float())
    return means, new_error


def compression_ratio(params: Sequence[torch.Tensor] = (),
                      from_dtype: torch.dtype = torch.bfloat16) -> float:
    """Collective-byte ratio of int8 values against ``from_dtype`` ones (the
    per-tensor scales are negligible)."""
    return (torch.tensor([], dtype=from_dtype).element_size()
            / torch.tensor([], dtype=torch.int8).element_size())
