"""Differentiable RMSNorm on the CUDA kernel (``csrc/rms_norm.cu``):
flattens the leading dimensions, runs the kernel on CUDA tensors and the
plain version on any other device; the backward recomputes through
:func:`.ref.rms_norm` from the saved ``(x, scale)``, as the JAX package's
custom VJP does."""

from __future__ import annotations

import torch

from ... import counters
from . import ref
from . import kernel

NAME = "rms_norm"


def rms_norm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                 ) -> torch.Tensor:
    if not x.is_cuda:
        return counters.plain(NAME, ref.rms_norm, x, scale, eps)
    d = x.shape[-1]
    if scale.shape != (d,) or scale.get_device() != x.get_device():
        raise ValueError(f"rms_norm needs a ({d},) scale on {x.device}, got "
                         f"{tuple(scale.shape)} on {scale.device}")
    if x.dtype not in kernel.DTYPES:
        raise TypeError(f"rms_norm takes a floating x, got {x.dtype}")
    if x.stride(-1) != 1:
        raise ValueError("rms_norm needs a contiguous last dimension")
    scale = scale.contiguous()
    if x.is_contiguous():   # the model's case: rows d apart, no reshape
        out = torch.empty_like(x)
        kernel.launch(x, scale, out, x.numel() // max(d, 1), d, eps)
    else:
        out = kernel.rms_norm_2d(x.reshape(-1, d), scale, eps).view_as(x)
    counters.bump(NAME)
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (x, scale)]
            gx, gs = torch.autograd.grad(ref.rms_norm(*xs, ctx.eps), xs, g)
        return gx, gs, None


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """``x * rsqrt(mean(x²) + eps) * scale`` over the last axis, in float32,
    returned in ``x``'s dtype."""
    return _RMSNorm.apply(x, scale, eps)
