"""Fused RMSNorm — Triton kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm/kernel.py ::
rms_norm_2d``.  One program normalizes one row of ``x (N, d)``: it loads the
row once (``BLOCK_D`` = the next power of two of ``d``, masked), reduces the
sum of squares in float32, multiplies by ``rsqrt(mean + eps)`` and the scale
in the same pass, and stores the row in ``x``'s dtype.

Bound: bytes (one read and one write of ``x``; a handful of operations per
element).  The single pass is the design: the row never goes back to device
memory between the reduction and the scale.  Unlike the TPU kernel, rows are
not padded to a multiple of 8 — a program per row needs no row tiling.

Triton is imported, and the kernel compiled, at the first launch: the module
itself imports without Triton, so CPU-only installs can import the package.
"""

from __future__ import annotations

import functools

import torch

tl = None  # triton.language, bound by _compiled() at the first launch


def _rms_norm_rows(x_ptr, s_ptr, o_ptr, x_row_stride, o_row_stride, d, eps,
                   BLOCK_D: tl.constexpr):
    row = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < d
    x = tl.load(x_ptr + row * x_row_stride + cols, mask=mask,
                other=0.0).to(tl.float32)
    inv = tl.rsqrt(tl.sum(x * x, axis=0) / d + eps)
    s = tl.load(s_ptr + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * inv * s
    tl.store(o_ptr + row * o_row_stride + cols,
             y.to(o_ptr.dtype.element_ty), mask=mask)


@functools.cache
def _compiled():
    global tl
    import triton
    import triton.language

    tl = triton.language
    return triton.jit(_rms_norm_rows)


def rms_norm_2d(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    """x: (N, d) CUDA tensor with contiguous rows; scale: (d,) contiguous."""
    import triton

    N, d = x.shape
    if x.stride(1) != 1 or scale.stride(0) != 1:
        raise ValueError("rms_norm kernel needs unit-stride rows and scale, "
                         f"got x strides {x.stride()}, scale {scale.stride()}")
    out = torch.empty((N, d), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    block = triton.next_power_of_2(d)
    _compiled()[(N,)](x, scale, out, x.stride(0), out.stride(0), d, eps,
                      BLOCK_D=block, num_warps=min(max(block // 256, 1), 8))
    return out
