"""Fused RMSNorm: the ``ctypes`` binding of ``csrc/rms_norm.cu`` (K4).

Replaces the Pallas TPU kernel ``repro/kernels/rmsnorm/kernel.py ::
rms_norm_2d``.  One warp normalizes one row of ``x (N, d)`` at a time, from
16-byte vectors held in registers, with the scale kept in registers across
the rows; a persistent grid of warps strides over the rows.  The source note
of ``rms_norm.cu`` says what bounds it (bytes) and what the design does
about that.

The library is built by ``nvcc`` at the first launch (:mod:`.._build`), so
the module imports on machines without CUDA.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

NAME = "rms_norm"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


_FWD = _build.Binding(
    "rms_norm", "rms_norm_fwd",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
     ctypes.c_float, ctypes.c_void_p])
_ERROR = _build.Binding("rms_norm", "rms_norm_error_string", [ctypes.c_int],
                        ctypes.c_char_p)


def kernel_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The scale as the kernel reads it: in ``x``'s dtype if it has it, else
    in float32 (exact for every floating dtype the kernel takes)."""
    return scale if scale.dtype == x.dtype else scale.float()


def launch(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor,
           rows: int, x_stride: int, eps: float) -> None:
    """Normalize ``rows`` rows of ``d = x.shape[-1]`` elements, ``x_stride``
    elements apart, into the row-contiguous ``out``; the caller has checked
    the layouts (unit-stride rows and scale, a dtype of ``DTYPES``)."""
    if rows == 0:
        return
    d = x.shape[-1]
    s = kernel_scale(x, scale)
    status = (_FWD.fn or _FWD.load())(
        x.data_ptr(), s.data_ptr(), int(s.dtype != x.dtype), out.data_ptr(),
        DTYPES[x.dtype], rows, d, x_stride, d, eps,
        _build.stream(x.get_device()))
    if status:
        _build.check(status, NAME, _ERROR)


def rms_norm_2d(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
                ) -> torch.Tensor:
    """x: (N, d) CUDA tensor with unit-stride rows; scale: (d,) contiguous.
    Returns ``x * rsqrt(mean(x²) + eps) * scale`` row by row, in float32,
    stored in ``x``'s dtype."""
    N, d = x.shape
    if x.stride(1) != 1 or scale.stride(0) != 1:
        raise ValueError("rms_norm kernel needs unit-stride rows and scale, "
                         f"got x strides {x.stride()}, scale {scale.stride()}")
    if x.dtype not in DTYPES:
        raise TypeError(f"rms_norm kernel takes {sorted(map(str, DTYPES))}, "
                        f"got {x.dtype}")
    out = torch.empty((N, d), dtype=x.dtype, device=x.device)
    launch(x, scale, out, N, x.stride(0), eps)
    return out
