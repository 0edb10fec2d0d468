"""The SSD scan on the within-chunk kernel K6 (``csrc/ssd_chunk.cu``).

:func:`ssd_chunk_blocks` launches the kernel on CUDA tensors and returns the
plain :func:`.ref.chunk_terms` on any other device.  The C launcher picks
the kernel: bf16 x, B, C at (P, Q) = (64, 256) with a state N of 128
(Mamba2) or 64 (Zamba2) take the tensor-core kernel, which shares each
group's C·Bᵀ among a slice of the group's heads; float32, and bf16 at other
shapes, take the scalar kernel.  :func:`head_slice` asks the library which
one a call would take.

:func:`ssd_chunked` is differentiable: its forward pads time to whole chunks,
runs the within-chunk terms through :func:`ssd_chunk_blocks` and the short
recurrence across chunks in PyTorch (the JAX package leaves that part to XLA
too); its backward recomputes through the plain :func:`.ref.ssd_chunked`
from the saved inputs, as the JAX package's custom VJP does, so no (Q × Q)
tensor is kept between forward and backward.  The JAX package has no SSD
backward kernel, so neither has the port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ... import counters
from .. import _build
from . import ref

NAME = "ssd_chunk"
MAX_HEAD_DIM = 64       # P: the kernel's output tile is 64 columns wide
MAX_STATE = 128         # N: B and C tiles are 128 columns wide
MAX_CHUNK = 1024        # Q: the chunk's cumulative sum lives in shared memory

_P, _I = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.c_int64 * 12  # (batch, seq, head or group) of x, dt, B, C
_FWD = _build.Binding("ssd_chunk", "ssd_chunk_fwd",
                      [_P] * 7 + [_I] * 8 + [ctypes.POINTER(ctypes.c_int64),
                                             _P])
_SLICE = _build.Binding("ssd_chunk", "ssd_chunk_head_slice", [_I] * 6)
_MISALIGNED_ROWS = -1   # ssd_chunk_fwd's status for the tensor-core kernel
_ERROR = _build.Binding("ssd_chunk", "ssd_chunk_error_string", [_I],
                        ctypes.c_char_p)


def head_slice(dtype: torch.dtype, P: int, N: int, chunk: int, heads: int,
               groups: int) -> int:
    """Heads per block of the tensor-core kernel for these operands, or 0
    when they take the scalar kernel, as the built library decides (so it
    builds the library).  A group of ``R`` heads is cut into
    ``ceil(R / slice)`` slices, the last one shorter when ``slice`` does not
    divide ``R``; each block computes its group's scores once for its
    slice."""
    return (_SLICE.fn or _SLICE.load())(int(dtype == torch.bfloat16), P, N,
                                        chunk, heads, groups)


def ssd_chunk_blocks(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk terms (see :func:`.ref.chunk_terms`): the kernel on CUDA
    tensors, the plain version on any other device.  x (B, S, H, P) and
    Bm/Cm (B, S, G, N) in one dtype (float32 or bfloat16) with a contiguous
    last axis, read through their strides (on the tensor-core kernel, rows
    of 16 aligned bytes: bases and strides at multiples of 8 elements); dt
    (B, S, H) and A (H,) float32; S a multiple of ``chunk``.  Returns y_diag
    (B, S, H, P) and states (B, S/chunk, H, P, N), both float32."""
    if not x.is_cuda:
        return counters.plain(NAME, ref.chunk_terms, x, dt, A, Bm, Cm,
                              chunk)
    Bsz, S, H, P = x.shape
    if Bm.shape != Cm.shape or Bm.ndim != 4 or Bm.shape[:2] != (Bsz, S):
        raise ValueError(f"ssd needs Bm, Cm of shape (B, S, G, N) matching x "
                         f"{tuple(x.shape)}, got {tuple(Bm.shape)} and "
                         f"{tuple(Cm.shape)}")
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    if dt.shape != (Bsz, S, H) or A.shape != (H,):
        raise ValueError(f"ssd needs dt {(Bsz, S, H)} and A {(H,)}, got "
                         f"{tuple(dt.shape)} and {tuple(A.shape)}")
    if not (0 < chunk <= MAX_CHUNK and S % chunk == 0):
        raise ValueError(f"ssd kernel needs 0 < chunk <= {MAX_CHUNK} dividing "
                         f"S = {S}, got chunk {chunk}")
    if not (0 < P <= MAX_HEAD_DIM and 0 < N <= MAX_STATE):
        raise ValueError(f"ssd kernel takes head_dim <= {MAX_HEAD_DIM} and "
                         f"state <= {MAX_STATE}, got {P} and {N}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not (
            Bm.dtype == Cm.dtype == x.dtype):
        raise TypeError(f"ssd kernel takes float32 or bfloat16 x, Bm, Cm of "
                        f"one dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd kernel takes float32 dt and A, got {dt.dtype} "
                        f"and {A.dtype}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd operands must be on one device")
    if min(t.stride(-1) for t in (x, Bm, Cm)) != 1:
        raise ValueError("ssd kernel needs a contiguous last axis of x, Bm, Cm")
    # a stride of a size-1 axis is never stepped along: 0
    strides = tuple(0 if t.shape[i] == 1 else t.stride(i)
                    for t in (x, dt, Bm, Cm) for i in range(3))
    A = A.contiguous()
    nc = S // chunk
    y = torch.empty((Bsz, S, H, P), dtype=torch.float32, device=x.device)
    states = torch.empty((Bsz, nc, H, P, N), dtype=torch.float32,
                         device=x.device)
    if Bsz == 0 or S == 0:
        return y, states
    status = (_FWD.fn or _FWD.load())(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
        int(x.dtype == torch.bfloat16), Bsz, S, H, G, P, N, chunk,
        _STRIDES(*strides), _build.stream(x.get_device()))
    if status == _MISALIGNED_ROWS:
        raise ValueError(
            f"the bf16 ssd kernel loads rows of x, Bm, Cm as 16 aligned "
            f"bytes: bases 16-byte aligned and (batch, seq, head) strides at "
            f"multiples of 8 elements; got strides {strides}")
    _build.check(status, NAME, _ERROR)
    counters.bump(NAME)
    return y, states


class _SSDChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, init_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk = chunk
        return ref.chunked_with(ssd_chunk_blocks, x, dt, A, Bm, Cm, chunk,
                                init_state)

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        inputs = [t if t is None else t.detach().requires_grad_(
            t.is_floating_point()) for t in saved]
        with torch.enable_grad():
            x, dt, A, Bm, Cm, st = inputs
            outs = ref.ssd_chunked(x, dt, A, Bm, Cm, ctx.chunk, st)
            wrt = [t for t in inputs if t is not None]
            grads = iter(torch.autograd.grad(outs, wrt, (gy, gstate),
                                             allow_unused=True))
        g = [None if t is None else next(grads) for t in inputs]
        return g[0], g[1], g[2], g[3], g[4], None, g[5]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as :func:`.ref.ssd_chunked`: x (B, S, H, P), dt (B, S,
    H), A (H,), Bm/Cm (B, S, G, N), any S.  Returns y (B, S, H, P) in x's
    dtype and the final state (B, H, P, N) float32."""
    return _SSDChunked.apply(x, dt, A, Bm, Cm, chunk, init_state)
