"""Differentiable wrapper of the causal GQA flash-attention kernel
(``csrc/flash_attn_fwd.cu``).

The forward runs the Hopper kernel on CUDA tensors (the model layout
``(B, S, H, D)`` is read through strides: no transpose, no padding) and the
plain version on any other device.  The backward recomputes attention from
the saved ``(q, k, v)`` through the plain :func:`.ref.attention`, as the JAX
package's custom VJP does — no ``(S × S)`` tensor is kept between forward and
backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ... import counters
from .. import _build
from . import ref

NAME = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 128)


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attn_fwd")
    fn = lib.flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attn_error_string.argtypes = [ctypes.c_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """Causal GQA attention forward: the kernel on CUDA tensors, the plain
    version on any other device.  q: (B, Sq, H, D); k/v: (B, Skv, K, D)."""
    if not q.is_cuda:
        return ref.attention(q, k, v)
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.ndim != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash attention needs k, v of shape (B, Skv, K, D) "
                         f"matching q {tuple(q.shape)}, got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    Skv, K = k.shape[1], k.shape[2]
    if H % K:
        raise ValueError(f"{K} KV heads do not divide {H} query heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError("q, k, v must be on one device")
    if min(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("flash attention needs a contiguous head dimension")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if Sq == 0:
        return o
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    lib = _lib()
    status = lib.flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, K, Sq, Skv, D, strides,
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, NAME, lib.flash_attn_error_string)
    counters.bump(NAME)
    return o


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return attention_fwd(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.attention(*qkv)
            return torch.autograd.grad(out, qkv, g)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, K, D). Causal. Returns (B, S, H, D)."""
    return _FlashAttention.apply(q, k, v)
