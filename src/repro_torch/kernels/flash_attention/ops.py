"""Differentiable wrapper of the causal GQA flash-attention kernel
(``csrc/flash_attn_fwd.cu``).

The forward runs the Hopper kernel on CUDA tensors (the model layout
``(B, S, H, D)`` is read through strides: no transpose, no padding) and the
plain version on any other device.  bf16 inputs go to the tensor cores by
TMA, which needs 16-byte-aligned bases and strides (:func:`tma_strides`
raises otherwise; nothing falls back); float32 inputs to the scalar kernel.
Head dims ``HEAD_DIMS`` (256 is PaliGemma's, on smaller K/V tiles); any
other raises.
The backward recomputes attention from the saved ``(q, k, v)`` through the
plain :func:`.ref.attention`, as the JAX package's custom VJP does — no
``(S × S)`` tensor is kept between forward and backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ... import counters
from .. import _build
from . import ref

NAME = "flash_attention_fwd"
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_STRIDES = ctypes.c_int64 * 12  # (batch, seq, head) of q, k, v, o


_FWD = _build.Binding(
    "flash_attn_fwd", "flash_attn_fwd",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p])
_ERROR = _build.Binding("flash_attn_fwd", "flash_attn_error_string",
                        [ctypes.c_int], ctypes.c_char_p)


def tma_strides(t: torch.Tensor, name: str) -> tuple:
    """The (batch, seq, head) element strides of a bf16 ``(B, S, H, D)``
    tensor as its TMA map takes them, or a ``ValueError`` naming the layout
    when the map cannot be built: the base must be 16-byte aligned and every
    stride a multiple of 16 bytes.  A dimension of size 1 is never stepped
    along, so its stride is replaced by the contiguous one."""
    B, S, H, D = t.shape
    sb, ss, sh, _ = t.stride()
    if B == 1:
        sb = S * H * D
    if S == 1:
        ss = H * D
    if H == 1:
        sh = D
    off = t.data_ptr() % 16
    if off or sb % 8 or ss % 8 or sh % 8:
        raise ValueError(
            f"flash attention loads bf16 {name} by TMA, which needs a "
            f"16-byte-aligned base and (batch, seq, head) strides that are "
            f"multiples of 8 elements; got {name} of shape {tuple(t.shape)} "
            f"with strides {t.stride()} and its base {off} bytes past a "
            f"16-byte boundary")
    return sb, ss, sh


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """Causal GQA attention forward: the kernel on CUDA tensors, the plain
    version on any other device.  q: (B, Sq, H, D); k/v: (B, Skv, K, D)."""
    if not q.is_cuda:
        return counters.plain(NAME, ref.attention, q, k, v)
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
    if not (k.get_device() == v.get_device() == q.get_device()):
        raise ValueError("q, k, v must be on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash attention needs a contiguous head dimension")
    bf16 = q.dtype == torch.bfloat16
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if Sq == 0:
        return o
    qkv = ([tma_strides(t, n) for t, n in zip((q, k, v), "qkv")] if bf16
           else [t.stride()[:3] for t in (q, k, v)])
    strides = _STRIDES(*qkv[0], *qkv[1], *qkv[2], *o.stride()[:3])
    status = (_FWD.fn or _FWD.load())(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        int(bf16), B, H, K, Sq, Skv, D, strides, 1.0 / math.sqrt(D),
        _build.stream(q.get_device()))
    _build.check(status, NAME, _ERROR)
    counters.bump(NAME)
    return o


def kernel_flops(B: int, S: int, H: int, D: int) -> int:
    """The kernel's arithmetic for one causal ``(B, S, H, D)`` call: QK^T
    and PV over the ``S(S+1)/2`` unmasked score entries of each head, 2
    FLOPs a multiply-add.  ``FlopCounterMode`` cannot see a kernel called
    through ``ctypes``; a count of a step adds this per launch."""
    return 4 * D * (S * (S + 1) // 2) * B * H


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
