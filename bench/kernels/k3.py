"""K3, the causal GQA flash-attention forward (``csrc/flash_attn_fwd.cu``),
bf16 on the tensor cores."""

from bench.peaks import BF16_TENSOR_FLOPS

OP = "_FlashAttention"
FRAGMENTS = ("flash_fwd_sm90", "flash_fwd_kernel")


def work(shapes, conf):
    """``(bytes, operations, peak operations/s)`` of one launch on q (B, S,
    H, D) and k, v (B, S, K, D): q, k, v read once and the output written
    once in bf16; QKᵀ and PV over the S(S+1)/2 unmasked entries."""
    (B, S, H, D), (_, Skv, K, _) = shapes[0], shapes[1]
    nbytes = 2 * (2 * B * S * H * D + 2 * B * Skv * K * D)
    ops = 4 * D * (S * (S + 1) // 2) * B * H
    return nbytes, ops, BF16_TENSOR_FLOPS
