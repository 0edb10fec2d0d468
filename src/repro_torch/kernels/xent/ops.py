"""Token-chunked cross-entropy: never materializes the full ``(B·S, V)``
logits — the largest activation of a 150k-vocab model.

A loop over token blocks whose body runs under a per-block checkpoint (the
PyTorch form of the JAX package's ``@jax.checkpoint`` scan body): only one
``(block, V)`` float32 logits block is live at a time, and the backward
recomputes it block by block.  No kernel: the per-block product is a plain
matrix product, as it is an XLA scan in the JAX package.  Vocab-parallel
under model-axis tensor parallelism: ``w`` holds this rank's vocabulary
columns and each block's log-partition and label logit are reduced over
the model group (the recompute reduces again).
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.rematerialize import remat
from ...distributed.tensor_parallel import vocab_parallel_lse_gold


def _block_loss(hblk: torch.Tensor, w: torch.Tensor, lblk: torch.Tensor,
                mblk: torch.Tensor, z_loss: float, vocab_start: int, axis):
    logits = (hblk @ w.to(hblk.dtype)).float()
    lse, gold = vocab_parallel_lse_gold(logits, lblk, vocab_start, axis)
    per = lse - gold
    if z_loss:
        per = per + z_loss * lse ** 2
    return torch.sum(per * mblk), torch.sum(mblk)


def token_chunked_xent(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, block: int = 4096,
                       z_loss: float = 0.0, vocab_start: int = 0,
                       axis=None) -> torch.Tensor:
    """Masked token-mean cross-entropy of ``h @ w``; h (B, S, d), w (d, V),
    labels (B, S) int, mask (B, S) or None; with ``axis`` (a
    ``tensor_parallel.ModelAxis``) ``w`` is this rank's columns from
    ``vocab_start`` on."""
    B, S, d = h.shape
    T = B * S
    h2 = h.reshape(T, d)
    lab = labels.reshape(T)
    m1 = (mask.reshape(T).float() if mask is not None
          else torch.ones(T, dtype=torch.float32, device=h.device))
    block = min(block, T)
    lsum = torch.zeros((), dtype=torch.float32, device=h.device)
    msum = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, T, block):
        l, m = remat(_block_loss, h2[i:i + block], w, lab[i:i + block],
                     m1[i:i + block], z_loss, vocab_start, axis)
        lsum = lsum + l
        msum = msum + m
    return lsum / torch.clamp(msum, min=1.0)
