"""Token-chunked cross-entropy: never materializes the full ``(B·S, V)``
logits — the largest activation of a 150k-vocab model.

A loop over token blocks whose body runs under a per-block checkpoint (the
PyTorch form of the JAX package's ``@jax.checkpoint`` scan body): only one
``(block, V)`` float32 logits block is live at a time, and the backward
recomputes it block by block.  No kernel: the per-block product is a plain
matrix product, as it is an XLA scan in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...core.rematerialize import remat


def _block_loss(hblk: torch.Tensor, w: torch.Tensor, lblk: torch.Tensor,
                mblk: torch.Tensor, z_loss: float):
    logits = (hblk @ w.to(hblk.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, lblk.long()[:, None])[:, 0]
    per = lse - gold
    if z_loss:
        per = per + z_loss * lse ** 2
    return torch.sum(per * mblk), torch.sum(mblk)


def token_chunked_xent(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None, block: int = 4096,
                       z_loss: float = 0.0) -> torch.Tensor:
    """Masked token-mean cross-entropy of ``h @ w``; h (B, S, d), w (d, V),
    labels (B, S) int, mask (B, S) or None."""
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
                     m1[i:i + block], z_loss)
        lsum = lsum + l
        msum = msum + m
    return lsum / torch.clamp(msum, min=1.0)
