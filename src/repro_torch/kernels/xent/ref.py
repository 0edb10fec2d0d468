"""Oracle: materialize-everything cross-entropy from hidden states."""

from __future__ import annotations

from typing import Optional

import torch


def xent_from_hidden(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     z_loss: float = 0.0) -> torch.Tensor:
    """h: (B, S, d), w: (d, V), labels: (B, S) int.  Full-logits
    reference: the (masked) token mean of ``lse - gold`` (+ ``z_loss ·
    lse²``)."""
    logits = (h @ w.to(h.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - gold
    if z_loss:
        loss = loss + z_loss * lse ** 2
    if mask is not None:
        mask = mask.float()
        return (loss * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
