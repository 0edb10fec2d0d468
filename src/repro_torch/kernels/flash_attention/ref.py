"""Plain PyTorch causal GQA attention (the flash kernel's oracle and the
recompute path of its backward)."""

from __future__ import annotations

import math

import torch


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D), K divides H.  Causal, scores
    and softmax in float32, probabilities cast to v's dtype for the value
    product.  Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          k.float()) / math.sqrt(D)
    keep = (torch.arange(Skv, device=q.device)[None, :]
            <= torch.arange(Sq, device=q.device)[:, None])
    logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(B, Sq, H, D)
