"""Chunked cross-entropy: neither form materializes the full ``(B·S, V)``
logits — the largest activation of a 150k-vocab model.  No kernel: the
per-block products are plain matrix products, as they are XLA scans in the
JAX package.

:func:`token_chunked_xent` loops over token blocks whose body runs under a
per-block checkpoint (the PyTorch form of the JAX package's
``@jax.checkpoint`` scan body): only one ``(block, V)`` float32 logits
block is live at a time, and the backward recomputes it block by block.
Vocab-parallel under model-axis tensor parallelism: ``w`` holds this
rank's vocabulary columns and each block's log-partition and label logit
are reduced over the model group (the recompute reduces again).  This is
the loss the models run (``ModelConfig.logits_chunk``).

:func:`blockwise_xent` loops over vocabulary blocks instead (the
reference's ``blockwise_xent``): the forward keeps a running (max,
sum-exp, label logit) per token, the backward recomputes each logits block
and accumulates ``dh`` and that block's ``dW`` — peak memory
``O(B·S·block)``.  No model calls it, as no model of the reference does.
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


def _lse_scan(h2: torch.Tensor, w: torch.Tensor, labels1: torch.Tensor,
              block: int):
    """h2 (T, d), w (d, V), labels1 (T,): ``(lse (T,), gold (T,))`` in
    float32, one vocabulary block at a time."""
    T, V = h2.shape[0], w.shape[1]
    m = torch.full((T,), -torch.inf, dtype=torch.float32, device=h2.device)
    s = torch.zeros(T, dtype=torch.float32, device=h2.device)
    gold = torch.zeros(T, dtype=torch.float32, device=h2.device)
    for j0 in range(0, V, block):
        logits = (h2 @ w[:, j0:j0 + block].to(h2.dtype)).float()
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        col = j0 + torch.arange(logits.shape[1], device=h2.device)
        hit = labels1[:, None] == col[None, :]
        gold = gold + torch.where(hit, logits, 0.0).sum(dim=-1)
        m = m_new
    return m + torch.log(s), gold


class _BlockwiseXent(torch.autograd.Function):
    """Loss forward by :func:`_lse_scan`; the backward recomputes each
    vocabulary block's logits and accumulates ``dh`` (float32) and the
    block's columns of ``dW``."""

    @staticmethod
    def forward(ctx, h, w, labels, mask, block, z_loss):
        B, S, d = h.shape
        T = B * S
        h2, labels1 = h.reshape(T, d), labels.reshape(T)
        lse, gold = _lse_scan(h2, w, labels1, block)
        per_tok = lse - gold
        if z_loss:
            per_tok = per_tok + z_loss * lse ** 2
        if mask is not None:
            m1 = mask.reshape(T).float()
            denom = torch.clamp(m1.sum(), min=1.0)
            loss = (per_tok * m1).sum() / denom
            wgt = m1 / denom
        else:
            loss = per_tok.mean()
            wgt = torch.full((T,), 1.0 / T, dtype=torch.float32,
                             device=h.device)
        ctx.save_for_backward(h, w, labels, lse, wgt)
        ctx.block, ctx.z_loss = block, z_loss
        return loss

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse, wgt = ctx.saved_tensors
        B, S, d = h.shape
        T = B * S
        h2, labels1 = h.reshape(T, d), labels.reshape(T)
        coef = (g * wgt).float()                                # (T,)
        zcoef = 1.0 + 2.0 * ctx.z_loss * lse if ctx.z_loss else None
        dh = torch.zeros((T, d), dtype=torch.float32, device=h.device)
        dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
        for j0 in range(0, w.shape[1], ctx.block):
            wblk = w[:, j0:j0 + ctx.block]
            logits = (h2 @ wblk.to(h2.dtype)).float()
            p = torch.exp(logits - lse[:, None])
            if zcoef is not None:
                p = p * zcoef[:, None]
            col = j0 + torch.arange(logits.shape[1], device=h.device)
            hit = (labels1[:, None] == col[None, :]).float()
            dlogits = coef[:, None] * (p - hit)                 # (T, blk)
            dh += dlogits @ wblk.float().T
            dw[:, j0:j0 + ctx.block] = h2.float().T @ dlogits
        return (dh.reshape(B, S, d).to(h.dtype), dw.to(w.dtype), None, None,
                None, None)


def blockwise_xent(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, block: int = 8192,
                   z_loss: float = 0.0) -> torch.Tensor:
    """Masked token-mean cross-entropy of ``h @ w`` (+ ``z_loss · lse²``),
    vocabulary-chunked: h (B, S, d), w (d, V), labels (B, S) int, mask
    (B, S) or None; ``V`` need not be a multiple of ``block``.
    Differentiable in ``h`` and ``w``."""
    return _BlockwiseXent.apply(h, w, labels, mask, block, z_loss)
