"""Plain PyTorch SSD (Mamba2's state-space duality, arXiv:2405.21060): the
chunked algorithm of ``repro.models.mamba2.ssd_chunked``, split at the seam
of the within-chunk kernel, and the sequential recurrence that validates it.

- :func:`chunk_terms` — the within-chunk output ``y_diag`` and each chunk's
  state contribution: the plain version of the Hopper kernel K6
  (``csrc/ssd_chunk.cu``).
- :func:`inter_chunk` — the recurrence across chunks and the incoming-state
  term ``y_off``, run in PyTorch on both the plain and the kernel path.
- :func:`ssd_chunked` — padding plus both: the oracle, the CPU path and the
  recompute of the kernel path's backward.
- :func:`ssd_naive` — the O(S) sequential recurrence, ground truth for all.

Shapes: x (B, S, H, P), dt (B, S, H) after softplus, A (H,) negative,
Bm/Cm (B, S, G, N) with G dividing H (head ``h`` reads group ``h // (H/G)``).
Every product is taken in float32.  B and C are never repeated per head: the
scores ``C·Bᵀ`` are computed once per group.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

Blocks = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def _decay_matrix(da: torch.Tensor) -> torch.Tensor:
    """``L[..., i, j] = exp(cs_i − cs_j)`` for ``j <= i`` else 0, with ``cs``
    the cumulative sum of ``da`` over its last axis (``exp`` of the JAX
    package's ``_segsum``; the masked entries are ``exp(−inf)``)."""
    Q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones((Q, Q), dtype=torch.bool, device=da.device).tril()
    return torch.exp(torch.where(keep, diff, float("-inf")))


def chunk_terms(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Within-chunk terms, S a multiple of ``chunk``.  Returns ``y_diag``
    (B, S, H, P) float32, ``((C·Bᵀ) ⊙ L ⊙ dt)·x`` per chunk, and ``states``
    (B, S/chunk, H, P, N) float32, ``xᵀ·(B ⊙ exp(cs_last − cs) ⊙ dt)``."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nc, R = S // chunk, H // G
    xr = x.reshape(Bsz, nc, chunk, G, R, P).float()
    dtr = dt.reshape(Bsz, nc, chunk, G, R).float()
    Bg = Bm.reshape(Bsz, nc, chunk, G, N).float()
    Cg = Cm.reshape(Bsz, nc, chunk, G, N).float()
    da = dtr * A.float().reshape(G, R)                    # (B,nc,Q,G,R)
    cs = torch.cumsum(da, dim=2)
    L = _decay_matrix(da.permute(0, 1, 3, 4, 2))          # (B,nc,G,R,Q,Q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cg, Bg)   # (B,nc,G,Q,Q)
    w = scores[:, :, :, None] * L * dtr.permute(0, 1, 3, 4, 2)[..., None, :]
    y_diag = torch.einsum("bcgrqk,bckgrp->bcqgrp", w, xr)
    decay = torch.exp(cs[:, :, -1:] - cs)                 # (B,nc,Q,G,R)
    states = torch.einsum("bcqgrp,bcqgn->bcgrpn",
                          xr * (decay * dtr)[..., None], Bg)
    return (y_diag.reshape(Bsz, S, H, P),
            states.reshape(Bsz, nc, H, P, N))


def inter_chunk(y_diag: torch.Tensor, states: torch.Tensor, dt: torch.Tensor,
                A: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential scan over the chunk states and the contribution of the
    state entering each chunk.  Returns ``y`` (B, S, H, P) float32 and the
    final state (B, H, P, N) float32."""
    Bsz, S, H, P = y_diag.shape
    G, N = Cm.shape[2], Cm.shape[3]
    nc, R = S // chunk, H // G
    cs = torch.cumsum(dt.reshape(Bsz, nc, chunk, H).float() * A.float(),
                      dim=2)                              # (B,nc,Q,H)
    chunk_decay = torch.exp(cs[:, :, -1])                 # (B,nc,H)
    st = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=y_diag.device)
          if init_state is None else init_state.float())
    prev = []
    for c in range(nc):                                   # state entering c
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_g = torch.stack(prev, 1).reshape(Bsz, nc, G, R, P, N)
    Cg = Cm.reshape(Bsz, nc, chunk, G, N).float()
    y_off = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cg, prev_g)
    y_off = y_off * torch.exp(cs).reshape(Bsz, nc, chunk, G, R)[..., None]
    return y_diag + y_off.reshape(Bsz, S, H, P), st


def pad_to_chunks(chunk: int, x: torch.Tensor, dt: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor):
    """Pad time to a multiple of ``chunk`` with zeros (``dt = 0`` is a step
    that changes nothing)."""
    pad = -x.shape[1] % chunk
    if not pad:
        return x, dt, Bm, Cm
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(Bm, (0, 0, 0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, 0, 0, pad)))


def chunked_with(blocks: Blocks, x, dt, A, Bm, Cm, chunk: int,
                 init_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD with its within-chunk terms from ``blocks``
    (:func:`chunk_terms` or the kernel).  Returns ``y`` (B, S, H, P) in x's
    dtype and the final state (B, H, P, N) float32."""
    S = x.shape[1]
    xp, dtp, Bp, Cp = pad_to_chunks(chunk, x, dt, Bm, Cm)
    y_diag, states = blocks(xp, dtp, A, Bp, Cp, chunk)
    y, final = inter_chunk(y_diag, states, dtp, A, Cp, chunk, init_state)
    return y[:, :S].to(x.dtype), final


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD in plain PyTorch (the JAX package's oracle)."""
    return chunked_with(chunk_terms, x, dt, A, Bm, Cm, chunk, init_state)


def ssd_naive(x, dt, A, Bm, Cm, init_state=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential recurrence ``s_t = exp(dt_t·A) s_{t−1} + dt_t x_t B_tᵀ``,
    ``y_t = s_t C_t``, in float32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Br = Bm.float().repeat_interleave(H // G, dim=2)
    Cr = Cm.float().repeat_interleave(H // G, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    st = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)                 # (B,H)
        st = st * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], Br[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", st, Cr[:, t]))
    return torch.stack(ys, 1).to(x.dtype), st
