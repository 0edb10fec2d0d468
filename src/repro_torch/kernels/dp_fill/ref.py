"""Plain PyTorch version of the DP band minimum (kernel parity oracle)."""

from __future__ import annotations

import torch


def band_min_two_tier(r: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """``min_j (r[j] + lm[j])`` over the stacked split axis."""
    return torch.amin(r + lm, dim=0)
