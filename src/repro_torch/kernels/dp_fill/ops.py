"""Band-fill host loop for ``impl="plain"`` / ``impl="cuda"`` and the wrapper of
the DP band-min kernel (``csrc/dp_band_min.cu``).

The recursion is :func:`repro_torch.core.dp_kernels.fill_two_tier` itself;
this module hands it a band minimum that stacks the band's ``d`` split planes
of the companion tables into ``(d, ns, W)`` ``R``/``Lm`` tensors on the
requested device and reduces them there — one kernel launch per band on a
CUDA device (the dispatch pattern of the JAX package's ``impl="pallas"``),
the plain PyTorch reduction on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np
import torch

from ... import counters
from ...core import dp_kernels
from ...core.dp_kernels import COST_DTYPE, BandedTable
from .. import _build
from . import ref

NAME = "dp_band_min_two_tier"


def _lib() -> ctypes.CDLL:
    lib = _build.library("dp_band_min")
    fn = lib.dp_band_min_two_tier
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dp_band_min_error_string.argtypes = [ctypes.c_int]
    lib.dp_band_min_error_string.restype = ctypes.c_char_p
    return lib


def band_min_two_tier(r: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """``min_j (r[j] + lm[j])`` of two ``(d, ns, W)`` float32 stacks: the
    Hopper kernel on CUDA tensors, the plain version on any other device."""
    if r.ndim != 3 or r.shape != lm.shape:
        raise ValueError(f"band_min_two_tier needs two (d, ns, W) stacks of "
                         f"one shape, got {tuple(r.shape)} and "
                         f"{tuple(lm.shape)}")
    if r.dtype != torch.float32 or lm.dtype != torch.float32:
        raise TypeError("band_min_two_tier works on float32")
    if r.device != lm.device:
        raise ValueError("r and lm must be on one device")
    if not r.is_cuda:
        return ref.band_min_two_tier(r, lm)
    if not (r.is_contiguous() and lm.is_contiguous()):
        raise ValueError("band_min_two_tier needs contiguous stacks")
    d, ns, w = r.shape
    out = torch.empty((ns, w), dtype=torch.float32, device=r.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    status = lib.dp_band_min_two_tier(
        r.data_ptr(), lm.data_ptr(), out.data_ptr(), d, ns, w,
        torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(status, NAME, lib.dp_band_min_error_string)
    counters.bump(NAME)
    return out


def fill_two_tier(dchain, S: int, allow_fall: bool = True,
                  v: Optional[dict] = None,
                  device: Union[str, torch.device] = "cpu") -> BandedTable:
    """Two-tier band fill with the split reduction on ``device``.  Bit-equal
    to ``impl="banded"`` on f32-exact chains (same adds, same mins)."""
    dev = torch.device(device)

    def band_min(R, Lm, off, d, ns, W, out):
        rs = np.empty((d, ns, W), dtype=COST_DTYPE)
        ls = np.empty((d, ns, W), dtype=COST_DTYPE)
        for j in range(d):                  # split sp = s + 1 + j
            base = int(off[d - 1 - j]) + 1 + j
            rs[j] = R[base:base + ns, :W]
            ls[j] = Lm[off[j]:off[j] + ns, :W]
        res = band_min_two_tier(torch.from_numpy(rs).to(dev),
                                torch.from_numpy(ls).to(dev))
        out[:] = res.cpu().numpy()

    return dp_kernels.fill_two_tier(dchain, S, allow_fall=allow_fall, v=v,
                                    band_min=band_min)
