"""Wrappers of the DP fill kernels and the fill drivers of the ``"plain"``,
``"cuda"`` and ``"cuda_fused"`` impls.

Kernels (CUDA C++ in ``csrc/``; each wrapper runs the plain version of
:mod:`.ref` on CPU tensors, launches the kernel on CUDA tensors, and counts
its launches in :mod:`repro_torch.counters`):

- :func:`band_min_two_tier` (K1, ``dp_band_min.cu``) and
  :func:`band_min_offload` (K5a, same file): one band's split minimum, one
  launch per band;
- :func:`fused_fill_two_tier` (K2) and :func:`fused_fill_offload` (K5b),
  ``dp_fused_fill.cu``: the whole band recursion on the card in one
  cooperative launch per fill, for chains of up to :func:`max_length`
  stages.

Drivers: :func:`fill_two_tier` / :func:`fill_offload` hand the one copy of
the recursion in :mod:`repro_torch.core.dp_kernels` a band minimum that
stacks the band's split planes into ``(d, ns, W)`` tensors on the requested
device (the dispatch pattern of the JAX package's ``impl="pallas"``);
:func:`fill_two_tier_fused` / :func:`fill_offload_fused` stage the base case,
offsets, clamped integer vectors and thresholds once, run the fused fill,
and broadcast the saturated tail on the host afterwards.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ... import counters
from ...core import dp_kernels
from ...core.dp_kernels import COST_DTYPE, BandedTable, OffloadSplits
from .. import _build
from . import ref

NAME = "dp_band_min_two_tier"
NAME_OFFLOAD = "dp_band_min_offload"
NAME_FUSED = "dp_fused_fill_two_tier"
NAME_FUSED_OFFLOAD = "dp_fused_fill_offload"

#: int32 clamp of the fused fills' integer operands (``_FillCtx.raw_wa``'s)
INT_CLAMP = 1 << 30

_P, _I = ctypes.c_void_p, ctypes.c_int
_F32 = torch.float32
_F32_PAIR = (_F32, _F32)

_TWO_TIER = _build.Binding("dp_band_min", NAME, [_P, _P, _P, _I, _I, _I, _P])
_OFFLOAD = _build.Binding("dp_band_min", NAME_OFFLOAD,
                          [_P] * 9 + [_I, _I, _I, _P])
_BAND_ERROR = _build.Binding("dp_band_min", "dp_band_min_error_string", [_I],
                             ctypes.c_char_p)
_FUSED = _build.Binding("dp_fused_fill", NAME_FUSED,
                        [_P] * 9 + [_I, _I, _I, _P])
_FUSED_OFFLOAD = _build.Binding("dp_fused_fill", NAME_FUSED_OFFLOAD,
                                [_P] * 12 + [_I, _I, _I, _I, _P])
_FUSED_ERROR = _build.Binding("dp_fused_fill", "dp_fused_fill_error_string",
                              [_I], ctypes.c_char_p)
_FUSED_MAX_LENGTH = _build.Binding("dp_fused_fill",
                                   "dp_fused_fill_max_length", [])


def _check_operands(what: str, tensors, dtypes) -> int:
    """One device for all; each of its dtype; contiguous on CUDA.  Returns
    the device's index, -1 off the card.  One launch is a few microseconds
    of device work, so this runs once per call and reads little."""
    index = tensors[0].get_device()
    for t, dt in zip(tensors, dtypes):
        if t.dtype != dt:
            raise TypeError(f"{what} needs {dt} operands, got {t.dtype}")
        if t.get_device() != index:
            raise ValueError(f"{what}: operands must be on one device")
        if index >= 0 and not t.is_contiguous():
            raise ValueError(f"{what} needs contiguous operands")
    return index


def band_min_two_tier(r: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """``min_j (r[j] + lm[j])`` of two ``(d, ns, W)`` float32 stacks: the
    Hopper kernel on CUDA tensors, the plain version on any other device."""
    shape = r.shape
    if len(shape) != 3 or lm.shape != shape:
        raise ValueError(f"band_min_two_tier needs two (d, ns, W) stacks of "
                         f"one shape, got {tuple(shape)} and "
                         f"{tuple(lm.shape)}")
    index = _check_operands(NAME, (r, lm), _F32_PAIR)
    if index < 0:
        return ref.band_min_two_tier(r, lm)
    d, ns, w = shape
    out = r.new_empty((ns, w))
    if ns * w == 0:
        return out
    status = (_TWO_TIER.fn or _TWO_TIER.load())(
        r.data_ptr(), lm.data_ptr(), out.data_ptr(), d, ns, w,
        _build.stream(index))
    if status:
        _build.check(status, NAME, _BAND_ERROR)
    counters.bump(NAME)
    return out


def band_min_offload(r: torch.Tensor, r3: torch.Tensor, lmb: torch.Tensor,
                     lme: torch.Tensor, lmb3: torch.Tensor, toff: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The offload band's three split minima of five ``(d, ns, W)`` float32
    stacks and the ``(ns, 1)`` CUM-shifted offload times: the Hopper kernel
    on CUDA tensors, the plain version on any other device."""
    planes = (r, r3, lmb, lme, lmb3)
    if r.ndim != 3 or any(p.shape != r.shape for p in planes):
        raise ValueError(f"band_min_offload needs five (d, ns, W) stacks of "
                         f"one shape, got {[tuple(p.shape) for p in planes]}")
    d, ns, w = r.shape
    if tuple(toff.shape) != (ns, 1):
        raise ValueError(f"band_min_offload needs toff of shape ({ns}, 1), "
                         f"got {tuple(toff.shape)}")
    index = _check_operands(NAME_OFFLOAD, planes + (toff,), (_F32,) * 6)
    if index < 0:
        return ref.band_min_offload(r, r3, lmb, lme, lmb3, toff)
    outs = tuple(r.new_empty((ns, w)) for _ in range(3))
    if ns * w == 0:
        return outs
    status = (_OFFLOAD.fn or _OFFLOAD.load())(
        *(t.data_ptr() for t in planes + (toff,) + outs), d, ns, w,
        _build.stream(index))
    if status:
        _build.check(status, NAME_OFFLOAD, _BAND_ERROR)
    counters.bump(NAME_OFFLOAD)
    return outs


_FUSED_TYPES = (torch.int32,) * 3 + (torch.float32,) * 3 + (torch.int32,) * 2


def _check_fused(what: str, tables, ints, L: int, W: int) -> int:
    """``ints`` = (off, wa, wb, cum, uf, ub, mn, ma[, toff, tpre])."""
    ncells = (L + 1) * (L + 2) // 2
    if L < 1 or W < 1:
        raise ValueError(f"{what} needs L >= 1 and W >= 1, got L={L}, W={W}")
    for t in tables:
        if tuple(t.shape) != (ncells, W):
            raise ValueError(f"{what} needs ({ncells}, {W}) tables, got "
                             f"{tuple(t.shape)}")
    off, wa, wb, cum, uf, ub, mn, ma = ints[:8]
    if off.numel() != L + 2 or wa.numel() < L + 1 or cum.numel() < L + 1 \
            or min(wb.numel(), uf.numel(), ub.numel()) < L + 1 \
            or tuple(mn.shape) != (L, L) or tuple(ma.shape) != (L, L) \
            or any(t.numel() < L + 1 for t in ints[8:]):
        raise ValueError(f"{what}: operand vectors too short for L={L}")
    index = _check_operands(what, tuple(tables) + tuple(ints),
                            (_F32,) * len(tables) + _FUSED_TYPES
                            + (_F32,) * (len(ints) - 8))
    if index >= 0 and L > max_length():
        raise ValueError(f"{what} takes chains of up to {max_length()} "
                         f"stages in one launch, got L={L}")
    return index


def max_length() -> int:
    """The longest chain K2 and K5b take on the card, as the built library
    says (a block stages the chain's offsets, ``WA`` and ``CUM`` in shared
    memory; so it builds the library).  The plain versions take any."""
    return (_FUSED_MAX_LENGTH.fn or _FUSED_MAX_LENGTH.load())()


def fused_fill_two_tier(t0, off, wa, wb, cum, uf, ub, mn, ma, *, L: int,
                        W: int, allow_fall: bool) -> torch.Tensor:
    """The whole two-tier band recursion (K2): ``t0`` ``(ncells, W)`` float32
    holds the base-case band and ``+inf`` elsewhere; int32 ``off`` (L+2),
    ``wa``/``wb`` (clamped to ``[0, 2^30]``) and ``mn``/``ma`` ``(L, L)``
    thresholds; float32 ``cum``/``uf``/``ub``.  Returns the filled table."""
    ints = (off, wa, wb, cum, uf, ub, mn, ma)
    index = _check_fused(NAME_FUSED, (t0,), ints, L, W)
    if index < 0:
        return ref.fused_fill_two_tier(t0, *ints, L=L, W=W,
                                       allow_fall=allow_fall)
    t = t0.clone()
    status = (_FUSED.fn or _FUSED.load())(
        *(x.data_ptr() for x in (t,) + ints), L, W, int(allow_fall),
        _build.stream(index))
    _build.check(status, NAME_FUSED, _FUSED_ERROR)
    counters.bump(NAME_FUSED)
    return t


def fused_fill_offload(t0b, t0e, off, wa, wb, cum, uf, ub, mn, ma, toff,
                       tpre, *, L: int, W: int, allow_fall: bool,
                       host_on: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole offload band recursion (K5b): operands as
    :func:`fused_fill_two_tier`, two base-case tables, and the float32
    CUM-shifted offload times ``toff`` and prefetch times ``tpre`` (zeros
    without a host tier).  Returns ``(Cb, Ce)``."""
    ints = (off, wa, wb, cum, uf, ub, mn, ma, toff, tpre)
    index = _check_fused(NAME_FUSED_OFFLOAD, (t0b, t0e), ints, L, W)
    if index < 0:
        return ref.fused_fill_offload(t0b, t0e, *ints, L=L, W=W,
                                      allow_fall=allow_fall, host_on=host_on)
    tb, te = t0b.clone(), t0e.clone()
    status = (_FUSED_OFFLOAD.fn or _FUSED_OFFLOAD.load())(
        *(x.data_ptr() for x in (tb, te) + ints), L, W,
        int(allow_fall), int(host_on), _build.stream(index))
    _build.check(status, NAME_FUSED_OFFLOAD, _FUSED_ERROR)
    counters.bump(NAME_FUSED_OFFLOAD)
    return tb, te


# ---------------------------------------------------------------------------
# Per-band drivers (impl="plain" / "cuda")
# ---------------------------------------------------------------------------

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


def fill_offload(dchain, S: int, allow_fall: bool = True,
                 v: Optional[dict] = None,
                 device: Union[str, torch.device] = "cpu"
                 ) -> Tuple[BandedTable, BandedTable]:
    """Offload band fill with the split reduction on ``device``: the band's
    planes (the C3 right planes built by slices or by the gather, exactly as
    the numpy fill builds them) go to :func:`band_min_offload`, or, without a
    host tier, to :func:`band_min_two_tier` once per input state."""
    dev = torch.device(device)

    def band_min(sp: OffloadSplits, resb, rese, c3):
        d, shape = sp.d, (sp.d, sp.ns, sp.W)
        rs, lbs, les = (np.empty(shape, dtype=COST_DTYPE) for _ in range(3))
        if c3 is not None:
            r3s, lb3s = (np.empty(shape, dtype=COST_DTYPE) for _ in range(2))
        for j in range(d):
            rs[j], lbs[j], les[j] = sp.right(j), sp.left_b(j), sp.left_e(j)
            if c3 is not None:
                sp.right3(j, r3s[j])
                lb3s[j] = sp.left_b3(j)

        def on(a):
            return torch.from_numpy(a).to(dev)

        if c3 is None:
            outs = (band_min_two_tier(on(rs), on(lbs)),
                    band_min_two_tier(on(rs), on(les)))
            targets = (resb, rese)
        else:
            outs = band_min_offload(on(rs), on(r3s), on(lbs), on(les),
                                    on(lb3s), on(np.ascontiguousarray(sp.toff)))
            targets = (resb, rese, c3)
        for dst, res in zip(targets, outs):
            dst[:] = res.cpu().numpy()

    return dp_kernels.fill_offload(dchain, S, allow_fall=allow_fall, v=v,
                                   band_min=band_min)


# ---------------------------------------------------------------------------
# Fused drivers (impl="cuda_fused", and their plain counterparts on the CPU)
# ---------------------------------------------------------------------------

class FusedOperands:
    """Host staging of a fused fill: the offsets, the clamped int32 vectors
    and the per-band thresholds, all computed before the fill starts.

    Width: ``W`` is the widest unsaturated band (the caps grow with ``d``),
    so the tables are ``(ncells, W)``.  Columns the banded fill would
    broadcast are computed directly on the card; by the saturation invariant
    they are the same values, so :meth:`unpack` broadcasts column ``W - 1``
    over ``[W, S]``.  Rows are bounds-checked on the card, so nothing is
    padded."""

    def __init__(self, dchain, S: int, allow_fall: bool,
                 v: Optional[dict] = None):
        if v is None:
            v = dp_kernels._views(dchain)
        L = dchain.length
        self.v, self.L, self.S = v, L, S
        ctx = dp_kernels._FillCtx(v, L, S)
        self.ctx = ctx
        caps = dp_kernels.saturation_caps(v, S, allow_fall)
        self.W = dp_kernels.band_width(caps, L, S)
        self.off = np.concatenate(
            [[0], np.cumsum([L + 1 - d for d in range(L + 1)])]
        ).astype(np.int32)
        self.ncells = int(self.off[-1])
        self.wa = np.clip(ctx.WA, 0, INT_CLAMP).astype(np.int32)
        self.wb = np.clip(ctx.WB, 0, INT_CLAMP).astype(np.int32)
        self.cum, self.uf, self.ub = ctx.CUM32, ctx.UF32, ctx.UB32
        n = max(L, 1)
        self.mn = np.zeros((n, n), dtype=np.int32)
        self.ma = np.zeros((n, n), dtype=np.int32)
        for d in range(1, L + 1):
            ma_d, mn_d = ctx.thresholds(d)
            self.mn[d - 1, :L + 1 - d] = np.clip(mn_d, 0, INT_CLAMP)
            self.ma[d - 1, :L + 1 - d] = np.clip(ma_d, 0, INT_CLAMP)

    def base_table(self) -> BandedTable:
        tab = BandedTable(self.L, self.S)
        self.ctx.base_case(tab)
        return tab

    def initial(self, tab: BandedTable, dev: torch.device) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(tab.data[:, 1:1 + self.W])).to(dev)

    def tensors(self, dev: torch.device, *extra: np.ndarray):
        """(off, wa, wb, cum, uf, ub, mn, ma, *extra) on ``dev``."""
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (self.off, self.wa, self.wb, self.cum, self.uf,
                               self.ub, self.mn, self.ma) + extra)

    def unpack(self, t: torch.Tensor, tab: BandedTable) -> BandedTable:
        W, S = self.W, self.S
        tab.data[:, 1:1 + W] = t.cpu().numpy()
        if W <= S:
            tab.data[:, 1 + W:] = tab.data[:, W:W + 1]   # saturated tail
        return tab


def fill_two_tier_fused(dchain, S: int, allow_fall: bool = True,
                        v: Optional[dict] = None,
                        device: Union[str, torch.device] = "cuda"
                        ) -> BandedTable:
    """Two-tier fill with the whole recursion in :func:`fused_fill_two_tier`
    on ``device``.  Bit-equal to ``impl="banded"`` on f32-exact chains."""
    ops_ = FusedOperands(dchain, S, allow_fall, v)
    tab = ops_.base_table()
    if ops_.L == 0:
        return tab
    dev = torch.device(device)
    t = fused_fill_two_tier(ops_.initial(tab, dev), *ops_.tensors(dev),
                            L=ops_.L, W=ops_.W, allow_fall=allow_fall)
    return ops_.unpack(t, tab)


def fill_offload_fused(dchain, S: int, allow_fall: bool = True,
                       v: Optional[dict] = None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Tuple[BandedTable, BandedTable]:
    """Offload fill with the whole recursion in :func:`fused_fill_offload`
    on ``device``: both tables stay there from the first band to the
    last."""
    ops_ = FusedOperands(dchain, S, allow_fall, v)
    tb, te = ops_.base_table(), ops_.base_table()
    L = ops_.L
    if L == 0:
        return tb, te
    host = dchain.chain.host
    host_on = host is not None and host.enabled
    if host_on:
        toff, tpre = dp_kernels.offload_vectors(dchain, ops_.v)
    else:
        toff = tpre = np.zeros(L + 1, dtype=COST_DTYPE)
    dev = torch.device(device)
    outb, oute = fused_fill_offload(
        ops_.initial(tb, dev), ops_.initial(te, dev),
        *ops_.tensors(dev, toff, tpre), L=L, W=ops_.W,
        allow_fall=allow_fall, host_on=host_on)
    return ops_.unpack(outb, tb), ops_.unpack(oute, te)
