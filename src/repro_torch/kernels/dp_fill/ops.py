"""Wrappers of the DP fill kernels and the fill drivers of the ``"plain"``,
``"cuda"`` and ``"cuda_fused"`` impls.

Kernels (CUDA C++ in ``csrc/``; each wrapper runs the plain version of
:mod:`.ref` on CPU tensors, launches the kernel on CUDA tensors, and counts
its launches in :mod:`repro_torch.counters`):

- :class:`TableBands` (K1 and K5a, ``dp_band_min.cu``): one band's split
  minima read in place from companion tables kept on the card, bound once
  per fill, one launch per band; :func:`band_min_two_tier` /
  :func:`band_min_offload` run the same kernel on split planes stacked into
  ``(d, ns, W)`` tensors (the JAX kernels' contract);
- :func:`fused_fill_two_tier` (K2) and :func:`fused_fill_offload` (K5b),
  ``dp_fused_fill.cu``: the whole band recursion on the card in one
  cooperative launch per fill, for chains of up to :func:`max_length`
  stages.

Drivers: :func:`fill_two_tier` / :func:`fill_offload` hand the one copy of
the recursion in :mod:`repro_torch.core.dp_kernels` a band minimum that
keeps the companion tables on the requested device for the whole fill,
sends up only each band's new rows and launches once per band;
:func:`fill_two_tier_fused` / :func:`fill_offload_fused` stage the base case,
offsets, clamped integer vectors and thresholds once, run the fused fill,
and broadcast the saturated tail on the host afterwards.
"""

from __future__ import annotations

import ctypes
import math
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
                          [_P] * 7 + [_I, _I, _I, _P])
_TABLES = _build.Binding("dp_band_min", "dp_band_min_tables",
                         [_P, _I, _I, _P])
_COPY = _build.Binding("dp_band_min", "dp_band_min_copy",
                       [_P, _P, ctypes.c_int64, _P])
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


def _check_operands(what: str, tensors, dtypes, strided: int = 0) -> int:
    """One device for all; each of its dtype; on CUDA contiguous, or for
    the first ``strided`` (tables read row by row) of unit column stride.
    Returns the device's index, -1 off the card.  One launch is a few
    microseconds of device work, so this runs once per call and reads
    little."""
    index = tensors[0].get_device()
    for i, (t, dt) in enumerate(zip(tensors, dtypes)):
        if t.dtype != dt:
            raise TypeError(f"{what} needs {dt} operands, got {t.dtype}")
        if t.get_device() != index:
            raise ValueError(f"{what}: operands must be on one device")
        if index >= 0 and not (t.stride(-1) == 1 if i < strided
                               else t.is_contiguous()):
            raise ValueError(f"{what} needs contiguous operands (tables: "
                             f"rows of unit column stride)")
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
    out = r.new_empty((3, ns, w))
    if ns * w == 0:
        return tuple(out)
    status = (_OFFLOAD.fn or _OFFLOAD.load())(
        *(t.data_ptr() for t in planes + (toff, out)), d, ns, w,
        _build.stream(index))
    if status:
        _build.check(status, NAME_OFFLOAD, _BAND_ERROR)
    counters.bump(NAME_OFFLOAD)
    return tuple(out)


class _Band(ctypes.Structure):
    """The C launcher's ``Band`` (``csrc/dp_band_min.cu``)."""
    _fields_ = [("r", _P), ("lm", _P * 3), ("r3", _P), ("cb", _P),
                ("wa", _P), ("cum", _P), ("toff", _P), ("out", _P),
                ("r_stride", ctypes.c_int64), ("l_stride", ctypes.c_int64),
                ("cb_stride", ctypes.c_int64)] + [
                    (k, _I) for k in ("nacc", "rows", "c3", "L", "S", "d",
                                      "ns", "w", "g")]


#: ``c3`` of :class:`TableBands` -> the C launcher's code
_C3_CODES = {None: -1, "slice": 1, "gather": 2}


class TableBands:
    """K1 or K5a bound to the companion tables of one per-band fill of an
    ``L``-stage chain (float32, one row per cell, band ``k`` from row
    ``k (L + 1) - k (k - 1) / 2``; views into a wider buffer too, the kernel
    taking their row strides): the operands are checked and packed for the
    C launcher once, then :meth:`launch` computes band ``d`` into the front
    of the flat float32 buffer ``out``.  On CUDA tensors that is one launch
    of the Hopper kernel, counted; on any other device the plain version.

    ``c3``: ``"two-tier"`` is K1 on ``(r, lefts[0])``; otherwise K5a on
    ``r`` and ``lefts = (Lmb, Lme[, Lmb3])`` (one row stride), without a
    host tier (``c3`` None: two minima), or with C3 (three), whose right
    plane is read from ``r`` at column ``wa[r] + c`` (``"slice"``, ``wa =
    min(WA, S + 1)`` int32, ``r`` padded by the widest shift) or gathered
    from the bare table ``cb`` (``"gather"``, ``S + 2`` wide, ``wa = WA``,
    and the float32 ``cum``), ``toff`` holding the CUM-shifted offload times
    (one per row)."""

    def __init__(self, r, lefts, out, *, L: int, S: int = 0, c3="two-tier",
                 cb=None, wa=None, cum=None, toff=None):
        if c3 != "two-tier" and c3 not in _C3_CODES:
            raise ValueError(f"TableBands: c3 must be 'two-tier', None, "
                             f"'slice' or 'gather', got {c3!r}")
        self.name = NAME if c3 == "two-tier" else NAME_OFFLOAD
        self.nacc = {"two-tier": 1, None: 2}.get(c3, 3)
        lefts = tuple(lefts)[:self.nacc]
        tables = (r,) + lefts + ((cb,) if c3 == "gather" else ())
        ncells = (L + 1) * (L + 2) // 2
        if L < 1 or len(lefts) < self.nacc or any(
                t.ndim != 2 or t.shape[0] < ncells for t in tables):
            raise ValueError(f"{self.name} needs L >= 1, {self.nacc} left "
                             f"tables and tables of at least {ncells} rows")
        if any(t.stride(0) != lefts[0].stride(0) for t in lefts):
            raise ValueError(f"{self.name}: the left tables must share one "
                             f"row stride")
        if c3 == "gather" and cb.shape[1] != S + 2:
            raise ValueError(f"{self.name}: cb must be S + 2 = {S + 2} "
                             f"wide, got {cb.shape[1]}")
        vectors = {}
        if self.nacc == 3:
            vectors = {"toff": (toff, _F32, L),
                       "wa": (wa, torch.int32, L + 1)}
            if c3 == "gather":
                vectors["cum"] = (cum, _F32, L + 1)
        for what, (v, _, n) in vectors.items():
            if v.ndim != 1 or v.numel() < n:
                raise ValueError(f"{self.name}: {what} needs at least {n} "
                                 f"elements, got {tuple(v.shape)}")
        self.index = _check_operands(
            self.name, tables + tuple(v for v, _, _ in vectors.values())
            + (out,), (_F32,) * len(tables)
            + tuple(t for _, t, _ in vectors.values()) + (_F32,),
            strided=len(tables))
        if out.ndim != 1:
            raise ValueError(f"{self.name} needs a flat output buffer")
        self.r, self.lefts, self.out = r, lefts, out
        self.cb, self.wa, self.cum, self.toff = cb, wa, cum, toff
        self.L, self.S, self.c3 = L, S, c3
        self.width = min(t.shape[1] for t in (r,) + lefts)
        if c3 == "slice":       # row r of R is read from column wa[r] on
            # (a copy to the host, once per fill, rather than a reduction
            # kernel on the card: a fill launches nothing but its bands)
            self.width = min(self.width,
                             r.shape[1] - int(wa[:L].cpu().max()))
        self.capacity = out.numel()
        if self.index >= 0:
            def ptr(t):
                return None if t is None else t.data_ptr()

            self.args = _Band(
                r=ptr(r), lm=(_P * 3)(*(ptr(t) for t in lefts)),
                cb=ptr(cb if c3 == "gather" else None),
                wa=ptr(wa if self.nacc == 3 else None),
                cum=ptr(cum if c3 == "gather" else None),
                toff=ptr(toff if self.nacc == 3 else None), out=ptr(out),
                r_stride=r.stride(0), l_stride=lefts[0].stride(0),
                cb_stride=cb.stride(0) if c3 == "gather" else 0,
                nacc=self.nacc, c3=_C3_CODES.get(c3, -1), L=L, S=S)
            self.address = ctypes.addressof(self.args)

    def launch(self, d: int, W: int) -> int:
        """Band ``d``'s ``(nacc, L + 1 - d, W)`` minima into the front of
        ``out``; returns their number of elements."""
        n = self.nacc * (self.L + 1 - d) * W
        if not (1 <= d <= self.L and 1 <= W <= self.width
                and n <= self.capacity):
            raise ValueError(f"{self.name}: band d={d}, W={W} outside the "
                             f"tables (L={self.L}, width {self.width}) or "
                             f"the output buffer")
        if self.index < 0:
            self.out[:n].view(-1, W).copy_(self.plain(d, W).reshape(-1, W))
            return n
        status = (_TABLES.fn or _TABLES.load())(
            self.address, d, W, _build.stream(self.index))
        if status:
            _build.check(status, self.name, _BAND_ERROR)
        counters.bump(self.name)
        return n

    def plain(self, d: int, W: int) -> torch.Tensor:
        """Band ``d``'s minima by the plain version (:mod:`.ref`)."""
        if self.nacc == 1:
            return ref.band_min_two_tier_tables(self.r, self.lefts[0],
                                                L=self.L, d=d, W=W)
        lmb3 = self.lefts[2] if self.nacc == 3 else None
        return ref.band_min_offload_tables(
            self.r, *self.lefts[:2], lmb3, self.cb, self.wa, self.cum,
            self.toff, L=self.L, S=self.S, d=d, W=W, c3=self.c3)


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

class _Uplink:
    """A per-band fill's host tables as the device sees them, for the whole
    fill: one buffer allocated once, each table a column range of its rows
    (so one copy moves a band's rows of every table), and a result buffer.

    :meth:`band` sends up the rows the host recursion published since the
    last band (band ``d - 1``'s before band ``d``, :meth:`publish`),
    launches band ``d`` and brings its minima back (:meth:`fetch`).  On the
    card the rows go up from a pinned staging buffer and the minima come
    down into another, both as asynchronous copies on the current stream,
    with one synchronize a band, so the staging buffers are free again when
    the next band starts.  On the CPU the buffer is a plain tensor, NaN
    until its rows are published (a row read too early shows in the
    result)."""

    def __init__(self, host_tables, L: int, nout: int, width: int,
                 dev: torch.device):
        self.host, self.L = host_tables, L
        self.card = dev.type == "cuda"
        self.sent = 0
        cols = np.cumsum([0] + [t.shape[1] for t in host_tables])
        self.cols = [(int(a), int(b)) for a, b in zip(cols[:-1], cols[1:])]
        shape = (host_tables[0].shape[0], int(cols[-1]))
        size = nout * L * width
        if self.card:
            self.buf = torch.empty(shape, dtype=_F32, device=dev)
            self.stage = torch.empty((L + 1, shape[1]), dtype=_F32,
                                     pin_memory=True)
            self.stage_np = self.stage.numpy()
            self.down = torch.empty(size, dtype=_F32, pin_memory=True)
            self.down_np = self.down.numpy()
            self.stream = torch.cuda.current_stream(dev)
            self.row_bytes = 4 * shape[1]
        else:
            self.buf = torch.full(shape, math.nan, dtype=_F32)
        self.tables = [self.buf[:, a:b] for a, b in self.cols]
        self.out = torch.empty(size, dtype=_F32, device=dev)

    def _copy(self, dst: int, src: int, nbytes: int) -> None:
        status = (_COPY.fn or _COPY.load())(dst, src, nbytes,
                                            self.stream.cuda_stream)
        if status:
            _build.check(status, "dp_band_min_copy", _BAND_ERROR)

    def publish(self, d: int) -> None:
        """Send up the rows before band ``d``'s first not sent yet."""
        L = self.L
        upto = d * (L + 1) - d * (d - 1) // 2          # band d's first row
        lo, rows = self.sent, upto - self.sent
        if self.card:
            for host, (a, b) in zip(self.host, self.cols):
                self.stage_np[:rows, a:b] = host[lo:upto]
            self._copy(self.buf.data_ptr() + lo * self.row_bytes,
                       self.stage.data_ptr(), rows * self.row_bytes)
        else:
            for host, t in zip(self.host, self.tables):
                t[lo:upto] = torch.from_numpy(host[lo:upto])
        self.sent = upto

    def fetch(self, n: int, targets, W: int) -> None:
        """Fill the host arrays ``targets`` (one per minimum, ``W`` wide)
        with the first ``n`` floats of the result buffer."""
        if self.card:
            self._copy(self.down.data_ptr(), self.out.data_ptr(), 4 * n)
            self.stream.synchronize()
            got = self.down_np[:n]
        else:
            got = self.out[:n].numpy()
        for dst, src in zip(targets, got.reshape(len(targets), -1, W)):
            dst[:] = src

    def band(self, bands: TableBands, d: int, W: int, targets) -> None:
        """Band ``d``'s minima into ``targets``: publish, launch, fetch."""
        self.publish(d)
        self.fetch(bands.launch(d, W), targets, W)


def fill_two_tier(dchain, S: int, allow_fall: bool = True,
                  v: Optional[dict] = None,
                  device: Union[str, torch.device] = "cpu") -> BandedTable:
    """Two-tier band fill with the split reduction on ``device``: the host
    recursion of :mod:`repro_torch.core.dp_kernels`, whose companion tables
    ``R`` and ``Lm`` stay on ``device`` for the whole fill, each band's new
    rows sent up before the band's one launch of K1 (:class:`TableBands`).
    Bit-equal to ``impl="banded"`` on f32-exact chains (same adds, same
    mins)."""
    dev = torch.device(device)
    link = bands = None

    def band_min(R, Lm, off, d, ns, W, out):
        nonlocal link, bands
        if link is None:
            L = ns + d - 1
            link = _Uplink((R, Lm), L, 1, R.shape[1], dev)
            bands = TableBands(link.tables[0], link.tables[1:], link.out,
                               L=L)
        link.band(bands, d, W, (out,))

    return dp_kernels.fill_two_tier(dchain, S, allow_fall=allow_fall, v=v,
                                    band_min=band_min)


def fill_offload(dchain, S: int, allow_fall: bool = True,
                 v: Optional[dict] = None,
                 device: Union[str, torch.device] = "cpu"
                 ) -> Tuple[BandedTable, BandedTable]:
    """Offload band fill with the split reduction on ``device``: the
    companion tables (``R``, ``Lmb``, ``Lme``; with a host tier ``Lmb3``,
    and the bare table when an activation is wider than the budget and C3
    gathers from it) stay on ``device`` for the whole fill, and each band is
    one launch of K5a (:class:`TableBands`), which forms the C3 right planes
    where it reads them, as ``OffloadSplits.right3`` does."""
    dev = torch.device(device)
    link = bands = None

    def band_min(sp: OffloadSplits, resb, rese, c3):
        nonlocal link, bands
        ctx = sp.ctx
        if link is None:
            mode = None if c3 is None else ("slice" if sp.slice_c3
                                            else "gather")
            tables = [sp.R, sp.Lmb, sp.Lme]
            if mode is not None:
                tables.append(sp.Lmb3)
            if mode == "gather":
                tables.append(sp.flat_b.reshape(-1, ctx.S2))
            link = _Uplink(tables, ctx.L, 2 if mode is None else 3, ctx.S1,
                           dev)
            t = link.tables
            vectors = {}
            if mode is not None:
                # WA as the C3 plane reads it, CUM, and toffP[:L] (band 1's
                # rows, so every band's)
                wa = np.minimum(ctx.WA, ctx.S1) if mode == "slice" \
                    else ctx.WA
                vectors = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for k, a in (("wa", wa.astype(np.int32)),
                                        ("cum", ctx.CUM32),
                                        ("toff", sp.toff[:, 0]))}
            bands = TableBands(t[0], t[1:4], link.out, L=ctx.L, S=ctx.S,
                               c3=mode, cb=t[4] if mode == "gather" else None,
                               **vectors)
        link.band(bands, sp.d, sp.W,
                  (resb, rese) if c3 is None else (resb, rese, c3))

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
