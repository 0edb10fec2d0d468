"""Banded, split-batched DP fills for the two-tier and the offload
(three-tier) checkpointing solvers — a copy of ``repro.core.dp_kernels``
without the thread pool, the unpruned mode and the seed reference tables.

- Tables are stored upper-triangular only (``1 <= s <= t <= L+1``), one
  contiguous float32 block per sub-chain length ``d = t - s``; no
  ``choice``/``split`` tables (branch decisions are recomputed at the O(L)
  cells the reconstruction visits, :func:`choose_two_tier`).
- For each length ``d`` the C1 candidates of **all** starts are evaluated
  split by split into a running minimum.  Two companion tables collapse each
  candidate to one add: ``R[s',t][m] = C[s',t][m - WA[s'-1]] + CUM[s'-1]``
  (the memory shift pre-applied, ``+inf`` below it) and
  ``Lm[s,t][m] = C[s,t][m] - CUM[s-1]`` — the forward-stream cost telescopes.
- The offload C3 plane folds its stall into a max
  (``X + max(T_off - X, 0) = max(X, T_off)``) and reads the same ``R`` at a
  parent-side column offset, so it too is one add per split.
- Saturated m-column pruning (:func:`saturation_caps`): each band is filled
  only up to a frontier column computable before any fill runs, and the last
  computed column is broadcast across the rest — bit-identical tables.

Exactness: every quantity of an f32-exact chain (integer stage costs) is
exactly representable in float32, and min does not round, so every
implementation of the band minimum gives bit-identical tables.

Four implementations share the recursion (``KNOWN_IMPLS``): ``"banded"``
(numpy), ``"plain"`` (the host band loop of :mod:`repro_torch.kernels.dp_fill`
with the PyTorch band minimum on CPU tensors), ``"cuda"`` (the same loop
with the band minimum on the hand-written Hopper kernels, one launch per
band) and ``"cuda_fused"`` (the whole recursion on the card: the tables and
their companions stay in device memory from the first band to the last).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

INFEASIBLE = np.inf
COST_DTYPE = np.float32
_F32 = np.float32
_INF32 = np.float32(np.inf)

#: The DP fill implementations every solver entry point accepts.
KNOWN_IMPLS = ("banded", "plain", "cuda", "cuda_fused")

#: ``band_min(R, Lm, off, d, ns, W, out)`` writes the split minimum of band
#: ``d`` into ``out`` (``(ns, W)``, preset to ``+inf``).
BandMin = Callable[[np.ndarray, np.ndarray, np.ndarray, int, int, int,
                    np.ndarray], None]


# ---------------------------------------------------------------------------
# 1-based views of a DiscreteChain (shared by fills, chooses, and rebuilds)
# ---------------------------------------------------------------------------

def _views(dchain) -> dict:
    """1-based views aligned with paper notation (see chain.py docstring)."""
    L = dchain.length
    uf = np.concatenate([[0.0], dchain.uf])          # UF[l], l=1..L+1
    ub = np.concatenate([[0.0], dchain.ub])
    wabar = np.concatenate([[0], dchain.wabar])      # WABAR[l]
    of = np.concatenate([[0], dchain.of])
    ob = np.concatenate([[0], dchain.ob])
    wa = np.asarray(dchain.wa)                       # WA[i], i=0..L
    wd = np.concatenate([dchain.wdelta, [0]])        # WD[i], i=0..L+1 (δ^{L+1}=0)
    cum_uf = np.cumsum(uf)                           # cum_uf[l] = Σ_{k<=l} UF[k]
    return dict(L=L, UF=uf, UB=ub, WA=wa, WABAR=wabar, OF=of, OB=ob, WD=wd,
                CUM_UF=cum_uf)


def _m_all(v: dict, s: int, t: int) -> int:
    return int(max(v["WD"][t] + v["WABAR"][s] + v["OF"][s],
                   v["WD"][s] + v["WABAR"][s] + v["OB"][s]))


def _m_none(v: dict, s: int, t: int) -> int:
    best = v["WD"][t] + v["WA"][s] + v["OF"][s]
    js = np.arange(s + 1, t)
    if len(js):
        best = max(best, (v["WD"][t] + v["WA"][js - 1] + v["WA"][js]
                          + v["OF"][js]).max())
    return int(best)


def _h_vector(v: dict) -> np.ndarray:
    """H[j] = WA[j-1] + WA[j] + OF[j] (the F_∅-stream liveness of a^{j-1},
    a^j plus the forward overhead), j = 1..L — windows of it give m_∅."""
    L = v["L"]
    WA = np.asarray(v["WA"], dtype=np.int64)
    H = np.zeros(L + 1, dtype=np.int64)
    if L >= 1:
        H[1:] = WA[:-1] + WA[1:] + np.asarray(v["OF"][1:L + 1], dtype=np.int64)
    return H


def _band_thresholds(v: dict, H: np.ndarray, d: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(m_all, m_none) for every start ``s = 1..L+1-d`` at length ``d``."""
    L = v["L"]
    ns = L + 1 - d
    sv = np.arange(1, ns + 1)
    tv = sv + d
    WD, OF, OB = v["WD"], v["OF"], v["OB"]
    WA = np.asarray(v["WA"], dtype=np.int64)
    WB = np.asarray(v["WABAR"], dtype=np.int64)
    ma = np.maximum(WD[tv] + WB[sv] + OF[sv].astype(np.int64),
                    WD[sv] + WB[sv] + OB[sv].astype(np.int64))
    base = WA[sv] + OF[sv].astype(np.int64)
    if d >= 2:
        wmax = sliding_window_view(H[2:L + 1], d - 1)[:ns].max(axis=1)
        mn = WD[tv] + np.maximum(base, wmax)
    else:
        mn = WD[tv] + base
    return ma, mn


def saturation_caps(v: dict, S: int, allow_fall: bool = True) -> np.ndarray:
    """Per-band saturated-column frontier, computable *before any fill runs*:
    ``caps[d]`` is a column ``c <= S`` such that every cell of band ``d`` is
    constant in ``m`` on ``[c, S]`` (every threshold passed and every child
    read landing in the child's own constant region)."""
    L = v["L"]
    H = _h_vector(v)
    WA = np.asarray(v["WA"], dtype=np.int64)
    WB = np.asarray(v["WABAR"], dtype=np.int64)
    wshift = int(np.minimum(WA, S + 1).max(initial=0))
    if allow_fall:
        wshift = max(wshift, int(np.minimum(WB[1:], S + 1).max(initial=0)))
    caps = np.empty(L + 1, dtype=np.int64)
    sv = np.arange(1, L + 2)
    ma0 = (v["WD"][sv] + WB[sv]
           + np.maximum(v["OF"][sv], v["OB"][sv]).astype(np.int64))
    caps[0] = min(S, max(0, int(ma0.max())))
    for d in range(1, L + 1):
        ma, mn = _band_thresholds(v, H, d)
        t = int(mn.max())
        if allow_fall:
            t = max(t, int(ma.max()))
        caps[d] = min(S, max(t, int(caps[d - 1]) + wshift))
    return caps


def band_width(caps: np.ndarray, d: int, S: int) -> int:
    """Number of columns band ``d`` must actually compute."""
    return min(S + 1, int(caps[d]) + 1)


# ---------------------------------------------------------------------------
# Band storage
# ---------------------------------------------------------------------------

class BandedTable:
    """Upper-triangular cost table ``C[s, t, m]`` (``1 <= s <= t <= L+1``,
    ``0 <= m <= S``), stored as one contiguous float32 block per sub-chain
    length ``d = t - s``.

    Storage column 0 is a hidden ``+inf`` sentinel: gather indices are the
    memory index **plus one**, clipped to ``[0, S+1]``, so an out-of-budget
    shift reads infeasibility directly.  ``row(s, t)`` returns the m-indexed
    view (sentinel excluded).
    """

    def __init__(self, L: int, S: int):
        self.L, self.S = L, S
        sizes = np.array([L + 1 - d for d in range(L + 1)], dtype=np.int64)
        self.off = np.concatenate([[0], np.cumsum(sizes)])  # off[d] band start
        self.data = np.full((int(self.off[-1]), S + 2), INFEASIBLE,
                            dtype=COST_DTYPE)

    def band(self, d: int) -> np.ndarray:
        """Rows for all sub-chains of length ``d`` (s = 1..L+1-d), incl. the
        sentinel column."""
        return self.data[self.off[d]:self.off[d + 1]]

    def row(self, s: int, t: int) -> np.ndarray:
        """``C[s, t, :]`` — the (S+1,) cost vector over memory slots."""
        return self.data[self.off[t - s] + (s - 1), 1:]

    @property
    def nbytes(self) -> int:
        return self.data.nbytes


class _FillCtx:
    """Everything a band fill needs that is independent of the band length."""

    def __init__(self, v: dict, L: int, S: int):
        self.v, self.L, self.S = v, L, S
        self.S1, self.S2 = S + 1, S + 2
        ms = np.arange(S + 1)
        self.ms = ms
        WA = np.asarray(v["WA"], dtype=np.int64)        # (L+1,) a^0..a^L
        WB = np.asarray(v["WABAR"], dtype=np.int64)     # (L+2,) 1-based
        self.WA, self.WB = WA, WB
        # storage-column gather indices (sentinel layout: column = m - w + 1,
        # clipped to [0, S+1]; 0 reads +inf, S+1 reads m = S)
        self.idx_wb = np.clip(ms[None, :] - WB[:, None] + 1,
                              0, S + 1).astype(np.int32)
        # raw (unclipped) m - WA[p], for the offload branch whose shift also
        # depends on the group input; clamped low so int32 cannot overflow
        # after adding WA[s-1] back (values below -2^30 are equally infeasible)
        self.raw_wa = np.clip(ms[None, :] - WA[:, None],
                              -(1 << 30), S).astype(np.int32)
        # flat-storage row strides: is2[i] = i * (S+2)
        self.is2 = (np.arange(L + 1, dtype=np.int64) * self.S2
                    ).astype(np.int32)
        # Activation sizes come quantized into few distinct slot counts, so
        # per-row shifted reads are done as one contiguous block copy per
        # distinct WA value.  groups[w] lists the p's (= band row indices of
        # the cells whose *input* is a^p) with min(WA[p], S+1) == w.
        wvals = np.minimum(WA, S + 1)
        self.groups = [(int(w), np.nonzero(wvals == w)[0])
                       for w in np.unique(wvals)]
        self.wcap = int(wvals.max(initial=0))
        # True when no activation exceeds the whole budget — the precondition
        # for the slice-based (gather-free) C3 plane
        self.wa_uncapped = bool(WA.max(initial=0) <= S + 1)
        self.UF32 = v["UF"].astype(COST_DTYPE)
        self.UB32 = v["UB"].astype(COST_DTYPE)
        # CUM32[i] = float32 cumulative forward time up to stage i, baked
        # into the companion tables so the C1 candidate is one add per split
        self.CUM32 = v["CUM_UF"].astype(COST_DTYPE)
        self.OF, self.OB, self.WD = v["OF"], v["OB"], v["WD"]
        self.H = _h_vector(v)

    def thresholds(self, d: int) -> Tuple[np.ndarray, np.ndarray]:
        """(m_all, m_none) for every start ``s = 1..L+1-d`` at length d."""
        return _band_thresholds(self.v, self.H, d)

    def base_case(self, tab: BandedTable) -> None:
        """``C[s, s, m] = u_f^s + u_b^s`` wherever ``m >= m_all(s, s)``."""
        L = self.L
        sv = np.arange(1, L + 2)
        ma = (self.WD[sv] + self.WB[sv]
              + np.maximum(self.OF[sv], self.OB[sv]).astype(np.int64))
        vals = (self.v["UF"][sv] + self.v["UB"][sv]).astype(COST_DTYPE)
        band0 = tab.band(0)[:, 1:]
        band0[:] = np.where(self.ms[None, :] >= ma[:, None],
                            vals[:, None], _INF32)


def _build_r_band(ctx: _FillCtx, R: np.ndarray, tab: BandedTable, d: int,
                  clamp_tail: bool = False) -> None:
    """Publish band ``d`` of the pre-shifted right-child companion table:
    ``R[s', t][m'] = C[s', t][m' - WA[s'-1]] + CUM32[s'-1]`` (``+inf`` below
    the shift and, with ``clamp_tail``, ``C[·][S]`` above it: the offload
    DP's memory-gain reads), one contiguous copy per distinct WA value."""
    ns = ctx.L + 1 - d
    width = R.shape[1]
    S1 = ctx.S1
    Rband = R[tab.off[d]:tab.off[d] + ns]
    Cband = tab.band(d)
    for w, ps in ctx.groups:
        rows = ps[:np.searchsorted(ps, ns)]
        if len(rows) == 0:
            continue
        cum = ctx.CUM32[rows][:, None]
        ncopy = min(S1, width - w)
        if ncopy > 0:
            Rband[rows, w:w + ncopy] = Cband[rows, 1:1 + ncopy] + cum
        if clamp_tail and width - (w + S1) > 0:
            Rband[rows, w + S1:] = Cband[rows, S1:S1 + 1] + cum


def _build_lm_band(ctx: _FillCtx, Lm: np.ndarray, tab: BandedTable, d: int
                   ) -> None:
    """Publish band ``d`` of the left-child companion table:
    ``Lm[s, t][m] = C[s, t][m] - CUM32[s-1]``."""
    ns = ctx.L + 1 - d
    np.subtract(tab.band(d)[:, 1:], ctx.CUM32[:ns, None],
                out=Lm[tab.off[d]:tab.off[d] + ns])


def _fall_plane(ctx: _FillCtx, tab: BandedTable, d: int, ns: int,
                ma: np.ndarray, out: np.ndarray) -> np.ndarray:
    """C2: ``u_f^s + C[s+1, t][m - wā^s] + u_b^s``, masked by m_all, at the
    column width of ``out`` (the pruned band width)."""
    S2 = ctx.S2
    W = out.shape[1]
    rows = ((tab.off[d - 1] + 1 + np.arange(ns, dtype=np.int64)) * S2
            ).astype(np.int32)
    fi = rows[:, None] + ctx.idx_wb[1:1 + ns, :W]
    np.take(tab.data.reshape(-1), fi, out=out)
    out += ctx.UF32[1:1 + ns, None]
    out += ctx.UB32[1:1 + ns, None]
    out[ctx.ms[None, :W] < ma[:, None]] = _INF32
    return out


# ---------------------------------------------------------------------------
# Two-tier fill
# ---------------------------------------------------------------------------

def _numpy_band_min(R: np.ndarray, Lm: np.ndarray, off: np.ndarray, d: int,
                    ns: int, W: int, out: np.ndarray) -> None:
    """The split loop in numpy: one add of two contiguous companion blocks
    per split offset, min-accumulated into ``out``."""
    tmp = np.empty((ns, W), dtype=COST_DTYPE)
    for j in range(d):                  # split sp = s + 1 + j
        base = int(off[d - 1 - j]) + 1 + j
        np.add(R[base:base + ns, :W], Lm[off[j]:off[j] + ns, :W], out=tmp)
        np.minimum(out, tmp, out=out)


def fill_two_tier(dchain, S: int, allow_fall: bool = True,
                  v: Optional[dict] = None,
                  band_min: BandMin = _numpy_band_min) -> BandedTable:
    """Banded bottom-up fill of the paper's Theorem-1 recursion.  For each
    sub-chain length the C1 split minimum of all starts goes to ``band_min``
    (numpy by default; :mod:`repro_torch.kernels.dp_fill` passes the
    PyTorch/CUDA band minimum), then the m_∅ mask, the C2 (``F_all``-first)
    plane and the saturated tail are applied and the companions of the new
    band are published.  Each band computes only its unsaturated columns
    (:func:`saturation_caps`)."""
    if v is None:
        v = _views(dchain)
    L = dchain.length
    ctx = _FillCtx(v, L, S)
    tab = BandedTable(L, S)
    ctx.base_case(tab)
    caps = saturation_caps(v, S, allow_fall)
    off = tab.off
    R = np.full((int(off[-1]), ctx.S1), INFEASIBLE, dtype=COST_DTYPE)
    Lm = np.empty((int(off[-1]), ctx.S1), dtype=COST_DTYPE)
    _build_r_band(ctx, R, tab, 0)
    _build_lm_band(ctx, Lm, tab, 0)
    for d in range(1, L + 1):
        ns = L + 1 - d
        W = band_width(caps, d, S)
        ma, mn = ctx.thresholds(d)
        resfull = tab.band(d)[:, 1:]        # starts at +inf
        res = resfull[:, :W]
        band_min(R, Lm, off, d, ns, W, res)
        res[ctx.ms[None, :W] < mn[:, None]] = _INF32
        if allow_fall:
            c2 = np.empty((ns, W), dtype=COST_DTYPE)
            _fall_plane(ctx, tab, d, ns, ma, c2)
            np.minimum(res, c2, out=res)
        if W <= S:
            resfull[:, W:] = resfull[:, W - 1:W]   # saturated tail
        _build_r_band(ctx, R, tab, d)
        _build_lm_band(ctx, Lm, tab, d)
    return tab


def fill_tables(dchain, S: int, impl: str = "banded",
                allow_fall: bool = True, v: Optional[dict] = None
                ) -> BandedTable:
    """Two-tier band fill behind the ``impl`` seam: ``"banded"`` runs the
    numpy split loop; ``"plain"`` and ``"cuda"`` run the host band loop of
    :mod:`repro_torch.kernels.dp_fill` with the band minimum on CPU tensors
    (plain PyTorch) or CUDA tensors (the Hopper kernel); ``"cuda_fused"``
    runs the whole recursion on the card.  All produce the same
    :class:`BandedTable`, so reconstruction is impl-agnostic."""
    if impl == "banded":
        return fill_two_tier(dchain, S, allow_fall=allow_fall, v=v)
    if impl in ("plain", "cuda", "cuda_fused"):
        from ..kernels.dp_fill import ops as _dp_fill_ops
        if impl == "cuda_fused":
            return _dp_fill_ops.fill_two_tier_fused(
                dchain, S, allow_fall=allow_fall, v=v, device="cuda")
        return _dp_fill_ops.fill_two_tier(
            dchain, S, allow_fall=allow_fall, v=v,
            device="cuda" if impl == "cuda" else "cpu")
    raise ValueError(f"fill_tables cannot run impl {impl!r}; "
                     f"expected one of {KNOWN_IMPLS}")


# ---------------------------------------------------------------------------
# Offload (three-tier) fill — the C3 branch is one more candidate plane
# ---------------------------------------------------------------------------

class OffloadSplits:
    """The split planes of one band of the offload fill, as views into the
    companion tables: what a band-min-offload callback reduces.  Split ``j``
    is the split point ``sp = s + 1 + j``."""

    def __init__(self, ctx: _FillCtx, R, Lmb, Lme, Lmb3, flat_b, off,
                 d: int, W: int, slice_c3: bool, toffP: np.ndarray):
        self.ctx, self.R, self.Lmb, self.Lme, self.Lmb3 = ctx, R, Lmb, Lme, Lmb3
        self.flat_b, self.off, self.d, self.W = flat_b, off, d, W
        self.ns = ns = ctx.L + 1 - d
        self.slice_c3 = slice_c3
        #: ``(ns, 1)`` CUM-shifted offload times ``T_off(a^{s-1}) + CUM[s-1]``
        self.toff = toffP[:ns, None]
        if Lmb3 is not None:
            self.wacol = ctx.WA[:ns].astype(np.int32)[:, None]
            self.par_groups = [(w, ps[:np.searchsorted(ps, ns)])
                               for w, ps in ctx.groups]

    def _base(self, j: int) -> int:
        return int(self.off[self.d - 1 - j]) + 1 + j

    def _lo(self, j: int) -> int:
        return int(self.off[j])

    def right(self, j: int) -> np.ndarray:
        """Pre-shifted right child ``R`` (C1, both input states)."""
        b = self._base(j)
        return self.R[b:b + self.ns, :self.W]

    def left_b(self, j: int) -> np.ndarray:
        lo = self._lo(j)
        return self.Lmb[lo:lo + self.ns, :self.W]

    def left_e(self, j: int) -> np.ndarray:
        lo = self._lo(j)
        return self.Lme[lo:lo + self.ns, :self.W]

    def left_b3(self, j: int) -> np.ndarray:
        """Bare left child with the prefetch charge pre-added (C3)."""
        lo = self._lo(j)
        return self.Lmb3[lo:lo + self.ns, :self.W]

    def right3(self, j: int, out: np.ndarray) -> np.ndarray:
        """The C3 right plane ``X`` before the stall max: the right child read
        at the parent-side column offset ``WA[s-1]`` (the offloaded input's
        slots are reclaimed).  A slice of ``R`` when every activation fits
        the budget, else a gather from the bare table."""
        ctx, ns, W = self.ctx, self.ns, self.W
        base = self._base(j)
        if self.slice_c3:
            Rblk = self.R[base:base + ns]
            for w0, rows in self.par_groups:
                if len(rows):
                    out[rows] = Rblk[rows, w0:w0 + W]
            return out
        ifi = np.add(ctx.raw_wa[1 + j:1 + j + ns, :W], self.wacol)
        np.clip(ifi, -1, ctx.S, out=ifi)
        ifi += 1
        ifi += ctx.is2[:ns, None]
        np.take(self.flat_b[base * ctx.S2:], ifi, out=out)
        out += ctx.CUM32[1 + j:1 + j + ns, None]
        return out


#: ``band_min_offload(splits, resb, rese, c3)`` min-accumulates the split
#: minima of one band into ``resb``/``rese`` (C1, input bare / embedded) and
#: ``c3`` (the C3 plane; ``None`` without a host tier), all preset to +inf.
BandMinOffload = Callable[[OffloadSplits, np.ndarray, np.ndarray,
                           Optional[np.ndarray]], None]


def _numpy_band_min_offload(sp: OffloadSplits, resb: np.ndarray,
                            rese: np.ndarray, c3: Optional[np.ndarray]
                            ) -> None:
    """The offload split loop in numpy: three accumulators per pass."""
    tmp = np.empty((sp.ns, sp.W), dtype=COST_DTYPE)
    tmp3 = np.empty((sp.ns, sp.W), dtype=COST_DTYPE)
    for j in range(sp.d):
        r = sp.right(j)
        # C1 keeps the parent's input-state bit in the left child; the right
        # child is always bare (C_b)
        np.add(r, sp.left_b(j), out=tmp)
        np.minimum(resb, tmp, out=resb)
        np.add(r, sp.left_e(j), out=tmp)
        np.minimum(rese, tmp, out=rese)
        if c3 is None:
            continue
        sp.right3(j, tmp3)
        np.maximum(tmp3, sp.toff, out=tmp3)
        tmp3 += sp.left_b3(j)                   # C3 left is bare
        np.minimum(c3, tmp3, out=c3)


def offload_vectors(dchain, v: dict) -> Tuple[np.ndarray, np.ndarray]:
    """``(toffP, tpre32)``: the CUM-shifted float32 offload times
    ``T_off(a^i) + CUM[i]`` and the float32 prefetch times, ``i = 0..L``."""
    L = dchain.length
    toffP = (dchain.chain.offload_times()
             + np.asarray(v["CUM_UF"][:L + 1])).astype(COST_DTYPE)
    return toffP, dchain.chain.prefetch_times().astype(COST_DTYPE)


def fill_offload(dchain, S: int, allow_fall: bool = True,
                 v: Optional[dict] = None,
                 band_min: BandMinOffload = _numpy_band_min_offload
                 ) -> Tuple[BandedTable, BandedTable]:
    """Banded fill of the offload-aware DP: returns ``(Cb, Ce)`` — input bare
    (all three branches) vs input embedded in an ``ā`` (two-tier branches).
    The split minima of each band go to ``band_min`` (numpy by default;
    :mod:`repro_torch.kernels.dp_fill` passes the PyTorch/CUDA one)."""
    if v is None:
        v = _views(dchain)
    L = dchain.length
    ctx = _FillCtx(v, L, S)
    tb, te = BandedTable(L, S), BandedTable(L, S)
    ctx.base_case(tb)
    ctx.base_case(te)
    caps = saturation_caps(v, S, allow_fall)
    host = dchain.chain.host
    host_on = host is not None and host.enabled
    toffP, tpre32 = offload_vectors(dchain, v)
    S1 = ctx.S1
    off = tb.off
    # pre-shifted right-child companion of C_b (right children are always
    # bare) and left-child companions of both tables.  The C3 plane reads R
    # at a parent-side column offset WA[s-1], so R's width is padded by wcap
    # and the tail clamps to C[·][S] (the memory-gain semantics); that slice
    # needs every WA <= S+1, else C3 gathers from C_b instead.
    slice_c3 = host_on and ctx.wa_uncapped
    ncells = int(off[-1])
    R = np.full((ncells, S1 + (ctx.wcap if slice_c3 else 0)),
                INFEASIBLE, dtype=COST_DTYPE)
    Lmb = np.empty((ncells, S1), dtype=COST_DTYPE)
    Lme = np.empty((ncells, S1), dtype=COST_DTYPE)
    # C3 left-child companion with the prefetch charge pre-added:
    # Lmb3[s, t][m] = (C_b[s, t][m] - CUM32[s-1]) + T_pre(a^{s-1})
    Lmb3 = np.empty((ncells, S1), dtype=COST_DTYPE) if host_on else None

    def publish(d: int) -> None:
        _build_r_band(ctx, R, tb, d, clamp_tail=slice_c3)
        _build_lm_band(ctx, Lmb, tb, d)
        _build_lm_band(ctx, Lme, te, d)
        if host_on:
            ns_, lo = L + 1 - d, int(off[d])
            np.add(Lmb[lo:lo + ns_], tpre32[:ns_, None],
                   out=Lmb3[lo:lo + ns_])

    publish(0)
    flat_b = tb.data.reshape(-1)
    for d in range(1, L + 1):
        ns = L + 1 - d
        W = band_width(caps, d, S)
        ma, mn = ctx.thresholds(d)
        resb_full = tb.band(d)[:, 1:]
        rese_full = te.band(d)[:, 1:]
        resb = resb_full[:, :W]
        rese = rese_full[:, :W]
        c3 = np.full((ns, W), _INF32, dtype=COST_DTYPE) if host_on else None
        band_min(OffloadSplits(ctx, R, Lmb, Lme, Lmb3, flat_b, off, d, W,
                               slice_c3, toffP), resb, rese, c3)
        infeas = ctx.ms[None, :W] < mn[:, None]
        resb[infeas] = _INF32
        rese[infeas] = _INF32
        if allow_fall:
            c2 = np.empty((ns, W), dtype=COST_DTYPE)
            _fall_plane(ctx, te, d, ns, ma, c2)         # C2 child is embedded
            np.minimum(resb, c2, out=resb)
            np.minimum(rese, c2, out=rese)
        if host_on:
            c3[infeas] = _INF32
            np.minimum(resb, c3, out=resb)
        if W <= S:
            resb_full[:, W:] = resb_full[:, W - 1:W]   # saturated tail
            rese_full[:, W:] = rese_full[:, W - 1:W]
        publish(d)
    return tb, te


def fill_tables_offload(dchain, S: int, impl: str = "banded",
                        allow_fall: bool = True, v: Optional[dict] = None
                        ) -> Tuple[BandedTable, BandedTable]:
    """Offload (three-tier) band fill behind the same ``impl`` seam as
    :func:`fill_tables`: ``"banded"`` numpy, ``"plain"``/``"cuda"`` the host
    band loop with the three-accumulator band minimum on CPU or CUDA
    tensors, ``"cuda_fused"`` the whole recursion on the card."""
    if impl == "banded":
        return fill_offload(dchain, S, allow_fall=allow_fall, v=v)
    if impl in ("plain", "cuda", "cuda_fused"):
        from ..kernels.dp_fill import ops as _dp_fill_ops
        if impl == "cuda_fused":
            return _dp_fill_ops.fill_offload_fused(
                dchain, S, allow_fall=allow_fall, v=v, device="cuda")
        return _dp_fill_ops.fill_offload(
            dchain, S, allow_fall=allow_fall, v=v,
            device="cuda" if impl == "cuda" else "cpu")
    raise ValueError(f"fill_tables_offload cannot run impl {impl!r}; "
                     f"expected one of {KNOWN_IMPLS}")


# ---------------------------------------------------------------------------
# Choice recomputation (used by the reconstruction instead of stored tables)
# ---------------------------------------------------------------------------

def _lookup(tab: BandedTable, s: int, t: int, m_shifted: int) -> np.float32:
    if m_shifted < 0:
        return _INF32
    return tab.row(s, t)[min(m_shifted, tab.S)]


def _c1_candidates(v: dict, right_tab: BandedTable, left_tab: BandedTable,
                   s: int, t: int, m: int) -> np.ndarray:
    """C1 candidate values for every split, in the exact float32 operation
    order the banded fill used: the forward-stream cost telescopes as
    ``(C_right[m - w] + CUM32[sp-1]) + (C_left[m] - CUM32[s-1])``."""
    sps = np.arange(s + 1, t + 1)
    n = len(sps)
    right = np.empty(n, dtype=COST_DTYPE)
    left = np.empty(n, dtype=COST_DTYPE)
    for k, sp in enumerate(sps):
        right[k] = _lookup(right_tab, sp, t, m - int(v["WA"][sp - 1]))
        left[k] = left_tab.row(s, sp - 1)[m]
    cum32 = v["CUM_UF"].astype(COST_DTYPE)
    return (right + cum32[sps - 1]) + (left - cum32[s - 1])


def _c2_value(v: dict, child_tab: BandedTable, s: int, t: int, m: int
              ) -> np.float32:
    if m < _m_all(v, s, t):
        return _INF32
    val = _lookup(child_tab, s + 1, t, m - int(v["WABAR"][s]))
    return (val + _F32(v["UF"][s])) + _F32(v["UB"][s])


def choose_two_tier(v: dict, tab: BandedTable, s: int, t: int, m: int,
                    allow_fall: bool = True) -> Tuple[int, int]:
    """Recompute the optimal branch at one cell: returns ``(choice, split)``
    with choice 0 = infeasible, 1 = Ck, 2 = All (ties go to Ck)."""
    if s == t:
        return (2, 0) if np.isfinite(tab.row(s, s)[m]) else (0, 0)
    cand = _c1_candidates(v, tab, tab, s, t, m)
    if m < _m_none(v, s, t):
        cand[:] = _INF32
    k = int(np.argmin(cand))
    best = cand[k]
    choice, sp = (1, s + 1 + k) if np.isfinite(best) else (0, 0)
    if allow_fall:
        c2 = _c2_value(v, tab, s, t, m)
        if c2 < best or (not np.isfinite(best) and np.isfinite(c2)):
            choice, sp, best = 2, 0, c2
    if not np.isfinite(best):
        return 0, 0
    return choice, sp


def choose_offload(v: dict, tb: BandedTable, te: BandedTable,
                   toffP: np.ndarray, tpre32: np.ndarray,
                   s: int, t: int, m: int, bare: bool,
                   allow_fall: bool = True) -> Tuple[int, int]:
    """Branch decision for the offload DP at one cell: choice 0 = infeasible,
    1 = Ck, 2 = All, 3 = Offload (ties: Ck before All before Offload).
    ``toffP``/``tpre32`` are the fill's :func:`offload_vectors`."""
    tab = tb if bare else te
    if s == t:
        return (2, 0) if np.isfinite(tab.row(s, s)[m]) else (0, 0)
    m_none = _m_none(v, s, t)
    cand = _c1_candidates(v, tb, tab, s, t, m)
    if m < m_none:
        cand[:] = _INF32
    k = int(np.argmin(cand))
    best = cand[k]
    choice, sp = (1, s + 1 + k) if np.isfinite(best) else (0, 0)
    if allow_fall:
        c2 = _c2_value(v, te, s, t, m)
        if c2 < best or (not np.isfinite(best) and np.isfinite(c2)):
            choice, sp, best = 2, 0, c2
    if bare and np.isfinite(toffP[s - 1]):
        sps = np.arange(s + 1, t + 1)
        n = len(sps)
        hidden = np.empty(n, dtype=COST_DTYPE)   # CUM-shifted hidden work
        left = np.empty(n, dtype=COST_DTYPE)
        w0 = int(v["WA"][s - 1])
        cum32 = v["CUM_UF"].astype(COST_DTYPE)
        for kk, spp in enumerate(sps):
            hidden[kk] = (_lookup(tb, spp, t, m - int(v["WA"][spp - 1]) + w0)
                          + cum32[spp - 1])
            left[kk] = tb.row(s, spp - 1)[m]
        # X + max(T_off - X, 0) = max(X, T_off), in the CUM-shifted domain;
        # the prefetch charge rides on the left-child companion (Lmb3)
        cand3 = (np.maximum(hidden, toffP[s - 1])
                 + ((left - cum32[s - 1]) + tpre32[s - 1]))
        if m < m_none:
            cand3[:] = _INF32
        k3 = int(np.argmin(cand3))
        if cand3[k3] < best or (not np.isfinite(best)
                                and np.isfinite(cand3[k3])):
            choice, sp, best = 3, s + 1 + k3, cand3[k3]
    if not np.isfinite(best):
        return 0, 0
    return choice, sp
