"""Plain PyTorch versions of the DP fill kernels (their parity oracles, and
what the wrappers run on CPU tensors).

The fused fills run the whole band recursion on tensors, with the companion
rebuild written as a ``torch.gather`` under the kernels' rules: an index
below 0 reads ``+inf``, an index past the row clamps to column ``W - 1``.
"""

from __future__ import annotations

from typing import Tuple

import torch

_INF = float("inf")
_INT_CLAMP = 1 << 30


def band_min_two_tier(r: torch.Tensor, lm: torch.Tensor) -> torch.Tensor:
    """``min_j (r[j] + lm[j])`` over the stacked split axis."""
    return torch.amin(r + lm, dim=0)


def band_min_offload(r: torch.Tensor, r3: torch.Tensor, lmb: torch.Tensor,
                     lme: torch.Tensor, lmb3: torch.Tensor, toff: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The offload band's three split minima: C1 with a bare and with an
    embedded left child, and C3 with its stall folded into
    ``max(X, T_off)`` (``toff``: ``(ns, 1)``)."""
    return (torch.amin(r + lmb, dim=0), torch.amin(r + lme, dim=0),
            torch.amin(torch.maximum(r3, toff) + lmb3, dim=0))


def band_rows(L: int, d: int,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(right, left)``: ``(d, ns)`` table rows that split ``j`` of band
    ``d`` reads for row ``r`` of an ``L``-stage chain, ``off[d-1-j] + 1 + j
    + r`` and ``off[j] + r``, band ``k`` starting at ``off[k] = k (L + 1) -
    k (k - 1) / 2`` (the rows ``_numpy_band_min`` and ``OffloadSplits``
    read)."""
    j = torch.arange(d, device=device)
    r = torch.arange(L + 1 - d, device=device)

    def start(k):
        return k * (L + 1) - k * (k - 1) // 2

    return ((start(d - 1 - j) + 1 + j)[:, None] + r, start(j)[:, None] + r)


def band_min_two_tier_tables(r: torch.Tensor, lm: torch.Tensor, *, L: int,
                             d: int, W: int) -> torch.Tensor:
    """:func:`band_min_two_tier` of band ``d`` read in place from the
    companion tables ``r`` and ``lm`` (one row per cell): ``(ns, W)``."""
    right, left = band_rows(L, d, r.device)
    return torch.amin(r[right, :W] + lm[left, :W], dim=0)


def offload_planes(r, lmb, lme, lmb3, cb, wa, cum, *, L: int, S: int,
                   d: int, W: int, c3):
    """Band ``d``'s split planes of the offload fill, stacked ``(d, ns, W)``
    from its tables: ``(R, X, Lmb, Lme, Lmb3)``, the C3 right plane ``X``
    read from ``r`` at column ``wa[r] + c`` (``c3 == "slice"``, ``wa =
    min(WA, S + 1)``) or gathered from the bare table ``cb`` (``"gather"``,
    ``wa = WA``) as ``OffloadSplits.right3`` forms it; ``X`` and ``Lmb3``
    are None without a host tier (``c3`` None)."""
    right, left = band_rows(L, d, r.device)
    planes = [r[right, :W], None, lmb[left, :W], lme[left, :W], None]
    if c3 is not None:
        ns = L + 1 - d
        cols = torch.arange(W, device=r.device)
        wa_r = wa[:ns, None].long()
        if c3 == "slice":
            x = torch.gather(r[right], 2, (wa_r + cols).expand(d, ns, W))
        else:
            p = (1 + torch.arange(d, device=r.device)[:, None]
                 + torch.arange(ns, device=r.device))      # right input
            raw = (cols - wa[p].long()[..., None]).clamp(min=-_INT_CLAMP)
            i = (raw + wa_r).clamp(-1, S) + 1
            x = torch.gather(cb[right], 2, i) + cum[p][..., None]
        planes[1], planes[4] = x, lmb3[left, :W]
    return tuple(planes)


def band_min_offload_tables(r, lmb, lme, lmb3, cb, wa, cum, toff, *, L: int,
                            S: int, d: int, W: int, c3) -> torch.Tensor:
    """The offload band's split minima read in place from the fill's tables
    (:func:`offload_planes`): ``(2, ns, W)`` (C1 bare and embedded) without
    a host tier (``c3`` None), else ``(3, ns, W)`` with C3."""
    rv, x, lb, le, lb3 = offload_planes(r, lmb, lme, lmb3, cb, wa, cum, L=L,
                                        S=S, d=d, W=W, c3=c3)
    if c3 is None:
        return torch.stack([torch.amin(rv + lb, dim=0),
                            torch.amin(rv + le, dim=0)])
    return torch.stack(band_min_offload(rv, x, lb, le, lb3,
                                        toff[:L + 1 - d, None]))


def _shifted_gather(blk: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[r, c] = blk[r, idx[r, c]]``; ``idx < 0`` reads ``+inf``, an
    index past the row reads its last column."""
    w = blk.shape[1]
    g = torch.gather(blk, 1, idx.clamp(0, w - 1).long())
    return torch.where(idx < 0, _INF, g)


def _rebuild(t: torch.Tensor, lo: int, ns: int, wa: torch.Tensor,
             cum: torch.Tensor, cols: torch.Tensor):
    """``(R, Lm)`` rows of the band whose ``ns`` rows start at ``lo``."""
    blk = t[lo:lo + ns]
    c = cum[:ns, None]
    return _shifted_gather(blk, cols - wa[:ns, None]) + c, blk - c


def _c2(t: torch.Tensor, lo: int, ns: int, wb, uf, ub, ma_d,
        cols: torch.Tensor) -> torch.Tensor:
    """C2 of a band from the child band starting at row ``lo + 1``:
    ``(C[s+1, t][m - wā^s] + u_f^s) + u_b^s``, ``+inf`` below m_all."""
    blk = t[lo + 1:lo + 1 + ns]
    c2 = (_shifted_gather(blk, cols - wb[1:1 + ns, None])
          + uf[1:1 + ns, None]) + ub[1:1 + ns, None]
    return torch.where(cols < ma_d[:ns, None], _INF, c2)


def fused_fill_two_tier(t0, off, wa, wb, cum, uf, ub, mn, ma, *, L: int,
                        W: int, allow_fall: bool) -> torch.Tensor:
    """The whole two-tier recursion on tensors: ``t0`` ``(ncells, W)`` holds
    the base-case band (``+inf`` elsewhere); returns the filled table."""
    t = t0.clone()
    r, lm = torch.empty_like(t), torch.empty_like(t)
    cols = torch.arange(W, dtype=torch.int32, device=t.device)[None, :]
    offs = [int(x) for x in off.tolist()]
    r[:L + 1], lm[:L + 1] = _rebuild(t, 0, L + 1, wa, cum, cols)
    for d in range(1, L + 1):
        ns = L + 1 - d
        acc = torch.full((ns, W), _INF, dtype=t.dtype, device=t.device)
        for j in range(d):                  # split sp = s + 1 + j
            rr, lr = offs[d - 1 - j] + 1 + j, offs[j]
            acc = torch.minimum(acc, r[rr:rr + ns] + lm[lr:lr + ns])
        res = torch.where(cols < mn[d - 1, :ns, None], _INF, acc)
        if allow_fall:
            res = torch.minimum(res, _c2(t, offs[d - 1], ns, wb, uf, ub,
                                         ma[d - 1], cols))
        lo = offs[d]
        t[lo:lo + ns] = res
        r[lo:lo + ns], lm[lo:lo + ns] = _rebuild(t, lo, ns, wa, cum, cols)
    return t


def fused_fill_offload(t0b, t0e, off, wa, wb, cum, uf, ub, mn, ma, toff,
                       tpre, *, L: int, W: int, allow_fall: bool,
                       host_on: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole offload recursion on tensors: two tables (input bare /
    embedded) and four companions; returns ``(Cb, Ce)``."""
    tb, te = t0b.clone(), t0e.clone()
    r, lmb, lme, lmb3 = (torch.empty_like(tb) for _ in range(4))
    cols = torch.arange(W, dtype=torch.int32, device=tb.device)[None, :]
    offs = [int(x) for x in off.tolist()]

    def publish(lo: int, ns: int) -> None:
        r[lo:lo + ns], lmb[lo:lo + ns] = _rebuild(tb, lo, ns, wa, cum, cols)
        lme[lo:lo + ns] = te[lo:lo + ns] - cum[:ns, None]
        if host_on:
            lmb3[lo:lo + ns] = lmb[lo:lo + ns] + tpre[:ns, None]

    publish(0, L + 1)
    for d in range(1, L + 1):
        ns = L + 1 - d
        accb, acce, acc3 = (torch.full((ns, W), _INF, dtype=tb.dtype,
                                       device=tb.device) for _ in range(3))
        wa_s = wa[:ns, None]                 # WA[s-1]
        toff_s = toff[:ns, None]
        for j in range(d):                  # split sp = s + 1 + j
            rr, lr = offs[d - 1 - j] + 1 + j, offs[j]
            rv = r[rr:rr + ns]
            accb = torch.minimum(accb, rv + lmb[lr:lr + ns])
            acce = torch.minimum(acce, rv + lme[lr:lr + ns])
            if host_on:
                raw = (cols - wa[1 + j:1 + j + ns, None]).clamp(-_INT_CLAMP,
                                                                 W - 1)
                idx3 = (raw + wa_s).clamp(-1, W - 1)
                c3 = _shifted_gather(tb[rr:rr + ns], idx3) \
                    + cum[1 + j:1 + j + ns, None]
                c3 = torch.maximum(c3, toff_s) + lmb3[lr:lr + ns]
                acc3 = torch.minimum(acc3, c3)
        infeas = cols < mn[d - 1, :ns, None]
        resb = torch.where(infeas, _INF, accb)
        rese = torch.where(infeas, _INF, acce)
        if allow_fall:
            c2 = _c2(te, offs[d - 1], ns, wb, uf, ub, ma[d - 1], cols)
            resb, rese = torch.minimum(resb, c2), torch.minimum(rese, c2)
        if host_on:
            resb = torch.minimum(resb, torch.where(infeas, _INF, acc3))
        lo = offs[d]
        tb[lo:lo + ns], te[lo:lo + ns] = resb, rese
        publish(lo, ns)
    return tb, te
