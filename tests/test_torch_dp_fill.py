"""The port's DP fill against the JAX package: the plain PyTorch band
minimum against the Pallas kernel (interpret mode) and its jnp oracle, the
port's banded and plain fills against ``repro.core.dp_kernels``, the fused
drivers' plain path (what K2 and K5b compute on the card) against the JAX
banded fills on chains of up to 48 stages and on the Qwen1.5-4B chain at
its 40 layers, with the per-band Pallas fill in interpret mode as a second
witness, and the solver's schedules — all **bit-equal**: on f32-exact chains
(integer stage costs and dyadic transfer times, so every DP quantity is
exact in float32 and min does not round), and on the analytic Qwen chain
because both sides do the same float32 adds in the same order."""

import math

import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import dp_kernels as jdp  # noqa: E402
from repro.core import solver as jsolver  # noqa: E402
from repro.core.chain import Chain as JChain  # noqa: E402
from repro.core.chain import HostTransferModel as JHost  # noqa: E402
from repro.core.schedule import Schedule, simulate  # noqa: E402
from repro.kernels.dp_fill import kernel as jkernel  # noqa: E402
from repro.kernels.dp_fill import ops as jops  # noqa: E402
from repro.kernels.dp_fill import ref as jref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core import dp_kernels as pdp  # noqa: E402
from repro_torch.core import solver as psolver  # noqa: E402
from repro_torch.core.chain import Chain as PChain  # noqa: E402
from repro_torch.core.chain import HostTransferModel as PHost  # noqa: E402
from repro_torch.core.schedule import simulate as psimulate  # noqa: E402
from repro_torch import counters  # noqa: E402
from repro_torch.kernels.dp_fill import ops as pops  # noqa: E402
from repro_torch.kernels.dp_fill import ref as pref  # noqa: E402
from repro_torch.launch.steps import plan_chain  # noqa: E402
from repro_torch.models.lm import StagedLM  # noqa: E402
from repro_torch.offload.solver import solve_min_device_memory  # noqa: E402

from helpers import random_chain  # noqa: E402


def _port_chain(ch) -> PChain:
    host = None if ch.host is None else PHost(
        bandwidth_d2h=ch.host.bandwidth_d2h,
        bandwidth_h2d=ch.host.bandwidth_h2d, latency=ch.host.latency)
    return PChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob, host=host)


def _jax_chain(ch) -> JChain:
    host = None if ch.host is None else JHost(
        bandwidth_d2h=ch.host.bandwidth_d2h,
        bandwidth_h2d=ch.host.bandwidth_h2d, latency=ch.host.latency)
    return JChain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                       wdelta=ch.wdelta, of=ch.of, ob=ch.ob, host=host)


def _budgets(ch, fracs):
    peak = simulate(ch, Schedule.store_all(ch.length)).peak_mem
    return [float(math.ceil(peak * f)) for f in fracs]


@pytest.mark.parametrize("d,ns,w", [(1, 1, 4), (3, 5, 17), (7, 300, 33)])
def test_plain_band_min_bit_equal_to_pallas(d, ns, w):
    rng = np.random.default_rng(d * 100 + ns)
    r = rng.uniform(0, 8, (d, ns, w)).astype(np.float32)
    lm = rng.uniform(-4, 4, (d, ns, w)).astype(np.float32)
    r[rng.uniform(size=r.shape) < 0.3] = np.inf   # out-of-budget sentinels
    got = pops.band_min_two_tier(torch.from_numpy(r),
                                 torch.from_numpy(lm)).numpy()
    assert np.array_equal(got, np.asarray(jref.band_min_two_tier(r, lm)))
    assert np.array_equal(
        got, np.asarray(jkernel.band_min_two_tier(r, lm, interpret=True)))


def test_band_min_wrapper_rejects_bad_stacks():
    r = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        pops.band_min_two_tier(r, torch.zeros(2, 3, 5))
    with pytest.raises(TypeError):
        pops.band_min_two_tier(r.double(), r.double())


@pytest.mark.parametrize("name", [pops.NAME, pops.NAME_OFFLOAD])
def test_band_min_wrappers_run_plain_off_the_card(name):
    """On CPU tensors K1's and K5a's wrappers return their plain versions'
    results and count no launch."""
    rng = np.random.default_rng(3)
    planes = [torch.from_numpy(rng.uniform(0, 9, (3, 4, 5)).astype(
        np.float32)) for _ in range(5)]
    toff = torch.from_numpy(rng.uniform(0, 9, (4, 1)).astype(np.float32))
    before = counters.snapshot()
    if name == pops.NAME:
        got = (pops.band_min_two_tier(*planes[:2]),)
        want = (pref.band_min_two_tier(*planes[:2]),)
    else:
        got = pops.band_min_offload(*planes, toff)
        want = pref.band_min_offload(*planes, toff)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert counters.snapshot() == before


@pytest.mark.parametrize("bad", ["table dtype", "vector dtype", "table shape",
                                 "short vectors"])
def test_fused_fill_wrappers_reject_bad_operands(bad):
    """K2's and K5b's wrappers check their operands before choosing a
    device: every bad operand raises, on the CPU too."""
    ch = _port_chain(random_chain(np.random.default_rng(2), max_len=4))
    m = _budgets(ch, (0.7,))[0]
    ops_ = pops.FusedOperands(ch.discretize(m, int(m)), int(m), True)
    t0 = ops_.initial(ops_.base_table(), torch.device("cpu"))
    ints = list(ops_.tensors(torch.device("cpu"), np.zeros(ops_.L + 1,
                                                           np.float32),
                             np.zeros(ops_.L + 1, np.float32)))
    L, W, err = ops_.L, ops_.W, ValueError
    if bad == "table dtype":
        t0, err = t0.double(), TypeError
    elif bad == "vector dtype":
        ints[0], err = ints[0].long(), TypeError
    elif bad == "table shape":
        t0 = t0[:, :-1]
    else:
        L += 1
    with pytest.raises(err):
        pops.fused_fill_two_tier(t0, *ints[:8], L=L, W=W, allow_fall=True)
    with pytest.raises(err):
        pops.fused_fill_offload(t0, t0, *ints, L=L, W=W, allow_fall=True,
                                host_on=True)


def _long_chain(case: int):
    """(JAX chain, budget): an integer chain of 13 to 48 stages with a
    dyadic host link; in cases 1 and 3 one activation is wider than the
    budget (the C3 plane then gathers), the budget being sized on the chain
    with that activation capped."""
    L = (13, 24, 37, 48)[case]
    rng = np.random.default_rng(200 + case)
    n = L + 1
    wa = rng.integers(1, 4, n).astype(float)
    capped = JChain.make(uf=np.ones(n), ub=np.ones(n), wa=wa,
                         wabar=rng.integers(1, 6, n).astype(float))
    m = _budgets(capped, (0.6,))[0]
    if case % 2:
        wa = wa.copy()
        wa[L // 2] = 10 * m
    ch = JChain.make(uf=rng.integers(1, 5, n).astype(float),
                     ub=rng.integers(1, 5, n).astype(float), wa=wa,
                     wabar=capped.wabar,
                     of=rng.integers(0, 2, n).astype(float),
                     ob=rng.integers(0, 2, n).astype(float),
                     host=JHost(bandwidth_d2h=float(rng.choice([0.5, 1.0,
                                                                4.0])),
                                latency=float(rng.choice([0.0, 0.25]))))
    return ch, m


def _fused_fills_match(pdch, want_two, want_off, S, allow_fall=True):
    got = pops.fill_two_tier_fused(pdch, S, allow_fall=allow_fall,
                                   device="cpu")
    assert np.array_equal(got.data, want_two.data)
    gb, ge = pops.fill_offload_fused(pdch, S, allow_fall=allow_fall,
                                     device="cpu")
    assert np.array_equal(gb.data, want_off[0].data)
    assert np.array_equal(ge.data, want_off[1].data)


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("allow_fall", [True, False])
def test_fused_fills_bit_equal_to_jax_on_long_chains(case, allow_fall):
    """The fused drivers' plain path (K2's and K5b's arithmetic) against the
    JAX package's banded fills, host tier on and off."""
    ch, m = _long_chain(case)
    S = int(m)
    for jch in (ch, ch.with_host(None)):
        jd = jch.discretize(m, S)
        _fused_fills_match(_port_chain(jch).discretize(m, S),
                           jdp.fill_two_tier(jd, S, allow_fall=allow_fall),
                           jdp.fill_offload(jd, S, allow_fall=allow_fall), S,
                           allow_fall)


@pytest.mark.parametrize("case", [0, 1])
def test_fused_fills_bit_equal_to_jax_pallas_band_fill(case):
    """The second witness: JAX's per-band Pallas fill in interpret mode (its
    fused fill does not run under the installed jax) gives the tables the
    port's fused drivers give."""
    ch, m = _long_chain(case)
    S = int(m)
    jd = ch.discretize(m, S)
    jops.set_interpret(True)
    try:
        want_two = jops.fill_two_tier(jd, S)
        want_off = jops.fill_offload(jd, S)
    finally:
        jops.set_interpret(None)
    assert np.array_equal(want_two.data, jdp.fill_two_tier(jd, S).data)
    _fused_fills_match(_port_chain(ch).discretize(m, S), want_two, want_off,
                       S)


def test_fused_fills_bit_equal_to_jax_on_qwen_full_depth_chain():
    """Qwen1.5-4B at its published 40 layers, one layer a chunk (L = 41),
    profiled analytically on meta tensors (batch 4 × 2048) with a 50 GB/s
    host link, at S = 500 and two budgets: the two-tier midpoint and the
    midpoint between the three- and two-tier floors."""
    cfg = get_config("qwen1.5-4b", n_chunks=40, use_flash_attention=True)
    pch = plan_chain(StagedLM(cfg), input_specs(
        cfg, ShapeSpec("train", "train", 2048, 4)), 7.75e14,
        host=PHost(bandwidth_d2h=5e10))
    assert pch.length == 41
    low = psolver.solve_min_memory(pch).mem_limit
    budgets = ((low + pch.store_all_peak()) / 2,
               (solve_min_device_memory(pch).mem_limit + low) / 2)
    S = 500
    for m in budgets:
        jd = _jax_chain(pch).discretize(m, S)
        want_off = jdp.fill_offload(jd, S)
        pd = pch.discretize(m, S)
        assert pops.FusedOperands(pd, S, True).W == 501
        _fused_fills_match(pd, jdp.fill_two_tier(jd, S), want_off, S)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("allow_fall", [True, False])
def test_fill_tables_bit_equal_to_jax(seed, allow_fall):
    rng = np.random.default_rng(seed)
    ch = random_chain(rng, max_len=6)
    pch = _port_chain(ch)
    for m in _budgets(ch, (0.4, 0.7, 1.0)):
        S = int(m)
        want = jdp.fill_two_tier(ch.discretize(m, S), S,
                                 allow_fall=allow_fall).data
        for impl in ("banded", "plain"):
            got = pdp.fill_tables(pch.discretize(m, S), S, impl=impl,
                                  allow_fall=allow_fall).data
            assert np.array_equal(got, want), (impl, m)


def test_unknown_fill_impl_raises():
    ch = _port_chain(random_chain(np.random.default_rng(0)))
    with pytest.raises(ValueError, match="unknown DP impl"):
        psolver.solve_optimal(ch, 10.0, impl="pallas")


@pytest.mark.parametrize("seed", range(4))
def test_solutions_match_jax(seed):
    rng = np.random.default_rng(seed)
    ch = random_chain(rng, max_len=6)
    pch = _port_chain(ch)
    for m in _budgets(ch, (0.4, 0.7, 1.0)):
        S = int(m)
        want = jsolver.solve_optimal(ch, m, num_slots=S, cache=False)
        for impl in ("banded", "plain"):
            got = psolver.solve_optimal(pch, m, num_slots=S, impl=impl)
            assert got.feasible == want.feasible
            if want.feasible:
                assert got.expected_time == want.expected_time
                assert got.schedule.ops == want.schedule.ops
                assert psimulate(pch, got.schedule, m + 1e-6).valid
    want = jsolver.solve_min_memory(ch, cache=False)
    got = psolver.solve_min_memory(pch, impl="plain")
    assert got.mem_limit == want.mem_limit
    assert got.schedule.ops == want.schedule.ops


def _table_case(L: int, mode, seed: int):
    """Random companion tables of an ``L``-stage chain (``+inf`` in 30 % of
    the right-child cells) and the JAX package's fill context of a random
    integer chain: (ctx, R, Lmb, Lme, Lmb3, Cb, toffP).  ``mode`` "gather"
    makes one activation wider than the budget; "slice" pads R by the widest
    activation, as the offload fill does."""
    rng = np.random.default_rng(seed)
    n = L + 1
    wa = rng.integers(1, 6, n).astype(float)
    S = 40
    if mode == "gather":
        wa[L // 2] = 10 * S
    ch = JChain.make(uf=rng.integers(1, 5, n).astype(float),
                     ub=rng.integers(1, 5, n).astype(float), wa=wa,
                     wabar=rng.integers(1, 6, n).astype(float))
    ctx = jdp._FillCtx(jdp._views(ch.discretize(float(S), S)), L, S)
    ncells = (L + 1) * (L + 2) // 2

    def table(width, lo, hi, p_inf=0.0):
        t = rng.uniform(lo, hi, (ncells, width)).astype(np.float32)
        t[rng.uniform(size=t.shape) < p_inf] = np.inf
        return t

    R = table(S + 1 + (ctx.wcap if mode == "slice" else 0), 0, 8, 0.3)
    Cb = table(S + 2, 0, 8, 0.3)
    Cb[:, 0] = np.inf                           # the sentinel column
    toffP = rng.uniform(0, 6, L + 1).astype(np.float32)
    return (ctx, R, table(S + 1, -4, 4), table(S + 1, -4, 4),
            table(S + 1, -4, 4), Cb, toffP)


def _stacked_planes(ctx, R, Lmb, Lme, Lmb3, Cb, d: int, W: int, mode):
    """Band ``d``'s split planes stacked with numpy as the JAX package's
    per-band Pallas fill stacks them (``repro.kernels.dp_fill.ops``)."""
    L, S = ctx.L, ctx.S
    ns = L + 1 - d
    off = np.concatenate([[0], np.cumsum([L + 1 - k for k in range(L + 1)])])
    rs, lbs, les, lb3s, r3s = (np.empty((d, ns, W), np.float32)
                               for _ in range(5))
    wacol = ctx.WA[:ns].astype(np.int32)[:, None]
    for j in range(d):
        base, lo = int(off[d - 1 - j]) + 1 + j, int(off[j])
        rs[j] = R[base:base + ns, :W]
        lbs[j], les[j] = Lmb[lo:lo + ns, :W], Lme[lo:lo + ns, :W]
        lb3s[j] = Lmb3[lo:lo + ns, :W]
        if mode == "slice":
            for w0, ps in ctx.groups:
                rows = ps[:np.searchsorted(ps, ns)]
                r3s[j, rows] = R[base + rows, w0:w0 + W]
        elif mode == "gather":
            ifi = np.clip(ctx.raw_wa[1 + j:1 + j + ns, :W] + wacol, -1, S)
            ifi += 1 + ctx.is2[:ns, None]
            r3s[j] = np.take(Cb.reshape(-1)[base * (S + 2):], ifi)
            r3s[j] += ctx.CUM32[1 + j:1 + j + ns, None]
    return rs, r3s, lbs, les, lb3s


@pytest.mark.parametrize("mode", ["two-tier", None, "slice", "gather"])
@pytest.mark.parametrize("L", [4, 11])
def test_table_band_minima_bit_equal_to_pallas(L, mode):
    """K1's and K5a's in-place forms (the plain versions, and
    ``TableBands`` on CPU tensors, which runs them and counts no launch)
    read split j's rows of the companion tables by the band offsets, and
    form the C3 right plane by slice or by gather; they equal the JAX Pallas
    kernels (interpret mode) on the planes numpy stacks from the same tables
    as the JAX package's per-band fill does."""
    ctx, R, Lmb, Lme, Lmb3, Cb, toffP = _table_case(L, mode, 40 + L)
    S = ctx.S
    c3 = None if mode == "two-tier" else mode
    tabs = [torch.from_numpy(a) for a in (R, Lmb, Lme, Lmb3, Cb)]
    wa = np.minimum(ctx.WA, S + 1) if mode == "slice" else ctx.WA
    vecs = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (wa.astype(np.int32), ctx.CUM32, toffP)]
    out = torch.empty(3 * L * (S + 1))
    before = counters.snapshot()
    for d in sorted({1, 2, L // 2 + 1, L}):
        W = (S + 1, 17, 5)[d % 3]
        ns = L + 1 - d
        rs, r3s, lbs, les, lb3s = _stacked_planes(ctx, R, Lmb, Lme, Lmb3, Cb,
                                                  d, W, mode)
        if mode == "two-tier":
            want = np.asarray(jkernel.band_min_two_tier(rs, lbs,
                                                        interpret=True))
            plain = pref.band_min_two_tier_tables(tabs[0], tabs[1], L=L,
                                                  d=d, W=W)
            bands = pops.TableBands(tabs[0], tabs[1:2], out, L=L)
        else:
            want = jkernel.band_min_offload(
                rs, r3s, lbs, les, lb3s, toffP[:ns, None], interpret=True)
            want = np.stack([np.asarray(w) for w in want[:3 if c3 else 2]])
            plain = pref.band_min_offload_tables(*tabs, *vecs, L=L, S=S, d=d,
                                                 W=W, c3=c3)
            bands = pops.TableBands(tabs[0], tabs[1:4], out, L=L, S=S, c3=c3,
                                    cb=tabs[4], wa=vecs[0], cum=vecs[1],
                                    toff=vecs[2])
        n = bands.launch(d, W)
        assert np.array_equal(plain.numpy(), want), (d, W)
        assert np.array_equal(out[:n].numpy(), want.reshape(-1)), (d, W)
    assert counters.snapshot() == before


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("allow_fall", [True, False])
def test_plain_fills_bit_equal_to_jax_on_long_chains(case, allow_fall):
    """``impl="plain"``: the per-band drivers (companion tables kept as
    tensors, each band's rows sent before its one call) against the JAX
    package's banded fills, on 13-48-stage chains with the host tier on and
    off; cases 1 and 3 have an activation wider than the budget, so C3
    gathers from the bare table."""
    ch, m = _long_chain(case)
    S = int(m)
    for jch in (ch, ch.with_host(None)):
        jd, pd = jch.discretize(m, S), _port_chain(jch).discretize(m, S)
        want = jdp.fill_two_tier(jd, S, allow_fall=allow_fall)
        assert np.array_equal(pdp.fill_tables(
            pd, S, impl="plain", allow_fall=allow_fall).data, want.data)
        tb, te = jdp.fill_offload(jd, S, allow_fall=allow_fall)
        gb, ge = pdp.fill_tables_offload(pd, S, impl="plain",
                                         allow_fall=allow_fall)
        assert np.array_equal(gb.data, tb.data)
        assert np.array_equal(ge.data, te.data)


def test_uplink_sends_each_band_its_rows_once():
    """A per-band fill's device tables get each host row once, just before
    the first band that reads it: before band ``d`` the rows of bands
    ``0 .. d - 1`` (equal to the host's) and NaN below them; the result
    lands in the host arrays, one per minimum."""
    L, S1 = 4, 3
    n = (L + 1) * (L + 2) // 2
    host = [np.arange(n * S1, dtype=np.float32).reshape(n, S1) + k
            for k in (0, 100)]
    link = pops._Uplink(host, L, 2, S1, torch.device("cpu"))
    for d in range(1, L + 1):
        upto = d * (L + 1) - d * (d - 1) // 2
        link.publish(d)
        for h, t in zip(host, link.tables):
            assert np.array_equal(t[:upto].numpy(), h[:upto])
            assert bool(torch.isnan(t[upto:]).all())
        ns = L + 1 - d
        link.out[:2 * ns * 2] = torch.arange(4.0 * ns) + d
        targets = [np.full((ns, 2), np.inf, np.float32) for _ in range(2)]
        link.fetch(4 * ns, targets, 2)
        assert np.array_equal(np.stack(targets).reshape(-1),
                              np.arange(4.0 * ns, dtype=np.float32) + d)
    link.publish(L + 1)                         # the last row, band L's
    assert not bool(torch.isnan(link.buf).any())


def test_band_struct_mirrors_the_c_launcher():
    """``ops._Band`` (ctypes) names the fields of ``Band`` in
    ``csrc/dp_band_min.cu`` in the same order with the same kinds (pointer,
    int64, int), so the launcher reads what the wrapper packs."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(pops.__file__).resolve().parents[1] / "csrc"
           / "dp_band_min.cu").read_text()
    src = re.sub(r"//[^\n]*", "", src)
    body = re.search(r"struct Band \{(.*?)\};", src, re.S).group(1)
    want = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        kind = ("ptr" if "*" in decl else
                "i64" if decl.startswith("int64_t") else "int")
        names = decl.split(None, 1)[1] if kind != "ptr" else \
            decl.split("*", 1)[1]
        for name in names.split(","):
            name, _, n = name.strip().partition("[")
            want.append((name, kind, int(n.rstrip("]")) if n else 1))
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int64: "i64",
             ctypes.c_int: "int"}
    got = []
    for name, t in pops._Band._fields_:
        n = getattr(t, "_length_", 1)
        got.append((name, kinds[getattr(t, "_type_", t) if n > 1 else t],
                    n))
    assert got == want


@pytest.mark.parametrize("bad", ["c3", "short tables", "left strides",
                                 "cb width", "short vector", "band",
                                 "width", "output"])
def test_table_bands_reject_bad_operands(bad):
    """``TableBands`` checks its operands when it is bound and each band
    when it is launched; every bad one raises, on the CPU too."""
    L, S = 5, 8
    n = (L + 1) * (L + 2) // 2
    buf = torch.zeros(n, 4 * (S + 1) + S + 2)
    r, lmb, lme, lmb3 = (buf[:, k * (S + 1):(k + 1) * (S + 1)]
                         for k in range(4))
    cb = buf[:, 4 * (S + 1):]
    kw = dict(L=L, S=S, c3="gather", cb=cb, wa=torch.zeros(L + 1,
                                                           dtype=torch.int32),
              cum=torch.zeros(L + 1), toff=torch.zeros(L))
    out = torch.empty(3 * L * (S + 1))
    band = (1, S + 1)
    if bad == "c3":
        kw["c3"] = "both"
    elif bad == "short tables":
        r = r[:-1]
    elif bad == "left strides":
        lme = lme.contiguous()
    elif bad == "cb width":
        kw["cb"] = cb[:, 1:]
    elif bad == "short vector":
        kw["toff"] = torch.zeros(L - 1)
    elif bad == "band":
        band = (L + 1, 1)
    elif bad == "width":
        band = (1, S + 2)
    else:
        out = out[:L * (S + 1)]
    with pytest.raises(ValueError):
        pops.TableBands(r, (lmb, lme, lmb3), out, **kw).launch(*band)


def test_table_bands_keep_the_slice_inside_the_right_table():
    """With C3 by slice, row r of R is read from column ``wa[r]`` on, so a
    band wider than R's width less the widest such shift is refused."""
    L, S = 3, 6
    n = (L + 1) * (L + 2) // 2
    r = torch.zeros(n, S + 1 + 2)               # padded by a shift of 2
    lefts = [torch.zeros(n, S + 1) for _ in range(3)]
    wa = torch.tensor([2, 1, 0, 1], dtype=torch.int32)
    bands = pops.TableBands(r, lefts, torch.empty(3 * L * (S + 1)), L=L, S=S,
                            c3="slice", wa=wa, toff=torch.zeros(L))
    assert bands.launch(1, S + 1) == 3 * L * (S + 1)
    wa[0] = 3
    bands = pops.TableBands(r, lefts, torch.empty(3 * L * (S + 1)), L=L, S=S,
                            c3="slice", wa=wa, toff=torch.zeros(L))
    with pytest.raises(ValueError):
        bands.launch(1, S + 1)
