"""The port's kernel analyzer (``repro_torch.check.kernel_analyzer``) and
its gate, ``python -m repro_torch.check``.

The analyzer must prove the shipped CUDA DP-fill kernels clean, with no
``unsupported`` construct, and flag each seeded defect in
``tests/fixtures/bad_dp_fill_*`` (copies of the index header or of a kernel
source, each with one defect) with its kind.  It also pins the driver
contract the analyzer states against what ``kernels/dp_fill/ops.py`` stages
and checks, so the two cannot drift apart silently; and the case matrix
against the launch geometries it must reach.  The library digest of
``kernels/_build.py`` must follow the header too."""

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch.check import kernel_analyzer as ka  # noqa: E402
from repro_torch.check.__main__ import main  # noqa: E402
from repro_torch.core import solver_cache  # noqa: E402
from repro_torch.core.chain import Chain  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dp_fill import ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(scope="module")
def shipped():
    return ka.analyze_dp_fill()


# -- the shipped kernels are clean ------------------------------------------


def test_shipped_dp_fill_kernels_analyze_clean(shipped):
    assert shipped == [], "\n".join(str(i) for i in shipped)


def test_no_unsupported_constructs_in_shipped_kernels(shipped):
    """Every access of the four kernels goes through the header and the
    enumerator models it: an ``unsupported`` issue would mean the gate
    stopped proving."""
    assert not [i for i in shipped if i.kind == "unsupported"]
    assert ka.scan_sources() == []


def test_cache_key_is_code_fingerprint():
    assert ka.cache_key() == solver_cache.code_fingerprint()
    assert "kernels/csrc/dp_fill_index.cuh" in \
        solver_cache._FINGERPRINT_FILES


def test_issue_kinds_are_the_references():
    assert ka.ISSUE_KINDS == ("out-of-bounds", "final-invalid", "clobber",
                              "grid-race", "read-only-write", "unsupported")
    with pytest.raises(ValueError):
        ka.KernelIssue("k", "read-before-write", "no such kind")


# -- the contract is what ops.py stages --------------------------------------


def _chain(L, seed=0):
    rng = np.random.default_rng(seed)
    n = L + 1
    return Chain.make(uf=rng.integers(1, 5, n).astype(float),
                      ub=rng.integers(1, 5, n).astype(float),
                      wa=rng.integers(1, 4, n).astype(float),
                      wabar=rng.integers(1, 6, n).astype(float),
                      of=rng.integers(0, 2, n).astype(float),
                      ob=rng.integers(0, 2, n).astype(float))


@pytest.mark.parametrize("L", [1, 5, 9])
def test_fused_contract_matches_ops_driver(L):
    ch = _chain(L, seed=L)
    S = int(ch.store_all_peak())
    staged = ops.FusedOperands(ch.discretize(float(S), S), S, True)
    c = ka.fused_contract(L, staged.W)
    assert list(staged.off) == c["off"] and staged.ncells == c["ncells"]
    assert staged.mn.shape == staged.ma.shape == c["thresholds"]
    for v in (staged.wa, staged.wb, staged.cum, staged.uf, staged.ub):
        assert v.size >= c["vector"]
    # _check_fused takes the contract at its tightest and nothing less
    table = torch.zeros(c["table"])
    vec = c["vector"]
    ints = [torch.tensor(c["off"], dtype=torch.int32)] + [
        torch.zeros(vec, dtype=dt) for dt in
        (torch.int32, torch.int32, torch.float32, torch.float32,
         torch.float32)] + [torch.zeros(c["thresholds"], dtype=torch.int32)
                            for _ in range(2)]
    extra = [torch.zeros(vec), torch.zeros(vec)]
    assert ops._check_fused("k", (table, table), ints + extra, L,
                            staged.W) == -1
    with pytest.raises(ValueError):
        ops._check_fused("k", (table[:-1],), ints, L, staged.W)
    short = list(ints)
    short[1] = short[1][:-1]
    with pytest.raises(ValueError):
        ops._check_fused("k", (table,), short, L, staged.W)
    with pytest.raises(ValueError):
        ops._check_fused("k", (table,), ints + [torch.zeros(vec - 1)] * 2,
                         L, staged.W)


@pytest.mark.parametrize("c3", ["two-tier", None, "slice", "gather"])
def test_band_tables_contract_matches_table_bands(c3):
    L, S = 5, 36
    wa = [0, 3, 37, 1, 12, 5] if c3 == "slice" else [0, 3, 40, 1, 1 << 30, 5]
    c = ka.band_tables_contract(L, S, c3, wa)
    nacc = c["nacc"]
    r = torch.zeros(c["r"])
    lefts = [torch.zeros(c["left"]) for _ in range(3)]
    kw = {}
    if nacc == 3:
        kw = {"wa": torch.tensor(wa, dtype=torch.int32)[:c["wa"]],
              "toff": torch.zeros(c["toff"])}
        if c3 == "gather":
            kw["cb"] = torch.zeros(c["cb"])
            kw["cum"] = torch.zeros(c["cum"])
    out = torch.zeros(c["out"])
    bands = ops.TableBands(r, lefts, out, L=L, S=S, c3=c3, **kw)
    assert (bands.nacc, bands.width, bands.capacity) == \
        (nacc, c["width"], c["out"])
    for d in range(1, L + 1):      # every band of the fill fits the output
        assert bands.launch(d, c["width"]) == nacc * (L + 1 - d) * c["width"]
    with pytest.raises(ValueError):
        ops.TableBands(r[:-1], lefts, out, L=L, S=S, c3=c3, **kw)
    if nacc == 3:
        with pytest.raises(ValueError):
            ops.TableBands(r, lefts, out, L=L, S=S, c3=c3,
                           **dict(kw, toff=kw["toff"][:-1]))


@pytest.mark.parametrize("nacc", [1, 3])
def test_band_stacked_contract_matches_wrappers(nacc):
    d, ns, w = 4, 3, 37
    c = ka.band_stacked_contract(d, ns, w, nacc)
    planes = [torch.zeros((d, ns, w)) for _ in range(5)]
    assert planes[0].reshape(-1, w).shape == c["planes"]
    if nacc == 1:
        got = ops.band_min_two_tier(*planes[:2])
        assert got.numel() == c["out"]
    else:
        toff = torch.zeros((ns, 1))
        assert toff.numel() == c["toff"]
        got = ops.band_min_offload(*planes, toff)
        assert sum(g.numel() for g in got) == c["out"]


# -- the matrix reaches the launch geometries ----------------------------------


def test_matrix_covers_lengths_flags_and_ragged_widths():
    fused, band = ka.DEFAULT_FUSED_CASES, ka.DEFAULT_BAND_CASES
    assert {1, 2, 5, 9} <= {c.L for c in fused} and \
        max(c.L for c in fused) >= 33
    assert {c.allow_fall for c in fused} == {False, True}
    assert {(c.offload, c.host_on) for c in fused} == \
        {(False, False), (True, False), (True, True)}
    assert all(c.W % 32 for c in fused) and all(c.width % 32 for c in band)
    assert {(c.rows, c.nacc, c.c3) for c in band} >= {
        ("stacked", 1, None), ("stacked", 3, "operand"),
        ("tables", 1, None), ("tables", 2, None), ("tables", 3, "slice"),
        ("tables", 3, "gather")}
    assert max(c.L for c in band if c.rows == "tables") >= 33


def test_matrix_reaches_group_sizes_and_stride_rounds():
    results = ka.run_cases(ka.build_enumerator(),
                           ka.DEFAULT_BAND_CASES + ka.DEFAULT_FUSED_CASES)
    assert ka.coverage(results) == []
    seen = {}
    for case, issues, stats in results:
        assert issues == []
        k = seen.setdefault(case.kernel, [set(), 0])
        k[0] |= stats["g"]
        k[1] = max(k[1], stats["rounds"])
    for kernel, (gs, rounds) in seen.items():
        assert {1, 16} <= gs, kernel
        if kernel.startswith("fused"):
            assert rounds >= 2, kernel
    assert 2 in seen["band_min<1>"][0]          # K1's cross-warp reduction


# -- seeded defects ------------------------------------------------------------


@pytest.mark.parametrize("fixture,where,kind", [
    ("bad_dp_fill_index_current_band.cuh", "header", "grid-race"),
    ("bad_dp_fill_index_clamp.cuh", "header", "out-of-bounds"),
    ("bad_dp_fill_index_uninit.cuh", "header", "final-invalid"),
    ("bad_dp_fill_index_alias.cuh", "header", "clobber"),
    ("bad_dp_fill_raw_subscript.cu", "fused_source", "unsupported"),
])
def test_seeded_defect_is_flagged(fixture, where, kind):
    issues = ka.analyze_dp_fill(**{where: FIXTURES / fixture})
    assert kind in {i.kind for i in issues}, \
        "\n".join(str(i) for i in issues) or "analyzed clean"


@pytest.mark.parametrize("fixture,where,kind", [
    ("bad_dp_fill_index_current_band.cuh", "HEADER", "grid-race"),
    ("bad_dp_fill_index_uninit.cuh", "HEADER", "final-invalid"),
    ("bad_dp_fill_raw_subscript.cu", "FUSED_SOURCE", "unsupported"),
])
def test_gate_fails_on_a_seeded_defect(fixture, where, kind, monkeypatch,
                                       tmp_path, capsys):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    monkeypatch.setattr(ka, where, FIXTURES / fixture)
    assert main(["--force"]) == 1
    out = capsys.readouterr().out
    assert f": {kind}: " in out
    assert not (tmp_path / "repro_torch" / "kernel-analysis.ok").exists()


def test_missing_header_reports_unsupported(tmp_path):
    issues = ka.analyze_dp_fill(header=tmp_path / "dp_fill_index.cuh")
    assert [i.kind for i in issues] == ["unsupported"]


def _mutated(tmp_path, old, new):
    src = ka.HEADER.read_text()
    assert src.count(old) == 1
    path = tmp_path / "dp_fill_index.cuh"
    path.write_text(src.replace(old, new))
    return path


@pytest.mark.parametrize("old,new", [
    # a body reads a view's pointer by a raw subscript
    ("const V lb = f.tb.ld(lrow, c) - cum_s;",
     "const V lb = f.tb.p_[lrow] - cum_s;"),
    # a body loads past the views
    ("rv[k] = b.r.ld(rrow, c);", "rv[k] = __ldg(&b.r.ld(rrow, c));"),
    # a body reads the thread index itself
    ("const int row = x.block();", "const int row = blockIdx.x;"),
    # a body declares a pointer
    ("const int c = r.c;", "const int c = r.c;\n      const float* q = 0;"),
    # the trusted section loses its bounds
    ("// ---- end of device primitives", "// ----"),
])
def test_header_scan_reports_a_bypass(tmp_path, old, new):
    issues = ka.scan_sources(header=_mutated(tmp_path, old, new))
    assert issues and {i.kind for i in issues} == {"unsupported"}


def test_enumerator_that_does_not_compile_is_unsupported(tmp_path):
    path = _mutated(tmp_path, "r.accb = fminf(r.accb, rv + lb);",
                    "r.accb = fminf(r.accb, rv + lb) +;")
    issues = ka.analyze_dp_fill(header=path)
    assert any(i.kind == "unsupported" and "compile" in i.message
               for i in issues)


# -- the gate ------------------------------------------------------------------


@pytest.mark.parametrize("flags", [[], ["--force"], ["--no-cache"],
                                   ["--skip-kernels"],
                                   ["--force", "--no-cache"]])
def test_gate_passes_with_each_flag(flags, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    stamp = tmp_path / "repro_torch" / "kernel-analysis.ok"
    assert main(flags) == 0
    out = capsys.readouterr().out
    assert "lint: ok" in out and "not run" not in out
    if "--skip-kernels" in flags:
        assert "kernel-analysis" not in out and not stamp.exists()
        return
    assert "kernel-analysis: ok" in out
    assert stamp.exists() == ("--no-cache" not in flags)
    if stamp.exists():
        assert stamp.read_text().strip() == ka.cache_key()
        assert main(flags) == 0
        again = capsys.readouterr().out
        want = "kernel-analysis: ok" if "--force" in flags else \
            "kernel-analysis: cached ok"
        assert want in again


def test_gate_runs_without_torch_jax_or_repro_and_in_time(tmp_path):
    """The gate imports neither torch nor jax nor the JAX package, builds
    its enumerator from nothing (a fresh build directory) and finishes well
    inside 30 s on a CPU."""
    code = f"""
import sys
for name in ("torch", "jax", "repro"):
    sys.modules[name] = None
from repro_torch.check import kernel_analyzer
from pathlib import Path
kernel_analyzer.BUILD_DIR = Path({str(tmp_path / "build")!r})
from repro_torch.check.__main__ import main
sys.exit(main(["--force"]))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XDG_CACHE_HOME=str(tmp_path / "cache"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "kernel-analysis: ok" in proc.stdout
    assert seconds < 30, seconds


# -- the library digest follows the header -------------------------------------


def test_library_path_hashes_the_included_header(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    for name in ("dp_band_min", "dp_fused_fill"):
        assert _build.library_path(name, csrc) == _build.library_path(name)
    before = {n: _build.library_path(n, csrc) for n in _build.SOURCES}
    with open(csrc / "dp_fill_index.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n, csrc) for n in _build.SOURCES}
    assert after["dp_band_min"] != before["dp_band_min"]
    assert after["dp_fused_fill"] != before["dp_fused_fill"]
    for name in ("flash_attn_fwd", "rms_norm", "ssd_chunk"):
        assert after[name] == before[name]
