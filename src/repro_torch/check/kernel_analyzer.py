"""Static analyzer for the CUDA DP-fill kernels — the port of
``repro.check.kernel_analyzer``.

It proves, on a matrix of launches, that the four kernels of
``kernels/csrc/`` that fill the checkpointing DP — ``band_min<1>`` (K1),
``band_min<2>`` / ``band_min<3>`` (K5a, both ways of naming split rows and
all three sources of the C3 plane) and ``fused_fill<false>`` /
``fused_fill<true>`` (K2, K5b) — stay inside their buffers, read only what
an earlier band (or the host, before the launch) wrote, write every result
cell exactly once and from valid values, and never write an input.

How it reads the code nvcc compiles.  Each kernel's body, every index it
computes and every access it makes live in one header,
``kernels/csrc/dp_fill_index.cuh``, as templates over the operand views
and the execution context; the ``.cu`` files keep the ``__global__`` shells
and the launchers.  The analyzer

1. scans the sources: every ``__global__`` body may only declare its
   shared memory and hand views to the header's body, the launchers must
   take their geometry from the header, and outside the header's device
   primitives (the views' loads and stores, the trusted base) nothing may
   subscript, load, store, declare a pointer or read a thread index — a
   raw access is reported ``unsupported`` instead of escaping the proof;
2. compiles ``dp_fill_enum.cpp`` with the host C++ compiler against that
   header: the same bodies, instantiated with shadow views that check each
   index against the driver contract (:func:`fused_contract`,
   :func:`band_tables_contract`, :func:`band_stacked_contract`, mirrored
   from ``kernels/dp_fill/ops.py`` and pinned by the tests) and a context
   that walks the real launch order — every block of the grid, bands in
   turn with a grid barrier between them, each block's stride loop, each
   thread's splits, phase by phase between block barriers;
3. runs it over the case matrix (integer operands drawn from a seed with
   their extremes: 0, the width, 2^30, int32's top) and turns what it
   reports into :class:`KernelIssue` s.

Known-sound / known-incomplete boundary: indices are exact on each case;
float values are abstracted to validity (IEEE min/max/add trusted); the
matrix is finite (it must reach group sizes 1 and 16, a stride loop of two
rounds and K1's cross-warp reduction, or the analysis reports
``unsupported``); the device views and ``DeviceX`` are trusted to do what
the host ones model.  Anything the scan or the build cannot place is
``unsupported`` — the gate fails closed.

Results are keyed by :func:`repro_torch.core.solver_cache.code_fingerprint`
(which hashes the header and both kernel sources): ``python -m
repro_torch.check`` skips the analysis when the fingerprint matches the
last recorded pass.  Neither ``torch`` nor ``jax`` is imported.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import random
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

ISSUE_KINDS = (
    "out-of-bounds",      # an index escapes the driver-contract shape
    "final-invalid",      # a read of unwritten memory, or a result cell not
                          # written exactly once from valid values
    "clobber",            # a write to another band's cell, or a second write
    "grid-race",          # a read of the current band's cells; a shared race
    "read-only-write",    # the kernel writes an input buffer
    "unsupported",        # outside the analyzed route (fail closed)
)


@dataclasses.dataclass(frozen=True)
class KernelIssue:
    kernel: str
    kind: str
    message: str
    case: str = ""

    def __post_init__(self):
        if self.kind not in ISSUE_KINDS:
            raise ValueError(f"unknown issue kind {self.kind!r}")

    def __str__(self) -> str:
        where = f" [{self.case}]" if self.case else ""
        return f"{self.kernel}: {self.kind}: {self.message}{where}"


class _Unsupported(Exception):
    pass


CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"
HEADER = CSRC / "dp_fill_index.cuh"
BAND_SOURCE = CSRC / "dp_band_min.cu"
FUSED_SOURCE = CSRC / "dp_fused_fill.cu"
ENUMERATOR = Path(__file__).resolve().parent / "dp_fill_enum.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernel_analyzer"
CXX_FLAGS = ("-O2", "-std=c++17", "-w")

INT_CLAMP = 1 << 30
INT32_MAX = (1 << 31) - 1
#: round warps of band_min's launcher: an H100's 132 SMs at 4 blocks of 16
#: warps, and a card of one SM at one block (group sizes held back)
ROUND_WARPS = (132 * 4 * 16, 16)
#: fused grids: one block per SM of an H100, and two and one blocks (stride
#: loops of several rounds)
FUSED_GRIDS = (132, 2, 1)
LENGTHS = (1, 2, 5, 9, 33)
WIDTHS = (5, 37)                 # 1 and 2 tiles of 32, neither a multiple


# -- the driver contract (kernels/dp_fill/ops.py) ---------------------------

def band_offsets(L: int) -> List[int]:
    """``FusedOperands.off``: band ``d`` starts at row ``off[d]``."""
    off = [0]
    for d in range(L + 1):
        off.append(off[-1] + L + 1 - d)
    return off


def fused_contract(L: int, W: int) -> Dict[str, object]:
    """What ``_check_fused`` accepts at its tightest: ``(ncells, W)``
    tables, ``off`` of ``L + 2``, ``(L, L)`` thresholds and vectors of
    ``L + 1`` (``toff``/``tpre`` too)."""
    off = band_offsets(L)
    return {"off": off, "ncells": off[-1], "table": (off[-1], W),
            "vector": L + 1, "thresholds": (L, L)}


def band_tables_contract(L: int, S: int, c3: Optional[str],
                         wa: Sequence[int] = ()) -> Dict[str, object]:
    """What ``TableBands`` binds for a per-band fill (``fill_two_tier`` /
    ``fill_offload``): tables of ``ncells`` rows, ``R`` ``S + 1`` wide (plus
    the widest shift for C3 by slice), the lefts ``S + 1``, ``C_b`` ``S + 2``;
    ``wa`` and ``cum`` of ``L + 1``, ``toff`` of ``L``; the band width
    ``TableBands.width``; the output ``nacc * L * (S + 1)`` floats
    (``_Uplink``)."""
    nacc = {"two-tier": 1, None: 2}.get(c3, 3)
    ncells = (L + 1) * (L + 2) // 2
    rcols = S + 1 + (max(wa) if c3 == "slice" else 0)
    width = S + 1
    if c3 == "slice":
        width = min(width, rcols - max(wa[:L]))
    return {"nacc": nacc, "ncells": ncells, "r": (ncells, rcols),
            "left": (ncells, S + 1),
            "cb": (ncells, S + 2) if c3 == "gather" else None,
            "wa": L + 1 if nacc == 3 else 0,
            "cum": L + 1 if c3 == "gather" else 0,
            "toff": L if nacc == 3 else 0, "width": width,
            "out": nacc * L * (S + 1)}


def band_stacked_contract(d: int, ns: int, w: int,
                          nacc: int) -> Dict[str, object]:
    """``band_min_two_tier`` / ``band_min_offload``: ``(d, ns, w)`` planes
    (rows ``d * ns`` of ``w``), ``toff`` ``(ns, 1)``, out ``(nacc, ns,
    w)``."""
    return {"planes": (d * ns, w), "toff": ns if nacc == 3 else 0,
            "out": nacc * ns * w}


# -- the case matrix ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedCase:
    L: int
    W: int
    grid: int
    allow_fall: bool
    offload: bool
    host_on: bool = False
    seed: int = 0

    @property
    def kernel(self) -> str:
        return f"fused_fill<{'true' if self.offload else 'false'}>"

    def describe(self) -> str:
        return (f"L={self.L} W={self.W} grid={self.grid} "
                f"allow_fall={int(self.allow_fall)}"
                + (f" host_on={int(self.host_on)}" if self.offload else ""))


@dataclasses.dataclass(frozen=True)
class BandCase:
    rows: str                 # "stacked" or "tables"
    nacc: int
    c3: Optional[str]         # "operand", "slice", "gather" (nacc 3)
    L: int                    # tables: the chain; stacked: the splits d
    width: int                # tables: S + 1; stacked: w
    warps: int
    ns: int = 1               # stacked only
    seed: int = 0

    @property
    def kernel(self) -> str:
        return f"band_min<{self.nacc}>"

    def describe(self) -> str:
        what = (f"d={self.L} ns={self.ns} w={self.width}"
                if self.rows == "stacked" else
                f"L={self.L} S={self.width - 1}")
        return (f"{self.rows} {what} c3={self.c3} warps={self.warps}")


DEFAULT_FUSED_CASES: Tuple[FusedCase, ...] = tuple(
    FusedCase(L, W, grid, af, offload, host_on, seed=i)
    for i, (L, W, grid, af, offload, host_on) in enumerate(
        (L, W, grid, af, offload, host_on)
        for L in LENGTHS for W in WIDTHS for grid in FUSED_GRIDS
        for af in (False, True)
        for offload, host_on in ((False, False), (True, False),
                                 (True, True))))

DEFAULT_BAND_CASES: Tuple[BandCase, ...] = tuple(
    [BandCase("stacked", nacc, "operand" if nacc == 3 else None, d, w, warps,
              ns=ns, seed=i)
     for i, (nacc, d, w, warps, ns) in enumerate(
         (nacc, d, w, warps, ns) for nacc in (1, 2, 3) for d in LENGTHS
         for w in WIDTHS for warps in ROUND_WARPS for ns in (1, 3))]
    + [BandCase("tables", nacc, c3, L, width, warps, seed=1000 + i)
       for i, (nacc, c3, L, width, warps) in enumerate(
           (nacc, c3, L, width, warps)
           for nacc, c3 in ((1, None), (2, None), (3, "slice"),
                            (3, "gather"))
           for L in LENGTHS for width in WIDTHS for warps in ROUND_WARPS)])


def _draw(rng: random.Random, n: int, palette: Sequence[int]) -> List[int]:
    return [rng.choice(palette) for _ in range(n)]


def _fused_line(case: FusedCase) -> str:
    L, W = case.L, case.W
    c = fused_contract(L, W)
    rng = random.Random(case.seed)
    # integer operands as the host stages them: clamped to [0, 2^30]
    shifts = (0, 1, W // 2, W - 1, W, W + 1, 2 * W, INT_CLAMP)
    bounds = (0, 0, 1, W // 2, W - 1, W, INT_CLAMP)
    wa, wb = (_draw(rng, c["vector"], shifts) for _ in range(2))
    mn, ma = (_draw(rng, L * L, bounds) for _ in range(2))
    fields = ["fused", int(case.offload), L, W, case.grid,
              int(case.allow_fall), int(case.host_on), c["ncells"],
              c["vector"]]
    return " ".join(map(str, fields + c["off"] + wa + wb + mn + ma))


def _band_line(case: BandCase) -> str:
    if case.rows == "stacked":
        c = band_stacked_contract(case.L, case.ns, case.width, case.nacc)
        return " ".join(map(str, [
            "stacked", case.nacc, case.L, case.ns, case.width, case.warps,
            *c["planes"], c["toff"], c["out"]]))
    L, S1 = case.L, case.width
    rng = random.Random(case.seed)
    wa = [0] * (L + 1)
    if case.c3 == "slice":       # min(WA, S + 1)
        wa = _draw(rng, L + 1, (0, 1, S1 // 2, S1 - 1, S1))
    elif case.c3 == "gather":    # WA, int32
        wa = _draw(rng, L + 1, (0, 1, S1 // 2, S1, S1 + 1, 2 * S1,
                                INT_CLAMP, INT32_MAX))
    c = band_tables_contract(L, S1 - 1, case.c3 if case.nacc == 3 else
                             ("two-tier" if case.nacc == 1 else None), wa)
    code = {None: -1, "slice": 1, "gather": 2}[case.c3]
    return " ".join(map(str, [
        "tables", case.nacc, code, L, S1 - 1, c["width"], case.warps,
        c["ncells"], c["r"][1], c["left"][1],
        c["cb"][1] if c["cb"] else 0, c["wa"], c["cum"], c["toff"],
        c["out"]] + wa[:c["wa"]]))


# -- the source scan ---------------------------------------------------------

_DEVICE_BEGIN = "// ---- device primitives"
_DEVICE_END = "// ---- end of device primitives"
_FORBIDDEN = re.compile(
    r"\b(__ld\w*|__st\w*|atomic\w*|asm|reinterpret_cast|threadIdx|blockIdx|"
    r"blockDim|gridDim|__syncthreads|this_grid|__shared__|extern|volatile|"
    r"memcpy|p_)\b|->")
_TYPES = r"(?:float|double|int|bool|char|void|auto|size_t|int64_t|int32_t|" \
         r"uint\w*|unsigned|V|T)"
_POINTER_DECL = re.compile(
    r"\b" + _TYPES + r"\s*(?:const\s*)?\*+\s*(?:const\s+)?[A-Za-z_]\w*\s*"
    r"[=;,)\[]")
_ARRAY_DECL = re.compile(r"^(?:const\s+)?" + _TYPES + r"\s+(.*)$", re.S)


def _strip(src: str) -> str:
    """Comments, string literals and preprocessor lines blanked (offsets and
    line numbers kept)."""
    out = re.sub(r"/\*.*?\*/", lambda m: re.sub(r"[^\n]", " ", m.group()),
                 src, flags=re.S)
    out = re.sub(r"//[^\n]*", lambda m: " " * len(m.group()), out)
    out = re.sub(r'"(?:\\.|[^"\\\n])*"', lambda m: " " * len(m.group()),
                 out)
    return re.sub(r"(?m)^[ \t]*#[^\n]*", lambda m: " " * len(m.group()),
                  out)


def _line(src: str, pos: int) -> int:
    return src.count("\n", 0, pos) + 1


def _matching(src: str, pos: int, open_: str = "{", close: str = "}") -> int:
    depth = 0
    for i in range(pos, len(src)):
        if src[i] == open_:
            depth += 1
        elif src[i] == close:
            depth -= 1
            if depth == 0:
                return i
    raise _Unsupported(f"unbalanced {open_}{close} from offset {pos}")


def _declared_arrays(code: str) -> set:
    names = set()
    for stmt in re.split(r"[;{}]", code):
        m = _ARRAY_DECL.match(stmt.strip())
        if not m:
            continue
        depth, start = 0, 0
        rest = m.group(1)
        parts = []
        for i, ch in enumerate(rest):
            depth += ch in "([<"
            depth -= ch in ")]>"
            if ch == "," and depth == 0:
                parts.append(rest[start:i])
                start = i + 1
        parts.append(rest[start:])
        for part in parts:
            d = re.match(r"\s*([A-Za-z_]\w*)\s*\[", part)
            if d:
                names.add(d.group(1))
    return names


def _subscript_base(code: str, pos: int) -> Optional[str]:
    """The name subscripted by the ``[`` at ``pos``: None for a lambda
    introducer or an attribute, "" for a subscript of an expression."""
    i = pos - 1
    while i >= 0 and code[i].isspace():
        i -= 1
    if i < 0:
        return None
    while code[i] == "]":                      # a chain: a[i][j]
        depth = 0
        while i >= 0:
            depth += code[i] == "]"
            depth -= code[i] == "["
            i -= 1
            if depth == 0:
                break
        while i >= 0 and code[i].isspace():
            i -= 1
    if code[i] == ")":
        return ""
    if not (code[i].isalnum() or code[i] == "_"):
        return None
    end = i + 1
    while i >= 0 and (code[i].isalnum() or code[i] == "_"):
        i -= 1
    name = code[i + 1:end]
    return None if name in ("return",) else name


def _scan_header(path: Path) -> List[KernelIssue]:
    issues: List[KernelIssue] = []

    def bad(msg: str) -> None:
        issues.append(KernelIssue("dp_fill_index.cuh", "unsupported", msg))

    raw = path.read_text()
    a, b = raw.find(_DEVICE_BEGIN), raw.find(_DEVICE_END)
    if a < 0 or b < a:
        bad(f"{path.name}: no '{_DEVICE_BEGIN}' ... '{_DEVICE_END}' section")
        a = b = len(raw)
    code = _strip(raw[:a] + "\n" * raw[a:b].count("\n") + raw[b:])
    for m in _FORBIDDEN.finditer(code):
        bad(f"{path.name}:{_line(code, m.start())}: '{m.group()}' outside "
            f"the device primitives")
    for m in _POINTER_DECL.finditer(code):
        bad(f"{path.name}:{_line(code, m.start())}: pointer declaration "
            f"'{m.group().strip()}' outside the device primitives")
    arrays = _declared_arrays(code)
    for m in re.finditer(r"\[", code):
        base = _subscript_base(code, m.start())
        if base is not None and base not in arrays:
            bad(f"{path.name}:{_line(code, m.start())}: raw subscript of "
                f"'{base or 'an expression'}': global and shared memory go "
                f"through a view")
    return issues


_SHELL_OK = (
    re.compile(r"^(?:extern\s+)?__shared__\s+\w+\s+\w+\s*(?:\[[\w\s*+]*\])+$"),
    re.compile(r"^(?:dpfill::)?DeviceX\s+\w+$"),
)
_ARGS_OK = re.compile(r"^[\w\s:<>(),?]*$")


def _scan_source(path: Path, kernels: Dict[str, str],
                 launch: str) -> List[KernelIssue]:
    """``kernels``: each ``__global__``'s name -> the header body it must
    hand its views to; ``launch``: the header function the launcher must
    take its geometry from."""
    issues: List[KernelIssue] = []

    def bad(kernel: str, msg: str) -> None:
        issues.append(KernelIssue(kernel, "unsupported", msg))

    raw = path.read_text()
    code = _strip(raw)
    if not re.search(r'(?m)^\s*#\s*include\s+"dp_fill_index\.cuh"', raw):
        bad(path.name, f"{path.name} does not include dp_fill_index.cuh")
    if not re.search(r"\b" + launch + r"\s*\(", code):
        bad(path.name, f"{path.name}: the launcher does not take its "
            f"geometry from dpfill::{launch}")
    seen = set()
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                         r"\([^)]*\)\s*)?(\w+)\s*\(", code):
        name = m.group(1)
        seen.add(name)
        if name not in kernels:
            bad(name, f"{path.name}:{_line(code, m.start())}: kernel "
                f"'{name}' is not one the analyzer walks")
            continue
        start = code.index("{", m.end())
        body = code[start + 1:_matching(code, start)]
        calls = 0
        for stmt in body.split(";"):
            stmt = " ".join(stmt.split())
            if not stmt or any(p.match(stmt) for p in _SHELL_OK):
                continue
            call = re.match(r"^(?:dpfill::)?" + kernels[name]
                            + r"\s*<[^;]*?>\s*\((.*)\)$", stmt)
            if call and _ARGS_OK.match(call.group(1)) \
                    and not _FORBIDDEN.search(call.group(1)):
                calls += 1
                continue
            bad(name, f"{path.name}: statement '{stmt}' in kernel '{name}' "
                f"outside the header's body")
        if calls != 1:
            bad(name, f"{path.name}: kernel '{name}' must hand its views to "
                f"dpfill::{kernels[name]} once, does {calls} times")
    for name in set(kernels) - seen:
        bad(name, f"{path.name}: kernel '{name}' not found")
    return issues


def scan_sources(header: Path = HEADER, band_source: Path = BAND_SOURCE,
                 fused_source: Path = FUSED_SOURCE) -> List[KernelIssue]:
    """The scan of step 1 (see the module docstring)."""
    issues = _scan_header(Path(header))
    issues += _scan_source(Path(band_source), {"band_min": "band_min_body"},
                           "band_min_geometry")
    issues += _scan_source(Path(fused_source),
                           {"fused_fill": "fused_fill_body"},
                           "fused_smem_bytes")
    return issues


# -- the enumerator ------------------------------------------------------------

def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise _Unsupported("no host C++ compiler (CXX, c++, g++ or clang++) "
                       "to build the enumerator")


def build_enumerator(header: Path = HEADER) -> Path:
    """Compile ``dp_fill_enum.cpp`` against ``header`` into ``build/``
    (keyed by the sources, the compiler and its flags); raises
    :class:`_Unsupported` with the compiler's output if it fails."""
    header = Path(header).resolve()
    cxx = _compiler()
    h = hashlib.sha256()
    for part in (ENUMERATOR.read_bytes(), header.read_bytes(),
                 str(header).encode(), cxx.encode(),
                 " ".join(CXX_FLAGS).encode()):
        h.update(part)
        h.update(b"\0")
    out = BUILD_DIR / f"dp_fill_enum-{h.hexdigest()[:16]}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.name + ".", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, f'-DDP_FILL_INDEX_HEADER="{header}"', "-o", tmp,
           str(ENUMERATOR)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        log = "\n".join((proc.stdout + proc.stderr).splitlines()[:20])
        raise _Unsupported(f"the enumerator does not compile against "
                           f"{header.name}:\n{log}")
    os.replace(tmp, out)
    return out


def run_cases(binary: Path, cases: Sequence) -> List[Tuple[object, list,
                                                            dict]]:
    """Run ``cases`` (:class:`FusedCase` / :class:`BandCase`) through the
    enumerator: ``(case, issues, stats)`` each, stats as ``{"g": {...},
    "rounds": n, "reads": n, ...}``."""
    text = "".join((_fused_line(c) if isinstance(c, FusedCase)
                    else _band_line(c)) + "\n" for c in cases)
    try:
        proc = subprocess.run([str(binary)], input=text, capture_output=True,
                              text=True, timeout=600)
    except subprocess.TimeoutExpired:
        raise _Unsupported("the enumerator did not finish within 600 s")
    if proc.returncode != 0:
        raise _Unsupported(f"the enumerator exited with {proc.returncode}: "
                           f"{proc.stderr.strip()[:500]}")
    results = []
    blocks = proc.stdout.split("end\n")
    if len(blocks) != len(cases) + 1:
        raise _Unsupported(f"the enumerator answered {len(blocks) - 1} of "
                           f"{len(cases)} cases")
    for case, block in zip(cases, blocks):
        issues, stats = [], {}
        for line in block.splitlines():
            kind, _, rest = line.partition("\t")
            if kind == "issue":
                what, _, msg = rest.partition("\t")
                issues.append(KernelIssue(case.kernel, what, msg,
                                          case.describe()))
            elif kind == "stats":
                for field in rest.split("\t"):
                    key, _, value = field.partition("=")
                    stats[key] = ({int(v) for v in value.split(",") if v}
                                  if key == "g" else int(value))
        results.append((case, issues, stats))
    return results


def coverage(results) -> List[KernelIssue]:
    """The matrix must reach group sizes 1 and 16 in every kernel, a fused
    stride loop of two rounds, and K1's cross-warp reduction."""
    issues = []
    by_kernel: Dict[str, dict] = {}
    for case, _, stats in results:
        k = by_kernel.setdefault(case.kernel, {"g": set(), "rounds": 0})
        k["g"] |= stats.get("g", set())
        k["rounds"] = max(k["rounds"], stats.get("rounds", 0))
    for kernel in ("band_min<1>", "band_min<2>", "band_min<3>",
                   "fused_fill<false>", "fused_fill<true>"):
        k = by_kernel.get(kernel, {"g": set(), "rounds": 0})
        want = {1, 16} | ({2} if kernel == "band_min<1>" else set())
        if not want <= k["g"]:
            issues.append(KernelIssue(kernel, "unsupported",
                                      f"the case matrix reaches group sizes "
                                      f"{sorted(k['g'])}, not all of "
                                      f"{sorted(want)}"))
        if kernel.startswith("fused") and k["rounds"] < 2:
            issues.append(KernelIssue(kernel, "unsupported",
                                      "the case matrix never runs a stride "
                                      "loop of two rounds"))
    return issues


# -- public entry points -----------------------------------------------------

def analyze_dp_fill(header=None, band_source=None,
                    fused_source=None) -> List[KernelIssue]:
    """Analyze the four shipped DP-fill kernels over the default matrix (the
    gate); the arguments swap in another header or kernel source (the tests'
    seeded defects)."""
    header = Path(header or HEADER)
    band_source = Path(band_source or BAND_SOURCE)
    fused_source = Path(fused_source or FUSED_SOURCE)
    for path in (header, band_source, fused_source):
        if not path.is_file():
            return [KernelIssue("dp_fill", "unsupported",
                                f"{path} not found")]
    issues = scan_sources(header, band_source, fused_source)
    try:
        results = run_cases(build_enumerator(header),
                            DEFAULT_BAND_CASES + DEFAULT_FUSED_CASES)
    except _Unsupported as e:
        return issues + [KernelIssue("dp_fill", "unsupported", str(e))]
    for _, found, _ in results:
        issues += found
    return _capped(issues + coverage(results))


def _capped(issues: List[KernelIssue], most: int = 8) -> List[KernelIssue]:
    """At most ``most`` issues of each kernel and kind, then a count."""
    out: List[KernelIssue] = []
    seen: Dict[Tuple[str, str], int] = {}
    for i in issues:
        key = (i.kernel, i.kind)
        seen[key] = seen.get(key, 0) + 1
        if seen[key] <= most:
            out.append(i)
    out += [KernelIssue(kernel, kind, f"{n - most} more of this kind")
            for (kernel, kind), n in seen.items() if n > most]
    return out


def cache_key() -> str:
    """Fingerprint of the solver and kernel sources — analysis results are
    valid exactly as long as this matches
    :func:`repro_torch.core.solver_cache.code_fingerprint`."""
    from ..core.solver_cache import code_fingerprint

    return code_fingerprint()
