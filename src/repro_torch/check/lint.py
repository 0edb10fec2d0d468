"""AST-based repo-invariant linter (``python -m repro_torch.check``): the
port of ``repro.check.lint``'s four rules, on ``src/repro_torch``, and a
fifth of the port's own.

- **torch-import** — the modules that must import without the accelerator
  stack (all of ``core/`` except the three executor-side modules, all of
  ``obs/``, ``check/`` and ``store/``) import ``torch`` — or a port module
  known to import it — only inside functions, never at module level.  This
  keeps ``import repro_torch.core`` / ``repro_torch.obs.metrics`` working
  on plan-serving hosts with no PyTorch.
- **policy-parse** — policy *strings* are parsed in exactly one place,
  ``plan/compat.py``: any ``x.startswith("optimal..."/"periodic:"/...)``
  on a policy prefix outside it is flagged.
- **metric-name** — literal metric names passed to
  ``metrics.counter/gauge/histogram/value`` follow the dotted ``noun.verb``
  registry convention (``solver_cache.hits``, ``train.step_seconds``);
  f-string names are checked with placeholders substituted.
- **pickle-confinement** — raw (de)serialization modules (``pickle`` et
  al.) are imported only under ``store/``: every other module persists
  through the tamper-evident ``store.codec`` envelope.  Checked over the
  whole AST (function-local imports count).
- **port-isolation** — nothing imports ``jax``, ``jaxlib`` or the JAX
  package ``repro``, function-local imports included: the port stands
  alone (the static half of ``tests/test_torch_isolation.py``).

The linter is purely syntactic (no imports of the linted modules), so it
runs in any environment.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, List, Optional

# -- rule configuration ------------------------------------------------------

# Modules that must stay importable without torch.  Paths relative to the
# ``src/repro_torch`` root; directory entries cover every .py directly
# inside.
TORCH_FREE_DIRS = ("core", "obs", "check", "store")
# core modules that *are* the torch boundary (execution side) — exempt.
TORCH_BOUNDARY = {
    "core/executor.py",
    "core/planner.py",
    "core/rematerialize.py",
}
# Importing any of these at module level re-introduces torch transitively.
_TORCH_ROOTS = ("torch", "triton")
_TORCH_PORT_MODULES = (
    "repro_torch.core.executor",
    "repro_torch.core.planner",
    "repro_torch.core.rematerialize",
    "repro_torch.offload.executor",
    "repro_torch.offload.host_buffer",
    "repro_torch.ckpt",
    "repro_torch.kernels",
)
_TORCH_RELATIVE = ("executor", "planner", "rematerialize", "host_buffer")

# Policy-string prefixes whose parsing is confined to plan/compat.py.
POLICY_PREFIXES = (
    "optimal",
    "optimal_offload",
    "periodic:",
    "rotor:",
    "revolve:",
    "store_all",
    "full_remat",
    "min_memory",
)
POLICY_PARSE_ALLOWED = ("plan/compat.py",)

# Raw (de)serialization is confined to the store package.
_PICKLE_MODULES = ("pickle", "cPickle", "dill", "marshal", "shelve")
PICKLE_ALLOWED_DIRS = ("store",)

# Dotted lowercase noun.verb convention for registry metric names.
METRIC_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")
_METRIC_FNS = {"counter", "gauge", "histogram", "value"}
_METRIC_RECEIVERS = {"metrics", "_obs", "obs", "obs_metrics"}

# Top-level modules the port never imports.
FORBIDDEN_ROOTS = ("jax", "jaxlib", "repro")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# -- helpers -----------------------------------------------------------------


def _module_level_imports(tree: ast.Module) -> Iterable[ast.stmt]:
    """Import statements at module scope, descending into plain module-level
    ``if``/``try`` blocks except ``if TYPE_CHECKING:`` (annotation-only)."""
    stack: List[ast.stmt] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        elif isinstance(node, ast.If):
            if "TYPE_CHECKING" not in ast.dump(node.test):
                stack.extend(node.body)
                stack.extend(node.orelse)
        elif isinstance(node, ast.Try):
            stack.extend(node.body)
            for h in node.handlers:
                stack.extend(h.body)
            stack.extend(node.orelse)
            stack.extend(node.finalbody)


def _is_torch_module(name: str) -> bool:
    if name.split(".")[0] in _TORCH_ROOTS:
        return True
    return any(name == m or name.startswith(m + ".")
               for m in _TORCH_PORT_MODULES)


def _literal_str(node: ast.AST) -> Optional[str]:
    """The string a literal (or f-string with placeholders → ``"x"``)
    evaluates to, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        return "".join(v.value if isinstance(v, ast.Constant)
                       and isinstance(v.value, str) else "x"
                       for v in node.values)
    return None


def _imported_names(rel: str, node: ast.stmt) -> List[str]:
    """The absolute module names an import statement brings in (a
    relative import resolved against ``repro_torch`` and ``rel``'s
    package)."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if not node.level:
        return [node.module or ""]
    pkg = ["repro_torch"] + rel.split("/")[:-1]
    base = ".".join(pkg[: len(pkg) - (node.level - 1)])
    mod = node.module or ""
    names = [(base + "." + mod if mod else base) + "." + a.name.split(".")[0]
             for a in node.names]
    # `from . import executor`-style by bare name
    names += [a.name for a in node.names
              if a.name in _TORCH_RELATIVE and not mod]
    if mod:
        names.append(base + "." + mod)
    return names


# -- rules -------------------------------------------------------------------


def _check_torch_imports(rel: str, tree: ast.Module) -> List[LintViolation]:
    parts = rel.split("/")
    if not (len(parts) == 2 and parts[0] in TORCH_FREE_DIRS
            and rel not in TORCH_BOUNDARY):
        return []
    out = []
    for node in _module_level_imports(tree):
        for name in _imported_names(rel, node):
            if (_is_torch_module(name)
                    or name.split(".")[-1] in _TORCH_RELATIVE):
                out.append(LintViolation(
                    rel, node.lineno, "torch-import",
                    f"module-level import of {name!r} in a torch-free "
                    f"module (use a function-local import)"))
                break
    return out


def _check_policy_parse(rel: str, tree: ast.Module) -> List[LintViolation]:
    if rel in POLICY_PARSE_ALLOWED:
        return []
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "startswith" and node.args):
            continue
        arg = node.args[0]
        literals = ([_literal_str(e) for e in arg.elts]
                    if isinstance(arg, ast.Tuple) else [_literal_str(arg)])
        for lit in literals:
            if lit is not None and any(lit == p or lit.startswith(p)
                                       for p in POLICY_PREFIXES):
                out.append(LintViolation(
                    rel, node.lineno, "policy-parse",
                    f"policy-string parsing ({lit!r}) outside "
                    f"plan/compat.py — route through the compat shim"))
                break
    return out


def _check_metric_names(rel: str, tree: ast.Module) -> List[LintViolation]:
    # names imported straight from the metrics module count as receivers
    imported: set = set()
    for node in _module_level_imports(tree):
        if (isinstance(node, ast.ImportFrom)
                and (node.module or "").endswith("metrics")):
            imported |= {a.asname or a.name for a in node.names}
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and node.args):
            continue
        fn = node.func
        is_metric_call = (
            isinstance(fn, ast.Attribute) and fn.attr in _METRIC_FNS
            and isinstance(fn.value, ast.Name)
            and fn.value.id in _METRIC_RECEIVERS
        ) or (isinstance(fn, ast.Name) and fn.id in _METRIC_FNS
              and fn.id in imported)
        if not is_metric_call:
            continue
        name = _literal_str(node.args[0])
        if name is not None and not METRIC_NAME_RE.match(name):
            out.append(LintViolation(
                rel, node.lineno, "metric-name",
                f"metric name {name!r} does not match the dotted noun.verb "
                f"convention ({METRIC_NAME_RE.pattern})"))
    return out


def _absolute_imports(tree: ast.Module) -> Iterable[tuple]:
    """``(node, module name)`` of every absolute import in the whole tree
    (function-local ones included)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node, node.module or ""


def _check_pickle_confinement(rel: str, tree: ast.Module
                              ) -> List[LintViolation]:
    if rel.split("/")[0] in PICKLE_ALLOWED_DIRS:
        return []
    out, seen = [], set()
    for node, name in _absolute_imports(tree):
        if name.split(".")[0] in _PICKLE_MODULES and id(node) not in seen:
            seen.add(id(node))
            out.append(LintViolation(
                rel, node.lineno, "pickle-confinement",
                f"import of {name!r} outside store/ — all (de)serialization "
                f"goes through the repro_torch.store.codec envelope"))
    return out


def _check_port_isolation(rel: str, tree: ast.Module) -> List[LintViolation]:
    out, seen = [], set()
    for node, name in _absolute_imports(tree):
        if name.split(".")[0] in FORBIDDEN_ROOTS and id(node) not in seen:
            seen.add(id(node))
            out.append(LintViolation(
                rel, node.lineno, "port-isolation",
                f"import of {name!r}: the port imports neither JAX nor the "
                f"JAX package"))
    return out


_RULES = (
    _check_torch_imports,
    _check_policy_parse,
    _check_metric_names,
    _check_pickle_confinement,
    _check_port_isolation,
)


# -- entry points ------------------------------------------------------------


def lint_file(path: str, root: str) -> List[LintViolation]:
    rel = os.path.relpath(path, root).replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintViolation(rel, e.lineno or 0, "syntax",
                              f"cannot parse: {e}")]
    out: List[LintViolation] = []
    for rule in _RULES:
        out.extend(rule(rel, tree))
    return out


def lint_paths(paths: Iterable[str], root: str) -> List[LintViolation]:
    out: List[LintViolation] = []
    for p in sorted(paths):
        out.extend(lint_file(p, root))
    return out


def package_root() -> str:
    """The ``src/repro_torch`` package root this module was loaded from."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_repo(root: Optional[str] = None) -> List[LintViolation]:
    """Lint every ``.py`` under ``src/repro_torch`` (the gate's entry
    point)."""
    root = root or package_root()
    files = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        files.extend(os.path.join(dirpath, fn) for fn in filenames
                     if fn.endswith(".py"))
    return lint_paths(files, root)
