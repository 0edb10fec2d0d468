"""``python -m repro_torch.check`` — the port's static-checks gate.

Runs the repo-invariant linter (:mod:`.lint`) over every module under
``src/repro_torch`` and the kernel analyzer (:mod:`.kernel_analyzer`) over
the CUDA DP-fill kernels; exits non-zero on any finding.  No torch, no jax,
no kernel execution: the analyzer builds its host-only enumerator with the
host C++ compiler.

The kernel analysis is cached on
:func:`repro_torch.core.solver_cache.code_fingerprint` (which hashes the
solver sources, both DP kernels and their index header): an unchanged tree
skips straight to "cached ok".  Pass ``--force`` to re-analyze regardless,
``--no-cache`` to neither read nor write the stamp.
"""

from __future__ import annotations

import argparse
import os
import sys

from .kernel_analyzer import analyze_dp_fill, cache_key
from .lint import lint_repo


def _stamp_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "repro_torch", "kernel-analysis.ok")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="repro_torch static checks: repo lint + CUDA DP-fill "
                    "kernel analysis")
    parser.add_argument("--force", action="store_true",
                        help="re-run the kernel analysis even if the code "
                             "fingerprint matches the cached pass")
    parser.add_argument("--no-cache", action="store_true",
                        help="neither read nor write the analysis stamp")
    parser.add_argument("--skip-kernels", action="store_true",
                        help="run only the repo linter")
    args = parser.parse_args(argv)

    failed = False
    lint = lint_repo()
    if lint:
        failed = True
        print(f"lint: {len(lint)} violation(s)")
        for v in lint:
            print(f"  {v}")
    else:
        print("lint: ok")

    if not args.skip_kernels:
        fp = cache_key()
        stamp = _stamp_path()
        cached = False
        if not args.force and not args.no_cache:
            try:
                with open(stamp, "r", encoding="utf-8") as f:
                    cached = f.read().strip() == fp
            except OSError:
                cached = False
        if cached:
            print(f"kernel-analysis: cached ok ({fp[:12]})")
        else:
            issues = analyze_dp_fill()
            if issues:
                failed = True
                print(f"kernel-analysis: {len(issues)} issue(s)")
                for i in issues:
                    print(f"  {i}")
            else:
                print(f"kernel-analysis: ok ({fp[:12]})")
                if not args.no_cache:
                    try:
                        os.makedirs(os.path.dirname(stamp), exist_ok=True)
                        with open(stamp, "w", encoding="utf-8") as f:
                            f.write(fp + "\n")
                    except OSError:
                        pass
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
