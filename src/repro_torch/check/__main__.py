"""``python -m repro_torch.check`` — the port's static-checks gate.

Runs the repo-invariant linter (:mod:`.lint`) over every module under
``src/repro_torch`` and exits non-zero on any finding.  Pure AST work: no
torch, no kernel execution.
"""

from __future__ import annotations

import argparse
import sys

from .lint import lint_repo


def main(argv=None) -> int:
    argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="repro_torch static checks: the repo lint").parse_args(
            argv)
    lint = lint_repo()
    if lint:
        print(f"lint: {len(lint)} violation(s)")
        for v in lint:
            print(f"  {v}")
    else:
        print("lint: ok")
    print("kernel-analysis: not run — the JAX package's analyzer interprets "
          "its Pallas kernels; the CUDA sources have no counterpart yet "
          "(ROADMAP.md)")
    return 1 if lint else 0


if __name__ == "__main__":
    sys.exit(main())
