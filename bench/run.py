"""The benchmark's command: ``python3 bench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``, run from the root of a checkout.  The
last line of standard output is the run's result as one JSON object; the
last lines of standard error are the numbers that decided ``correct``,
each beside its limit.  It exits non-zero, printing no result, without a
CUDA device for the cell, for an unknown cell, or where the process loaded
JAX or the JAX package."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the port's build and kernel caches at fixed places inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "torchinductor"),
                 ("TRITON_CACHE_DIR", "triton_cache"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
# the checkout's root and the port, in place of this file's directory
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    del sys.path[0]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

if __name__ == "__main__":
    from bench import harness

    sys.exit(harness.main(sys.argv[1:], T_START))
