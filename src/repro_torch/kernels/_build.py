"""Build the port's hand-written CUDA kernels and load them with ``ctypes``.

Each source in ``csrc/`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a`` and without ``--use_fast_math`` (the DP band-min must
stay bit-exact, denormals included), into ``build/torch_ext/`` under the
checkout root.  The library's file name carries a hash of its source and
flags, so an edited source is rebuilt and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all together.

Nothing is built at import: the first launch of a kernel builds and loads its
library, and a failed build raises.  A wrapper holds each C function as a
:class:`Binding`, whose ``argtypes`` and ``restype`` are set once, when the
library loads; a launch then costs one attribute read before the ``ctypes``
call, with no lock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
SOURCES = ("dp_band_min", "dp_fused_fill", "flash_attn_fwd", "rms_norm",
           "ssd_chunk")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                           "the port's CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` each, all started together.  Returns the seconds each build took
    (0.0 for a library already built); raises with ``nvcc``'s output if any
    build fails.  ``ptxas``'s register and shared-memory report is kept
    beside each library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        out.with_name(out.name + ".log").write_text(log)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        if name not in _LIBS:
            build_all([name])
            _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return _LIBS[name]


class Binding:
    """One C function of ``csrc/<lib>.cu``: ``fn`` is the ``ctypes``
    function, typed, once :meth:`load` has run (``None`` before)."""

    __slots__ = ("lib", "name", "argtypes", "restype", "fn")

    def __init__(self, lib: str, name: str, argtypes: Sequence[Any],
                 restype: Any = ctypes.c_int):
        self.lib, self.name = lib, name
        self.argtypes, self.restype = list(argtypes), restype
        self.fn: Optional[Any] = None

    def load(self):
        """Build and load the library if need be, type the function, keep
        it in ``fn`` and return it."""
        fn = getattr(library(self.lib), self.name)
        fn.argtypes, fn.restype = self.argtypes, self.restype
        self.fn = fn
        return fn


def stream(index: int) -> int:
    """The handle of the current CUDA stream on the device of this index (a
    tensor's ``get_device()``), as the launchers take it (read without
    building a ``torch.cuda.Stream``: host time counts on every launch)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(status: int, what: str, error_string: Binding) -> None:
    """Raise if a launcher returned a CUDA error code (a refused launch
    never runs, and a later synchronize would not report it);
    ``error_string`` binds the library's ``cudaGetErrorString`` export."""
    if status != 0:
        text = (error_string.fn or error_string.load())(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({text})")
