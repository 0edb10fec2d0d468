"""Puts the port (``src``) on the path of the benchmark's tests and keeps
its plan cache in memory (no file under the user's cache)."""

import os
import sys
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[2] / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

os.environ.setdefault("REPRO_STORE", "memory://")
