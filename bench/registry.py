"""Finds what ``BENCHMARK.json`` names: a cell (``bench/workloads/<cell>.json``),
its configuration (the file its ``configs`` entry gives), its traffic mix
(``bench/traffic/<traffic>.json``), and the modules of a kind by name
(``bench/<kind>/<name>.py``: ``metrics``, ``kernels``, ``reference``,
``inputs``).  Adding a cell, a configuration, a traffic mix or a metric is
adding its files and entries; nothing here lists them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


class UnknownWorkload(KeyError):
    """``--workload`` names no cell of ``BENCHMARK.json``."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: Dict            # the configuration file, normalised
    traffic: Dict         # the traffic mix's parameters
    spec: Dict            # the cell's own file (frozen budget, limits)
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def load_config(path: Path) -> Dict:
    """A configuration file with ``layer_kinds`` spelt out (a file may give
    one ``layer_kind`` for every layer)."""
    conf = load_json(path)
    if "layer_kinds" not in conf:
        conf["layer_kinds"] = [conf["layer_kind"]] * conf["num_layers"]
    return conf


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name``, with everything it names loaded."""
    bench = benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise UnknownWorkload(f"no workload {name!r} in BENCHMARK.json; "
                              f"the cells are {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported
                                  else [])]
    return Cell(name=name, chips=w["chips"],
                conf=load_config(root / configs[w["config"]]["file"]),
                traffic=load_json(root / "bench" / "traffic"
                                  / f"{w['traffic']}.json"),
                spec=load_json(root / "bench" / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def module(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``bench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    key = f"bench.{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = root / "bench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
