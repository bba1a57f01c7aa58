"""Finds a cell's pieces by name, from files alone.

``BENCHMARK.json`` at the checkout's root names the cells; each cell names a
configuration (its file is listed in ``configs``) and a traffic mix
(``portbench/traffic/<mix>.json``), and the mix names its driver
(``portbench/drivers/<driver>.py``).  Per-layer metrics are readers in
``portbench/metrics/<metric>.py``, work counts in ``portbench/work/<op>.py``,
and the limits a cell's output check holds in
``portbench/limits/<cell>.json``.  Adding any of these is adding a file and an
entry; no file here names a cell.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell(name: str, bench: dict) -> Dict:
    """-> {"workload", "config", "traffic", "limits", "end_to_end",
    "per_layer"} of the cell ``name``: its entry, its configuration and
    traffic files' contents, its limits, and the metrics it reports."""
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    limits_path = BENCH / "limits" / f"{name}.json"

    def reports(m):
        return name in m.get("workloads", [name])

    return {
        "workload": w,
        "config": read_json(BENCH.parent / cfg_entry["file"]),
        "traffic": read_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        "limits": (read_json(limits_path)["limits"]
                   if limits_path.is_file() else {}),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }
