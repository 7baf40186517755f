"""BENCHMARK.json and the files it names, found by name.

A configuration is `configs/<config>.json`, a traffic mix
`traffic/<traffic>.json` (its `driver` key names `drivers/<driver>.py`), a
cell's correctness limits `limits/<cell>.json`, and a per-layer metric is
read by `layers/<family>.py`, where the family is the metric's name up to
the first dot (`roofline.attention.offline` -> `layers/roofline.py`). A
later cell, mix, configuration or metric is added as files and entries; no
file here changes.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parent
ROOT = PACKAGE_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Manifest:
    def __init__(self, data: Dict[str, Any], package_dir: Path = PACKAGE_DIR):
        self.data = data
        self.package_dir = package_dir

    @classmethod
    def load(cls, path: Optional[Path] = None, package_dir: Path = PACKAGE_DIR) -> "Manifest":
        path = Path(path) if path is not None else package_dir.parent / "BENCHMARK.json"
        with open(path) as f:
            return cls(json.load(f), package_dir)

    def cell(self, name: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (it has {[w['name'] for w in self.data['workloads']]})")

    def config_entry(self, name: str) -> Dict[str, Any]:
        for c in self.data["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config_path(self, name: str) -> Path:
        return self.package_dir.parent / self.config_entry(name)["file"]

    def traffic(self, name: str) -> Dict[str, Any]:
        return _read_json(self.package_dir / "traffic" / f"{_checked(name)}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return _read_json(self.package_dir / "limits" / f"{_checked(cell)}.json")["limits"]

    def end_to_end(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.data["end_to_end"] if _in_cell(m, cell)]

    def per_layer(self, cell: str) -> List[Dict[str, Any]]:
        return [m for m in self.data["per_layer"] if _in_cell(m, cell)]


def _in_cell(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _checked(name: str) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


def _read_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def driver(name: str):
    """The module `portbench.drivers.<name>` that serves a traffic mix."""
    return importlib.import_module(f"portbench.drivers.{_checked(name)}")


def reader(metric: str):
    """The `read(metric, run)` function of the metric's family."""
    family = _checked(metric).split(".", 1)[0]
    return importlib.import_module(f"portbench.layers.{family}").read
