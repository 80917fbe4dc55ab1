"""What a cell is, read from `BENCHMARK.json` and the files it names.

A cell (an entry of ``workloads``) names a configuration, whose file is
``configs/<config>.json``; a traffic mix, ``workloads/<traffic>.json``;
and its limits, ``limits/<cell>.json``. The traffic file names the load
generator that drives the cell and launches over its chips,
``loads/<load>.py``, and the policy, whose mode names the check that
judges it, ``checks/<mode>.py``. A per-layer metric is the module
``metrics/<metric>.py``, whose ``read(ctx)`` returns the value or None.
Everything is found by name, so a new cell, load, check or metric is a
new file.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def load(self):
        """The module that runs this cell (``loads/<load>.py``)."""
        return module("loads", self.traffic["load"])

    @property
    def check(self):
        """The module that judges this cell's answers
        (``checks/<policy mode>.py``)."""
        return module("checks", self.traffic["policy"]["mode"])


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _read_json(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=_read_json(HERE / "configs" / f"{w['config']}.json"),
        traffic=_read_json(HERE / "workloads" / f"{w['traffic']}.json"),
        limits=_read_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


_MODULES: dict = {}


def module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark, loaded once."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{kind[:-1]} {name!r} has no module at {path.relative_to(ROOT)}")
    key = (kind, name)
    if key not in _MODULES:
        ident = "portbench_%s_%s" % (kind, "".join(c if c.isalnum() else "_" for c in name))
        spec = importlib.util.spec_from_file_location(ident, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def metric_reader(name: str):
    """The `read` function of ``metrics/<name>.py``."""
    return module("metrics", name).read
