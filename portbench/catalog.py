"""Finds a cell, its configuration, traffic, limits and metric readers by
the names in `BENCHMARK.json`.  Adding a cell, a configuration or a
per-layer metric adds files here; no code names them."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell(NamedTuple):
    name: str
    config: str
    traffic: str
    chips: int
    end_to_end: tuple      # the metric entries this cell reports untraced
    per_layer: tuple       # ... and traced


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str) -> Cell:
    """The workload `name` of BENCHMARK.json; an unknown name raises."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]),
                        tuple(m for m in bench["end_to_end"]
                              if _applies(m, name)),
                        tuple(m for m in bench["per_layer"]
                              if _applies(m, name)))
    known = [w["name"] for w in bench["workloads"]]
    raise ValueError(f"no workload named {name!r}; known: {known}")


def read(kind: str, name: str) -> dict:
    """`<kind>/<name>.json` under portbench/ (kind: configs, traffic or
    limits); a name outside the allowed characters or without a file
    raises."""
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r}: want letters, digits, "
                         f"'_', '.' and '-', at most 64")
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise ValueError(f"no {kind} file for {name!r} ({path.name})")
    with open(path) as f:
        return json.load(f)


def reader(metric: str):
    """The module `metrics/<metric>.py`, whose `read(run)` gives the
    metric's value or None where the run has nothing to read."""
    if not NAME.match(metric):
        raise ValueError(f"metric name {metric!r}")
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise ValueError(f"no reader for metric {metric!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
