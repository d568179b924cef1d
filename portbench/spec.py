"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of the
checkout, and under this folder

* ``configs/<config>.json`` (the path the configuration's ``file`` gives),
* ``workloads/<cell>.json``, the cell's traffic,
* ``metrics/<metric>.py``, one reader a metric; a metric split by the
  end-to-end metric it moves or by its bound, ``<quantity>.<split>``, is
  read by ``metrics/<quantity>.py`` unless it has a file of its own,
* ``reference/<family>.py`` and ``work/<family>.py``, one module a
  transform family, named by the configuration's ``family``.

A cell, configuration or metric is added by adding its files and its entry
in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

__all__ = ["HERE", "ROOT", "Cell", "cells", "cell", "module"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration, its traffic and
    the metrics it reports (``end_to_end``, ``per_layer``: the entries of
    ``BENCHMARK.json`` whose ``workloads``, if given, list the cell), and
    the checkout ``root`` it was read from."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def _reports(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def cells(root: Path = ROOT) -> dict:
    """Every cell of ``root/BENCHMARK.json``, resolved, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    configs = {c["name"]: c for c in bench["configs"]}
    out = {}
    for w in bench["workloads"]:
        name = w["name"]
        out[name] = Cell(
            name, w["chips"],
            json.loads((root / configs[w["config"]]["file"]).read_text()),
            json.loads((root / HERE.name / "workloads" / f"{name}.json")
                       .read_text()),
            [m for m in bench["end_to_end"] if _reports(m, name)],
            [m for m in bench["per_layer"] if _reports(m, name)], root)
    return out


def cell(name: str, root: Path = ROOT) -> Cell:
    found = cells(root)
    if name not in found:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json; cells: "
                         + ", ".join(sorted(found)))
    return found[name]


def module(kind: str, name: str, root: Path = ROOT):
    """``<root>/portbench/<kind>/<name>.py``, imported as a module of the
    package ``portbench.<kind>`` (a name may hold ``.`` and ``-``).  Where
    there is no such file, the name's last ``.<split>`` is dropped, as
    often as it takes to find one."""
    stem = name
    path = root / HERE.name / kind / f"{stem}.py"
    while not path.exists() and "." in stem:
        stem = stem.rsplit(".", 1)[0]
        path = root / HERE.name / kind / f"{stem}.py"
    modname = f"{HERE.name}.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', stem)}"
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod
