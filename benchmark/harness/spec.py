"""The cell a run measures, as ``BENCHMARK.json`` and the data files name it.

A cell names a configuration and a traffic mix; each is a JSON file found by
its name (``configs/<config>.json``, ``traffic/<traffic>.json``), and the
limits its outputs are held to are ``limits/<cell>.json``.  Code is found by
name too: a traffic mix's ``kind`` is ``kinds/<kind>.py`` (its class
``Run``), a configuration's scene ``kind`` is ``scenes/<kind>.py`` and a
per-layer metric is ``metrics/<metric>.py``.  Adding a cell, a mix, a
configuration, a kind of traffic or scene, or a metric adds files and
entries; no file that is there changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]     # the benchmark's folder
ROOT = HERE.parent                             # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def module(folder: str, name: str) -> ModuleType:
    """The module of file ``<folder>/<name>.py`` under the benchmark's folder
    (a name may hold dots, as ``metrics/adam_us.train.py`` does)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {folder}/{name}.py in the benchmark")
    key = f"bench_{folder}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``bench_file`` with its files read."""
    bench = _read(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are {sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if ("workloads" not in m or name in m["workloads"])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, config=_read(HERE / "configs" / f"{w['config']}.json"),
                traffic=_read(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_read(HERE / "limits" / f"{name}.json"), chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)
