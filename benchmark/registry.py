"""Finds each piece of a cell by its name, so that a new cell,
configuration, traffic mix, load shape or metric is new files plus new
entries in ``BENCHMARK.json``, never an edit of a file that is there:

- the cell: its entry in ``BENCHMARK.json`` (configuration, traffic,
  chips) and the metrics whose ``workloads`` name it or that have none;
- a configuration: ``configs/<config>.json``;
- a traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the load
  shape ``loops/<kind>.py`` (a function ``drive``);
- the limits of its output check: ``limits/<cell>.json``;
- a metric: ``metrics/<name>.py``, a function ``read(run)`` that returns
  the value, or None where the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench_dir: str = HERE, spec_path: str = "") -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the root above
    ``bench_dir`` unless ``spec_path`` names it) with its pieces loaded."""
    spec = _json(spec_path or os.path.join(os.path.dirname(bench_dir), "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(os.path.join(os.path.dirname(bench_dir), configs[w["config"]]["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(bench_dir, "limits", name + ".json"))
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = HERE) -> Callable:
    path = os.path.join(bench_dir, "metrics", name + ".py")
    return _module(path, "benchmark_metric_" + name.replace(".", "_")).read


def load_shape(kind: str, bench_dir: str = HERE) -> Callable:
    path = os.path.join(bench_dir, "loops", kind + ".py")
    return _module(path, "benchmark_loop_" + kind).drive
