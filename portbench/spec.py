"""``BENCHMARK.json`` and the files its names lead to.

Everything that belongs to one configuration, one traffic mix, one metric
or one cell is a file of its own, found by name:

* ``configs/<config>.json``: the deployment (effects and their
  parameters, channels, length, precision, source, reduced, assumed);
* ``traffic/<traffic>.json``: the traffic mix (the loop it runs, block
  size, signal, what is checked, what is traced);
* ``metrics/<metric>.py``: the reader of one metric, ``read(run)``;
* ``limits/<cell>.json``: each number the cell's correctness check
  compares, with its limit and the readings it was set from.

A new cell, configuration, traffic mix or metric is new files and new
entries in ``BENCHMARK.json``: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list
    here: str                 # the benchmark's directory in that checkout


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def config_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "configs", f"{name}.json")


def traffic_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "traffic", f"{name}.json")


def metric_path(name: str, here: str = HERE) -> str:
    return os.path.join(here, "metrics", f"{name}.py")


def limits_path(cell: str, here: str = HERE) -> str:
    return os.path.join(here, "limits", f"{cell}.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell, or those it lists."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of the checkout at ``root``: its entry in
    ``BENCHMARK.json`` and the files its names lead to under
    ``<root>/portbench``."""
    here = os.path.join(root, os.path.basename(HERE))
    bench = load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    return Cell(name=name, chips=int(w["chips"]),
                config=_json(config_path(w["config"], here)),
                traffic=_json(traffic_path(w["traffic"], here)),
                limits=_json(limits_path(name, here)),
                end_to_end=[m for m in bench["end_to_end"]
                            if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)],
                here=here)


_readers: dict = {}


def reader(name: str, here: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = metric_path(name, here)
    if path not in _readers:
        if not os.path.isfile(path):
            raise KeyError(f"no reader for metric {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            "_metric_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _readers[path] = mod.read
    return _readers[path]
