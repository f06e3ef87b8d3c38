"""Finding a cell's parts by name.

``BENCHMARK.json`` (at the root of the checkout) names every cell with its
configuration and traffic mix. Each part lives in a file of its own under
``benchmark/``, found by its name:

- ``configs/<config>.json``: the model configuration, its published source
  and sizes, the MAML++ keys the program is run with (``maml``);
- ``traffic/<traffic>.json``: the traffic mix's parameters and the
  ``driver`` that generates it (``drivers/<driver>.py``);
- ``limits/<cell>.json``: the limit of every number the cell compares with
  the reference, with the readings it was set from;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

A later cell, configuration, traffic mix or metric is one more file (and
one more entry of ``BENCHMARK.json``); no file here changes.
"""

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(spec: Dict[str, Any], name: str) -> Dict[str, Any]:
    for entry in spec["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in spec['workloads']]})")


def part(kind: str, name: str, bench_dir: str = BENCH_DIR) -> Dict[str, Any]:
    """``configs``, ``traffic`` or ``limits`` file of ``name``."""
    return load_json(os.path.join(bench_dir, kind, name + ".json"))


def load_module(path: str, name: str) -> ModuleType:
    """A module loaded from its file (metric names hold dots, so they are
    no import paths)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return load_module(os.path.join(bench_dir, "drivers", name + ".py"), f"bench_driver_{name}")


def metric_reader(name: str, bench_dir: str = BENCH_DIR) -> ModuleType:
    return load_module(os.path.join(bench_dir, "metrics", name + ".py"), "bench_metric_" + name.replace(".", "_"))


def _applies(metric: Dict[str, Any], cell: str, reported: List[str]) -> bool:
    """A metric with ``workloads`` is the listed cells'; one without is
    every cell's that reports the end-to-end metric it moves (an end-to-end
    metric without ``moves``: every cell's)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def end_to_end(spec: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    return [m for m in spec["end_to_end"] if _applies(m, cell, [])]


def per_layer(spec: Dict[str, Any], cell: str) -> List[Dict[str, Any]]:
    reported = [m["name"] for m in end_to_end(spec, cell)]
    return [m for m in spec["per_layer"] if _applies(m, cell, reported)]
