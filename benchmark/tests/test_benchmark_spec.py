"""``BENCHMARK.json`` against the benchmark's contract: its keys, the
characters of its names and units, its bounds and run length, and a file
for every part it names (configuration, traffic, limits, driver, metric
reader), each reader moving the end-to-end metric the spec says."""

import json
import os
import re

import pytest

from harness import cells

SPEC = cells.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _names():
    out = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    out += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    out += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    return out + [k for c in SPEC["configs"] for k in c["reduced"]]


@pytest.mark.parametrize("name", _names())
def test_names_use_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        reader = cells.metric_reader(metric["name"])
        assert reader.MOVES == metric["moves"]
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]


def test_top_level_and_budget():
    assert set(SPEC) == TOP_KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    seconds = SPEC["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    # a full check with the 24 cells later PRs may bring must fit
    cells_max = 24
    assert (2 + 14 * cells_max) * (seconds + 60) + cells_max * 2 * 90 + 1200 <= 43200
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_its_files_and_metrics(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    traffic = cells.part("traffic", cell["traffic"])
    assert os.path.exists(os.path.join(cells.BENCH_DIR, "drivers", traffic["driver"] + ".py"))
    assert cells.part("limits", cell["name"])["limits"]
    reported = {m["name"] for m in cells.end_to_end(SPEC, cell["name"])}
    assert "setup_s" in reported and len(reported) >= 2
    assert cells.per_layer(SPEC, cell["name"])


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    data = cells.part("configs", config["name"])
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert data["source"] == config["source"]
    assert data["precision"] in ("float32",)
    assert data["flops_per_meta_step"] > 0
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])
