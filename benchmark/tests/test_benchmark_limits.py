"""How a cell's limits are set (``set_limits.py``) and what its committed
limits files hold: the lower reading from every sound run, an upper one
only where the control or a fault reads far enough above it, the limit
between the two, and the diagnostics never compared."""

import json
import os

import pytest

import set_limits
from harness import cells

SPEC = cells.benchmark_spec()


def _row(arm, **values):
    return {"arm": arm, "seed": 1, "values": values}


def test_the_lower_reading_takes_every_sound_run():
    calibration = {"workload": "w", "rows": [_row("program", a=1.0, pass_loss_gap=0.0), _row("control", a=9.0)]}
    later = [_row("program", a=2.0)]
    out = set_limits.limits_from(calibration, later)
    assert out["readings"]["a"]["lower"] == 2.0 and out["readings"]["a"]["program_runs"] == 2
    # the control reads 4.5x the largest sound run: an upper reading; the limit lies between, nearer the upper
    limit = out["limits"]["a"]
    assert 2.0 * (9.0 / 2.0) ** 0.5 < limit < 9.0
    assert "pass_loss_gap" not in out["readings"] and out["caught"] == {"control": True}


def test_a_control_under_three_times_the_lower_sets_no_limit():
    calibration = {"workload": "w", "rows": [_row("program", a=1.0), _row("control", a=2.9),
                                             _row("half_batch", a=9.0)]}
    out = set_limits.limits_from(calibration)
    assert "a" not in out["limits"] and "upper" not in out["readings"]["a"]
    assert out["caught"] == {"control": False, "half_batch": False}


def test_runs_of_other_keys_are_read_but_never_judged():
    calibration = {"workload": "w", "rows": [_row("program", a=1.0), _row("control", a=5.0),
                                             _row("arm.remat_none", a=50.0)]}
    out = set_limits.limits_from(calibration)
    assert set(out["caught"]) == {"control"} and out["readings"]["a"]["lower"] == 1.0


def test_run_logs_give_their_readings_once(tmp_path):
    log = tmp_path / "run.err"
    log.write_text("benchmark: set-up 20.1 s\n"
                   "benchmark: reference 2.0 s over 48 requests; readings {'prob_gap': 0.05, 'x': 1e-3}\n"
                   'benchmark: readings {"prob_gap": 0.05, "x": 0.001}\n'
                   'benchmark: readings {"prob_gap": 0.07, "x": 0.002}\n')
    rows = set_limits.run_rows(str(log))
    assert sorted(r["values"]["prob_gap"] for r in rows) == [0.05, 0.07]


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_limit_lies_between_its_readings(cell):
    data = cells.part("limits", cell["name"])
    for name, limit in data["limits"].items():
        entry = data["readings"][name]
        assert entry["lower"] < limit < entry["upper"], name
        ratio = set_limits.CONTROL_RATIO if entry["upper_from"] == "control" else set_limits.FAULT_RATIOS.get(
            entry["upper_from"], set_limits.FAULT_RATIO)
        assert entry["upper"] >= ratio * entry["lower"], name
        assert not name.startswith(set_limits.DIAGNOSTICS)


def test_the_limits_files_are_the_tools_output():
    names = {w["name"] for w in SPEC["workloads"]}
    for file in os.listdir(os.path.join(cells.BENCH_DIR, "limits")):
        assert file.endswith(".json") and file[: -len(".json")] in names, file
        with open(os.path.join(cells.BENCH_DIR, "limits", file)) as f:
            assert set(json.load(f)) == {"card", "limits", "readings"}
