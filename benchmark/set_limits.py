#!/usr/bin/env python3
"""Set a cell's limits from its calibration (``calibrate.py --out``) by the
benchmark's rules, and write ``limits/<cell>.json`` with the readings each
limit was set from.

    python3 benchmark/set_limits.py <calibration.json> [--runs LOG ...] [--write]

``--runs`` adds the readings of sound runs of the cell (``run.py``'s
standard error, its ``benchmark: readings`` lines) to the calibration's.
For every number the calibration read:

- the lower reading is the largest that the program's sound runs gave,
  the calibration's and every other run's;
- the upper reading is the smallest the control gave, where that is at
  least three times the lower, or the smallest reading of a fault that is
  at least ten times the lower (a state left unchanged: three times), the
  least of these (a serving cell's single altered answer is caught by its
  worst request's gap, which float32's own scatter keeps from the
  control's reach);
- a number with an upper reading is compared, at the limit
  ``lower**0.4 * upper**0.6``: more of the room above the lower, where
  fresh seeds reach, than under the upper; a number without is not.

The cell is sound only where the control and every fault fail one of its
compared numbers on every seed read; the tool says which arm fails none.
"""

import argparse
import ast
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CONTROL_RATIO = 3.0
FAULT_RATIO = 10.0
#: faults whose reading is the number's whole scale (a state left unchanged reads 1)
FAULT_RATIOS = {"state_unchanged": 3.0}
#: where the limit lies between the lower and the upper reading, in logs
ABOVE = 0.6
DIAGNOSTICS = ("pass_", "repeat_", "f32ref.")
READINGS = "benchmark: readings "


def run_rows(path: str):
    """The readings of the sound runs in a run's standard error (also the
    serving driver's own line, ``...; readings {...}``)."""
    rows = []
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith(READINGS):
                values = json.loads(line[len(READINGS):])
            elif line.startswith("benchmark: reference ") and "; readings {" in line:
                values = ast.literal_eval(line.split("; readings ", 1)[1].strip())
            else:
                continue
            rows.append({"arm": "program", "seed": None, "values": values, "from": path})
    # a run prints both lines for the same readings
    return [dict(r) for r in {json.dumps(r["values"], sort_keys=True): r for r in rows}.values()]


def limits_from(calibration: dict, extra_rows=()):
    rows = [r for r in list(calibration["rows"]) + list(extra_rows) if not r.get("error")]
    rows = [r for r in rows if not r["arm"].startswith("arm.")]
    names = sorted({k for r in rows if r["arm"] == "program" for k in r["values"] if not k.startswith(DIAGNOSTICS)})
    arms = sorted({r["arm"] for r in rows} - {"program"})
    limits, readings = {}, {}
    for name in names:
        lower = max(r["values"][name] for r in rows if r["arm"] == "program" and name in r["values"])
        uppers = {}
        for arm in arms:
            values = [r["values"][name] for r in rows if r["arm"] == arm]
            if not values:
                continue
            ratio = CONTROL_RATIO if arm == "control" else FAULT_RATIOS.get(arm, FAULT_RATIO)
            if min(values) >= ratio * lower:
                uppers[arm] = min(values)
        entry = {"lower": lower, "program_runs": sum(r["arm"] == "program" and name in r["values"] for r in rows)}
        if uppers:
            arm = min(uppers, key=uppers.get)
            entry.update(upper=uppers[arm], upper_from=arm)
            limits[name] = lower ** (1.0 - ABOVE) * uppers[arm] ** ABOVE
            entry["limit"] = limits[name]
        readings[name] = entry
    caught = {}
    for arm in arms:
        seeds = [r for r in rows if r["arm"] == arm]
        caught[arm] = bool(seeds) and all(any(r["values"][n] > limits[n] for n in limits) for r in seeds)
    failed = [r for r in calibration["rows"] if r.get("error")]
    return {"limits": limits, "readings": readings, "caught": caught,
            "errored_runs": [(r["arm"], r["seed"], r["error"]) for r in failed]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("calibration")
    parser.add_argument("--runs", nargs="*", default=[])
    parser.add_argument("--write", action="store_true")
    args = parser.parse_args(argv)
    with open(args.calibration) as f:
        calibration = json.load(f)
    out = limits_from(calibration, [row for path in args.runs for row in run_rows(path)])
    sound = bool(out["limits"]) and all(out["caught"].values()) and not out["errored_runs"]
    print(json.dumps({"workload": calibration["workload"], "sound": sound, **out}, indent=1))
    if args.write and sound:
        with open(os.path.join(BENCH_DIR, "limits", calibration["workload"] + ".json"), "w") as f:
            json.dump({"card": calibration.get("card"), "limits": out["limits"], "readings": out["readings"]}, f,
                      indent=1)
            f.write("\n")
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
