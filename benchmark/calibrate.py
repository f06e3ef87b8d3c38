#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process: the numbers the cell compares, for sound runs of the program on
many seeds (the lower reading), for the control (the program at the next
precision below the configuration's: TF32 for IEEE float32, its
``matmul_precision: high``) and for each fault the cell can have
(``harness/faults.py``) on a few seeds (the upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --fault-seeds 7,8,9 [--seconds 4] [--out FILE] \\
        [--arm NAME:JSON ...] [--arm-seeds ...] [--f32ref] [--repeat-seeds ...]

Training cells run their set-up (the compared dispatches through the
window's call) and the comparison, no window, on ``--repeat-seeds`` with a
second pass over the compared rows against the first (``repeat_*``) and,
with ``--f32ref``, the
reference itself in float32 against its own precision (``f32ref.*``); serving cells
a short window of ``--seconds`` at the cell's own load. ``--arm`` adds a
run of the program with other keys (``JSON``) on the control seeds, read
but not judged (a training cell's ``step_peak_bytes`` under another remat
policy, say). One JSON line per run on standard output, and all of them in
``--out``.
"""

import argparse
import gc
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
CONTROL = {"matmul_precision": "high"}


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--out", default="")
    parser.add_argument("--arm", action="append", default=[])
    parser.add_argument("--arm-seeds", default="")
    parser.add_argument("--f32ref", action="store_true")
    parser.add_argument("--repeat-seeds", default="")
    args = parser.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    import torch

    import run as bench
    from harness import cells, faults, runtime

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench._paths()
    spec = cells.benchmark_spec(ROOT)
    cell = cells.workload(spec, args.workload)
    config = cells.part("configs", cell["config"])
    traffic = cells.part("traffic", cell["traffic"])
    driver = cells.driver(traffic["driver"])
    kinds = faults.for_cell(traffic, config)
    plan = [("program", s, None, None) for s in _seeds(args.seeds)]
    plan += [("control", s, None, CONTROL) for s in _seeds(args.control_seeds)]
    plan += [(name, s, kind, None) for name, kind in kinds.items() for s in _seeds(args.fault_seeds)]
    for arm in args.arm:
        name, keys = arm.split(":", 1)
        plan += [("arm." + name, s, None, json.loads(keys)) for s in _seeds(args.arm_seeds or args.control_seeds)]
    limits = {}  # every number is read (``run.readings``); none is judged here
    rows = []
    for arm, seed, kind, overrides in plan:
        ns = bench.parse(["--workload", cell["name"], "--seed", str(seed), "--seconds", str(args.seconds)])
        run = bench.Run(ns, cell, config, traffic, limits, torch.device("cuda"), runtime.Spans(),
                        kind() if kind else bench.NoFaults(), overrides)
        run.diagnose, run.f32ref = seed in _seeds(args.repeat_seeds), args.f32ref
        t0 = time.perf_counter()
        try:
            if "query_sizes" in traffic:
                result = driver.run(run)
                extra = {"failed": result["failed"], "metrics": result["metrics"]}
            else:
                built = driver.setup(run)
                extra = {"step_peak_bytes": built.get("step_peak_bytes")}
                driver.check(run, built)
            values = run.readings
        except Exception as exc:  # noqa: BLE001 — a run that crashes has failed, and the next one runs
            values, extra = {}, {"error": f"{type(exc).__name__}: {exc}"}
        row = {"arm": arm, "seed": seed, "values": values, "seconds": round(time.perf_counter() - t0, 1), **extra}
        rows.append(row)
        print(json.dumps(row), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": cell["name"], "card": runtime.power_limit(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
