#!/usr/bin/env python3
"""Run one cell of the benchmark of ``howtotrainyourmamlpytorch_tpu_torch``
once, on the CUDA card of this machine, and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its configuration, traffic mix,
limits and per-layer metrics are files under ``benchmark/`` found by name
(``harness/cells.py``). ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` its per-layer metrics, with the device's busy and
traced seconds and a breakdown of the traced sub-window. Every run checks
what its timed path produced against the plain reference
(``reference/``); the numbers compared and their limits are the last lines
of standard error and the ``checks`` key, last in the line.

Exit codes: 0 with a result line; 2 without a card (or too few) or on a
usage error; 3 where the run passed its deadline; 4 where a JAX module was
loaded. No result line is printed unless the code is 0.
"""

import argparse
import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
#: build and kernel caches: fixed directories inside the checkout
CACHE_DIR = os.path.join(ROOT, ".bench_cache")
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "nv"}
#: a run's whole time on the card; the driver allows 360 s
DEADLINE_S = 345.0


class NoFaults:
    """The timed path as it is (tests pass an object that breaks it)."""

    def apply(self, target) -> None:
        return None


class Run:
    """What a driver needs of one run."""

    def __init__(self, args, cell, config, traffic, limits, device, spans, faults, program_overrides):
        self.seed, self.seconds, self.trace = args.seed, float(args.seconds), bool(args.trace)
        self.cell, self.config, self.traffic, self.limits = cell, config, traffic, limits
        self.device, self.spans, self.faults = device, spans, faults
        self.program_overrides = dict(program_overrides or {})
        #: every number the driver's comparison read (set by its check)
        self.readings = {}


def parse(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def _paths() -> None:
    for path in (ROOT, BENCH_DIR):
        if path not in sys.path:
            sys.path.insert(0, path)
    for var, sub in CACHE_VARS.items():
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def execute(argv=None, device=None, faults=None, program_overrides=None, root=ROOT):
    """One run -> ``(exit code, result or None)``. ``device`` other than None
    skips the look for a card (the CPU tests); ``faults`` breaks the timed
    path underneath; ``program_overrides`` sets program keys (the control's
    lower precision); ``root`` is where ``BENCHMARK.json`` and the cell's
    data files (``benchmark/configs``, ``traffic``, ``limits``) are."""
    _paths()
    args = parse(argv)
    import torch

    from harness import cells, compare, runtime

    bench_dir = os.path.join(root, "benchmark")
    spec = cells.benchmark_spec(root)
    cell = cells.workload(spec, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible", file=sys.stderr)
            return 2, None
        device = "cuda"
        deadline = runtime.Deadline(DEADLINE_S)
        print(f"benchmark: card {runtime.power_limit()}", file=sys.stderr, flush=True)
    else:
        deadline = None
    device = torch.device(device)
    config = cells.part("configs", cell["config"], bench_dir)
    traffic = cells.part("traffic", cell["traffic"], bench_dir)
    limits = cells.part("limits", cell["name"], bench_dir)["limits"]
    run = Run(args, cell, config, traffic, limits, device, runtime.Spans(), faults or NoFaults(), program_overrides)
    result = cells.driver(traffic["driver"], BENCH_DIR).run(run)

    record = result["record"]
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    record["card"] = kind
    if run.trace:
        wanted = cells.per_layer(spec, cell["name"])
        values = {}
        for metric in wanted:
            value = cells.metric_reader(metric["name"], BENCH_DIR).read(record, run)
            if value is not None:
                values[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        wanted = cells.end_to_end(spec, cell["name"])
        values = {m["name"]: {"value": result["metrics"][m["name"]], "unit": m["unit"]} for m in wanted}
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": kind,
            "count": 1, "memory_peak_bytes": record.get("memory_peak_bytes", 0)}
    line = {"correct": bool(result["correct"]), "attempted": int(result["attempted"]),
            "failed": int(result["failed"]), "metrics": values, "device": info}
    if run.trace and record.get("trace") is not None:
        traced = record["trace"]
        info["busy_s"], info["window_s"] = traced.busy_s, traced.window_s
        line["breakdown"] = traced.breakdown()
    loaded = runtime.forbidden_modules()
    if deadline is not None:
        deadline.cancel()
    if loaded:
        print(f"benchmark: the run loaded {loaded}; no result", file=sys.stderr)
        return 4, None
    print(f"benchmark: readings {json.dumps(run.readings, sort_keys=True)}", file=sys.stderr)
    checks = result["checks"]
    for name, check in checks.items():
        verdict = "ok" if compare.passed({name: check}) else "FAILED"
        print(f"check {name} {check['value']!r} limit {check['limit']!r} {verdict}", file=sys.stderr)
    line["checks"] = checks
    return 0, line


def main(argv=None) -> int:
    code, line = execute(argv)
    if line is not None:
        sys.stdout.flush()
        print(json.dumps(line), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
