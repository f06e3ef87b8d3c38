#!/usr/bin/env python3
"""One sweep of offered load for a serving cell, on the card, in one
process: the cell's set-up once, then its traffic at each rate for
``--seconds``, each rate reporting what it completed and whether its
backlog grew.

    python3 benchmark/knee_sweep.py --workload <serving cell> --rates 60,80,100 [--seconds 10] [--seed N]

The knee is the highest offered rate, of those swept upward, below the
first at which the backlog grows over the window: at the knee the requests
of the window's last fifth wait no longer than twice those of its first
fifth (medians), and the completed rate is within 2% of the offered one. A cell's traffic file then fixes its rate as
a number (the sweep is not part of a run).
"""

import argparse
import json
import os
import statistics
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=2147483900)
    args = parser.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    import torch

    import run as bench
    from harness import cells, runtime

    if not torch.cuda.is_available():
        print("knee_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    bench._paths()
    spec = cells.benchmark_spec(ROOT)
    cell = cells.workload(spec, args.workload)
    traffic = cells.part("traffic", cell["traffic"])
    driver = cells.driver(traffic["driver"])
    ns = bench.parse(["--workload", cell["name"], "--seed", str(args.seed), "--seconds", str(args.seconds)])
    run = bench.Run(ns, cell, cells.part("configs", cell["config"]), traffic, {}, torch.device("cuda"),
                    runtime.Spans(), bench.NoFaults(), None)
    with driver.deployment(run):
        knee = _sweep(args, run, driver, traffic)
    print(json.dumps({"knee": knee}))
    return 0


def _sweep(args, run, driver, traffic):
    from harness import runtime

    built = driver.setup(run)
    print(f"knee_sweep: card {runtime.power_limit()}", file=sys.stderr)
    knee, grown = None, False
    for stream, rate in enumerate(float(r) for r in args.rates.split(",")):
        times, sizes = driver.schedule({**traffic, "rate_per_s": rate}, args.seed, args.seconds)
        rows, _ = driver._drive(run, built["frontend"], run.config["maml"], 100 + stream, times, sizes)
        ok = [r for r in rows if r[0]]
        fifth = max(1, len(rows) // 5)
        first = statistics.median(r[1] for r in rows[:fifth])
        last = statistics.median(r[1] for r in rows[-fifth:])
        done = len(ok) / max(r[2] for r in ok) if ok else 0.0
        latencies = sorted(r[1] if r[0] else float("inf") for r in rows)
        steady = last <= 2.0 * first and done >= 0.98 * rate and len(ok) == len(rows)
        grown = grown or not steady
        knee = knee if grown else rate
        print(json.dumps({"rate": rate, "requests": len(rows), "failed": len(rows) - len(ok), "tasks_per_s": done,
                          "p50_ms": 1e3 * latencies[len(latencies) // 2],
                          "p95_ms": 1e3 * latencies[int(0.95 * (len(latencies) - 1))],
                          "first_fifth_p50_ms": 1e3 * first, "last_fifth_p50_ms": 1e3 * last, "steady": steady}),
              flush=True)
    built["frontend"].close()
    return knee


if __name__ == "__main__":
    sys.exit(main())
