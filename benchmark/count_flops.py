#!/usr/bin/env python3
"""Write the benchmark's own FLOP counts into its configuration files.

    python3 benchmark/count_flops.py            # every configuration of BENCHMARK.json
    python3 benchmark/count_flops.py <config>   # one

For each configuration: ``flops_per_meta_step``, the reference's
meta-gradient at the configuration's shapes (``reference/costs.py``: on
``meta`` tensors, so nothing is computed and it runs on any CPU); and where
a cell serves it, ``flops_per_task``, one request's adaptation and
prediction for each query size of that cell's traffic. The counts depend on
shapes only; rerun the tool where a configuration's sizes change.
"""

import json
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def counts(spec, name: str) -> dict:
    from harness import cells
    from reference import costs

    config = cells.part("configs", name)
    cfg = config["maml"]
    out = {"flops_per_meta_step": costs.meta_step_flops(cfg)}
    support = int(cfg["num_classes_per_set"]) * int(cfg["num_samples_per_class"])
    steps = int(cfg["number_of_evaluation_steps_per_iter"])
    per_task = {}
    for cell in spec["workloads"]:
        traffic = cells.part("traffic", cell["traffic"])
        if cell["config"] == name and "query_sizes" in traffic:
            for q in traffic["query_sizes"]:
                per_task[str(q)] = costs.serve_task_flops(cfg, support, int(q), steps)
    if per_task:
        out["flops_per_task"] = dict(sorted(per_task.items(), key=lambda kv: int(kv[0])))
    return out


def main(argv=None) -> int:
    sys.path.insert(0, BENCH_DIR)
    from harness import cells

    spec = cells.benchmark_spec(ROOT)
    names = (argv if argv is not None else sys.argv[1:]) or [c["name"] for c in spec["configs"]]
    for name in names:
        path = os.path.join(BENCH_DIR, "configs", name + ".json")
        with open(path) as f:
            config = json.load(f)
        config.update(counts(spec, name))
        with open(path, "w") as f:
            json.dump(config, f, indent=2)
            f.write("\n")
        print(name, {k: v for k, v in config.items() if k.startswith("flops")})
    return 0


if __name__ == "__main__":
    sys.exit(main())
