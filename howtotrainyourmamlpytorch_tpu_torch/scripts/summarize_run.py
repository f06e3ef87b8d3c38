#!/usr/bin/env python
"""Print the measured cells of a RESULTS.md accuracy-table row for finished
run directories (the JAX package's ``scripts/summarize_run.py``, over this
package's ``analysis.load_run``).

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.summarize_run RUN_DIR [RUN_DIR ...]

Wall-clock is end-to-end from the ``logs/events.jsonl`` timestamps (train
and validation), extrapolated by one epoch for epoch 0 (the first event is
stamped at the end of epoch 0). The Reference and delta columns come from
BASELINE.md by hand; placeholders keep the row aligned with the 5-column
table. Reads files only: no device.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from howtotrainyourmamlpytorch_tpu_torch.analysis import load_run  # noqa: E402


def row(run_dir: str) -> str:
    rec = load_run(run_dir)
    if rec is None or not rec.test:
        return f"| {run_dir} | (no test_summary.csv — unfinished?) | | | |"
    test = rec.test[-1]
    acc = 100 * test["test_accuracy_mean"]
    ci = 100 * test["test_accuracy_ci95"]
    n = int(test["test_num_episodes"])
    wall = "?"
    try:
        with open(os.path.join(run_dir, "logs", "events.jsonl")) as f:
            ts = [json.loads(line)["ts"] for line in f if line.strip()]
        if len(ts) > 1:
            mins = (ts[-1] - ts[0]) / 60 * len(ts) / (len(ts) - 1)
            wall = f"≈{mins:.0f} min"
    except (OSError, ValueError, KeyError):
        pass
    name = run_dir.rstrip("/").split("/")[-1]
    return f"| {name} | (ref: BASELINE.md) | {acc:.2f} ± {ci:.2f} % (n={n}) | Δ | {wall} |"


def main(argv=None) -> int:
    for d in sys.argv[1:] if argv is None else argv:
        print(row(d), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
