#!/usr/bin/env python
"""Fleet campaign CLI: drive a config x seed matrix unattended (the JAX
package's ``scripts/fleet_run.py``, training through this package).

Gang-schedules the matrix as training subprocesses (``python -m
howtotrainyourmamlpytorch_tpu_torch.train --device DEVICE``), applies the rc
policy straight from ``exit_codes.py`` (75/76 restart with exact resume, 3
diverged-move-on, 64/65 pause on the card gate ``wait_for_card.py``), kills
and relaunches runs whose logs go silent, and aggregates every run's
telemetry/events into one ``fleet_report.json`` via this package's
``obs_report.py``.

Usage::

    # a spec file (configs/fleet_*.yaml):
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.fleet_run \
        configs/fleet_accuracy_omniglot.yaml [--device cuda|cpu]

    # or inline jobs ("<name> <override...>"):
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.fleet_run \
        --job "omniglot.5.1 num_classes_per_set=5 num_samples_per_class=1" \
        --base dataset=omniglot --base inner_optim=gd --seeds 0

    # knobs:
    ... --stall-secs 420 --max-restarts 8 --deadline-epoch 1760000000
    ... --select 'omniglot\\.5\\..*'   # regex over cell names
    ... --dry-run                      # print the cell plan, run nothing

``--device`` (default: the spec's, the card) is where every cell trains;
``cpu`` skips the card gate, as ``JAX_PLATFORMS=cpu`` does for the JAX
fleet. Emits ONE JSON line (the fleet report summary) on stdout whatever
happens; progress goes to stderr and ``<exps-root>/fleet_events.jsonl``.
Exit 0 iff every cell completed or diverged-per-policy; 1 on failed/skipped
cells; 2 on usage errors.

Import-light: loads ``resilience/fleet.py`` (itself torch-free) by file
path, so the scheduler never initializes the card the children use. It
also runs by path (``python howtotrainyourmamlpytorch_tpu_torch/scripts/
fleet_run.py``), which skips the package import altogether.
"""

import argparse
import importlib.util
import json
import os
import re
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_by_path(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


fleet = _load_by_path("htymp_torch_fleet", os.path.join(_PKG, "resilience", "fleet.py"))
exit_codes = fleet.exit_codes


def build_spec(args) -> "fleet.FleetSpec":
    if args.spec:
        spec = fleet.load_spec(args.spec)
    elif args.job:
        configs = []
        for job in args.job:
            parts = job.split()
            if not parts:
                raise ValueError("--job needs '<name> <override...>'")
            configs.append({"name": parts[0], "overrides": parts[1:]})
        spec = fleet.FleetSpec(
            name=args.name or "fleet", configs=configs,
            seeds=[int(s) for s in args.seeds.split(",")] if args.seeds else [0],
            base_overrides=list(args.base or []),
        )
    else:
        raise ValueError("need a spec file or at least one --job")
    # CLI knobs override the spec file (env-driven rounds tune without edits)
    if args.exps_root:
        spec.experiment_root = args.exps_root
    if args.stall_secs is not None:
        spec.stall_deadline_s = args.stall_secs
    if args.max_restarts is not None:
        spec.max_restarts = args.max_restarts
        spec.restart_budget = 3 * args.max_restarts
    if args.deadline_epoch:
        spec.deadline_epoch = args.deadline_epoch
    if args.no_gate:
        spec.tpu_gate = False
    if args.device:
        spec.device = args.device
    if args.select:
        pattern = re.compile(args.select)
        spec.configs = [c for c in spec.configs if pattern.search(c["name"])]
        if not spec.configs:
            raise ValueError(f"--select {args.select!r} matches no config")
    return spec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument("spec", nargs="?", help="fleet spec YAML (configs/fleet_*.yaml)")
    parser.add_argument("--job", action="append",
                        help="inline cell: '<name> <override...>' (repeatable)")
    parser.add_argument("--base", action="append",
                        help="override applied to every cell (repeatable)")
    parser.add_argument("--seeds", help="comma-separated seed list (inline jobs)")
    parser.add_argument("--name", help="fleet name for inline jobs")
    parser.add_argument("--exps-root", help="experiment root (default: spec's, or exps)")
    parser.add_argument("--stall-secs", type=float, default=None,
                        help="silent-log kill deadline (default: spec's 420)")
    parser.add_argument("--max-restarts", type=int, default=None)
    parser.add_argument("--deadline-epoch", type=float, default=0.0,
                        help="epoch seconds after which no new cell starts")
    parser.add_argument("--select", help="regex filter over config names")
    parser.add_argument("--no-gate", action="store_true",
                        help="skip the card gate before each launch (--device cpu skips it automatically)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where every cell trains (default: the spec's, the CUDA card)")
    parser.add_argument("--dry-run", action="store_true",
                        help="print the cell plan as JSON and exit")
    args = parser.parse_args(argv)
    try:
        spec = build_spec(args)
    except (ValueError, OSError, KeyError) as exc:
        print(f"fleet_run: {exc}", file=sys.stderr)
        return exit_codes.USAGE
    if args.dry_run:
        print(json.dumps(
            {"report": "fleet_plan", "spec": spec.name,
             "cells": [c.as_dict() for c in spec.cells()]}
        ))
        return exit_codes.OK
    scheduler = fleet.FleetScheduler(spec)
    report = scheduler.run()
    slim = {k: v for k, v in report.items() if k != "cells"}
    slim["cells"] = len(report["cells"])
    print(json.dumps(slim))
    return exit_codes.OK if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
