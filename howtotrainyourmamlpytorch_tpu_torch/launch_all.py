#!/usr/bin/env python
"""Ablation-grid sweep launcher (the repository's ``launch_all.py``, on
this package): the cartesian product of (dataset x n_way/k_shot x
backbone x inner optimizer x seed) from the reference's published sweep
(BASELINE.md), 324 jobs, each a run of this package's training CLI, run
one after another on this host or printed as a command list for a
scheduler.

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.launch_all --dry-run      # print the grid
    python -m howtotrainyourmamlpytorch_tpu_torch.launch_all --select 0 2 5 # run these jobs
    python -m howtotrainyourmamlpytorch_tpu_torch.launch_all [KEY=VALUE ...] [--device cuda|cpu]

Every job runs ``python -m howtotrainyourmamlpytorch_tpu_torch.train
--device DEVICE`` (the card unless ``--device cpu``) with its overrides,
then the ``key=value`` overrides given here (accepted anywhere on the
command line), which win. ``--in-process`` runs each job's CLI in this
process (``train.main``) instead of a child process.
"""

import argparse
import itertools
import subprocess
import sys

GRID = {
    "episode": [  # (dataset_preset, n_way, k_shot)
        ("omniglot", 5, 1),
        ("omniglot", 5, 5),
        ("omniglot", 20, 1),
        ("omniglot", 20, 5),
        ("imagenet", 5, 1),
        ("imagenet", 5, 5),
    ],
    "net": ["vgg", "resnet-4", "resnet-8", "resnet-12", "densenet-8", "densenet-12"],
    "inner_optim": ["gd", "adam", "rprop"],
    "seed": [0, 1, 2],
}


def jobs():
    for (ds, n_way, k_shot), net, opt, seed in itertools.product(
        GRID["episode"], GRID["net"], GRID["inner_optim"], GRID["seed"]
    ):
        name = f"{ds}.{n_way}.{k_shot}.{net}.{opt}.{seed}"
        overrides = [
            f"dataset={ds}",
            f"num_classes_per_set={n_way}",
            f"num_samples_per_class={k_shot}",
            f"net={net}",
            f"inner_optim={opt}",
            f"seed={seed}",
            f"train_seed={seed}",
            f"val_seed={seed}",
            f"experiment_name={name}",
        ]
        yield name, overrides


def command(overrides, device: str = "cuda"):
    return [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.train", "--device", device, *overrides]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--select", nargs="+", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--in-process", action="store_true", help="run each job's CLI in this process")
    # key=value overrides for every job are split off before argparse, so
    # that --select's list of ints cannot swallow them
    if argv is None:
        argv = sys.argv[1:]
    extra = [a for a in argv if "=" in a and not a.startswith("-")]
    args = parser.parse_args([a for a in argv if a not in extra])

    all_jobs = list(jobs())
    selected = [all_jobs[i] for i in args.select] if args.select is not None else all_jobs
    for i, (name, overrides) in enumerate(selected):
        cmd = command(overrides + extra, args.device)
        print(f"[{i + 1}/{len(selected)}] {name}: {' '.join(cmd)}", flush=True)
        if args.dry_run:
            continue
        if args.in_process:
            from howtotrainyourmamlpytorch_tpu_torch import train

            rc = train.main(cmd[3:])
            if rc:
                raise RuntimeError(f"job {name} exited {rc}")
        else:
            subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
