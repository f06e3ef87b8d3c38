#!/usr/bin/env python
"""Seeded chaos-soak campaign over the resilience layer (the JAX package's
``scripts/chaos_soak.py``, on this package).

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.chaos_soak \\
        --episodes 17 --seed 0 [--work-dir DIR] [--no-subprocess] \\
        [--sanitize] [--device cuda|cpu]

Samples fault injections across every registered seam (checkpoint
read/write, loader episode assembly, runner step dispatch, serving dispatch
and refine, HTTP handler; ``resilience/faults.py``), runs a short train /
resume / shrink / grow / serve / cross-process gateway episode under each on
``--device`` (the CUDA card by default), and checks the cross-cutting
invariants after every one (documented rc, loadable latest-or-fallback
checkpoint, well-formed events.jsonl, serving never 200s a failure).
Deterministic in ``--seed``. ``--sanitize`` arms the lock-discipline
sanitizer (``tools/graftsan``) for every episode.

Prints exactly ONE JSON verdict line on stdout; progress goes to stderr.
Exit 0 iff every invariant held.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile

# the repo root, for ``tools/graftsan`` when run by path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from howtotrainyourmamlpytorch_tpu_torch.resilience.campaign import run_campaign  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--episodes", type=int, default=17)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--work-dir", default="", help="campaign scratch dir (default: a fresh temp dir)")
    parser.add_argument(
        "--no-subprocess",
        action="store_true",
        help="skip fresh-interpreter episodes (rc=76 wedge, device-shrink) — faster, less coverage",
    )
    parser.add_argument(
        "--sanitize",
        action="store_true",
        help="arm the graftsan lock-discipline sanitizer (tools/graftsan) for every episode; lock-order "
        "cycles, blocking-under-lock, and thread leaks become campaign violations",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where every episode runs (default: the CUDA card)")
    args = parser.parse_args(argv)
    work_dir = args.work_dir or tempfile.mkdtemp(prefix="chaos_soak_")
    # in-process episodes print training progress; the one-JSON-line stdout
    # contract sends all of that to stderr
    with contextlib.redirect_stdout(sys.stderr):
        verdict = run_campaign(
            work_dir,
            episodes=args.episodes,
            seed=args.seed,
            include_subprocess=not args.no_subprocess,
            sanitize=args.sanitize,
            device=args.device,
        )
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
