#!/usr/bin/env python
"""What the serving prewarm's build order costs in graph-pool bytes: one
engine per arm at one config (seeded random weights, the fused update,
remat off), its whole planned grid prewarmed, the arms in turn.

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.serving_pool_probe \\
        [--config configs/default.yaml] [--override serving.refine_enabled=true ...] \\
        [--arms jax largest_first largest_first jax] [--device cuda|cpu] [--json PATH]

Arms: ``largest_first``, the engine's own order (the largest flush, support
or query bucket x task batch, first), and ``jax``, the JAX package's order
(the planned keys sorted). Each engine has a graph pool of its own. Prints
one JSON line: per arm the pool's bytes after the prewarm and after each
capture (``costs.pool_bytes``; None off a card), the prewarm's seconds and
its errors.
"""

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

ARMS = ("largest_first", "jax")
DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                              "configs", "default.yaml")


def _key(name: str):
    """``serve_adapt/100/8`` -> ``("adapt", 100, 8)``, the planned key."""
    kind, bucket, b = name[len("serve_"):].split("/")
    return kind, int(bucket), int(b)


def prewarm_arm(system, state, serving, arm: str):
    """One engine prewarmed in ``arm``'s order -> its row."""
    from howtotrainyourmamlpytorch_tpu_torch.observability.compile_ledger import CompileLedger
    from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

    engine = AdaptationEngine(system, state, serving_cfg=serving)
    ledger, entries = CompileLedger(), []
    ledger.on_entry = entries.append
    engine.compile_ledger = ledger
    if arm == "jax":
        jobs = engine._prewarm_jobs
        engine._prewarm_jobs = lambda shape: sorted(jobs(shape), key=lambda job: repr(_key(job[0])))
    summary = engine.prewarm()
    after_each = [(e.get("memory") or {}).get("peak_bytes") for e in entries]
    return {"arm": arm, "programs": summary["programs"], "errors": summary["errors"],
            "prewarm_s": summary["seconds"], "pool_bytes": summary["pool_bytes"],
            "static_bytes": summary["static_bytes"], "first": entries[0]["program"] if entries else None,
            "pool_bytes_after_each": after_each}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--override", nargs="*", default=[], help="key=value config overrides")
    parser.add_argument("--arms", nargs="+", default=["jax", "largest_first", "largest_first", "jax"],
                        choices=ARMS)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--json", default=None, help="also write the line to this file")
    args = parser.parse_args(argv)

    from howtotrainyourmamlpytorch_tpu_torch.config import load_config
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem

    cfg = load_config(args.config, ["use_pallas_inner_update=true", "remat_inner_steps=false", *args.override])
    system = MAMLSystem(cfg, device=None if args.device == "cuda" else args.device)
    state = system.init_train_state(args.seed)
    serving = dataclasses.replace(cfg.serving)
    rows = []
    for arm in args.arms:
        rows.append(prewarm_arm(system, state, serving, arm))
        if system.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
    device = torch.cuda.get_device_name(0) if system.device.type == "cuda" else "cpu"
    line = json.dumps({"arms": rows, "device": device, "config": args.config, "overrides": args.override})
    print(line)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return 0 if all(row["errors"] == 0 for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
