#!/usr/bin/env python
"""Prewarm service: build the planned program set ahead of time (the
repo's ``scripts/prewarm.py``, on this package).

Builds the program families strict mode plans (the train variants
``(train | train_multi, second_order, msl_active)`` plus ``eval`` and
``eval_multi``, and with ``--serving`` the serving (bucket x batch bucket)
grid) through the compile ledger, every build with ``phase="prewarm"``
(``compile/aot.py``): the multi-step programs captured as CUDA graphs, the
others dispatched once. The kernels' libraries are built into their build
directory first. With a run directory it verifies, then writes, the
prewarm manifest beside the checkpoints, so that a restarted run can tell
whether the kernels it needs are built for its environment. A graph is not
serializable: a new process captures its graphs again.

Usage::

    # a run directory's train programs (config.yaml beside saved_models/)
    python howtotrainyourmamlpytorch_tpu_torch/scripts/prewarm.py exps/<run>

    # the serving grid too, on the CPU
    python howtotrainyourmamlpytorch_tpu_torch/scripts/prewarm.py exps/<run> --serving --device cpu

    # no run directory: a config built from overrides alone
    python howtotrainyourmamlpytorch_tpu_torch/scripts/prewarm.py --no-train --serving num_classes_per_set=5

Runs on the CUDA card unless ``--device cpu``. Prints exactly ONE JSON line
on stdout; progress goes to stderr. Exit codes: 0 = prewarmed (per-program
failures are contained and counted in the line), 2 = a usage error (the
line carries it).
"""

import argparse
import contextlib
import json
import os
import sys
import time

# the repo root: this file runs by path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

RC_OK, RC_USAGE = 0, 2


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _usage(msg: str) -> int:
    print(json.dumps({"report": "prewarm", "ok": False, "error": msg}), flush=True)
    return RC_USAGE


def _slim(summary):
    return None if summary is None else {k: v for k, v in summary.items() if k != "by_program"}


def _mesh(cfg, device):
    """The runner's mesh for ``cfg`` on this machine (None on one device):
    the programs a run on a mesh uses are built for that placement."""
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import make_mesh, visible_devices

    devices = visible_devices(device)
    if not (cfg.parallel.shard_meta_batch and len(devices) > 1):
        return None
    try:
        mesh = make_mesh(cfg.parallel, devices)
        if (cfg.batch_size * cfg.samples_per_iter) % mesh.shape["dp"]:
            raise ValueError(f"meta-batch not divisible by dp={mesh.shape['dp']}")
        return mesh
    except ValueError as exc:
        _log(f"prewarm: meshless ({type(exc).__name__}: {exc})")
        return None


def _prewarm(args, cfg) -> dict:
    from howtotrainyourmamlpytorch_tpu_torch.compile import aot
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt
    from howtotrainyourmamlpytorch_tpu_torch.parallel.mesh import shard_train_state

    t0 = time.perf_counter()
    system = MAMLSystem(cfg, device=None if args.device == "cuda" else args.device)
    device = system.device
    if cfg.use_pallas_inner_update and device.type == "cuda":
        from howtotrainyourmamlpytorch_tpu_torch.ops import _kernels

        _kernels.build()
    state = system.init_train_state()
    mesh = _mesh(cfg, device)
    mesh_shape = [int(mesh.shape["dp"]), int(mesh.shape["mp"])] if mesh is not None else [1, 1]
    save_dir = os.path.join(args.run_dir, "saved_models") if args.run_dir else None
    if save_dir:
        expected_warm, reason = aot.verify_manifest(ckpt.load_prewarm_manifest(save_dir), mesh_shape, device=device)
        _log("prewarm: the manifest promises a warm start" if expected_warm
             else f"prewarm: cold start expected ({reason})")
    train_summary = serving_summary = None
    if not args.no_train:
        _log("prewarm: the train program family...")
        placed = shard_train_state(state, mesh) if mesh is not None else state
        train_summary = system.prewarm(placed, batch_sharding=mesh, chunk_sharding=mesh,
                                       max_workers=args.max_workers, on_program=lambda n: _log(f"prewarm:   {n}"))
    if args.serving:
        from howtotrainyourmamlpytorch_tpu_torch.serving.engine import AdaptationEngine

        _log("prewarm: the serving grid...")
        engine = AdaptationEngine(system, state)
        serving_summary = engine.prewarm(max_workers=args.max_workers, on_program=lambda n: _log(f"prewarm:   {n}"))
    manifest_path = None
    if save_dir and cfg.aot.executable_store:
        manifest_path = ckpt.save_prewarm_manifest(
            save_dir, aot.build_manifest(train_summary=train_summary, serving_summary=serving_summary,
                                         mesh_shape=mesh_shape, device=device))
    return {
        "report": "prewarm",
        "ok": True,
        "platform": device.type,
        "run_dir": args.run_dir,
        "seconds": round(time.perf_counter() - t0, 3),
        "train": _slim(train_summary),
        "serving": _slim(serving_summary),
        "cache_dir": aot.cache_state()["dir"],
        "manifest": manifest_path,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("run_dir", nargs="?", default=None,
                        help="experiment directory (config.yaml + saved_models); omit to prewarm a config built "
                             "from overrides alone")
    parser.add_argument("--serving", action="store_true", help="also prewarm the serving grid")
    parser.add_argument("--no-train", action="store_true", help="skip the train program family")
    parser.add_argument("--max-workers", type=int, default=None, help="kept for the JAX CLI's flags; ignored")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the programs are built (default: the CUDA card)")
    parser.add_argument("overrides", nargs="*", default=[], help="config overrides, key=value dotted paths")
    try:
        args = parser.parse_args(argv)
    except SystemExit as exc:
        if exc.code in (0, None):  # --help
            raise
        return _usage("bad arguments (see --help)")
    overrides = list(args.overrides)
    if args.run_dir and "=" in args.run_dir:
        # an overrides-only call: argparse gives the first key=value to run_dir
        overrides.insert(0, args.run_dir)
        args.run_dir = None
    if args.no_train and not args.serving:
        return _usage("nothing to do (--no-train without --serving)")
    if args.run_dir and not os.path.exists(os.path.join(args.run_dir, "config.yaml")):
        return _usage(f"no config.yaml under {args.run_dir}")
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    try:
        cfg = load_config(os.path.join(args.run_dir, "config.yaml") if args.run_dir else None, overrides)
    except (KeyError, TypeError, ValueError) as exc:
        return _usage(f"bad config: {type(exc).__name__}: {exc}")
    # the one-JSON-line stdout contract: everything else goes to stderr
    with contextlib.redirect_stdout(sys.stderr):
        report = _prewarm(args, cfg)
    print(json.dumps(report), flush=True)
    return RC_OK


if __name__ == "__main__":
    sys.exit(main())
