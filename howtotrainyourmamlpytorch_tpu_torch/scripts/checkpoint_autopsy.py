#!/usr/bin/env python
"""Autopsy of a run's saved checkpoints (the JAX package's
``scripts/checkpoint_autopsy.py``, on this package): does a state that
failed on the card fail on the CPU too?

For each checkpoint of ``RUN_DIR/saved_models`` (default: every epoch and
``best``; formats 1-3, as ``experiment/checkpoint.py`` reads them) it prints
per-tensor statistics (norm, largest magnitude, mean) of the parameters,
the BN state, the learned inner learning rates (LSLR) and the outer Adam
moments, in the JAX package's layout and key paths, then adapts and
evaluates the checkpoint on the same validation batches on ``--device``
and, with ``--compare-cpu``, on the CPU as well. If the CPU also scores
near chance the state itself is destroyed; if the CPU scores well from
the same state, the card's execution of the adaptation is at fault.

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.checkpoint_autopsy \\
        RUN_DIR [EPOCH ...] [--data-root DIR] [--index-cache-dir DIR] \\
        [--eval-batches 3] [--compare-cpu [EPOCH ...]] [--device cuda|cpu] [--json PATH]

The config is the run's ``config.yaml``; ``--data-root`` is joined before
its dataset path and ``--index-cache-dir`` replaces its index cache (the
JAX script's hard-coded data root and index cache).
``--eval-batches`` replaces the JAX script's ``AUTOPSY_EVAL_BATCHES``
variable. The JAX script's switch to its rolled, rematerialized program
family has no counterpart: the port runs one program, the run's own.
Images are read from disk (``load_into_memory`` off), as the JAX script
reads them.
"""

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from howtotrainyourmamlpytorch_tpu_torch.scripts.grad_precision_probe import keystr  # noqa: E402


def tensor_stats(tree) -> List[dict]:
    """One row per leaf of a tree of JAX-layout arrays: key path, shape,
    norm, largest magnitude and mean, in float64 (the JAX script's)."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten

    rows = []
    leaves, paths = tree_flatten(tree)
    for path, leaf in zip(paths, leaves):
        a = np.asarray(leaf, np.float64)
        rows.append({"name": keystr(path), "shape": tuple(a.shape), "norm": float(np.linalg.norm(a)),
                     "max_abs": float(np.abs(a).max()), "mean": float(a.mean())})
    return rows


def format_stats(rows: List[dict], label: str) -> List[str]:
    """The JAX script's printed table."""
    return [f"  {label}:"] + [
        f"    {r['name']:55s} shape={str(r['shape']):18s} "
        f"|x|={r['norm']:10.3e} max|x|={r['max_abs']:10.3e} "
        f"mean={r['mean']:+9.3e}"
        for r in rows
    ]


def state_tables(state, feature_shape) -> Dict[str, List[dict]]:
    """The statistics of a port ``TrainState`` in the JAX layout: params,
    BN state, inner hyperparameters (LSLR) and the outer Adam moments."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.interop import opt_state_to_jax, params_to_jax

    tables = {
        "params": tensor_stats(params_to_jax(state.params, feature_shape)),
        "bn_state": tensor_stats(params_to_jax(state.bn_state, feature_shape)),
    }
    if state.inner_hparams:
        tables["inner_hparams (learned lrs)"] = tensor_stats(params_to_jax(state.inner_hparams, feature_shape))
    if state.opt_state is not None:
        adam = opt_state_to_jax(state.opt_state, feature_shape)[0]
        tables["outer adam mu"] = tensor_stats(adam.mu)
        tables["outer adam nu"] = tensor_stats(adam.nu)
    return tables


def autopsy_config(run_dir: str, index_cache_dir: Optional[str] = None):
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    cfg = load_config(os.path.join(run_dir, "config.yaml"))
    cfg = dataclasses.replace(cfg, load_into_memory=False)
    if index_cache_dir:
        cfg = dataclasses.replace(cfg, index_cache_dir=index_cache_dir)
    return cfg


def val_batches(cfg, n: int, data_root: Optional[str] = None) -> List[dict]:
    """The first ``n`` validation batches of the run's stream, host
    arrays."""
    from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningDataLoader

    loader = MetaLearningDataLoader(cfg, current_iter=0, data_root=data_root)
    try:
        return [b for _, b in zip(range(n), loader.val_batches(n))]
    finally:
        loader.close()


def evaluate(system, state, batches) -> dict:
    losses, accs = [], []
    for b in batches:
        out = system.eval_step(state, b)
        losses.append(float(out.loss))
        accs.append(float(out.accuracy))
    return {"loss": float(np.mean(losses)), "accuracy": float(np.mean(accs)), "per_batch_accuracy": accs}


def autopsy(run_dir: str, idxs=None, data_root=None, index_cache_dir=None, eval_batches: int = 3, device=None,
            compare_cpu=None, model=None, cpu_model=None, out=print) -> dict:
    """The autopsy of ``idxs`` (default every epoch and ``best``) ->
    ``{"checkpoints": {idx: {epoch, step, stats, eval}}}``. ``compare_cpu``:
    None (card only), ``[]`` (every checkpoint on the CPU too) or a list of
    checkpoint names. ``model`` / ``cpu_model`` replace the config's
    backbone (a test's small one)."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt

    save_dir = os.path.join(run_dir, "saved_models")
    idxs = list(idxs or [str(e) for e in ckpt.available_epochs(save_dir)] + ["best"])
    cfg = autopsy_config(run_dir, index_cache_dir)
    systems = {"card" if device is None else str(device): MAMLSystem(cfg, model=model, device=device)}
    if compare_cpu is not None and "cpu" not in systems:
        systems["cpu"] = MAMLSystem(cfg, model=cpu_model or model, device="cpu")
    templates = {name: s.init_train_state() for name, s in systems.items()}
    batches = val_batches(cfg, eval_batches, data_root)
    report = {"run_dir": run_dir, "eval_batches": len(batches), "checkpoints": {}}
    for idx in idxs:
        if not ckpt.checkpoint_exists(save_dir, idx):
            out(f"== checkpoint {idx}: missing, skipped")
            continue
        entry = {"eval": {}}
        for name, system in systems.items():
            if name == "cpu" and compare_cpu and idx not in compare_cpu:
                continue
            state, book = ckpt.load_checkpoint(save_dir, idx, templates[name],
                                               feature_shape=system.model.feature_shape)
            if "stats" not in entry:
                entry.update(epoch=book.get("epoch"), step=int(state.step),
                             stats=state_tables(state, system.model.feature_shape))
                out(f"== checkpoint {idx} (epoch={entry['epoch']}, step={entry['step']})")
                for label, rows in entry["stats"].items():
                    for line in format_stats(rows, label):
                        out(line)
            ev = evaluate(system, state, batches)
            entry["eval"][name] = ev
            out(f"  {name} eval ({len(batches)} val batches, {cfg.number_of_evaluation_steps_per_iter} inner "
                f"steps): loss={ev['loss']:.4f} acc={ev['accuracy']:.4f} "
                f"(per-batch acc: {', '.join(f'{a:.3f}' for a in ev['per_batch_accuracy'])})")
        report["checkpoints"][idx] = entry
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                     epilog=__doc__.split("\n\n", 2)[2],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("run_dir")
    parser.add_argument("epochs", nargs="*", help="checkpoint names (default: every epoch and best)")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--index-cache-dir", default=None)
    parser.add_argument("--eval-batches", type=int, default=3)
    parser.add_argument("--compare-cpu", nargs="*", default=None, metavar="EPOCH",
                        help="also evaluate on the CPU (every checkpoint, or the ones named)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--json", default=None, help="write the report as one JSON object to this path")
    args = parser.parse_args(argv)
    report = autopsy(args.run_dir, args.epochs, args.data_root, args.index_cache_dir, args.eval_batches,
                     None if args.device == "cuda" else "cpu", args.compare_cpu)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
