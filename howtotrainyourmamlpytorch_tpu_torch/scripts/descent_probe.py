#!/usr/bin/env python
"""Repeated-batch descent probe (the JAX package's
``scripts/descent_probe.py``, on this package): can the full meta-step
(second order, MSL, LSLR, outer Adam) descend on a few fixed batches?

Draws ``N_BATCHES`` training batches from the loader (augmented, as the
runner draws them) and takes ``STEPS`` train steps rotating over them,
printing the running train loss and accuracy; with more than one batch it
ends with the loss and accuracy on every probe batch, each from a copy of
the end state (the step's metrics are those of the state before the
update).

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.descent_probe \\
        [EMULATE] [N_WAY] [STEPS] [UNROLL] [N_BATCHES] [--emulate bf16|tf32] \\
        [--dataset-path DIR] [--data-root DIR] [--index-cache-dir DIR] \\
        [--k-shot 1] [--batch-size 4] [--override KEY=VALUE] [--device cuda|cpu] [--json PATH]

``EMULATE`` (0/1) is the JAX script's switch, 1 meaning ``--emulate bf16``
(the operand rounding shared with ``grad_precision_probe``). ``UNROLL`` is
accepted and ignored: in the JAX script it picks an XLA program family
(unrolled or ``lax.scan``), which has no counterpart here. The dataset is
Omniglot at ``--dataset-path`` (default the config's), 1-shot, meta-batch
4, remat off, images from disk, as the JAX script's config; the JAX
script's hard-coded data root and index cache become ``--data-root`` and
``--index-cache-dir``.
"""

import argparse
import json
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from howtotrainyourmamlpytorch_tpu_torch.scripts.grad_precision_probe import FORMATS, operand_emulation  # noqa: E402


def descent_config(n_way: int = 20, dataset_path: Optional[str] = None, index_cache_dir: Optional[str] = None,
                   k_shot: int = 1, batch_size: int = 4, overrides=()):
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    extra = [] if dataset_path is None else ["dataset=" + json.dumps({"name": "omniglot_dataset", "path": dataset_path})]
    if index_cache_dir:
        extra.append(f"index_cache_dir={index_cache_dir}")
    return load_config(None, [f"num_classes_per_set={n_way}", f"num_samples_per_class={k_shot}",
                              "num_target_samples=1", f"batch_size={batch_size}", "load_into_memory=false",
                              "remat_inner_steps=false", *extra, *overrides])


def probe_batches(cfg, n_batches: int, data_root=None) -> List[dict]:
    from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningDataLoader

    loader = MetaLearningDataLoader(cfg, current_iter=0, data_root=data_root)
    try:
        return [b for _, b in zip(range(n_batches), loader.train_batches(n_batches, augment_images=True))]
    finally:
        loader.close()


def descend(cfg, steps: int, n_batches: int = 1, device=None, emulate: Optional[str] = None, data_root=None,
            model=None, state=None, out=print) -> dict:
    """``steps`` train steps over ``n_batches`` fixed batches from
    ``state`` (default the seeded init) -> ``{"steps": [{step, loss,
    accuracy}], "final": [{batch, loss, accuracy}]}``."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.core.programs import clone_tree

    system = MAMLSystem(cfg, model=model, device=device)
    state = system.init_train_state() if state is None else state
    batches = probe_batches(cfg, n_batches, data_root)
    out(f"emulate={emulate} n_way={cfg.num_classes_per_set} n_batches={len(batches)} "
        f"matmul_precision={cfg.matmul_precision} device={system.device.type}")
    record, final = [], []
    with operand_emulation(emulate):
        for i in range(steps):
            state, o = system.train_step(state, batches[i % len(batches)], epoch=0)
            record.append({"step": i, "loss": float(o.loss), "accuracy": float(o.accuracy)})
            if i % 10 == 0 or i == steps - 1:
                out(f"step {i:3d} loss={record[-1]['loss']:.4f} acc={record[-1]['accuracy']:.4f}")
        if len(batches) > 1:
            for j, b in enumerate(batches):
                _, o = system.train_step(clone_tree(state), b, epoch=0)
                final.append({"batch": j, "loss": float(o.loss), "accuracy": float(o.accuracy)})
                out(f"final batch {j} loss={final[-1]['loss']:.4f} acc={final[-1]['accuracy']:.4f}")
            out(f"final mean acc over {len(batches)} batches: {sum(f['accuracy'] for f in final) / len(final):.4f}")
    return {"n_way": cfg.num_classes_per_set, "n_batches": len(batches), "emulate": emulate,
            "device": system.device.type, "steps": record, "final": final}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                     epilog=__doc__.split("\n\n", 2)[2],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("emulate_flag", nargs="?", type=int, default=0, metavar="EMULATE")
    parser.add_argument("n_way", nargs="?", type=int, default=20)
    parser.add_argument("steps", nargs="?", type=int, default=25)
    parser.add_argument("unroll", nargs="?", type=int, default=None, help="ignored (an XLA program family)")
    parser.add_argument("n_batches", nargs="?", type=int, default=1)
    parser.add_argument("--emulate", choices=FORMATS, default=None)
    parser.add_argument("--dataset-path", default=None)
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--index-cache-dir", default=None)
    parser.add_argument("--k-shot", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                        help="a config override applied last (e.g. use_pallas_inner_update=true); repeatable")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--json", default=None, help="write the result as one JSON object to this path")
    args = parser.parse_args(argv)
    emulate = args.emulate or ("bf16" if args.emulate_flag else None)
    cfg = descent_config(args.n_way, args.dataset_path, args.index_cache_dir, args.k_shot, args.batch_size,
                         args.override)
    result = descend(cfg, args.steps, args.n_batches, None if args.device == "cuda" else "cpu", emulate,
                     args.data_root)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
