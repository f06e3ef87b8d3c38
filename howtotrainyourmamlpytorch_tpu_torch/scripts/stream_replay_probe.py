#!/usr/bin/env python
"""Replay the training stream a run saw, from one of its own checkpoints
(the JAX package's ``scripts/stream_replay_probe.py``, on this package).

The episode stream is a pure function of the train seed and the loader's
cursor, and the checkpoint's bookkeeping stores the cursor
(``train_episodes_produced``), so from checkpoint N this replays the very
batches the run consumed after it (the same augmentations, the same
order), on ``--device``: the card, or the CPU, where ``--emulate`` can
round the matmul operands as the card's ``high`` (``tf32``) or a TPU's
default pass (``bf16``) would. If the run degraded over these steps while
a CPU replay from the same state and stream holds, the card's updates are
at fault; if the replay degrades the same way, the training dynamics are.
Each step prints its loss, accuracy and a digest of its batch (sha256 of
the host arrays), so a replay can be shown to see the run's own batches.

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.stream_replay_probe \\
        RUN_DIR CKPT N_STEPS [PRINT_EVERY] [EMULATE] [--emulate bf16|tf32] \\
        [--data-root DIR] [--index-cache-dir DIR] [--device cuda|cpu] [--json PATH]

``CKPT`` is an epoch, ``latest``, ``best`` or ``init`` (the run's own
initialization over the epoch-0 stream). ``EMULATE`` (0/1) is the JAX
script's switch, 1 meaning ``--emulate bf16``. The config is the run's
``config.yaml``, with images read from disk; ``--data-root`` and
``--index-cache-dir`` replace the JAX script's hard-coded paths. The JAX
script's switch to its rolled program without remat has no counterpart:
the replay runs the run's own program.
"""

import argparse
import hashlib
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from howtotrainyourmamlpytorch_tpu_torch.scripts.checkpoint_autopsy import autopsy_config  # noqa: E402
from howtotrainyourmamlpytorch_tpu_torch.scripts.grad_precision_probe import FORMATS, operand_emulation  # noqa: E402


def batch_digest(batch) -> str:
    """sha256 over a batch's arrays in key order (host bytes, dtype and
    shape included): equal digests, equal batches."""
    h = hashlib.sha256()
    for key in sorted(batch):
        a = batch[key]
        a = np.ascontiguousarray(a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a))
        h.update(f"{key}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def replay_start(run_dir: str, idx: str, system):
    """(state, the epoch the checkpoint closed, the loader's cursor in
    episodes) of checkpoint ``idx`` (``init``: the seeded init, -1, 0)."""
    from howtotrainyourmamlpytorch_tpu_torch.experiment import checkpoint as ckpt

    template = system.init_train_state()
    if idx == "init":
        return template, -1, 0
    state, book = ckpt.load_checkpoint(os.path.join(run_dir, "saved_models"), idx, template,
                                       feature_shape=system.model.feature_shape)
    return state, int(book.get("epoch", 0)), int(book.get("train_episodes_produced", 0))


def replay(run_dir: str, idx: str, n_steps: int, device=None, emulate: Optional[str] = None, data_root=None,
           index_cache_dir=None, print_every: int = 10, model=None, out=print) -> dict:
    """``n_steps`` train steps of the run's stream from checkpoint ``idx``
    -> ``{"epoch", "cursor", "steps": [{step, loss, accuracy, digest}]}``."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningDataLoader

    cfg = autopsy_config(run_dir, index_cache_dir)
    system = MAMLSystem(cfg, model=model, device=device)
    state, epoch, cursor = replay_start(run_dir, idx, system)
    loader = MetaLearningDataLoader(cfg, current_iter=cursor // (cfg.batch_size * cfg.samples_per_iter),
                                    data_root=data_root)
    next_epoch = epoch + 1
    out(f"replay from ckpt {idx}: epoch={epoch} step={int(state.step)} cursor={cursor} emulate={emulate} "
        f"-> replaying epoch {next_epoch} stream on {system.device.type}")
    steps: List[dict] = []
    try:
        with operand_emulation(emulate):
            for i, b in zip(range(n_steps), loader.train_batches(n_steps, augment_images=True)):
                digest = batch_digest(b)
                state, o = system.train_step(state, b, epoch=next_epoch)
                steps.append({"step": i, "loss": float(o.loss), "accuracy": float(o.accuracy), "digest": digest})
                if i % print_every == 0 or i == n_steps - 1:
                    out(f"step {i:4d} loss={steps[-1]['loss']:.4f} acc={steps[-1]['accuracy']:.4f} "
                        f"batch={digest[:16]}")
    finally:
        loader.close()
    return {"checkpoint": idx, "epoch": epoch, "cursor": cursor, "emulate": emulate, "device": system.device.type,
            "steps": steps}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                     epilog=__doc__.split("\n\n", 2)[2],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("run_dir")
    parser.add_argument("ckpt")
    parser.add_argument("n_steps", type=int)
    parser.add_argument("print_every", nargs="?", type=int, default=10)
    parser.add_argument("emulate_flag", nargs="?", type=int, default=0, metavar="EMULATE")
    parser.add_argument("--emulate", choices=FORMATS, default=None)
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--index-cache-dir", default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--json", default=None, help="write the replay as one JSON object to this path")
    args = parser.parse_args(argv)
    emulate = args.emulate or ("bf16" if args.emulate_flag else None)
    result = replay(args.run_dir, args.ckpt, args.n_steps, None if args.device == "cuda" else "cpu", emulate,
                    args.data_root, args.index_cache_dir, args.print_every)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
