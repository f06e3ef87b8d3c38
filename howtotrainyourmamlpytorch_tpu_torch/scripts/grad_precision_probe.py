#!/usr/bin/env python
"""Meta-gradient precision probe (the JAX package's
``scripts/grad_precision_probe.py``, on this package): does the card's
matmul precision change the second-order MAML meta-gradient?

Computes the meta-gradient of one fixed synthetic batch at init and either
saves it (``save``: run it with ``--device cpu``, the float32 ground truth)
or prints per-tensor norms and the cosine of each tensor to a saved one
(``compare``: on the card under each ``--precision``, IEEE float32
``highest`` and TF32 ``high`` by default).

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.grad_precision_probe \\
        save GRADS.npz [N_WAY] [DTYPE] --device cpu
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.grad_precision_probe \\
        compare GRADS.npz [N_WAY] [DTYPE] [--precision highest high]

``DTYPE``: ``float32`` (default), ``bfloat16`` (the config's
``compute_dtype``) or ``mxu_default`` (the same as ``--emulate bf16``).
``--emulate bf16|tf32`` rounds every convolution and matrix-product operand
to that format before its float32 product (:func:`apply_operand_emulation`,
shared with ``stream_replay_probe`` and ``descent_probe``): ``bf16`` is the
JAX script's emulation of the TPU's default pass, ``tf32`` the card's
``high``. Dropped from the JAX script: the ``JAX_DEFAULT_MATMUL_PRECISION``
variable (``--precision`` takes its place). Added: ``--k-shot``,
``--batch-size`` (default the config's 8), ``--override KEY=VALUE``, ``--learnable`` (the
class-structured batch in place of pure noise) and ``--json PATH`` (the
result as one JSON object). Tensor names are the JAX package's key paths in
its layout, so files of either package compare.
"""

import argparse
import contextlib
import json
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from howtotrainyourmamlpytorch_tpu_torch.models import layers  # noqa: E402

FORMATS = ("bf16", "tf32")
PRECISIONS = ("highest", "high")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """To bfloat16 and back (round to nearest even); the gradient is cast
    the same way, as JAX's ``astype`` pair transposes."""
    return t.to(torch.bfloat16).to(t.dtype)


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest even at 10 mantissa bits (TF32's)."""
    bits = t.contiguous().view(torch.int32)
    rounded = ((bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(t), rounded, t)


class _RoundTF32(torch.autograd.Function):
    """:func:`_tf32` with a gradient rounded the same way (a cast to a
    10-bit-mantissa format and back, as :func:`round_bf16`)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(t):
        return _tf32(t)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return _RoundTF32.apply(grad)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    return _RoundTF32.apply(t)


ROUNDERS = {"bf16": round_bf16, "tf32": round_tf32}


def apply_operand_emulation(fmt: Optional[str]):
    """Round the input and the weight of every convolution and matrix
    product to ``fmt`` (``"bf16"``, ``"tf32"``; None: off) before its
    float32 product, process-wide (``models/layers.py::OPERAND_ROUNDING``).
    Elementwise ops stay float32. Returns the previous setting."""
    if fmt is not None and fmt not in ROUNDERS:
        raise ValueError(f"unknown operand format {fmt!r}; expected one of {FORMATS}")
    previous = layers.OPERAND_ROUNDING
    layers.OPERAND_ROUNDING = None if fmt is None else ROUNDERS[fmt]
    return previous


@contextlib.contextmanager
def operand_emulation(fmt: Optional[str]):
    previous = apply_operand_emulation(fmt)
    try:
        yield
    finally:
        layers.OPERAND_ROUNDING = previous


def keystr(path) -> str:
    """A tree path spelled as ``jax.tree_util.keystr`` spells a dict path."""
    return "".join(f"['{k}']" for k in path)


def flat_jax_layout(tree, feature_shape) -> Dict[str, np.ndarray]:
    """``{"params", "hparams"}`` of port tensors -> {JAX key path: float64
    array in the JAX layout}."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.interop import trainables_to_jax
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_flatten

    leaves, paths = tree_flatten(trainables_to_jax(tree, feature_shape))
    return {keystr(path): np.asarray(leaf, np.float64) for path, leaf in zip(paths, leaves)}


def probe_config(n_way: int = 20, k_shot: int = 5, compute_dtype: str = "float32", batch_size: Optional[int] = None,
                 precision: str = "default", overrides=()):
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    extra = [] if batch_size is None else [f"batch_size={batch_size}"]
    return load_config(None, [f"num_classes_per_set={n_way}", f"num_samples_per_class={k_shot}",
                              f"compute_dtype={compute_dtype}", f"matmul_precision={precision}", *extra,
                              *overrides])


def probe_batch(cfg, learnable: bool = False):
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch, synthetic_batch

    make = learnable_synthetic_batch if learnable else synthetic_batch
    return make(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class, cfg.num_target_samples,
                cfg.image_shape, seed=0)


def meta_grads(cfg, device=None, state=None, batch=None, model=None) -> Dict[str, np.ndarray]:
    """The meta-gradient (second order, MSL, K inner steps at epoch 0: the
    JAX script's ``_meta_objective`` call) of ``batch`` (default the
    probe's) at ``state`` (default the seeded init) of ``model`` (default
    the config's) -> {JAX key path: float64 array}."""
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem

    system = MAMLSystem(cfg, model=model, device=device)
    state = system.init_train_state() if state is None else state
    batch = probe_batch(cfg) if batch is None else batch
    if not (system.use_second_order(0) and system.msl_active(0)):
        raise ValueError("the probe's objective is the second-order MSL step of epoch 0")
    _, _, grads = system.meta_gradients(state, batch, epoch=0)
    return flat_jax_layout(grads, system.model.feature_shape)


def compare(flat: Dict[str, np.ndarray], ref) -> dict:
    """Per-tensor norms and cosines of ``flat`` to ``ref`` (same names),
    the worst cosine, and the cosine of the whole vectors."""
    rows, worst = [], 1.0
    for name in sorted(flat):
        g, r = flat[name], np.asarray(ref[name], np.float64)
        denom = np.linalg.norm(g) * np.linalg.norm(r)
        cos = float((g * r).sum() / denom) if denom > 0 else float("nan")
        worst = min(worst, cos if cos == cos else worst)
        rows.append({"name": name, "norm": float(np.linalg.norm(g)), "ref_norm": float(np.linalg.norm(r)), "cos": cos})
    a = np.concatenate([flat[n].ravel() for n in sorted(flat)])
    b = np.concatenate([np.asarray(ref[n], np.float64).ravel() for n in sorted(flat)])
    return {"tensors": rows, "worst_cosine": worst,
            "global_cosine": float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                     epilog=__doc__.split("\n\n", 2)[2],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("mode", choices=("save", "compare"))
    parser.add_argument("path")
    parser.add_argument("n_way", nargs="?", type=int, default=20)
    parser.add_argument("dtype", nargs="?", default="float32", choices=("float32", "bfloat16", "mxu_default"))
    parser.add_argument("--k-shot", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--learnable", action="store_true", help="the class-structured synthetic batch")
    parser.add_argument("--emulate", choices=FORMATS, default=None)
    parser.add_argument("--precision", nargs="+", choices=PRECISIONS, default=None,
                        help="compare: the matmul precisions to run (default: highest high); save: highest")
    parser.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                        help="a config override applied last (e.g. use_pallas_inner_update=true); repeatable")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--json", default=None, help="write the result as one JSON object to this path")
    args = parser.parse_args(argv)
    emulate = "bf16" if args.dtype == "mxu_default" else args.emulate
    compute_dtype = "float32" if args.dtype == "mxu_default" else args.dtype
    device = None if args.device == "cuda" else "cpu"
    precisions = args.precision or (["highest"] if args.mode == "save" else list(PRECISIONS))
    result = {"mode": args.mode, "n_way": args.n_way, "k_shot": args.k_shot, "dtype": args.dtype,
              "emulate": emulate, "device": args.device, "arms": {}}
    ref = np.load(args.path) if args.mode == "compare" else None
    with operand_emulation(emulate):
        for precision in precisions:
            cfg = probe_config(args.n_way, args.k_shot, compute_dtype, args.batch_size, precision, args.override)
            flat = meta_grads(cfg, device, batch=probe_batch(cfg, args.learnable))
            print(f"backend={args.device} n_way={args.n_way} dtype={args.dtype} emulate={emulate} "
                  f"matmul_precision={precision}", flush=True)
            if args.mode == "save":
                np.savez(args.path, **flat)
                print(f"saved {len(flat)} grad tensors -> {args.path}", flush=True)
                result["arms"][precision] = {"tensors": len(flat)}
                continue
            arm = compare(flat, ref)
            for row in arm["tensors"]:
                print(f"{row['name']:55s} |g|={row['norm']:9.3e} |ref|={row['ref_norm']:9.3e} cos={row['cos']:+.4f}")
            print(f"worst cosine vs the saved reference: {arm['worst_cosine']:+.4f} "
                  f"(whole vector {arm['global_cosine']:+.6f})", flush=True)
            result["arms"][precision] = arm
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
