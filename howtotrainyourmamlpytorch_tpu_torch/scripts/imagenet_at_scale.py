#!/usr/bin/env python
"""The Mini-ImageNet data path at the real dataset's scale (the JAX
package's ``scripts/imagenet_at_scale.py``, on this package).

No Mini-ImageNet is in the repository, so this drives the full 84x84x3
pipeline at the real dataset's size, 100 classes x 600 images pre-split
64/16/20, on a synthetic image tree, and records each stage's wall seconds
and the process's peak RSS after it in a JSON report:

  1. tree generation (random JPEGs, one per real image; skipped when the
     tree is complete)
  2. index bootstrap and the RAM cache (every image decoded to float32
     NHWC, about 5.1 GB at full scale)
  3. the cached re-bootstrap (the index JSONs exist)
  4. episode assembly throughput (the native C++ engine where it builds)
  5. with ``--steps N``: N meta-steps of the 5-way 5-shot Mini-ImageNet
     recipe (meta-batch 8, the ImageNet grad clamp) on ``--device``, from
     the loader

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.imagenet_at_scale \\
        [--root DIR] [--steps N] [--assembly-batches 250] [--out PATH] \\
        [--classes 100] [--per-class 600] [--net vgg] [--override KEY=VALUE] [--device cuda|cpu]

``--classes`` and ``--per-class`` shrink the tree (the split keeps the
64/16/20 shares, each at least the episode's 5 classes); ``--net`` picks
the backbone of the meta-steps (the JAX script's is its config's default,
``vgg``). The report goes to ``--out`` (default ``ROOT/imagenet_at_scale.json``;
the JAX script wrote into its repository's ``results/``).
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import time
from typing import Dict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

CLASSES, IMAGES_PER_CLASS = 100, 600
N_WAY, K_SHOT, TARGETS, META_BATCH = 5, 5, 1, 8


def peak_rss_gb() -> float:
    """This program's peak resident set (``VmHWM``; ``ru_maxrss``, which a
    process keeps across ``exec`` from the one that forked it, where
    ``/proc`` has none), in GB."""
    try:
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) for line in f if line.startswith("VmHWM:")) / 1e6
    except (OSError, StopIteration):
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def split_counts(classes: int = CLASSES, n_way: int = N_WAY) -> Dict[str, int]:
    """The 64/16/20 split of ``classes`` (exact at 100)."""
    train, val = round(classes * 64 / 100), round(classes * 16 / 100)
    counts = {"train": train, "val": val, "test": classes - train - val}
    if min(counts.values()) < n_way:
        raise ValueError(f"{classes} classes split {counts}: every split needs {n_way} classes for an episode")
    return counts


def generate_tree(root: str, classes: int = CLASSES, per_class: int = IMAGES_PER_CLASS) -> int:
    """``classes`` x ``per_class`` synthetic 84x84x3 JPEGs in the pre-split
    layout ``<split>/<class>/<img>`` (one RandomState(0) stream, as the JAX
    script's): one low-entropy base per class plus per-image noise. ->
    the number of images."""
    from PIL import Image

    rng = np.random.RandomState(0)
    n = 0
    for split, n_classes in split_counts(classes).items():
        for c in range(n_classes):
            d = os.path.join(root, split, f"n{split}{c:08d}")
            os.makedirs(d, exist_ok=True)
            base = rng.randint(0, 200, size=(84, 84, 3), dtype=np.uint8)
            for i in range(per_class):
                img = base + rng.randint(0, 56, size=(84, 84, 3), dtype=np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"{i:05d}.jpg"), quality=60)
                n += 1
    return n


def recipe_config(data_dir: str, cache_dir: str, load_into_memory: bool, net: str = "vgg", overrides=()):
    """configs/mini_imagenet_5way_5shot.yaml's episode (5-way 5-shot, one
    target, meta-batch 8) on the synthetic tree."""
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    dataset = json.dumps({"name": "mini_imagenet_full_size", "path": data_dir})
    return load_config(None, [f"dataset={dataset}", f"index_cache_dir={cache_dir}",
                              f"load_into_memory={str(load_into_memory).lower()}", "sets_are_pre_split=true",
                              f"num_classes_per_set={N_WAY}", f"num_samples_per_class={K_SHOT}",
                              f"num_target_samples={TARGETS}", f"batch_size={META_BATCH}", f"net={net}",
                              *overrides])


def _stage(report: dict, name: str, t0: float) -> None:
    report["stages"][name] = {"seconds": time.perf_counter() - t0, "peak_rss_gb": peak_rss_gb()}


def run(root: str, steps: int = 0, assembly_batches: int = 250, classes: int = CLASSES,
        per_class: int = IMAGES_PER_CLASS, net: str = "vgg", device=None, model=None, overrides=(),
        out=print) -> dict:
    from howtotrainyourmamlpytorch_tpu_torch import native
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import resolve_device
    from howtotrainyourmamlpytorch_tpu_torch.data import FewShotDataset, MetaLearningDataLoader

    device = resolve_device(device)  # the card unless the CPU is asked for, before any stage
    counts = split_counts(classes)
    report = {"synthetic_data": True, "classes": classes, "per_class": per_class, "split": counts,
              "image_shape": [84, 84, 3], "net": net, "stages": {}}
    data_dir = os.path.join(root, "mini_imagenet_full_size")
    marker = os.path.join(root, ".complete")
    if not os.path.exists(marker):
        out(f"generating the synthetic tree ({classes} x {per_class}) ...")
        t0 = time.perf_counter()
        report["images_generated"] = generate_tree(data_dir, classes, per_class)
        _stage(report, "tree_generation", t0)
        with open(marker, "w") as f:
            f.write("ok")
    cache_dir = os.path.join(root, "index_cache")
    cfg = recipe_config(data_dir, cache_dir, True, net, overrides)

    t0 = time.perf_counter()
    ds = FewShotDataset(cfg)
    _stage(report, "bootstrap_plus_ram_cache", t0)
    report["ram_cache_classes"] = {k: len(v) for k, v in ds.datasets.items()}
    report["ram_cache_images"] = sum(len(v) for classes_ in ds.datasets.values() for v in classes_.values())
    if report["ram_cache_classes"] != counts:
        raise RuntimeError(f"the index holds {report['ram_cache_classes']} classes, the tree {counts}")

    t0 = time.perf_counter()
    FewShotDataset(recipe_config(data_dir, cache_dir, False, net, overrides))
    _stage(report, "cached_bootstrap", t0)

    report["native_engine"] = native.load_engine() is not None
    loader = MetaLearningDataLoader(cfg, dataset=ds)
    try:
        for _ in loader.train_batches(min(10, assembly_batches), augment_images=True):
            pass  # the prefetch path warm
        t0 = time.perf_counter()
        shapes = None
        count = 0
        for b in loader.train_batches(assembly_batches, augment_images=True):
            shapes = shapes or {k: list(v.shape) for k, v in b.items()}
            count += 1
        dt = time.perf_counter() - t0
        _stage(report, "episode_assembly", t0)
        report.update(assembly_batches=count, episode_shapes=shapes,
                      assembly_episodes_per_s=count * cfg.batch_size / dt, assembly_ms_per_batch=1e3 * dt / count,
                      loader_stats=loader.stats())
        if steps:
            report["meta_steps"] = meta_steps(cfg, loader, steps, device, model)
            report["stages"]["meta_steps"] = {"seconds": report["meta_steps"]["seconds"],
                                              "peak_rss_gb": peak_rss_gb()}
    finally:
        loader.close()
    report["peak_rss_gb"] = peak_rss_gb()
    return report


def meta_steps(cfg, loader, steps: int, device=None, model=None) -> dict:
    """``steps`` train steps of the recipe from the loader: the first
    (cuDNN's algorithm search, B1/B2 builds) timed apart from the rest."""
    import torch

    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem

    t_all = time.perf_counter()
    system = MAMLSystem(cfg, model=model, device=device)
    state = system.init_train_state()
    batches = list(loader.train_batches(steps, augment_images=True))
    sync = torch.cuda.synchronize if system.device.type == "cuda" else (lambda: None)
    losses, ms = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, o = system.train_step(state, b, epoch=0)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(o.loss))
    out = {"steps": steps, "device": system.device.type, "remat_policy": system.remat_policy,
           "step_ms": ms, "losses": losses, "finite": bool(np.isfinite(losses).all()),
           "seconds": time.perf_counter() - t_all}
    if system.device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                     epilog=__doc__.split("\n\n", 2)[2],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "mini_imagenet_synth"))
    parser.add_argument("--steps", type=int, default=0)
    parser.add_argument("--assembly-batches", type=int, default=250)
    parser.add_argument("--classes", type=int, default=CLASSES)
    parser.add_argument("--per-class", type=int, default=IMAGES_PER_CLASS)
    parser.add_argument("--net", default="vgg")
    parser.add_argument("--override", action="append", default=[], metavar="KEY=VALUE",
                        help="a config override applied last (e.g. use_pallas_inner_update=true); repeatable")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--out", default=None, help="the JSON report (default ROOT/imagenet_at_scale.json)")
    args = parser.parse_args(argv)
    report = run(args.root, args.steps, args.assembly_batches, args.classes, args.per_class, args.net,
                 None if args.device == "cuda" else "cpu", overrides=args.override)
    path = args.out or os.path.join(args.root, "imagenet_at_scale.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
