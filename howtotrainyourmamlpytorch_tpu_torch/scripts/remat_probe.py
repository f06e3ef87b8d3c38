#!/usr/bin/env python
"""What each remat policy costs on the card: one model and batch under the
policies, eager train steps with the arms in turn (a host that drifts
moves every arm alike), wall and host CPU ms per step, peak memory, the
host time the profiler puts in dispatch modes' ``__torch_dispatch__`` (none
under the C++ hook of the selective policies), and a chunk of steps
replayed from a CUDA graph per policy.

Usage:
    python -m howtotrainyourmamlpytorch_tpu_torch.scripts.remat_probe \\
        [--config configs/mini_imagenet_5way_5shot.yaml] [--override net=resnet-12 ...] \\
        [--arms none full dots_saveable full+passthrough] \\
        [--parent-remat FILE] [--rounds 6] [--chunk 3] [--profile] [--device cuda|cpu] [--json PATH]

Arms: a policy name (``core/remat.py``), ``full+passthrough`` (``full`` with a dispatch mode that records
nothing entered around the whole inner step: the Python cost of such a
mode) and, with ``--parent-remat FILE`` (a ``core/remat.py`` of another
revision, from git history), ``parent`` (that file's ``dots_saveable``, with
its ``dot`` at the call sites of ``models/layers.py``; a convolution's site
passes ``conv=True``, as the Python dispatch mode of that revision expects).
Every arm starts from the same state and batch (seeded), under cuDNN's
deterministic algorithms, so the first losses must agree. ``--chunk 0``
skips the graphs.
"""

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

ARMS = ("none", "full", "dots_saveable", "full+passthrough")
DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                              "configs", "mini_imagenet_5way_5shot.yaml")


class PassThrough(TorchDispatchMode):
    """Runs every op and records nothing."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _load_remat(path: str):
    spec = importlib.util.spec_from_file_location("remat_under_probe", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def arm_context(arm: str, parent=None):
    """The ``apply_remat_policy`` of ``arm``, for the steps run inside."""
    from howtotrainyourmamlpytorch_tpu_torch.core import maml
    from howtotrainyourmamlpytorch_tpu_torch.models import layers

    apply, dot, conv = maml.apply_remat_policy, layers.dot, layers._conv
    if arm == "full+passthrough":
        def policy(step, name):
            def in_mode(*args):
                with PassThrough():
                    return step(*args)

            return apply(in_mode, name)

        maml.apply_remat_policy = policy
    elif arm == "parent":
        maml.apply_remat_policy, layers.dot = parent.apply_remat_policy, parent.dot
        layers._conv = lambda x, w, b, stride, padding: layers._dot(
            torch.nn.functional.conv2d, x, w, b, bias_view=(-1, 1, 1), conv=True, stride=stride, padding=padding)
    try:
        yield
    finally:
        maml.apply_remat_policy, layers.dot, layers._conv = apply, dot, conv


def policy_of(arm: str) -> str:
    return {"full+passthrough": "full", "parent": "dots_saveable"}.get(arm, arm)


def dispatch_host_ms(system, state, batch) -> dict:
    """One train step under the profiler with Python tracing: the
    ``__torch_dispatch__`` calls it recorded and their summed ms (the op
    each passes on included; the tracer slows them)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        system.train_step(state, batch, epoch=0)
        _sync(system)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    calls = [e for e in events if "__torch_dispatch__" in str(e.get("name", ""))]
    return {"calls": len(calls), "ms": sum(e.get("dur", 0) for e in calls) / 1e3}


def _sync(system):
    if system.device.type == "cuda":
        torch.cuda.synchronize(system.device)


def probe(cfg_path: str, overrides, arms, rounds: int, chunk: int, profile: bool, device=None, parent=None,
          seed: int = 0, out=print) -> dict:
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config
    from howtotrainyourmamlpytorch_tpu_torch.core.maml import MAMLSystem
    from howtotrainyourmamlpytorch_tpu_torch.data.synthetic import learnable_synthetic_batch

    cuda = torch.device("cuda") if device is None else torch.device(device)
    report = {"config": cfg_path, "overrides": list(overrides), "rounds": rounds, "arms": {}}
    systems, batch = {}, None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for arm in arms:
            cfg = load_config(cfg_path, [*overrides, f"remat_policy={policy_of(arm)}"])
            system = MAMLSystem(cfg, device=device)
            state = system.init_train_state(seed)
            if batch is None:
                batch = learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                                  cfg.num_target_samples, cfg.image_shape, seed=seed + 6)
            gc.collect()
            if cuda.type == "cuda":
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            with arm_context(arm, parent):
                t0 = time.perf_counter()
                _, first = system.train_step(state, batch, epoch=0)
                _sync(system)
            entry = report["arms"][arm] = {"policy": system.remat_policy, "first_loss": float(first.loss),
                                           "first_step_ms": (time.perf_counter() - t0) * 1e3,
                                           "wall_ms": [], "host_cpu_ms": []}
            if cuda.type == "cuda":
                entry["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            systems[arm] = (system, state, cfg)
        for r in range(rounds):
            for arm in arms[r % len(arms):] + arms[:r % len(arms)]:
                system, state, _ = systems[arm]
                with arm_context(arm, parent):
                    _sync(system)
                    c0, t0 = time.thread_time(), time.perf_counter()
                    system.train_step(state, batch, epoch=0)
                    _sync(system)
                report["arms"][arm]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
                report["arms"][arm]["host_cpu_ms"].append((time.thread_time() - c0) * 1e3)
        for arm in arms:
            entry, (system, state, cfg) = report["arms"][arm], systems[arm]
            if rounds:
                entry.update(wall_ms_median=statistics.median(entry["wall_ms"]),
                             host_cpu_ms_median=statistics.median(entry["host_cpu_ms"]))
            if profile:
                with arm_context(arm, parent):
                    entry["torch_dispatch"] = dispatch_host_ms(system, state, batch)
            out(f"{arm:24s} " + json.dumps({k: v for k, v in entry.items() if not isinstance(v, list)}))
        for arm in [a for a in arms if a in ("none", "full", "dots_saveable")] if chunk else []:
            system, state, cfg = systems[arm]
            steps = [learnable_synthetic_batch(cfg.batch_size, cfg.num_classes_per_set, cfg.num_samples_per_class,
                                               cfg.num_target_samples, cfg.image_shape, seed=seed + 6 + i)
                     for i in range(chunk)]
            stacked = {k: torch.stack([torch.as_tensor(b[k]) for b in steps]) for k in steps[0]}
            _sync(system)
            t0 = time.perf_counter()
            _, (losses, _, _) = system.train_step_multi(state, stacked, 0)
            _sync(system)
            seconds = time.perf_counter() - t0
            graphs = [c for p in system._train_multi.values() for c in getattr(p, "_captured", {}).values()]
            graph = {"chunk": chunk, "dispatch_s": seconds, "losses": [float(x) for x in losses]}
            if graphs:  # the replays: the dispatch less the warmup and the capture
                graph.update(warmup_s=graphs[0].lower_s, capture_s=graphs[0].compile_s,
                             replay_ms_per_step=(seconds - graphs[0].lower_s - graphs[0].compile_s) * 1e3 / chunk)
            report["arms"][arm]["graph"] = graph
            out(f"{arm:24s} graph " + json.dumps(graph))
            del systems[arm]
            gc.collect()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                     epilog=__doc__.split("\n\n", 2)[2],
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", default=DEFAULT_CONFIG)
    parser.add_argument("--override", action="append", default=None, metavar="KEY=VALUE",
                        help="config overrides (default: net=resnet-12 use_pallas_inner_update=true)")
    parser.add_argument("--arms", nargs="+", default=list(ARMS), choices=(*ARMS, "parent"))
    parser.add_argument("--parent-remat", default=None, metavar="FILE")
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--chunk", type=int, default=3)
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--json", default=None, help="write the report as one JSON object to this path")
    args = parser.parse_args(argv)
    arms = list(args.arms) + (["parent"] if args.parent_remat and "parent" not in args.arms else [])
    parent = _load_remat(args.parent_remat) if args.parent_remat else None
    overrides = args.override if args.override is not None else ["net=resnet-12", "use_pallas_inner_update=true"]
    report = probe(args.config, overrides, arms, args.rounds, args.chunk, args.profile,
                   None if args.device == "cuda" else "cpu", parent)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
