"""Toy cells for the CPU tests: a copy of ``BENCHMARK.json`` and of the
benchmark's data files under a temporary root, with small configurations
(the networks at 3 ways, 2 shots, 2 tasks, 2 inner steps; the ResNet
configuration's as ResNet-4), toy traffic and toy cells of both drivers,
each cell holding the limits of the real cell it stands for."""

import json
import os
import shutil

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

TOY_SIZES = {"num_classes_per_set": 3, "num_samples_per_class": 2, "batch_size": 2,
             "number_of_training_steps_per_iter": 2, "number_of_evaluation_steps_per_iter": 2}
#: toy cell -> (real cell whose traffic and limits it takes, configuration, size changes)
TOY_CELLS = {
    "toy.train.vgg": ("train.omniglot20w5s-vgg64", "omniglot20w5s-vgg64", {"train_steps_per_dispatch": 2}),
    "toy.train.resnet": ("train.omniglot20w5s-vgg64", "miniimagenet5w5s-resnet12", {"net": "resnet-4"}),
    "toy.serve.vgg": ("serve.omniglot20w5s-vgg64.over-knee", "omniglot20w5s-vgg64", {}),
}
TOY_TRAFFIC = {"train_steps": {"pool_bytes": 1 << 20},
               "adapt_predict_over_knee": {"rate_per_s": 10.0, "query_sizes": [3, 6], "query_weights": [0.5, 0.5],
                                           "check_requests": 6}}


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _dump(value, *parts):
    path = os.path.join(*parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(value, f, indent=1)


def build(root: str, copy_code: bool = False) -> dict:
    """Write the toy tree under ``root`` -> the spec written. With
    ``copy_code`` the whole ``benchmark/`` directory is copied first."""
    bench = os.path.join(root, "benchmark")
    if copy_code:
        shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = _load(ROOT, "BENCHMARK.json")
    real = {w["name"]: w for w in spec["workloads"]}
    for toy, (source, config_name, changes) in TOY_CELLS.items():
        cell = dict(real[source])
        config = _load(BENCH_DIR, "configs", config_name + ".json")
        config["name"] = "toy-" + toy
        config["maml"].update(TOY_SIZES, **changes)
        _dump(config, bench, "configs", config["name"] + ".json")
        traffic = _load(BENCH_DIR, "traffic", cell["traffic"] + ".json")
        traffic.update(TOY_TRAFFIC[cell["traffic"]])
        _dump(traffic, bench, "traffic", "toy-" + cell["traffic"] + ".json")
        _dump(_load(BENCH_DIR, "limits", source + ".json"), bench, "limits", toy + ".json")
        spec["workloads"].append({**cell, "name": toy, "config": config["name"], "traffic": "toy-" + cell["traffic"],
                                  "why": "toy"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if source in metric.get("workloads", ()):
                metric["workloads"].append(toy)
    _dump(spec, root, "BENCHMARK.json")
    return spec


def parts(cell: str):
    """-> (traffic, configuration) of a toy cell, as ``build`` writes them."""
    source, config_name, changes = TOY_CELLS[cell]
    spec = _load(ROOT, "BENCHMARK.json")
    real = {w["name"]: w for w in spec["workloads"]}[source]
    config = _load(BENCH_DIR, "configs", config_name + ".json")
    config["maml"].update(TOY_SIZES, **changes)
    traffic = _load(BENCH_DIR, "traffic", real["traffic"] + ".json")
    traffic.update(TOY_TRAFFIC[real["traffic"]])
    return traffic, config


def args(cell: str, seed: int = 2147483659, seconds: float = 1.0, trace: int = 0):
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
