"""The harness's side of the program under test: its configuration from a
config file's ``maml`` keys, its state from the weights the harness made,
and the episodes both sides see.

Everything here is made on the card from the run's seed, in a few large
calls, and handed to the program and to the reference alike.
"""

import json
from typing import Dict, Optional

import torch

from reference import maml as ref

SEED_MODULUS = 2 ** 63


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of the run's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % SEED_MODULUS)
    return gen


def program_config(maml_keys: Dict[str, object], extra: Optional[Dict[str, object]] = None):
    """The port's ``Config`` from the MAML++ keys, as its CLI builds one
    from ``key=value`` overrides."""
    from howtotrainyourmamlpytorch_tpu_torch.config import load_config

    keys = dict(maml_keys)
    keys.update(extra or {})
    return load_config(None, [f"{k}={json.dumps(v)}" for k, v in keys.items()])


def train_state(system, params: Dict[str, torch.Tensor], lrs: Dict[str, torch.Tensor]):
    """The program's ``TrainState`` over copies of the harness's weights and
    learning rates (a zero outer Adam state, step 0)."""
    from howtotrainyourmamlpytorch_tpu_torch.core.train_state import TrainState
    from howtotrainyourmamlpytorch_tpu_torch.ops.outer_adam import adam_init

    p = ref.nest({k: v.clone() for k, v in params.items()})
    hp = {"lr": ref.nest({k: v.clone() for k, v in lrs.items()})}
    return TrainState(params=p, bn_state=bn_state(params), inner_hparams=hp,
                      opt_state=adam_init({"params": p, "hparams": hp}),
                      step=torch.zeros((), dtype=torch.int64, device=system.device))


def bn_state(params: Dict[str, torch.Tensor]) -> dict:
    """The batch norms' running statistics at their start (transductive
    batch norm never reads them), one set per ``.../scale`` parameter."""
    state = {}
    for key, value in params.items():
        if key.endswith("/scale"):
            prefix = key[: -len("/scale")]
            state.update({prefix + "/mean": torch.zeros_like(value), prefix + "/var": torch.ones_like(value),
                          prefix + "/count": torch.zeros((), device=value.device)})
    return ref.nest(state)


def norms(tree_flat: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Norm of every leaf, read to the host at once."""
    keys = list(tree_flat)
    values = torch.stack([tree_flat[k].detach().double().norm() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))


def episodes(cfg: Dict[str, object], steps: int, gen: torch.Generator, device,
             noise_share: float) -> Dict[str, torch.Tensor]:
    """``steps`` meta-batches, every row distinct: ``x_support [steps, B,
    n_way, k, H, W, C]`` and the targets, the label of an image its class's
    index. Every class of every task has a prototype image drawn uniformly
    from [0, 1); each of its images is the prototype mixed with its own
    uniform noise, ``noise_share`` of it noise, so that the classes can be
    told apart, as a data set's can."""
    b, n = int(cfg["batch_size"]), int(cfg["num_classes_per_set"])
    k, t = int(cfg["num_samples_per_class"]), int(cfg["num_target_samples"])
    img = ref.image_shape(cfg)
    proto = torch.rand((steps, b, n, 1) + img, generator=gen, device=device) * (1.0 - noise_share)
    images = lambda m: torch.rand((steps, b, n, m) + img, generator=gen, device=device) * noise_share + proto  # noqa: E731
    labels = lambda m: torch.arange(n, device=device).view(1, 1, n, 1).expand(steps, b, n, m).contiguous()  # noqa: E731
    return {"x_support": images(k), "y_support": labels(k), "x_target": images(t), "y_target": labels(t)}


def rows(data: Dict[str, torch.Tensor], lo: int, hi: int) -> Dict[str, torch.Tensor]:
    return {key: value[lo:hi] for key, value in data.items()}


def row(data: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {key: value[i] for key, value in data.items()}


def episode_bytes(cfg: Dict[str, object]) -> int:
    b, n = int(cfg["batch_size"]), int(cfg["num_classes_per_set"])
    k, t = int(cfg["num_samples_per_class"]), int(cfg["num_target_samples"])
    h, w, c = ref.image_shape(cfg)
    return 4 * b * n * (k + t) * h * w * c + 8 * b * n * (k + t)
