"""The plain reference of the benchmark: MAML++ in plain PyTorch.

Written from the MAML++ paper (Antoniou et al., "How to train your MAML",
ICLR 2019) and its reference code (``few_shot_learning_system.py``,
``meta_neural_network_architectures.py``, and the stem-less ResNet of the
reference fork's ``models.py``), in float32 with TF32 off. It imports no
part of the program under test and takes nothing the program made: the
harness hands both sides the same weights and episodes.

Parameters are a flat dict ``{"stage_0/conv/w": tensor, ...}`` whose keys
are the checkpoint layout both packages of the repository use, so the
harness can hand the same tensors to the program as a nested tree
(:func:`nest`).

- Conv-4 VGG: 4 x [conv 3x3 pad 1 (with bias) -> batch norm -> leaky ReLU
  0.01 -> max pool 2], flatten (channel, row, column), linear.
- ResNet-12 without a stem: 4 stages of 3 basic blocks at widths
  32/64/128/256; the first block of a stage has stride 2 and a 1x1 conv +
  batch norm shortcut; convs without bias; global average pool, linear.
- Batch norm is transductive: every forward normalises with the statistics
  of the batch it sees (biased variance, eps 1e-5), as the reference does.
- The inner loop: SGD with one learnable learning rate per parameter
  tensor, ``w <- w - lr_w * dL_support/dw``; second order keeps the graph of
  the inner gradients.
- The multi-step loss (MSL): the target loss after every inner step,
  weighted by the annealed importance vector of the reference code.
- The outer update: Adam (b1 0.9, b2 0.999, eps 1e-8, the step size read
  from a cosine schedule stepped once per epoch), with the gradients of the
  network's parameters clamped to +-10 on Mini-ImageNet, and every inner
  learning rate kept at or above 1e-4 after the step.
"""

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

IMAGE_SHAPES = {"omniglot": (28, 28, 1), "imagenet": (84, 84, 3)}
RESNET_WIDTHS = (32, 64, 128, 256)
RESNET_BLOCKS = {"resnet-4": (1, 1, 1, 1), "resnet-8": (2, 2, 2, 2), "resnet-12": (3, 3, 3, 3)}
VGG_STAGES, VGG_FILTERS = 4, 64
BN_EPS = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MIN_INNER_LR = 1e-4
IMAGENET_GRAD_CLAMP = 10.0


def strict_float32() -> None:
    """IEEE float32 for every matrix product and convolution (no TF32)."""
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"


def dataset_kind(cfg: dict) -> str:
    return "imagenet" if "imagenet" in str(cfg["dataset"]) else "omniglot"


def image_shape(cfg: dict) -> Tuple[int, int, int]:
    """(H, W, C) of the configuration's dataset."""
    return IMAGE_SHAPES[dataset_kind(cfg)]


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """``(key, shape, init, scale)`` for every parameter tensor, in sorted
    key order. ``init``: ``uniform`` (U(-scale, scale)), ``normal``
    (N(0, scale^2)), ``ones`` or ``zeros``."""
    h, w, c = image_shape(cfg)
    n_way = int(cfg["num_classes_per_set"])
    specs = []

    def conv(key, cin, cout, k, bias, init):
        fan_in, fan_out = cin * k * k, cout * k * k
        if init == "uniform":
            specs.append((key + "/w", (cout, cin, k, k), "uniform", 1.0 / math.sqrt(fan_in)))
        else:
            specs.append((key + "/w", (cout, cin, k, k), "normal", math.sqrt(2.0 / fan_out)))
        if bias:
            specs.append((key + "/b", (cout,), "uniform", 1.0 / math.sqrt(fan_in)))

    def bn(key, ch):
        specs.append((key + "/scale", (ch,), "ones", 0.0))
        specs.append((key + "/bias", (ch,), "zeros", 0.0))

    def linear(key, cin, cout):
        specs.append((key + "/w", (cout, cin), "uniform", 1.0 / math.sqrt(cin)))
        specs.append((key + "/b", (cout,), "uniform", 1.0 / math.sqrt(cin)))

    net = cfg["net"]
    if net == "vgg":
        cin, fh, fw = c, h, w
        for i in range(VGG_STAGES):
            conv(f"stage_{i}/conv", cin, VGG_FILTERS, 3, True, "uniform")
            bn(f"stage_{i}/bn", VGG_FILTERS)
            cin, fh, fw = VGG_FILTERS, fh // 2, fw // 2
        linear("fc", VGG_FILTERS * fh * fw, n_way)
    elif net in RESNET_BLOCKS:
        cin = c
        for si, (planes, n) in enumerate(zip(RESNET_WIDTHS, RESNET_BLOCKS[net])):
            for bi in range(n):
                key = f"layer{si + 1}/block_{bi}"
                conv(key + "/conv1", cin, planes, 3, False, "normal")
                bn(key + "/bn1", planes)
                conv(key + "/conv2", planes, planes, 3, False, "normal")
                bn(key + "/bn2", planes)
                if bi == 0:
                    conv(key + "/downsample/conv", cin, planes, 1, False, "normal")
                    bn(key + "/downsample/bn", planes)
                cin = planes
        linear("fc", RESNET_WIDTHS[-1], n_way)
    else:
        raise ValueError(f"the reference has no network {net!r}")
    return sorted(specs, key=lambda s: s[0].split("/"))


def init_params(cfg: dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded parameters on ``device``: every uniform tensor from one
    ``torch.rand`` call and every normal one from one ``torch.randn`` call
    of ``gen`` (a generator on ``device``)."""
    specs = param_specs(cfg)
    sizes = {kind: sum(math.prod(s[1]) for s in specs if s[2] == kind) for kind in ("uniform", "normal")}
    pools = {
        "uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2.0 - 1.0,
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
    }
    offsets = {"uniform": 0, "normal": 0}
    params = {}
    for key, shape, init, scale in specs:
        if init in pools:
            n = math.prod(shape)
            params[key] = (pools[init][offsets[init]:offsets[init] + n] * scale).reshape(shape).clone()
            offsets[init] += n
        else:
            params[key] = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
    return params


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b/c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    out: dict = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Inverse of :func:`nest`."""
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(flat(value, prefix + key + "/"))
        else:
            out[prefix + key] = value
    return out


# ---------------------------------------------------------------------------
# forward passes (NHWC images in, logits out)
# ---------------------------------------------------------------------------


def _bn(x, p, key):
    """Batch norm with the statistics of ``x`` over (N, H, W), computed in
    two passes (the mean, then the mean squared deviation from it)."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    shape = (1, -1, 1, 1)
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[key + "/scale"].view(shape) + p[key + "/bias"].view(shape)


def vgg_forward(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2)
    for i in range(VGG_STAGES):
        key = f"stage_{i}"
        x = F.conv2d(x, p[key + "/conv/w"], p[key + "/conv/b"], padding=1)
        x = F.max_pool2d(F.leaky_relu(_bn(x, p, key + "/bn"), 0.01), 2)
    return F.linear(x.flatten(1), p["fc/w"], p["fc/b"])


def resnet_forward(p: Dict[str, torch.Tensor], x: torch.Tensor, blocks) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2).contiguous()
    for si, n in enumerate(blocks):
        for bi in range(n):
            key = f"layer{si + 1}/block_{bi}"
            stride = 2 if bi == 0 else 1
            out = torch.relu(_bn(F.conv2d(x, p[key + "/conv1/w"], stride=stride, padding=1), p, key + "/bn1"))
            out = _bn(F.conv2d(out, p[key + "/conv2/w"], padding=1), p, key + "/bn2")
            if bi == 0:
                x = _bn(F.conv2d(x, p[key + "/downsample/conv/w"], stride=stride), p, key + "/downsample/bn")
            x = torch.relu(out + x)
    return F.linear(x.mean(dim=(2, 3)), p["fc/w"], p["fc/b"])


def forward(cfg: dict, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if cfg["net"] == "vgg":
        return vgg_forward(p, x)
    return resnet_forward(p, x, RESNET_BLOCKS[cfg["net"]])


# ---------------------------------------------------------------------------
# the meta-step
# ---------------------------------------------------------------------------


def msl_weights(epoch: int, steps: int, msl_epochs: int) -> List[float]:
    """The reference's per-step loss importance at ``epoch``: uniform 1/N at
    epoch 0, the non-final weights decaying by 1/(N * msl_epochs) per epoch
    to a floor of 0.03/N, the final one growing to match."""
    n = float(steps)
    decay = 1.0 / n / msl_epochs
    floor = 0.03 / n
    weights = [max(1.0 / n - epoch * decay, floor)] * steps
    weights[-1] = min(1.0 / n + epoch * (n - 1.0) * decay, 1.0 - (n - 1.0) * floor)
    return weights


def inner_loop(cfg, params: Dict[str, torch.Tensor], lrs: Dict[str, torch.Tensor], x, y, steps: int,
               create_graph: bool, targets=None, weights=None):
    """``steps`` SGD steps on (x, y) from ``params``. With ``targets``
    ``(x_t, y_t)`` -> the weighted sum of the target losses after each step
    (a weight of 0 skips that step's target forward); else -> the adapted
    parameters."""
    fast = dict(params)
    keys = list(fast)
    total = 0.0
    for k in range(steps):
        loss = F.cross_entropy(forward(cfg, fast, x), y)
        grads = torch.autograd.grad(loss, [fast[key] for key in keys], create_graph=create_graph)
        fast = {key: fast[key] - lrs[key] * g for key, g in zip(keys, grads)}
        if targets is not None and weights[k] != 0.0:
            total = total + weights[k] * F.cross_entropy(forward(cfg, fast, targets[0]), targets[1])
    return total if targets is not None else fast


def flatten_task(x: torch.Tensor) -> torch.Tensor:
    """[n_way, k, ...] -> [n_way * k, ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def meta_gradient(cfg: dict, params, lrs, batch: dict, epoch: int):
    """The meta-objective of one batch of tasks and its gradient ->
    ``(loss tensor, grads over params, grads over lrs)``. The tasks' losses
    are differentiated one task at a time and summed (the gradient of their
    mean), which keeps one task's graph in memory at once."""
    steps = int(cfg["number_of_training_steps_per_iter"])
    msl = bool(cfg.get("use_multi_step_loss_optimization", True)) and epoch < int(cfg["multi_step_loss_num_epochs"])
    weights = msl_weights(epoch, steps, int(cfg["multi_step_loss_num_epochs"])) if msl else [0.0] * (steps - 1) + [1.0]
    second_order = bool(cfg.get("second_order", True)) and epoch > int(cfg.get("first_order_to_second_order_epoch", -1))
    tasks = batch["x_support"].shape[0]
    keys = list(params)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    a = {k: v.detach().requires_grad_(True) for k, v in lrs.items()}
    leaves = [p[k] for k in keys] + [a[k] for k in keys]
    acc = [torch.zeros_like(t) for t in leaves]
    loss_sum = 0.0
    for t in range(tasks):
        task_loss = inner_loop(
            cfg, p, a, flatten_task(batch["x_support"][t]), flatten_task(batch["y_support"][t]), steps,
            second_order, targets=(flatten_task(batch["x_target"][t]), flatten_task(batch["y_target"][t])),
            weights=weights,
        )
        grads = torch.autograd.grad(task_loss / tasks, leaves)
        acc = [s + g for s, g in zip(acc, grads)]
        loss_sum = loss_sum + task_loss.detach() / tasks
    n = len(keys)
    return loss_sum, dict(zip(keys, acc[:n])), dict(zip(keys, acc[n:]))


def cosine_lr(cfg: dict, count: int) -> float:
    """The outer step size at update ``count``: cosine annealing stepped
    once per epoch from ``meta_learning_rate`` to ``min_learning_rate``."""
    epoch = count // int(cfg["total_iter_per_epoch"])
    hi, lo = float(cfg["meta_learning_rate"]), float(cfg["min_learning_rate"])
    return lo + (hi - lo) * 0.5 * (1.0 + math.cos(math.pi * epoch / int(cfg["total_epochs"])))


def train_step(cfg: dict, state: dict, batch: dict):
    """One outer update of ``state`` (``params``, ``lrs``, Adam's moments
    ``mu`` and ``nu`` over both as ``{"p": ..., "a": ...}``, and its update
    ``count``) -> ``(new state, loss, the gradient as Adam takes it)``."""
    epoch = state["count"] // int(cfg["total_iter_per_epoch"])
    loss, gp, ga = meta_gradient(cfg, state["params"], state["lrs"], batch, epoch)
    loss = float(loss)
    if dataset_kind(cfg) == "imagenet":
        gp = {k: g.clamp(-IMAGENET_GRAD_CLAMP, IMAGENET_GRAD_CLAMP) for k, g in gp.items()}
    grads = {"p": gp, "a": ga}
    lr = cosine_lr(cfg, state["count"])
    count = state["count"] + 1
    bc1, bc2 = 1.0 - ADAM_B1 ** count, 1.0 - ADAM_B2 ** count
    new = {"count": count, "mu": {}, "nu": {}}
    for part, values in (("p", state["params"]), ("a", state["lrs"])):
        mu = {k: ADAM_B1 * state["mu"][part][k] + (1.0 - ADAM_B1) * g for k, g in grads[part].items()}
        nu = {k: ADAM_B2 * state["nu"][part][k] + (1.0 - ADAM_B2) * g * g for k, g in grads[part].items()}
        new["mu"][part], new["nu"][part] = mu, nu
        stepped = {k: values[k] - lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS) for k in values}
        new["params" if part == "p" else "lrs"] = stepped
    new["lrs"] = {k: v.clamp(min=MIN_INNER_LR) for k, v in new["lrs"].items()}
    return new, loss, grads


# ---------------------------------------------------------------------------
# serving: adapt on a support set, answer its queries
# ---------------------------------------------------------------------------


def adapt_predict(cfg: dict, params, lrs, x_support, y_support, x_query, steps: int) -> torch.Tensor:
    """First-order adaptation of one task on its support set, then softmax
    probabilities of its queries (batch statistics over the query set)."""
    with torch.enable_grad():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        fast = inner_loop(cfg, p, lrs, x_support, y_support, steps, create_graph=False)
    with torch.no_grad():
        return torch.softmax(forward(cfg, {k: v.detach() for k, v in fast.items()}, x_query), dim=-1)
