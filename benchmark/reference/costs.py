"""The benchmark's own work counts: FLOPs of the reference's meta-step and
serving request, and the bytes of one launch of the fused inner update.

FLOPs: the reference run under ``torch.utils.flop_counter.FlopCounterMode``
on ``meta`` tensors (shapes only: nothing is computed or allocated), two
FLOPs per multiply-add, the matrix products and convolutions forward,
backward and double backward; elementwise work is not counted, and neither
is recomputation (the reference recomputes nothing). torch's formula for
``convolution_backward`` counts a grouped convolution's weight gradient as
a dense one, ``groups`` times too many; :func:`conv_backward_flop` divides
that term by the groups.

Bytes of the fused inner update, ``p' = p - lr * g`` over every parameter
tensor of every task (B1) and its backward (B2): each input read once and
each output written once. B1 reads p and g and one lr per tensor, writes
p'. B2 reads the cotangent, g and the lrs, writes dg and one dlr per tensor.
"""

import math
from typing import Dict

import torch

from . import maml

FLOAT_BYTES = 4


def conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
                       output_padding, groups, output_mask, out_shape, **kwargs) -> int:
    """torch's ``convolution_backward`` count with the weight gradient's term
    divided by ``groups``."""
    from torch.utils.flop_counter import conv_backward_flop as torch_formula

    formula = getattr(torch_formula, "__wrapped__", torch_formula)
    args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed, output_padding, groups)
    total = formula(*args, output_mask, out_shape=out_shape, **kwargs)
    if groups > 1 and output_mask[1]:
        weight = formula(*args, [False, True, False], out_shape=out_shape, **kwargs)
        total -= weight - weight // groups
    return total


def _counter():
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False, custom_mapping={torch.ops.aten.convolution_backward: conv_backward_flop})


def _meta_params(cfg: dict):
    params = {k: torch.empty(shape, device="meta") for k, shape, _, _ in maml.param_specs(cfg)}
    lrs = {k: torch.empty((), device="meta") for k in params}
    return params, lrs


def episode_shapes(cfg: dict) -> Dict[str, tuple]:
    """Shapes of one meta-batch: ``[B, n_way, k, H, W, C]`` and the labels."""
    b, n = int(cfg["batch_size"]), int(cfg["num_classes_per_set"])
    k, t = int(cfg["num_samples_per_class"]), int(cfg["num_target_samples"])
    img = maml.image_shape(cfg)
    return {"x_support": (b, n, k) + img, "y_support": (b, n, k), "x_target": (b, n, t) + img,
            "y_target": (b, n, t)}


def meta_step_flops(cfg: dict) -> int:
    """FLOPs of one meta-gradient of the reference at the configuration's
    shapes (the outer Adam's elementwise work is not counted)."""
    params, lrs = _meta_params(cfg)
    batch = {k: torch.empty(s, device="meta", dtype=torch.int64 if k.startswith("y") else torch.float32)
             for k, s in episode_shapes(cfg).items()}
    counter = _counter()
    with counter:
        maml.meta_gradient(cfg, params, lrs, batch, 0)
    return int(counter.get_total_flops())


def serve_task_flops(cfg: dict, support: int, query: int, steps: int) -> int:
    """FLOPs of one served request: ``steps`` first-order inner steps on
    ``support`` images, then the forward of ``query`` images."""
    params, lrs = _meta_params(cfg)
    img = maml.image_shape(cfg)
    xs = torch.empty((support,) + img, device="meta")
    ys = torch.empty((support,), device="meta", dtype=torch.int64)
    xq = torch.empty((query,) + img, device="meta")
    counter = _counter()
    with counter:
        p = {k: v.requires_grad_(True) for k, v in params.items()}
        fast = maml.inner_loop(cfg, p, lrs, xs, ys, steps, create_graph=False)
        with torch.no_grad():
            maml.forward(cfg, fast, xq)
    return int(counter.get_total_flops())


def inner_update_bytes(cfg: dict, tasks: int) -> Dict[str, int]:
    """Bytes of one launch of B1 and of B2 over the parameter tree of
    ``tasks`` tasks."""
    specs = maml.param_specs(cfg)
    elements = tasks * sum(math.prod(shape) for _, shape, _, _ in specs)
    leaves = len(specs)
    return {
        "fused_sgd": FLOAT_BYTES * (3 * elements + leaves),
        "fused_sgd_bwd": FLOAT_BYTES * (3 * elements + 2 * leaves),
    }
