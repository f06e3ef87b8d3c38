"""The benchmark's own work counts: the FLOP counter on meta tensors against
the same counter on real tensors at a small size, the grouped-convolution
correction, the stored count of a configuration, and the bytes of one
launch of B1 and B2 against a hand count."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import cells
from reference import costs, maml

SMALL = {"dataset": "omniglot", "net": "vgg", "num_classes_per_set": 3, "num_samples_per_class": 2,
         "num_target_samples": 1, "batch_size": 2, "number_of_training_steps_per_iter": 2,
         "multi_step_loss_num_epochs": 10}


@pytest.mark.parametrize("net,dataset", [("vgg", "omniglot"), ("resnet-4", "imagenet")])
def test_meta_count_equals_a_count_on_real_tensors(net, dataset):
    cfg = {**SMALL, "net": net, "dataset": dataset}
    params = maml.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lrs = {k: torch.tensor(0.1) for k in params}
    shapes = costs.episode_shapes(cfg)
    batch = {k: (torch.zeros(s, dtype=torch.int64) if k.startswith("y") else torch.rand(s)) for k, s in shapes.items()}
    counter = FlopCounterMode(display=False,
                              custom_mapping={torch.ops.aten.convolution_backward: costs.conv_backward_flop})
    with counter:
        maml.meta_gradient(cfg, params, lrs, batch, 0)
    assert costs.meta_step_flops(cfg) == counter.get_total_flops() > 0


def test_grouped_convolution_weight_term_is_divided_by_the_groups():
    x, w = (8, 64, 14, 14), (64, 16, 3, 3)
    args = dict(grad_out_shape=(8, 64, 14, 14), x_shape=x, w_shape=w, bias=None, stride=[1, 1], padding=[1, 1],
                dilation=[1, 1], transposed=False, output_padding=[0, 0], out_shape=[x, w, None])
    torch_count = getattr(torch.utils.flop_counter.conv_backward_flop, "__wrapped__",
                          torch.utils.flop_counter.conv_backward_flop)
    positional = [args[k] for k in ("grad_out_shape", "x_shape", "w_shape", "bias", "stride", "padding",
                                    "dilation", "transposed", "output_padding")]
    weight_only = [False, True, False]
    dense_weight = torch_count(*positional, 4, weight_only, out_shape=[x, w, None])
    assert costs.conv_backward_flop(groups=4, output_mask=weight_only, **args) * 4 == dense_weight
    # the input gradient's term is left as torch counts it
    input_only = [True, False, False]
    assert costs.conv_backward_flop(groups=4, output_mask=input_only, **args) == torch_count(
        *positional, 4, input_only, out_shape=[x, w, None])


def test_stored_count_of_the_vgg_configuration():
    config = cells.part("configs", "omniglot20w5s-vgg64")
    assert costs.meta_step_flops(config["maml"]) == config["flops_per_meta_step"]


@pytest.mark.parametrize("net,dataset", [("vgg", "omniglot"), ("resnet-12", "imagenet")])
def test_inner_update_bytes_against_a_hand_count(net, dataset):
    cfg = {**SMALL, "net": net, "dataset": dataset}
    specs = maml.param_specs(cfg)
    elements = 8 * sum(math.prod(s) for _, s, _, _ in specs)
    counted = costs.inner_update_bytes(cfg, 8)
    assert counted["fused_sgd"] == 4 * (3 * elements + len(specs))
    assert counted["fused_sgd_bwd"] == 4 * (3 * elements + 2 * len(specs))


def test_vgg_bytes_match_the_kernel_table():
    """The 20-way VGG-64 tree of 8 tasks: 905,888 elements, 18 leaves (the
    bound of PERF.md's kernel table)."""
    cfg = cells.part("configs", "omniglot20w5s-vgg64")["maml"]
    assert costs.inner_update_bytes(cfg, 8) == {"fused_sgd": 10_870_728, "fused_sgd_bwd": 10_870_800}
