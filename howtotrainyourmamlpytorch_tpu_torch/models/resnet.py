"""Stem-less ResNet few-shot backbone (reference ``models.py:60-150``; JAX
package ``models/resnet.py``).

No ImageNet stem: the first stage takes the input channels. 4 stages of
BasicBlocks at widths 32/64/128/256; the first block of each stage has
stride 2, and a 1x1 conv + BN ``downsample`` where the stride or the width
changes. Then global average pool -> Linear. resnet-4/8/12 are
``blocks_per_stage`` (1,1,1,1) / (2,2,2,2) / (3,3,3,3).

Init: kaiming-normal fan_out convs without bias, unit/zero BN, optionally
the second BN scale of every block at zero (``zero_init_residual``); the
head keeps torch's default Linear init. Parameter keys match the JAX
package: ``layer{i}/block_{j}/{conv1,bn1,conv2,bn2,downsample/{conv,bn}}``
and ``fc``.
"""

from typing import Sequence, Tuple

import torch

from . import layers
from .model import Model

STAGE_WIDTHS = (32, 64, 128, 256)


def _init_basic_block(gen, cin, planes, stride):
    bn1_p, bn1_s = layers.init_batch_norm(planes)
    bn2_p, bn2_s = layers.init_batch_norm(planes)
    params = {
        "conv1": layers.init_conv(gen, 3, 3, cin, planes, bias=False, init="kaiming_normal_fan_out"),
        "bn1": bn1_p,
        "conv2": layers.init_conv(gen, 3, 3, planes, planes, bias=False, init="kaiming_normal_fan_out"),
        "bn2": bn2_p,
    }
    state = {"bn1": bn1_s, "bn2": bn2_s}
    if stride != 1 or cin != planes:
        dbn_p, dbn_s = layers.init_batch_norm(planes)
        params["downsample"] = {
            "conv": layers.init_conv(gen, 1, 1, cin, planes, bias=False, init="kaiming_normal_fan_out"),
            "bn": dbn_p,
        }
        state["downsample"] = {"bn": dbn_s}
    return params, state


def _apply_basic_block(params, state, x, stride, use_batch_stats, sample_weight, stat_dtype):
    bn = lambda p, s, h: layers.batch_norm(  # noqa: E731
        p, s, h, use_batch_stats, sample_weight=sample_weight, stat_dtype=stat_dtype
    )[0]
    out = layers.relu(bn(params["bn1"], state["bn1"], layers.conv2d(params["conv1"], x, stride=stride, padding=1)))
    out = bn(params["bn2"], state["bn2"], layers.conv2d(params["conv2"], out, padding=1))
    identity = x
    if "downsample" in params:
        down = params["downsample"]
        identity = bn(down["bn"], state["downsample"]["bn"], layers.conv2d(down["conv"], x, stride=stride))
    return layers.relu(out + identity)


def build_resnet(
    image_shape: Tuple[int, int, int],
    num_classes: int,
    blocks_per_stage: Sequence[int] = (1, 1, 1, 1),
    zero_init_residual: bool = False,
) -> Model:
    """``image_shape`` is (H, W, C)."""
    h, w, c = image_shape

    def init(gen):
        params, state = {}, {}
        cin = c
        for si, (planes, n) in enumerate(zip(STAGE_WIDTHS, blocks_per_stage)):
            stage_p, stage_s = {}, {}
            for bi in range(n):
                bp, bs = _init_basic_block(gen, cin, planes, 2 if bi == 0 else 1)
                if zero_init_residual:
                    bp["bn2"]["scale"] = torch.zeros_like(bp["bn2"]["scale"])
                stage_p[f"block_{bi}"], stage_s[f"block_{bi}"] = bp, bs
                cin = planes
            params[f"layer{si + 1}"], state[f"layer{si + 1}"] = stage_p, stage_s
        params["fc"] = layers.init_linear(gen, STAGE_WIDTHS[-1], num_classes)
        return params, state

    def apply(params, state, x, *, use_batch_stats=True, sample_weight=None, stat_dtype=None):
        # NHWC -> NCHW, contiguous: on the CPU, torch's oneDNN convolution
        # takes the permuted view as channels-last, and its weight gradient
        # of a 1x1 stride-2 conv on such an input is wrong or crashes
        x = x.permute(0, 3, 1, 2).contiguous()
        for si, n in enumerate(blocks_per_stage):
            stage_p, stage_s = params[f"layer{si + 1}"], state[f"layer{si + 1}"]
            for bi in range(n):
                x = _apply_basic_block(
                    stage_p[f"block_{bi}"], stage_s[f"block_{bi}"], x, 2 if bi == 0 else 1,
                    use_batch_stats, sample_weight, stat_dtype,
                )
        return layers.linear(params["fc"], layers.global_avg_pool(x)), state

    return Model(init=init, apply=apply, name="resnet", feature_shape=(STAGE_WIDTHS[-1], 1, 1))
