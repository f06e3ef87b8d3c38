"""Stem-less DenseNet-BC few-shot backbone (reference ``models.py:153-220``;
JAX package ``models/densenet.py``).

No first convolution: the dense blocks start from the input channels.
Growth rate 8, bottleneck width ``bn_size`` x growth. Each dense layer is
BN -> ReLU -> Conv1x1(bn_size * growth) -> BN -> ReLU -> Conv3x3(growth,
pad 1), its output concatenated onto the running features on ``dim=1``
(NCHW: the JAX package's ``axis=-1`` in NHWC, the same channel order).
Each transition is BN -> ReLU -> Conv1x1(features // 2) -> AvgPool 2x2.
Then ``norm5`` -> ReLU -> global average pool -> Linear with a zero bias.
Convs have no bias and kaiming-normal fan_in init. densenet-8/12 are
``block_config`` (2,)*4 / (3,)*4. Parameter keys match the JAX package:
``denseblock{i}/layer_{j}/{norm1,conv1,norm2,conv2}``,
``transition{i}/{norm,conv}``, ``norm5``, ``classifier``.
"""

from typing import Sequence, Tuple

import torch

from . import layers
from .model import Model


def _init_dense_layer(gen, cin, growth_rate, bn_size):
    bottleneck = bn_size * growth_rate
    n1_p, n1_s = layers.init_batch_norm(cin)
    n2_p, n2_s = layers.init_batch_norm(bottleneck)
    params = {
        "norm1": n1_p,
        "conv1": layers.init_conv(gen, 1, 1, cin, bottleneck, bias=False, init="kaiming_normal_fan_in"),
        "norm2": n2_p,
        "conv2": layers.init_conv(gen, 3, 3, bottleneck, growth_rate, bias=False, init="kaiming_normal_fan_in"),
    }
    return params, {"norm1": n1_s, "norm2": n2_s}


def build_densenet(
    image_shape: Tuple[int, int, int],
    num_classes: int,
    block_config: Sequence[int] = (3, 3, 3, 3),
    growth_rate: int = 8,
    bn_size: int = 2,
) -> Model:
    """``image_shape`` is (H, W, C)."""
    h, w, c = image_shape
    features = c
    for i, n in enumerate(block_config):
        features += n * growth_rate
        if i != len(block_config) - 1:
            features //= 2

    def init(gen):
        params, state = {}, {}
        num_features = c
        for i, num_layers in enumerate(block_config):
            block_p, block_s = {}, {}
            for li in range(num_layers):
                lp, ls = _init_dense_layer(gen, num_features + li * growth_rate, growth_rate, bn_size)
                block_p[f"layer_{li}"], block_s[f"layer_{li}"] = lp, ls
            params[f"denseblock{i + 1}"], state[f"denseblock{i + 1}"] = block_p, block_s
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                tn_p, tn_s = layers.init_batch_norm(num_features)
                params[f"transition{i + 1}"] = {
                    "norm": tn_p,
                    "conv": layers.init_conv(
                        gen, 1, 1, num_features, num_features // 2, bias=False, init="kaiming_normal_fan_in"
                    ),
                }
                state[f"transition{i + 1}"] = {"norm": tn_s}
                num_features //= 2
        params["norm5"], state["norm5"] = layers.init_batch_norm(num_features)
        params["classifier"] = layers.init_linear(gen, num_features, num_classes, zero_bias=True)
        return params, state

    def apply(params, state, x, *, use_batch_stats=True, sample_weight=None, stat_dtype=None):
        def bn_relu(p, s, h):
            out, _ = layers.batch_norm(p, s, h, use_batch_stats, sample_weight=sample_weight, stat_dtype=stat_dtype)
            return layers.relu(out)

        # NHWC -> NCHW, contiguous: on the CPU, torch's oneDNN convolution
        # takes the permuted view as channels-last, and its weight gradient
        # of a 1x1 stride-2 conv on such an input is wrong or crashes
        x = x.permute(0, 3, 1, 2).contiguous()
        for i, num_layers in enumerate(block_config):
            block_p, block_s = params[f"denseblock{i + 1}"], state[f"denseblock{i + 1}"]
            for li in range(num_layers):
                lp, ls = block_p[f"layer_{li}"], block_s[f"layer_{li}"]
                out = layers.conv2d(lp["conv1"], bn_relu(lp["norm1"], ls["norm1"], x))
                out = layers.conv2d(lp["conv2"], bn_relu(lp["norm2"], ls["norm2"], out), padding=1)
                x = torch.cat([x, out], dim=1)
            if i != len(block_config) - 1:
                tp, ts = params[f"transition{i + 1}"], state[f"transition{i + 1}"]
                x = layers.avg_pool(layers.conv2d(tp["conv"], bn_relu(tp["norm"], ts["norm"], x)))
        x = layers.global_avg_pool(bn_relu(params["norm5"], state["norm5"], x))
        return layers.linear(params["classifier"], x), state

    return Model(init=init, apply=apply, name="densenet", feature_shape=(features, 1, 1))
