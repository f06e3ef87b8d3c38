"""Backbone dispatch by name (JAX package ``models/registry.py``).

``vgg`` -> Conv-4 VGG (64 filters, 4 stages, pad, max-pool);
``resnet-4/8/12`` -> stem-less ResNet with (1,1,1,1)/(2,2,2,2)/(3,3,3,3)
blocks; ``densenet-8/12`` -> stem-less DenseNet-BC with (2,)*4/(3,)*4
blocks.
"""

from typing import Tuple

from .densenet import build_densenet
from .model import Model
from .resnet import build_resnet
from .vgg import build_vgg

_RESNET_BLOCKS = {"resnet-4": (1, 1, 1, 1), "resnet-8": (2, 2, 2, 2), "resnet-12": (3, 3, 3, 3)}
_DENSENET_BLOCKS = {"densenet-8": (2, 2, 2, 2), "densenet-12": (3, 3, 3, 3)}

MODEL_NAMES = ("vgg",) + tuple(_RESNET_BLOCKS) + tuple(_DENSENET_BLOCKS)


def build_model(
    net: str,
    image_shape: Tuple[int, int, int],
    num_classes: int,
    reduce_window_pool: bool = False,
) -> Model:
    """``image_shape`` is (H, W, C), as in the JAX package.
    ``reduce_window_pool`` (``Config.max_pool_reduce_window``) applies to
    the VGG's max-pools; the other backbones pool by averages only."""
    if net == "vgg":
        return build_vgg(
            image_shape,
            num_classes,
            num_stages=4,
            cnn_num_filters=64,
            max_pooling=True,
            conv_padding=True,
            norm_layer="batch_norm",
            reduce_window_pool=reduce_window_pool,
        )
    if net in _RESNET_BLOCKS:
        return build_resnet(image_shape, num_classes, blocks_per_stage=_RESNET_BLOCKS[net])
    if net in _DENSENET_BLOCKS:
        return build_densenet(image_shape, num_classes, block_config=_DENSENET_BLOCKS[net])
    raise ValueError(f"unknown net {net!r}; expected one of {MODEL_NAMES}")
