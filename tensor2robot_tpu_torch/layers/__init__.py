"""Network building blocks."""

from tensor2robot_tpu_torch.layers.core import MLP, dense, flatten_and_concat
from tensor2robot_tpu_torch.layers.resnet import (
    BottleneckBlock,
    ResNet,
    ResNetBlock,
    max_pool_same,
    resnet18,
    resnet34,
    resnet50,
)
from tensor2robot_tpu_torch.layers.transformer import CausalTransformer
from tensor2robot_tpu_torch.layers.vision_layers import (
    ConvTower,
    FiLM,
    ImageEncoder,
    SpatialSoftmax,
    spatial_softmax,
)

__all__ = ["BottleneckBlock", "CausalTransformer", "ConvTower", "FiLM",
           "ImageEncoder", "MLP", "ResNet", "ResNetBlock", "SpatialSoftmax",
           "dense", "flatten_and_concat", "max_pool_same", "resnet18",
           "resnet34", "resnet50", "spatial_softmax"]
