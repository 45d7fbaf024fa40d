"""Network building blocks."""

from tensor2robot_tpu_torch.layers.core import MLP, dense, flatten_and_concat
from tensor2robot_tpu_torch.layers.transformer import CausalTransformer
from tensor2robot_tpu_torch.layers.vision_layers import (
    ConvTower,
    ImageEncoder,
    SpatialSoftmax,
    spatial_softmax,
)

__all__ = ["CausalTransformer", "ConvTower", "ImageEncoder", "MLP",
           "SpatialSoftmax", "dense", "flatten_and_concat",
           "spatial_softmax"]
