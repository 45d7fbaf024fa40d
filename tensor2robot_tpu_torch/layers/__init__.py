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
from tensor2robot_tpu_torch.layers.mdn import (
    MDNHead,
    MDNParams,
    mdn_log_prob,
    mdn_loss,
    mdn_mean,
    mdn_mode,
    mdn_sample,
)
from tensor2robot_tpu_torch.layers.snail import (
    AttentionBlock,
    CausalConv1D,
    DenseBlock,
    SNAIL,
    TCBlock,
)
from tensor2robot_tpu_torch.layers.pipelined_transformer import (
    PipelinedCausalTransformer,
)
from tensor2robot_tpu_torch.layers.transformer import CausalTransformer
from tensor2robot_tpu_torch.layers.vision_layers import (
    ConvTower,
    FiLM,
    ImageEncoder,
    SpatialSoftmax,
    spatial_softmax,
)

__all__ = ["AttentionBlock", "BottleneckBlock", "CausalConv1D",
           "CausalTransformer", "ConvTower", "DenseBlock", "FiLM",
           "ImageEncoder", "MDNHead", "MDNParams", "MLP",
           "PipelinedCausalTransformer", "ResNet",
           "ResNetBlock", "SNAIL", "SpatialSoftmax", "TCBlock", "dense",
           "flatten_and_concat", "max_pool_same", "mdn_log_prob", "mdn_loss",
           "mdn_mean", "mdn_mode", "mdn_sample", "resnet18", "resnet34",
           "resnet50", "spatial_softmax"]
