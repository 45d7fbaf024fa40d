"""ResNet with optional FiLM conditioning (port of `layers/resnet.py`).

NHWC at the public functions, parameters under the flax names
(``conv_init``, ``bn_init``, ``stage{i}_block{j}.{conv1, bn1, conv2,
bn2, proj, bn_proj, film}``), so converted flax weights give the same
numbers. What the flax original does that torch's defaults do not:
- ``conv_init`` is 7×7 / 2 with explicit (3, 3) padding;
- the stem's 3×3 / 2 max pool is SAME: XLA pads (0, 1) on an even input
  and (1, 1) on an odd one, with −inf (`max_pool_same`);
  `MaxPool2d(padding=1)` pads (1, 1) always;
- every other conv is SAME the XLA way (`conv_same`: (0, 1) at stride 2
  on an even input);
- the last batch norm of each block starts at scale 0 (``bn2``, ``bn3``),
  so a fresh block is the identity plus its shortcut;
- batch norm computes in f32 and casts to the compute dtype;
- the spatial mean accumulates in f32 and rounds once to the compute
  dtype; the pooled vector (and the spatial map) return as f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.vision_layers import (
    FiLM,
    BatchNorm,
    _same_pads,
    conv_same,
    spatial_mean,
)
from tensor2robot_tpu_torch.layers.core import dense


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
  """flax `nn.max_pool(x, (k, k), (s, s), "SAME")` on NHWC `x`: XLA's
  SAME pads, filled with −inf."""
  ph = _same_pads(x.shape[1], window, stride)
  pw = _same_pads(x.shape[2], window, stride)
  xt = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
             value=float("-inf"))
  return F.max_pool2d(xt, window, stride).permute(0, 2, 3, 1)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          bias: bool = False) -> nn.Conv2d:
  return nn.Conv2d(cin, cout, k, stride=stride, bias=bias)


class ResNetBlock(nn.Module):
  """Basic 3×3 + 3×3 residual block (resnet-18/34)."""

  expansion = 1

  def __init__(self, in_channels: int, filters: int, stride: int = 1,
               use_film: bool = False, conditioning_size: int = 0,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.conv1 = _conv(in_channels, filters, 3, stride)
    self.bn1 = BatchNorm(filters, dtype)
    self.conv2 = _conv(filters, filters, 3)
    self.bn2 = BatchNorm(filters, dtype)
    with torch.no_grad():
      self.bn2.scale.zero_()
    if use_film:
      self.film = FiLM(conditioning_size, filters, dtype)
    self.projects = in_channels != filters or stride != 1
    if self.projects:
      self.proj = _conv(in_channels, filters, 1, stride)
      self.bn_proj = BatchNorm(filters, dtype)

  def forward(self, x: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.relu(self.bn1(conv_same(self.conv1, x, self.dtype)))
    y = self.bn2(conv_same(self.conv2, y, self.dtype))
    return _finish(self, x, y, conditioning)


class BottleneckBlock(nn.Module):
  """1×1 − 3×3 − 1×1 bottleneck block (resnet-50)."""

  expansion = 4

  def __init__(self, in_channels: int, filters: int, stride: int = 1,
               use_film: bool = False, conditioning_size: int = 0,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    out = filters * 4
    self.conv1 = _conv(in_channels, filters, 1)
    self.bn1 = BatchNorm(filters, dtype)
    self.conv2 = _conv(filters, filters, 3, stride)
    self.bn2 = BatchNorm(filters, dtype)
    self.conv3 = _conv(filters, out, 1)
    self.bn3 = BatchNorm(out, dtype)
    with torch.no_grad():
      self.bn3.scale.zero_()
    if use_film:
      self.film = FiLM(conditioning_size, out, dtype)
    self.projects = in_channels != out or stride != 1
    if self.projects:
      self.proj = _conv(in_channels, out, 1, stride)
      self.bn_proj = BatchNorm(out, dtype)

  def forward(self, x: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.relu(self.bn1(conv_same(self.conv1, x, self.dtype)))
    y = torch.relu(self.bn2(conv_same(self.conv2, y, self.dtype)))
    y = self.bn3(conv_same(self.conv3, y, self.dtype))
    return _finish(self, x, y, conditioning)


def _finish(block, x, y, conditioning):
  """FiLM (when built and given a conditioning), the shortcut, relu."""
  if hasattr(block, "film") and conditioning is not None:
    y = block.film(y, conditioning)
  residual = x
  if block.projects:
    residual = block.bn_proj(conv_same(block.proj, x, block.dtype))
  return torch.relu(residual + y)


class ResNet(nn.Module):
  """Configurable ResNet over NHWC images. `num_classes=None` returns
  the pooled features; `return_spatial=True` also the last feature map
  (B, H, W, C), both f32. `use_film=True` builds a FiLM layer in every
  block, fed a (B, conditioning_size) vector at call time (torch needs
  its width up front; flax reads it from the first call). The flax
  module leaves FiLM out when no conditioning is passed; so does this
  one, whatever it built."""

  def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
               num_filters: int = 64, block_cls=ResNetBlock,
               num_classes: Optional[int] = None, use_film: bool = False,
               return_spatial: bool = False, in_channels: int = 3,
               conditioning_size: int = 0,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    if use_film and conditioning_size <= 0:
      raise ValueError("use_film=True needs conditioning_size")
    self.stage_sizes = tuple(stage_sizes)
    self.return_spatial = return_spatial
    self.dtype = dtype
    self.conv_init = _conv(in_channels, num_filters, 7, 2)
    self.bn_init = BatchNorm(num_filters, dtype)
    channels = num_filters
    self.block_names = []
    for i, count in enumerate(self.stage_sizes):
      for j in range(count):
        filters = num_filters * 2 ** i
        name = f"stage{i}_block{j}"
        self.add_module(name, block_cls(
            channels, filters, stride=2 if i > 0 and j == 0 else 1,
            use_film=use_film, conditioning_size=conditioning_size,
            dtype=dtype))
        self.block_names.append(name)
        channels = filters * block_cls.expansion
    self.out_channels = channels
    if num_classes is not None:
      self.head = nn.Linear(channels, num_classes)

  def forward(self, images: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None):
    x = images.to(self.dtype)
    x = F.pad(x.permute(0, 3, 1, 2), (3, 3, 3, 3))
    x = F.conv2d(x.contiguous(memory_format=torch.channels_last),
                 self.conv_init.weight.to(self.dtype), stride=2)
    x = torch.relu(self.bn_init(x.permute(0, 2, 3, 1)))
    x = max_pool_same(x)
    for name in self.block_names:
      x = getattr(self, name)(x, conditioning)
    spatial = x
    x = spatial_mean(x)
    if hasattr(self, "head"):
      x = dense(self.head, x, self.dtype)
    if self.return_spatial:
      return x.float(), spatial.float()
    return x.float()


def resnet18(**kwargs) -> ResNet:
  return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=ResNetBlock, **kwargs)


def resnet34(**kwargs) -> ResNet:
  return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=ResNetBlock, **kwargs)


def resnet50(**kwargs) -> ResNet:
  return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock,
                **kwargs)
