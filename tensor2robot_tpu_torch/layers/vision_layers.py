"""Vision building blocks (port of `layers/vision_layers.py`).

Conv towers, spatial-softmax keypoint pooling, FiLM and the image
encoder, in the JAX package's NHWC layout at every public function, so
converted flax weights give the same numbers. Parameter names are the
flax names (``tower.conv_0``, ``ssoftmax.log_temperature``, ``proj``,
``film.film_proj``).

Shared here by every family that convolves: XLA's SAME padding
(`conv_same`), flax batch norm in eval and train mode (`BatchNorm`,
`collect_batch_stats`) and the f32 spatial mean. Convolutions pad SAME
the way XLA does ((0, 1) for a 3×3 stride-2 conv on an even input):
torch refuses padding='same' at stride 2, and symmetric padding would
shift every tap.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch.layers.core import dense

_BN_EPS = 1e-5  # flax nn.BatchNorm default


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
  """XLA's SAME padding (low, high) for one spatial dim."""
  total = max((-(-n // s) - 1) * s + k - n, 0)
  return total // 2, total - total // 2


def conv_same(conv: nn.Conv2d, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
  """flax `nn.Conv(padding='SAME', dtype=dtype)` on NHWC `x`."""
  y = conv2d_same(x, conv.weight.to(dtype), conv.stride, dtype)
  if conv.bias is not None:
    y = y + conv.bias.to(dtype)
  return y


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride,
                dtype: torch.dtype) -> torch.Tensor:
  """`lax.conv_general_dilated(x, w, stride, "SAME")` on NHWC `x` with
  an OIHW `weight` (already in `dtype`), no bias: NHWC out."""
  (kh, kw), (sh, sw) = weight.shape[2:], stride
  ph = _same_pads(x.shape[1], kh, sh)
  pw = _same_pads(x.shape[2], kw, sw)
  xt = F.pad(x.to(dtype).permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
  xt = xt.contiguous(memory_format=torch.channels_last)
  return F.conv2d(xt, weight, stride=(sh, sw)).permute(0, 2, 3, 1)


def spatial_mean(x: torch.Tensor) -> torch.Tensor:
  """`jnp.mean(x, axis=(1, 2))`: f32 accumulation, one rounding."""
  return x.float().mean(dim=(1, 2)).to(x.dtype)


class BatchNorm(nn.Module):
  """flax `nn.BatchNorm(momentum=0.9)` over the last (channel) axis.

  Parameter/buffer names are flax's: ``scale``/``bias`` params and
  ``mean``/``var`` batch statistics. In eval mode it normalizes with the
  running statistics. In train mode (`use_running_average=False`) it
  normalizes with the batch's own: mean and biased variance over every
  axis but the last, in f32 from the compute-dtype input, as
  E[x²] − E[x]² floored at 0 (flax's `use_fast_variance`). The running
  statistics it would move to, 0.9·old + 0.1·batch in f32, are left in
  `self.update` (and the buffers are never written): the caller's state
  stays as it was, as under JAX (`collect_batch_stats`).
  """

  MOMENTUM = 0.9

  def __init__(self, features: int, dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.scale = nn.Parameter(torch.ones(features))
    self.bias = nn.Parameter(torch.zeros(features))
    self.register_buffer("mean", torch.zeros(features))
    self.register_buffer("var", torch.ones(features))
    self.update: Optional[Dict[str, torch.Tensor]] = None

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if not self.training:
      return _normalize(x, self.mean, self.var, self.scale, self.bias,
                        self.dtype)
    xf = x.to(self.dtype).float()
    axes = tuple(range(xf.dim() - 1))
    mean = xf.mean(dim=axes)
    var = torch.clamp_min((xf * xf).mean(dim=axes) - mean * mean, 0.0)
    # The running statistics carry no gradient (flax returns them as
    # mutated state, outside the differentiated loss).
    m = self.MOMENTUM
    self.update = {"mean": m * self.mean + (1 - m) * mean.detach(),
                   "var": m * self.var + (1 - m) * var.detach()}
    return _normalize(xf, mean, var, self.scale, self.bias, self.dtype)


def _normalize(x, mean, var, scale, bias, dtype) -> torch.Tensor:
  """flax `_normalize`: (x − mean) · (rsqrt(var + eps) · scale) + bias,
  all in f32, then the cast to the compute dtype."""
  mul = torch.rsqrt(var + _BN_EPS) * scale
  return ((x.float() - mean) * mul + bias).to(dtype)


def collect_batch_stats(network: nn.Module) -> Dict[str, torch.Tensor]:
  """The running statistics the last train-mode forward of `network`
  moved to, keyed like its buffers (``head_bn_0.mean``); clears them."""
  out = {}
  for name, module in network.named_modules():
    if isinstance(module, BatchNorm) and module.update is not None:
      for key, value in module.update.items():
        out[f"{name}.{key}"] = value
      module.update = None
  return out


class ConvTower(nn.Module):
  """Stack of 3×3 stride-2 SAME conv (+ batch norm) + relu blocks,
  NHWC (flax's default kernel sizes and strides, the only ones used).

  Without batch norm each conv carries a bias (flax `use_bias=not
  use_batch_norm`). Torch needs the input channel count up front.
  """

  def __init__(self, in_channels: int,
               filters: Sequence[int] = (32, 64, 128),
               use_batch_norm: bool = True,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.filters = tuple(filters)
    self.use_batch_norm = use_batch_norm
    self.dtype = dtype
    for i, f in enumerate(self.filters):
      self.add_module(f"conv_{i}", nn.Conv2d(in_channels, f, 3, stride=2,
                                             bias=not use_batch_norm))
      if use_batch_norm:
        self.add_module(f"bn_{i}", BatchNorm(f, dtype))
      in_channels = f

  def forward(self, images: torch.Tensor) -> torch.Tensor:
    x = images.to(self.dtype)
    for i in range(len(self.filters)):
      x = conv_same(getattr(self, f"conv_{i}"), x, self.dtype)
      if self.use_batch_norm:
        x = getattr(self, f"bn_{i}")(x)
      x = torch.relu(x)
    return x


def spatial_softmax(features: torch.Tensor,
                    temperature: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
  """Soft-argmax keypoints: (B, H, W, C) → (B, 2C) expected (x, y).

  f32 logits, softmax over the H·W positions of each channel; all x
  coordinates (along W) come first, then all y coordinates (along H),
  each in [-1, 1].
  """
  b, h, w, c = features.shape
  logits = features.reshape(b, h * w, c).float()
  if temperature is not None:
    logits = logits / temperature
  probs = torch.softmax(logits, dim=1)
  dev = features.device
  xs = torch.linspace(-1.0, 1.0, w, device=dev)
  ys = torch.linspace(-1.0, 1.0, h, device=dev)
  grid_x = xs[None, :].expand(h, w).reshape(h * w)
  grid_y = ys[:, None].expand(h, w).reshape(h * w)
  exp_x = torch.einsum("bpc,p->bc", probs, grid_x)
  exp_y = torch.einsum("bpc,p->bc", probs, grid_y)
  return torch.cat([exp_x, exp_y], dim=-1)


class SpatialSoftmax(nn.Module):
  """`spatial_softmax` with a learnable temperature exp(log_temperature)."""

  def __init__(self):
    super().__init__()
    self.log_temperature = nn.Parameter(torch.zeros(()))

  def forward(self, features: torch.Tensor) -> torch.Tensor:
    return spatial_softmax(features, torch.exp(self.log_temperature))


class FiLM(nn.Module):
  """Feature-wise linear modulation: x · (1 + γ) + β, with (γ, β) the
  two halves of ``film_proj`` (a dense layer, 2C wide) of the
  conditioning vector, broadcast over every axis between the batch and
  the channels; all in the compute dtype. The (1 + γ) form is the
  identity at γ = 0. Torch needs the conditioning width up front."""

  def __init__(self, conditioning_size: int, channels: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.film_proj = nn.Linear(conditioning_size, 2 * channels)

  def forward(self, x: torch.Tensor,
              conditioning: torch.Tensor) -> torch.Tensor:
    gb = dense(self.film_proj, conditioning.to(self.dtype), self.dtype)
    gamma, beta = gb.chunk(2, dim=-1)
    shape = (gamma.shape[0],) + (1,) * (x.dim() - 2) + (gamma.shape[-1],)
    gamma, beta = gamma.reshape(shape), beta.reshape(shape)
    return x * (1.0 + gamma) + beta


class ImageEncoder(nn.Module):
  """ConvTower → [FiLM] → {spatial_softmax | mean | flatten} → dense
  embedding.

  Returns f32, as the flax module does. `flatten` needs the image size
  to size the projection (`image_size`); `film=True` needs the
  conditioning width (`conditioning_size`), and modulates the tower's
  output when `forward` is given a conditioning (as flax, which leaves
  FiLM out without one).
  """

  def __init__(self, in_channels: int = 3,
               filters: Sequence[int] = (32, 64, 128),
               embedding_size: int = 128,
               pooling: str = "spatial_softmax",
               use_batch_norm: bool = True,
               film: bool = False,
               image_size: Optional[int] = None,
               conditioning_size: int = 0,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    if film and conditioning_size <= 0:
      raise ValueError("ImageEncoder(film=True) needs conditioning_size")
    self.pooling = pooling
    self.dtype = dtype
    self.tower = ConvTower(in_channels, filters=filters,
                           use_batch_norm=use_batch_norm, dtype=dtype)
    channels = self.tower.filters[-1]
    if film:
      self.film = FiLM(conditioning_size, channels, dtype)
    if pooling == "spatial_softmax":
      self.ssoftmax = SpatialSoftmax()
      width = 2 * channels
    elif pooling == "mean":
      width = channels
    elif pooling == "flatten":
      if image_size is None:
        raise ValueError("pooling='flatten' needs image_size")
      side = image_size
      for _ in self.tower.filters:
        side = -(-side // 2)
      width = side * side * channels
    else:
      raise ValueError(f"Unknown pooling: {pooling}")
    self.proj = nn.Linear(width, embedding_size)

  def forward(self, images: torch.Tensor,
              conditioning: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = self.tower(images)
    if hasattr(self, "film") and conditioning is not None:
      x = self.film(x, conditioning)
    if self.pooling == "spatial_softmax":
      x = self.ssoftmax(x)
    elif self.pooling == "mean":
      x = spatial_mean(x)
    else:
      x = x.reshape(x.shape[0], -1)
    return dense(self.proj, x, self.dtype).float()
