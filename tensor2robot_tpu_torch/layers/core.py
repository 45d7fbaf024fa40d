"""Core network building blocks (port of `layers/core.py`).

Conventions kept from the flax original: parameters are float32
masters, and each layer casts its input and its parameters to the
compute `dtype` in the forward pass (flax's `dtype=`). A dense layer
is the product in `dtype` followed by the bias add in `dtype`, the
order flax's `nn.Dense` uses.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from tensor2robot_tpu_torch.specs import TensorSpecStruct


def dense(linear: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
  """flax `nn.Dense(dtype=dtype)` on a torch Linear's parameters."""
  y = x.to(dtype) @ linear.weight.to(dtype).t()
  if linear.bias is not None:
    y = y + linear.bias.to(dtype)
  return y


def flatten_and_concat(features: Any,
                       keys: Optional[Sequence[str]] = None
                       ) -> torch.Tensor:
  """Flattens selected (or all floating) leaves and concats on last axis."""
  if isinstance(features, (dict, TensorSpecStruct)):
    flat = (features.to_flat_dict() if isinstance(features, TensorSpecStruct)
            else dict(features))
    if keys is not None:
      leaves = [flat[k] for k in keys]
    else:
      leaves = [v for v in flat.values() if v.is_floating_point()]
  else:
    leaves = [features]
  batch = leaves[0].shape[0]
  return torch.cat([leaf.reshape(batch, -1) for leaf in leaves], dim=-1)


class MLP(nn.Module):
  """Plain relu MLP; parameters named ``dense_{i}`` as in flax. With
  `activate_final` the last layer is followed by a relu too."""

  def __init__(self,
               in_features: int,
               hidden_sizes: Sequence[int],
               output_size: Optional[int] = None,
               dtype: torch.dtype = torch.float32,
               activate_final: bool = False):
    super().__init__()
    sizes = list(hidden_sizes)
    if output_size is not None:
      sizes.append(output_size)
    self.dtype = dtype
    self.activate_final = activate_final
    self.num_layers = len(sizes)
    for i, (fan_in, fan_out) in enumerate(zip([in_features] + sizes[:-1],
                                              sizes)):
      self.add_module(f"dense_{i}", nn.Linear(fan_in, fan_out))

  def layers(self):
    return [getattr(self, f"dense_{i}") for i in range(self.num_layers)]

  def forward(self, features) -> torch.Tensor:
    x = flatten_and_concat(features).to(self.dtype)
    for i, layer in enumerate(self.layers()):
      x = dense(layer, x, self.dtype)
      if i < self.num_layers - 1 or self.activate_final:
        x = torch.relu(x)
    return x.float()
