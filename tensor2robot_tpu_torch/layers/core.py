"""Core network building blocks (port of `layers/core.py`).

Conventions kept from the flax original: parameters are float32
masters, and each layer casts its input and its parameters to the
compute `dtype` in the forward pass (flax's `dtype=`). A dense layer
is the product in `dtype` followed by the bias add in `dtype`, the
order flax's `nn.Dense` uses.

Dropout (flax's `nn.Dropout`): in train mode each element is kept with
probability 1 − rate and scaled by 1 / (1 − rate), `where(keep, x /
keep_prob, 0)`; in eval mode it is the identity. The masks come from an
explicit `torch.Generator`, the one the enclosing `random_stream` holds
(the model's step enters it); a dropout layer in train mode outside one
raises. torch's streams cannot match threefry (ROADMAP trap 5): parity
with JAX injects the masks (`draw_keep`).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Optional, Sequence

import torch
from torch import nn

from tensor2robot_tpu_torch.specs import TensorSpecStruct

_STREAM = threading.local()


@contextlib.contextmanager
def random_stream(generator: Optional[torch.Generator]
                  ) -> Iterator[Optional[torch.Generator]]:
  """Makes `generator` the one dropout layers draw from in the body (on
  this thread)."""
  previous = getattr(_STREAM, "generator", None)
  _STREAM.generator = generator
  try:
    yield generator
  finally:
    _STREAM.generator = previous


def draw_keep(shape, keep_prob: float, device) -> torch.Tensor:
  """A bool keep mask of `shape`, each element kept with probability
  `keep_prob`, drawn from the enclosing `random_stream`'s generator."""
  generator = getattr(_STREAM, "generator", None)
  if generator is None:
    raise RuntimeError(
        "dropout in train mode draws from an explicit generator: run the "
        "network inside layers.core.random_stream(generator) (the "
        "model's train step does)")
  return torch.rand(shape, generator=generator, device=device) < keep_prob


def dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
  """flax's `nn.Dropout(rate, deterministic=not train)`."""
  if not train or rate <= 0.0:
    return x
  keep_prob = 1.0 - rate
  keep = draw_keep(x.shape, keep_prob, x.device)
  return torch.where(keep, x / keep_prob, 0.0)


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
  `activate_final` the last layer is followed by a relu too; with
  `dropout_rate` each activation is followed by dropout in train mode."""

  def __init__(self,
               in_features: int,
               hidden_sizes: Sequence[int],
               output_size: Optional[int] = None,
               dtype: torch.dtype = torch.float32,
               activate_final: bool = False,
               dropout_rate: float = 0.0):
    super().__init__()
    sizes = list(hidden_sizes)
    if output_size is not None:
      sizes.append(output_size)
    self.dtype = dtype
    self.activate_final = activate_final
    self.dropout_rate = dropout_rate
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
        x = dropout(torch.relu(x), self.dropout_rate, self.training)
    return x.float()
