"""Model base and carried state (port of `models/abstract_model.py`).

This slice ports the inference half: `TrainState` as the holder of a
network's parameters and batch statistics (no optimizer yet), and the
model base's `device_dtype` / `create_network` / `predict_step` (the
JAX default preprocessor is the no-op one, so there is none to port). The JAX package keeps
params outside its stateless flax modules; the port does the same, so
a state can be hot-swapped atomically while a dispatch still runs on
the old one. `AbstractT2RModel.bind(state)` returns a module whose
tensors ARE the state's (no copy), built once per state object.
"""

from __future__ import annotations

import abc
import dataclasses
import math
import weakref
from typing import Any, Dict, Optional

import torch
from torch import nn

from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.device import DeviceLike, resolve_device
from tensor2robot_tpu_torch.specs import TensorSpecStruct


@dataclasses.dataclass(frozen=True, eq=False)
class TrainState:
  """Carried state: step counter, params and batch statistics.

  `params` and `batch_stats` are flat dicts keyed by the network's
  parameter and buffer names (torch `state_dict` keys, e.g.
  ``q_head.dense_0.weight`` or ``torso_bn_0.mean``). Master params are
  float32, as flax params are.
  """

  step: int
  params: Dict[str, torch.Tensor]
  batch_stats: Dict[str, torch.Tensor]
  opt_state: Any = None

  @property
  def variables(self) -> Dict[str, torch.Tensor]:
    return {**self.params, **self.batch_stats}

  @property
  def nbytes(self) -> int:
    return sum(t.numel() * t.element_size()
               for t in self.variables.values())

  def to(self, device) -> "TrainState":
    move = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
    return dataclasses.replace(self, params=move(self.params),
                               batch_stats=move(self.batch_stats))

  @classmethod
  def from_network(cls, network: nn.Module, step: int = 0) -> "TrainState":
    return cls(step=step,
               params={k: v.detach()
                       for k, v in network.named_parameters()},
               batch_stats={k: v.detach()
                            for k, v in network.named_buffers()})


def init_parameters(network: nn.Module, generator: torch.Generator) -> None:
  """flax's default init, drawn from `generator`: lecun-normal
  (truncated normal, fan-in) conv and dense kernels, zero biases.
  A module with raw params of its own (learned positions) draws them
  in its `init_raw_parameters(generator)`."""
  for module in network.modules():
    if hasattr(module, "init_raw_parameters"):
      module.init_raw_parameters(generator)
    if isinstance(module, (nn.Conv2d, nn.Linear)):
      fan_in = module.weight[0].numel()
      # 0.8796 = std of a unit normal truncated to [-2, 2].
      std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
      with torch.no_grad():
        nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        if module.bias is not None:
          module.bias.zero_()


class AbstractT2RModel(abc.ABC):
  """Base class for models: specs + network construction."""

  def __init__(self, device_dtype: torch.dtype = torch.float32):
    self._device_dtype = device_dtype
    self._bound: "weakref.WeakKeyDictionary[TrainState, nn.Module]" = (
        weakref.WeakKeyDictionary())

  @abc.abstractmethod
  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    ...

  @abc.abstractmethod
  def get_label_specification(
      self, mode: Mode) -> Optional[TensorSpecStruct]:
    ...

  @property
  def device_dtype(self) -> torch.dtype:
    """Compute dtype the network casts to in its forward pass."""
    return self._device_dtype

  @abc.abstractmethod
  def create_network(self) -> nn.Module:
    ...

  def create_inference_state(self, seed: int = 0,
                             device: DeviceLike = None) -> TrainState:
    """Fresh params + batch stats from `seed` (no optimizer state), on
    `device` (None = the CUDA card; raises without one)."""
    device = resolve_device(device)
    network = self.create_network()
    init_parameters(network, torch.Generator().manual_seed(seed))
    return TrainState.from_network(network).to(device)

  def predict_step(self, state: TrainState, features) -> Any:
    """The bound network's outputs on `features`, without autograd."""
    with torch.inference_mode():
      return self.bind(state)(features)

  def bind(self, state: TrainState) -> nn.Module:
    """The network in eval mode over `state`'s own tensors.

    Built on the meta device and assigned the state's tensors, so no
    parameter is copied or initialized; cached per state object (a
    swapped-in state gets its own module, the old one stays intact for
    dispatches still running on it).
    """
    network = self._bound.get(state)
    if network is None:
      with torch.device("meta"):
        network = self.create_network()
      network.load_state_dict(state.variables, strict=True, assign=True)
      network.eval()
      self._bound[state] = network
    return network
