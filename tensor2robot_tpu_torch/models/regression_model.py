"""Regression model base (port of `models/regression_model.py`).

Subclasses declare specs; the default network is an MLP over all float
features, the default loss MSE against `labels[label_key]`. The network
returns a dict with key `inference_output` (the serving signature's
name). The MLP sits under the name ``backbone``, flax's path for the
JAX network's `_DictOutput(backbone=MLP(...))`, so converted weights map.
`dropout_rate` puts dropout after each hidden activation in train mode
(`layers.core.dropout`, masks from the model's generator).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.layers.core import MLP
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel

INFERENCE_OUTPUT = "inference_output"


class _DictOutput(nn.Module):
  """An MLP whose output is `{INFERENCE_OUTPUT: ...}`."""

  def __init__(self, backbone: nn.Module):
    super().__init__()
    self.backbone = backbone

  def forward(self, features) -> Dict[str, torch.Tensor]:
    return {INFERENCE_OUTPUT: self.backbone(features)}


def float_feature_width(specs) -> int:
  """Summed widths of a spec struct's float leaves (an MLP's input)."""
  return sum(int(np.prod(s.shape)) for s in specs.to_flat_dict().values()
             if s.dtype is torch.bfloat16 or s.dtype.kind == "f")


@gin.configurable
class RegressionModel(AbstractT2RModel):
  """MSE regression against a declared label key."""

  def __init__(self,
               output_size: int = 1,
               hidden_sizes: Sequence[int] = (64, 64),
               label_key: str = "target",
               dropout_rate: float = 0.0,
               **kwargs):
    super().__init__(**kwargs)
    self._output_size = output_size
    self._hidden_sizes = tuple(hidden_sizes)
    self._label_key = label_key
    self._dropout_rate = dropout_rate

  @property
  def label_key(self) -> str:
    return self._label_key

  def create_network(self) -> nn.Module:
    width = float_feature_width(self.get_feature_specification(Mode.TRAIN))
    return _DictOutput(MLP(width, self._hidden_sizes,
                           output_size=self._output_size,
                           dtype=self.device_dtype,
                           dropout_rate=self._dropout_rate))

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    prediction = outputs[INFERENCE_OUTPUT]
    target = labels[self._label_key]
    target = target.reshape(prediction.shape).to(prediction.dtype)
    loss = torch.mean(torch.square(prediction - target))
    return loss, {"mse": loss,
                  "mae": torch.mean(torch.abs(prediction - target))}
