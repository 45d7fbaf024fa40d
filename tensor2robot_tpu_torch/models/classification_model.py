"""Classification model base (port of `models/classification_model.py`).

Softmax cross-entropy against integer labels, and the accuracy of the
argmax (ties to the lower class, as `jnp.argmax`). The network is an MLP
over all float features under the name ``MLP_0``, flax's path for the
JAX network's inner `MLP`, so converted weights map; `dropout_rate` puts
dropout after each hidden activation in train mode (`layers.core`).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.layers.core import MLP
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.models.regression_model import float_feature_width

LOGITS = "logits"


class _Logits(nn.Module):
  """`{LOGITS: MLP(features)}` (f32 logits)."""

  def __init__(self, mlp: MLP):
    super().__init__()
    self.MLP_0 = mlp

  def forward(self, features) -> Dict[str, torch.Tensor]:
    return {LOGITS: self.MLP_0(features)}


@gin.configurable
class ClassificationModel(AbstractT2RModel):
  """Softmax cross-entropy against integer labels; tracks accuracy."""

  def __init__(self,
               num_classes: int = 2,
               hidden_sizes: Sequence[int] = (64, 64),
               label_key: str = "label",
               dropout_rate: float = 0.0,
               **kwargs):
    super().__init__(**kwargs)
    self._num_classes = num_classes
    self._hidden_sizes = tuple(hidden_sizes)
    self._label_key = label_key
    self._dropout_rate = dropout_rate

  @property
  def num_classes(self) -> int:
    return self._num_classes

  def create_network(self) -> nn.Module:
    width = float_feature_width(self.get_feature_specification(Mode.TRAIN))
    return _Logits(MLP(width, self._hidden_sizes,
                       output_size=self._num_classes,
                       dtype=self.device_dtype,
                       dropout_rate=self._dropout_rate))

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = outputs[LOGITS].float()
    target = labels[self._label_key].reshape(logits.shape[0]).long()
    loss = F.cross_entropy(logits, target)
    accuracy = (logits.argmax(dim=-1) == target).float().mean()
    return loss, {"cross_entropy": loss, "accuracy": accuracy}
