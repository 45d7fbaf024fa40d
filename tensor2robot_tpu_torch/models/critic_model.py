"""Critic (Q-function) model base (port of `models/critic_model.py`).

State + action → scalar Q, trained against a Bellman target label: MSE,
or with `sigmoid_q=True` the sigmoid cross-entropy on the logit in its
stable form max(x, 0) − x·t + log1p(exp(−|x|)), which is better
conditioned than MSE near saturation. The default network is an MLP
over every float feature, flattened and concatenated in the feature
struct's key order.
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
from tensor2robot_tpu_torch.models.regression_model import float_feature_width

Q_VALUE = "q_value"


class _QNet(nn.Module):
  """flatten_and_concat(float features) → MLP → {Q_VALUE: [B]}. The MLP
  is named ``MLP_0``, flax's auto-name, so converted weights map."""

  def __init__(self, in_features: int, hidden: Sequence[int],
               dtype: torch.dtype):
    super().__init__()
    self.add_module("MLP_0", MLP(in_features, hidden, output_size=1,
                                 dtype=dtype))

  def forward(self, features) -> Dict[str, torch.Tensor]:
    return {Q_VALUE: getattr(self, "MLP_0")(features)[..., 0]}


@gin.configurable
class CriticModel(AbstractT2RModel):
  """Q(state, action) regression against a target-Q label."""

  def __init__(self,
               hidden_sizes: Sequence[int] = (256, 256),
               action_key: str = "action",
               target_q_key: str = "target_q",
               sigmoid_q: bool = False,
               **kwargs):
    super().__init__(**kwargs)
    self._hidden_sizes = tuple(hidden_sizes)
    self._action_key = action_key
    self._target_q_key = target_q_key
    self._sigmoid_q = sigmoid_q

  @property
  def action_key(self) -> str:
    return self._action_key

  @property
  def sigmoid_q(self) -> bool:
    return self._sigmoid_q

  @property
  def action_dim(self) -> int:
    """The action's width, from the TRAIN feature spec under
    `action_key` (what `QTOptLearner`'s CEM samples)."""
    spec = self.get_feature_specification(Mode.TRAIN).to_flat_dict()[
        self._action_key]
    return int(np.prod(spec.shape))

  def create_network(self) -> nn.Module:
    """The default MLP critic; torch needs its input width up front, so
    it is summed from the TRAIN feature spec's float leaves."""
    width = float_feature_width(self.get_feature_specification(Mode.TRAIN))
    return _QNet(width, self._hidden_sizes, self.device_dtype)

  def q_from_outputs(self, outputs) -> torch.Tensor:
    q = outputs[Q_VALUE]
    return torch.sigmoid(q) if self._sigmoid_q else q

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    raw = outputs[Q_VALUE]
    target = labels[self._target_q_key].reshape(raw.shape).to(raw.dtype)
    if self._sigmoid_q:
      loss = torch.mean(torch.clamp_min(raw, 0) - raw * target
                        + torch.log1p(torch.exp(-torch.abs(raw))))
      q = torch.sigmoid(raw)
    else:
      loss = torch.mean(torch.square(raw - target))
      q = raw
    return loss, {"q_loss": loss, "q_mean": torch.mean(q),
                  "target_q_mean": torch.mean(target)}
