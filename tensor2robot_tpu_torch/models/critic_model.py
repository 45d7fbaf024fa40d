"""Critic (Q-function) model base (port of `models/critic_model.py`).

The forward parts only: the Q output key, `sigmoid_q` and
`q_from_outputs`. The critic loss comes with the training slice.
"""

from __future__ import annotations

import torch

from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel

Q_VALUE = "q_value"


class CriticModel(AbstractT2RModel):
  """Q(state, action); sigmoid-bounded Q via `sigmoid_q=True`."""

  def __init__(self,
               action_key: str = "action",
               target_q_key: str = "target_q",
               sigmoid_q: bool = False,
               **kwargs):
    super().__init__(**kwargs)
    self._action_key = action_key
    self._target_q_key = target_q_key
    self._sigmoid_q = sigmoid_q

  @property
  def action_key(self) -> str:
    return self._action_key

  @property
  def sigmoid_q(self) -> bool:
    return self._sigmoid_q

  def q_from_outputs(self, outputs) -> torch.Tensor:
    q = outputs[Q_VALUE]
    return torch.sigmoid(q) if self._sigmoid_q else q
