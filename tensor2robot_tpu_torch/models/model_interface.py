"""The minimal model contract the trainer and predictors depend on
(port of `models/model_interface.py`).

Preprocessors live on `AbstractT2RModel` (`preprocessor`), as in the
JAX package; the steps take no rng (no stochastic layers are ported); a
state is made from an integer seed on a device.
"""

from __future__ import annotations

import abc
from typing import Any, Optional

from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.specs import TensorSpecStruct


class ModelInterface(abc.ABC):
  """What the orchestration layer needs from any model."""

  @abc.abstractmethod
  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    """Model-side feature specs."""

  @abc.abstractmethod
  def get_label_specification(
      self, mode: Mode) -> Optional[TensorSpecStruct]:
    """Model-side label specs."""

  @abc.abstractmethod
  def create_train_state(self, seed: int = 0, device: Any = None):
    """Initializes parameters + optimizer state on `device`."""

  @abc.abstractmethod
  def train_step(self, state, features, labels):
    """(state, batch) -> (new state, metrics); the old state untouched."""

  @abc.abstractmethod
  def eval_step(self, state, features, labels):
    """(state, batch) -> metrics."""

  @abc.abstractmethod
  def predict_step(self, state, features):
    """(state, features) -> outputs (the serving path)."""
