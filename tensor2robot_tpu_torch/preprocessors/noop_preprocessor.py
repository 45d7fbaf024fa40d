"""Identity preprocessor (port of `preprocessors/noop_preprocessor.py`)."""

from __future__ import annotations

from typing import Optional

import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.preprocessors.abstract_preprocessor import (
    AbstractPreprocessor,
)
from tensor2robot_tpu_torch.specs.tensorspec import TensorSpecStruct


@gin.configurable
class NoOpPreprocessor(AbstractPreprocessor):
  """Wire specs == model specs; `preprocess` returns its arguments (it
  launches nothing)."""

  def get_in_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    return self.model_feature_specification(mode)

  def get_in_label_specification(self, mode: Mode):
    return self.model_label_specification(mode)

  def get_out_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    return self.model_feature_specification(mode)

  def get_out_label_specification(self, mode: Mode):
    return self.model_label_specification(mode)

  def preprocess(self, features, labels, mode: Mode,
                 generator: Optional[torch.Generator] = None):
    return features, labels
