"""Mock models for framework tests (port of `utils/mocks.py`).

`MockT2RModel`, `MockClassificationModel` and `MockCriticModel` let the
trainer's tests run without real data or real networks, with the JAX
package's specs and network names, so flax weights carry across
(`models.convert`).
"""

from __future__ import annotations

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.models.classification_model import (
    ClassificationModel,
)
from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.models.regression_model import RegressionModel
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct


@gin.configurable
class MockT2RModel(RegressionModel):
  """Tiny regression model: {x: (3,)} → target (2,). CPU-instant."""

  def __init__(self, output_size: int = 2, hidden_sizes=(8,), **kwargs):
    super().__init__(output_size=output_size, hidden_sizes=hidden_sizes,
                     **kwargs)

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.x = ExtendedTensorSpec(shape=(3,), dtype=np.float32, name="x")
    return st

  def get_label_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.target = ExtendedTensorSpec(shape=(2,), dtype=np.float32,
                                   name="target")
    return st


@gin.configurable
class MockClassificationModel(ClassificationModel):
  """Tiny classifier: {x: (4,)} → label in [0, num_classes)."""

  def __init__(self, num_classes: int = 3, hidden_sizes=(8,), **kwargs):
    super().__init__(num_classes=num_classes, hidden_sizes=hidden_sizes,
                     **kwargs)

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.x = ExtendedTensorSpec(shape=(4,), dtype=np.float32, name="x")
    return st

  def get_label_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.label = ExtendedTensorSpec(shape=(1,), dtype=np.int64,
                                  name="label")
    return st


@gin.configurable
class MockCriticModel(CriticModel):
  """Tiny critic: {state: (4,), action: (2,)} → target_q scalar."""

  def __init__(self, hidden_sizes=(8,), **kwargs):
    super().__init__(hidden_sizes=hidden_sizes, **kwargs)

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.state = ExtendedTensorSpec(shape=(4,), dtype=np.float32,
                                  name="state")
    st.action = ExtendedTensorSpec(shape=(2,), dtype=np.float32,
                                   name="action")
    return st

  def get_label_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.target_q = ExtendedTensorSpec(shape=(1,), dtype=np.float32,
                                     name="target_q")
    return st
