"""QT-Opt grasping critic model (port of `research/qtopt/t2r_models.py`):
specs + network wiring. It trains with `CriticModel`'s sigmoid
cross-entropy and the default `create_optimizer` (Adam at 1e-4)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.models.critic_model import CriticModel
from tensor2robot_tpu_torch.research.qtopt.networks import GraspingQNetwork
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct


@gin.configurable
class GraspingQModel(CriticModel):
  """Q(image, action) with sigmoid grasp-success head.

  Wire spec: uint8 camera image + float action + optional extra float
  state vectors declared via `extra_state_features` ({name: shape}).
  """

  def __init__(self,
               image_size: int = 64,
               action_dim: int = 4,
               torso_filters: Sequence[int] = (32, 64),
               head_filters: Sequence[int] = (64, 64),
               dense_sizes: Sequence[int] = (64, 64),
               extra_state_features=None,
               use_batch_norm: bool = True,
               sigmoid_q: bool = True,
               space_to_depth: int = 1,
               device_dtype: torch.dtype = torch.bfloat16,
               **kwargs):
    super().__init__(sigmoid_q=sigmoid_q, target_q_key="target_q",
                     device_dtype=device_dtype, **kwargs)
    self._space_to_depth = space_to_depth
    self._image_size = image_size
    self._action_dim = action_dim
    self._torso_filters = tuple(torso_filters)
    self._head_filters = tuple(head_filters)
    self._dense_sizes = tuple(dense_sizes)
    self._extra_state_features = {
        k: tuple(v) for k, v in (extra_state_features or {}).items()}
    self._use_batch_norm = use_batch_norm

  @property
  def action_dim(self) -> int:
    return self._action_dim

  @property
  def image_size(self) -> int:
    return self._image_size

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.image = ExtendedTensorSpec(
        shape=(self._image_size, self._image_size, 3), dtype=np.uint8,
        name="image", data_format="jpeg")
    st.action = ExtendedTensorSpec(
        shape=(self._action_dim,), dtype=np.float32, name="action")
    for key, shape in self._extra_state_features.items():
      st[key] = ExtendedTensorSpec(shape=shape, dtype=np.float32, name=key)
    return st

  def get_label_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.target_q = ExtendedTensorSpec(
        shape=(1,), dtype=np.float32, name="target_q")
    return st

  def create_network(self) -> GraspingQNetwork:
    extra = sum(int(np.prod(s)) for s in self._extra_state_features.values())
    return GraspingQNetwork(
        action_dim=self._action_dim,
        extra_features_dim=extra,
        torso_filters=self._torso_filters,
        head_filters=self._head_filters,
        dense_sizes=self._dense_sizes,
        use_batch_norm=self._use_batch_norm,
        space_to_depth=self._space_to_depth,
        dtype=self.device_dtype,
    )
