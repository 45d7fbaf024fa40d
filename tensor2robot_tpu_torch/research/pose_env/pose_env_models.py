"""Pose regression: image → planar pose (port of
`research/pose_env/pose_env_models.py`).

Images stay uint8 across the host→device copy and are divided by 255 in
the compute dtype on the card. The encoder is a conv tower with
spatial-softmax keypoint pooling (`layers.ImageEncoder`), the head an
MLP; module names are the flax ones (``encoder``, ``head``), so
`models.convert.convert_variables` carries the JAX network's variables
across.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.layers import MLP, ImageEncoder
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.models.regression_model import INFERENCE_OUTPUT
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct


class _PoseNetwork(nn.Module):
  """uint8 image → /255 in the compute dtype → encoder → pose head."""

  def __init__(self, filters: Sequence[int], embedding_size: int,
               hidden_sizes: Sequence[int], output_size: int,
               use_batch_norm: bool, dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.encoder = ImageEncoder(
        in_channels=3, filters=tuple(filters),
        embedding_size=embedding_size, pooling="spatial_softmax",
        use_batch_norm=use_batch_norm, dtype=dtype)
    self.head = MLP(embedding_size, tuple(hidden_sizes),
                    output_size=output_size, dtype=dtype)

  def forward(self, features) -> Dict[str, torch.Tensor]:
    image = features["image"].to(self.dtype) / 255.0
    return {INFERENCE_OUTPUT: self.head(self.encoder(image))}


@gin.configurable
class PoseEnvRegressionModel(AbstractT2RModel):
  """MSE pose regression from rendered images."""

  def __init__(self,
               image_size: int = 64,
               pose_dim: int = 2,
               filters: Sequence[int] = (32, 64, 128),
               embedding_size: int = 128,
               hidden_sizes: Sequence[int] = (64,),
               use_batch_norm: bool = True,
               device_dtype: torch.dtype = torch.bfloat16,
               **kwargs):
    super().__init__(device_dtype=device_dtype, **kwargs)
    self._image_size = image_size
    self._pose_dim = pose_dim
    self._filters = tuple(filters)
    self._embedding_size = embedding_size
    self._hidden_sizes = tuple(hidden_sizes)
    self._use_batch_norm = use_batch_norm

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.image = ExtendedTensorSpec(
        shape=(self._image_size, self._image_size, 3), dtype=np.uint8,
        name="image", data_format="jpeg")
    return st

  def get_label_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    st.target_pose = ExtendedTensorSpec(
        shape=(self._pose_dim,), dtype=np.float32, name="target_pose")
    return st

  def create_network(self) -> nn.Module:
    return _PoseNetwork(self._filters, self._embedding_size,
                        self._hidden_sizes, self._pose_dim,
                        self._use_batch_norm, self.device_dtype)

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    prediction = outputs[INFERENCE_OUTPUT].float()
    diff = prediction - labels["target_pose"].float()
    loss = torch.mean(torch.square(diff))
    pose_error = torch.mean(torch.sqrt(torch.sum(diff * diff, dim=-1)))
    return loss, {"mse": loss, "pose_error": pose_error}
