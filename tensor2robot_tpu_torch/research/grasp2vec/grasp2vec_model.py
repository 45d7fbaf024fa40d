"""Grasp2Vec: self-supervised object embeddings from grasping (port of
`research/grasp2vec/grasp2vec_model.py`).

A scene tower φ (pregrasp and postgrasp images) and an outcome tower ψ
(the grasped object alone), each a ResNet trunk, a 1×1 conv to the
embedding width, relu and a spatial mean, trained so that
φ(pre) − φ(post) ≈ ψ(goal) under the N-pairs loss. As in the JAX
package:
- pregrasp and postgrasp run through φ in ONE stacked pass at batch 2B
  (so batch norm in training sees both halves' statistics at once);
- images cross to the device as uint8 and are divided by 255 in the
  compute dtype;
- the embeddings and the pre-pool map are f32 (relu before the pool
  keeps them non-negative, hence additive over objects).
Module names are the flax ones (``scene_tower.trunk.stage0_block0.conv1``,
``goal_tower.embed``), so `models.convert.convert_variables` carries a
JAX model's variables across.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
from tensor2robot_tpu_torch.layers.resnet import ResNet, ResNetBlock
from tensor2robot_tpu_torch.layers.vision_layers import conv_same
from tensor2robot_tpu_torch.models.abstract_model import AbstractT2RModel
from tensor2robot_tpu_torch.research.grasp2vec import losses as g2v_losses
from tensor2robot_tpu_torch.specs import ExtendedTensorSpec, TensorSpecStruct

PREGRASP_EMBEDDING = "pregrasp_embedding"
POSTGRASP_EMBEDDING = "postgrasp_embedding"
GOAL_EMBEDDING = "goal_embedding"
SCENE_SPATIAL = "scene_spatial"
GOAL_REWARD = "goal_similarity"


class _EmbeddingTower(nn.Module):
  """ResNet trunk → 1×1 conv to the embedding width → relu → f32 mean
  pool. Returns (embedding (B, D), spatial map (B, H, W, D))."""

  def __init__(self, stage_sizes: Sequence[int], num_filters: int,
               embedding_size: int, dtype: torch.dtype):
    super().__init__()
    self.dtype = dtype
    self.trunk = ResNet(stage_sizes=tuple(stage_sizes),
                        num_filters=num_filters, block_cls=ResNetBlock,
                        num_classes=None, return_spatial=True, dtype=dtype)
    self.embed = nn.Conv2d(self.trunk.out_channels, embedding_size, 1)

  def forward(self, images: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = images.to(self.dtype) / torch.tensor(255.0, dtype=self.dtype)
    _, spatial = self.trunk(x)
    spatial = conv_same(self.embed, spatial.to(self.dtype), self.dtype)
    spatial = torch.relu(spatial).float()
    return spatial.mean(dim=(1, 2)), spatial


class _Grasp2VecNetwork(nn.Module):
  """Scene tower φ (shared by pre and post) + outcome tower ψ."""

  def __init__(self, stage_sizes: Sequence[int], num_filters: int,
               embedding_size: int, dtype: torch.dtype):
    super().__init__()
    self.scene_tower = _EmbeddingTower(stage_sizes, num_filters,
                                       embedding_size, dtype)
    self.goal_tower = _EmbeddingTower(stage_sizes, num_filters,
                                      embedding_size, dtype)

  def forward(self, features) -> Dict[str, torch.Tensor]:
    pre = features["pregrasp_image"]
    post = features["postgrasp_image"]
    batch = pre.shape[0]
    scene_emb, scene_spatial = self.scene_tower(torch.cat([pre, post], 0))
    pre_emb, post_emb = scene_emb[:batch], scene_emb[batch:]
    goal_emb, _ = self.goal_tower(features["goal_image"])
    return {
        PREGRASP_EMBEDDING: pre_emb,
        POSTGRASP_EMBEDDING: post_emb,
        GOAL_EMBEDDING: goal_emb,
        SCENE_SPATIAL: scene_spatial[:batch],
        GOAL_REWARD: g2v_losses.goal_similarity_reward(
            pre_emb, post_emb, goal_emb),
    }


@gin.configurable
class Grasp2VecModel(AbstractT2RModel):
  """Self-supervised scene/outcome embedding model.

  Features: the pregrasp scene, the postgrasp scene and the outcome
  ("goal") image of the grasped object, uint8 JPEG on the wire. Label:
  an integer `object_id` (none in PREDICT), used only for the loss's
  duplicate-aware targets and the retrieval metric.
  """

  def __init__(self,
               image_size: int = 64,
               goal_image_size: Optional[int] = None,
               embedding_size: int = 128,
               stage_sizes: Sequence[int] = (2, 2, 2, 2),
               num_filters: int = 64,
               reg_lambda: float = 0.002,
               device_dtype: torch.dtype = torch.bfloat16,
               **kwargs):
    super().__init__(device_dtype=device_dtype, **kwargs)
    self._image_size = image_size
    self._goal_image_size = goal_image_size or image_size
    self._embedding_size = embedding_size
    self._stage_sizes = tuple(stage_sizes)
    self._num_filters = num_filters
    self._reg_lambda = reg_lambda

  @property
  def embedding_size(self) -> int:
    return self._embedding_size

  def get_feature_specification(self, mode: Mode) -> TensorSpecStruct:
    st = TensorSpecStruct()
    scene_shape = (self._image_size, self._image_size, 3)
    goal_shape = (self._goal_image_size, self._goal_image_size, 3)
    st.pregrasp_image = ExtendedTensorSpec(
        shape=scene_shape, dtype=np.uint8, name="pregrasp_image",
        data_format="jpeg")
    st.postgrasp_image = ExtendedTensorSpec(
        shape=scene_shape, dtype=np.uint8, name="postgrasp_image",
        data_format="jpeg")
    st.goal_image = ExtendedTensorSpec(
        shape=goal_shape, dtype=np.uint8, name="goal_image",
        data_format="jpeg")
    return st

  def get_label_specification(
      self, mode: Mode) -> Optional[TensorSpecStruct]:
    if mode == Mode.PREDICT:
      return None
    st = TensorSpecStruct()
    st.object_id = ExtendedTensorSpec(
        shape=(), dtype=np.int64, name="object_id")
    return st

  def create_network(self) -> nn.Module:
    return _Grasp2VecNetwork(
        stage_sizes=self._stage_sizes,
        num_filters=self._num_filters,
        embedding_size=self._embedding_size,
        dtype=self.device_dtype,
    )

  def model_train_fn(self, features, labels, outputs, mode
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    anchor = outputs[PREGRASP_EMBEDDING] - outputs[POSTGRASP_EMBEDDING]
    object_ids = labels["object_id"] if labels is not None else None
    loss, metrics = g2v_losses.npairs_loss(
        anchor, outputs[GOAL_EMBEDDING], object_ids=object_ids,
        reg_lambda=self._reg_lambda)
    metrics["goal_similarity"] = outputs[GOAL_REWARD].mean()
    return loss, metrics
