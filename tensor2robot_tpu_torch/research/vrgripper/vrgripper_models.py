"""VRGripper observation encoder (port of
`research/vrgripper/vrgripper_models.py`).

This slice ports the shared torso every vrgripper policy uses,
`GripperObsEncoder`, and the `ACTION` key. The BC/MDN policy heads come
with ROADMAP A10.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tensor2robot_tpu_torch.layers.core import dense
from tensor2robot_tpu_torch.layers.vision_layers import ImageEncoder

ACTION = "action"


class GripperObsEncoder(nn.Module):
  """{image [N, H, W, 3] uint8, gripper_pose [N, S]} → [N, E] embedding.

  Conv tower + spatial softmax over the image, the pose concatenated
  after pooling, one joint projection. Dtypes follow flax: image/255
  in the compute dtype; the image embedding comes back f32; the pose
  is cast to the compute dtype, and the concat promotes both to f32;
  `joint_proj` computes (and returns) in the compute dtype.
  """

  def __init__(self, state_dim: int,
               filters: Sequence[int] = (32, 64),
               embedding_size: int = 64,
               use_batch_norm: bool = False,
               dtype: torch.dtype = torch.bfloat16):
    super().__init__()
    self.dtype = dtype
    self.image_encoder = ImageEncoder(
        in_channels=3, filters=tuple(filters),
        embedding_size=embedding_size, pooling="spatial_softmax",
        use_batch_norm=use_batch_norm, dtype=dtype)
    self.joint_proj = nn.Linear(embedding_size + state_dim, embedding_size)

  def forward(self, features) -> torch.Tensor:
    image = features["image"]
    # A 0-dim device tensor, made by a fill (no host copy, so a CUDA
    # graph can capture it): a true division, as flax's, where a Python
    # scalar divisor would become a multiply by its reciprocal on CUDA.
    x = image.to(self.dtype) / torch.full((), 255.0, dtype=self.dtype,
                                          device=image.device)
    emb = self.image_encoder(x)
    state = features["gripper_pose"].to(self.dtype)
    joint = torch.cat([emb, state.to(emb.dtype)], dim=-1)
    return dense(self.joint_proj, joint, self.dtype)
