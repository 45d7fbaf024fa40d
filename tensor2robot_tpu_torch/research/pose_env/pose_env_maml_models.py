"""MAML over the pose regression model (port of
`research/pose_env/pose_env_maml_models.py`).

The base network is batch-norm-free (per-task adapted statistics are
ill-defined), so the encoder runs without norm layers.
"""

from __future__ import annotations

from typing import Sequence

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.meta_learning import MAMLModel
from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
    PoseEnvRegressionModel,
)


@gin.configurable
class PoseEnvRegressionModelMAML(MAMLModel):
  """MAML over a BN-free pose regression base."""

  def __init__(self,
               image_size: int = 64,
               pose_dim: int = 2,
               filters: Sequence[int] = (16, 32),
               embedding_size: int = 64,
               hidden_sizes: Sequence[int] = (64,),
               num_inner_steps: int = 1,
               inner_lr: float = 0.05,
               first_order: bool = False,
               num_condition_samples_per_task: int = 4,
               num_inference_samples_per_task: int = 4,
               **kwargs):
    base = PoseEnvRegressionModel(
        image_size=image_size, pose_dim=pose_dim, filters=filters,
        embedding_size=embedding_size, hidden_sizes=hidden_sizes,
        use_batch_norm=False)
    super().__init__(
        base_model=base,
        num_inner_steps=num_inner_steps,
        inner_lr=inner_lr,
        first_order=first_order,
        num_condition_samples_per_task=num_condition_samples_per_task,
        num_inference_samples_per_task=num_inference_samples_per_task,
        **kwargs)
