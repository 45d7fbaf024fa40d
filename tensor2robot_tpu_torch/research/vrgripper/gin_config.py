"""The widths of the shipped `train_vrgripper_transformer.gin`, for the
runs that build its model in code.

The gin itself runs as written through `bin/run_t2r_trainer.py` (from
TFRecords that `collect_demo_episodes` writes). This module holds the
same model widths, optimizer and training shape, with seeded
scripted-expert episodes in memory, so that `chip_smoke.py`'s timing
phases and `bin/profile_policy.py` measure that configuration without
a record file.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch

from tensor2robot_tpu_torch.models.optimizers import create_optimizer
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_env import (
    VRGripperEnv,
    collect_expert_episode,
)
from tensor2robot_tpu_torch.research.vrgripper.vrgripper_transformer_models import (  # noqa: E501
    VRGripperTransformerModel,
)

# `VRGripperTransformerModel` bindings of the gin (state_dim, filters and
# embedding_size are the model's defaults there).
GIN_WIDTH = dict(image_size=48, state_dim=3, action_dim=3, filters=(16, 32),
                 embedding_size=64, width=128, depth=4, num_heads=4,
                 max_context_length=512, attention_impl="auto")
# `create_optimizer`: adam at 3e-4. The input generator's training shape.
GIN_LEARNING_RATE = 3e-4
GIN_BATCH_SIZE = 16
GIN_SEQUENCE_LENGTH = 32


def gin_model(device_dtype: torch.dtype = torch.bfloat16
              ) -> VRGripperTransformerModel:
  """The gin's model and optimizer at `device_dtype` compute."""
  return VRGripperTransformerModel(
      device_dtype=device_dtype,
      create_optimizer_fn=functools.partial(
          create_optimizer, "adam", learning_rate=GIN_LEARNING_RATE),
      **GIN_WIDTH)


def expert_episodes(num_episodes: int, seed: int
                    ) -> List[Dict[str, np.ndarray]]:
  """Seeded scripted-expert episodes at the gin's image size, of 24 to
  40 steps: some shorter than the 32-step crop (masked), some longer
  (cut)."""
  env = VRGripperEnv(image_size=GIN_WIDTH["image_size"], seed=seed,
                     max_steps=40)
  rng = np.random.default_rng(seed)
  return [collect_expert_episode(env, action_noise=0.1,
                                 min_steps=int(rng.integers(24, 41)),
                                 rng=rng) for _ in range(num_episodes)]
