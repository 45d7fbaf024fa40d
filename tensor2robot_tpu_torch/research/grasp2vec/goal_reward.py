"""Grasp2Vec → QT-Opt: self-supervised goal-conditioned rewards (port of
`research/grasp2vec/goal_reward.py`).

A reward labeler over the model's `predict_step` (both towers, the
cosine and the threshold, on the device the state lives on) and a
relabeler that emits the QT-Opt replay layout, the goal embedding
riding as an extra state feature of the Q-function:
`relabel_transitions`' keys are `QTOptLearner.transition_specification()`
for `GraspingQModel(extra_state_features={"goal_embedding": (D,)})`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.research.grasp2vec.grasp2vec_model import (
    GOAL_EMBEDDING,
    GOAL_REWARD,
    Grasp2VecModel,
)
from tensor2robot_tpu_torch.specs import TensorSpecStruct

GOAL_EMBEDDING_FEATURE = "goal_embedding"


def make_grasp2vec_reward_fn(
    model: Grasp2VecModel,
    state: TrainState,
    threshold: float = 0.5,
    binary: bool = True,
) -> Callable[[np.ndarray, np.ndarray, np.ndarray], Dict[str, np.ndarray]]:
  """Builds `(pregrasp, postgrasp, goal) → {reward, similarity,
  goal_embedding}` (numpy in, numpy out). `binary=True` applies the
  paper's success threshold on the cosine; otherwise the raw similarity
  is the (shaped) reward. ψ(goal) comes back too, so relabeled
  transitions can condition the Q-function."""
  device = next(iter(state.params.values())).device

  def reward_fn(pregrasp_image, postgrasp_image, goal_image):
    features = TensorSpecStruct.from_flat_dict({
        "pregrasp_image": torch.as_tensor(np.asarray(pregrasp_image),
                                          device=device),
        "postgrasp_image": torch.as_tensor(np.asarray(postgrasp_image),
                                           device=device),
        "goal_image": torch.as_tensor(np.asarray(goal_image),
                                      device=device),
    })
    outputs = model.predict_step(state, features)
    similarity = outputs[GOAL_REWARD].float().cpu().numpy()
    reward = ((similarity > threshold).astype(np.float32)
              if binary else similarity)
    return {
        "reward": reward,
        "similarity": similarity,
        GOAL_EMBEDDING_FEATURE: outputs[GOAL_EMBEDDING].float().cpu().numpy(),
    }

  return reward_fn


def relabel_transitions(
    reward_fn,
    pregrasp_images: np.ndarray,
    postgrasp_images: np.ndarray,
    goal_images: np.ndarray,
    actions: np.ndarray,
    next_images: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
  """Grasping attempts → QT-Opt replay transitions, grasp2vec-labeled:
  the scene image and goal embedding are the state, the attempt is the
  action, the outcome similarity the reward, and each episode is one
  grasp (done = 1, the paper's setting)."""
  labels = reward_fn(pregrasp_images, postgrasp_images, goal_images)
  n = pregrasp_images.shape[0]
  goal_emb = labels[GOAL_EMBEDDING_FEATURE]
  return {
      "image": pregrasp_images,
      GOAL_EMBEDDING_FEATURE: goal_emb,
      "action": np.asarray(actions, np.float32),
      "reward": labels["reward"][:, None],
      "done": np.ones((n, 1), np.float32),
      "next_image": (postgrasp_images if next_images is None
                     else next_images),
      f"next_{GOAL_EMBEDDING_FEATURE}": goal_emb,
  }
