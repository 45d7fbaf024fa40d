"""Pose envs as a batched grasp bandit (port of
`research/pose_env/grasp_bandit.py`).

`GraspActor` speaks the vectorized single-step bandit interface of
`ToyGraspEnv` (`reset_batch` / `grade` / `action_dim`); the pose envs
speak per-episode `reset()` and a ground-truth `pose`. This adapter
bridges them with QT-Opt's reward structure:

  * observation: the env's rendered RGB image;
  * action: the normalized grasp point in [-1, 1]², mapped linearly onto
    the pose workspace box;
  * reward: 1 when the grasp point lands within `success_threshold`
    WORLD units of the block pose, else 0.

Numpy over the env. `physics=True` (the JAX default) builds the
physics-backed `MuJoCoPoseEnv` (which needs `mujoco`); `physics=False`
uses the numpy `PoseEnv`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    IMAGE_SIZE,
    WORKSPACE_HIGH,
    WORKSPACE_LOW,
)


def grade_grasp(actions: np.ndarray, positions: np.ndarray,
                threshold: float) -> np.ndarray:
  """The host grading rule: normalized grasp point → workspace box →
  proximity success (`envs.pose.PoseBanditEnv.grasp_reward` is the same
  float math on the card)."""
  grasp = np.asarray(actions, np.float32)[:, :2] * WORKSPACE_HIGH
  dist = np.linalg.norm(grasp - np.asarray(positions, np.float32),
                        axis=-1)
  return (dist < threshold).astype(np.float32)


@gin.configurable
class PoseGraspBandit:
  """Batched single-step grasp bandit over a pose env."""

  def __init__(self,
               image_size: int = IMAGE_SIZE,
               action_dim: int = 2,
               success_threshold: float = 0.1,
               physics: bool = True,
               seed: int = 0,
               env=None,
               **env_kwargs):
    """Args:
      image_size: rendered observation size (must match the model's).
      action_dim: actor action width; the FIRST TWO dims are the grasp
        point, extras ride along unused.
      success_threshold: max grasp-point error in WORLD units (the
        workspace box spans ±0.4; 0.1 gives a ~5% random baseline).
      physics: True → `MuJoCoPoseEnv` (needs `mujoco`); False → the
        numpy `PoseEnv`.
      env: an already-constructed pose env (overrides `physics`).
      **env_kwargs: forwarded to the env constructor.
    """
    if action_dim < 2:
      raise ValueError(
          f"action_dim must be >= 2 (grasp point), got {action_dim}")
    self._action_dim = int(action_dim)
    self._threshold = float(success_threshold)
    if env is not None:
      self._env = env
    elif physics:
      from tensor2robot_tpu_torch.research.pose_env.mujoco_pose_env import (
          MuJoCoPoseEnv,
      )
      self._env = MuJoCoPoseEnv(image_size=image_size, seed=seed,
                                **env_kwargs)
    else:
      from tensor2robot_tpu_torch.research.pose_env.pose_env import PoseEnv
      self._env = PoseEnv(image_size=image_size, seed=seed, **env_kwargs)

  @property
  def action_dim(self) -> int:
    return self._action_dim

  @property
  def success_threshold(self) -> float:
    """Max grasp-point error in WORLD units: the grading geometry a
    device twin must match (`envs.pose.host_parity_env`)."""
    return self._threshold

  @property
  def env(self):
    return self._env

  def reset_batch(self, n: int
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """N fresh episodes: ({image: [N, S, S, 3]}, poses [N, 2])."""
    images = []
    poses = []
    for _ in range(n):
      observation = self._env.reset()
      images.append(observation["image"])
      poses.append(self._env.pose)
    return {"image": np.stack(images)}, np.stack(poses)

  def grade(self, actions: np.ndarray,
            positions: np.ndarray) -> np.ndarray:
    """Success per episode: grasp point near the pose."""
    return grade_grasp(actions, positions, self._threshold)

  def sample_transitions(self, n: int) -> Dict[str, np.ndarray]:
    """N random-policy transitions in the learner's replay layout."""
    rng = getattr(self._env, "_rng", np.random.default_rng(0))
    observations, positions = self.reset_batch(n)
    actions = rng.uniform(
        -1, 1, (n, self._action_dim)).astype(np.float32)
    reward = self.grade(actions, positions)
    return {
        "image": observations["image"],
        "action": actions,
        "reward": reward[:, None].astype(np.float32),
        "done": np.ones((n, 1), np.float32),
        "next_image": observations["image"],
    }


__all__ = ["PoseGraspBandit", "grade_grasp", "WORKSPACE_LOW",
           "WORKSPACE_HIGH"]
