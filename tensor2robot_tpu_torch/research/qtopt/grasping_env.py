"""Toy grasping environment and the closed-loop success evaluation for
QT-Opt (port of `research/qtopt/grasping_env.py`).

`ToyGraspEnv` is a single-step grasping bandit with QT-Opt's reward
structure: an object is rendered at a random position, the action is
the (normalized) grasp point, the reward is grasp success. It is numpy
only and draws exactly what the JAX package's env draws (the same
`numpy.random.default_rng` calls in the same order), so one seed gives
the same images, positions and grades in both packages.

`evaluate_grasp_policy` resets every episode as one batch, selects all
their actions in ONE `QTOptLearner.build_policy` call on the learner's
device, and grades them in numpy, beside a random policy's success on
the same episodes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin

IMAGE_SIZE = 64


class ToyGraspEnv:
  """Single-step grasping bandit: image → grasp point → success."""

  def __init__(self,
               image_size: int = IMAGE_SIZE,
               action_dim: int = 2,
               success_threshold: float = 0.35,
               block_half_extent: float = 0.1,
               noise: float = 0.02,
               workspace: float = 0.8,
               seed: int = 0):
    """`workspace`: object centers stay in [-w, w]² (normalized coords);
    actions live in [-1, 1]^action_dim, the first two dims being the
    grasp point. `success_threshold` is the max grasp-point error."""
    self._size = image_size
    self._action_dim = action_dim
    self._threshold = success_threshold
    self._half = block_half_extent
    self._noise = noise
    self._workspace = workspace
    self._rng = np.random.default_rng(seed)

  @property
  def action_dim(self) -> int:
    return self._action_dim

  def _render(self, positions: np.ndarray) -> np.ndarray:
    """Renders a batch of object positions to uint8 images."""
    n = positions.shape[0]
    size = self._size
    images = np.full((n, size, size, 3), 96, np.float64)
    images += self._rng.normal(0, 255 * self._noise,
                               (n, size, size, 3))
    half_px = max(1, int(self._half / 2.0 * size))
    centers = ((positions + 1.0) / 2.0 * (size - 1)).astype(int)
    for i, (cx, cy) in enumerate(centers):
      x0, x1 = max(0, cx - half_px), min(size, cx + half_px + 1)
      y0, y1 = max(0, cy - half_px), min(size, cy + half_px + 1)
      images[i, y0:y1, x0:x1] = (200, 40, 40)
    return np.clip(images, 0, 255).astype(np.uint8)

  def reset_batch(self, n: int
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """N fresh episodes: ({image: [N, S, S, 3]}, object positions)."""
    positions = self._rng.uniform(
        -self._workspace, self._workspace, (n, 2)).astype(np.float32)
    return {"image": self._render(positions)}, positions

  def grade(self, actions: np.ndarray,
            positions: np.ndarray) -> np.ndarray:
    """Success per episode: grasp point within threshold of the object."""
    grasp = np.asarray(actions, np.float32)[:, :2]
    dist = np.linalg.norm(grasp - positions, axis=-1)
    return (dist < self._threshold).astype(np.float32)

  def sample_transitions(self, n: int) -> Dict[str, np.ndarray]:
    """N random-policy transitions in the learner's replay layout.

    Episodes are single-step: done=1 and next_image is the (unused,
    spec-required) terminal observation.
    """
    observations, positions = self.reset_batch(n)
    actions = self._rng.uniform(
        -1, 1, (n, self._action_dim)).astype(np.float32)
    reward = self.grade(actions, positions)
    return {
        "image": observations["image"],
        "action": actions,
        "reward": reward[:, None].astype(np.float32),
        "done": np.ones((n, 1), np.float32),
        "next_image": observations["image"],
    }


@gin.configurable
def evaluate_grasp_policy(
    learner,
    state,
    num_episodes: int = 512,
    image_size: int = IMAGE_SIZE,
    success_threshold: float = 0.35,
    seed: int = 1,
    cem_population: Optional[int] = None,
    cem_iterations: Optional[int] = None,
    noise: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
  """Scores the learner's CEM policy on `num_episodes` fresh episodes.

  One `build_policy` call selects every episode's action on the
  learner's device (`state` is moved there if it is not), its CEM noise
  from a generator on that device seeded `seed` (or given whole as
  `noise` `[iterations, num_episodes, population, action_dim]`, as a
  test injects the JAX draw). Also reports a random policy's success on
  the same episodes (`default_rng(seed + 1)`).
  """
  env = ToyGraspEnv(image_size=image_size,
                    action_dim=learner.model.action_dim,
                    success_threshold=success_threshold, seed=seed)
  observations, positions = env.reset_batch(num_episodes)
  ts = getattr(state, "train_state", state)
  if next(iter(ts.params.values())).device != learner.device:
    ts = ts.to(learner.device)
  policy = learner.build_policy(cem_population=cem_population,
                                cem_iterations=cem_iterations)
  generator = (None if noise is not None else
               torch.Generator(device=learner.device).manual_seed(seed))
  actions = policy(ts, {"image": observations["image"]},
                   generator=generator, noise=noise)
  success = env.grade(actions.float().cpu().numpy(), positions)
  random_actions = np.random.default_rng(seed + 1).uniform(
      -1, 1, (num_episodes, learner.model.action_dim))
  return {
      "success_rate": float(success.mean()),
      "random_baseline_success_rate": float(
          env.grade(random_actions, positions).mean()),
      "num_episodes": float(num_episodes),
  }
