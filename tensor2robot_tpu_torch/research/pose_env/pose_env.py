"""Pose environment: the smallest end-to-end task (port of
`research/pose_env/pose_env.py`).

A block lands at a random planar pose on a table; the observation is a
numpy-rendered RGB image, the label the pose. `PoseEnv` draws from the
same `numpy.random.default_rng(seed)` stream in the same order as the
JAX package's, so a seed gives the same images and poses bit for bit.
`evaluate_pose_model` scores a predictor by its mean pose error and
success rate. `collect_random_episodes` writes TFRecords of {image,
target_pose} with the port's record writer (the same bytes as the JAX
package's for a seed); the physics-backed `MuJoCoPoseEnv` is in
`mujoco_pose_env`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin

IMAGE_SIZE = 64
# Reachable table region in world units; poses regress into this box.
WORKSPACE_LOW = np.array([-0.4, -0.4], np.float32)
WORKSPACE_HIGH = np.array([0.4, 0.4], np.float32)


class PoseEnv:
  """Numpy pose task: random block pose → rendered RGB observation."""

  def __init__(self, image_size: int = IMAGE_SIZE, seed: int = 0,
               block_half_extent: float = 0.06, noise: float = 0.02):
    self._image_size = image_size
    self._rng = np.random.default_rng(seed)
    self._half = block_half_extent
    self._noise = noise
    self._pose: Optional[np.ndarray] = None

  @property
  def image_size(self) -> int:
    return self._image_size

  def reset(self) -> Dict[str, np.ndarray]:
    """Samples a new block pose; returns the observation dict."""
    self._pose = self._rng.uniform(
        WORKSPACE_LOW, WORKSPACE_HIGH).astype(np.float32)
    return self._observation()

  def _world_to_pixel(self, xy: np.ndarray) -> Tuple[int, int]:
    frac = (xy - WORKSPACE_LOW) / (WORKSPACE_HIGH - WORKSPACE_LOW)
    px = np.clip((frac * self._image_size).astype(int), 0,
                 self._image_size - 1)
    return int(px[0]), int(px[1])

  def _observation(self) -> Dict[str, np.ndarray]:
    size = self._image_size
    # Table: gray background with sensor noise.
    image = np.full((size, size, 3), 96, np.uint8)
    noise = self._rng.normal(0, 255 * self._noise, (size, size, 3))
    image = np.clip(image + noise, 0, 255).astype(np.uint8)
    # Block: red square centered at the pose.
    cx, cy = self._world_to_pixel(self._pose)
    extent = max(1, int(self._half / float(
        WORKSPACE_HIGH[0] - WORKSPACE_LOW[0]) * size))
    x0, x1 = max(0, cx - extent), min(size, cx + extent + 1)
    y0, y1 = max(0, cy - extent), min(size, cy + extent + 1)
    image[y0:y1, x0:x1] = np.array([200, 40, 40], np.uint8)
    return {"image": image}

  @property
  def pose(self) -> np.ndarray:
    if self._pose is None:
      raise RuntimeError("Call reset() first.")
    return self._pose


@gin.configurable
def collect_random_episodes(
    output_path: str,
    num_episodes: int = 100,
    image_size: int = IMAGE_SIZE,
    seed: int = 0,
    env_cls: type = None,
) -> str:
  """Renders random poses into a TFRecord file of {image, target_pose}
  (`PoseEnvRegressionModel`'s specs: the image as JPEG); returns the
  path."""
  from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
  from tensor2robot_tpu_torch.data.tfrecord_input_generator import (
      write_tfrecord,
  )
  from tensor2robot_tpu_torch.research.pose_env.pose_env_models import (
      PoseEnvRegressionModel,
  )

  env = (env_cls or PoseEnv)(image_size=image_size, seed=seed)
  model = PoseEnvRegressionModel(image_size=image_size)
  examples = []
  for _ in range(num_episodes):
    obs = env.reset()
    examples.append({"image": obs["image"], "target_pose": env.pose})
  os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
  write_tfrecord(
      output_path, examples,
      model.get_feature_specification(Mode.TRAIN),
      model.get_label_specification(Mode.TRAIN))
  return output_path


@gin.configurable
def evaluate_pose_model(
    predict_fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]],
    num_episodes: int = 50,
    image_size: int = IMAGE_SIZE,
    seed: int = 1,
    success_threshold: float = 0.05,
    env_cls: type = None,
) -> Dict[str, float]:
  """Rolls the env and scores predicted poses against ground truth.

  `predict_fn` maps a batched feature dict to an output dict whose
  `inference_output` (else first) value is the predicted pose. Returns
  the mean L2 pose error, the success rate at `success_threshold` world
  units and the episode count.
  """
  env = (env_cls or PoseEnv)(image_size=image_size, seed=seed)
  errors: List[float] = []
  for _ in range(num_episodes):
    obs = env.reset()
    out = predict_fn({"image": obs["image"][None]})
    value = out.get("inference_output", next(iter(out.values())))
    predicted = np.asarray(value)[0].reshape(-1)[:2]
    errors.append(float(np.linalg.norm(predicted - env.pose)))
  errors_arr = np.asarray(errors)
  return {
      "mean_pose_error": float(errors_arr.mean()),
      "success_rate": float((errors_arr < success_threshold).mean()),
      "num_episodes": float(num_episodes),
  }
