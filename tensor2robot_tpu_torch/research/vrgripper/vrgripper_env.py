"""VRGripper environment (port of `research/vrgripper/vrgripper_env.py`).

The JAX package's dependency-free numpy reach-and-grasp task with its
scripted expert, copied so the port imports nothing of that package,
and without the config registry. It draws from its RNG in the same
order, so the same seed and actions give the same frames.

Task: a gripper (green dot) must reach a block (red square) on a
table and close. Observation: RGB render + gripper pose
[x, y, closed]. Action: [dx, dy, close_cmd], all in [-1, 1]. The
scripted expert walks toward the block and closes on arrival.

The env, `collect_expert_episode`, the TFRecord demo writer
`collect_demo_episodes`, the Watch-Try-Learn meta-batch sampler
`sample_wtl_meta_batch` and the closed-loop `evaluate_gripper_policy`.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.specs.packing import as_sequence_specs

IMAGE_SIZE = 48
WORKSPACE_LOW = np.array([-0.4, -0.4], np.float32)
WORKSPACE_HIGH = np.array([0.4, 0.4], np.float32)
# World units per unit action: one expert step covers this distance.
ACTION_SCALE = 0.1
# Forgiving gripper aperture (a compliant gripper, as real ones are):
# the expert aims well inside it, a cloned policy succeeds from the
# whole aperture.
GRASP_RADIUS = 0.09


class VRGripperEnv:
  """Numpy reach-and-grasp task with a scripted expert."""

  def __init__(self, image_size: int = IMAGE_SIZE, seed: int = 0,
               max_steps: int = 12, noise: float = 0.02,
               task_offset_scale: float = 0.0):
    self._image_size = image_size
    self._rng = np.random.default_rng(seed)
    self._max_steps = max_steps
    self._noise = noise
    self._task_offset_scale = task_offset_scale
    self._block: Optional[np.ndarray] = None
    self._gripper: Optional[np.ndarray] = None
    self._closed = 0.0
    self._offset = np.zeros(2, np.float32)
    self._steps = 0

  @property
  def image_size(self) -> int:
    return self._image_size

  @property
  def max_steps(self) -> int:
    return self._max_steps

  @property
  def task_offset(self) -> np.ndarray:
    return self._offset

  def reset(self, task_offset: Optional[np.ndarray] = None
            ) -> Dict[str, np.ndarray]:
    self._block = self._rng.uniform(
        WORKSPACE_LOW * 0.8, WORKSPACE_HIGH * 0.8).astype(np.float32)
    self._gripper = self._rng.uniform(
        WORKSPACE_LOW, WORKSPACE_HIGH).astype(np.float32)
    if task_offset is not None:
      self._offset = np.asarray(task_offset, np.float32)
    elif self._task_offset_scale > 0:
      self._offset = self._rng.uniform(
          -self._task_offset_scale, self._task_offset_scale,
          2).astype(np.float32)
    else:
      self._offset = np.zeros(2, np.float32)
    self._closed = 0.0
    self._steps = 0
    return self.observation()

  @property
  def target(self) -> np.ndarray:
    """The (latent) point the expert aims for: block + task offset."""
    return np.clip(self._block + self._offset,
                   WORKSPACE_LOW, WORKSPACE_HIGH)

  def step(self, action: np.ndarray
           ) -> Tuple[Dict[str, np.ndarray], float, bool]:
    """Applies [dx, dy, close]; returns (obs, reward, done)."""
    action = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
    self._gripper = np.clip(
        self._gripper + action[:2] * ACTION_SCALE,
        WORKSPACE_LOW, WORKSPACE_HIGH).astype(np.float32)
    self._closed = float(action[2] > 0)
    self._steps += 1
    success = self.success()
    done = success or self._steps >= self._max_steps
    return self.observation(), float(success), done

  def success(self) -> bool:
    return (self._closed > 0 and
            float(np.linalg.norm(self._gripper - self.target))
            < GRASP_RADIUS)

  def expert_action(self) -> np.ndarray:
    """Scripted demonstration policy toward the (latent) target."""
    delta = self.target - self._gripper
    dist = float(np.linalg.norm(delta))
    if dist < GRASP_RADIUS * 0.6:
      return np.array([0.0, 0.0, 1.0], np.float32)
    move = np.clip(delta / ACTION_SCALE, -1.0, 1.0)
    return np.array([move[0], move[1], -1.0], np.float32)

  def _world_to_pixel(self, xy: np.ndarray) -> Tuple[int, int]:
    frac = (xy - WORKSPACE_LOW) / (WORKSPACE_HIGH - WORKSPACE_LOW)
    px = np.clip((frac * self._image_size).astype(int), 0,
                 self._image_size - 1)
    return int(px[0]), int(px[1])

  def observation(self) -> Dict[str, np.ndarray]:
    size = self._image_size
    image = np.full((size, size, 3), 96, np.uint8)
    noise = self._rng.normal(0, 255 * self._noise, (size, size, 3))
    image = np.clip(image + noise, 0, 255).astype(np.uint8)
    # Block: red square.
    bx, by = self._world_to_pixel(self._block)
    e = max(1, size // 16)
    image[max(0, by - e):by + e + 1, max(0, bx - e):bx + e + 1] = (
        np.array([200, 40, 40], np.uint8))
    # Gripper: green dot (brighter when closed).
    gx, gy = self._world_to_pixel(self._gripper)
    g = max(1, size // 24)
    color = np.array([40, 230 if self._closed else 160, 40], np.uint8)
    image[max(0, gy - g):gy + g + 1, max(0, gx - g):gx + g + 1] = color
    return {
        "image": image,
        "gripper_pose": np.array(
            [self._gripper[0], self._gripper[1], self._closed],
            np.float32),
    }


def collect_expert_episode(env: VRGripperEnv,
                           task_offset: Optional[np.ndarray] = None,
                           action_noise: float = 0.0,
                           min_steps: int = 1,
                           rng: Optional[np.random.Generator] = None,
                           ) -> Dict[str, np.ndarray]:
  """Rolls the scripted expert; returns a [T, ...] episode dict.

  `min_steps` keeps recording hold-in-place grasp steps after success
  until the episode has at least that many timesteps (capped by the
  env's max_steps) — consumers that split episodes into condition/
  inference sets need a guaranteed minimum length.
  """
  rng = rng or np.random.default_rng(0)
  obs = env.reset(task_offset=task_offset)
  images, poses, actions, rewards = [], [], [], []
  done = False
  while not done or len(actions) < min(min_steps, env.max_steps):
    action = env.expert_action()
    if action_noise > 0:
      action = np.clip(
          action + rng.normal(0, action_noise, 3).astype(np.float32),
          -1.0, 1.0)
    images.append(obs["image"])
    poses.append(obs["gripper_pose"])
    actions.append(action.astype(np.float32))
    obs, reward, done = env.step(action)
    rewards.append(np.array([reward], np.float32))
    if len(actions) >= env.max_steps:
      break
  return {
      "image": np.stack(images),
      "gripper_pose": np.stack(poses),
      "action": np.stack(actions),
      "reward": np.stack(rewards),
  }


def _demo_specs(image_size: int, state_dim: int = 3, action_dim: int = 3):
  """The per-step feature and label specs of `VRGripperRegressionModel
  (image_size=image_size)`: a PNG image and the gripper pose as
  features, the action as the label."""
  from tensor2robot_tpu_torch.data.abstract_input_generator import Mode
  from tensor2robot_tpu_torch.research.vrgripper.vrgripper_models import (
      VRGripperRegressionModel,
  )
  model = VRGripperRegressionModel(image_size=image_size,
                                   state_dim=state_dim,
                                   action_dim=action_dim)
  return (model.get_feature_specification(Mode.TRAIN),
          model.get_label_specification(Mode.TRAIN))


@gin.configurable
def collect_demo_episodes(output_path: str,
                          num_episodes: int = 100,
                          image_size: int = IMAGE_SIZE,
                          seed: int = 0,
                          action_noise: float = 0.05,
                          task_offset_scale: float = 0.0,
                          min_episode_steps: int = 8) -> str:
  """Writes scripted-expert episodes as SequenceExample TFRecords (port
  of the JAX function: the same episodes for the same seed).

  The wire layout is VRGripperRegressionModel's specs lifted to
  sequences: image and gripper_pose per step as features, action per
  step as the label. `min_episode_steps` defaults to 8 so the shipped
  meta configs' 4 condition + 4 inference splits fit inside real data.
  Returns `output_path`.
  """
  from tensor2robot_tpu_torch.data.tfrecord_input_generator import (
      write_episode_tfrecord,
  )
  env = VRGripperEnv(image_size=image_size, seed=seed,
                     task_offset_scale=task_offset_scale)
  rng = np.random.default_rng(seed + 1)
  episodes = [
      collect_expert_episode(env, action_noise=action_noise,
                             min_steps=min_episode_steps, rng=rng)
      for _ in range(num_episodes)]
  features, labels = _demo_specs(image_size)
  os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
  write_episode_tfrecord(output_path, episodes, as_sequence_specs(features),
                         as_sequence_specs(labels))
  return output_path


def _sample_steps(episode: Dict[str, np.ndarray], n: int,
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
  """Samples n timesteps (with replacement when the episode is short)."""
  t = len(episode["action"])
  idx = np.sort(rng.choice(t, size=n, replace=t < n))
  return {k: v[idx] for k, v in episode.items()}


def sample_wtl_meta_batch(
    num_tasks: int,
    num_condition: int = 4,
    num_trial: int = 4,
    num_inference: int = 4,
    image_size: int = IMAGE_SIZE,
    seed: int = 0,
    task_offset_scale: float = 0.15,
    trial_noise: float = 0.4,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
  """Builds one Watch-Try-Learn meta batch from scripted rollouts.

  Per task (a random offset the policy can only learn from the demo):
  a clean expert demo (condition), a noisy suboptimal rollout with its
  rewards (trial), and held-out expert steps to imitate (inference).
  Returns flat (features, labels) dicts matching VRGripperWTLModel's
  retrial specs; trial keys are simply dropped for the trial policy.
  """
  rng = np.random.default_rng(seed)
  env = VRGripperEnv(image_size=image_size, seed=seed)
  f: Dict[str, List[np.ndarray]] = {}
  l: Dict[str, List[np.ndarray]] = {}

  def put(store, key, value):
    store.setdefault(key, []).append(value)

  for _ in range(num_tasks):
    offset = rng.uniform(-task_offset_scale, task_offset_scale,
                         2).astype(np.float32)
    demo = _sample_steps(
        collect_expert_episode(env, task_offset=offset, rng=rng),
        num_condition, rng)
    trial = _sample_steps(
        collect_expert_episode(env, task_offset=offset,
                               action_noise=trial_noise, rng=rng),
        num_trial, rng)
    query = _sample_steps(
        collect_expert_episode(env, task_offset=offset, rng=rng),
        num_inference, rng)
    put(f, "condition/image", demo["image"])
    put(f, "condition/gripper_pose", demo["gripper_pose"])
    put(f, "trial/image", trial["image"])
    put(f, "trial/gripper_pose", trial["gripper_pose"])
    put(f, "trial/action", trial["action"])
    put(f, "trial/reward", trial["reward"])
    put(f, "inference/image", query["image"])
    put(f, "inference/gripper_pose", query["gripper_pose"])
    put(l, "condition/action", demo["action"])
    put(l, "inference/action", query["action"])

  features = {k: np.stack(v) for k, v in f.items()}
  labels = {k: np.stack(v) for k, v in l.items()}
  return features, labels


@gin.configurable
def evaluate_gripper_policy(
    predict_fn: Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]],
    num_episodes: int = 50,
    image_size: int = IMAGE_SIZE,
    seed: int = 1,
    task_offset_scale: float = 0.0,
    action_key: str = "action",
    max_steps: int = 12,
) -> Dict[str, float]:
  """Closed-loop policy rollout; returns success rate + final distance.
  An episode ends on success or after `max_steps` steps.

  `predict_fn` maps a batched feature dict {image, gripper_pose} to an
  output dict containing the action (the predictor API). Stateful
  policies (e.g. full-history transformer policies) expose a
  `.reset()` method, called at each episode boundary.
  """
  env = VRGripperEnv(image_size=image_size, seed=seed,
                     task_offset_scale=task_offset_scale, max_steps=max_steps)
  successes, final_dists = [], []
  for _ in range(num_episodes):
    obs = env.reset()
    if hasattr(predict_fn, "reset"):
      predict_fn.reset()
    done = False
    while not done:
      batch = {"image": obs["image"][None],
               "gripper_pose": obs["gripper_pose"][None]}
      out = predict_fn(batch)
      value = out.get(action_key, next(iter(out.values())))
      action = np.asarray(value)[0].reshape(-1)[:3]
      obs, _, done = env.step(action)
    successes.append(float(env.success()))
    final_dists.append(
        float(np.linalg.norm(
            obs["gripper_pose"][:2] - env.target)))
  return {
      "success_rate": float(np.mean(successes)),
      "mean_final_distance": float(np.mean(final_dists)),
      "num_episodes": float(num_episodes),
  }
