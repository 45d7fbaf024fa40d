"""Procedurally generated grasping scenarios (port of `envs/procgen.py`).

Scenario generation is the reset: every episode samples from the
generator

  * workspace scale: the block's box is ``U[min_workspace_scale, 1] ×``
    the PoseEnv box;
  * block half-extent (target size);
  * sensor noise σ (camera quality);
  * distractor count and poses: up to ``max_distractors`` blue blocks of
    the same size that the policy must not grasp;
  * drift: after every step the target slides this far in a direction
    drawn per step, so multi-step episodes chase a moving target.

The action contract is the pose bandit's: ``action[:2]`` in [-1, 1]²
onto the BASE workspace box, reward by proximity to the target pose.
`scenario_bucket` (the distractor count) groups scenarios for the
success protocol's `envs` sweep. The same generator seed reproduces the
same scenarios bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.envs.core import FunctionalEnv
from tensor2robot_tpu_torch.envs.pose import (
    BLOCK_COLOR,
    IMAGE_SIZE,
    block_mask,
    fused_multiply_add,
    paint,
    plain_table,
    proximity_reward,
    sensor_table,
)
from tensor2robot_tpu_torch.research.pose_env.pose_env import WORKSPACE_HIGH

DISTRACTOR_COLOR = (40, 80, 200)

_BASE_HALF_WIDTH = float(WORKSPACE_HIGH[0])  # the ±0.4 PoseEnv box


@dataclasses.dataclass(frozen=True)
class ProcGenState:
  """A batch of sampled scenarios and their episode progress."""

  pose: torch.Tensor             # [N, 2] f32 target pose (world units)
  distractors: torch.Tensor      # [N, max(M, 1), 2] f32 distractor poses
  num_distractors: torch.Tensor  # [N] int32: how many render and count
  half_extent: torch.Tensor      # [N] f32 block half size (world units)
  noise: torch.Tensor            # [N] f32 sensor noise sigma
  drift: torch.Tensor            # [N] f32 world units slid per step
  workspace: torch.Tensor        # [N] f32 half-width of the scenario's box
  table: torch.Tensor            # [N, S, S, 3] uint8 noisy background
  t: torch.Tensor                # [N] int32 step counter


def _uniform(generator, shape, low, high):
  u = torch.rand(shape, generator=generator, device=generator.device)
  return low + (high - low) * u


@gin.configurable
class ProcGenGraspEnv(FunctionalEnv):
  """Generator-sampled grasping scenarios over the pose-env geometry."""

  def __init__(self,
               image_size: int = IMAGE_SIZE,
               action_dim: int = 2,
               success_threshold: float = 0.1,
               max_distractors: int = 3,
               min_workspace_scale: float = 0.6,
               half_extent_range: Tuple[float, float] = (0.03, 0.1),
               noise_range: Tuple[float, float] = (0.0, 0.05),
               max_drift: float = 0.05,
               max_episode_steps: int = 1):
    if action_dim < 2:
      raise ValueError(
          f"action_dim must be >= 2 (grasp point), got {action_dim}")
    if max_distractors < 0:
      raise ValueError(
          f"max_distractors must be >= 0, got {max_distractors}")
    if not 0.0 < min_workspace_scale <= 1.0:
      raise ValueError("min_workspace_scale must be in (0, 1], got "
                       f"{min_workspace_scale}")
    if max_episode_steps < 1:
      raise ValueError(
          f"max_episode_steps must be >= 1, got {max_episode_steps}")
    self._size = int(image_size)
    self._action_dim = int(action_dim)
    self._threshold = float(success_threshold)
    self._max_distractors = int(max_distractors)
    self._min_scale = float(min_workspace_scale)
    self._half_range = (float(half_extent_range[0]),
                        float(half_extent_range[1]))
    self._noise_range = (float(noise_range[0]), float(noise_range[1]))
    self._max_drift = float(max_drift)
    self._max_steps = int(max_episode_steps)

  @property
  def action_dim(self) -> int:
    return self._action_dim

  @property
  def image_size(self) -> int:
    return self._size

  @property
  def num_buckets(self) -> int:
    """Scenario buckets = distractor counts 0..max_distractors."""
    return self._max_distractors + 1

  def observation_shapes(self) -> Dict[str, tuple]:
    return {"image": (self._size, self._size, 3)}

  def reset(self, generator: torch.Generator,
            num_envs: int) -> ProcGenState:
    n = num_envs
    device = generator.device
    slots = max(self._max_distractors, 1)
    scale = _uniform(generator, (n,), self._min_scale, 1.0)
    workspace = scale * _BASE_HALF_WIDTH
    ws = workspace[:, None]
    pose = _uniform(generator, (n, 2), -ws, ws)
    num = torch.randint(0, self._max_distractors + 1, (n,),
                        generator=generator, device=device)
    distractors = _uniform(generator, (n, slots, 2), -ws[..., None],
                           ws[..., None])
    half = _uniform(generator, (n,), *self._half_range)
    noise = _uniform(generator, (n,), *self._noise_range)
    drift = _uniform(generator, (n,), 0.0, self._max_drift)
    return self.scenario(pose, distractors, num, half, noise, drift,
                         workspace, generator=generator)

  def scenario(self, pose, distractors, num_distractors, half_extent,
               noise, drift, workspace,
               generator: Optional[torch.Generator] = None,
               normal: Optional[torch.Tensor] = None) -> ProcGenState:
    """A batch of GIVEN scenarios at step 0 (what `reset` samples, or a
    JAX env's states carried over); the sensor noise is `normal`
    (standard normals `[N, S, S, 3]`) or drawn from `generator`."""
    n = pose.shape[0]
    if self._noise_range[1] == 0.0:
      table = plain_table(n, self._size, pose.device)
    else:
      if normal is None:
        normal = torch.randn((n, self._size, self._size, 3),
                             generator=generator, device=pose.device)
      table = sensor_table(normal, noise)
    return ProcGenState(
        pose=pose.float(), distractors=distractors.float(),
        num_distractors=num_distractors.to(torch.int32),
        half_extent=half_extent.float(), noise=noise.float(),
        drift=drift.float(), workspace=workspace.float(), table=table,
        t=torch.zeros((n,), dtype=torch.int32, device=pose.device))

  def scenario_bucket(self, state: ProcGenState) -> torch.Tensor:
    """int32 robustness-eval bucket ids (distractor counts) `[N]`."""
    return state.num_distractors

  # ---- rendering ----

  def _to_pixel(self, xy: torch.Tensor, workspace: torch.Tensor
                ) -> torch.Tensor:
    """World → pixel under each scenario's box (`workspace`
    broadcasting against `xy[..., 0]`), the PoseEnv mapping's order."""
    ws = workspace[..., None]
    frac = (xy + ws) / (2.0 * ws)
    return (frac * self._size).to(torch.int32).clamp(0, self._size - 1)

  def observe(self, state: ProcGenState) -> Dict[str, torch.Tensor]:
    size = self._size
    extent_px = (state.half_extent / (2.0 * state.workspace)
                 * size).to(torch.int32).clamp_min(1)
    # Distractors first (every slot, masked down to the sampled count),
    # the target last so it always occludes.
    centers = self._to_pixel(state.distractors, state.workspace[:, None])
    masks = block_mask(centers, extent_px[:, None], size)  # [N, M, S, S]
    slots = torch.arange(masks.shape[1], device=masks.device)
    active = slots < state.num_distractors[:, None]
    image = paint(state.table, (masks & active[..., None, None]).any(dim=1),
                  DISTRACTOR_COLOR)
    target = block_mask(self._to_pixel(state.pose, state.workspace),
                        extent_px, size)
    return {"image": paint(image, target, BLOCK_COLOR)}

  # ---- dynamics ----

  def grasp_reward(self, action: torch.Tensor,
                   pose: torch.Tensor) -> torch.Tensor:
    """The pose bandit's mapping: [-1, 1]² onto the BASE box."""
    half = torch.full((), _BASE_HALF_WIDTH, device=pose.device)
    return proximity_reward(action, pose, half, self._threshold)

  def step(self, state: ProcGenState, action: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           direction: Optional[torch.Tensor] = None
           ) -> Tuple[ProcGenState, Dict[str, torch.Tensor], torch.Tensor,
                      torch.Tensor]:
    """One step. The target slides `drift` along `direction` `[N, 2]`
    (unit vectors; by default (cos θ, sin θ) of an angle θ drawn from
    `generator`), one fused multiply-add per coordinate, as XLA's CPU
    program computes the JAX expression."""
    reward = self.grasp_reward(action, state.pose)
    if direction is None:
      angle = _uniform(generator, (state.pose.shape[0],), 0.0,
                       2.0 * math.pi)
      direction = torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)
    ws = state.workspace[:, None]
    pose = fused_multiply_add(state.drift[:, None], direction,
                              state.pose)
    pose = torch.minimum(torch.maximum(pose, -ws), ws)
    t_next = state.t + 1
    done = (reward > 0.5) | (t_next >= self._max_steps)
    next_state = dataclasses.replace(state, pose=pose, t=t_next)
    return next_state, self.observe(next_state), reward, done
