"""The pose / grasp-point bandit as a batched functional env (port of
`envs/pose.py`).

An episode is a block at a planar pose in the PoseEnv workspace box; the
observation is the rendered RGB image; the action is a normalized grasp
point in [-1, 1]² mapped onto the box (``action[:2] * WORKSPACE_HIGH``);
the reward is 1 when the grasp lands within ``success_threshold`` world
units of the pose. The geometry (box, world → pixel mapping, block
extent, colours) is the numpy `PoseEnv`'s, in the same f32 operation
order, so at ``noise=0`` the frames of matched poses equal the numpy
renderer's and the JAX env's bit for bit, and `grasp_reward` is
`grade_grasp`'s float math.

``max_episode_steps > 1`` makes the bandit a short refinement episode
(re-grasp until success or the step limit).

A CUDA graph captures `reset`, `observe` and `step`: every constant is
made on the device by a fill (`torch.full`), never copied from the host,
and every division divides by a device tensor (CUDA divides by a host
scalar as a multiply by its reciprocal, which may round differently).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.envs.core import FunctionalEnv
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    IMAGE_SIZE,
    WORKSPACE_HIGH,
    WORKSPACE_LOW,
)

# Shared scene palette (the numpy PoseEnv renderer's constants).
BACKGROUND = 96
BLOCK_COLOR = (200, 40, 40)


@dataclasses.dataclass(frozen=True)
class PoseState:
  """A batch of episodes: the block poses, each episode's noisy table
  (its sensor noise, drawn once at reset) and the step counters."""

  pose: torch.Tensor   # [N, 2] f32 world units
  table: torch.Tensor  # [N, S, S, 3] uint8 background with sensor noise
  t: torch.Tensor      # [N] int32


def _box(device) -> Tuple[torch.Tensor, torch.Tensor]:
  """The workspace box's low and high corners as f32 scalars on `device`
  (the box is square: both axes span the same range)."""
  return (torch.full((), float(WORKSPACE_LOW[0]), device=device),
          torch.full((), float(WORKSPACE_HIGH[0]), device=device))


def world_to_pixel(xy: torch.Tensor, image_size: int) -> torch.Tensor:
  """The numpy `PoseEnv._world_to_pixel` mapping on `[..., 2]` world
  points: f32 in its order, truncation toward zero, then the clip."""
  low, high = _box(xy.device)
  frac = (xy - low) / (high - low)
  return (frac * image_size).to(torch.int32).clamp(0, image_size - 1)


def fused_multiply_add(a: torch.Tensor, b: torch.Tensor,
                       c: Union[float, torch.Tensor]) -> torch.Tensor:
  """`a·b + c` of f32 tensors with ONE rounding to f32, as an FMA gives
  (XLA's CPU program fuses the JAX envs' multiply-adds so): the product
  is exact in f64, the sum rounds to f64 and then to f32, which differs
  from the single rounding only if the f64 sum lands exactly on an f32
  rounding midpoint. The same on every device (`torch.addcmul` fuses on
  the CPU but not on CUDA)."""
  c = c.double() if isinstance(c, torch.Tensor) else c
  return (a.double() * b.double() + c).float()


def sensor_table(normal: torch.Tensor,
                 sigma: Union[float, torch.Tensor]) -> torch.Tensor:
  """The noisy grey table `[N, S, S, 3]` uint8 from standard normals of
  that shape and a noise level (a float, or `[N]` f32): the JAX
  renderers' `clip(96 + (255·σ)·normal, 0, 255)`, the product in f32 and
  the add fused, then truncated."""
  if isinstance(sigma, torch.Tensor):
    scale = (sigma.float() * 255.0).reshape(-1, 1, 1, 1)
  else:
    scale = torch.full((), 255.0 * sigma, device=normal.device)
  return fused_multiply_add(scale, normal.float(), float(BACKGROUND)).clamp(
      0, 255).to(torch.uint8)


def plain_table(num_envs: int, image_size: int, device) -> torch.Tensor:
  """The noiseless table: every pixel the background grey."""
  return torch.full((num_envs, image_size, image_size, 3), BACKGROUND,
                    dtype=torch.uint8, device=device)


def block_mask(center: torch.Tensor, extent: Union[int, torch.Tensor],
               image_size: int) -> torch.Tensor:
  """`[..., S, S]` bool: the inclusive box ``rows cy-e..cy+e`` × ``cols
  cx-e..cx+e`` around integer centers `[..., 2]` (x, y); `extent` a
  Python int or an int tensor broadcasting against `center[..., 0]`."""
  rows = torch.arange(image_size, device=center.device)
  extent = (extent if isinstance(extent, int) else extent[..., None])
  cx = center[..., 0:1]
  cy = center[..., 1:2]
  in_y = (rows >= cy - extent) & (rows <= cy + extent)
  in_x = (rows >= cx - extent) & (rows <= cx + extent)
  return in_y[..., :, None] & in_x[..., None, :]


def paint(image: torch.Tensor, mask: torch.Tensor, color) -> torch.Tensor:
  """`image` with the pixels under `mask` `[N, S, S]` set to `color`."""
  value = torch.stack([torch.full((), c, dtype=torch.uint8,
                                  device=image.device) for c in color])
  return torch.where(mask[..., None], value, image)


def render_block_scene(pose: torch.Tensor, table: torch.Tensor,
                       extent_px: int) -> torch.Tensor:
  """The PoseEnv scene: the (noisy) table with the red block at `pose`.
  Noise lies on the background only, block pixels are exact, as the
  numpy renderer composes them."""
  center = world_to_pixel(pose, table.shape[1])
  return paint(table, block_mask(center, extent_px, table.shape[1]),
               BLOCK_COLOR)


def proximity_reward(action: torch.Tensor, pose: torch.Tensor,
                     half_width, threshold: float) -> torch.Tensor:
  """`grade_grasp`'s rule on a batch: ``action[:, :2] · half_width`` →
  distance to `pose` (the two squares summed, then the root, each step
  rounded in f32) → 1.0 where below `threshold` (as f32)."""
  grasp = action[:, :2].float() * half_width
  d = grasp - pose.float()
  dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
  limit = torch.full((), threshold, device=dist.device)
  return (dist < limit).float()


@gin.configurable
class PoseBanditEnv(FunctionalEnv):
  """Functional pose/grasp bandit over the PoseEnv workspace box."""

  def __init__(self,
               image_size: int = IMAGE_SIZE,
               action_dim: int = 2,
               success_threshold: float = 0.1,
               block_half_extent: float = 0.06,
               noise: float = 0.02,
               max_episode_steps: int = 1):
    """Defaults mirror `PoseGraspBandit` / `PoseEnv`: threshold 0.1
    world units on the ±0.4 box (~5% random baseline), 0.06 block
    half-extent, 2% sensor noise. `action_dim` >= 2; extra dims ride
    along unused."""
    if action_dim < 2:
      raise ValueError(
          f"action_dim must be >= 2 (grasp point), got {action_dim}")
    if max_episode_steps < 1:
      raise ValueError(
          f"max_episode_steps must be >= 1, got {max_episode_steps}")
    self._size = int(image_size)
    self._action_dim = int(action_dim)
    self._threshold = float(success_threshold)
    self._half = float(block_half_extent)
    self._noise = float(noise)
    self._max_steps = int(max_episode_steps)
    # Static pixel extent: the numpy renderer's formula.
    self._extent_px = max(1, int(
        self._half / float(WORKSPACE_HIGH[0] - WORKSPACE_LOW[0])
        * self._size))

  @property
  def action_dim(self) -> int:
    return self._action_dim

  @property
  def image_size(self) -> int:
    return self._size

  def observation_shapes(self) -> Dict[str, tuple]:
    return {"image": (self._size, self._size, 3)}

  def _table(self, n: int, device, generator=None,
             normal: Optional[torch.Tensor] = None) -> torch.Tensor:
    if self._noise == 0.0:
      return plain_table(n, self._size, device)
    if normal is None:
      normal = torch.randn((n, self._size, self._size, 3),
                           generator=generator, device=device)
    return sensor_table(normal, self._noise)

  def reset(self, generator: torch.Generator, num_envs: int) -> PoseState:
    device = generator.device
    low, high = _box(device)
    u = torch.rand((num_envs, 2), generator=generator, device=device)
    pose = low + (high - low) * u
    return PoseState(
        pose=pose, table=self._table(num_envs, device, generator),
        t=torch.zeros((num_envs,), dtype=torch.int32, device=device))

  def state_at(self, pose, generator: Optional[torch.Generator] = None,
               normal: Optional[torch.Tensor] = None) -> PoseState:
    """Episodes at GIVEN poses `[N, 2]`: the matched-geometry seam of
    the host-vs-device parity checks. Their noise is `normal` (standard
    normals `[N, S, S, 3]`, e.g. the JAX env's draw) or drawn from
    `generator`; at ``noise=0`` neither is needed."""
    device = (normal.device if normal is not None else
              generator.device if generator is not None else None)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    pose = pose.reshape(-1, 2)
    n = pose.shape[0]
    return PoseState(
        pose=pose, table=self._table(n, pose.device, generator, normal),
        t=torch.zeros((n,), dtype=torch.int32, device=pose.device))

  def observe(self, state: PoseState) -> Dict[str, torch.Tensor]:
    return {"image": render_block_scene(state.pose, state.table,
                                        self._extent_px)}

  def grasp_reward(self, action: torch.Tensor,
                   pose: torch.Tensor) -> torch.Tensor:
    """`PoseGraspBandit.grade` on a batch."""
    return proximity_reward(action, pose, _box(pose.device)[1],
                            self._threshold)

  def step(self, state: PoseState, action: torch.Tensor,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[PoseState, Dict[str, torch.Tensor], torch.Tensor,
                      torch.Tensor]:
    del generator  # the block has settled; transitions are deterministic
    reward = self.grasp_reward(action, state.pose)
    t_next = state.t + 1
    done = (reward > 0.5) | (t_next >= self._max_steps)
    next_state = dataclasses.replace(state, t=t_next)
    return next_state, self.observe(next_state), reward, done


def host_parity_env(bandit) -> PoseBanditEnv:
  """A `PoseBanditEnv` geometry-matched to a host `PoseGraspBandit`
  (same image size, action width, threshold)."""
  return PoseBanditEnv(
      image_size=bandit.env.image_size,
      action_dim=bandit.action_dim,
      success_threshold=bandit.success_threshold)
