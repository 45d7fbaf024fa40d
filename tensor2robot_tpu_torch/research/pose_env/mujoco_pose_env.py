"""Physics-backed pose environment: MuJoCo contact dynamics (port of
`research/pose_env/mujoco_pose_env.py`).

`reset()` drops the block over the table at a random planar position,
height, yaw and lateral velocity, then steps MuJoCo's contact dynamics
until the block settles (or the step budget runs out). The label is the
settled pose; a settle outside the workspace is rejected and the drop
resampled, up to `max_attempts`. The observation comes from `PoseEnv`'s
numpy rasterizer at the settled pose.

The port draws from the numpy generator in JAX's order (the drop's xy,
its yaw, `qvel[:2]`, `qvel[5]`) and runs the same `mj_step` loop with the
same `step > 10` settle test, so on the same `mujoco` a seed gives the
same settled poses and observations bit for bit. `mujoco` is imported
inside the constructor, after the `max_settle_steps` check, so importing
the package never needs it; without it the constructor raises
`ImportError` naming the package (no fallback).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.research.pose_env.pose_env import (
    IMAGE_SIZE,
    WORKSPACE_HIGH,
    WORKSPACE_LOW,
    PoseEnv,
)

_SCENE_XML = """
<mujoco model="pose_env">
  <option timestep="0.004"/>
  <worldbody>
    <geom name="table" type="plane" size="2 2 0.1" friction="0.8 0.005 0.0001"/>
    <body name="block" pos="0 0 1">
      <freejoint name="block_joint"/>
      <geom name="block_geom" type="box" size="{half} {half} {half}"
            density="400" friction="0.8 0.005 0.0001"/>
    </body>
  </worldbody>
</mujoco>
"""


@gin.configurable
class MuJoCoPoseEnv(PoseEnv):
  """Pose task with MuJoCo-settled block poses (the module docstring)."""

  def __init__(self, image_size: int = IMAGE_SIZE, seed: int = 0,
               block_half_extent: float = 0.06, noise: float = 0.02,
               drop_height: float = 0.25,
               max_settle_steps: int = 1500,
               settle_speed: float = 1e-3):
    if max_settle_steps < 1:
      raise ValueError(
          f"max_settle_steps must be >= 1 (got {max_settle_steps}): "
          "the settle loop needs at least one physics step to produce "
          "a pose.")
    super().__init__(image_size=image_size, seed=seed,
                     block_half_extent=block_half_extent, noise=noise)
    try:
      import mujoco
    except ImportError as e:
      raise ImportError(
          "MuJoCoPoseEnv needs the `mujoco` package, which is not "
          "installed; the numpy PoseEnv runs without it") from e
    self._mujoco = mujoco
    self._model = mujoco.MjModel.from_xml_string(
        _SCENE_XML.format(half=block_half_extent))
    self._data = mujoco.MjData(self._model)
    self._drop_height = drop_height
    self._max_settle_steps = max_settle_steps
    self._settle_speed = settle_speed
    self.last_drop_pose: Optional[np.ndarray] = None
    self.last_settle_steps: int = 0

  def _settle_once(self) -> Optional[np.ndarray]:
    """One drop → the settled planar pose, or None if it left the
    workspace."""
    mujoco = self._mujoco
    rng = self._rng
    drop_xy = rng.uniform(WORKSPACE_LOW, WORKSPACE_HIGH)
    yaw = rng.uniform(0, 2 * np.pi)
    mujoco.mj_resetData(self._model, self._data)
    # Free joint qpos: [x, y, z, qw, qx, qy, qz].
    self._data.qpos[:3] = (drop_xy[0], drop_xy[1],
                           self._half + self._drop_height)
    self._data.qpos[3:7] = (np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2))
    # A lateral shove, so settles move off the drop point.
    self._data.qvel[:2] = rng.uniform(-0.5, 0.5, size=2)
    self._data.qvel[5] = rng.uniform(-2.0, 2.0)  # yaw spin
    self.last_drop_pose = drop_xy.astype(np.float32)
    for step in range(self._max_settle_steps):
      mujoco.mj_step(self._model, self._data)
      if (step > 10
          and float(np.linalg.norm(self._data.qvel)) < self._settle_speed):
        break
    self.last_settle_steps = step + 1
    settled = self._data.qpos[:2].astype(np.float32)
    inside = np.all((settled >= WORKSPACE_LOW) & (settled <= WORKSPACE_HIGH))
    return settled if inside else None

  def reset(self, max_attempts: int = 50) -> Dict[str, np.ndarray]:
    """Drops until a block settles inside the workspace; renders it.
    Raises after `max_attempts` drops that all left it."""
    for _ in range(max_attempts):
      settled = self._settle_once()
      if settled is not None:
        self._pose = settled
        return self._observation()
    raise RuntimeError(
        f"No drop settled inside the workspace in {max_attempts} "
        "attempts — drop_height/velocity/friction leave the block "
        "outside [{}, {}]; retune the env config.".format(
            WORKSPACE_LOW.tolist(), WORKSPACE_HIGH.tolist()))
