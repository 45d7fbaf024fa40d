"""`MuJoCoPoseEnv` (`research/pose_env/mujoco_pose_env.py`) against the
JAX package's, on the CPU (the card's machine has no `mujoco`, so no
chip phase drives it).

  * Over several seeds and resets the settled poses, the drop poses, the
    settle step counts and the rendered observations equal JAX's bit for
    bit: the same numpy draws in the same order (drop xy, yaw,
    `qvel[:2]`, `qvel[5]`) and the same `mj_step` loop with the same
    `step > 10` settle test, on the same `mujoco`.
  * `max_settle_steps < 1` raises JAX's ValueError before `mujoco` is
    imported; `max_attempts` drops that all leave the workspace raise
    JAX's RuntimeError; without `mujoco` the constructor raises an
    ImportError naming the package.
  * `PoseGraspBandit(physics=True)` and `collect_random_episodes(env_cls=
    MuJoCoPoseEnv)` run on it.
"""

import sys

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("mujoco")

from tensor2robot_tpu.research.pose_env import (  # noqa: E402
    mujoco_pose_env as jax_env_lib,
)
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    PoseGraspBandit,
    collect_random_episodes,
)
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    mujoco_pose_env as env_lib,
)


@pytest.mark.parametrize("seed,kwargs", [
    (0, {}), (1, {}), (7, {"image_size": 32}),
    (3, {"drop_height": 0.1, "settle_speed": 1e-2})])
def test_settled_poses_and_observations_equal_jax_bit_for_bit(seed, kwargs):
  port = env_lib.MuJoCoPoseEnv(seed=seed, **kwargs)
  ref = jax_env_lib.MuJoCoPoseEnv(seed=seed, **kwargs)
  for _ in range(3):
    got, want = port.reset(), ref.reset()
    np.testing.assert_array_equal(got["image"], want["image"])
    assert got["image"].dtype == want["image"].dtype
    np.testing.assert_array_equal(port.pose, ref.pose)
    np.testing.assert_array_equal(port.last_drop_pose, ref.last_drop_pose)
    assert port.last_settle_steps == ref.last_settle_steps
    assert port.pose.dtype == np.float32


def test_config_errors_are_jax():
  for env in (env_lib.MuJoCoPoseEnv, jax_env_lib.MuJoCoPoseEnv):
    with pytest.raises(ValueError, match="max_settle_steps must be >= 1"):
      env(max_settle_steps=0)
  port = env_lib.MuJoCoPoseEnv(seed=2)
  ref = jax_env_lib.MuJoCoPoseEnv(seed=2)
  port._settle_once = ref._settle_once = lambda: None
  messages = []
  for env in (port, ref):
    with pytest.raises(RuntimeError, match="in 3 attempts") as info:
      env.reset(max_attempts=3)
    messages.append(str(info.value))
  assert messages[0] == messages[1]


def test_without_mujoco_the_constructor_names_the_package(monkeypatch):
  monkeypatch.setitem(sys.modules, "mujoco", None)
  with pytest.raises(ImportError, match="`mujoco` package"):
    env_lib.MuJoCoPoseEnv()
  with pytest.raises(ValueError, match="max_settle_steps"):
    env_lib.MuJoCoPoseEnv(max_settle_steps=0)  # checked before the import


def test_the_physics_bandit_and_collection_run(tmp_path):
  bandit = PoseGraspBandit(image_size=16, seed=1)
  assert isinstance(bandit.env, env_lib.MuJoCoPoseEnv)
  obs, poses = bandit.reset_batch(2)
  assert obs["image"].shape == (2, 16, 16, 3) and poses.shape == (2, 2)
  path = str(tmp_path / "phys.tfrecord")
  collect_random_episodes(path, num_episodes=3, image_size=16,
                          env_cls=env_lib.MuJoCoPoseEnv)
  from tensor2robot_tpu_torch.data import tfrecord_io
  assert len(list(tfrecord_io.iterate_records(path))) == 3
