"""The port's functional envs (`tensor2robot_tpu_torch/envs/`) against the
JAX package's.

States come from the JAX `reset` and are carried over, with the sensor
noise the JAX env draws from each state's key injected as standard
normals; then `observe`, `step` (with the JAX drift direction injected),
`grasp_reward` and `scenario_bucket` must equal JAX's exactly. At noise
0 the frames equal the JAX frames and the numpy `PoseEnv`'s bit for bit.
Auto-reset, the terminal frame and seeded scenarios are pinned on the
port's own.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from tensor2robot_tpu import envs as jax_envs  # noqa: E402
from tensor2robot_tpu.research.pose_env import pose_env as jax_pose_env  # noqa: E402
from tensor2robot_tpu_torch import envs  # noqa: E402
from tensor2robot_tpu_torch.envs.core import num_envs_of  # noqa: E402
from tensor2robot_tpu_torch.research.pose_env import (  # noqa: E402
    PoseEnv,
    PoseGraspBandit,
    grade_grasp,
)

S = 16
N = 32


def _t(x):
  return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _jax_fns(family, **kwargs):
  """The JAX env and its jitted batched reset, noise draw, observe and
  step (each compiled once per module)."""
  cls = {"pose": jax_envs.PoseBanditEnv,
         "procgen": jax_envs.ProcGenGraspEnv}[family]
  env = cls(image_size=S, **dict(kwargs))
  normal = jax.jit(jax.vmap(lambda k: jax.random.normal(k, (S, S, 3))))
  return (env, jax.jit(jax.vmap(env.reset)), normal,
          jax.jit(jax.vmap(env.observe)), jax.jit(jax.vmap(env.step)))


def _port_env(family, **kwargs):
  cls = {"pose": envs.PoseBanditEnv, "procgen": envs.ProcGenGraspEnv}[family]
  return cls(image_size=S, **kwargs)


def _carried(family, env, js, normal):
  """The port's state holding a batch of JAX states."""
  if family == "pose":
    return env.state_at(_t(js.pose), normal=_t(normal))
  return env.scenario(_t(js.pose), _t(js.distractors),
                      _t(js.num_distractors), _t(js.half_extent),
                      _t(js.noise), _t(js.drift), _t(js.workspace),
                      normal=_t(normal))


def _both(family, seed, n=N, **kwargs):
  """(JAX fns, JAX states, port env, port states) from one JAX reset."""
  fns = _jax_fns(family, **kwargs)
  _, reset, normal, _, _ = fns
  js = reset(jax.random.split(jax.random.PRNGKey(seed), n))
  env = _port_env(family, **kwargs)
  return fns, js, env, _carried(family, env, js, normal(js.noise_key))


def _jax_directions(keys):
  """The unit drift directions the JAX procgen step draws from `keys`."""
  angle = jax.vmap(lambda k: jax.random.uniform(
      k, (), minval=0.0, maxval=2.0 * jnp.pi))(keys)
  return _t(jnp.stack([jnp.cos(angle), jnp.sin(angle)], axis=-1))


def _hits_and_misses(poses, n, seed):
  """Actions: exact grasps on even rows, uniform draws on odd ones."""
  rng = np.random.default_rng(seed)
  actions = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
  actions[::2] = np.asarray(poses)[::2] / np.float32(0.4)
  return actions


@pytest.mark.parametrize("family", ["pose", "procgen"])
def test_observe_equals_jax_with_its_noise(family):
  (_, _, _, observe, _), js, env, ts = _both(family, seed=3)
  want = np.asarray(observe(js)["image"])
  got = env.observe(ts)["image"].numpy()
  assert got.dtype == np.uint8 and got.shape == (N, S, S, 3)
  np.testing.assert_array_equal(got, want)
  # The noise is real: the background is not the flat grey.
  assert (got != 96).mean() > 0.1


@pytest.mark.parametrize("family", ["pose", "procgen"])
def test_step_equals_jax(family):
  kwargs = dict(max_episode_steps=3)
  (_, _, _, _, step), js, env, ts = _both(family, seed=4, **kwargs)
  actions = _hits_and_misses(js.pose, N, seed=1)
  keys = jax.random.split(jax.random.PRNGKey(9), N)
  jn, jobs, jr, jd = step(js, jnp.asarray(actions), keys)
  extra = ({} if family == "pose"
           else {"direction": _jax_directions(keys)})
  tn, tobs, tr, td = env.step(ts, _t(actions), **extra)
  np.testing.assert_array_equal(tn.pose.numpy(), np.asarray(jn.pose))
  np.testing.assert_array_equal(tn.t.numpy(), np.asarray(jn.t))
  np.testing.assert_array_equal(tobs["image"].numpy(),
                                np.asarray(jobs["image"]))
  np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
  np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
  assert 0.0 < tr.numpy().mean() < 1.0
  if family == "procgen":
    assert not np.array_equal(tn.pose.numpy(), ts.pose.numpy())  # drifted


@pytest.mark.parametrize("family", ["pose", "procgen"])
def test_grasp_reward_equals_jax(family):
  (jenv, _, _, _, _), js, env, _ = _both(family, seed=5, n=256)
  actions = np.random.default_rng(2).uniform(-1, 1, (256, 2)).astype(
      np.float32)
  # Grasps placed just inside and outside the threshold too.
  offsets = np.float32(0.1) * np.array([0.999, 1.001], np.float32)
  actions[:64] = (np.asarray(js.pose)[:64]
                  + np.stack([np.tile(offsets, 32), np.zeros(64)], -1)
                  .astype(np.float32)) / np.float32(0.4)
  want = np.asarray(jax.vmap(jenv.grasp_reward)(jnp.asarray(actions),
                                                js.pose))
  got = env.grasp_reward(_t(actions), _t(js.pose)).numpy()
  np.testing.assert_array_equal(got, want)
  assert 0.0 < got.mean() < 1.0


def test_scenario_bucket_equals_jax():
  (jenv, _, _, _, _), js, env, ts = _both("procgen", seed=6, n=128)
  np.testing.assert_array_equal(
      env.scenario_bucket(ts).numpy(),
      np.asarray(jax.vmap(jenv.scenario_bucket)(js)))
  assert set(env.scenario_bucket(ts).tolist()) == {0, 1, 2, 3}
  assert env.num_buckets == 4


def test_noiseless_pose_frames_bitwise():
  """At noise 0: the port's frames equal the JAX env's and the port's
  and the JAX package's numpy `PoseEnv`'s on the same poses."""
  port_host = PoseEnv(image_size=S, seed=5, noise=0.0)
  jax_host = jax_pose_env.PoseEnv(image_size=S, seed=5, noise=0.0)
  jenv = jax_envs.PoseBanditEnv(image_size=S, noise=0.0)
  env = envs.PoseBanditEnv(image_size=S, noise=0.0)
  for _ in range(8):
    host_obs = port_host.reset()
    np.testing.assert_array_equal(host_obs["image"],
                                  jax_host.reset()["image"])
    got = env.observe(env.state_at(port_host.pose))["image"][0].numpy()
    np.testing.assert_array_equal(got, host_obs["image"])
    want = jenv.observe(jenv.state_at(port_host.pose,
                                      jax.random.PRNGKey(0)))["image"]
    np.testing.assert_array_equal(got, np.asarray(want))


def test_noiseless_procgen_frames_bitwise():
  (_, _, _, observe, _), js, env, ts = _both(
      "procgen", seed=7, noise_range=(0.0, 0.0))
  np.testing.assert_array_equal(env.observe(ts)["image"].numpy(),
                                np.asarray(observe(js)["image"]))
  assert (ts.table.numpy() == 96).all()


def test_host_grade_equals_device_reward():
  host = PoseGraspBandit(image_size=S, physics=False, seed=3)
  device = envs.host_parity_env(host)
  _, poses = host.reset_batch(64)
  actions = np.random.default_rng(0).uniform(-1, 1, (64, 2)).astype(
      np.float32)
  actions[::4] = poses[::4] / np.float32(0.4)
  np.testing.assert_array_equal(
      host.grade(actions, poses),
      device.grasp_reward(_t(actions), _t(poses)).numpy())
  np.testing.assert_array_equal(
      grade_grasp(actions, poses, 0.1),
      device.grasp_reward(_t(actions), _t(poses)).numpy())


def test_auto_reset_at_step_limit():
  env = envs.PoseBanditEnv(image_size=8, max_episode_steps=3)
  wrapped = envs.AutoResetEnv(env)
  g = torch.Generator().manual_seed(0)
  state = wrapped.reset(g, 4)
  pose0 = state.pose.clone()
  miss = torch.ones((4, 2))  # the corner: never within the threshold
  for t in range(2):
    state, _, reward, done = wrapped.step(state, miss, g)
    assert not done.any() and (reward == 0).all()
    torch.testing.assert_close(state.pose, pose0, rtol=0, atol=0)
    assert (state.t == t + 1).all()
  state, _, _, done = wrapped.step(state, miss, g)
  assert done.all()
  assert (state.t == 0).all()  # a fresh episode: clock zeroed, new block
  assert not torch.equal(state.pose, pose0)


def test_terminal_frame_is_the_old_episode():
  env = envs.PoseBanditEnv(image_size=8, noise=0.0, max_episode_steps=1)
  wrapped = envs.AutoResetEnv(env)
  g = torch.Generator().manual_seed(1)
  state = wrapped.reset(g, 4)
  new_state, obs, _, done = wrapped.step(state, torch.ones((4, 2)), g)
  assert done.all()
  old = env.observe(env.state_at(state.pose))["image"]
  assert torch.equal(obs["image"], old)
  assert not torch.equal(wrapped.observe(new_state)["image"], old)


def test_only_done_envs_reset():
  env = envs.PoseBanditEnv(image_size=8, max_episode_steps=5)
  wrapped = envs.AutoResetEnv(env)
  g = torch.Generator().manual_seed(2)
  state = wrapped.reset(g, 6)
  actions = torch.ones((6, 2))
  actions[:3] = state.pose[:3] / 0.4  # exact grasps end those episodes
  new_state, _, reward, done = wrapped.step(state, actions, g)
  assert done.tolist() == [True] * 3 + [False] * 3
  assert (reward[:3] == 1).all()
  assert torch.equal(new_state.pose[3:], state.pose[3:])
  assert torch.equal(new_state.table[3:], state.table[3:])
  assert (new_state.t == torch.tensor([0, 0, 0, 1, 1, 1],
                                      dtype=torch.int32)).all()
  assert not torch.equal(new_state.pose[:3], state.pose[:3])


@pytest.mark.parametrize("family", ["pose", "procgen"])
def test_same_seed_same_scenario(family):
  env = _port_env(family)
  a = env.reset(torch.Generator().manual_seed(7), 16)
  b = env.reset(torch.Generator().manual_seed(7), 16)
  c = env.reset(torch.Generator().manual_seed(8), 16)
  for name in a.__dataclass_fields__:
    assert torch.equal(getattr(a, name), getattr(b, name)), name
  assert torch.equal(env.observe(a)["image"], env.observe(b)["image"])
  assert not torch.equal(a.pose, c.pose)
  assert torch.unique(a.pose, dim=0).shape[0] == 16  # envs independent
  assert num_envs_of(a) == 16


def test_procgen_scenarios_vary():
  env = envs.ProcGenGraspEnv(image_size=S, max_distractors=3)
  state = env.reset(torch.Generator().manual_seed(0), 128)
  assert set(env.scenario_bucket(state).tolist()) == {0, 1, 2, 3}
  assert state.half_extent.std() > 0 and state.workspace.std() > 0
  assert ((state.pose.abs() <= state.workspace[:, None]).all())
  lo, hi = 0.4 * 0.6, 0.4
  assert ((state.workspace >= lo * 0.999) & (state.workspace <= hi)).all()


@pytest.mark.parametrize("family", ["pose", "procgen"])
def test_draws_do_not_depend_on_data(family):
  """A step's and a reset's use of the generator depends on the sizes
  only (a CUDA graph captures it): different actions and states leave
  the generator in the same place."""
  wrapped = envs.AutoResetEnv(_port_env(family, max_episode_steps=2))
  after = []
  for seed, act in ((0, 1.0), (1, -0.3)):
    state = wrapped.reset(torch.Generator().manual_seed(seed), 8)
    g = torch.Generator().manual_seed(11)
    wrapped.step(state, torch.full((8, 2), act), g)
    after.append(torch.rand(4, generator=g))
  assert torch.equal(after[0], after[1])


def test_select_state_broadcasts_from_the_left():
  env = envs.ProcGenGraspEnv(image_size=8)
  a = env.reset(torch.Generator().manual_seed(0), 4)
  b = env.reset(torch.Generator().manual_seed(1), 4)
  done = torch.tensor([True, False, True, False])
  mixed = envs.select_state(done, a, b)
  for name in a.__dataclass_fields__:
    got = getattr(mixed, name)
    assert torch.equal(got[0], getattr(a, name)[0]), name
    assert torch.equal(got[1], getattr(b, name)[1]), name


def test_bad_arguments_raise():
  with pytest.raises(ValueError, match="grasp point"):
    envs.PoseBanditEnv(action_dim=1)
  with pytest.raises(ValueError, match="max_episode_steps"):
    envs.ProcGenGraspEnv(max_episode_steps=0)
  with pytest.raises(ValueError, match="min_workspace_scale"):
    envs.ProcGenGraspEnv(min_workspace_scale=0.0)
  with pytest.raises(ValueError, match="num_envs"):
    envs.BatchedEnv(envs.PoseBanditEnv(), 0)
