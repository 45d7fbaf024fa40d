"""The port's fleet actor (`fleet/actor.py`) against the JAX package's,
on the CPU.

  * `build_env(config, i)` for `"toy_grasp"` and `"pose"` yields JAX's
    observations, grades and rewards for the same seeds; `"mujoco_pose"`
    raises naming ROADMAP A10a.
  * Against a stub server whose policy returns fixed actions, the
    port's `actor_main` commits JAX's episodes: every transition row,
    the actor id and the policy stamps, batch for batch (both run in a
    thread of this process, each against a server of its own package).
  * An actor process (spawned, as the orchestrator spawns it) commits
    episodes, reports `proc.cuda_initialized` 0 in its final telemetry
    push and exits 0 when its stop event is set.
"""

import multiprocessing as mp
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from tensor2robot_tpu.fleet import actor as jax_actor  # noqa: E402
from tensor2robot_tpu.fleet import orchestrator as jax_orch  # noqa: E402
from tensor2robot_tpu.fleet import rpc as jax_rpc  # noqa: E402
from tensor2robot_tpu_torch.fleet import actor  # noqa: E402
from tensor2robot_tpu_torch.fleet import orchestrator as orch  # noqa: E402
from tensor2robot_tpu_torch.fleet import rpc  # noqa: E402
from tensor2robot_tpu_torch.telemetry import core as tcore  # noqa: E402
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics  # noqa: E402
from tensor2robot_tpu_torch.telemetry import perf as perf_lib  # noqa: E402

_KW = dict(image_size=16, action_dim=2, batch_episodes=8, epsilon=0.3,
           seed=5, telemetry_dir="", telemetry_poll_secs=0.0,
           rpc_call_timeout_secs=30.0)


@pytest.fixture(autouse=True)
def _isolated():
  yield
  perf_lib.stop_resource_sampler()
  tcore.reset_for_tests()
  tmetrics.reset_for_tests()


@pytest.mark.parametrize("env", ["toy_grasp", "pose"])
@pytest.mark.parametrize("index", [0, 1, 3])
def test_build_env_equals_jax(env, index):
  port_env = actor.build_env(orch.FleetConfig(env=env, **_KW), index)
  jax_env = jax_actor.build_env(jax_orch.FleetConfig(env=env, **_KW), index)
  rng = np.random.default_rng(index)
  for n in (8, 3):
    port_obs, port_pos = port_env.reset_batch(n)
    jax_obs, jax_pos = jax_env.reset_batch(n)
    assert port_obs.keys() == jax_obs.keys()
    for key in port_obs:
      assert port_obs[key].dtype == jax_obs[key].dtype
      assert np.array_equal(port_obs[key], jax_obs[key])
    assert np.array_equal(port_pos, jax_pos)
    actions = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    actions[0] = port_pos[0] / np.max(np.abs(port_pos)) * 0.1
    assert np.array_equal(port_env.grade(actions, port_pos),
                          jax_env.grade(actions, jax_pos))
  assert port_env.action_dim == jax_env.action_dim


def test_physics_env_names_a10a():
  """`mujoco_pose` (A10a, ported) builds the physics bandit, JAX's for the
  same actor seed: the same settled poses and images. (The name is kept
  from when the port refused it naming A10a.)"""
  port_env = actor.build_env(orch.FleetConfig(env="mujoco_pose", **_KW), 1)
  jax_env = jax_actor.build_env(jax_orch.FleetConfig(env="mujoco_pose",
                                                     **_KW), 1)
  port_obs, port_pos = port_env.reset_batch(2)
  jax_obs, jax_pos = jax_env.reset_batch(2)
  np.testing.assert_array_equal(port_pos, jax_pos)
  np.testing.assert_array_equal(port_obs["image"], jax_obs["image"])


class _Stub:
  """A fleet host's act/commit surface: fixed actions (a function of the
  row index only), every commit recorded; stops the actor after
  `commits` of them."""

  def __init__(self, rpc_lib, commits, stop):
    self.commits, self.pushes = [], []
    self._want, self._stop = commits, stop
    self.server = rpc_lib.RpcServer(self.handle, authkey=b"stub")

  def handle(self, method, payload, ctx):
    if method == "hello":
      return {"max_batch": 4, "capacity": 512, "params_version": 3,
              "params_learner_step": 7, "monotonic": time.monotonic()}
    if method == "act":
      n = len(payload["image"])
      actions = np.linspace(-0.5, 0.5, 2 * n, dtype=np.float32)
      return {"actions": actions.reshape(n, 2), "params_version": 3,
              "params_learner_step": 7, "params_hop": 0}
    if method == "commit":
      self.commits.append(payload)
      if len(self.commits) >= self._want:
        self._stop.set()
      return True
    if method == "telemetry_push":
      self.pushes.append(payload)
      return True
    if method == "__disconnect__":
      return None
    raise ValueError(method)


def _thread_run(actor_lib, rpc_lib, config, index, commits):
  stop = threading.Event()
  stub = _Stub(rpc_lib, commits, stop)
  try:
    thread = threading.Thread(target=actor_lib.actor_main, args=(
        config, index, stub.server.address, stop, None))
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
  finally:
    stub.server.close(timeout_secs=0.5)
  return stub.commits


@pytest.mark.parametrize("env", ["toy_grasp", "pose"])
def test_committed_episodes_equal_jax(env):
  kwargs = dict(_KW, env=env, authkey=b"stub")
  port = _thread_run(actor, rpc, orch.FleetConfig(**kwargs), 1, 3)
  jax = _thread_run(jax_actor, jax_rpc, jax_orch.FleetConfig(**kwargs), 1, 3)
  assert len(port) == len(jax) == 3
  for got, want in zip(port, jax):
    assert got.keys() == want.keys()
    assert got["actor_id"] == want["actor_id"] == "actor-1"
    for stamp in ("policy_version", "policy_learner_step", "policy_hop"):
      assert got[stamp] == want[stamp]
    assert got["transitions"].keys() == want["transitions"].keys()
    for key, value in got["transitions"].items():
      assert value.dtype == want["transitions"][key].dtype
      assert np.array_equal(value, want["transitions"][key]), key


def test_an_actor_process_never_touches_cuda(tmp_path):
  ctx = mp.get_context("spawn")
  stop = ctx.Event()
  heartbeat = ctx.Value("d", 0.0)
  stub = _Stub(rpc, 2, threading.Event())
  config = orch.FleetConfig(env="pose", authkey=b"stub", **dict(
      _KW, telemetry_dir=str(tmp_path), telemetry_poll_secs=1.0))
  process = ctx.Process(target=actor.actor_main, args=(
      config, 0, stub.server.address, stop, heartbeat), daemon=True)
  process.start()
  try:
    deadline = time.monotonic() + 120
    while len(stub.commits) < 2 and time.monotonic() < deadline:
      time.sleep(0.05)
    assert len(stub.commits) >= 2
    stop.set()
    process.join(timeout=60)
    assert process.exitcode == 0
    assert heartbeat.value > 0.0
    final = stub.pushes[-1]
    assert final["role"] == "actor-0"
    assert final["snapshot"]["gauges"]["proc.cuda_initialized"] == 0.0
    assert final["snapshot"]["gauges"]["actor.episodes_collected"] >= 16
  finally:
    if process.is_alive():
      process.kill()
    stub.server.close(timeout_secs=0.5)
