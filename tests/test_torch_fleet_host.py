"""The port's replay/serving host (`fleet/host.py`) in a process of its
own, on the CPU (`FleetConfig.device = "cpu"`), as the JAX package's
`tests/test_fleet.py` pins its host.

  * Publications: each `publish` is served from then on, once per
    version: the version moves by one, the served params are the
    published ones bit for bit (their digests), `act` replies carry the
    version and the learner step it was published at, and a learner
    step going backward is recorded as a resume.
  * A staged episode whose connection drops lands no rows; a committed
    one lands whole with its lag stamp, from a port client and from a
    JAX client alike.
"""

import multiprocessing as mp
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from tensor2robot_tpu.fleet import rpc as jax_rpc  # noqa: E402
from tensor2robot_tpu_torch.fleet import host as host_lib  # noqa: E402
from tensor2robot_tpu_torch.fleet import learner as learner_lib  # noqa: E402
from tensor2robot_tpu_torch.fleet import orchestrator as orch  # noqa: E402
from tensor2robot_tpu_torch.fleet.rpc import RpcClient  # noqa: E402


def _config():
  return orch.FleetConfig(
      num_actors=2, env="toy_grasp", image_size=16, action_dim=2,
      torso_filters=(8,), head_filters=(8,), dense_sizes=(16,),
      cem_population=8, cem_iterations=1, cem_elites=2, batch_size=16,
      max_train_steps=16, min_replay_size=32, publish_every_steps=8,
      log_every_steps=8, batch_episodes=8, serve_max_batch=4,
      replay_capacity=512, replay_shards=1, heartbeat_timeout_secs=0.0,
      seed=0, device="cpu", telemetry_dir="")


@pytest.fixture(scope="module")
def host():
  ctx = mp.get_context("spawn")
  config = _config()
  parent_conn, child_conn = ctx.Pipe()
  stop = ctx.Event()
  heartbeat = ctx.Value("d", 0.0)
  process = ctx.Process(target=host_lib.host_main,
                        args=(config, child_conn, stop, heartbeat),
                        name="t2r-fleet-host", daemon=True)
  process.start()
  child_conn.close()
  assert parent_conn.poll(240.0), "host never reported ready"
  address = tuple(parent_conn.recv()["address"])
  parent_conn.close()
  yield config, address
  stop.set()
  process.join(timeout=30.0)
  if process.is_alive():
    process.kill()
    process.join(5.0)
  assert process.exitcode == 0


def _transitions(n=4, size=16):
  rng = np.random.default_rng(n)
  return {
      "image": rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8),
      "action": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
      "reward": np.ones((n, 1), np.float32),
      "done": np.ones((n, 1), np.float32),
      "next_image": np.zeros((n, size, size, 3), np.uint8),
  }


def test_publications_are_served_once_per_version(host):
  config, address = host
  client = RpcClient(address, authkey=config.authkey)
  hello = client.call("hello")
  assert hello["params_version"] == 0 and hello["max_batch"] == 4
  learner = host_lib._build_learner(config)
  obs = {"image": _transitions(3)["image"]}
  versions = []
  for version, (seed, step) in enumerate([(1, 8), (2, 16), (3, 24)], 1):
    train_state = learner.create_state(seed).train_state
    published = learner_lib.publication(train_state)
    assert client.call("publish", {"step": step, "state": published,
                                   "origin_wall": time.time(),
                                   "hop": 0}) == version
    reply = client.call("act", obs)
    assert reply["actions"].shape == (3, 2)
    assert (reply["params_version"], reply["params_learner_step"]) == (
        version, step)
    metrics = client.call("metrics")
    assert metrics["publishes"] == version
    assert metrics["params_version"] == version
    assert metrics["params_learner_step"] == step
    # What the engine serves is the publication, bit for bit.
    assert metrics["served_params_sha256"] == (
        host_lib.served_params_digests(host_lib._train_state(published)))
    assert metrics["cuda_initialized"] is False
    versions.append(metrics["served_params_sha256"])
  assert len({tuple(sorted(v.items())) for v in versions}) == 3
  # The learner's step going backward is a resume the host witnesses.
  for step in (24, 30, 16, 20):
    client.call("set_learner_step", step)
  assert client.call("metrics")["learner_resumes"] == [
      {"from_step": 30, "to_step": 16}]
  client.close()


@pytest.mark.parametrize("client_lib", ["port", "jax"])
def test_dropped_connection_aborts_the_staged_episode(host, client_lib):
  config, address = host
  client_cls = RpcClient if client_lib == "port" else jax_rpc.RpcClient
  observer = RpcClient(address, authkey=config.authkey)
  before = observer.call("metrics")
  size0 = observer.call("size")
  crashy = client_cls(address, authkey=config.authkey)
  crashy.call("begin_episode", f"actor-crashy-{client_lib}")
  crashy.call("append", {"actor_id": f"actor-crashy-{client_lib}",
                         "transitions": _transitions()})
  crashy.close()  # the actor "dies" mid-episode
  deadline = time.monotonic() + 10
  aborted = before["service"]["replay_aborted_episodes"]
  while time.monotonic() < deadline:
    metrics = observer.call("metrics")
    if metrics["service"]["replay_aborted_episodes"] > aborted:
      break
    time.sleep(0.05)
  assert metrics["service"]["replay_aborted_episodes"] == aborted + 1
  assert observer.call("size") == size0  # not one staged row landed
  committer = client_cls(address, authkey=config.authkey)
  payload = {"actor_id": f"actor-ok-{client_lib}",
             "transitions": _transitions(), "policy_version": 0,
             "policy_learner_step": 0}
  assert committer.call("commit", payload) is True
  deadline = time.monotonic() + 10
  while observer.call("size") < size0 + 4 and time.monotonic() < deadline:
    time.sleep(0.05)
  assert observer.call("size") == size0 + 4
  lag = observer.call("metrics")["param_refresh_lag"]
  assert lag["rows"] >= 4
  committer.close()
  observer.close()
