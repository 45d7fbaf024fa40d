"""The port's fleet topology, configuration, refusals and metric merges
(`fleet/orchestrator.py`) against the JAX package's, on the CPU; no
process is spawned here.

  * `broadcast_children` and `broadcast_depths` equal JAX's for 1–8
    hosts and degrees 1–4.
  * `FleetConfig` has every JAX field (and `device`), with JAX's
    defaults; for a table of invalid configs it raises JAX's exception
    type with JAX's message, and the shipped fleet gins parse into the
    same config in both registries.
  * What the port does not run yet (the `mujoco_pose` env) is refused
    at `Fleet` construction by a `FleetUnported` naming its ROADMAP item
    (A10a only, beside pods or a learner group), before any process or
    directory is made; front replicas, the control plane, Anakin pods
    and learner groups are not.
  * `_merge_fleet_metrics` and `_result_from_metrics` equal JAX's on the
    same seeded snapshot dicts.
"""

import dataclasses
import multiprocessing as mp
import os
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from tensor2robot_tpu import config as jax_gin  # noqa: E402
from tensor2robot_tpu.fleet import faults as jax_faults  # noqa: E402
from tensor2robot_tpu.fleet import orchestrator as jax_orch  # noqa: E402
from tensor2robot_tpu_torch import config as port_gin  # noqa: E402
from tensor2robot_tpu_torch.fleet import FleetError  # noqa: E402
from tensor2robot_tpu_torch.fleet import faults  # noqa: E402
from tensor2robot_tpu_torch.fleet import orchestrator as orch  # noqa: E402

_CONFIGS = "tensor2robot_tpu/research/qtopt/configs/"
# Fields of a run, not of its configuration.
_RUN_FIELDS = ("authkey", "fault_plan", "device")


@pytest.fixture(autouse=True)
def _clean():
  jax_gin.clear_config()
  port_gin.clear_config()
  yield
  jax_gin.clear_config()
  port_gin.clear_config()


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
@pytest.mark.parametrize("hosts", range(1, 9))
def test_broadcast_tree_equals_jax(hosts, degree):
  assert orch.broadcast_depths(hosts, degree) == jax_orch.broadcast_depths(
      hosts, degree)
  children = [orch.broadcast_children(i, hosts, degree)
              for i in range(hosts)]
  assert children == [jax_orch.broadcast_children(i, hosts, degree)
                      for i in range(hosts)]
  # Every host but the root is some host's child, exactly once.
  assert sorted(c for cs in children for c in cs) == list(range(1, hosts))


def _fields(config):
  return {k: v for k, v in dataclasses.asdict(config).items()
          if k not in _RUN_FIELDS}


def test_every_jax_field_with_its_default():
  port_names = [f.name for f in dataclasses.fields(orch.FleetConfig)]
  jax_names = [f.name for f in dataclasses.fields(jax_orch.FleetConfig)]
  assert port_names == jax_names + ["device"]
  assert _fields(orch.FleetConfig()) == _fields(jax_orch.FleetConfig())
  assert orch.FleetConfig().device is None
  assert len(orch.FleetConfig().authkey) == 16
  assert orch.FleetConfig().authkey != orch.FleetConfig().authkey


_INVALID = [
    dict(num_actors=-1), dict(num_actors=0), dict(learner_hosts=0),
    dict(learner_hosts=2, batch_size=15),
    dict(learner_hosts=2, learner_crash_policy="resume"),
    dict(pod_hosts=-1), dict(envs_per_pod=0), dict(pod_rollout_length=0),
    dict(pod_hosts=1, env="toy_grasp"), dict(env="bogus"),
    dict(actor_crash_policy="retry"), dict(actor_crash_mode="soft"),
    dict(learner_crash_policy="pray"), dict(overflow="spill"),
    dict(transport="udp"), dict(serving_hosts=0), dict(replay_hosts=-1),
    dict(broadcast_degree=0), dict(serving_hosts=2),
    dict(front_hosts=-1), dict(front_spread=0),
    dict(front_hosts=2, front_spread=3), dict(front_tenants=()),
    dict(dedup_capacity=-1), dict(max_front_restarts=-1),
    dict(control_max_actions=0), dict(control_cadence_secs=-1.0),
    dict(control_budget_window_secs=-1.0), dict(control_shed_rate_rps=0.0),
    dict(fault_plan={"not": "a plan"}),
]


@pytest.mark.parametrize("kwargs", _INVALID,
                         ids=[",".join(k) for k in _INVALID])
def test_invalid_configs_raise_jax_errors(kwargs):
  with pytest.raises(Exception) as port:
    orch.FleetConfig(**kwargs)
  with pytest.raises(Exception) as jax:
    jax_orch.FleetConfig(**kwargs)
  assert type(port.value) is type(jax.value)
  assert str(port.value) == str(jax.value)


_VALID = [
    dict(), dict(env="pose", num_actors=4), dict(env="toy_grasp"),
    dict(transport="tcp", serving_hosts=3, replay_hosts=2,
         broadcast_degree=1),
    dict(num_actors=0, pod_hosts=2, env="pose"),
    dict(learner_hosts=2, batch_size=64),
    dict(front_hosts=2, front_spread=2, front_tenants=("a", "b")),
    dict(learner_crash_policy="resume", actor_crash_policy="abort",
         overflow="block", actor_crash_mode="mid_episode"),
]


@pytest.mark.parametrize("kwargs", _VALID)
def test_valid_configs_equal_jax(kwargs):
  port, jax = orch.FleetConfig(**kwargs), jax_orch.FleetConfig(**kwargs)
  assert _fields(port) == _fields(jax)
  assert port.fault_plan is None


@pytest.mark.parametrize("gin_file", ["qtopt_fleet.gin",
                                      "qtopt_fleet_elastic.gin",
                                      "qtopt_fleet_tcp.gin",
                                      "qtopt_serving_replicated.gin",
                                      "qtopt_fleet_hybrid.gin"])
def test_shipped_gins_parse_to_jax_configs(gin_file):
  import tensor2robot_tpu.fleet  # noqa: F401  (registers JAX's configurables)
  binding = 'FleetConfig.env = "pose"'
  port_gin.parse_config_files_and_bindings([_CONFIGS + gin_file], [binding])
  jax_gin.parse_config_files_and_bindings([_CONFIGS + gin_file], [binding])
  port = port_gin.query_parameter("run_fleet.config")
  jax = jax_gin.query_parameter("run_fleet.config")
  port_config = orch.FleetConfig()
  jax_config = jax_orch.FleetConfig()
  assert _fields(port_config) == _fields(jax_config)
  assert port_config.env == "pose"
  assert port is not None and jax is not None


# The physics env is the one refusal left: beside fronts, the control
# plane, pods or a learner group, the message names A10a alone.
_A10A_ONLY = r"yet: env='mujoco_pose' needs MuJoCoPoseEnv \(ROADMAP A10a\)"
_REFUSED = [
    (dict(), "A10a"),  # the JAX default env: mujoco_pose
    (dict(front_hosts=2, pod_hosts=1), "A10a beside fronts and pods"),
    (dict(pod_hosts=1), "A10a beside pods"),
    (dict(control=True, learner_hosts=2),
     "A10a beside the control plane and a learner group"),
    (dict(learner_hosts=2), "A10a beside a learner group"),
    (dict(pod_hosts=1, learner_hosts=2), "A10a beside pods and a group"),
]


@pytest.mark.parametrize("kwargs,item", _REFUSED,
                         ids=[item for _, item in _REFUSED])
def test_refusals_raise_before_anything_is_made(tmp_path, kwargs, item):
  config = orch.FleetConfig(**kwargs)
  children = set(mp.active_children())
  model_dir = str(tmp_path / "fleet")
  with pytest.raises(orch.FleetUnported, match=_A10A_ONLY) as info:
    orch.Fleet(config, model_dir)
  assert not re.search("front|control|pod|learner|A11|A13",
                       str(info.value))
  assert isinstance(info.value, FleetError)
  assert isinstance(info.value, NotImplementedError)
  with pytest.raises(orch.FleetUnported, match=_A10A_ONLY):
    orch.run_fleet(model_dir=model_dir, config=config)
  assert set(mp.active_children()) == children
  assert not os.path.exists(model_dir)


def test_a_runnable_config_is_not_refused(tmp_path):
  assert orch.unported(orch.FleetConfig(env="pose")) == []
  assert orch.unported(orch.FleetConfig(
      env="toy_grasp", transport="tcp", serving_hosts=2,
      replay_hosts=2)) == []
  assert orch.unported(orch.FleetConfig(
      env="pose", front_hosts=2, front_spread=2, control=True)) == []
  assert orch.unported(orch.FleetConfig(
      env="pose", pod_hosts=1, learner_hosts=2, transport="tcp",
      serving_hosts=2, replay_hosts=2)) == []
  fleet = orch.Fleet(orch.FleetConfig(env="pose", device="cpu"),
                     str(tmp_path))
  assert fleet.num_actors == 0  # nothing spawned before launch()


def test_front_and_control_levers_before_launch(tmp_path):
  """The levers the control plane pulls, on a fleet not launched yet:
  the front tier and the pods are empty, membership changes need a
  launched fleet, and only actor-N / front-N / pod-N are kickable."""
  fleet = orch.Fleet(orch.FleetConfig(env="pose", device="cpu",
                                      front_hosts=2, control=True),
                     str(tmp_path))
  assert fleet.num_fronts == 0 and fleet.front_addresses == {}
  assert fleet.retune_admission("policy", factor=0.5) == {}
  assert fleet.admission_slo_reports() == {}
  assert fleet.num_pods == 0
  with pytest.raises(FleetError, match="launched"):
    fleet.kick("pod-0")
  with pytest.raises(FleetError, match="launched"):
    fleet.scale_pods_to(1)
  with pytest.raises(ValueError):
    fleet.scale_pods_to(-1)
  for role in ("learner", "host", "shard0", "fleet"):
    with pytest.raises(FleetError, match="not kickable"):
      fleet.kick(role)
  with pytest.raises(FleetError, match="launched"):
    fleet.kick("front1")
  with pytest.raises(FleetError, match="launched"):
    fleet.scale_fronts_to(3)
  with pytest.raises(ValueError):
    fleet.scale_fronts_to(0)
  events = []
  fleet.add_front_observer(lambda *event: events.append(event))
  fleet.add_front_observer(lambda *event: 1 / 0)  # never breaks the loop
  fleet._notify_front_observers("added", 2, ("127.0.0.1", 1))
  assert events == [("added", 2, ("127.0.0.1", 1))]


def _lag(rng, hops=(0,)):
  rows = int(rng.integers(1, 500))
  histogram = {f"<={2 ** i}": int(rng.integers(0, 50)) for i in range(6)}
  out = {"rows": rows, "mean": float(rng.random() * 40),
         "max": int(rng.integers(0, 100)), "histogram": histogram}
  out["by_hop"] = {str(h): {"rows": int(rng.integers(1, 300)),
                            "mean": float(rng.random() * 30),
                            "max": int(rng.integers(0, 90))} for h in hops}
  return out


def _host(rng, index=0, shard=False):
  store = {"size": float(rng.integers(0, 4096)), "capacity": 2048.0,
           "fill": float(rng.random()), "adds_total": float(
               rng.integers(0, 9999)), "learner_step": float(
                   rng.integers(0, 500)), "num_shards": 1.0}
  service = {"replay_committed_transitions": float(
      rng.integers(16, 9999) // 16 * 16), "replay_aborted_episodes": float(
          rng.integers(0, 3)), "replay_dropped_batches": 0.0}
  t0 = float(rng.random() * 100)
  out = {
      "store": store, "service": service,
      "staleness": {"64": {"rows": int(rng.integers(1, 999)),
                           "mean_age_steps": float(rng.random() * 90)}},
      "param_refresh_lag": _lag(rng, hops=(0, 1)),
      "commit_window": {"first_time": t0,
                        "last_time": t0 + float(rng.random() * 60)},
  }
  if shard:
    out["shard_index"] = index
    return out
  out.update({
      "publishes": int(rng.integers(1, 11)),
      "params_version": int(rng.integers(1, 11)),
      "params_learner_step": 500,
      "learner_window": {"first_time": t0, "first_step": 0,
                         "last_time": t0 + 5.0 + float(rng.random()),
                         "last_step": 500},
      "learner_resumes": [], "host_index": index,
  })
  return out


@pytest.mark.parametrize("shards,replicas", [(0, 0), (2, 1), (3, 0),
                                             (1, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_metric_merges_equal_jax(seed, shards, replicas):
  rng = np.random.default_rng(seed)
  root = _host(rng)
  if shards:
    root.update(store=None, service=None, staleness={},
                param_refresh_lag=None, commit_window=None)
  replica_metrics = [_host(rng, i + 1) for i in range(replicas)]
  shard_metrics = [_host(rng, i, shard=True) for i in range(shards)]
  port = orch._merge_fleet_metrics(root, replica_metrics, shard_metrics)
  jax = jax_orch._merge_fleet_metrics(root, replica_metrics, shard_metrics)
  assert port == jax
  for restarts in (0, 3):
    port_result = orch._result_from_metrics(port, 12.5, restarts)
    jax_result = jax_orch._result_from_metrics(jax, 12.5, restarts)
    assert dataclasses.asdict(port_result) == dataclasses.asdict(jax_result)
  assert orch._merge_lag_snapshots([]) is None
  assert jax_faults.FAULT_CLASSES == faults.FAULT_CLASSES


@pytest.mark.parametrize("payload, step", [
    ({}, 0),
    ({"replay.learner_step": 7.0, "shard0/replay.learner_step": 9.0}, 7),
    ({"shard0/replay.learner_step": 12.0,
      "shard1/replay.learner_step": 15.0, "replay.adds": 3.0}, 15),
])
def test_the_learner_step_of_a_poll(payload, step):
  """The step a poll's record and the controller's decisions carry: the
  root store's, else (replay hosts own every shard) the largest shard's.
  JAX's orchestrator reads the root's key alone."""
  assert orch.learner_step(payload) == step


def test_a_learner_rank_checks_its_plan_before_anything_else():
  """A learner group's rank validates its plan (JAX's
  `learner_group_plan`) before it scrubs, builds or connects: a batch
  that does not divide, or a rank outside the group, raises there."""
  from tensor2robot_tpu_torch.fleet import learner as learner_lib
  config = orch.FleetConfig(env="pose", device="cpu", batch_size=15)
  with pytest.raises(ValueError, match="divide"):
    learner_lib.learner_main(config, "/nonexistent", None, None,
                             world_size=2)
  with pytest.raises(ValueError, match="rank"):
    learner_lib.learner_main(orch.FleetConfig(env="pose", device="cpu"),
                             "/nonexistent", None, None, world_size=2,
                             rank=2)
