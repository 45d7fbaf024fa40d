"""The port's fleet end to end on the CPU (`FleetConfig.device = "cpu"`),
at the JAX tests' tiny shape (`tests/test_fleet.py::_tiny_config`:
`toy_grasp`, 16×16 images, 2 actors, 16 learner steps, a publication
every 8).

  * Tier 1: `run_fleet` runs a host, two actors and a learner process to
    a clean shutdown: `max_train_steps // publish_every_steps`
    publications, the served params the learner's final checkpoint bit
    for bit, whole episodes only, `fleet_result.json` written, and no
    child alive after.
  * Tier 1, the two configs of the front tier and the control plane,
    parsed from the shipped gins with the pose env, the CPU and test
    widths bound on top, each with robots on its fronts' tenants
    (`fleet.traffic.drive_fleet`): `qtopt_serving_replicated.gin` with a
    non-recurring `serving_replica_crash` (the front respawns and serves
    past the fault in its second incarnation, the routers re-admit it
    through the observer, every request is answered, the fronts serve
    the final checkpoint), and `qtopt_fleet_autopilot.gin` with a short
    poll (the decision log validates, an actuated `scale_actors` shows in
    `FleetResult.scale_events`, the budget holds, the records carry the
    replay host's learner step).
  * Slow (as JAX's slow fleet tests): an actor crashing mid-episode is
    restarted and lands no partial rows; the learner's death is detected
    and the fleet torn down; the abort policy takes the fleet down; a
    learner crash under `learner_crash_policy="resume"` restores from
    the latest checkpoint and finishes; `scale_to` grows and shrinks the
    actors mid-run with whole episodes only; `--trainer=fleet` through the
    binary with the shipped gin; and the JAX fleet and the port's on the
    same config report the same `FleetResult` keys, metric names,
    publications and clean shutdown.
"""

import dataclasses
import hashlib
import json
import multiprocessing as mp
import os
import time

import pytest

torch = pytest.importorskip("torch")

from tensor2robot_tpu_torch import config as port_gin  # noqa: E402
from tensor2robot_tpu_torch import control  # noqa: E402
from tensor2robot_tpu_torch.fleet import Fleet, FleetConfig, FleetError  # noqa: E402
from tensor2robot_tpu_torch.fleet import faults  # noqa: E402
from tensor2robot_tpu_torch.fleet import orchestrator as orch  # noqa: E402
from tensor2robot_tpu_torch.fleet import traffic  # noqa: E402
from tensor2robot_tpu_torch.telemetry import records as trecords  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402

_TINY = dict(
    num_actors=2, env="toy_grasp", image_size=16, action_dim=2,
    torso_filters=(8,), head_filters=(8,), dense_sizes=(16,),
    cem_population=8, cem_iterations=1, cem_elites=2,
    batch_size=16, max_train_steps=16, min_replay_size=32,
    publish_every_steps=8, log_every_steps=8,
    batch_episodes=8, serve_max_batch=4,
    replay_capacity=512, replay_shards=1,
    heartbeat_timeout_secs=0.0, launch_timeout_secs=240.0,
    run_timeout_secs=420.0, seed=0)


def _tiny_config(**overrides):
  return FleetConfig(**dict(_TINY, device="cpu", **overrides))


def _fleet_children():
  return [p for p in mp.active_children() if p.name.startswith("t2r-fleet")]


def _committed(metrics):
  return int(metrics["service"]["replay_committed_transitions"])


def _checkpoint_digests(model_dir):
  leaves = ckpt_lib._load_leaves(model_dir, None)
  out = {}
  for path, leaf in leaves.items():
    for prefix in ("train_state/params/", "train_state/batch_stats/"):
      if path.startswith(prefix):
        out[path[len(prefix):]] = hashlib.sha256(
            leaf.contiguous().numpy().tobytes()).hexdigest()
  return out


def test_run_fleet_end_to_end(tmp_path):
  config = _tiny_config()
  model_dir = str(tmp_path / "fleet")
  result = orch.run_fleet(model_dir=model_dir, config=config)
  assert result.clean_shutdown
  assert result.publishes == (config.max_train_steps
                              // config.publish_every_steps)
  assert result.params_version == result.publishes
  metrics = result.metrics
  assert metrics["learner_window"]["last_step"] == config.max_train_steps
  assert metrics["params_learner_step"] == config.max_train_steps
  assert metrics["served_params_sha256"] == _checkpoint_digests(model_dir)
  committed = _committed(metrics)
  assert committed > 0 and committed % config.batch_episodes == 0
  assert metrics["store"]["adds_total"] % config.batch_episodes == 0
  assert result.env_steps_per_sec > 0 and result.learner_steps_per_sec > 0
  assert result.param_refresh_lag["rows"] > 0
  assert any(s["rows"] for s in result.replay_staleness.values())
  assert result.actor_restarts == 0 and result.recoveries == []
  assert metrics["cuda_initialized"] is False
  with open(os.path.join(model_dir, orch.RESULT_FILENAME)) as f:
    written = json.load(f)
  assert written["publishes"] == result.publishes
  assert set(written) == {f.name for f in dataclasses.fields(result)}
  assert _fleet_children() == []


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a host with a card serves from it: this pins "
                           "the launch's failure where there is none")
def test_a_fleet_without_a_card_fails_its_launch(tmp_path):
  """`device=None` is the card: without one the host dies building its
  engine, the launch latches that, and every child (spawned before the
  hosts were up, waiting for the address book) is stopped; nothing
  serves from the CPU."""
  fleet = Fleet(FleetConfig(**_TINY), str(tmp_path / "fleet"))
  assert fleet.config.device is None
  with pytest.raises(FleetError, match="host died before reporting ready"):
    fleet.run()
  assert _fleet_children() == []
  assert fleet._address is None


_CONFIGS = "tensor2robot_tpu/research/qtopt/configs/"
# The shipped fleet gins at test width, on the CPU, with the pose env.
_GIN_TINY = (
    'FleetConfig.env = "pose"', 'FleetConfig.device = "cpu"',
    "FleetConfig.image_size = 16", "FleetConfig.torso_filters = (8,)",
    "FleetConfig.head_filters = (8,)", "FleetConfig.dense_sizes = (16,)",
    "FleetConfig.cem_population = 8", "FleetConfig.cem_iterations = 1",
    "FleetConfig.cem_elites = 2", "FleetConfig.batch_size = 16",
    "FleetConfig.min_replay_size = 32", "FleetConfig.batch_episodes = 8",
    "FleetConfig.serve_max_batch = 4", "FleetConfig.replay_capacity = 512",
    "FleetConfig.replay_shards = 1", "FleetConfig.heartbeat_timeout_secs = 0.0",
    "FleetConfig.run_timeout_secs = 420.0")


def _drive_gin(gin_file, bindings, model_dir, robots, **overrides):
  """`drive_fleet` on a shipped gin with `bindings` on top (the launch
  gate is the gin tests') and robots on the `robots` tenants; the
  bindings stay parsed through the launch, which builds the
  controller's rule table from them."""
  port_gin.clear_config()
  try:
    port_gin.parse_config_files_and_bindings(
        [_CONFIGS + gin_file], list(_GIN_TINY) + list(bindings))
    config = dataclasses.replace(orch.FleetConfig(), **overrides)
    return traffic.drive_fleet(model_dir, config, robots=robots)
  finally:
    port_gin.clear_config()


def test_serving_replicated_gin_with_a_front_crash(tmp_path):
  plan = faults.FaultPlan(seed=0, events=(faults.FaultEvent(
      fault=faults.SERVING_REPLICA_CRASH, target="front-0", at=3,
      recurring=False),))
  model_dir = str(tmp_path / "replicated")
  steps = 48
  result, seen = _drive_gin(
      "qtopt_serving_replicated.gin",
      (f"FleetConfig.max_train_steps = {steps}",
       "FleetConfig.publish_every_steps = 8",
       "FleetConfig.log_every_steps = 8"),
      model_dir, ("policy",), fault_plan=plan)
  assert result.clean_shutdown and _fleet_children() == []
  (recovery,) = result.recoveries
  assert recovery["target"] == "front-0" and recovery["mttr_ms"] > 0
  assert recovery["fault"] == faults.SERVING_REPLICA_CRASH
  assert seen["membership_events"][0]["event"] == "respawned"
  assert seen["router"]["alive"] == [0, 1] and seen["num_fronts"] == 2
  assert seen["router"]["failovers"] >= 1
  policy = seen["tenants"]["policy"]
  assert policy["errors"] == 0 and policy["nonfinite"] == 0
  assert policy["shed"] == 0 and seen["errors"] == []
  # One robot a tenant per actor of the gin (4), each with its router.
  assert seen["robots_per_tenant"] == 4 and seen["router"]["routers"] == 4
  # A request in flight as the fleet began its shutdown may be cut.
  assert policy["answered"] + policy["cut"] == policy["offered"] == seen[
      "router"]["requests"] > 3
  assert seen["failover_latency_ms"]["n"] >= 1
  fronts = {f["front_index"]: f for f in result.metrics["front_hosts"]}
  assert sorted(fronts) == [0, 1]
  # The plan is not recurring: the respawned front (incarnation 1) served
  # past the serve the first incarnation died at. JAX's respawned front
  # installs the plan as incarnation 0 and dies there again.
  assert fronts[0]["serves"] > 3
  digests = _checkpoint_digests(model_dir)
  # Both replicas serve the final checkpoint: the respawned one was
  # caught up with the root host's publication as it rejoined.
  for front in fronts.values():
    assert front["params_version"] == steps
    assert front["served_params_sha256"]["policy"] == digests
    assert front["cuda_initialized"] is False
    assert front["ready_secs"] > 0
  assert result.metrics["served_params_sha256"] == digests
  assert "front_failures" not in result.metrics
  assert result.metrics["serving_replicas"][0]["params_learner_step"] == steps


def test_fleet_autopilot_gin_actuates_scale_actors(tmp_path):
  model_dir = str(tmp_path / "autopilot")
  result, seen = _drive_gin(
      "qtopt_fleet_autopilot.gin",
      ("FleetConfig.max_train_steps = 64",
       "FleetConfig.publish_every_steps = 16",
       "FleetConfig.log_every_steps = 16",
       "FleetConfig.telemetry_poll_secs = 0.5",
       # Any collection rate is over this band: one actor is drained.
       "fleet_rules.env_steps_per_sec_max = 1.0",
       "fleet_rules.env_steps_per_sec_min = 0.0"),
      model_dir, ("policy", "batch"))
  assert result.clean_shutdown and _fleet_children() == []
  records = control.read_decisions(os.path.join(
      model_dir, "telemetry", control.DECISIONS_FILENAME))
  assert records
  assert all(trecords.validate_record(r) == [] for r in records)
  down = [r for r in records
          if "control.actors_scale_down.actuated" in r["payload"]]
  assert down and down[0]["payload"]["control.actors_scale_down.actuated"] == 1
  assert {"action": "remove", "index": 1} in [
      {k: e[k] for k in ("action", "index")} for e in result.scale_events]
  assert seen["num_actors"] == 1 and seen["num_fronts"] == 2
  stats = result.metrics["control"]
  assert 1 <= stats["actuated"] <= 4  # control_max_actions per window
  for tenant in ("policy", "batch"):
    assert seen["tenants"][tenant]["errors"] == 0
    assert seen["tenants"][tenant]["answered"] > 0
  with open(os.path.join(model_dir, "telemetry", "fleet_metrics.jsonl")) as f:
    polls = [json.loads(line)["payload"] for line in f if line.strip()]
  # The shard's replay twins reach the aggregated view the rules read.
  assert polls[-1]["shard0/replay.adds"] > 0
  assert "shard0/replay.fill" in polls[-1]
  # The root holds no store (`replay_hosts = 1`): the records and the
  # decisions carry the shard's learner step (JAX's carry 0).
  with open(os.path.join(model_dir, "telemetry", "fleet_metrics.jsonl")) as f:
    steps = [(json.loads(line)["step"], json.loads(line)["payload"])
             for line in f if line.strip()]
  assert "replay.learner_step" not in steps[-1][1]
  assert all(step == int(payload.get("shard0/replay.learner_step", 0))
             for step, payload in steps)
  assert steps[-1][0] > 0 and max(r["step"] for r in records) > 0


@pytest.mark.slow
def test_actor_crash_restart_lands_no_partial_rows(tmp_path):
  config = _tiny_config(actor_crash_after_episodes=2,
                        actor_crash_mode="mid_episode", crash_actor_index=0,
                        max_actor_restarts=2)
  fleet = Fleet(config, str(tmp_path / "fleet"))
  result = fleet.run()
  service = result.metrics["service"]
  assert result.actor_restarts >= 1
  assert service["replay_actor_restarts"] >= 1.0
  assert service["replay_aborted_episodes"] >= 1.0
  assert result.metrics["store"]["adds_total"] % config.batch_episodes == 0
  assert [r["target"] for r in result.recoveries] == ["actor-0"]
  assert result.recoveries[0]["mttr_ms"] > 0
  assert result.clean_shutdown
  assert _fleet_children() == []


@pytest.mark.slow
def test_learner_death_is_detected_and_actors_exit(tmp_path):
  config = _tiny_config(learner_crash_after_steps=4)
  fleet = Fleet(config, str(tmp_path / "fleet"))
  with pytest.raises(FleetError, match="learner died"):
    fleet.run()
  assert _fleet_children() == []


@pytest.mark.slow
def test_learner_crash_after_steps_crash_loops_under_resume(tmp_path):
  """As JAX's: the knob fires in every incarnation, so each resumed
  learner dies at the same step again until the restart budget trips
  (a one-off crash that resumes is a fault plan's event)."""
  config = _tiny_config(learner_crash_after_steps=4,
                        learner_crash_policy="resume",
                        max_learner_restarts=1, restart_window_secs=600.0)
  fleet = Fleet(config, str(tmp_path / "fleet"))
  with pytest.raises(FleetError, match=r"learner died .* after 1 resume"):
    fleet.run()
  assert fleet._learner_restarts == 1
  assert _fleet_children() == []


@pytest.mark.slow
def test_actor_abort_policy_takes_the_fleet_down(tmp_path):
  config = _tiny_config(actor_crash_after_episodes=1,
                        actor_crash_mode="hard", actor_crash_policy="abort")
  fleet = Fleet(config, str(tmp_path / "fleet"))
  with pytest.raises(FleetError, match="actor 0 died"):
    fleet.run()
  assert _fleet_children() == []


@pytest.mark.slow
def test_learner_crash_resumes_from_the_latest_checkpoint(tmp_path):
  plan = faults.FaultPlan(seed=0, events=(faults.FaultEvent(
      fault=faults.LEARNER_CRASH, target="learner", at=10),))
  config = _tiny_config(fault_plan=plan, learner_crash_policy="resume",
                        max_learner_restarts=2, restart_window_secs=600.0)
  result = Fleet(config, str(tmp_path / "fleet")).run()
  assert result.learner_restarts == 1
  assert [r["fault"] for r in result.recoveries] == ["learner_crash"]
  assert result.recoveries[0]["mttr_ms"] > 0
  assert result.metrics["learner_window"]["last_step"] == 16
  assert result.metrics["params_learner_step"] == 16
  (resume,) = result.metrics["learner_resumes"]
  assert resume == {"from_step": 10, "to_step": 8}
  assert _committed(result.metrics) % config.batch_episodes == 0


@pytest.mark.slow
def test_elastic_scale_up_and_down_lands_no_partial_rows(tmp_path):
  config = _tiny_config(max_train_steps=24)
  fleet = Fleet(config, str(tmp_path / "fleet"))
  fleet.launch()
  try:
    time.sleep(3.0)
    fleet.scale_to(3)
    assert fleet.num_actors == 3
    time.sleep(2.0)
    fleet.scale_to(1)
    assert fleet.num_actors == 1
    fleet.wait()
  finally:
    metrics = fleet.shutdown()
  committed = _committed(metrics)
  assert committed > 0 and committed % config.batch_episodes == 0
  assert [e["action"] for e in fleet.scale_events] == [
      "add", "remove", "remove"]
  assert fleet._restarts.get(0, 0) == 0  # drains never read as crashes
  assert _fleet_children() == []


@pytest.mark.slow
def test_the_binary_runs_the_shipped_gin(tmp_path):
  from tensor2robot_tpu_torch.bin import run_t2r_trainer
  model_dir = tmp_path / "fleet"
  small = {"env": '"pose"', "device": "'cpu'", "image_size": 16,
           "torso_filters": "(8,)", "head_filters": "(8,)",
           "dense_sizes": "(16,)", "cem_population": 8, "cem_elites": 2,
           "serve_max_batch": 4, "batch_size": 16, "max_train_steps": 16,
           "publish_every_steps": 8, "log_every_steps": 8,
           "batch_episodes": 8, "replay_capacity": 512}
  argv = ["--trainer=fleet", "--gin_configs",
          "tensor2robot_tpu/research/qtopt/configs/qtopt_fleet.gin",
          "--gin_bindings", f"run_fleet.model_dir = '{model_dir}'"]
  for key, value in small.items():
    argv += ["--gin_bindings", f"FleetConfig.{key} = {value}"]
  try:
    assert run_t2r_trainer.main(argv) == 0
  finally:
    port_gin.clear_config()
  with open(model_dir / orch.RESULT_FILENAME) as f:
    result = json.load(f)
  assert result["clean_shutdown"] and result["publishes"] == 2
  assert _fleet_children() == []


@pytest.mark.slow
def test_the_jax_fleet_and_the_port_report_alike(tmp_path):
  from tensor2robot_tpu.fleet import Fleet as JaxFleet
  from tensor2robot_tpu.fleet import FleetConfig as JaxFleetConfig

  port = Fleet(_tiny_config(), str(tmp_path / "port")).run()
  jax = JaxFleet(JaxFleetConfig(**_TINY), str(tmp_path / "jax")).run()
  assert ({f.name for f in dataclasses.fields(port)}
          == {f.name for f in dataclasses.fields(jax)})
  # The port's host adds its served-params digests and CUDA report.
  assert set(port.metrics) - set(jax.metrics) == {
      "served_params_sha256", "cuda_initialized"}
  assert set(jax.metrics) <= set(port.metrics)
  for key in ("store", "service"):
    assert set(port.metrics[key]) == set(jax.metrics[key])
  assert port.publishes == jax.publishes == 2
  assert port.params_version == jax.params_version
  assert port.clean_shutdown and jax.clean_shutdown
  assert _fleet_children() == []
