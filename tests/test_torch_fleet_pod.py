"""The Anakin pods and the learner group in the port's fleet, on the CPU
(`FleetConfig.device = "cpu"`), as the JAX package's `tests/test_fleet.py`
pins them (`TestPodUnits`, `TestHybridPodracer`).

  * `pod_env_family`, `trim_devices` and the pods' home-shard remap equal
    JAX's.
  * `acting_state` on a host in a process of its own: the publication as
    host numpy on a version move, the stamp alone when the version is
    unchanged.
  * A hybrid fleet at tiny size (TCP, 2 serving hosts, 2 shard hosts, a
    2-rank learner group, one pod beside one process actor) ends cleanly:
    only rank 0 publishes (`publishes == params_version`), the served
    params are its final checkpoint, the pod's segments land whole and
    every role reports, the pod and both learner ranks included, in the
    aggregated view, the merged timeline (= the JAX tool's merge) and
    the report; `scale_pods_to` grows the pods and `kick("pod-1")`
    respawns one.
  * A pods-only fleet with a mid-segment pod kill lands whole segments
    only, and the pod is respawned.
  * After rank 0's clean end, a learner rank that fails or hangs fails
    the run.
  * A pod or learner rank whose build raises (before its telemetry is
    configured) leaves a flight record naming its role (ROADMAP C6).

Each fleet run has its own time limit (`run_timeout_secs`).
"""

import hashlib
import json
import multiprocessing as mp
import os
import time

import pytest

pytest.importorskip("torch")

from tensor2robot_tpu.fleet import actor as jax_actor  # noqa: E402
from tensor2robot_tpu.fleet import pod as jax_pod  # noqa: E402
from tensor2robot_tpu.telemetry import merge as jax_merge  # noqa: E402
from tensor2robot_tpu_torch.fleet import Fleet, FleetConfig  # noqa: E402
from tensor2robot_tpu_torch.fleet import FleetError  # noqa: E402
from tensor2robot_tpu_torch.fleet import faults  # noqa: E402
from tensor2robot_tpu_torch.fleet import orchestrator  # noqa: E402
from tensor2robot_tpu_torch.fleet import host as host_lib  # noqa: E402
from tensor2robot_tpu_torch.fleet import pod as pod_lib  # noqa: E402
from tensor2robot_tpu_torch.fleet.actor import home_shard  # noqa: E402
from tensor2robot_tpu_torch.fleet.rpc import RpcClient  # noqa: E402
from tensor2robot_tpu_torch.telemetry import merge, report  # noqa: E402
from tensor2robot_tpu_torch.utils import checkpoints as ckpt_lib  # noqa: E402

_TINY = dict(
    env="pose", image_size=16, action_dim=2,
    torso_filters=(8,), head_filters=(8,), dense_sizes=(16,),
    cem_population=8, cem_iterations=1, cem_elites=2,
    batch_size=16, max_train_steps=16, min_replay_size=32,
    publish_every_steps=8, log_every_steps=8,
    batch_episodes=8, serve_max_batch=4,
    replay_capacity=512, replay_shards=1,
    envs_per_pod=8, pod_rollout_length=2,
    heartbeat_timeout_secs=0.0, launch_timeout_secs=240.0,
    run_timeout_secs=420.0, seed=0, device="cpu")


def _fleet_children():
  return [p for p in mp.active_children() if p.name.startswith("t2r-fleet")]


def _checkpoint_digests(model_dir):
  leaves = ckpt_lib._load_leaves(model_dir, None)
  out = {}
  for path, leaf in leaves.items():
    for prefix in ("train_state/params/", "train_state/batch_stats/"):
      if path.startswith(prefix):
        out[path[len(prefix):]] = hashlib.sha256(
            leaf.contiguous().numpy().tobytes()).hexdigest()
  return out


# ---- the pod's pure seams ----


def test_env_family_maps_onto_functional_envs():
  for env in ("pose", "mujoco_pose", "procgen"):
    assert pod_lib.pod_env_family(env) == jax_pod.pod_env_family(env)
  for fn in (pod_lib.pod_env_family, jax_pod.pod_env_family):
    with pytest.raises(ValueError, match="functional"):
      fn("toy_grasp")


@pytest.mark.parametrize("count,num_envs", [(8, 32), (8, 12), (8, 7),
                                            (3, 16), (1, 5)])
def test_trim_devices_largest_dividing_prefix(count, num_envs):
  devices = [f"d{i}" for i in range(count)]
  got = pod_lib.trim_devices(devices, num_envs)
  assert got == jax_pod.trim_devices(devices, num_envs)
  assert num_envs % len(got) == 0 and got == devices[:len(got)]


def test_pod_home_shard_remap_is_minimal():
  """Rendezvous placement over `pod-N` ids, as JAX's: shrinking the shard
  set remaps only the pods homed on the removed shard."""
  pods = [f"pod-{k}" for k in range(32)]
  with_three = {p: home_shard(p, 3) for p in pods}
  with_two = {p: home_shard(p, 2) for p in pods}
  assert with_three == {p: jax_actor.home_shard(p, 3) for p in pods}
  displaced = [p for p in pods if with_three[p] == 2]
  assert displaced
  for p in pods:
    if with_three[p] != 2:
      assert with_two[p] == with_three[p], p


def test_pod_seed_is_jax_key_seed():
  config = FleetConfig(**_TINY)
  assert pod_lib.pod_seed(config, 0) == 7013
  assert pod_lib.pod_seed(config, 2, incarnation=1) == 3 * 7013 + 1


# ---- acting_state ----


def test_acting_state_serves_params_once_per_version():
  ctx = mp.get_context("spawn")
  config = FleetConfig(**dict(_TINY, env="toy_grasp", telemetry_dir=""))
  parent_conn, child_conn = ctx.Pipe()
  stop = ctx.Event()
  heartbeat = ctx.Value("d", 0.0)
  process = ctx.Process(target=host_lib.host_main,
                        args=(config, child_conn, stop, heartbeat),
                        name="t2r-fleet-host", daemon=True)
  process.start()
  child_conn.close()
  try:
    assert parent_conn.poll(240.0), "host never reported ready"
    address = tuple(parent_conn.recv()["address"])
    pod = RpcClient(address, authkey=config.authkey)
    first = pod.call("acting_state", {"have_version": -1})
    # Version 0 exists from the engine's construction.
    assert first["params_version"] == 0 and first["params_hop"] == 0
    state = first["state"]
    assert set(state) == {"step", "params", "batch_stats"}
    assert state["params"] and all(
        type(v).__module__ == "numpy" for v in state["params"].values())
    second = pod.call("acting_state", {"have_version": 0})
    assert second["state"] is None
    assert (second["params_version"], second["params_learner_step"]) == (
        first["params_version"], first["params_learner_step"])
    # A publication moves the version: the next poll carries it whole.
    published = {"step": 8, "params": state["params"],
                 "batch_stats": state["batch_stats"]}
    assert pod.call("publish", {"step": 8, "state": published}) == 1
    third = pod.call("acting_state", {"have_version": 0})
    assert third["params_version"] == 1
    assert third["params_learner_step"] == 8
    for key, value in state["params"].items():
      assert (third["state"]["params"][key] == value).all(), key
    cached = pod_lib.PodParamClient(pod)
    assert cached.refresh() and cached.params_version == 1
    assert not cached.refresh()
    assert set(cached.state.params) == set(state["params"])
    pod.close()
  finally:
    stop.set()
    process.join(timeout=30.0)
    if process.is_alive():
      process.kill()
      process.join(5.0)
  assert process.exitcode == 0


# ---- fleets ----


def test_hybrid_fleet_with_a_learner_group_and_a_pod(tmp_path):
  config = FleetConfig(**dict(
      _TINY, num_actors=1, pod_hosts=1, learner_hosts=2, transport="tcp",
      serving_hosts=2, replay_hosts=2, max_actor_restarts=3))
  model_dir = str(tmp_path / "hybrid")
  fleet = Fleet(config, model_dir)
  fleet.launch()
  # Elastic pods on the launched fleet: a second pod, then a kick.
  fleet.scale_pods_to(2)
  assert fleet.num_pods == 2
  fleet.kick("pod-1")
  assert fleet._pod_restarts[1] == 1
  t0 = time.monotonic()
  fleet.wait()
  metrics = fleet.shutdown()
  result = fleet.result(metrics, time.monotonic() - t0)
  assert result.clean_shutdown and _fleet_children() == []
  assert {"action": "add_pod", "index": 1} in [
      {k: e[k] for k in ("action", "index")} for e in result.scale_events]
  assert result.actor_restarts == 1  # the kicked pod's respawn
  # Only rank 0 publishes: a publishing rank 1 would double the count.
  assert result.publishes == result.params_version == 2
  assert metrics["learner_window"]["last_step"] == config.max_train_steps
  digests = _checkpoint_digests(model_dir)
  assert metrics["served_params_sha256"] == digests
  # Both ranks ended at the checkpoint's params, by digest.
  with open(tmp_path / "hybrid" / "learner_group.json") as f:
    assert json.load(f)["rank_digests"] == [digests, digests]
  assert result.param_refresh_lag["rows"] > 0
  # Lag rows from both collectors (the shards' registries, polled).
  with open(tmp_path / "hybrid" / "telemetry" / "fleet_metrics.jsonl") as f:
    last = [json.loads(line) for line in f if line.strip()][-1]["payload"]
  for collector in ("actor-0", "pod-0"):
    assert sum(v for k, v in last.items() if k.endswith(
        f"fleet.param_refresh_lag_rows.{collector}")) > 0, collector
  pushed = metrics["pushed_telemetry"]
  assert {"learner", "learner-r1", "pod-0", "actor-0"} <= set(pushed)
  assert pushed["learner-r1"]["snapshot"]["gauges"][
      "fleet.learner_group.rank"] == 1.0
  segment_rows = config.envs_per_pod * config.pod_rollout_length
  env_steps = pushed["pod-0"]["snapshot"]["counters"]["fleet.pod.env_steps"]
  assert env_steps > 0 and env_steps % segment_rows == 0
  committed = int(metrics["service"]["replay_committed_transitions"])
  assert committed > 0 and committed % config.batch_episodes == 0
  # The new roles merge into the run's timeline and render in its report,
  # as the JAX tools do.
  trace_dir = str(tmp_path / "hybrid" / "telemetry")
  merged = merge.merge_traces(trace_dir)
  assert merged == jax_merge.merge_traces(trace_dir)
  assert {"pod-0", "learner", "learner-r1"} <= set(
      merge.roles_with_spans(merged))
  text = report.render_markdown(report.build_report(model_dir))
  for role in ("pod-0", "learner-r1"):
    assert f"| {role} |" in text, role


def test_pod_commits_land_whole_across_a_pod_kill(tmp_path):
  """A pods-only fleet with one planned mid-segment kill: the staged
  segment is aborted on disconnect, the restart policy respawns pod-0,
  and every landed row arrived in whole segment-sized commits."""
  plan = faults.FaultPlan(seed=0, events=(faults.FaultEvent(
      fault=faults.ACTOR_CRASH, target="pod-0", at=2,
      mode="mid_episode"),))
  config = FleetConfig(**dict(
      _TINY, num_actors=0, pod_hosts=1, fault_plan=plan,
      max_actor_restarts=2, restart_window_secs=600.0))
  result = Fleet(config, str(tmp_path / "fleet")).run()
  assert result.clean_shutdown and _fleet_children() == []
  assert result.actor_restarts >= 1
  assert [r["target"] for r in result.recoveries] == ["pod-0"]
  assert result.recoveries[0]["fault"] == "actor_crash"
  assert result.recoveries[0]["mttr_ms"] > 0
  service = result.metrics["service"]
  assert service["replay_aborted_episodes"] >= 1.0
  segment_rows = config.envs_per_pod * config.pod_rollout_length
  committed = int(service["replay_committed_transitions"])
  assert committed > 0 and committed % segment_rows == 0
  assert result.metrics["store"]["adds_total"] % segment_rows == 0
  assert result.publishes == result.params_version == 2


# ---- the learner group's supervision ----


def _exit_after(secs, code):
  time.sleep(secs)
  os._exit(code)


@pytest.mark.parametrize("peer, error", [
    ((0.5, 0), None),
    ((0.5, 3), r"rank 1 failed after rank 0's clean end \(exit 3\)"),
    ((60.0, 0), r"rank 1 did not exit within 2s"),
], ids=["clean", "fails", "hangs"])
def test_a_learner_rank_ending_badly_after_rank0_fails_the_run(
    tmp_path, monkeypatch, peer, error):
  """Rank 0 has exited 0 while rank 1 is still in its teardown (hooks'
  `end`, the prefetcher's close, the telemetry flush): the run is clean
  only if rank 1 then exits 0 within `PEER_EXIT_SECS`."""
  monkeypatch.setattr(orchestrator, "PEER_EXIT_SECS", 2.0)
  fleet = Fleet(FleetConfig(**dict(_TINY, num_actors=1, learner_hosts=2)),
                str(tmp_path))
  ctx = mp.get_context("fork")
  fleet._learner = ctx.Process(target=_exit_after, args=(0.0, 0),
                               name="rank0-stub")
  fleet._learner_peers[1] = ctx.Process(target=_exit_after, args=peer,
                                        name="rank1-stub")
  try:
    fleet._learner.start()
    fleet._learner_peers[1].start()
    fleet._learner.join(30.0)
    assert fleet._learner.exitcode == 0
    assert fleet._learner_peers[1].exitcode is None
    if error is None:
      assert fleet._supervise_once() is True
      assert fleet._learner_peers[1].exitcode == 0
    else:
      with pytest.raises(FleetError, match=error):
        fleet._supervise_once()
  finally:
    for process in (fleet._learner, fleet._learner_peers[1]):
      if process.is_alive():
        process.kill()
      process.join(5.0)


# ---- a build that raises leaves a flight record (ROADMAP C6) ----


@pytest.mark.parametrize("role", ["pod-3", "learner", "learner-r1"])
def test_a_build_that_raises_leaves_a_flight_record(tmp_path, monkeypatch,
                                                    role):
  """The pod and the learner rank build before their telemetry is
  configured (while the hosts come up); a build that raises still dumps
  a flight record naming the role, as JAX's do (they build inside the
  `try` that dumps)."""
  import threading

  from tensor2robot_tpu_torch.fleet import learner as learner_lib
  from tensor2robot_tpu_torch.telemetry import flightrec

  def broken(config):
    raise RuntimeError("no card for the build")

  monkeypatch.setattr(host_lib, "_build_learner", broken)
  # The children scrub the launch variables: keep the test process's.
  monkeypatch.setattr(os, "environ", dict(os.environ))
  dump_dir = str(tmp_path / "flightrec")
  config = FleetConfig(**{**_TINY, "flightrec_dir": dump_dir})
  with pytest.raises(RuntimeError, match="no card for the build"):
    if role.startswith("pod"):
      pod_lib.pod_main(config, 3, None, threading.Event(), None)
    else:
      world = 2 if role == "learner-r1" else 1
      learner_lib.learner_main(config, str(tmp_path / "model"), None, None,
                               world_size=world, rank=world - 1)
  dumps = flightrec.read_dumps(dump_dir)
  assert [d["role"] for d in dumps] == [role]
  assert dumps[0]["reason"].startswith(f"{role}: build failed:")
  assert "no card for the build" in dumps[0]["reason"]
