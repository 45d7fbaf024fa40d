"""Fleet actor process (port of `fleet/actor.py`): env stepping only,
with no model, no learner and no CUDA context.

The actor steps environments and speaks RPC. Action selection happens in
the host's serving engine (every actor's requests coalesce in the
micro-batcher there), episode commits go through the host's replay
sessions, and parameters never reach this process. So an actor costs an
interpreter and an env; the card is never touched here (`actor_main`
records `torch.cuda.is_initialized()` as the ``proc.cuda_initialized``
gauge of its final telemetry push).

The loop is `GraspActor.collect_once`; this module supplies its two
seams with RPC-backed implementations:

  * `FleetPolicyClient`: the `policy_server=` seam. Each `act` reply
    carries the engine's params version and the learner step those
    params were published at, so every episode is stamped with the
    policy that produced it (the `param_refresh_lag` measurement seam).
  * `FleetReplaySession`: the replay-sink seam. One `add` is one atomic
    episode commit server-side; the drop-policy bool comes back so the
    actor's `episodes_dropped` accounting keeps working.
    `begin/append/end` are exposed too (multi-chunk episodes, crash
    injection): rows staged server-side between `begin` and `end` are
    aborted if the connection dies.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.fleet import faults as faults_lib
from tensor2robot_tpu_torch.fleet import proc
from tensor2robot_tpu_torch.fleet.rpc import RpcClient
from tensor2robot_tpu_torch.telemetry import flightrec
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

log = logging.getLogger(__name__)

# Exit code for injected hard crashes (distinguishable from a clean 0
# and a Python-exception 1).
CRASH_EXIT_CODE = 13


def home_shard(actor_id: str, num_shards: int) -> int:
  """The actor's consistent-hash home replay shard.

  Rendezvous (highest-random-weight) hashing: each (actor, shard) pair
  gets a deterministic pseudo-random weight and the actor homes on its
  max. When the shard set changes, only the actors homed on a removed
  shard remap; everyone else's episodes keep landing where they did.
  """
  if num_shards <= 0:
    raise ValueError(f"num_shards must be positive, got {num_shards}")
  best, best_weight = 0, -1
  for shard in range(num_shards):
    digest = hashlib.sha256(
        f"{actor_id}|shard-{shard}".encode()).digest()
    weight = int.from_bytes(digest[:8], "big")
    if weight > best_weight:
      best, best_weight = shard, weight
  return best


def address_book(address) -> Dict[str, List[Tuple[str, int]]]:
  """Normalizes an RPC target into the fleet's address book.

  A bare `(host, port)` tuple — every pre-sharding caller — means one
  serving host that also owns the replay plane. The orchestrator's
  multi-host launches pass `{"serving": [...], "shards": [...]}`
  instead: serving[0] is the ROOT (reference clock, learner control),
  and a non-empty `shards` list moves every commit/sample to the
  shard services.
  """
  if isinstance(address, dict):
    return {"serving": [tuple(a) for a in address.get("serving", ())],
            "shards": [tuple(a) for a in address.get("shards", ())]}
  return {"serving": [tuple(address)], "shards": []}


class FleetPolicyClient:
  """`GraspActor.policy_server`-shaped proxy to the host's CEM server."""

  def __init__(self, client: RpcClient, max_batch: int):
    self._client = client
    self.max_batch = int(max_batch)
    self.params_version = 0
    self.params_learner_step = 0
    self.params_hop = 0

  @property
  def engine(self) -> "FleetPolicyClient":
    # GraspActor chunks requests to `policy_server.engine.max_batch`;
    # the remote engine's bucket table is what bounds us, so this
    # proxy doubles as its own `engine`.
    return self

  def select_actions(self,
                     observations: Dict[str, Any]) -> np.ndarray:
    reply = self._client.call(
        "act", {k: np.asarray(v) for k, v in observations.items()})
    self.params_version = int(reply["params_version"])
    self.params_learner_step = int(reply["params_learner_step"])
    # The acting host's broadcast-tree depth: stamped into commits so
    # the shard attributes param_refresh_lag per hop.
    self.params_hop = int(reply.get("params_hop", 0))
    return np.asarray(reply["actions"])

  def update_state(self, state) -> None:
    raise NotImplementedError(
        "fleet actors never push params; the learner publishes to the "
        "host's engine directly")


class FleetReplaySession:
  """`GraspActor` replay sink committing through the host's sessions.

  Every call stamps the episode with the policy version/learner-step
  the paired `FleetPolicyClient` last acted with, which is how the
  host attributes `param_refresh_lag` to committed rows.
  """

  def __init__(self, client: RpcClient, actor_id: str,
               policy: Optional[FleetPolicyClient] = None):
    self._client = client
    self._policy = policy
    self.actor_id = actor_id
    self.last_transitions: Optional[Dict[str, np.ndarray]] = None

  def _stamp(self) -> Dict[str, Any]:
    if self._policy is None:
      return {"policy_version": None, "policy_learner_step": None}
    return {"policy_version": self._policy.params_version,
            "policy_learner_step": self._policy.params_learner_step,
            "policy_hop": self._policy.params_hop}

  def add(self, transitions: Dict[str, Any]) -> bool:
    flat = {k: np.asarray(v) for k, v in transitions.items()}
    self.last_transitions = flat
    payload = {"actor_id": self.actor_id, "transitions": flat}
    payload.update(self._stamp())
    return bool(self._client.call("commit", payload))

  def begin_episode(self) -> None:
    self._client.call("begin_episode", self.actor_id)

  def append(self, transitions: Dict[str, Any]) -> None:
    self._client.call("append", {
        "actor_id": self.actor_id,
        "transitions": {k: np.asarray(v)
                        for k, v in transitions.items()}})

  def end_episode(self) -> bool:
    payload = {"actor_id": self.actor_id}
    payload.update(self._stamp())
    return bool(self._client.call("end_episode", payload))


def build_env(config, actor_index: int):
  """The per-actor environment, seeded per index.

  `pose` is `GraspActor` driving the numpy `PoseEnv` through the
  `PoseGraspBandit` adapter; `toy_grasp` is the original QT-Opt bandit.
  `mujoco_pose` (the JAX fleet's default) wants the physics-backed
  `MuJoCoPoseEnv`, which is not ported (ROADMAP A10a):
  `PoseGraspBandit(physics=True)` raises, and the orchestrator refuses
  that env before it spawns anything.
  """
  seed = config.seed + 1009 * (actor_index + 1)
  if config.env == "toy_grasp":
    from tensor2robot_tpu_torch.research.qtopt.grasping_env import (
        ToyGraspEnv,
    )
    return ToyGraspEnv(image_size=config.image_size,
                       action_dim=config.action_dim, seed=seed)
  if config.env in ("pose", "mujoco_pose"):
    from tensor2robot_tpu_torch.research.pose_env.grasp_bandit import (
        PoseGraspBandit,
    )
    return PoseGraspBandit(image_size=config.image_size,
                           action_dim=config.action_dim,
                           physics=(config.env == "mujoco_pose"),
                           seed=seed)
  raise ValueError(f"unknown fleet env {config.env!r}")


def _inject_crash(mode: str, sink: FleetReplaySession) -> None:
  """Fault injection (FleetConfig.actor_crash_*)."""
  if mode == "mid_episode":
    # Die BETWEEN append and end_episode: rows are staged in the
    # host-side session when the process vanishes. The disconnect
    # abort (host.py) must discard them — the partial-episode pin.
    sink.begin_episode()
    if sink.last_transitions is not None:
      sink.append(sink.last_transitions)
    os._exit(CRASH_EXIT_CODE)
  if mode == "hard":
    os._exit(CRASH_EXIT_CODE)
  raise RuntimeError("injected actor crash (FleetConfig.actor_crash_*)")


def _push_telemetry(client: RpcClient, role: str) -> None:
  """Ships this process's registry snapshot to the host (best-effort:
  telemetry must never take an actor down)."""
  proc.record_cuda_state()
  try:
    client.call("telemetry_push", {
        "role": role,
        "snapshot": tmetrics.registry().snapshot()})
  except Exception:  # noqa: BLE001 — instrumentation only
    log.warning("telemetry push failed", exc_info=True)


def actor_main(config, actor_index: int, address, stop_event,
               heartbeat, incarnation: int = 0) -> None:
  """Child-process entry: connect → collect until told to stop.

  `address` is the address book, or a pipe end that delivers it once
  the hosts are up (`proc.await_address`); the env and `GraspActor`'s
  module load first, while they come up."""
  proc.scrub_inherited_distributed_env()
  from tensor2robot_tpu_torch.research.qtopt.actor import GraspActor
  env = build_env(config, actor_index)
  address = proc.await_address(address)
  if address is None:
    return  # the launch was aborted before the hosts were up
  actor_id = f"actor-{actor_index}"
  telemetry.configure(
      actor_id, trace_dir=getattr(config, "telemetry_dir", "") or None,
      actor_id=actor_id)
  # Resource watermarks: host RSS for this role; rsrc.* gauges ride the
  # telemetry_push to the host.
  from tensor2robot_tpu_torch.telemetry import perf as perf_lib
  perf_lib.start_resource_sampler()
  # The fault-plan seam: non-recurring events fire only in
  # incarnation 0, so a respawned actor replays a fault-free schedule.
  # `install` also arms the RPC client-side seam for this process.
  injector = faults_lib.install(config, actor_id,
                                incarnation=incarnation)
  rpc_kwargs = dict(
      authkey=config.authkey,
      call_timeout_secs=config.rpc_call_timeout_secs,
      max_retries=config.rpc_max_retries,
      transport=getattr(config, "transport", "loopback"),
      sndbuf=getattr(config, "tcp_sndbuf", 0),
      rcvbuf=getattr(config, "tcp_rcvbuf", 0))
  book = address_book(address)
  serving = book["serving"]
  # Multi-host placement: act against this actor's serving host
  # (round-robin over the broadcast tree; deeper hosts see params
  # later, which the per-hop lag attribution measures), commit to the
  # rendezvous-hash home shard (or the same host when the replay plane
  # is unsharded).
  act_address = serving[actor_index % len(serving)]
  client = RpcClient(act_address, **rpc_kwargs)
  commit_client: Optional[RpcClient] = None
  try:
    t_before = time.monotonic()
    hello = client.call("hello")
    t_after = time.monotonic()
    if "monotonic" in hello and act_address == serving[0]:
      # The clock handshake: this actor's spans go onto the root
      # host's monotonic timeline.
      telemetry.get_tracer().set_clock_offset(
          telemetry.clock_offset_from_handshake(
              hello["monotonic"], t_before, t_after))
    if act_address != serving[0]:
      # Acting against a replica: the reference clock is still the
      # root's; one transient hello aligns this trace.
      with RpcClient(serving[0], **rpc_kwargs) as root:
        t_before = time.monotonic()
        root_hello = root.call("hello")
        t_after = time.monotonic()
        if "monotonic" in root_hello:
          telemetry.get_tracer().set_clock_offset(
              telemetry.clock_offset_from_handshake(
                  root_hello["monotonic"], t_before, t_after))
    policy = FleetPolicyClient(client, max_batch=hello["max_batch"])
    if book["shards"]:
      shard = home_shard(actor_id, len(book["shards"]))
      commit_client = RpcClient(book["shards"][shard], **rpc_kwargs)
      sink = FleetReplaySession(commit_client, actor_id, policy)
      log.info("%s commits to replay shard %d at %s", actor_id, shard,
               book["shards"][shard])
    else:
      sink = FleetReplaySession(client, actor_id, policy)
    actor = GraspActor(
        learner=None,
        replay_buffer=sink,
        env=env,
        batch_episodes=config.batch_episodes,
        epsilon=config.epsilon,
        seed=config.seed + 101 * (actor_index + 1),
        policy_server=policy,
        name=actor_id)
    crash_after = (
        config.actor_crash_after_episodes
        if (actor_index == config.crash_actor_index and incarnation == 0)
        else None)
    batches = 0
    episodes = tmetrics.gauge("actor.episodes_collected")
    dropped = tmetrics.gauge("actor.episodes_dropped")
    # Snapshot pushes ride the acting connection, so they are (a) off
    # with the plane (telemetry_dir="off": the orchestrator never
    # polls), and (b) rate-limited to the orchestrator's poll cadence.
    push_period = (max(float(getattr(config, "telemetry_poll_secs",
                                     0.0)), 1.0)
                   if getattr(config, "telemetry_dir", "")
                   and getattr(config, "telemetry_poll_secs", 0.0)
                   else None)
    t_last_push = 0.0
    while not stop_event.is_set():
      with telemetry.span("actor.collect_batch",
                          batch=config.batch_episodes):
        actor.collect_once()
      # Mirror the actor's cumulative accounting into the registry
      # (gauges: the actor object owns the true counters).
      episodes.set(actor.episodes_collected)
      dropped.set(actor.episodes_dropped)
      batches += 1
      # Fault-plan seam, consulted between batches and before the
      # beat: an injected hang leaves the heartbeat one full batch
      # stale, and an injected crash dies with the batch committed;
      # partial rows can only come from the mid_episode mode, whose
      # staged rows the host aborts on disconnect.
      event = injector.on_batch(batches)
      if event is not None:
        if event.fault == faults_lib.ACTOR_HANG:
          proc.hang(event.duration_secs)
        else:
          _inject_crash(event.mode, sink)
      proc.beat(heartbeat)
      if (push_period is not None
          and time.monotonic() - t_last_push >= push_period):
        t_last_push = time.monotonic()
        _push_telemetry(client, actor_id)
      if crash_after is not None and batches >= crash_after:
        _inject_crash(config.actor_crash_mode, sink)
    if push_period is not None:
      # Final snapshot as the actor drains: the orchestrator's
      # end-of-run telemetry read (shutdown barrier) must see this
      # incarnation's rpc retry/recovery counters.
      _push_telemetry(client, actor_id)
    log.info("actor %s stopping cleanly: %d committed / %d dropped "
             "episodes, last policy version %s", actor_id,
             actor.episodes_collected, actor.episodes_dropped,
             actor.last_policy_version)
  except BaseException as e:
    # The crash-policy flight record: the orchestrator sees exit
    # codes; this preserves what the actor was doing when it died.
    if getattr(config, "flightrec_dir", ""):
      flightrec.dump(config.flightrec_dir, f"{actor_id}: {e!r}")
    raise
  finally:
    perf_lib.stop_resource_sampler()
    telemetry.get_tracer().close()
    if commit_client is not None:
      commit_client.close()
    client.close()
