"""Fleet Anakin pod (port of `fleet/pod.py`): a whole vectorized
collector as one fleet unit.

Where a process actor steps one env and pays an `act` RPC per decision,
a pod runs `envs.rollout.make_anakin_collect_fn`: `envs_per_pod`
functional envs and the CEM policy on the pod's device, so acting and
env stepping are one device loop and the wire carries whole rollout
segments, not per-step traffic. The pod is a pure collector: it never
trains.

Three seams tie it into the fleet's contracts:

  * Params come from the pod's serving replica through the
    `acting_state` RPC (`fleet/host.py`): the broadcast tree already
    pushed the publication there, so the pod polls its replica (the
    version stamp alone when unchanged, the acting state as host numpy
    when it moved) and acts with params on its device until the next
    refresh. `param_refresh_lag` rides the same version / step / hop
    stamp process actors use.
  * Experience lands on the pod's rendezvous-hashed home shard through
    the same `FleetReplaySession.add` one-commit-per-call contract: each
    segment (`envs_per_pod × pod_rollout_length` rows) is one atomic
    commit, so a pod's death never leaves partial rows
    (`adds_total % (envs_per_pod * pod_rollout_length) == 0`).
  * Supervision: pods share the actor crash policy, restart budget,
    fault plan, heartbeat cadence (one beat per segment) and telemetry
    merge; the orchestrator treats `pod-N` like an `actor-N`.

The pod holds the card (its device is `FleetConfig.device`, None = the
card; no card raises). Importing this module stays cheap: torch and the
device come in inside `pod_main`, while the hosts come up.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.fleet import faults as faults_lib
from tensor2robot_tpu_torch.fleet import proc
from tensor2robot_tpu_torch.fleet.actor import (
    CRASH_EXIT_CODE,
    FleetReplaySession,
    _push_telemetry,
    address_book,
    home_shard,
)
from tensor2robot_tpu_torch.fleet.rpc import RpcClient
from tensor2robot_tpu_torch.telemetry import flightrec
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

log = logging.getLogger(__name__)

# A pod's generator seed: `seed + POD_SEED_STRIDE · (index + 1) +
# incarnation`, as JAX seeds the pod's key.
POD_SEED_STRIDE = 7013


def pod_env_family(env: str) -> str:
  """Maps a FleetConfig env name onto a functional env family.

  Pods run the env in the collection loop, so only the
  `envs/core.FunctionalEnv` families qualify. `mujoco_pose` process
  actors drive physics on the host; a pod in the same fleet collects
  from the functional `pose` renderer instead (same wire spec, same
  reward rule, no host stepping).
  """
  if env in ("pose", "mujoco_pose"):
    return "pose"
  if env == "procgen":
    return "procgen"
  raise ValueError(
      f"env {env!r} has no functional family for Anakin pods "
      "(pose/mujoco_pose/procgen)")


def trim_devices(devices, num_envs: int):
  """The largest device prefix that divides `num_envs` evenly (the
  collection needs `num_envs % num_devices == 0`; worst case one
  device, always valid)."""
  devices = list(devices)
  num_devices = max(1, len(devices))
  while num_envs % num_devices:
    num_devices -= 1
  return devices[:num_devices]


def pod_seed(config, pod_index: int, incarnation: int = 0) -> int:
  return config.seed + POD_SEED_STRIDE * (pod_index + 1) + incarnation


class PodParamClient:
  """Acting-params cache refreshed over the `acting_state` RPC.

  Duck-types the `FleetPolicyClient` stamp surface (`params_version` /
  `params_learner_step` / `params_hop`) so the shared
  `FleetReplaySession` attributes committed segments to the publication
  that produced them, as process actors do. `state` is the publication
  as a `TrainState` on `device`.
  """

  def __init__(self, client: RpcClient, device=None):
    self._client = client
    self._device = device
    self.state = None
    self.params_version = -1
    self.params_learner_step = 0
    self.params_hop = 0

  def refresh(self) -> bool:
    """One poll; True when a new publication replaced the cache."""
    reply = self._client.call(
        "acting_state", {"have_version": self.params_version})
    self.params_learner_step = int(reply["params_learner_step"])
    self.params_hop = int(reply.get("params_hop", 0))
    if reply.get("state") is None:
      return False
    from tensor2robot_tpu_torch.fleet.host import _train_state

    state = _train_state(reply["state"])
    self.state = state if self._device is None else state.to(self._device)
    self.params_version = int(reply["params_version"])
    return True


def _inject_crash(mode: str, sink: FleetReplaySession) -> None:
  """The pod's twin of `actor._inject_crash`: the mid_episode mode
  stages one wire batch in a host-side session before dying, so the
  disconnect-abort contract is exercised by pod-sized payloads too."""
  if mode == "mid_episode":
    sink.begin_episode()
    if sink.last_transitions is not None:
      sink.append(sink.last_transitions)
    os._exit(CRASH_EXIT_CODE)
  if mode == "hard":
    os._exit(CRASH_EXIT_CODE)
  raise RuntimeError("injected pod crash (FleetConfig.actor_crash_*)")


def _build_collector(config):
  """(learner, init_fn, collect_fn) of a pod: the fleet's learner
  constructor (lax select, as the hosts) on `FleetConfig.device` and the
  env family's functional env."""
  from tensor2robot_tpu_torch.envs.pose import PoseBanditEnv
  from tensor2robot_tpu_torch.envs.procgen import ProcGenGraspEnv
  from tensor2robot_tpu_torch.envs.rollout import make_anakin_collect_fn
  from tensor2robot_tpu_torch.fleet.host import _build_learner

  family = pod_env_family(config.env)
  env_cls = PoseBanditEnv if family == "pose" else ProcGenGraspEnv
  env = env_cls(image_size=config.image_size, action_dim=config.action_dim)
  learner = _build_learner(config)
  init_fn, collect_fn = make_anakin_collect_fn(
      learner, env,
      num_envs=config.envs_per_pod,
      rollout_length=config.pod_rollout_length,
      epsilon=config.epsilon,
      devices=trim_devices([learner.device], config.envs_per_pod),
      cem_population=getattr(config, "cem_population", None),
      cem_iterations=getattr(config, "cem_iterations", None))
  return learner, init_fn, collect_fn


def pod_main(config, pod_index: int, address, stop_event,
             heartbeat, incarnation: int = 0) -> None:
  """Child-process entry: build the collector → connect → refresh /
  collect / commit until told to stop.

  `address` is the address book, or a pipe end that delivers it once
  the hosts are up (`proc.await_address`); torch, the learner and the
  envs load first, while they come up."""
  proc.scrub_inherited_distributed_env()
  import torch

  from tensor2robot_tpu_torch.envs.rollout import flatten_devices

  learner, init_fn, collect_fn = _build_collector(config)
  address = proc.await_address(address)
  if address is None:
    return  # the launch was aborted before the hosts were up
  pod_id = f"pod-{pod_index}"
  telemetry.configure(
      pod_id, trace_dir=getattr(config, "telemetry_dir", "") or None,
      actor_id=pod_id)
  from tensor2robot_tpu_torch.telemetry import perf as perf_lib
  perf_lib.start_resource_sampler()
  injector = faults_lib.install(config, pod_id, incarnation=incarnation)
  rpc_kwargs = dict(
      authkey=config.authkey,
      call_timeout_secs=config.rpc_call_timeout_secs,
      max_retries=config.rpc_max_retries,
      transport=getattr(config, "transport", "loopback"),
      sndbuf=getattr(config, "tcp_sndbuf", 0),
      rcvbuf=getattr(config, "tcp_rcvbuf", 0))
  book = address_book(address)
  serving = book["serving"]
  # The actors' placement rule: refresh from this pod's serving replica
  # (round-robin over the broadcast tree), commit to the rendezvous-hash
  # home shard.
  refresh_address = serving[pod_index % len(serving)]
  client = RpcClient(refresh_address, **rpc_kwargs)
  commit_client: Optional[RpcClient] = None
  try:
    t_before = time.monotonic()
    hello = client.call("hello")
    t_after = time.monotonic()
    if "monotonic" in hello and refresh_address == serving[0]:
      telemetry.get_tracer().set_clock_offset(
          telemetry.clock_offset_from_handshake(
              hello["monotonic"], t_before, t_after))
    if refresh_address != serving[0]:
      # The reference clock is the root's: one transient hello aligns
      # this trace (the actor_main contract).
      with RpcClient(serving[0], **rpc_kwargs) as root:
        t_before = time.monotonic()
        root_hello = root.call("hello")
        t_after = time.monotonic()
        if "monotonic" in root_hello:
          telemetry.get_tracer().set_clock_offset(
              telemetry.clock_offset_from_handshake(
                  root_hello["monotonic"], t_before, t_after))
    params = PodParamClient(client, device=learner.device)
    if book["shards"]:
      shard = home_shard(pod_id, len(book["shards"]))
      commit_client = RpcClient(book["shards"][shard], **rpc_kwargs)
      sink = FleetReplaySession(commit_client, pod_id, params)
      log.info("%s commits to replay shard %d at %s", pod_id, shard,
               book["shards"][shard])
    else:
      sink = FleetReplaySession(client, pod_id, params)

    segment_rows = config.envs_per_pod * config.pod_rollout_length
    generator = torch.Generator(device=learner.device).manual_seed(
        pod_seed(config, pod_index, incarnation))
    env_states = init_fn(generator)
    # The serving engine publishes version 0 at construction, so the
    # first refresh always lands acting params before any rollout runs.
    if not params.refresh():
      raise RuntimeError(
          f"{pod_id}: serving replica at {refresh_address} returned no "
          "acting state")

    segments = 0
    tm_env_steps = tmetrics.counter("fleet.pod.env_steps")
    tm_segments = tmetrics.counter("fleet.pod.segments")
    tm_dropped = tmetrics.counter("fleet.pod.segments_dropped")
    tm_refreshes = tmetrics.counter("fleet.pod.param_refreshes")
    tm_version = tmetrics.gauge("fleet.pod.params_version")
    push_period = (max(float(getattr(config, "telemetry_poll_secs",
                                     0.0)), 1.0)
                   if getattr(config, "telemetry_dir", "")
                   and getattr(config, "telemetry_poll_secs", 0.0)
                   else None)
    t_last_push = 0.0
    while not stop_event.is_set():
      # Refresh before the segment (not after): the segment trains
      # someone else, but the pod acts on the freshest publication its
      # replica holds.
      if params.refresh():
        tm_refreshes.inc()
      tm_version.set(params.params_version)
      with telemetry.span("pod.collect_segment", rows=segment_rows):
        env_states, batch = collect_fn(params.state, env_states, generator)
        wire = {k: v.cpu().numpy()
                for k, v in flatten_devices(batch).items()}
      if sink.add(wire):
        tm_env_steps.inc(segment_rows)
      else:
        tm_dropped.inc()
      segments += 1
      tm_segments.inc()
      # The fault-plan seam between segments, before the beat: the
      # actors' placement (an injected hang leaves the heartbeat one
      # full segment stale).
      event = injector.on_batch(segments)
      if event is not None:
        if event.fault == faults_lib.ACTOR_HANG:
          proc.hang(event.duration_secs)
        else:
          _inject_crash(event.mode, sink)
      proc.beat(heartbeat)
      if (push_period is not None
          and time.monotonic() - t_last_push >= push_period):
        t_last_push = time.monotonic()
        _push_telemetry(client, pod_id)
    if push_period is not None:
      _push_telemetry(client, pod_id)
    log.info("pod %s stopping cleanly: %d segments (%d rows each), "
             "last params version %d", pod_id, segments, segment_rows,
             params.params_version)
  except BaseException as e:
    if getattr(config, "flightrec_dir", ""):
      flightrec.dump(config.flightrec_dir, f"{pod_id}: {e!r}")
    raise
  finally:
    perf_lib.stop_resource_sampler()
    telemetry.get_tracer().close()
    if commit_client is not None:
      commit_client.close()
    client.close()
