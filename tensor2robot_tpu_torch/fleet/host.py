"""Fleet replay/serving host (port of `fleet/host.py`): one process
owning the store and the serving engine.

Actors do not touch the card or the replay memory: they speak RPC to
host processes that own the `ReplayWriteService` → `ReplayStore`
ingestion plane and the `CEMPolicyServer` (bucketed engine, one CUDA
graph per bucket, and the micro-batcher). On a single host both live in
one process (the default, `replay_hosts=0`):

  * every actor's `act` request lands in the same micro-batcher, so N
    actors coalesce into about one CEM dispatch;
  * the learner's `publish` hot-swaps the engine's params in the same
    address space the actors' requests resolve against: the engine
    copies the publication into its idle params slot (the buffers its
    captured graphs read) and publishes that slot, so one swap serves
    the whole actor fleet at once;
  * `param_refresh_lag` and replay staleness are measured at the one
    choke point every transition passes through.

Past one host the same process splits along its two planes:

  * Sharded replay: `replay_shard_main` processes each own one store
    shard behind a `replay.service.ReplayFront`. They are numpy only
    and never touch the card. Actors commit to their rendezvous-hash
    home shard (`fleet.actor.home_shard`) and the learner fans sample
    requests across shards, concatenating shard-major. Serving hosts
    then own no store (`replay_hosts > 0`).
  * Broadcast tree: `serving_hosts` engine replicas in a
    `broadcast_degree`-ary tree (heap layout: children of host i are
    i·d+1 … i·d+d). The learner publishes to the root only; each host
    swaps locally and forwards to its children, with per-hop
    `param_refresh_lag` attribution (commits stamp the acting host's
    tree depth) and `fleet.broadcast.*` hop metrics.

Metric definitions (the JAX package's):

  * `param_refresh_lag`: at each committed episode, the learner's
    current step (the store's `learner_step` tag) minus the learner
    step stamped on the params the actor acted with.
  * replay staleness: learner step at sample minus at add, accounted by
    the store-side `ReplayBatchSampler` every learner `sample` rides
    through.

A publication arrives as host numpy (`{"step", "params",
"batch_stats"}`); nothing but numpy and plain Python crosses an RPC.
Each connection's replay sessions are aborted on disconnect
(`rpc.DISCONNECT_METHOD`), so an actor that dies mid-episode never
lands partial rows.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.fleet import faults as faults_lib
from tensor2robot_tpu_torch.fleet import proc
from tensor2robot_tpu_torch.fleet import rpc as rpc_lib
from tensor2robot_tpu_torch.telemetry import flightrec
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

# The model stack and the replay plane are imported inside the state
# constructors: the binary imports `fleet` in every mode, and the
# orchestrator's process builds neither.

log = logging.getLogger(__name__)

# Connect window of a publication forward to a front replica (a
# survivable tree child): it is up when it is configured, so a refused
# connection means it died; the publish must not wait out the default.
_SURVIVABLE_CONNECT_SECS = 2.0


def _server_kwargs(config) -> Dict[str, Any]:
  """The transport-seam kwargs every fleet RpcServer shares."""
  return dict(
      authkey=config.authkey,
      transport=getattr(config, "transport", "loopback"),
      sndbuf=getattr(config, "tcp_sndbuf", 0),
      rcvbuf=getattr(config, "tcp_rcvbuf", 0))


def _client_kwargs(config) -> Dict[str, Any]:
  """The transport-seam kwargs every fleet RpcClient shares."""
  return dict(
      authkey=config.authkey,
      transport=getattr(config, "transport", "loopback"),
      sndbuf=getattr(config, "tcp_sndbuf", 0),
      rcvbuf=getattr(config, "tcp_rcvbuf", 0))


def _handshake_clock(config, root_address) -> None:
  """Offsets this process's trace clock to the root host's.

  Every fleet process goes onto one timeline: the root serving host's
  CLOCK_MONOTONIC. Actors and the learner handshake over their
  long-lived clients; replica/shard hosts (which otherwise only
  answer) dial this transient hello at startup.
  """
  if root_address is None:
    return
  try:
    client = rpc_lib.RpcClient(
        tuple(root_address),
        call_timeout_secs=getattr(config, "rpc_call_timeout_secs",
                                  rpc_lib.DEFAULT_CALL_TIMEOUT_SECS),
        max_retries=getattr(config, "rpc_max_retries",
                            rpc_lib.DEFAULT_MAX_RETRIES),
        **_client_kwargs(config))
  except Exception:  # noqa: BLE001 — trace alignment is best-effort
    log.warning("clock handshake connect failed", exc_info=True)
    return
  try:
    t_before = time.monotonic()
    hello = client.call("hello")
    t_after = time.monotonic()
    if "monotonic" in hello:
      telemetry.get_tracer().set_clock_offset(
          telemetry.clock_offset_from_handshake(
              hello["monotonic"], t_before, t_after))
  except Exception:  # noqa: BLE001
    log.warning("clock handshake failed", exc_info=True)
  finally:
    client.close()


class _HostState:
  """Everything a serving host serves, plus the RPC method table.

  `host_index` 0 is the root: the reference clock, the learner's
  control endpoint, and (when `replay_hosts == 0`) the owner of the
  whole replay plane. Indices > 0 are broadcast-tree engine replicas:
  same engine, same `act` surface, no store (actors commit to shard
  services). The engine runs on `FleetConfig.device` (None = the card).
  """

  def __init__(self, config, host_index: int = 0):
    from tensor2robot_tpu_torch.replay.service import (
        ReplayFront,
        ReplayWriteService,
    )
    from tensor2robot_tpu_torch.replay.store import ReplayStore
    from tensor2robot_tpu_torch.serving.cem_policy import CEMPolicyServer

    self._config = config
    self.host_index = int(host_index)
    role = "host" if host_index == 0 else f"host{host_index}"
    # The host's telemetry identity: spans from the RPC layer and the
    # serving/replay planes flush to trace_<role>.jsonl; the root
    # host's clock is the reference clock every handshaking client
    # offsets against.
    telemetry.configure(
        role, trace_dir=getattr(config, "telemetry_dir", "") or None)
    # Resource watermarks: device memory and host RSS as rsrc.* gauges
    # in the ordinary registry, so the orchestrator's `telemetry` poll
    # aggregates them fleet-wide.
    from tensor2robot_tpu_torch.telemetry import perf as perf_lib
    from tensor2robot_tpu_torch.utils import profiling
    self._learner = _build_learner(config)
    perf_lib.start_resource_sampler(
        sources=[profiling.device_memory_source()])
    state0 = self._learner.create_state(config.seed)
    self.policy_server = CEMPolicyServer(
        self._learner, state0.train_state,
        max_batch=config.serve_max_batch,
        max_wait_us=config.serve_max_wait_us,
        seed=config.seed + 7,
        device=self._learner.device)
    # The replay plane lives here only on the single-host topology;
    # with shard services (`replay_hosts > 0`) every serving host, root
    # included, is engine-only and commit/sample are shard RPCs.
    if host_index == 0 and getattr(config, "replay_hosts", 0) == 0:
      store = ReplayStore(
          self._learner.transition_specification(),
          capacity=config.replay_capacity,
          num_shards=config.replay_shards,
          seed=config.seed + 11)
      service = ReplayWriteService(
          store,
          queue_batches=config.queue_batches,
          overflow=config.overflow)
      self.replay: Optional[ReplayFront] = ReplayFront(store, service)
    else:
      self.replay = None
    # Per-role registry snapshots pushed by actors/learner over the
    # `telemetry_push` RPC; the orchestrator's `telemetry` poll
    # returns them next to the host's own registry: one aggregated
    # fleet-wide view from one call.
    self._pushed_telemetry: Dict[str, Any] = {}
    self._lock = threading.Lock()
    self.publishes = 0
    self._publish_t0: Optional[float] = None
    self._learner_window: Optional[Tuple[float, int, float, int]] = None
    self._resumes: list = []  # observed backward learner steps
    # Broadcast-tree placement, set by the orchestrator's
    # `configure_broadcast` after every serving host is up. Forward
    # CLIENTS are per-connection (`ctx`) — owned by the publishing
    # connection's handler thread, rebuilt free on reconnect — only
    # the address list is shared state.
    self._children: List[Tuple[str, int]] = []
    self._survivable: List[Tuple[str, int]] = []
    self._tree_depth = 0
    self._broadcast_forwards = 0
    self._tm_depth = tmetrics.gauge("fleet.broadcast.depth")
    self._tm_forwards = tmetrics.counter("fleet.broadcast.forwards")
    self._tm_publish_ms = tmetrics.histogram(
        "fleet.broadcast.publish_ms", faults_lib.RECOVERY_MS_BOUNDS)
    self.shutdown_requested = threading.Event()

  # ---- broadcast fan-out ----

  def _forward_publish(self, payload: Dict[str, Any],
                       ctx: dict) -> None:
    """Forwards a publication to this host's tree children.

    Runs on the publishing connection's handler thread with its own
    per-child clients (in `ctx`: lock-free by ownership). A serving
    host that cannot be reached raises out of the handler: the learner's
    publish call sees the error, as if its own direct publish had
    failed; broadcast does not silently narrow the fleet. A front
    replica (`survivable` in `configure_broadcast`) that cannot be
    reached is skipped and counted: fronts only serve, and supervision
    respawns them.
    """
    with self._lock:
      children = list(self._children)
      survivable = set(self._survivable)
    if not children:
      return
    forwarded = dict(payload)
    forwarded["hop"] = int(payload.get("hop", 0)) + 1
    clients = ctx.setdefault("broadcast_clients", {})
    for child in children:
      try:
        client = clients.get(child)
        if client is None:
          client = clients[child] = rpc_lib.RpcClient(
              child,
              call_timeout_secs=getattr(
                  self._config, "rpc_call_timeout_secs",
                  rpc_lib.DEFAULT_CALL_TIMEOUT_SECS),
              max_retries=getattr(self._config, "rpc_max_retries",
                                  rpc_lib.DEFAULT_MAX_RETRIES),
              # A tree child is up when it is configured: a front that
              # refuses connections is dead, not warming.
              **(dict(connect_timeout_secs=_SURVIVABLE_CONNECT_SECS)
                 if child in survivable else {}),
              **_client_kwargs(self._config))
        client.call("publish", forwarded)
      except Exception:  # noqa: BLE001 — re-raised unless survivable
        if child not in survivable:
          raise
        # A front replica that died before supervision pruned it from
        # the tree: skipped, so the learner's publish does not fail.
        stale = clients.pop(child, None)
        if stale is not None:
          stale.close()
        tmetrics.counter("fleet.broadcast.forward_failures").inc()
        log.warning("publish forward to front %s failed; skipped",
                    child, exc_info=True)
        continue
      self._tm_forwards.inc()
      with self._lock:
        self._broadcast_forwards += 1

  def _publish_to(self, address: Tuple[str, int]) -> Optional[int]:
    """Sends the engine's current publication to one new front replica
    (respawned or added), marked `catch_up`: it would otherwise serve
    its seed's params until the learner's next publication. Returns the
    learner step sent, or None before the first publication."""
    published, arrays = self._read_publication()
    if published.version < 1:
      return None
    client = rpc_lib.RpcClient(address, **_client_kwargs(self._config))
    try:
      client.call("publish", {"state": arrays,
                              "step": int(published.learner_step),
                              "hop": self._tree_depth + 1,
                              "catch_up": True})
    finally:
      client.close()
    return int(published.learner_step)

  def _read_publication(self):
    """(the engine's current publication, its state as host numpy):
    the copy is retried until the slot it read was not reused by two
    swaps since (a swap writes the idle slot, so one swap leaves it
    whole)."""
    from tensor2robot_tpu_torch.fleet.learner import publication

    engine = self.policy_server.engine
    while True:
      published = engine.publication
      arrays = publication(published.state)
      if engine.publication.version - published.version < 2:
        return published, arrays

  # ---- the RPC method table ----

  def handle(self, method: str, payload: Any, ctx: dict) -> Any:
    if method == "act":
      # One atomic publication read: version and learner_step must be
      # a consistent pair (a swap between two property reads would
      # tear them). A swap landing between this read and the engine's
      # own dispatch can still attribute a single episode to the
      # adjacent publication: off by at most one refresh, which the
      # lag histogram tolerates.
      publication = self.policy_server.engine.publication
      actions = self.policy_server.select_actions(payload)
      return {"actions": np.asarray(actions),
              "params_version": publication.version,
              "params_learner_step": publication.learner_step,
              # The acting host's broadcast-tree depth: actors stamp
              # it into commits so lag is attributable PER HOP.
              "params_hop": self._tree_depth}
    if method == "acting_state":
      # Whole-params refresh for Anakin pods: a pod acts on its own
      # device (the envs and the Q-network run in one collection), so
      # instead of per-step `act` RPCs it pulls the published acting
      # state and runs with it until the version moves. An unchanged
      # `have_version` returns the stamp alone, no state payload.
      published = self.policy_server.engine.publication
      have = (int(payload.get("have_version", -1))
              if isinstance(payload, dict) else -1)
      reply: Dict[str, Any] = {
          "params_version": published.version,
          "params_learner_step": published.learner_step,
          "params_hop": self._tree_depth,
          "state": None,
      }
      if published.version != have and published.state is not None:
        published, reply["state"] = self._read_publication()
        reply["params_version"] = published.version
        reply["params_learner_step"] = published.learner_step
      return reply
    if method in ("commit", "begin_episode", "append", "end_episode",
                  "sample", "size"):
      if self.replay is None:
        raise ValueError(
            f"host {self.host_index} serves no replay "
            "(replay_hosts > 0 — commits and samples go to the shard "
            "services)")
      if method == "commit":
        return self.replay.commit(payload, ctx)
      if method == "begin_episode":
        return self.replay.begin_episode(payload, ctx)
      if method == "append":
        return self.replay.append(payload, ctx)
      if method == "end_episode":
        return self.replay.end_episode(payload, ctx)
      if method == "sample":
        return self.replay.sample(int(payload))
      return self.replay.size()
    if method == "set_learner_step":
      step = int(payload)
      if self.replay is not None:
        self.replay.set_learner_step(step)
      now = time.monotonic()
      with self._lock:
        if self._learner_window is None:
          self._learner_window = (now, step, now, step)
        else:
          t0, s0, _, last = self._learner_window
          if step < last:
            # The learner's step went backward: a crash-resume
            # restored from a checkpoint. The host is the one witness
            # with continuous state across learner incarnations, so
            # the measured restore point is recorded here.
            self._resumes.append({"from_step": last, "to_step": step})
          self._learner_window = (t0, s0, now, step)
      return True
    if method == "publish":
      self.policy_server.update_state(_train_state(payload["state"]),
                                      learner_step=int(payload["step"]))
      with self._lock:
        self.publishes += 1
        if self._publish_t0 is None:
          self._publish_t0 = time.monotonic()
      tmetrics.counter("fleet.param_publishes").inc()
      # Broadcast hop accounting: the learner stamps its wall clock at
      # origin; every host in the tree records origin→local-swap
      # latency (same machine, same wall clock).
      if payload.get("origin_wall") is not None:
        self._tm_publish_ms.observe(
            max(0.0, (time.time() - float(payload["origin_wall"]))
                * 1e3))
      self._forward_publish(payload, ctx)
      return self.policy_server.params_version
    if method == "publish_to":
      return self._publish_to(tuple(payload["address"]))
    if method == "configure_broadcast":
      with self._lock:
        self._children = [tuple(c) for c in payload.get("children", ())]
        self._survivable = [tuple(c)
                            for c in payload.get("survivable", ())]
        self._tree_depth = int(payload.get("depth", 0))
      self._tm_depth.set(self._tree_depth)
      return True
    if method == "metrics_scalars":
      out = (self.replay.metrics_scalars()
             if self.replay is not None else {})
      out["fleet_param_publishes"] = float(self.publishes)
      return out
    if method == "metrics":
      return self.metrics()
    if method == "hello":
      engine = self.policy_server.engine
      capacity = (self.replay.store.capacity
                  if self.replay is not None
                  else int(self._config.replay_capacity))
      # `monotonic` is the telemetry clock handshake: the client reads
      # its own clock around the call and derives its offset to this
      # host's CLOCK_MONOTONIC (telemetry.clock_offset_from_handshake).
      return {"max_batch": engine.max_batch,
              "capacity": capacity,
              "params_version": engine.params_version,
              "params_learner_step": engine.params_learner_step,
              "monotonic": time.monotonic()}
    if method == "telemetry":
      # The fleet-wide aggregated view (one poll): the host's own
      # registry (serving and lag live here, at the choke point) plus
      # whatever snapshots the other roles pushed.
      proc.record_cuda_state()
      with self._lock:
        pushed = dict(self._pushed_telemetry)
      return {"host": tmetrics.registry().snapshot(),
              "pushed": pushed,
              "monotonic": time.monotonic()}
    if method == "telemetry_push":
      with self._lock:
        self._pushed_telemetry[str(payload["role"])] = {
            "snapshot": payload["snapshot"],
            "wall": time.time(),
        }
      return True
    if method == "flight_record":
      # The orchestrator's latched-error hook: a still-live host dumps
      # its span ring + registry before teardown.
      return flightrec.dump(payload["out_dir"],
                            payload.get("reason", "requested"))
    if method == "shutdown":
      self.shutdown_requested.set()
      return True
    if method == rpc_lib.DISCONNECT_METHOD:
      # A dropped connection aborts every session it opened: whatever
      # its actor staged mid-episode is discarded, never committed
      # (identity-checked in the front: a late-detected death never
      # touches a restarted incarnation's fresh session). Broadcast
      # forward clients opened by this connection close with it.
      if self.replay is not None:
        self.replay.abort_sessions(ctx)
      for client in ctx.get("broadcast_clients", {}).values():
        client.close()
      return None
    raise ValueError(f"unknown fleet rpc method {method!r}")

  def metrics(self) -> Dict[str, Any]:
    with self._lock:
      learner_window = self._learner_window
      resumes = list(self._resumes)
      publishes = self.publishes
      broadcast = {
          "depth": self._tree_depth,
          "children": len(self._children),
          "forwards": self._broadcast_forwards,
      }
    if self.replay is not None:
      front = self.replay.metrics()
    else:
      front = {"store": None, "service": None, "staleness": {},
               "param_refresh_lag": None, "commit_window": None}
    engine = self.policy_server.engine
    front.update({
        "publishes": publishes,
        "params_version": engine.params_version,
        "params_learner_step": engine.params_learner_step,
        "learner_window": (None if learner_window is None else {
            "first_time": learner_window[0],
            "first_step": learner_window[1],
            "last_time": learner_window[2],
            "last_step": learner_window[3],
        }),
        "learner_resumes": resumes,
        "commit_window": front.get("commit_window"),
        "serving_dispatches": engine.dispatch_count,
        "host_index": self.host_index,
        "broadcast": broadcast,
        "served_params_sha256": served_params_digests(
            engine.publication.state),
        "cuda_initialized": proc.record_cuda_state(),
    })
    return front

  def close(self) -> None:
    # Intake is already stopped (the RPC server closes first); flush
    # what the writer still holds, then tear the batcher down.
    try:
      if self.replay is not None:
        self.replay.close()
    finally:
      self.policy_server.close()


class _ShardState:
  """One replay shard service: a 1-shard store behind a `ReplayFront`.

  Each shard host owns `replay_capacity / replay_hosts` rows with the
  same session/commit/sample/lag semantics as the single-host plane
  (shared through `ReplayFront`), so staleness and `param_refresh_lag`
  are accounted where the shard lives. Numpy only: the transition spec
  comes from a learner built on the CPU, which allocates nothing, and
  the process never touches the card.
  """

  def __init__(self, config, shard_index: int):
    from tensor2robot_tpu_torch.replay.service import (
        ReplayFront,
        ReplayWriteService,
    )
    from tensor2robot_tpu_torch.replay.store import ReplayStore

    self._config = config
    self.shard_index = int(shard_index)
    telemetry.configure(
        f"shard{shard_index}",
        trace_dir=getattr(config, "telemetry_dir", "") or None)
    from tensor2robot_tpu_torch.telemetry import perf as perf_lib
    perf_lib.start_resource_sampler()
    num_hosts = max(1, int(getattr(config, "replay_hosts", 1)))
    store = ReplayStore(
        # The spec comes from the same learner constructor every other
        # process uses: structural agreement by construction.
        _build_learner(config, device="cpu").transition_specification(),
        capacity=max(1, config.replay_capacity // num_hosts),
        num_shards=1,  # one shard per host IS the sharding
        seed=config.seed + 11 + 97 * (shard_index + 1))
    service = ReplayWriteService(
        store,
        queue_batches=config.queue_batches,
        overflow=config.overflow)
    self.front = ReplayFront(store, service)
    self.shutdown_requested = threading.Event()

  def handle(self, method: str, payload: Any, ctx: dict) -> Any:
    if method == "commit":
      return self.front.commit(payload, ctx)
    if method == "begin_episode":
      return self.front.begin_episode(payload, ctx)
    if method == "append":
      return self.front.append(payload, ctx)
    if method == "end_episode":
      return self.front.end_episode(payload, ctx)
    if method == "sample":
      return self.front.sample(int(payload))
    if method == "size":
      return self.front.size()
    if method == "set_learner_step":
      self.front.set_learner_step(int(payload))
      return True
    if method == "metrics":
      out = self.front.metrics()
      out["shard_index"] = self.shard_index
      out["cuda_initialized"] = proc.record_cuda_state()
      return out
    if method == "metrics_scalars":
      return self.front.metrics_scalars()
    if method == "hello":
      return {"capacity": self.front.store.capacity,
              "shard_index": self.shard_index,
              "monotonic": time.monotonic()}
    if method == "telemetry":
      proc.record_cuda_state()
      return {"host": tmetrics.registry().snapshot(),
              "pushed": {},
              "monotonic": time.monotonic()}
    if method == "flight_record":
      return flightrec.dump(payload["out_dir"],
                            payload.get("reason", "requested"))
    if method == "shutdown":
      self.shutdown_requested.set()
      return True
    if method == rpc_lib.DISCONNECT_METHOD:
      self.front.abort_sessions(ctx)
      return None
    raise ValueError(f"unknown replay shard rpc method {method!r}")

  def close(self) -> None:
    self.front.close()


def _build_learner(config, device=None):
  """The host's own QTOptLearner: the same constructor the learner
  process uses, so the published TrainState trees match structurally
  (CEM serving params here, gradient state there). It passes no
  `cem_select`: the fleet's CEM runs the lax select on both paths, as
  in JAX. `device` None takes `FleetConfig.device` (None = the card)."""
  from tensor2robot_tpu_torch.research.qtopt.qtopt_learner import (
      QTOptLearner,
  )
  from tensor2robot_tpu_torch.research.qtopt.t2r_models import (
      GraspingQModel,
  )

  model = GraspingQModel(
      image_size=config.image_size,
      action_dim=config.action_dim,
      torso_filters=tuple(config.torso_filters),
      head_filters=tuple(config.head_filters),
      dense_sizes=tuple(config.dense_sizes))
  return QTOptLearner(
      model,
      cem_population=config.cem_population,
      cem_iterations=config.cem_iterations,
      cem_elites=config.cem_elites,
      cem_inference=config.cem_inference,
      device=device if device is not None else config.device)


def _train_state(published: Dict[str, Any]):
  """A publication's host numpy (`{"step", "params", "batch_stats"}`)
  as a CPU `TrainState`; the engine copies it into its idle slot."""
  import torch

  from tensor2robot_tpu_torch.models.abstract_model import TrainState

  def tensors(arrays: Dict[str, np.ndarray]) -> Dict[str, "torch.Tensor"]:
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}

  return TrainState(step=int(published["step"]),
                    params=tensors(published["params"]),
                    batch_stats=tensors(published["batch_stats"]))


def served_params_digests(state) -> Dict[str, str]:
  """SHA-256 of every served tensor's bytes (params and batch stats of
  an engine publication), keyed by name: the run's proof that the
  served params are the learner's, bit for bit."""
  from tensor2robot_tpu_torch.utils.checkpoints import tensor_digests

  return tensor_digests({**state.params, **state.batch_stats})


def host_main(config, ready_conn, stop_event, heartbeat,
              host_index: int = 0, root_address=None) -> None:
  """Child-process entry: build → handshake → serve → drain → exit.

  `ready_conn` (a Pipe end) carries the bound RPC address back to the
  orchestrator once the engine is warm (every bucket's graph captured);
  the orchestrator spawns actors and the learner only after this
  handshake, so clients never race a cold host.

  `stop_event` is the host's own stop signal, set by the orchestrator
  only after the final metrics read: the host must outlive the
  actor/learner drain (it is the last process standing in the shutdown
  barrier). The RPC `shutdown` method is the other exit.

  `host_index` > 0 spawns a broadcast-tree engine replica (no store);
  `root_address` (or a pipe end that delivers it once the root is up,
  `proc.await_address`) lets non-root hosts align their trace clock to
  the root's once serving.
  """
  proc.scrub_inherited_distributed_env()
  role = "host" if host_index == 0 else f"host{host_index}"
  # Server-side fault seam (slow_host stalls, injected disconnects):
  # armed before the server accepts, so call counting is deterministic
  # from the first RPC.
  faults_lib.install(config, role)
  try:
    state = _HostState(config, host_index=host_index)
    server = rpc_lib.RpcServer(state.handle, **_server_kwargs(config))
  except BaseException as e:
    # A host that dies building (bad config, compile failure) leaves
    # its last moments in the flight recorder before the orchestrator
    # sees the exit code.
    if getattr(config, "flightrec_dir", ""):
      flightrec.dump(config.flightrec_dir,
                     f"{role} launch failed: {e!r}")
    raise
  try:
    ready_conn.send({"address": server.address})
    ready_conn.close()
    if host_index != 0:
      _handshake_clock(config, proc.await_address(root_address))
    while not (stop_event.is_set() or state.shutdown_requested.is_set()):
      proc.beat(heartbeat)
      time.sleep(0.1)
  finally:
    from tensor2robot_tpu_torch.telemetry import perf as perf_lib
    perf_lib.stop_resource_sampler()  # no device reads past teardown
    server.close()
    state.close()
    telemetry.get_tracer().close()  # flush the host's trace tail


def replay_shard_main(config, shard_index: int, root_address,
                      ready_conn, stop_event, heartbeat) -> None:
  """Child-process entry for one replay shard service.

  Same lifecycle contract as `host_main`: address handshake over
  `ready_conn`, heartbeat while serving, drain on `stop_event` (set
  only after the orchestrator's final metrics read) or the RPC
  `shutdown`.
  """
  proc.scrub_inherited_distributed_env()
  role = f"shard{shard_index}"
  faults_lib.install(config, role)
  try:
    state = _ShardState(config, shard_index)
    server = rpc_lib.RpcServer(state.handle, **_server_kwargs(config))
  except BaseException as e:
    if getattr(config, "flightrec_dir", ""):
      flightrec.dump(config.flightrec_dir,
                     f"{role} launch failed: {e!r}")
    raise
  try:
    ready_conn.send({"address": server.address})
    ready_conn.close()
    _handshake_clock(config, proc.await_address(root_address))
    while not (stop_event.is_set() or state.shutdown_requested.is_set()):
      proc.beat(heartbeat)
      time.sleep(0.1)
  finally:
    from tensor2robot_tpu_torch.telemetry import perf as perf_lib
    perf_lib.stop_resource_sampler()
    server.close()
    state.close()
    telemetry.get_tracer().close()
