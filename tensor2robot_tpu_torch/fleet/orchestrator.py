"""Fleet orchestrator (port of `fleet/orchestrator.py`): the organs run
together as one topology on one card.

The learner/actor decomposition of "Podracer architectures for scalable
RL" as a process-supervising orchestrator on one host:

    actor 0..N-1 ──act──▶ ┌───────────────────────┐
        │                 │ host: CEMPolicyServer │
        │ commit          │  + ReplayWriteService │ ◀─publish─ learner
        └────────────────▶│  + ReplayStore        │ ──sample─▶ (train_qtopt)
                          └───────────────────────┘
                                     │ publish (broadcast tree)
    callers ──ServingRouter──▶ front 0..F-1 (ModelArena + admission)

Only the host(s), the fronts, the learner (every rank of a learner group)
and the Anakin pods touch the card; actors, replay shard hosts and this
process do not. Children start from a forkserver that imported torch and
the fleet's modules once (`proc.children_context`); a plain fork of
this process would inherit its CUDA state. Front replicas serve
external callers through a `serving.router.ServingRouter` over
`addresses["fronts"]`; actors act against the serving hosts only.

Lifecycle contract (the JAX package's):

  * Launch gate: when gin configs are given, the port's `run_t2r_trainer
    --validate_only` runs as a pre-spawn subprocess, so a typo'd binding
    fails the launch in seconds. It runs no t2rcheck (the JAX package's
    source lints cover JAX code only).
  * Refusals: what the port does not run yet is refused at `Fleet`
    construction, before anything is spawned, by a `FleetUnported`
    naming its ROADMAP item: `env="mujoco_pose"` (A10a).
  * Learner groups (`learner_hosts > 1`): N learner processes adopt one
    orchestrator-issued coordinator address and join one gloo group;
    any rank's death tears the collective and is fatal.
  * Anakin pods (`pod_hosts > 0`, `fleet/pod.py`): on-device collectors
    supervised like actors (crash policy, restart budget, heartbeats,
    `scale_pods_to`, `kick("pod-N")`).
  * Heartbeat and exit-code supervision: child exit codes are polled and
    the first failure is latched (later teardown noise never masks it);
    each child also stamps a shared monotonic heartbeat so a silently
    hung process is detected, not just a dead one.
  * Actor-crash policy: `restart` (default) respawns the actor under the
    same actor id, which re-opens its replay session (the service aborts
    whatever the dead incarnation staged), under a rate-based budget;
    `abort` takes the fleet down.
  * Learner death: fatal, or under `learner_crash_policy="resume"` a
    respawn that resumes from the latest checkpoint while the host keeps
    the store and the engine. Host death is always fatal.
  * Front death is survivable: the replica is respawned at its index
    under its own budget (`max_front_restarts`), or the membership
    shrinks; front observers (`add_front_observer`) tell a router's
    owner either way.
  * The control plane (`control=True`): a `control.Controller` over
    `fleet_rules()` is stepped after every aggregated telemetry poll and
    pulls the fleet's levers (`scale_to`, `scale_fronts_to`, `kick`,
    `retune_admission`, the degradation ladder); the sentinel's pages
    go to it first.
  * Shutdown barrier: stop events → actors drain and exit → final
    metrics are read → hosts flush replay and exit → every child is
    joined (terminate, then kill, on timeout). `shutdown` checks that no
    child is left alive.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import multiprocessing as mp
import os
import re
import secrets
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch import control as control_lib
from tensor2robot_tpu_torch.fleet import actor as actor_lib
from tensor2robot_tpu_torch.fleet import faults as faults_lib
from tensor2robot_tpu_torch.fleet import front as front_lib
from tensor2robot_tpu_torch.fleet import host as host_lib
from tensor2robot_tpu_torch.fleet import learner as learner_lib
from tensor2robot_tpu_torch.fleet import pod as pod_lib
from tensor2robot_tpu_torch.fleet import proc
from tensor2robot_tpu_torch.fleet.rpc import RpcClient, TRANSPORTS
from tensor2robot_tpu_torch.telemetry import core as tcore
from tensor2robot_tpu_torch.telemetry import flightrec
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
from tensor2robot_tpu_torch.telemetry import perf as perf_lib
from tensor2robot_tpu_torch.telemetry import records as trecords
from tensor2robot_tpu_torch.telemetry import sentinel as sentinel_lib

log = logging.getLogger(__name__)

_ENVS = ("toy_grasp", "pose", "mujoco_pose")
_CRASH_POLICIES = ("restart", "abort")
_LEARNER_CRASH_POLICIES = ("fatal", "resume")
_CRASH_MODES = ("raise", "hard", "mid_episode")
_OVERFLOW = ("drop", "block")

# The repository root: the launch gate runs the port's binary from it.
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RESULT_FILENAME = "fleet_result.json"

# Once rank 0 of a learner group has exited cleanly, each peer must exit
# cleanly within this many seconds (its hooks' `end`, the prefetcher's
# close and its telemetry flush come after the final collective).
PEER_EXIT_SECS = 60.0


class FleetError(RuntimeError):
  """A latched fleet failure (child death, hang, launch-gate reject)."""


class FleetUnported(FleetError, NotImplementedError):
  """A configuration the port does not run yet; names its ROADMAP item."""


# ---- broadcast tree shape ----
#
# Learner publications fan over a complete d-ary tree in heap layout
# over the serving-host list: host 0 is the root (the learner's only
# publish target) and host i forwards to serving[i*d+1 : i*d+1+d].


def broadcast_children(index: int, num_hosts: int,
                       degree: int) -> List[int]:
  """Serving-host indices `index` forwards publications to."""
  first = index * degree + 1
  return list(range(first, min(first + degree, num_hosts)))


def broadcast_depths(num_hosts: int, degree: int) -> List[int]:
  """Per-host hop count from the root (root = 0)."""
  depths = [0] * num_hosts
  for i in range(1, num_hosts):
    depths[i] = depths[(i - 1) // degree] + 1
  return depths


@gin.configurable
@dataclasses.dataclass
class FleetConfig:
  """One fleet's topology, model and lifecycle knobs (picklable: the
  same instance is shipped to every child process). Every field of the
  JAX `FleetConfig`, with its defaults and checks, plus `device`."""

  # Topology.
  num_actors: int = 2
  env: str = "mujoco_pose"
  # Model (mirrors GraspingQModel/QTOptLearner constructor args so the
  # host's serving tree and the learner's training tree match).
  image_size: int = 32
  action_dim: int = 2
  torso_filters: Tuple[int, ...] = (16, 32)
  head_filters: Tuple[int, ...] = (32, 32)
  dense_sizes: Tuple[int, ...] = (32, 32)
  cem_population: int = 64
  cem_iterations: int = 2
  cem_elites: int = 6
  cem_inference: str = "bf16"
  # Learner loop.
  batch_size: int = 64
  max_train_steps: int = 200
  min_replay_size: Optional[int] = None
  publish_every_steps: int = 25  # checkpoint == param-refresh cadence
  log_every_steps: int = 25
  # Actors.
  batch_episodes: int = 16
  epsilon: float = 0.1
  # Replay plane.
  replay_capacity: int = 4096
  replay_shards: int = 2
  queue_batches: int = 16
  overflow: str = "drop"
  # Serving plane.
  serve_max_batch: int = 8
  serve_max_wait_us: int = 200
  # Cross-host topology. transport="tcp" moves every fleet RPC onto
  # fleet/transport.py's framing with out-of-band buffers (loopback is
  # the stdlib multiprocessing.connection default). serving_hosts > 1
  # spawns engine-only serving replicas; actors spread act traffic
  # round-robin and learner publications fan over a
  # `broadcast_degree`-ary tree rooted at host 0. replay_hosts > 0
  # moves the replay plane onto dedicated shard processes (one shard
  # per host); actors commit to their rendezvous-hashed home shard and
  # the learner's sampler fans across shards shard-major. Replicas own
  # no replay store, so serving_hosts > 1 requires replay_hosts >= 1.
  transport: str = "loopback"
  tcp_sndbuf: int = 0  # 0 = kernel default (SO_SNDBUF untouched)
  tcp_rcvbuf: int = 0
  serving_hosts: int = 1
  replay_hosts: int = 0
  broadcast_degree: int = 2
  # Learner groups: learner_hosts > 1 spawns N learner processes in one
  # gloo group (each samples batch_size / N rows, gradients averaged,
  # rank 0 alone publishes and checkpoints); a member's death is fatal.
  # Anakin pods: pod_hosts > 0 spawns on-device collectors of
  # envs_per_pod functional envs rolling pod_rollout_length steps a
  # segment, committing whole segments to their home shard.
  learner_hosts: int = 1
  pod_hosts: int = 0
  envs_per_pod: int = 64
  pod_rollout_length: int = 4
  # Replicated serving-front tier: front_hosts > 0 spawns front replica
  # hosts (`fleet/front.py`), each serving `front_tenants` behind
  # admission; they join the broadcast tree after the serving hosts.
  front_hosts: int = 0
  front_tenants: Tuple[str, ...] = ("policy",)
  front_spread: int = 1
  front_slo_ms: float = 100.0
  speculative_cem: bool = False
  dedup_capacity: int = 0
  # Lifecycle. The restart budget is rate-based: a crashed actor may be
  # respawned up to `max_actor_restarts` times per `restart_window_secs`
  # sliding window (0 = a lifetime cap).
  actor_crash_policy: str = "restart"
  max_actor_restarts: int = 3
  restart_window_secs: float = 600.0
  # "fatal" (default): learner death takes the fleet down. "resume":
  # the learner is respawned and `train_qtopt` resumes from the latest
  # checkpoint in model_dir while the host keeps the replay store and
  # serving engine alive.
  learner_crash_policy: str = "fatal"
  max_learner_restarts: int = 2
  heartbeat_timeout_secs: float = 300.0  # 0 disables hang detection
  # Actor hang detection (actors beat per collect batch). 0 = use
  # heartbeat_timeout_secs.
  actor_heartbeat_timeout_secs: float = 0.0
  launch_timeout_secs: float = 240.0
  run_timeout_secs: float = 1800.0
  # One learner process either way: True is the plain learner at world
  # size 1, bit for bit.
  distributed_learner: bool = False
  seed: int = 0
  authkey: bytes = b""  # per-fleet key generated at construction
  # RPC deadline/retry envelope for the data-plane clients (actor and
  # both learner clients). The orchestrator's control channel takes the
  # deadline but stays single-shot (retry would stall supervision).
  rpc_call_timeout_secs: float = 120.0
  rpc_max_retries: int = 2
  # Telemetry plane. Empty = derived from the fleet's model_dir at
  # launch (<model_dir>/telemetry, /flightrec); telemetry_dir="off"
  # disables cross-process tracing.
  telemetry_dir: str = ""
  flightrec_dir: str = ""
  telemetry_poll_secs: float = 10.0  # 0 disables the aggregated poll
  # Alert sentinel over the aggregated fleet view
  # (`telemetry.sentinel.fleet_watches`), evaluated at every poll; a
  # page-severity breach dumps flight records naming the offending role.
  sentinel: bool = True
  # The closed-loop control plane: `control=True` steps a
  # `control.Controller` over `control.fleet_rules()` after every
  # aggregated poll (needs the telemetry plane and a poll cadence).
  control: bool = False
  control_dry_run: bool = False
  control_cadence_secs: float = 0.0
  control_max_actions: int = 4
  control_budget_window_secs: float = 300.0
  control_shed_priorities: Tuple[str, ...] = ()
  control_shed_rate_rps: float = 1.0
  front_respawn: bool = True
  max_front_restarts: int = 2
  # Fault injection: the single-fault knobs and `fault_plan` (a
  # faults.FaultPlan, shipped to every child; each role injects its own
  # events). The single-fault knobs fire in a process's first
  # incarnation only, like the plan's non-recurring events.
  actor_crash_after_episodes: Optional[int] = None
  actor_crash_mode: str = "raise"
  crash_actor_index: int = 0
  learner_crash_after_steps: Optional[int] = None
  fault_plan: Optional[Any] = None
  # Where the host(s) and the learner run: None = the card (through
  # `device.resolve_device`, which raises without one); "cpu" for tests.
  device: Optional[str] = None

  def __post_init__(self):
    if not self.authkey:
      # Per-fleet secret, generated at construction and shipped (via
      # pickle) to every child: two fleets on one machine never
      # cross-connect. Never b"": a falsy authkey makes the stdlib
      # Listener skip the auth challenge the Client then waits for (a
      # handshake deadlock).
      self.authkey = secrets.token_bytes(16)
    if self.num_actors < 0:
      raise ValueError(f"num_actors must be >= 0, got {self.num_actors}")
    if self.num_actors < 1 and self.pod_hosts < 1:
      raise ValueError(
          "the fleet needs at least one collector: num_actors >= 1 or "
          "pod_hosts >= 1")
    if self.learner_hosts < 1:
      raise ValueError(
          f"learner_hosts must be >= 1, got {self.learner_hosts}")
    if self.batch_size % self.learner_hosts != 0:
      raise ValueError(
          f"batch_size ({self.batch_size}) must divide evenly across "
          f"the learner group (learner_hosts={self.learner_hosts}): "
          "each rank samples and feeds batch_size/learner_hosts rows")
    if self.learner_hosts > 1 and self.learner_crash_policy != "fatal":
      raise ValueError(
          "learner_hosts > 1 requires learner_crash_policy='fatal': a "
          "group member's death tears the gloo collective, so the only "
          "sound recovery is a full-group teardown")
    if self.pod_hosts < 0:
      raise ValueError(f"pod_hosts must be >= 0, got {self.pod_hosts}")
    if self.envs_per_pod < 1:
      raise ValueError(
          f"envs_per_pod must be >= 1, got {self.envs_per_pod}")
    if self.pod_rollout_length < 1:
      raise ValueError(
          f"pod_rollout_length must be >= 1, got "
          f"{self.pod_rollout_length}")
    if self.pod_hosts and self.env == "toy_grasp":
      raise ValueError(
          "pod_hosts requires a functional env family (pose/"
          "mujoco_pose/procgen): Anakin pods vmap the env inside pmap, "
          "which toy_grasp's stateful host env cannot do")
    if self.env not in _ENVS:
      raise ValueError(f"env must be one of {_ENVS}, got {self.env!r}")
    if self.actor_crash_policy not in _CRASH_POLICIES:
      raise ValueError(
          f"actor_crash_policy must be one of {_CRASH_POLICIES}, got "
          f"{self.actor_crash_policy!r}")
    if self.actor_crash_mode not in _CRASH_MODES:
      raise ValueError(
          f"actor_crash_mode must be one of {_CRASH_MODES}, got "
          f"{self.actor_crash_mode!r}")
    if self.learner_crash_policy not in _LEARNER_CRASH_POLICIES:
      raise ValueError(
          f"learner_crash_policy must be one of "
          f"{_LEARNER_CRASH_POLICIES}, got "
          f"{self.learner_crash_policy!r}")
    if self.overflow not in _OVERFLOW:
      raise ValueError(
          f"overflow must be one of {_OVERFLOW}, got {self.overflow!r}")
    if self.transport not in TRANSPORTS:
      raise ValueError(
          f"transport must be one of {TRANSPORTS}, got "
          f"{self.transport!r}")
    if self.serving_hosts < 1:
      raise ValueError(
          f"serving_hosts must be >= 1, got {self.serving_hosts}")
    if self.replay_hosts < 0:
      raise ValueError(
          f"replay_hosts must be >= 0, got {self.replay_hosts}")
    if self.broadcast_degree < 1:
      raise ValueError(
          f"broadcast_degree must be >= 1, got {self.broadcast_degree}")
    if self.serving_hosts > 1 and self.replay_hosts < 1:
      raise ValueError(
          "serving_hosts > 1 requires replay_hosts >= 1: serving "
          "replicas are engine-only (no replay store), so the replay "
          "plane must live on dedicated shard hosts")
    if self.front_hosts < 0:
      raise ValueError(
          f"front_hosts must be >= 0, got {self.front_hosts}")
    if self.front_spread < 1:
      raise ValueError(
          f"front_spread must be >= 1, got {self.front_spread}")
    if self.front_hosts and self.front_spread > self.front_hosts:
      raise ValueError(
          f"front_spread ({self.front_spread}) cannot exceed "
          f"front_hosts ({self.front_hosts})")
    if not self.front_tenants:
      raise ValueError("front_tenants must name at least one tenant")
    if self.dedup_capacity < 0:
      raise ValueError(
          f"dedup_capacity must be >= 0, got {self.dedup_capacity}")
    if self.max_front_restarts < 0:
      raise ValueError(
          f"max_front_restarts must be >= 0, got "
          f"{self.max_front_restarts}")
    if self.control_max_actions < 1:
      raise ValueError(
          f"control_max_actions must be >= 1, got "
          f"{self.control_max_actions}")
    if self.control_cadence_secs < 0 or self.control_budget_window_secs < 0:
      raise ValueError(
          "control_cadence_secs and control_budget_window_secs must "
          "be >= 0")
    if self.control_shed_rate_rps <= 0:
      raise ValueError(
          f"control_shed_rate_rps must be positive, got "
          f"{self.control_shed_rate_rps}")
    if self.fault_plan is not None and not isinstance(
        self.fault_plan, faults_lib.FaultPlan):
      raise ValueError(
          f"fault_plan must be a faults.FaultPlan, got "
          f"{type(self.fault_plan).__name__}")




@dataclasses.dataclass
class FleetResult:
  """What a completed fleet run measured."""

  env_steps_per_sec: float
  learner_steps_per_sec: float
  param_refresh_lag: Dict[str, Any]
  replay_staleness: Dict[str, Any]
  publishes: int
  params_version: int
  actor_restarts: int
  wall_secs: float
  clean_shutdown: bool
  metrics: Dict[str, Any]
  # Recovery accounting: one record per supervised fault the
  # orchestrator detected and recovered from ({fault, target, mttr_ms,
  # ...}); learner respawns under the resume policy; elastic membership
  # changes ({action, index, t}).
  recoveries: List[Dict[str, Any]] = dataclasses.field(
      default_factory=list)
  learner_restarts: int = 0
  scale_events: List[Dict[str, Any]] = dataclasses.field(
      default_factory=list)


def unported(config: FleetConfig) -> List[str]:
  """What of `config` the port does not run yet, each naming its
  ROADMAP item ([] when the port runs it)."""
  out = []
  if config.env == "mujoco_pose":
    out.append("env='mujoco_pose' needs MuJoCoPoseEnv (ROADMAP A10a); "
               "bind FleetConfig.env = 'pose' for the numpy PoseEnv")
  return out


class Fleet:
  """Launches, supervises, and tears down one learner/actor fleet."""

  def __init__(self, config: FleetConfig, model_dir: str,
               gin_configs: Sequence[str] = ()):
    refused = unported(config)
    if refused:
      raise FleetUnported(
          "the port does not run this fleet yet: " + "; ".join(refused))
    self.config = config
    # The per-run resolved copy (telemetry/flight-record dirs filled
    # in) is built at launch(); until then fall back to the caller's.
    self._run_config = config
    self.model_dir = model_dir
    self.gin_configs = tuple(gin_configs)
    self._ctx = proc.children_context()
    # Stop signals: the hosts have their own (they must outlive the
    # actor/learner drain so the final metrics read has someone to
    # talk to), and every actor gets a per-actor event so elastic
    # scale-down can drain one actor without touching the rest
    # (`scale_to`); the shutdown barrier drains the whole fleet by
    # setting every per-actor event under `_scale_lock`.
    self._host_stop = self._ctx.Event()
    self._host: Optional[mp.Process] = None
    # Serving replicas (host_index > 0) and replay shard hosts, all
    # sharing `_host_stop`.
    self._serving: Dict[int, mp.Process] = {}
    self._shards: Dict[int, mp.Process] = {}
    # Front replicas: the one survivable host-class failure (respawned,
    # or moved to `front_failures` as the membership shrinks).
    self._fronts: Dict[int, mp.Process] = {}
    self.front_failures: List[Dict[str, Any]] = []
    # One persistent control entry per extra host: {name, address,
    # client}; the client is opened lazily and dropped on poisoning
    # like the root control channel.
    self._aux_hosts: List[Dict[str, Any]] = []
    self._addresses: Optional[Dict[str, Any]] = None
    # Children spawned before the address they need exists: the sending
    # pipe ends of the root's address (extra hosts) and of the address
    # book (actors, learner), by child name (`launch`).
    self._root_pipes: Dict[str, Any] = {}
    self._book_pipes: Dict[str, Any] = {}
    self._learner: Optional[mp.Process] = None
    # A learner group's ranks > 0, by rank.
    self._learner_peers: Dict[int, mp.Process] = {}
    # Anakin pods: collectors supervised like actors, with their own
    # stop events and restart counts.
    self._pods: Dict[int, mp.Process] = {}
    self._pod_stops: Dict[int, Any] = {}
    self._pod_restarts: Dict[int, int] = {}
    self._next_pod_index = config.pod_hosts
    self._actors: Dict[int, mp.Process] = {}
    self._actor_stops: Dict[int, Any] = {}
    self._draining: List[Tuple[int, mp.Process]] = []
    self._heartbeats: Dict[str, Any] = {}
    self._spawned_at: Dict[str, float] = {}
    self._restarts: Dict[int, int] = {}
    # Sliding-window restart stamps per target name: the rate-based
    # budget (restarts per restart_window_secs, not per lifetime).
    self._restart_times: Dict[str, Any] = {}
    self._learner_restarts = 0
    # In-flight recoveries: detected faults whose respawned process has
    # not yet stamped a heartbeat. Completed ones move to `recoveries`
    # with their measured MTTR.
    self._pending_recoveries: List[Dict[str, Any]] = []
    self.recoveries: List[Dict[str, Any]] = []
    self.scale_events: List[Dict[str, Any]] = []
    # Guards actor-membership mutations: scale_to() may be called from
    # another thread while wait() supervises.
    self._scale_lock = threading.RLock()
    self._next_actor_index = config.num_actors
    self._control: Optional[RpcClient] = None
    self._address: Optional[Tuple[str, int]] = None
    self._error: Optional[BaseException] = None
    self._launched = False
    self._closed = False
    self._t_launched: Optional[float] = None
    self._tracer: Optional[tcore.Tracer] = None
    self._telemetry_file: Optional[Any] = None
    self._t_last_poll = 0.0
    self._sentinel: Optional[sentinel_lib.Sentinel] = None
    # The control plane, built at launch when `config.control` is on and
    # stepped after every telemetry poll.
    self._controller: Optional[control_lib.Controller] = None
    self._degradation: Optional[control_lib.DegradationLadder] = None
    # Front membership callbacks `(event, index, address)`, event in
    # {"respawned", "lost", "added", "removed"}: a ServingRouter's owner
    # calls `mark_alive`/`mark_dead` from them.
    self._front_observers: List[Callable[[str, int, Any], None]] = []
    self._front_restarts: Dict[int, int] = {}
    self._next_front_index = config.front_hosts

  # ---- launch ----

  def _run_launch_gate(self) -> None:
    """The port's `run_t2r_trainer --validate_only` as the pre-spawn
    gate (no t2rcheck: the JAX package's source lints are not ported)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, env.get("PYTHONPATH", "")) if p)
    for config_path in self.gin_configs:
      result = subprocess.run(
          [sys.executable, "-m",
           "tensor2robot_tpu_torch.bin.run_t2r_trainer",
           "--validate_only", "--gin_configs", config_path],
          capture_output=True, text=True, timeout=300, env=env)
      if result.returncode != 0:
        raise FleetError(
            f"launch gate rejected {config_path!r} "
            f"(validate_only exit {result.returncode}):\n"
            f"{result.stdout}\n{result.stderr}")

  def _heartbeat(self, name: str):
    value = self._ctx.Value("d", time.monotonic())
    self._heartbeats[name] = value
    self._spawned_at[name] = time.monotonic()
    return value

  def _later(self, pipes: Dict[str, Any], name: str) -> Any:
    """A pipe end that delivers an address to child `name` later (see
    `launch`); the sending end waits in `pipes`."""
    receive, send = self._ctx.Pipe(duplex=False)
    pipes[name] = send
    return receive

  def _start(self, process: mp.Process, *child_ends: Any) -> mp.Process:
    """Starts `process`, then closes this process's copies of the pipe
    ends it was handed (a closed sender must read as EOF there)."""
    process.start()
    for end in child_ends:
      if hasattr(end, "recv"):
        end.close()
    return process

  def _book(self, name: str) -> Any:
    """What a client child dials: the address book, or while the hosts
    are still coming up, a pipe end that delivers it once they are."""
    if self._addresses is not None:
      return self._addresses
    return self._later(self._book_pipes, name)

  def _deliver(self, pipes: Dict[str, Any], address: Any) -> None:
    """Sends `address` down every pipe waiting in `pipes`. A child's
    staleness clock starts now: the wait was the hosts', not its own."""
    for name, send in pipes.items():
      try:
        send.send(address)
      except OSError:
        pass  # the child died; supervision reads its exit code
      send.close()
      self._spawned_at[name] = time.monotonic()
    pipes.clear()

  def _spawn_actor(self, index: int, incarnation: int) -> None:
    name = f"t2r-fleet-actor-{index}"
    heartbeat = self._heartbeat(name)
    stop = self._actor_stops.get(index)
    if stop is None:
      stop = self._actor_stops[index] = self._ctx.Event()
    address = self._book(name)
    self._actors[index] = self._start(self._ctx.Process(
        target=actor_lib.actor_main,
        args=(self._run_config, index, address, stop, heartbeat,
              incarnation),
        name=name, daemon=True), address)

  def _spawn_pod(self, index: int, incarnation: int) -> None:
    name = f"t2r-fleet-pod-{index}"
    heartbeat = self._heartbeat(name)
    stop = self._pod_stops.get(index)
    if stop is None:
      stop = self._pod_stops[index] = self._ctx.Event()
    address = self._book(name)
    self._pods[index] = self._start(self._ctx.Process(
        target=pod_lib.pod_main,
        args=(self._run_config, index, address, stop, heartbeat,
              incarnation),
        name=name, daemon=True), address)

  def _spawn_learner(self, incarnation: int = 0) -> None:
    """The learner, and with `learner_hosts` = N > 1 its N − 1 peers:
    every rank adopts one fresh coordinator address (two fleets on one
    machine never share a port)."""
    config = self._run_config
    world = int(config.learner_hosts)
    coordinator = None
    if world > 1:
      from tensor2robot_tpu_torch.parallel.distributed import (
          ephemeral_coordinator_address,
      )
      coordinator = ephemeral_coordinator_address()
    for rank in range(world):
      name = ("t2r-fleet-learner" if rank == 0
              else f"t2r-fleet-learner-r{rank}")
      address = self._book(name)
      process = self._start(self._ctx.Process(
          target=learner_lib.learner_main,
          args=(config, self.model_dir, address, self._heartbeat(name),
                coordinator, incarnation, world, rank),
          name=name, daemon=True), address)
      if rank == 0:
        self._learner = process
      else:
        self._learner_peers[rank] = process

  def _await_ready(self, parent_conn: Any, process: mp.Process,
                   what: str, timeout_secs: float) -> Tuple[str, int]:
    """One ready-handshake: blocks for the child's address report."""
    if not parent_conn.poll(timeout_secs):
      raise FleetError(
          f"{what} did not report ready within {timeout_secs:.0f}s "
          f"(exitcode={process.exitcode})")
    try:
      info = parent_conn.recv()
    except (EOFError, OSError):
      # poll() also returns True on EOF: a child that died during
      # construction (bad config, no card, import failure) lands here,
      # not in the timeout branch; same latch/abort treatment.
      process.join(timeout=10.0)
      raise FleetError(
          f"{what} died before reporting ready "
          f"(exitcode={process.exitcode})") from None
    parent_conn.close()
    return tuple(info["address"])

  def _spawn_extra_hosts(self, config: FleetConfig) -> List[Tuple[
      Dict[str, Any], Any, mp.Process, str]]:
    """Serving replicas and replay shard hosts, each handed a pipe end
    that delivers the root's address (for the clock handshake) once the
    root is up; returns their pending ready-handshakes."""
    pending: List[Tuple[Dict[str, Any], Any, mp.Process, str]] = []
    for i in range(1, config.serving_hosts):
      name = f"t2r-fleet-host-{i}"
      parent_conn, child_conn = self._ctx.Pipe()
      root = self._later(self._root_pipes, name)
      self._serving[i] = self._start(self._ctx.Process(
          target=host_lib.host_main,
          args=(config, child_conn, self._host_stop,
                self._heartbeat(name), i, root),
          name=name, daemon=True), child_conn, root)
      entry = {"kind": "serving", "index": i, "name": f"host{i}",
               "address": None, "client": None}
      self._aux_hosts.append(entry)
      pending.append((entry, parent_conn, self._serving[i],
                      f"serving host {i}"))
    for i in range(config.replay_hosts):
      name = f"t2r-fleet-shard-{i}"
      parent_conn, child_conn = self._ctx.Pipe()
      root = self._later(self._root_pipes, name)
      process = self._shards[i] = self._start(self._ctx.Process(
          target=host_lib.replay_shard_main,
          args=(config, i, root, child_conn, self._host_stop,
                self._heartbeat(name)),
          name=name, daemon=True), child_conn, root)
      entry = {"kind": "shard", "index": i, "name": f"shard{i}",
               "address": None, "client": None}
      self._aux_hosts.append(entry)
      pending.append((entry, parent_conn, process, f"replay shard {i}"))
    for i in range(config.front_hosts):
      pending.append(self._spawn_front(config, i))
    return pending

  def _spawn_front(self, config: FleetConfig, index: int,
                   incarnation: int = 0):
    """Starts one front replica and registers its bookkeeping; returns
    the `(entry, parent_conn, process, what)` pending handshake (launch,
    respawn and front scale-up all await it the same way). At launch
    the root's address comes later, down a pipe. `incarnation` counts
    the index's respawns: a fault plan's non-recurring events fire in
    incarnation 0 only, as an actor's do (JAX's front takes none, so a
    respawned JAX front re-arms the plan; ROADMAP Queue C)."""
    name = f"t2r-fleet-front-{index}"
    parent_conn, child_conn = self._ctx.Pipe()
    root = (self._address if self._address is not None
            else self._later(self._root_pipes, name))
    process = self._fronts[index] = self._start(self._ctx.Process(
        target=front_lib.front_main,
        args=(config, index, root, child_conn, self._host_stop,
              self._heartbeat(name), incarnation),
        name=name, daemon=True), child_conn, root)
    entry = {"kind": "front", "index": index, "name": f"front{index}",
             "address": None, "client": None}
    self._aux_hosts.append(entry)
    return entry, parent_conn, process, f"front host {index}"

  def _aux_client(self, entry: Dict[str, Any]) -> Optional[RpcClient]:
    """The entry's control client, (re)connected on demand. Same
    single-shot envelope as the root control channel."""
    if entry["client"] is None:
      config = self._run_config
      try:
        entry["client"] = RpcClient(
            entry["address"], authkey=config.authkey,
            connect_timeout_secs=10.0,
            call_timeout_secs=config.rpc_call_timeout_secs,
            max_retries=0, transport=config.transport,
            sndbuf=config.tcp_sndbuf, rcvbuf=config.tcp_rcvbuf)
      except Exception:  # noqa: BLE001
        log.warning("control reconnect to %s failed", entry["name"],
                    exc_info=True)
        return None
    return entry["client"]

  def _aux_call(self, entry: Dict[str, Any], method: str,
                payload: Any = None,
                timeout_secs: Optional[float] = None) -> Any:
    """One control call to an extra host; poisoned-on-timeout clients
    are dropped so the next call reconnects (rpc.py contract)."""
    client = self._aux_client(entry)
    if client is None:
      raise FleetError(f"no control channel to {entry['name']}")
    try:
      return client.call(method, payload, timeout_secs=timeout_secs)
    except Exception:
      client.close()
      entry["client"] = None
      raise

  def _configure_broadcast(self, config: FleetConfig) -> None:
    """Wires the d-ary publication tree over the serving hosts and the
    front replicas: one heap layout (serving hosts first, fronts after),
    so the learner's single uplink fans to every engine and every front
    arena. Each host learns its forward set and its depth (stamped into
    act replies as `params_hop` for per-hop lag attribution)."""
    serving = list(self._addresses["serving"])
    front_entries = [entry for entry in self._aux_hosts
                     if entry["kind"] == "front"]
    combined = serving + [entry["address"] for entry in front_entries]
    if len(combined) < 2:
      return  # single serving host: root defaults (no children, hop 0)
    depths = broadcast_depths(len(combined), config.broadcast_degree)
    replicas = [entry for entry in self._aux_hosts
                if entry["kind"] == "serving"]
    for i in range(len(combined)):
      children = broadcast_children(i, len(combined),
                                    config.broadcast_degree)
      # A front child is survivable: a forward that fails on it (a
      # replica that died before supervision pruned it) is skipped, not
      # raised into the learner's publish.
      payload = {"children": [list(combined[c]) for c in children],
                 "survivable": [list(combined[c]) for c in children
                                if c >= len(serving)],
                 "depth": depths[i]}
      if i == 0:
        self._control.call("configure_broadcast", payload,
                           timeout_secs=30.0)
      elif i < len(serving):
        self._aux_call(replicas[i - 1], "configure_broadcast", payload,
                       timeout_secs=30.0)
      else:
        self._aux_call(front_entries[i - len(serving)],
                       "configure_broadcast", payload,
                       timeout_secs=30.0)
    if self._tracer is not None:
      self._tracer.event("fleet.broadcast_configured",
                         hosts=len(combined),
                         degree=config.broadcast_degree,
                         max_depth=max(depths))

  def launch(self) -> None:
    """Gate → every child spawned → hosts' handshakes → broadcast
    wiring → the address book to the actors and the learner.

    The children start together: a process's imports (torch's alone
    takes seconds) then overlap the hosts' build instead of following
    it. A child that needs an address it cannot know yet gets a pipe
    end that delivers it: the extra hosts the root's once the root is
    up, the actors and the learner the address book once every host is
    warm, so no client dials a cold host."""
    if self._launched:
      return
    self._run_launch_gate()
    # Resolve the telemetry plane before spawn into a per-run copy: the
    # copy ships (via pickle) to every child, so this is the one place
    # the trace/flight-record directories are decided, and the caller's
    # FleetConfig is never mutated.
    telemetry_dir = self.config.telemetry_dir
    if telemetry_dir == "off":
      telemetry_dir = ""  # tracing off; flight dumps keep working
    elif not telemetry_dir:
      telemetry_dir = os.path.join(self.model_dir, "telemetry")
    config = dataclasses.replace(
        self.config,
        telemetry_dir=telemetry_dir,
        flightrec_dir=(self.config.flightrec_dir
                       or flightrec.flightrec_dir(self.model_dir)))
    self._run_config = config
    if config.telemetry_dir:
      # The orchestrator's own timeline: a private tracer (never the
      # process-global one: the supervising process may be a trainer or
      # a test with its own telemetry identity).
      self._tracer = tcore.Tracer().configure(
          "orchestrator", trace_dir=config.telemetry_dir)
    if (config.control and config.telemetry_dir
        and config.telemetry_poll_secs):
      # The closed-loop control plane: the gin-tunable rule table over
      # the standard actuator set, stepped after every aggregated poll.
      # Built before the sentinel, whose act tier routes alerts to it.
      if config.control_shed_priorities:
        self._degradation = control_lib.DegradationLadder(
            config.control_shed_priorities,
            retune=self._shed_retune,
            shed_rate_rps=config.control_shed_rate_rps)
      self._controller = control_lib.Controller(
          control_lib.fleet_rules(),
          control_lib.fleet_actuators(
              self, on_page=self._control_page,
              degradation=self._degradation),
          cadence_secs=config.control_cadence_secs,
          dry_run=config.control_dry_run,
          max_actions=config.control_max_actions,
          budget_window_secs=config.control_budget_window_secs,
          decisions_path=os.path.join(
              config.telemetry_dir, control_lib.DECISIONS_FILENAME),
          tracer=self._tracer)
    if (config.telemetry_dir and config.sentinel
        and config.telemetry_poll_secs and perf_lib.plane_enabled()):
      # The fleet sentinel: gin-tunable rules evaluated over every
      # aggregated poll; a page-severity breach first offers itself to
      # the controller's act tier (a successful remediation demotes the
      # page), and only an unremediated one triggers the flight-recorder
      # path below, role-named like the hang path.
      self._sentinel = sentinel_lib.Sentinel(
          sentinel_lib.fleet_watches(),
          alerts_path=os.path.join(config.telemetry_dir,
                                   sentinel_lib.ALERTS_FILENAME),
          on_act=(self._controller.handle_alert
                  if self._controller is not None else None),
          on_page=self._sentinel_page,
          tracer=self._tracer)
    parent_conn, child_conn = self._ctx.Pipe()
    self._host = self._start(self._ctx.Process(
        target=host_lib.host_main,
        args=(config, child_conn, self._host_stop,
              self._heartbeat("t2r-fleet-host")),
        name="t2r-fleet-host", daemon=True), child_conn)
    pending = self._spawn_extra_hosts(config)
    for index in range(config.num_actors):
      self._restarts[index] = 0
      self._spawn_actor(index, incarnation=0)
    for index in range(config.pod_hosts):
      self._pod_restarts[index] = 0
      self._spawn_pod(index, incarnation=0)
    self._spawn_learner(incarnation=0)
    deadline = time.monotonic() + config.launch_timeout_secs
    try:
      # Handshakes, under one launch deadline: a host reports its bound
      # RPC address once its engine is warm; one that died building
      # surfaces here with its exit code instead of a silent hang.
      self._address = self._await_ready(
          parent_conn, self._host, "host", config.launch_timeout_secs)
      self._deliver(self._root_pipes, self._address)
      for entry, conn, process, what in pending:
        entry["address"] = self._await_ready(
            conn, process, what, max(0.0, deadline - time.monotonic()))
    except FleetError as e:
      self._latch(e)
      self._abort()
      raise self._error from None
    self._addresses = {
        "serving": [self._address] + [
            entry["address"] for entry in self._aux_hosts
            if entry["kind"] == "serving"],
        "shards": [entry["address"] for entry in self._aux_hosts
                   if entry["kind"] == "shard"],
        # Front replicas are not act-traffic targets (actors round-robin
        # over "serving" only); routers read this map.
        "fronts": {entry["index"]: entry["address"]
                   for entry in self._aux_hosts
                   if entry["kind"] == "front"},
    }
    # The control channel rides the deadline half of the envelope only:
    # every control call sits on a latency-bounded path (supervision,
    # the shutdown barrier, forensics) with its own poisoned-connection
    # recovery, and a transparent reconnect-and-retry would multiply a
    # wedged host's stall. Data-plane clients keep retries.
    self._control = RpcClient(
        self._address, authkey=config.authkey,
        call_timeout_secs=config.rpc_call_timeout_secs,
        max_retries=0, transport=config.transport,
        sndbuf=config.tcp_sndbuf, rcvbuf=config.tcp_rcvbuf)
    try:
      self._configure_broadcast(config)
    except Exception as e:  # noqa: BLE001 — any wiring failure is fatal
      self._latch(FleetError(f"broadcast-tree configuration failed: "
                             f"{e!r}"))
      self._abort()
      raise self._error from None
    self._deliver(self._book_pipes, self._addresses)
    self._launched = True
    self._t_launched = time.monotonic()
    if self._tracer is not None:
      self._tracer.event("orchestrator.launched",
                         actors=config.num_actors,
                         pods=config.pod_hosts,
                         learner_hosts=config.learner_hosts)

  # ---- supervision ----

  def _latch(self, error: BaseException) -> None:
    """First failure wins: teardown noise after the latch never
    replaces the root cause."""
    if self._error is None:
      self._error = error

  # ---- the rate-based restart budget ----

  def _budget_ok(self, target: str) -> bool:
    """True while `target` has budget left in the sliding restart
    window (restarts per `restart_window_secs`; window 0 is a lifetime
    cap). Expired stamps are pruned here, so a long-lived fleet absorbs
    occasional churn forever while a crash-loop trips the budget within
    one window."""
    window = self.config.restart_window_secs
    if target == "learner":
      limit = self.config.max_learner_restarts
    elif target.startswith("front-"):
      limit = self.config.max_front_restarts
    else:
      limit = self.config.max_actor_restarts
    stamps = self._restart_times.setdefault(
        target, collections.deque())
    if window:
      now = time.monotonic()
      while stamps and now - stamps[0] > window:
        stamps.popleft()
    return len(stamps) < limit

  def _charge_restart(self, target: str) -> None:
    self._restart_times.setdefault(
        target, collections.deque()).append(time.monotonic())

  # ---- fault recovery ----

  def _begin_recovery(self, fault: str, target: str, name: str,
                      **detail: Any) -> None:
    """Registers an in-flight recovery: the respawned process named
    `name` completes it by stamping its heartbeat (its first unit of
    real work: an actor's first collect batch, the learner's first
    resumed train step), which is when MTTR ends."""
    if self._tracer is not None:
      self._tracer.event("fleet.fault_detected", fault=fault,
                         target=target, **detail)
    self._pending_recoveries.append({
        "fault": fault, "target": target,
        "t_detected": detail.pop("t_detected"),
        "t_respawned": time.monotonic(),
        "heartbeat": self._heartbeats[name],
        "detail": detail})

  def _complete_recoveries(self) -> None:
    still: List[Dict[str, Any]] = []
    for pending in self._pending_recoveries:
      stamped = pending["heartbeat"].value
      if stamped <= pending["t_respawned"]:
        still.append(pending)
        continue
      mttr_ms = (stamped - pending["t_detected"]) * 1e3
      entry = {"fault": pending["fault"], "target": pending["target"],
               "mttr_ms": round(mttr_ms, 1)}
      entry.update(pending["detail"])
      self.recoveries.append(entry)
      faults_lib.recovery_histogram().observe(mttr_ms)
      if self._tracer is not None:
        self._tracer.event("fleet.recovered", **entry)
      log.warning("fleet recovered from %s (%s): MTTR %.0f ms",
                  pending["fault"], pending["target"], mttr_ms)
    self._pending_recoveries = still

  def _handle_actor_failure(self, index: int, fault: str,
                            t_detected: Optional[float] = None,
                            **detail: Any) -> None:
    """One dead/hung actor: respawn under the rate budget, or raise.

    ``t_detected`` is when the fault was detected: callers whose
    handling itself takes time (the hang path's terminate/join
    escalation) pass the stamp they took at detection so MTTR never
    excludes the kill latency; None = detection is now."""
    target = f"actor-{index}"
    if (self.config.actor_crash_policy == "restart"
        and self._budget_ok(target)):
      self._restarts[index] += 1
      self._charge_restart(target)
      log.warning(
          "actor %d failed (%s %s); restart %d (budget %d per "
          "%.0fs window) — session will reopen with "
          "abort-of-staged-rows", index, fault, detail,
          self._restarts[index], self.config.max_actor_restarts,
          self.config.restart_window_secs)
      if t_detected is None:
        t_detected = time.monotonic()
      self._spawn_actor(index, incarnation=self._restarts[index])
      self._begin_recovery(fault, target, f"t2r-fleet-actor-{index}",
                           t_detected=t_detected, **detail)
      return
    raise FleetError(
        f"actor {index} died ({fault}, {detail}) under "
        f"policy={self.config.actor_crash_policy!r} after "
        f"{self._restarts[index]} restart(s) — restart budget "
        f"({self.config.max_actor_restarts} per "
        f"{self.config.restart_window_secs:.0f}s window) exhausted"
        if self.config.actor_crash_policy == "restart" else
        f"actor {index} died ({fault}, {detail}) under "
        f"policy={self.config.actor_crash_policy!r}")

  def _handle_pod_failure(self, index: int, fault: str,
                          t_detected: Optional[float] = None,
                          **detail: Any) -> None:
    """One dead/hung Anakin pod: the actor contract. A segment is one
    atomic commit (or staged rows the shard aborts on disconnect), so a
    respawn reopens a fresh session and no partial segment ever lands
    (`adds_total % (envs_per_pod * pod_rollout_length) == 0`)."""
    target = f"pod-{index}"
    if (self.config.actor_crash_policy == "restart"
        and self._budget_ok(target)):
      self._pod_restarts[index] += 1
      self._charge_restart(target)
      log.warning(
          "pod %d failed (%s %s); restart %d (budget %d per %.0fs "
          "window); segments are committed atomically, so no partial "
          "rows survive", index, fault, detail,
          self._pod_restarts[index], self.config.max_actor_restarts,
          self.config.restart_window_secs)
      if t_detected is None:
        t_detected = time.monotonic()
      self._spawn_pod(index, incarnation=self._pod_restarts[index])
      self._begin_recovery(fault, target, f"t2r-fleet-pod-{index}",
                           t_detected=t_detected, **detail)
      return
    raise FleetError(
        f"pod {index} died ({fault}, {detail}) under "
        f"policy={self.config.actor_crash_policy!r} after "
        f"{self._pod_restarts[index]} restart(s) — restart budget "
        f"({self.config.max_actor_restarts} per "
        f"{self.config.restart_window_secs:.0f}s window) exhausted"
        if self.config.actor_crash_policy == "restart" else
        f"pod {index} died ({fault}, {detail}) under "
        f"policy={self.config.actor_crash_policy!r}")

  def _handle_front_failure(self, index: int, fault: str,
                            t_detected: Optional[float] = None,
                            **detail: Any) -> None:
    """One lost front replica: respawn under the front budget, else the
    membership shrinks.

    Fronts only serve (no replay rows, no training lease, no actor act
    traffic), so a death is never fatal. With `front_respawn` on and
    budget left, the replica is respawned at its original index; the
    new address replaces the old one in the broadcast tree and the
    front observers are told "respawned", so a router's owner re-admits
    it through `mark_alive(index, address)`. Otherwise (respawn off,
    budget spent, shutting down) routers fail the replica's tenants
    over to HRW survivors on their side, and the broadcast tree is
    pruned so the next publish fans over the survivors.
    """
    if t_detected is None:
      t_detected = time.monotonic()
    # The dead incarnation's bookkeeping goes either way.
    self._fronts.pop(index, None)
    name = f"t2r-fleet-front-{index}"
    self._heartbeats.pop(name, None)
    self._spawned_at.pop(name, None)
    entry = next(
        (e for e in self._aux_hosts
         if e["kind"] == "front" and e["index"] == index), None)
    if entry is not None:
      if entry["client"] is not None:
        entry["client"].close()
        entry["client"] = None
      self._aux_hosts.remove(entry)
    if self._addresses is not None:
      self._addresses.get("fronts", {}).pop(index, None)
    if not self._closed:
      # Prune the dead replica from the publication tree now: a respawn
      # takes the length of a front's build.
      try:
        self._configure_broadcast(self._run_config)
      except Exception:  # noqa: BLE001 — best-effort rewire
        log.warning("broadcast rewire after front %d died failed", index,
                    exc_info=True)
    target = f"front-{index}"
    if (self.config.front_respawn and not self._closed
        and self._budget_ok(target)):
      try:
        address = self._respawn_front(index, fault, t_detected, detail)
      except FleetError:
        log.warning("front %d respawn failed; falling back to "
                    "membership shrink", index, exc_info=True)
      else:
        self._notify_front_observers("respawned", index, address)
        return
    event = {"fault": fault, "target": target,
             "t_detected": t_detected}
    event.update(detail)
    self.front_failures.append(event)
    if self._tracer is not None:
      self._tracer.event("fleet.front_replica_lost", **event)
    log.warning("front replica %d lost (%s %s); %d replica(s) "
                "remain; routers reshed its tenants to survivors",
                index, fault, detail, len(self._fronts))
    self._notify_front_observers("lost", index, None)

  def _respawn_front(self, index: int, fault: str, t_detected: float,
                     detail: Dict[str, Any]) -> Tuple[str, int]:
    """Respawns one front replica at its original index; returns the
    new address. A failed respawn unwinds its half-spawn bookkeeping and
    raises `FleetError` (the caller falls back to the shrink)."""
    self._front_restarts[index] = self._front_restarts.get(index, 0) + 1
    self._charge_restart(f"front-{index}")
    log.warning(
        "front %d failed (%s %s); respawn %d (budget %d per %.0fs "
        "window)", index, fault, detail, self._front_restarts[index],
        self.config.max_front_restarts,
        self.config.restart_window_secs)
    entry, parent_conn, process, what = self._spawn_front(
        self._run_config, index, incarnation=self._front_restarts[index])
    try:
      entry["address"] = self._await_ready(
          parent_conn, process, what,
          self._run_config.launch_timeout_secs)
    except FleetError:
      self._fronts.pop(index, None)
      self._heartbeats.pop(f"t2r-fleet-front-{index}", None)
      self._spawned_at.pop(f"t2r-fleet-front-{index}", None)
      if entry in self._aux_hosts:
        self._aux_hosts.remove(entry)
      if process.is_alive():
        process.kill()
        process.join(timeout=5.0)
      raise
    if self._addresses is not None:
      self._addresses.setdefault("fronts", {})[index] = entry["address"]
    self._begin_recovery(fault, f"front-{index}",
                         f"t2r-fleet-front-{index}",
                         t_detected=t_detected, **detail)
    try:
      self._configure_broadcast(self._run_config)
    except Exception:  # noqa: BLE001 — best-effort rewire
      log.warning("broadcast rewire after front respawn failed",
                  exc_info=True)
    self._catch_up_front(entry)
    return entry["address"]

  def _catch_up_front(self, entry: Dict[str, Any]) -> None:
    """Has the root host send its current publication to a front that
    joined mid-run (after it is in the broadcast tree, so no later
    publication can pass it by). Best-effort: a front that misses it
    serves the next publication."""
    config = self._run_config
    try:
      client = RpcClient(
          self._address, authkey=config.authkey, connect_timeout_secs=10.0,
          call_timeout_secs=config.rpc_call_timeout_secs, max_retries=0,
          transport=config.transport, sndbuf=config.tcp_sndbuf,
          rcvbuf=config.tcp_rcvbuf)
      try:
        step = client.call("publish_to",
                           {"address": list(entry["address"])},
                           timeout_secs=60.0)
      finally:
        client.close()
    except Exception:  # noqa: BLE001 — the next publication catches up
      log.warning("catch-up publication to %s failed", entry["name"],
                  exc_info=True)
      return
    if self._tracer is not None and step is not None:
      self._tracer.event("fleet.front_caught_up", front=entry["name"],
                         step=step)

  def add_front_observer(
      self, fn: Callable[[str, int, Any], None]) -> None:
    """Registers a front-membership callback `(event, index, address)`,
    event in {"respawned", "lost", "added", "removed"}: the seam a
    `ServingRouter`'s owner uses to call `mark_alive(index, address)` /
    `mark_dead(index)`, so placement tracks supervision. Callbacks run
    on the supervising thread."""
    self._front_observers.append(fn)

  def _notify_front_observers(self, event: str, index: int,
                              address: Any) -> None:
    for fn in list(self._front_observers):
      try:
        fn(event, index, address)
      except Exception:  # noqa: BLE001 — an observer must never break
        # supervision (it runs on the supervising thread).
        log.warning("front observer failed on %s front %d", event,
                    index, exc_info=True)

  def _check_heartbeats(self) -> None:
    """Hang detection. A stale actor heartbeat is a recoverable fault
    under the restart policy (kill-and-respawn, the `actor_hang`
    class); a stale learner/host heartbeat stays fatal: a hung learner
    holds the training lease and a hung host is the fleet."""
    global_timeout = self.config.heartbeat_timeout_secs
    actor_timeout = (self.config.actor_heartbeat_timeout_secs
                     or global_timeout)
    now = time.monotonic()
    for name, value in list(self._heartbeats.items()):
      is_actor = name.startswith("t2r-fleet-actor-")
      # Pods beat per segment as actors beat per batch: they share the
      # collector timeout and the kill-and-respawn policy.
      is_pod = name.startswith("t2r-fleet-pod-")
      timeout = actor_timeout if (is_actor or is_pod) else global_timeout
      if not timeout:
        continue
      last = max(value.value, self._spawned_at.get(name, 0.0))
      stale = now - last
      if stale <= timeout:
        continue
      if name.startswith("t2r-fleet-front-"):
        # A hung front replica is handled like a dead one: killed, then
        # respawned or shed (`_handle_front_failure`).
        index = int(name.rsplit("-", 1)[1])
        process = self._fronts.get(index)
        if process is None:
          continue
        log.warning("front %d heartbeat stale for %.0fs; killing the "
                    "hung replica", index, stale)
        # MTTR starts at detection, like the actor hang path.
        t_detected = time.monotonic()
        process.terminate()
        process.join(timeout=5.0)
        if process.is_alive():
          process.kill()
          process.join(timeout=5.0)
        self._handle_front_failure(
            index, faults_lib.SERVING_REPLICA_CRASH,
            t_detected=t_detected, stale_secs=round(stale, 1))
        continue
      if is_pod and self.config.actor_crash_policy == "restart":
        index = int(name.rsplit("-", 1)[1])
        process = self._pods.get(index)
        if process is None:
          continue  # drained by a concurrent scale_pods_to
        log.warning("pod %d heartbeat stale for %.0fs; killing the "
                    "hung process for respawn", index, stale)
        t_detected = time.monotonic()
        process.terminate()
        process.join(timeout=5.0)
        if process.is_alive():
          process.kill()
          process.join(timeout=5.0)
        self._handle_pod_failure(index, faults_lib.ACTOR_HANG,
                                 t_detected=t_detected,
                                 stale_secs=round(stale, 1))
        continue
      if is_actor and self.config.actor_crash_policy == "restart":
        index = int(name.rsplit("-", 1)[1])
        process = self._actors.get(index)
        if process is None:
          continue  # drained by a concurrent scale_down
        log.warning("actor %d heartbeat stale for %.0fs; killing the "
                    "hung process for respawn", index, stale)
        # MTTR starts here, at detection: a SIGTERM-masking hang pays
        # up to two 5 s joins below, and that kill latency is part of
        # the outage the fleet experienced.
        t_detected = time.monotonic()
        process.terminate()
        process.join(timeout=5.0)
        if process.is_alive():
          process.kill()
          process.join(timeout=5.0)
        self._handle_actor_failure(index, faults_lib.ACTOR_HANG,
                                   t_detected=t_detected,
                                   stale_secs=round(stale, 1))
        continue
      raise FleetError(
          f"{name} heartbeat stale for {stale:.0f}s "
          f"(> {timeout:.0f}s): process hung")

  def _fresh_control(self) -> Optional[RpcClient]:
    """A new control-channel client (a timed-out call poisons the old
    one: rpc.py contract); None when the host is unreachable.
    Single-shot like the launch-time client."""
    if self._address is None:
      return None
    config = self._run_config
    try:
      return RpcClient(
          self._address, authkey=config.authkey,
          connect_timeout_secs=10.0,
          call_timeout_secs=config.rpc_call_timeout_secs,
          max_retries=0, transport=config.transport,
          sndbuf=config.tcp_sndbuf, rcvbuf=config.tcp_rcvbuf)
    except Exception:  # noqa: BLE001
      log.warning("control-channel reconnect failed", exc_info=True)
      return None

  def _poll_telemetry(self, force: bool = False) -> None:
    """One aggregated fleet-wide metrics read at the poll cadence: the
    host's registry (replay/serving/lag live at that choke point) plus
    every snapshot the other roles pushed, flattened per role and
    appended to `<telemetry_dir>/fleet_metrics.jsonl` as one envelope
    record, then the sentinel's pass over it. `force` bypasses the
    cadence gate (the end-of-run view must land even when the learner
    finishes mid-interval)."""
    cadence = self._run_config.telemetry_poll_secs
    if (not cadence or self._control is None
        or not self._run_config.telemetry_dir):
      return
    now = time.monotonic()
    if not force and now - self._t_last_poll < cadence:
      return
    self._t_last_poll = now
    try:
      view = self._control.call("telemetry", timeout_secs=30.0)
    except Exception:  # noqa: BLE001 — instrumentation only
      # A timed-out call poisons the client (the late reply could be
      # read as the answer to the next control call, e.g. the final
      # `metrics`): drop the connection and open a fresh one.
      log.warning("fleet telemetry poll failed; reconnecting the "
                  "control channel", exc_info=True)
      self._control.close()
      self._control = self._fresh_control()
      return
    payload = tmetrics.scalars_from_snapshot(view.get("host") or {})
    for role, pushed in (view.get("pushed") or {}).items():
      payload.update(tmetrics.scalars_from_snapshot(
          pushed.get("snapshot") or {}, prefix=f"{role}/"))
    # Extra hosts fold into the same envelope, namespaced per host
    # (host1/..., shard0/...).
    for entry in self._aux_hosts:
      try:
        aux_view = self._aux_call(entry, "telemetry", timeout_secs=30.0)
      except Exception:  # noqa: BLE001 — instrumentation only
        log.warning("telemetry poll of %s failed", entry["name"],
                    exc_info=True)
        continue
      payload.update(tmetrics.scalars_from_snapshot(
          aux_view.get("host") or {}, prefix=f"{entry['name']}/"))
      for role, pushed in (aux_view.get("pushed") or {}).items():
        payload.update(tmetrics.scalars_from_snapshot(
            pushed.get("snapshot") or {}, prefix=f"{role}/"))
    step = learner_step(payload)
    record = trecords.make_record(step, payload, role="orchestrator")
    if self._telemetry_file is None:
      self._telemetry_file = open(
          os.path.join(self._run_config.telemetry_dir,
                       "fleet_metrics.jsonl"), "a")
    self._telemetry_file.write(json.dumps(record) + "\n")
    self._telemetry_file.flush()
    if self._tracer is not None:
      self._tracer.event("orchestrator.telemetry_poll",
                         metrics=len(payload))
    if self._sentinel is not None:
      # Watch rules over the same aggregated view that just landed in
      # fleet_metrics.jsonl; page-severity breaches route through the
      # controller's act tier (on_act) here, before its rule pass.
      self._sentinel.evaluate(payload)
    if self._controller is not None:
      try:
        self._controller.maybe_step(payload, step=step)
      except Exception:  # noqa: BLE001 — the policy plane must never
        # take down the supervision loop it advises.
        log.warning("control step failed", exc_info=True)

  def _heartbeat_ages(self) -> Dict[str, float]:
    now = time.monotonic()
    return {
        name: round(now - max(value.value,
                              self._spawned_at.get(name, 0.0)), 3)
        for name, value in self._heartbeats.items()}

  def _sentinel_page(self, alert: Dict[str, Any]) -> None:
    """Page-severity alert → the flight-recorder path: the orchestrator
    dumps its own view (heartbeat ages, restart counts) with the
    offending role in the reason, and asks a still-live host to dump
    its ring. Non-fatal: the fleet keeps running."""
    if not self._run_config.flightrec_dir:
      return
    reason = (f"sentinel page: alert.{alert['rule']} on "
              f"{alert['metric']} = {alert.get('value'):.6g} "
              f"(role {alert['role']})")
    extra: Dict[str, Any] = {"alert": alert,
                             "heartbeat_ages_secs": self._heartbeat_ages(),
                             "actor_restarts": dict(self._restarts),
                             "pod_restarts": dict(self._pod_restarts)}
    if self._controller is not None:
      # An escalated page means the act tier did not remediate; the
      # decision tail shows why (cooldown, budget, actuator error).
      extra["control"] = self._controller.flight_extra()
    flightrec.dump(
        self._run_config.flightrec_dir, reason, extra=extra,
        role="orchestrator")
    if (self._control is not None and self._host is not None
        and self._host.is_alive()):
      try:
        self._control.call("flight_record", {
            "out_dir": self._run_config.flightrec_dir,
            "reason": reason}, timeout_secs=15.0)
      except Exception:  # noqa: BLE001 — forensics must not mask
        log.warning("host flight-record request failed", exc_info=True)
        # Poisoned-on-timeout contract (rpc.py): never let a later
        # control call read this call's late reply.
        self._control.close()
        self._control = self._fresh_control()

  def _control_page(self, decision: Dict[str, Any]) -> None:
    """The control plane's terminal lever (the `page` actuator): a rule
    ran out of cheaper actions, so the decision escalates with the
    flight-record artifact a sentinel page produces, plus the
    controller's recent decisions."""
    if not self._run_config.flightrec_dir:
      return
    reason = (f"control page: rule {decision.get('rule')} on "
              f"{decision.get('metric')} (role {decision.get('role')})")
    extra = {"decision": {k: v for k, v in decision.items()
                          if k != "detail"},
             "heartbeat_ages_secs": self._heartbeat_ages(),
             "actor_restarts": dict(self._restarts),
             "pod_restarts": dict(self._pod_restarts)}
    if self._controller is not None:
      extra["control"] = self._controller.flight_extra()
    flightrec.dump(self._run_config.flightrec_dir, reason,
                   extra=extra, role="orchestrator")

  def _flight_record(self, error: BaseException) -> None:
    """The latched-error / hang-detection flight-recorder trigger: dump
    the orchestrator's view (heartbeat ages name a hung process, one
    that cannot dump itself) and ask a still-live host to dump its own
    ring; learner/actor dumps happen in their processes' except
    paths."""
    if not self._run_config.flightrec_dir:
      return
    extra: Dict[str, Any] = {"heartbeat_ages_secs": self._heartbeat_ages(),
                             "actor_restarts": dict(self._restarts),
                             "pod_restarts": dict(self._pod_restarts)}
    if self._controller is not None:
      # What the control plane saw and did before the latch.
      extra["control"] = self._controller.flight_extra()
    flightrec.dump(
        self._run_config.flightrec_dir, f"fleet latched: {error!r}",
        extra=extra, role="orchestrator")
    if (self._control is not None and self._host is not None
        and self._host.is_alive()):
      try:
        self._control.call("flight_record", {
            "out_dir": self._run_config.flightrec_dir,
            "reason": f"fleet latched: {error!r}"}, timeout_secs=15.0)
      except Exception:  # noqa: BLE001 — forensics must not mask
        log.warning("host flight-record request failed", exc_info=True)
        # Poisoned on timeout and we are aborting: drop it rather than
        # let shutdown read a stale reply.
        self._control.close()
        self._control = None

  def _reap_draining(self) -> None:
    """Scale-down drains finish asynchronously; a drained actor's exit
    (any code: it was leaving) must never read as a crash."""
    still: List[Tuple[int, mp.Process]] = []
    for index, process in self._draining:
      if process.exitcode is None:
        still.append((index, process))
      elif process.exitcode != 0:
        log.warning("drained actor %d exited %s", index,
                    process.exitcode)
    self._draining = still

  def _join_learner_peers(self) -> None:
    """Rank 0 ended cleanly: the run is clean only if every peer rank
    ends cleanly too, within `PEER_EXIT_SECS`."""
    deadline = time.monotonic() + PEER_EXIT_SECS
    for rank, process in self._learner_peers.items():
      process.join(timeout=max(0.0, deadline - time.monotonic()))
      if process.exitcode is None:
        raise FleetError(
            f"learner group rank {rank} did not exit within "
            f"{PEER_EXIT_SECS:.0f}s of rank 0's clean end")
      if process.exitcode != 0:
        raise FleetError(
            f"learner group rank {rank} failed after rank 0's clean end "
            f"(exit {process.exitcode})")

  def _supervise_once(self) -> bool:
    """One poll; returns True when the learner finished cleanly."""
    with self._scale_lock:
      # Learner-group peers first: a dead rank tears the collective, so
      # rank 0 is (or soon will be) stuck in a reduction; the peer's
      # exit code is the root cause.
      for rank, process in self._learner_peers.items():
        if process.exitcode is not None and process.exitcode != 0:
          raise FleetError(
              f"learner group rank {rank} died (exit {process.exitcode}): "
              "the collective is torn, so the whole group is lost "
              "(learner_crash_policy='fatal' is the only sound policy for "
              "learner_hosts > 1)")
      learner = self._learner
      if learner.exitcode is not None:
        if learner.exitcode == 0:
          self._join_learner_peers()
          return True
        if (self.config.learner_crash_policy == "resume"
            and self._budget_ok("learner")):
          # The resume policy: respawn the learner; the host stays up
          # with the replay store and serving engine intact, and
          # `train_qtopt` restores from the latest checkpoint in
          # model_dir, so at most one publish cadence of training
          # progress is lost and no experience at all.
          self._learner_restarts += 1
          self._charge_restart("learner")
          log.warning(
              "learner died (exit %s); resume %d (budget %d per "
              "%.0fs window) from the latest checkpoint",
              learner.exitcode, self._learner_restarts,
              self.config.max_learner_restarts,
              self.config.restart_window_secs)
          t_detected = time.monotonic()
          self._spawn_learner(incarnation=self._learner_restarts)
          self._begin_recovery(
              faults_lib.LEARNER_CRASH, "learner",
              "t2r-fleet-learner", t_detected=t_detected,
              exitcode=learner.exitcode)
        else:
          raise FleetError(
              f"learner died (exit {learner.exitcode}) under "
              f"policy={self.config.learner_crash_policy!r} after "
              f"{self._learner_restarts} resume(s); stopping actors")
      if self._host.exitcode is not None:
        raise FleetError(
            f"replay/serving host died (exit {self._host.exitcode})")
      # Every host-class process is load-bearing topology: a dead
      # serving replica strands its actors' act traffic and its
      # broadcast subtree; a dead shard strands committed experience.
      for index, process in self._serving.items():
        if process.exitcode is not None:
          raise FleetError(
              f"serving host {index} died (exit {process.exitcode})")
      for index, process in self._shards.items():
        if process.exitcode is not None:
          raise FleetError(
              f"replay shard {index} died (exit {process.exitcode})")
      # Front replicas only serve: a death is survivable.
      for index, process in list(self._fronts.items()):
        if process.exitcode is not None:
          self._handle_front_failure(
              index, faults_lib.SERVING_REPLICA_CRASH,
              exitcode=process.exitcode)
      for index, process in list(self._actors.items()):
        if process.exitcode is None:
          continue
        # Any exit while the fleet is running is a crash (clean actor
        # exits only happen after a stop event: shutdown or a
        # scale-down drain, both of which remove the actor first).
        self._handle_actor_failure(index, faults_lib.ACTOR_CRASH,
                                   exitcode=process.exitcode)
      for index, process in list(self._pods.items()):
        if process.exitcode is None:
          continue
        self._handle_pod_failure(index, faults_lib.ACTOR_CRASH,
                                 exitcode=process.exitcode)
      self._reap_draining()
      self._check_heartbeats()
      self._complete_recoveries()
    return False

  # ---- elastic membership ----

  def scale_to(self, num_actors: int) -> None:
    """Elastic actor membership: grow or shrink the fleet mid-run.

    Scale-up spawns fresh actors under new indices (each with its own
    stop event, heartbeat and restart budget); scale-down sets the
    highest-indexed actors' per-actor stop events: each finishes its
    current collect batch (commits are atomic episodes, so no partial
    rows can land) and exits, joined asynchronously by supervision.
    Safe to call from another thread while `wait()` supervises.
    """
    if num_actors < 1:
      raise ValueError(f"num_actors must be >= 1, got {num_actors}")
    with self._scale_lock:
      # Checked under the lock shutdown() closes the fleet under: a
      # scale-up can never slip between the `_closed` flip and the
      # stop-event broadcast and spawn an actor nothing would stop.
      if not self._launched or self._closed:
        raise FleetError("scale_to() needs a launched, open fleet")
      current = sorted(self._actors)
      delta = num_actors - len(current)
      if delta == 0:
        return
      now = time.monotonic()
      if delta > 0:
        for _ in range(delta):
          index = self._next_actor_index
          self._next_actor_index += 1
          self._restarts[index] = 0
          self._spawn_actor(index, incarnation=0)
          self.scale_events.append(
              {"action": "add", "index": index, "t": now})
      else:
        for index in current[delta:]:
          process = self._actors.pop(index)
          self._actor_stops.pop(index).set()
          name = f"t2r-fleet-actor-{index}"
          self._heartbeats.pop(name, None)
          self._spawned_at.pop(name, None)
          self._draining.append((index, process))
          self.scale_events.append(
              {"action": "remove", "index": index, "t": now})
      tmetrics.gauge("fleet.actors").set(len(self._actors))
      if self._tracer is not None:
        self._tracer.event("fleet.scaled", actors=len(self._actors))
      log.info("fleet scaled to %d actors", len(self._actors))

  @property
  def closed(self) -> bool:
    """True once `shutdown` began (the end of `run`, or an abort)."""
    return self._closed

  @property
  def num_actors(self) -> int:
    return len(self._actors)

  @property
  def num_pods(self) -> int:
    return len(self._pods)

  def scale_pods_to(self, num_pods: int) -> None:
    """Elastic pod membership, as `scale_to`: grow under fresh indices,
    shrink by setting the highest-indexed pods' stop events (each
    finishes and commits its current segment, then exits, joined by the
    supervision drain). 0 is allowed while process actors remain: the
    fleet needs one collector tier non-empty."""
    if num_pods < 0:
      raise ValueError(f"num_pods must be >= 0, got {num_pods}")
    with self._scale_lock:
      if not self._launched or self._closed:
        raise FleetError("scale_pods_to() needs a launched, open fleet")
      if num_pods == 0 and not self._actors:
        raise FleetError(
            "scale_pods_to(0) would leave the fleet with no collectors "
            "(no process actors remain)")
      current = sorted(self._pods)
      delta = num_pods - len(current)
      if delta == 0:
        return
      now = time.monotonic()
      if delta > 0:
        for _ in range(delta):
          index = self._next_pod_index
          self._next_pod_index += 1
          self._pod_restarts[index] = 0
          self._spawn_pod(index, incarnation=0)
          self.scale_events.append(
              {"action": "add_pod", "index": index, "t": now})
      else:
        for index in current[delta:]:
          process = self._pods.pop(index)
          self._pod_stops.pop(index).set()
          name = f"t2r-fleet-pod-{index}"
          self._heartbeats.pop(name, None)
          self._spawned_at.pop(name, None)
          self._draining.append((index, process))
          self.scale_events.append(
              {"action": "remove_pod", "index": index, "t": now})
      tmetrics.gauge("fleet.pods").set(len(self._pods))
      if self._tracer is not None:
        self._tracer.event("fleet.scaled_pods", pods=len(self._pods))
      log.info("fleet scaled to %d pods", len(self._pods))

  @property
  def num_fronts(self) -> int:
    return len(self._fronts)

  @property
  def front_addresses(self) -> Dict[int, Tuple[str, int]]:
    """The live front replicas' RPC addresses, by index (a router's
    replica map)."""
    if self._addresses is None:
      return {}
    return dict(self._addresses.get("fronts", {}))

  def scale_fronts_to(self, num_fronts: int) -> None:
    """Elastic front-tier membership: grow under fresh indices (each
    caught up with the current publication, then observers told
    "added"), shrink by draining the highest-indexed
    replicas through their RPC `shutdown` (observers told "removed"
    first, so routers stop placing tenants on a leaving replica). The
    broadcast tree is rewired over the result. Safe from another thread
    while `wait()` supervises, like `scale_to`."""
    if num_fronts < 1:
      raise ValueError(f"num_fronts must be >= 1, got {num_fronts}")
    with self._scale_lock:
      if not self._launched or self._closed:
        raise FleetError("scale_fronts_to() needs a launched, open "
                         "fleet")
      current = sorted(self._fronts)
      delta = num_fronts - len(current)
      if delta == 0:
        return
      now = time.monotonic()
      if delta > 0:
        pending = []
        for _ in range(delta):
          index = self._next_front_index
          self._next_front_index += 1
          pending.append(self._spawn_front(self._run_config, index))
        deadline = (time.monotonic()
                    + self._run_config.launch_timeout_secs)
        for entry, parent_conn, process, what in pending:
          entry["address"] = self._await_ready(
              parent_conn, process, what,
              max(0.0, deadline - time.monotonic()))
          if self._addresses is not None:
            self._addresses.setdefault(
                "fronts", {})[entry["index"]] = entry["address"]
          self.scale_events.append(
              {"action": "add_front", "index": entry["index"],
               "t": now})
      else:
        for index in current[delta:]:
          self._notify_front_observers("removed", index, None)
          process = self._fronts.pop(index)
          entry = next(
              (e for e in self._aux_hosts
               if e["kind"] == "front" and e["index"] == index), None)
          if entry is not None:
            try:
              self._aux_call(entry, "shutdown", timeout_secs=10.0)
            except Exception:  # noqa: BLE001 — join/kill below wins
              log.warning("front %d shutdown rpc failed", index,
                          exc_info=True)
            if entry["client"] is not None:
              entry["client"].close()
              entry["client"] = None
            self._aux_hosts.remove(entry)
          if self._addresses is not None:
            self._addresses.get("fronts", {}).pop(index, None)
          self._heartbeats.pop(f"t2r-fleet-front-{index}", None)
          self._spawned_at.pop(f"t2r-fleet-front-{index}", None)
          self._join_or_kill(process, 30.0, f"front host {index}")
          self.scale_events.append(
              {"action": "remove_front", "index": index, "t": now})
      try:
        self._configure_broadcast(self._run_config)
      except Exception:  # noqa: BLE001 — best-effort rewire
        log.warning("broadcast rewire after front scale failed",
                    exc_info=True)
      if delta > 0:
        # In the tree now: catch each new front up, then admit it.
        for entry, _, _, _ in pending:
          self._catch_up_front(entry)
          self._notify_front_observers("added", entry["index"],
                                       entry["address"])
      tmetrics.gauge("fleet.fronts").set(len(self._fronts))
      if self._tracer is not None:
        self._tracer.event("fleet.fronts_scaled",
                           fronts=len(self._fronts))
      log.info("fleet scaled to %d fronts", len(self._fronts))

  def kick(self, role: str) -> None:
    """Targeted kill-and-respawn of one recoverable role (the
    `respawn_role` actuator's seam): the process is terminated and the
    existing failure paths take over, so an actor respawns under the
    actor budget and a front under the front budget, with the MTTR
    accounting of an organic crash. Accepts telemetry role names
    (`actor-3`, `front1`, `pod-0`); anything else (learner, host, shard,
    "fleet") raises: kicking a load-bearing role is an outage."""
    match = re.fullmatch(r"(actor|front|pod)-?(\d+)", role)
    if match is None:
      raise FleetError(
          f"role {role!r} is not kickable (only actor-N / front-N / "
          f"pod-N are recoverable by respawn)")
    kind, index = match.group(1), int(match.group(2))
    with self._scale_lock:
      if not self._launched or self._closed:
        raise FleetError("kick() needs a launched, open fleet")
      processes = {"actor": self._actors, "front": self._fronts,
                   "pod": self._pods}[kind]
      process = processes.get(index)
      if process is None or process.exitcode is not None:
        raise FleetError(f"{role} is not running (already respawned "
                         f"or scaled away?)")
      target = f"{kind}-{index}"
      if not self._budget_ok(target):
        # Checked before the kill: a kick with no respawn budget would
        # turn a remediation into an outage.
        raise FleetError(
            f"no restart budget left for {target}; refusing to kick")
      t_detected = time.monotonic()
      log.warning("control plane kicking %s (slow-host remediation)",
                  target)
      process.terminate()
      process.join(timeout=5.0)
      if process.is_alive():
        process.kill()
        process.join(timeout=5.0)
      if kind == "actor":
        self._handle_actor_failure(index, faults_lib.ACTOR_HANG,
                                   t_detected=t_detected, kicked=True)
      elif kind == "pod":
        self._handle_pod_failure(index, faults_lib.ACTOR_HANG,
                                 t_detected=t_detected, kicked=True)
      else:
        self._handle_front_failure(
            index, faults_lib.SERVING_REPLICA_CRASH,
            t_detected=t_detected, kicked=True)

  def retune_admission(self, tenant: str,
                       rate_rps: Optional[float] = None,
                       factor: Optional[float] = None,
                       min_rate_rps: float = 1.0,
                       max_rate_rps: Optional[float] = None,
                       ) -> Dict[str, Any]:
    """Fans one admission retune to every front replica (each owns its
    own `AdmissionController`; a tenant's budget is per replica, as the
    router spreads a tenant). `factor` scales the current rate;
    otherwise `rate_rps` is absolute (None = unlimited). Returns the
    per-front replies; a failed front reports its error instead of
    aborting the fan-out."""
    payload: Dict[str, Any] = {"tenant": str(tenant),
                               "min_rate_rps": float(min_rate_rps)}
    if factor is not None:
      payload["factor"] = float(factor)
    else:
      payload["rate_rps"] = rate_rps
    if max_rate_rps is not None:
      payload["max_rate_rps"] = float(max_rate_rps)
    replies: Dict[str, Any] = {}
    for entry in [e for e in self._aux_hosts if e["kind"] == "front"]:
      try:
        replies[entry["name"]] = self._aux_call(
            entry, "admission_retune", payload, timeout_secs=15.0)
      except Exception as e:  # noqa: BLE001 — partial fan-out reported
        log.warning("admission retune on %s failed", entry["name"],
                    exc_info=True)
        replies[entry["name"]] = {"error": repr(e)}
    if self._tracer is not None:
      self._tracer.event("fleet.admission_retuned", tenant=tenant,
                         fronts=len(replies))
    return replies

  def _shed_retune(self, tenant: str,
                   rate_rps: Optional[float] = None) -> None:
    """The degradation ladder's retune: clamp (or restore, rate None =
    unlimited) one tenant on every front."""
    self.retune_admission(tenant, rate_rps=rate_rps)

  def admission_slo_reports(self) -> Dict[str, Any]:
    """Per-front SLO scorecards (`AdmissionController.slo_report`),
    keyed by front name."""
    reports: Dict[str, Any] = {}
    for entry in [e for e in self._aux_hosts if e["kind"] == "front"]:
      try:
        reports[entry["name"]] = self._aux_call(
            entry, "slo_report", timeout_secs=15.0)
      except Exception:  # noqa: BLE001 — instrumentation only
        log.warning("slo report from %s failed", entry["name"],
                    exc_info=True)
    return reports

  def wait(self) -> None:
    """Blocks until the learner exits cleanly; on any latched failure
    the fleet is aborted (all children stopped) and the error raised."""
    deadline = self._t_launched + self.config.run_timeout_secs
    try:
      while True:
        if self._supervise_once():
          # Final aggregated view of the run, cadence bypassed.
          self._poll_telemetry(force=True)
          return
        self._poll_telemetry()
        if time.monotonic() > deadline:
          raise FleetError(
              f"fleet exceeded run_timeout_secs="
              f"{self.config.run_timeout_secs:.0f}")
        time.sleep(0.05)
    except BaseException as e:
      self._latch(e)
      self._flight_record(e)
      self._abort()
      raise self._error from None

  # ---- shutdown ----

  def _join_or_kill(self, process: mp.Process, timeout_secs: float,
                    what: str) -> None:
    process.join(timeout=timeout_secs)
    if process.is_alive():
      log.warning("%s did not exit within %.0fs; terminating",
                  what, timeout_secs)
      process.terminate()
      process.join(timeout=5.0)
    if process.is_alive():
      process.kill()
      process.join(timeout=5.0)

  def _all_processes(self) -> List[mp.Process]:
    procs = list(self._actors.values())
    procs.extend(self._pods.values())
    procs.extend(process for _, process in self._draining)
    if self._learner is not None:
      procs.append(self._learner)
    procs.extend(self._learner_peers.values())
    if self._host is not None:
      procs.append(self._host)
    procs.extend(self._serving.values())
    procs.extend(self._shards.values())
    procs.extend(self._fronts.values())
    return [p for p in procs if p is not None]

  def shutdown(self, timeout_secs: float = 60.0,
               collect_metrics: bool = True) -> Optional[Dict[str, Any]]:
    """The shutdown barrier: actors → final metrics → hosts → joined.

    Returns the host's final metrics (None when `collect_metrics` is off
    or the host is already gone). Raises `FleetError` if any child
    survives the barrier: the zero-leak contract is checked, not
    assumed.
    """
    with self._scale_lock:
      # `_closed` flips and every stop event is set under the same lock
      # `scale_to` holds while it checks `_closed` and spawns.
      if self._closed:
        return None
      self._closed = True
      # A child still waiting for an address reads EOF and returns.
      for send in list(self._root_pipes.values()) + list(
          self._book_pipes.values()):
        send.close()
      self._root_pipes.clear()
      self._book_pipes.clear()
      for stop in self._actor_stops.values():
        stop.set()
      for stop in self._pod_stops.values():
        stop.set()
      actors = list(self._actors.items())
      pods = list(self._pods.items())
      draining = list(self._draining)
    for index, process in actors + draining:
      self._join_or_kill(process, timeout_secs / 2,
                         f"actor {index}")
    # Pods drain before the final metrics read, as actors do: their last
    # segment commit and telemetry push must land on the hosts the reads
    # below aggregate.
    for index, process in pods:
      self._join_or_kill(process, timeout_secs / 2, f"pod {index}")
    metrics = None
    if (collect_metrics and self._host is not None
        and self._host.is_alive()):
      # The control client may have been dropped by a failed telemetry
      # poll; a telemetry hiccup must not cost a clean run its final
      # metrics: reconnect for the read.
      if self._control is None:
        self._control = self._fresh_control()
      if self._control is not None:
        try:
          metrics = self._control.call("metrics", timeout_secs=30.0)
        except Exception:
          log.warning("final metrics read failed", exc_info=True)
        else:
          # The actor/learner registry snapshots (retry and recovery
          # counters live in those processes); actors push a final
          # snapshot as they drain, so this read sees them all.
          try:
            view = self._control.call("telemetry", timeout_secs=15.0)
            metrics["pushed_telemetry"] = view.get("pushed")
            metrics["host_telemetry"] = view.get("host")
          except Exception:
            # Poisoned-on-timeout contract: the `shutdown` call below
            # must not read this call's late reply.
            log.warning("final telemetry read failed", exc_info=True)
            self._control.close()
            self._control = self._fresh_control()
    if metrics is not None and self._aux_hosts:
      # Cross-host final view: every extra host reports before the stop
      # event lands, and the per-host reads merge into one
      # `_result_from_metrics`-shaped dict.
      replica_metrics: List[Dict[str, Any]] = []
      shard_metrics: List[Dict[str, Any]] = []
      front_metrics: List[Dict[str, Any]] = []
      for entry in self._aux_hosts:
        try:
          aux = self._aux_call(entry, "metrics", timeout_secs=30.0)
        except Exception:  # noqa: BLE001
          log.warning("final metrics read from %s failed",
                      entry["name"], exc_info=True)
          continue
        if entry["kind"] == "serving":
          replica_metrics.append(aux)
        elif entry["kind"] == "front":
          front_metrics.append(aux)
        else:
          shard_metrics.append(aux)
      metrics = _merge_fleet_metrics(
          metrics, replica_metrics, shard_metrics)
      if front_metrics:
        # Fronts report beside the training-plane merge (a serving-only
        # tier).
        metrics["front_hosts"] = front_metrics
      if self.front_failures:
        metrics["front_failures"] = list(self.front_failures)
    self._host_stop.set()
    if self._control is not None:
      if self._host is not None and self._host.is_alive():
        try:
          self._control.call("shutdown", timeout_secs=10.0)
        except Exception:
          log.warning("host shutdown rpc failed (will join/terminate)",
                      exc_info=True)
      self._control.close()
      self._control = None
    if self._learner is not None:
      self._join_or_kill(self._learner, timeout_secs / 2, "learner")
    for rank, process in self._learner_peers.items():
      self._join_or_kill(process, timeout_secs / 2, f"learner rank {rank}")
    if self._host is not None:
      self._join_or_kill(self._host, timeout_secs / 2, "host")
    for index, process in self._serving.items():
      self._join_or_kill(process, timeout_secs / 2,
                         f"serving host {index}")
    for index, process in self._shards.items():
      self._join_or_kill(process, timeout_secs / 2,
                         f"replay shard {index}")
    for index, process in self._fronts.items():
      self._join_or_kill(process, timeout_secs / 2,
                         f"front host {index}")
    for entry in self._aux_hosts:
      if entry["client"] is not None:
        entry["client"].close()
        entry["client"] = None
    if metrics is not None and self._controller is not None:
      metrics["control"] = self._controller.stats()
    if self._telemetry_file is not None:
      self._telemetry_file.close()
      self._telemetry_file = None
    if self._controller is not None:
      self._controller.close()
    if self._sentinel is not None:
      self._sentinel.close()
    if self._tracer is not None:
      self._tracer.close()
    leaked = [p.name for p in self._all_processes() if p.is_alive()]
    if leaked:
      raise FleetError(f"shutdown leaked processes: {leaked}")
    return metrics

  def _abort(self) -> None:
    """Failure-path teardown: no metrics, everything force-stopped."""
    try:
      self.shutdown(timeout_secs=20.0, collect_metrics=False)
    except FleetError:
      log.exception("abort teardown incomplete")

  # ---- the whole run ----

  def run(self) -> FleetResult:
    """launch → wait → metrics → shutdown, as one supervised unit."""
    t0 = time.monotonic()
    self.launch()
    self.wait()
    metrics = self.shutdown()
    if metrics is None:
      raise FleetError("fleet completed but final metrics were lost")
    return self.result(metrics, time.monotonic() - t0)

  def result(self, metrics: Dict[str, Any],
             wall_secs: float) -> FleetResult:
    """The `FleetResult` of a run from its final metrics (`shutdown`'s
    return) and its wall seconds, with this fleet's recovery and
    membership accounting."""
    result = _result_from_metrics(
        metrics, wall_secs,
        sum(self._restarts.values()) + sum(self._pod_restarts.values()))
    result.recoveries = list(self.recoveries)
    result.learner_restarts = self._learner_restarts
    result.scale_events = list(self.scale_events)
    return result


def _merge_lag_snapshots(
    snaps: Sequence[Optional[Dict[str, Any]]]) -> Optional[Dict[str, Any]]:
  """Row-weighted merge of `LagStats.snapshot()` dicts across hosts."""
  snaps = [s for s in snaps if s]
  if not snaps:
    return None
  rows = sum(int(s.get("rows", 0)) for s in snaps)
  histogram: Dict[str, int] = {}
  for s in snaps:
    for label, count in (s.get("histogram") or {}).items():
      histogram[label] = histogram.get(label, 0) + int(count)
  by_hop: Dict[str, List[float]] = {}
  for s in snaps:
    for hop, h in (s.get("by_hop") or {}).items():
      acc = by_hop.setdefault(str(hop), [0, 0.0, 0])
      n = int(h.get("rows", 0))
      acc[0] += n
      acc[1] += float(h.get("mean", 0.0)) * n
      acc[2] = max(acc[2], int(h.get("max", 0)))
  out: Dict[str, Any] = {
      "rows": rows,
      "mean": (sum(float(s.get("mean", 0.0)) * int(s.get("rows", 0))
                   for s in snaps) / rows) if rows else 0.0,
      "max": max(int(s.get("max", 0)) for s in snaps),
      "histogram": histogram,
  }
  if by_hop:
    out["by_hop"] = {
        hop: {"rows": n, "mean": (total / n) if n else 0.0, "max": m}
        for hop, (n, total, m) in sorted(
            by_hop.items(), key=lambda kv: int(kv[0]))}
  return out


def _merge_fleet_metrics(
    root: Dict[str, Any],
    replicas: Sequence[Dict[str, Any]],
    shards: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
  """One `_result_from_metrics`-shaped dict for a multi-host fleet.

  Shard replay planes merge into the top-level replay keys: service
  counters summed, the commit window spanning the earliest first to the
  latest last (time.monotonic is one system-wide clock, so stamps
  compare across processes on one machine), lag histograms merged
  row-weighted, staleness namespaced per shard. Control-plane keys
  (learner_window, publishes, params_version) stay the root's: the root
  is the learner's control host and the broadcast origin. The raw
  per-host dicts ride along for forensics.
  """
  merged = dict(root)
  if shards:
    store_sum: Dict[str, float] = {}
    service_sum: Dict[str, float] = {}
    staleness: Dict[str, Any] = {}
    windows = []
    for i, shard in enumerate(shards):
      index = shard.get("shard_index", i)
      for key, value in (shard.get("store") or {}).items():
        if key == "learner_step":
          store_sum[key] = max(store_sum.get(key, 0.0), float(value))
        elif key != "fill":
          store_sum[key] = store_sum.get(key, 0.0) + float(value)
      for key, value in (shard.get("service") or {}).items():
        service_sum[key] = service_sum.get(key, 0.0) + float(value)
      for batch_size, snap in (shard.get("staleness") or {}).items():
        staleness[f"shard{index}:{batch_size}"] = snap
      if shard.get("commit_window"):
        windows.append(shard["commit_window"])
    if store_sum.get("capacity"):
      store_sum["fill"] = store_sum.get("size", 0.0) / store_sum[
          "capacity"]
    merged["store"] = store_sum or None
    merged["service"] = service_sum or None
    merged["staleness"] = staleness
    merged["param_refresh_lag"] = _merge_lag_snapshots(
        [shard.get("param_refresh_lag") for shard in shards])
    merged["commit_window"] = (None if not windows else {
        "first_time": min(float(w["first_time"]) for w in windows),
        "last_time": max(float(w["last_time"]) for w in windows),
    })
    merged["replay_shards"] = list(shards)
  if replicas:
    merged["serving_replicas"] = list(replicas)
  return merged


def _result_from_metrics(metrics: Dict[str, Any], wall_secs: float,
                         actor_restarts: int) -> FleetResult:
  service = metrics.get("service") or {}
  committed = float(service.get("replay_committed_transitions", 0.0))
  commit_window = metrics.get("commit_window") or {}
  commit_span = max(
      float(commit_window.get("last_time", 0.0))
      - float(commit_window.get("first_time", 0.0)), 1e-9)
  learner_window = metrics.get("learner_window") or {}
  step_span = (float(learner_window.get("last_step", 0))
               - float(learner_window.get("first_step", 0)))
  time_span = max(float(learner_window.get("last_time", 0.0))
                  - float(learner_window.get("first_time", 0.0)), 1e-9)
  return FleetResult(
      env_steps_per_sec=committed / commit_span,
      learner_steps_per_sec=step_span / time_span,
      param_refresh_lag=metrics.get("param_refresh_lag") or {},
      replay_staleness=metrics.get("staleness") or {},
      publishes=int(metrics.get("publishes", 0)),
      params_version=int(metrics.get("params_version", 0)),
      actor_restarts=actor_restarts,
      wall_secs=wall_secs,
      clean_shutdown=True,
      metrics=metrics,
  )


def _jsonable(value: Any) -> Any:
  """`json.dump`'s fallback for numpy scalars and arrays."""
  if hasattr(value, "tolist"):
    return value.tolist()
  return str(value)


def write_result(result: FleetResult, model_dir: str) -> str:
  """Writes `result` as `<model_dir>/fleet_result.json`; returns the
  path (the binary's run leaves its measurements beside its
  checkpoints)."""
  path = os.path.join(model_dir, RESULT_FILENAME)
  with open(path, "w") as f:
    json.dump(dataclasses.asdict(result), f, default=_jsonable)
  return path


def learner_step(payload: Dict[str, float]) -> int:
  """The learner step of an aggregated poll: the root store's
  `replay.learner_step`, or, where replay hosts own every shard (the
  root then holds no store), the largest `<shard>/replay.learner_step`.
  JAX's orchestrator reads the root's key alone, so its records and
  control decisions in such a fleet carry step 0."""
  if "replay.learner_step" in payload:
    return int(payload["replay.learner_step"])
  steps = [value for key, value in payload.items()
           if key.endswith("/replay.learner_step")]
  return int(max(steps, default=0))


@gin.configurable
def run_fleet(model_dir: str = gin.REQUIRED,
              config: Optional[FleetConfig] = None,
              gin_configs: Sequence[str] = ()) -> FleetResult:
  """Gin entry point (`run_t2r_trainer --trainer=fleet`): runs one
  fleet to completion, writes its `FleetResult` to
  `<model_dir>/fleet_result.json` and returns it."""
  config = config or FleetConfig()
  # Construction refuses what the port does not run before anything is
  # made or spawned.
  fleet = Fleet(config, model_dir, gin_configs=gin_configs)
  os.makedirs(model_dir, exist_ok=True)
  result = fleet.run()
  write_result(result, model_dir)
  log.info(
      "fleet complete: %.1f env steps/s, %.1f learner steps/s, "
      "param_refresh_lag mean %.1f steps, %d publishes, %d restarts",
      result.env_steps_per_sec, result.learner_steps_per_sec,
      result.param_refresh_lag.get("mean", 0.0), result.publishes,
      result.actor_restarts)
  return result
