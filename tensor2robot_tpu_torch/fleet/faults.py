"""Deterministic fault injection for the fleet (port of
`fleet/faults.py`): the chaos plan.

The recovery paths (actor respawn, learner resume, RPC retry) are
product code that must be exercised as deterministically as the happy
path:

  * `FaultEvent` / `FaultPlan`: a picklable, seeded schedule of faults.
    Triggers are count-based (actor batch index, learner step, Nth RPC
    call of a method), never wall-clock, so the same seed replays the
    same schedule on any host and in either package;
    `FaultPlan.digest()` is the SHA-256 of the canonical event list.
  * `FaultInjector`: the per-process runtime. Each fleet child builds
    one from the plan shipped in `FleetConfig.fault_plan` (filtered to
    its own role) and injects through seams in the real code paths:
    `rpc.py` consults `rpc_action()` on every client call and server
    handler turn (delay / drop / disconnect), `actor_main` consults
    `on_batch()` between collect batches (crash / hang via `proc.hang`),
    the learner's fault hook consults `on_step()`. An injected
    `rpc_drop` times out through the client's real deadline and
    recovers through its real reconnect-and-retry.

Every injection emits a telemetry event (`fleet.fault_injected`), bumps
`fleet.faults.injected.<class>`, and for process-killing faults dumps a
flight record first, so post-mortems of injected chaos look like
post-mortems of real chaos.

Non-recurring events (the default) fire only in a process's first
incarnation: a respawned actor replays a fault-free schedule, so
recovery converges instead of crash-looping. `recurring=True` events
fire in every incarnation: the crash-loop fixture the rate-based restart
budget is tested against. `serving_replica_crash` plans generate as in
JAX; their seam (the front replicas) is ROADMAP A13 rest.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import random
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.telemetry import flightrec
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

log = logging.getLogger(__name__)

# The fault taxonomy.
ACTOR_CRASH = "actor_crash"          # process dies between batches
ACTOR_HANG = "actor_hang"            # process stops beating, stays up
LEARNER_CRASH = "learner_crash"      # train loop raises mid-run
RPC_DELAY = "rpc_delay"              # client-side added latency
RPC_DROP = "rpc_drop"                # request lost: deadline + retry
RPC_DISCONNECT = "rpc_disconnect"    # server drops the connection
SLOW_HOST = "slow_host"              # server-side handler stall
SERVING_REPLICA_CRASH = "serving_replica_crash"  # front replica dies

FAULT_CLASSES = (ACTOR_CRASH, ACTOR_HANG, LEARNER_CRASH, RPC_DELAY,
                 RPC_DROP, RPC_DISCONNECT, SLOW_HOST)

# The full taxonomy. `FAULT_CLASSES` is the 7-class default set, as in
# JAX, so `FaultPlan.generate` draws the same seeded plans;
# serving_replica_crash (a replicated-front host hard-exits) is opt-in:
# it only generates when a caller asks for it and declares
# `num_fronts`.
ALL_FAULT_CLASSES = FAULT_CLASSES + (SERVING_REPLICA_CRASH,)

# Which process injects each class: client-side faults run in the
# caller (actor/learner), server-side faults run in the host's RPC
# handler threads.
_CLIENT_RPC = (RPC_DELAY, RPC_DROP)
_SERVER_RPC = (RPC_DISCONNECT, SLOW_HOST)

# Recovery-time histogram bounds (ms): recoveries span RPC retries
# (tens of ms) to learner respawn + checkpoint restore (tens of
# seconds). One source of truth for every process that observes
# `fleet.recovery_ms`.
RECOVERY_MS_BOUNDS = (10.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
                      2500.0, 5000.0, 10000.0, 30000.0, 60000.0,
                      120000.0)


def recovery_histogram() -> tmetrics.Histogram:
  """The process's `fleet.recovery_ms` histogram (shared bounds)."""
  return tmetrics.histogram("fleet.recovery_ms", RECOVERY_MS_BOUNDS)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
  """One scheduled fault.

  `at` is a deterministic COUNT in the target's own unit: collect
  batches for actor crash/hang, learner steps for learner_crash, and
  matching RPC calls for the rpc_*/slow_host classes. `count` extends
  rpc delay faults over that many consecutive calls (a slow host is
  slow for a while, not for one call). `method` filters rpc faults to
  one RPC method ("" = any).
  """

  fault: str
  target: str                 # "actor-<i>", "learner", or "host"
  at: int
  mode: str = "hard"          # actor_crash: raise | hard | mid_episode
  duration_secs: float = 0.0  # hang / delay / stall length
  method: str = ""
  count: int = 1
  recurring: bool = False

  def to_json(self) -> Dict[str, Any]:
    return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
  """A deterministic, seeded schedule of `FaultEvent`s (picklable —
  it ships to every child inside `FleetConfig`)."""

  seed: int
  events: Tuple[FaultEvent, ...]

  def digest(self) -> str:
    """SHA-256 over the canonical event list: the replay pin."""
    canonical = json.dumps(
        [event.to_json() for event in self.events], sort_keys=True)
    return hashlib.sha256(canonical.encode()).hexdigest()

  def for_target(self, target: str) -> Tuple[FaultEvent, ...]:
    return tuple(e for e in self.events if e.target == target)

  def classes(self) -> Tuple[str, ...]:
    return tuple(sorted({e.fault for e in self.events}))

  @classmethod
  def generate(cls,
               seed: int,
               num_actors: int,
               classes: Sequence[str] = FAULT_CLASSES,
               actor_batch_range: Tuple[int, int] = (2, 6),
               learner_step_range: Tuple[int, int] = (6, 20),
               rpc_call_range: Tuple[int, int] = (4, 16),
               hang_secs: float = 20.0,
               delay_secs: float = 0.2,
               stall_secs: float = 0.3,
               num_fronts: int = 0) -> "FaultPlan":
    """One event per requested class, targets/triggers drawn from a
    `random.Random(seed)` stream — same seed, same plan, any host.

    Ranges are in the class's own trigger unit; durations are the
    knobs a caller sizes against its heartbeat timeout (a hang must
    outlive it) and RPC deadline (a delay must not).
    """
    rng = random.Random(seed)
    events: List[FaultEvent] = []
    for fault in classes:
      if fault not in ALL_FAULT_CLASSES:
        raise ValueError(
            f"unknown fault class {fault!r}; one of "
            f"{ALL_FAULT_CLASSES}")
      if fault == SERVING_REPLICA_CRASH:
        if num_fronts < 1:
          raise ValueError(
              "serving_replica_crash needs num_fronts >= 1")
        events.append(FaultEvent(
            fault=fault, target=f"front-{rng.randrange(num_fronts)}",
            at=rng.randint(*rpc_call_range), mode="hard"))
      elif fault in (ACTOR_CRASH, ACTOR_HANG):
        target = f"actor-{rng.randrange(num_actors)}"
        at = rng.randint(*actor_batch_range)
        mode = (rng.choice(("raise", "hard", "mid_episode"))
                if fault == ACTOR_CRASH else "hard")
        events.append(FaultEvent(
            fault=fault, target=target, at=at, mode=mode,
            duration_secs=hang_secs if fault == ACTOR_HANG else 0.0))
      elif fault == LEARNER_CRASH:
        events.append(FaultEvent(
            fault=fault, target="learner",
            at=rng.randint(*learner_step_range), mode="raise"))
      elif fault in _CLIENT_RPC:
        target = rng.choice(
            [f"actor-{i}" for i in range(num_actors)] + ["learner"])
        events.append(FaultEvent(
            fault=fault, target=target,
            at=rng.randint(*rpc_call_range),
            duration_secs=delay_secs if fault == RPC_DELAY else 0.0,
            count=3 if fault == RPC_DELAY else 1))
      else:  # server-side: the host injects
        events.append(FaultEvent(
            fault=fault, target="host",
            at=rng.randint(*rpc_call_range),
            duration_secs=stall_secs if fault == SLOW_HOST else 0.0,
            count=6 if fault == SLOW_HOST else 1))
    return cls(seed=seed, events=tuple(events))


class _Armed:
  """Mutable per-event trigger state (the plan itself stays frozen)."""

  __slots__ = ("event", "remaining")

  def __init__(self, event: FaultEvent):
    self.event = event
    self.remaining = int(event.count)


class FaultInjector:
  """The per-process fault runtime; one per fleet child.

  Thread-safe: the host consults `rpc_action` from every handler
  thread. A disabled injector (no plan, or a non-recurring event in a
  respawned incarnation) costs one `None` check per seam.
  """

  def __init__(self,
               plan: Optional[FaultPlan],
               role: str,
               incarnation: int = 0,
               flightrec_dir: str = ""):
    self._role = role
    self._flightrec_dir = flightrec_dir
    self._lock = threading.Lock()
    self._rpc_calls: Dict[Tuple[str, str], int] = {}
    self._armed: List[_Armed] = []
    if plan is not None:
      for event in plan.for_target(role):
        if incarnation == 0 or event.recurring:
          self._armed.append(_Armed(event))
    self.injected: List[Dict[str, Any]] = []

  @property
  def active(self) -> bool:
    return bool(self._armed)

  def _record_injection(self, event: FaultEvent,
                        flight_record: bool = False) -> None:
    """Every injection is observable: a telemetry event, a per-class
    counter, and — for process-killing faults — a flight record dumped
    BEFORE the process dies (a hard `os._exit` has no except path)."""
    entry = {"fault": event.fault, "target": event.target,
             "at": event.at, "mode": event.mode}
    self.injected.append(entry)
    telemetry.event("fleet.fault_injected", **entry)
    tmetrics.counter(f"fleet.faults.injected.{event.fault}").inc()
    log.warning("fault injected: %s", entry)
    if flight_record and self._flightrec_dir:
      flightrec.dump(self._flightrec_dir,
                     f"injected {event.fault} ({self._role})",
                     extra={"fault_event": event.to_json()})

  # ---- the seams ----

  def on_batch(self, batch_index: int) -> Optional[FaultEvent]:
    """Actor seam: called between collect batches. Returns the due
    crash/hang event (recorded + flight-dumped) or None."""
    with self._lock:
      for armed in self._armed:
        event = armed.event
        if (event.fault in (ACTOR_CRASH, ACTOR_HANG)
            and armed.remaining > 0 and batch_index >= event.at):
          armed.remaining = 0
          break
      else:
        return None
    self._record_injection(event, flight_record=True)
    return event

  def on_step(self, step: int) -> Optional[FaultEvent]:
    """Learner seam: called after each train step."""
    with self._lock:
      for armed in self._armed:
        event = armed.event
        if (event.fault == LEARNER_CRASH and armed.remaining > 0
            and step >= event.at):
          armed.remaining = 0
          break
      else:
        return None
    self._record_injection(event, flight_record=True)
    return event

  def rpc_action(self, side: str,
                 method: str) -> Optional[Tuple[str, float]]:
    """RPC seam (rpc.py consults this on every call/handle).

    Returns None (the overwhelmingly common case) or an action tuple:
    client side — ("delay", secs) sleep before send, ("drop", 0) skip
    the send so the REAL deadline fires; server side — ("delay", secs)
    stall the handler, ("disconnect", 0) close the connection (which
    runs the real disconnect/session-abort path).
    """
    wanted = _CLIENT_RPC if side == "client" else _SERVER_RPC
    with self._lock:
      key = (side, method)
      calls = self._rpc_calls[key] = self._rpc_calls.get(key, 0) + 1
      for armed in self._armed:
        event = armed.event
        if (event.fault in wanted and armed.remaining > 0
            and (not event.method or event.method == method)
            and calls >= event.at):
          armed.remaining -= 1
          break
      else:
        return None
    self._record_injection(event)
    if event.fault == RPC_DELAY or event.fault == SLOW_HOST:
      return ("delay", event.duration_secs)
    if event.fault == RPC_DROP:
      return ("drop", 0.0)
    return ("disconnect", 0.0)


def install(config, role: str, incarnation: int = 0) -> FaultInjector:
  """Builds this process's injector from `FleetConfig.fault_plan` and
  installs it into the RPC seam. Always returns an injector (inactive
  when no plan targets this role) so call sites stay branch-free."""
  from tensor2robot_tpu_torch.fleet import rpc as rpc_lib

  injector = FaultInjector(
      getattr(config, "fault_plan", None), role,
      incarnation=incarnation,
      flightrec_dir=getattr(config, "flightrec_dir", "") or "")
  if injector.active:
    rpc_lib.set_fault_injector(injector)
  return injector
