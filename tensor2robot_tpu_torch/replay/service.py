"""Multi-producer ingestion front (port of `replay/service.py`): actors
→ bounded queue → store.

  * BACKPRESSURE — producers go through a bounded queue. Policy
    ``"block"`` waits for the writer to drain (collection slows to match
    ingestion, optionally capped by `block_timeout_secs`, after which the
    batch is dropped and counted); ``"drop"`` never blocks a producer: an
    overflowing batch is counted and discarded. The learner is on
    neither path: sampling reads the store directly.
  * ACTOR CRASH — producers write through per-actor SESSIONS that stage
    an episode locally and commit it atomically at `end_episode`. A
    crash mid-episode abandons the staged rows; the store never sees a
    partial episode.
  * RESTART — re-opening a session under the same `actor_id` aborts
    whatever the dead incarnation staged (counted in `aborted_episodes`
    and `restarts`) and resumes ingestion cleanly.

One writer thread drains the queue into `ReplayStore.add` (whole
batches, one shard lock apiece). A writer error is latched and raised
again on `flush()` and `close()` (and on the next enqueue) rather than
silently halting intake.

`LagStats` accumulates the param-refresh lag (learner step now minus the
step of the params an actor acted with) per committed row; `ReplayFront`
is the plane's RPC-facing surface over one store. The counters are
plain fields with twins in the process's telemetry registry
(`replay.dropped_transitions`, `replay.aborted_episodes`,
`replay.ingest_queue_depth`, `fleet.param_refresh_lag_steps` and its
`.hop<k>` family), updated at the JAX module's sites; its
`jax.monitoring` events have no counterpart here.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.replay.sampler import ReplayBatchSampler
from tensor2robot_tpu_torch.replay.store import ReplayStore, to_flat_arrays
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

log = logging.getLogger(__name__)

# Lag histogram bucket upper bounds, in learner steps: the registry's
# step-bucket family, so the snapshot and its registry twin agree.
LAG_BUCKETS = tuple(int(b) for b in tmetrics.DEFAULT_STEP_BOUNDS)

OVERFLOW_POLICIES = ("drop", "block")


class _Enqueued:
  __slots__ = ("flat", "n", "priority")

  def __init__(self, flat: Dict[str, np.ndarray], n: int,
               priority: Optional[float]):
    self.flat = flat
    self.n = n
    self.priority = priority


class ActorIngestSession:
  """One actor's write handle: episodes stage locally, commit atomically.

  Not thread-safe across actors by design — each actor owns its session
  (the service hands out one per `actor_id`). `add` is the
  single-commit convenience for bandit-style envs whose "episode" is
  one batched step.
  """

  def __init__(self, service: "ReplayWriteService", actor_id: str):
    self._service = service
    self.actor_id = actor_id
    self._staged: List[Dict[str, np.ndarray]] = []
    self._in_episode = False
    self.closed = False
    self.episodes_committed = 0
    self.transitions_committed = 0

  def begin_episode(self) -> None:
    if self._in_episode:
      # A begin without an end is the crash shape: discard the partial.
      self.abort()
    self._in_episode = True
    self._staged = []

  def append(self, transitions: Any) -> None:
    """Stages a [N, ...] chunk of the current episode (local only)."""
    if self.closed:
      raise RuntimeError(
          f"session {self.actor_id!r} is closed (actor restarted?)")
    if not self._in_episode:
      self.begin_episode()
    self._staged.append(to_flat_arrays(transitions))

  def end_episode(self, priority: Optional[float] = None) -> bool:
    """Commits the staged episode through the bounded queue.

    Returns False when the drop policy discarded it (queue full).
    """
    if not self._in_episode:
      return False
    staged, self._staged = self._staged, []
    self._in_episode = False
    if not staged:
      return False
    if len(staged) == 1:
      flat = staged[0]
    else:
      flat = {k: np.concatenate([c[k] for c in staged], axis=0)
              for k in staged[0]}
    accepted = self._service._enqueue(flat, priority)
    if accepted:
      n = int(next(iter(flat.values())).shape[0])
      self.episodes_committed += 1
      self.transitions_committed += n
    return accepted

  def add(self, transitions: Any,
          priority: Optional[float] = None) -> bool:
    """begin → append → end in one call (single-step episode batches)."""
    self.begin_episode()
    self.append(transitions)
    return self.end_episode(priority)

  def abort(self) -> None:
    """Discards any staged partial episode (crash / restart path)."""
    if self._in_episode or self._staged:
      self._service._count_abort(self.actor_id)
    self._staged = []
    self._in_episode = False


@gin.configurable
class ReplayWriteService:
  """Bounded-queue ingestion front over a `ReplayStore`."""

  def __init__(self,
               store: ReplayStore,
               queue_batches: int = 16,
               overflow: str = "drop",
               block_timeout_secs: Optional[float] = None):
    """Args:
      store: the sharded store batches drain into.
      queue_batches: bounded queue depth, in batches.
      overflow: "drop" (count + discard, producer never blocks) or
        "block" (backpressure: producer waits for queue space).
      block_timeout_secs: with "block", an optional cap on the wait —
        on expiry the batch is dropped and counted (an actor must not
        hang forever on a wedged writer).
    """
    if overflow not in OVERFLOW_POLICIES:
      raise ValueError(
          f"overflow must be one of {OVERFLOW_POLICIES}, got {overflow!r}")
    self._store = store
    self._overflow = overflow
    self._block_timeout = block_timeout_secs
    self._queue: "queue.Queue[_Enqueued]" = queue.Queue(
        maxsize=queue_batches)
    self._sessions: Dict[str, ActorIngestSession] = {}
    self._lock = threading.Lock()
    self._stop = threading.Event()
    self._error: Optional[BaseException] = None
    self.enqueued_batches = 0
    self.committed_batches = 0
    self.committed_transitions = 0
    self.dropped_batches = 0
    self.dropped_transitions = 0
    self.aborted_episodes = 0
    self.restarts = 0
    self._tm_drops = tmetrics.counter("replay.dropped_transitions")
    self._tm_aborts = tmetrics.counter("replay.aborted_episodes")
    self._tm_queue_depth = tmetrics.gauge("replay.ingest_queue_depth")
    self._writer = threading.Thread(
        target=self._drain, name="replay-writer", daemon=True)
    self._writer.start()

  @property
  def store(self) -> ReplayStore:
    return self._store

  @property
  def queue_depth(self) -> int:
    return self._queue.qsize()

  # ---- producer side ----

  def session(self, actor_id: str) -> ActorIngestSession:
    """The actor's write handle; reopening an id = crash-restart."""
    with self._lock:
      prior = self._sessions.pop(actor_id, None)
    if prior is not None:
      # Outside the lock: abort() re-enters the service for its
      # counter (the metrics mutex is not reentrant by design).
      prior.abort()
      prior.closed = True
      with self._lock:
        self.restarts += 1
      log.info("replay session %r reopened (actor restart); partial "
               "state discarded", actor_id)
    fresh = ActorIngestSession(self, actor_id)
    with self._lock:
      self._sessions[actor_id] = fresh
    return fresh

  def put(self, transitions: Any,
          priority: Optional[float] = None) -> bool:
    """Sessionless enqueue of one whole batch (dataset readers)."""
    return self._enqueue(to_flat_arrays(transitions), priority)

  def _enqueue(self, flat: Dict[str, np.ndarray],
               priority: Optional[float]) -> bool:
    if self._error is not None:
      raise RuntimeError("replay writer thread died") from self._error
    n = int(next(iter(flat.values())).shape[0])
    item = _Enqueued(flat, n, priority)
    try:
      if self._overflow == "block":
        self._put_blocking(item)
      else:
        self._queue.put_nowait(item)
    except queue.Full:
      with self._lock:
        self.dropped_batches += 1
        self.dropped_transitions += n
      self._tm_drops.inc(n)
      return False
    with self._lock:
      self.enqueued_batches += 1
    self._tm_queue_depth.set(self._queue.qsize())
    return True

  def _put_blocking(self, item: _Enqueued) -> None:
    """Backpressure put that still notices a dead writer.

    A bare ``put(timeout=None)`` would strand the producer FOREVER if
    the writer thread died while the queue was full — the error latch
    is only checked on `_enqueue` entry, and a dead writer never
    drains. Wait in short slices,
    re-checking the latch each slice; `block_timeout_secs` still caps
    the total wait (queue.Full on expiry → counted drop, unchanged).
    """
    deadline = (time.monotonic() + self._block_timeout
                if self._block_timeout is not None else None)
    while True:
      if self._error is not None:
        raise RuntimeError("replay writer thread died") from self._error
      slice_secs = 0.05
      if deadline is not None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
          raise queue.Full
        slice_secs = min(slice_secs, remaining)
      try:
        self._queue.put(item, timeout=slice_secs)
        return
      except queue.Full:
        continue

  def _count_abort(self, actor_id: str) -> None:
    with self._lock:
      self.aborted_episodes += 1
    self._tm_aborts.inc()

  # ---- writer thread ----

  def _drain(self) -> None:
    while True:
      try:
        item = self._queue.get(timeout=0.05)
      except queue.Empty:
        if self._stop.is_set():
          return
        continue
      try:
        self._store.add(item.flat, priority=item.priority)
        with self._lock:
          self.committed_batches += 1
          self.committed_transitions += item.n
      except BaseException as e:  # latched; surfaced on flush/close
        self._error = e
        log.exception("replay writer failed; ingestion halted")
        return

  # ---- lifecycle / metrics ----

  def flush(self, timeout_secs: float = 30.0) -> bool:
    """Blocks until everything enqueued so far has been committed."""
    deadline = time.monotonic() + timeout_secs
    while True:
      if self._error is not None:
        raise RuntimeError("replay writer thread died") from self._error
      with self._lock:
        drained = (self.committed_batches >= self.enqueued_batches
                   and self._queue.empty())
      if drained:
        return True
      if time.monotonic() > deadline:
        return False
      time.sleep(0.005)

  def close(self, timeout_secs: float = 10.0) -> None:
    self.flush(timeout_secs)
    self._stop.set()
    self._writer.join(timeout=timeout_secs)
    if self._error is not None:
      raise RuntimeError("replay writer thread died") from self._error

  def metrics_scalars(self, prefix: str = "replay_") -> Dict[str, float]:
    with self._lock:
      return {
          f"{prefix}queue_depth": float(self._queue.qsize()),
          f"{prefix}enqueued_batches": float(self.enqueued_batches),
          f"{prefix}committed_transitions": float(
              self.committed_transitions),
          f"{prefix}dropped_batches": float(self.dropped_batches),
          f"{prefix}dropped_transitions": float(self.dropped_transitions),
          f"{prefix}aborted_episodes": float(self.aborted_episodes),
          f"{prefix}actor_restarts": float(self.restarts),
      }


class LagStats:
  """Thread-safe accumulator for the param-refresh-lag distribution.

  Lives with the replay plane (not the serving host) because the lag
  is MEASURED at commit time, wherever the committed rows land. `hop`
  attributes the lag
  to the broadcast-tree depth of the serving host whose params the
  actor acted with: per-hop sub-histograms quantify what each extra
  tree hop costs in publication freshness.
  """

  def __init__(self):
    self._lock = threading.Lock()
    self._counts = np.zeros(len(LAG_BUCKETS) + 1, np.int64)
    self._sum = 0
    self._max = 0
    self._n = 0
    self._by_hop: Dict[int, List[int]] = {}  # hop -> [rows, sum, max]
    self._tm_lag = tmetrics.histogram(
        "fleet.param_refresh_lag_steps", tmetrics.DEFAULT_STEP_BOUNDS)

  def record(self, lag: int, rows: int,
             hop: Optional[int] = None) -> None:
    lag = max(int(lag), 0)
    bucket = int(np.searchsorted(LAG_BUCKETS, lag, side="left"))
    with self._lock:
      self._counts[bucket] += rows
      self._sum += lag * rows
      self._max = max(self._max, lag)
      self._n += rows
      if hop is not None:
        acc = self._by_hop.setdefault(int(hop), [0, 0, 0])
        acc[0] += rows
        acc[1] += lag * rows
        acc[2] = max(acc[2], lag)
    # Registry twins with the same row weighting; the per-hop twin rides
    # the same family under a `.hop<k>` suffix.
    self._tm_lag.observe(lag, n=rows)
    if hop is not None:
      tmetrics.histogram(f"fleet.param_refresh_lag_steps.hop{int(hop)}",
                         tmetrics.DEFAULT_STEP_BOUNDS).observe(lag, n=rows)

  def snapshot(self) -> Dict[str, Any]:
    with self._lock:
      labels = [f"<={b}" for b in LAG_BUCKETS] + [f">{LAG_BUCKETS[-1]}"]
      out: Dict[str, Any] = {
          "rows": int(self._n),
          "mean": (self._sum / self._n) if self._n else 0.0,
          "max": int(self._max),
          "histogram": {label: int(count)
                        for label, count in zip(labels, self._counts)},
      }
      if self._by_hop:
        out["by_hop"] = {
            str(hop): {"rows": int(n), "mean": (s / n) if n else 0.0,
                       "max": int(m)}
            for hop, (n, s, m) in sorted(self._by_hop.items())}
      return out


class ReplayFront:
  """The replay plane's RPC-facing surface over ONE store.

  The same session/commit/sample/lag semantics serve a serving host
  that owns one store, and each process of a sharded plane that owns
  one shard (actors commit to their rendezvous-hash home shard, the
  learner concatenates shard samples shard-major). Staleness and
  param-refresh lag are accounted where each store lives.

  The crash contract is inherited wholesale: sessions are tracked per
  RPC connection (`ctx`) by OBJECT identity and aborted on
  disconnect, so partial episodes never land no matter which process
  the store is in.
  """

  def __init__(self, store: ReplayStore, service: "ReplayWriteService"):
    self.store = store
    self.service = service
    self._samplers: Dict[int, ReplayBatchSampler] = {}
    self._sessions: Dict[str, ActorIngestSession] = {}
    self._lock = threading.Lock()
    self.lag = LagStats()
    self._commit_window: Optional[tuple] = None

  # ---- sessions (the host's restart-with-abort contract) ----

  def session_for(self, actor_id: str, ctx: dict) -> ActorIngestSession:
    with self._lock:
      session = self._sessions.get(actor_id)
    if session is None or session.closed:
      # A fresh claim under an existing actor_id is the restart path:
      # `service.session` counts it and aborts whatever the dead
      # incarnation staged (restart-with-session-abort).
      session = self.service.session(actor_id)
      with self._lock:
        self._sessions[actor_id] = session
    # Track the OBJECT this connection used, not just the id: a
    # hard-killed actor's connection can be detected dead AFTER its
    # replacement re-registered, and the late disconnect must abort
    # the old incarnation's session, never the new one's.
    ctx.setdefault("sessions", {})[actor_id] = session
    return session

  def abort_sessions(self, ctx: dict) -> None:
    """The disconnect path: aborts every session this ctx opened."""
    for actor_id, session in ctx.get("sessions", {}).items():
      if not session.closed:
        session.abort()
      with self._lock:
        if self._sessions.get(actor_id) is session:
          del self._sessions[actor_id]

  # ---- commits ----

  def _record_commit(self, rows: int, policy_learner_step,
                     hop: Optional[int]) -> None:
    now = time.monotonic()
    with self._lock:
      first = self._commit_window[0] if self._commit_window else now
      self._commit_window = (first, now)
    if policy_learner_step is not None:
      self.lag.record(
          self.store.learner_step - int(policy_learner_step), rows,
          hop=hop)

  def commit(self, payload: Dict[str, Any], ctx: dict) -> bool:
    session = self.session_for(payload["actor_id"], ctx)
    accepted = session.add(payload["transitions"])
    if accepted:
      rows = int(next(iter(payload["transitions"].values())).shape[0])
      self._record_commit(rows, payload.get("policy_learner_step"),
                          payload.get("policy_hop"))
    return bool(accepted)

  def begin_episode(self, actor_id: str, ctx: dict) -> bool:
    self.session_for(actor_id, ctx).begin_episode()
    return True

  def append(self, payload: Dict[str, Any], ctx: dict) -> bool:
    self.session_for(payload["actor_id"], ctx).append(
        payload["transitions"])
    return True

  def end_episode(self, payload: Dict[str, Any], ctx: dict) -> bool:
    session = self.session_for(payload["actor_id"], ctx)
    committed_before = session.transitions_committed
    accepted = session.end_episode()
    if accepted:
      self._record_commit(
          session.transitions_committed - committed_before,
          payload.get("policy_learner_step"),
          payload.get("policy_hop"))
    return bool(accepted)

  # ---- sampling / learner tag ----

  def sampler(self, batch_size: int) -> ReplayBatchSampler:
    with self._lock:
      sampler = self._samplers.get(batch_size)
      if sampler is None:
        sampler = ReplayBatchSampler(self.store, batch_size)
        self._samplers[batch_size] = sampler
    return sampler

  def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
    batch = self.sampler(int(batch_size)).sample()
    return {k: np.asarray(v) for k, v in batch.to_flat_dict().items()}

  def size(self) -> int:
    return len(self.store)

  def set_learner_step(self, step: int) -> None:
    self.store.set_learner_step(int(step))

  # ---- reporting ----

  def staleness(self) -> Dict[str, Any]:
    with self._lock:
      samplers = list(self._samplers.items())
    return {str(batch_size): sampler.staleness_snapshot()
            for batch_size, sampler in samplers}

  def metrics(self) -> Dict[str, Any]:
    with self._lock:
      commit_window = self._commit_window
    return {
        "store": self.store.metrics_snapshot(),
        "service": self.service.metrics_scalars(),
        "staleness": self.staleness(),
        "param_refresh_lag": self.lag.snapshot(),
        "commit_window": (None if commit_window is None else {
            "first_time": commit_window[0],
            "last_time": commit_window[1],
        }),
    }

  def metrics_scalars(self) -> Dict[str, float]:
    out = self.store.metrics_scalars()
    with self._lock:
      samplers = list(self._samplers.values())
    for sampler in samplers:
      out.update(sampler.metrics_scalars())
    out["fleet_param_refresh_lag_mean"] = self.lag.snapshot()["mean"]
    return out

  def close(self) -> None:
    self.service.close()
