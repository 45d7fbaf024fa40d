"""ServingFront: continuous batching across tenants, one dispatcher
(port of `serving/front.py`).

The single-model `MicroBatcher` parks a dispatcher thread per model;
the front runs ONE continuous-batching loop over every tenant's queue:

        tenant queues (bounded, admission-gated)
  a ──► [r r r]   ╲
  b ──► [r]        ──► round-robin pick ──► coalesce ≤ max_batch rows
  c ──► [r r]     ╱         │                of ONE tenant
                            ▼
                  arena.engine_async(tenant)   ◄─ LRU touch; a COLD
                            │                     tenant's load runs on
                            ▼                     an arena thread while
                  engine.predict(...)             the loop serves others
                            │
                            ▼
                  per-request slices → futures, latency stamped

A cold or evicted tenant never parks the dispatcher: its load (engine
build and bucket captures) runs on an arena thread, the round-robin
skips the tenant until the load's done-callback wakes the loop, and its
queued requests then dispatch against the warm engine (or fail with the
loader's error — the next submit retries the load).

Requests of different tenants never co-batch. FAIR SHARE is
round-robin with a one-dispatch turn: each turn serves at most one
dispatch (≤ the tenant's `max_batch` rows) before the pointer advances.
The submit path is the admission pipeline (`serving/admission.py`):
token-bucket rate gate → bounded tenant queue ("drop" counted, "block"
with deadline). `submit()` after `close()` fails fast.

Noise: a tenant that takes a generator (a CEM policy) gets, for each
dispatch, a `torch.Generator` on its engine's device seeded
`microbatcher.dispatch_seed(seed + i, d)`, with i the tenant's
registration index and d the front-wide dispatch index, where the JAX
front folds d into the tenant's `PRNGKey(seed + i)`. The streams differ
from JAX's (torch cannot draw threefry's numbers); a single-request
dispatch equals `engine.predict` with that generator, bit for bit.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.serving import coalesce
from tensor2robot_tpu_torch.serving.admission import (
    AdmissionController,
    RequestRejected,
    TenantPolicy,
    deadline_slices,
)
from tensor2robot_tpu_torch.serving.arena import ModelArena
from tensor2robot_tpu_torch.serving.microbatcher import dispatch_seed
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
from tensor2robot_tpu_torch.utils import tree


class _Request:

  __slots__ = ("features", "n", "future", "t_submit")

  def __init__(self, features: Any, n: int):
    self.features = features
    self.n = n
    self.future: Future = Future()
    self.t_submit = time.perf_counter()


class _Tenant:
  """Per-tenant front state: bounded queue + carry + metric handles."""

  __slots__ = ("tenant", "queue", "carry", "loading", "seed",
               "tm_request_ms", "tm_completions", "tm_slo_ok",
               "tm_queue_depth", "tm_goodput", "goodput_rows",
               "goodput_t0")

  def __init__(self, tenant: str, max_queue: int, seed: int,
               takes_rng: bool):
    self.tenant = tenant
    self.queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
    self.carry: Optional[_Request] = None
    # The tenant's arena load in flight (dispatcher-observed): while
    # set and unresolved, the round-robin SKIPS this tenant — its
    # requests wait in the queue, every other tenant keeps dispatching.
    self.loading: Optional[Future] = None
    # Base seed of the per-dispatch generators (None: no generator).
    self.seed = seed if takes_rng else None
    self.tm_request_ms = tmetrics.histogram(
        f"serving.{tenant}.request_ms")
    self.tm_completions = tmetrics.counter(
        f"serving.{tenant}.completions")
    self.tm_slo_ok = tmetrics.counter(f"serving.{tenant}.slo_ok")
    self.tm_queue_depth = tmetrics.gauge(
        f"serving.{tenant}.queue_depth")
    # Live goodput: in-SLO completed ROWS per second over a rolling
    # window, from the same completion accounting the slo_ok counter
    # rides.
    self.tm_goodput = tmetrics.gauge(
        f"serving.{tenant}.goodput_rows_per_sec")
    self.goodput_rows = 0.0
    self.goodput_t0 = time.perf_counter()

  def pending(self) -> bool:
    return self.carry is not None or not self.queue.empty()


@gin.configurable
class ServingFront:
  """Multi-tenant serving entry: admission → queues → one dispatcher."""

  def __init__(self,
               arena: ModelArena,
               admission: Optional[AdmissionController] = None,
               max_wait_us: int = 0,
               seed: int = 0):
    """Args:
      arena: the pinned-param pool (tenants register through the
        front so arena, admission, and queues stay in step).
      admission: the per-tenant gate; None constructs one with
        defaults (`AdmissionController()`).
      max_wait_us: batch-forming hold per dispatch, like the
        micro-batcher's. 0 (default) = pure continuous batching —
        dispatch whatever is queued, never hold the device.
      seed: base seed of the per-dispatch generators of tenants that
        take one (CEM policies): tenant i's dispatch d draws from
        `dispatch_seed(seed + i, d)`.
    """
    self._arena = arena
    self._admission = admission or AdmissionController()
    self._max_wait = max_wait_us / 1e6
    self._seed = int(seed)
    self._tenants: Dict[str, _Tenant] = {}
    self._order: List[str] = []
    self._rr = 0
    self._dispatch_index = 0
    self._stop = threading.Event()
    # Serializes submit()'s closed-check+enqueue against close(), the
    # micro-batcher's fail-fast contract: a request must never land on
    # a queue after the dispatcher decided to exit.
    self._submit_lock = threading.Lock()
    # Wakeup FLAG, not a token per request: a maxsize-1 queue set by
    # every submit (put_nowait, Full ignored) and consumed only when
    # the dispatcher goes idle. One token per request would never be
    # drained under sustained load (rounds keep finding work) and
    # grow without bound — the eventfd-style coalesced flag carries
    # the same no-lost-wakeup guarantee: a submit enqueues its request
    # BEFORE setting the flag, so after the dispatcher consumes a flag
    # its next scan sees the request, or a newer flag is already set.
    self._work: "queue.Queue[bool]" = queue.Queue(maxsize=1)
    self.dispatches = 0
    self.requests = 0
    self.dispatches_per_tenant: Dict[str, int] = {}
    # Front-wide live goodput window (in-SLO rows/s across tenants);
    # per-tenant windows live on each _Tenant entry. Dispatcher-thread
    # state only — no lock.
    self._goodput_rows = 0.0
    self._goodput_t0 = time.perf_counter()
    self._thread = threading.Thread(
        target=self._run, name="serving-front", daemon=True)
    self._thread.start()

  @property
  def arena(self) -> ModelArena:
    return self._arena

  @property
  def admission(self) -> AdmissionController:
    return self._admission

  # ---- registration ----

  def register_tenant(self,
                      tenant: str,
                      loader,
                      policy: Optional[TenantPolicy] = None,
                      max_batch: int = 8,
                      takes_rng: bool = False,
                      warmup: bool = True,
                      preload: bool = False) -> None:
    """One call wires a tenant end to end: arena residency spec,
    admission policy, and the front queue. `preload=True` loads (and
    warms up) the engine now instead of on first request."""
    # Validate the policy the tenant will actually get — the explicit
    # one OR the controller's default: a bucket of
    # depth `burst` can NEVER grant `max_batch` tokens, so every
    # full-size request would shed at any load ("drop") or spin to its
    # deadline ("block"). Loud at registration, not a 100%-shed
    # mystery in production. Checked BEFORE any registration so a
    # rejection leaves no half-registered tenant behind.
    effective = (policy if policy is not None
                 else self._admission.policy(tenant))
    if (effective.rate_rps is not None
        and effective.burst < max_batch):
      raise ValueError(
          f"tenant {tenant!r}: burst={effective.burst} < "
          f"max_batch={max_batch} — a max-size request could never be "
          "admitted; raise burst to at least max_batch.")
    self._arena.register(tenant, loader, max_batch=max_batch,
                         takes_rng=takes_rng, warmup=warmup)
    policy = self._admission.register(tenant, policy)
    entry = _Tenant(tenant, policy.max_queue,
                    seed=self._seed + len(self._order),
                    takes_rng=takes_rng)
    with self._submit_lock:
      self._tenants[tenant] = entry
      self._order.append(tenant)
    if preload:
      self._arena.engine(tenant)

  # ---- caller side ----

  def submit(self, tenant: str, features: Any) -> Future:
    """Admission-gated enqueue; returns the request's Future.

    Raises `RequestRejected` when the tenant's token bucket or queue
    bound sheds it (policy "drop", or "block" past its deadline), and
    `RuntimeError` after `close()` — fail fast, never enqueue into a
    dead dispatcher.
    """
    entry = self._tenants.get(tenant)
    if entry is None:
      raise KeyError(f"tenant {tenant!r} is not registered")
    n = int(np.asarray(tree.leaves(features)[0]).shape[0])
    max_batch = self._arena.spec(tenant).max_batch
    if n > max_batch:
      raise ValueError(
          f"request of {n} rows exceeds tenant {tenant!r} max_batch "
          f"{max_batch}; split it or raise max_batch.")
    if self._stop.is_set():
      raise RuntimeError(
          "ServingFront is closed; submit() after close() would "
          "enqueue into a dead dispatcher.")
    if not self._admission.admit(tenant, n, stop=self._stop):
      raise RequestRejected(
          tenant, "rate",
          f"tenant {tenant!r}: over admitted rate "
          f"(rate_rps={self._admission.policy(tenant).rate_rps}); "
          "request shed")
    request = _Request(features, n)
    policy = self._admission.policy(tenant)
    if self._try_enqueue(tenant, entry, request):
      return request.future
    # Queue full. "drop": count + reject. "block": backpressure in
    # timed SLEEP slices, each retrying `_try_enqueue` — every attempt
    # re-checks the closed flag under the submit lock, so a close()
    # can never be outrun by a late enqueue onto a freed slot
    # (sleeping happens outside the lock, the replay producers'
    # timed-put shape). Either shed path refunds the rate tokens the
    # request spent — unserved rows must not charge the tenant's
    # future budget. The request keeps its original submit stamp:
    # time spent blocked here is real latency the SLO accounting
    # must see.
    if policy.overflow == "drop":
      self._admission.queue_full(tenant, n)
      raise RequestRejected(
          tenant, "queue_full",
          f"tenant {tenant!r}: queue full "
          f"(max_queue={policy.max_queue}); request shed")
    for slice_secs in deadline_slices(policy.block_timeout_secs):
      # No stop event here: _try_enqueue re-checks the closed flag
      # under the submit lock every slice and raises the fail-fast
      # error itself — a close() mid-wait is noticed within a slice.
      time.sleep(slice_secs)
      if self._try_enqueue(tenant, entry, request):
        return request.future
    self._admission.queue_full(tenant, n)
    raise RequestRejected(
        tenant, "queue_full",
        f"tenant {tenant!r}: queue full past "
        f"block_timeout_secs={policy.block_timeout_secs}; "
        "request shed")

  def _try_enqueue(self, tenant: str, entry: _Tenant,
                   request: _Request) -> bool:
    """ONE enqueue attempt; the fail-fast contract lives here, once.

    Closed-check + bounded put + request accounting all happen under
    the submit lock (close() sets the stop flag under the same lock,
    so a request can never land on a queue after close() decided to
    drain); returns False on a full queue. A successful enqueue is
    what `admitted` MEANS: the request cleared both gates, so the
    admitted/dropped counters partition offered load with no overlap —
    including on the closed path: every caller sits past the rate gate
    (tokens charged), so a close() racing the enqueue refunds and
    counts the shed before failing fast.
    """
    closed = False
    with self._submit_lock:
      if self._stop.is_set():
        closed = True
      else:
        try:
          entry.queue.put_nowait(request)
        except queue.Full:
          return False
        self.requests += 1
    if closed:
      # Outside the submit lock: queue_full takes the admission locks.
      self._admission.queue_full(tenant, request.n)
      raise RuntimeError(
          "ServingFront is closed; submit() after close() would "
          "enqueue into a dead dispatcher.")
    self._wake()
    self._admission.count_admitted(tenant, request.n)
    return True

  def _wake(self, _done_future: Any = None) -> None:
    """Sets the coalesced wakeup flag (submit path AND arena-load
    done-callbacks — the signature tolerates the Future argument)."""
    try:
      self._work.put_nowait(True)
    except queue.Full:
      pass  # a wakeup is already pending — the scan will see us

  def predict(self, tenant: str, features: Any) -> Any:
    """Blocking predict — submit + wait (a control loop's tick)."""
    return self.submit(tenant, features).result()

  # ---- dispatcher thread ----

  @staticmethod
  def _load_in_flight(entry: _Tenant) -> bool:
    return entry.loading is not None and not entry.loading.done()

  def _next_tenant(self) -> Optional[_Tenant]:
    """Round-robin over tenants with pending work (fair share).
    Tenants whose arena load is still in flight are skipped — their
    turn comes when the load's done-callback wakes the dispatcher."""
    with self._submit_lock:
      order = list(self._order)
      start = self._rr
    count = len(order)
    for offset in range(count):
      tenant_id = order[(start + offset) % count]
      entry = self._tenants[tenant_id]
      if entry.pending() and not self._load_in_flight(entry):
        with self._submit_lock:
          self._rr = (start + offset + 1) % count
        return entry
    return None

  def _run(self) -> None:
    while True:
      served = self._serve_round()
      if served:
        continue
      if self._stop.is_set():
        # Drained: every queue and carry is empty.
        if all(not t.pending() for t in self._tenants.values()):
          return
        # Pending work behind an in-flight load: park on the wakeup
        # flag (the load's done-callback sets it) instead of spinning
        # the drain scan hot.
        if any(self._load_in_flight(t) for t in self._tenants.values()):
          try:
            self._work.get(timeout=0.05)
          except queue.Empty:
            pass
        continue
      try:
        # Idle: park on the wakeup flag. A stale flag costs one empty
        # scan — never a lost request, never a busy spin. The idle
        # tick also rolls the goodput windows so gauges decay honestly
        # through quiet stretches.
        self._work.get(timeout=0.05)
      except queue.Empty:
        self._roll_goodput_windows()
        continue

  def _serve_round(self) -> bool:
    entry = self._next_tenant()
    if entry is None:
      return False
    # A load that just resolved: surface its outcome before dispatch.
    load, entry.loading = entry.loading, None
    if load is not None and load.exception() is not None:
      # The load failed — its queued requests get the loader's error
      # (claim-first, so a cancelled future can't poison delivery);
      # the NEXT submit triggers a fresh load attempt.
      max_batch = self._arena.spec(entry.tenant).max_batch
      batch, entry.carry = coalesce.take_batch(
          entry.queue, entry.carry, max_batch, 0.0)
      failed = coalesce.claim_batch(batch)
      if failed:
        coalesce.fail_batch(failed, load.exception())
      return bool(batch)
    # Async arena touch (LRU bump; load-on-miss runs on an arena
    # thread): a cold tenant never parks this dispatcher — mark it
    # loading, wake on completion, serve everyone else meanwhile.
    engine, pending = self._arena.engine_async(entry.tenant)
    if pending is not None:
      entry.loading = pending
      pending.add_done_callback(self._wake)
      return True  # turn consumed; the tenant waits on its load
    max_batch = self._arena.spec(entry.tenant).max_batch
    batch, entry.carry = coalesce.take_batch(
        entry.queue, entry.carry, max_batch, self._max_wait)
    if not batch:
      return False
    self._dispatch(entry, batch, engine)
    return True  # queue entries were consumed either way

  _GOODPUT_WINDOW_SECS = 1.0

  def _roll_goodput_windows(self, now: Optional[float] = None) -> None:
    """Closes every goodput window that has run ≥1 s — per tenant and
    front-wide — publishing rows/window (0 when nothing completed).
    Called after each completion batch AND from the dispatcher's idle
    tick, so windows keep rolling through quiet stretches: an idle
    tenant's gauge decays to 0 within ~a window instead of freezing at
    its last burst, and a burst after a long gap is denominated over
    ~one window, not the whole gap. Dispatcher-thread only."""
    if now is None:
      now = time.perf_counter()
    for entry in list(self._tenants.values()):
      window = now - entry.goodput_t0
      if window >= self._GOODPUT_WINDOW_SECS:
        entry.tm_goodput.set(entry.goodput_rows / window)
        entry.goodput_rows = 0.0
        entry.goodput_t0 = now
    window = now - self._goodput_t0
    if window >= self._GOODPUT_WINDOW_SECS:
      tmetrics.gauge("perf.goodput_rows_per_sec").set(
          self._goodput_rows / window)
      self._goodput_rows = 0.0
      self._goodput_t0 = now

  def _dispatch(self, entry: _Tenant, batch: List[_Request],
                engine: Any) -> None:
    # Claim first (shared coalesce contract): requests cancelled while
    # queued drop out here, survivors can't be cancelled — delivery
    # can never hit a poisoned future.
    batch = coalesce.claim_batch(batch)
    if not batch:
      return
    try:
      rows = sum(r.n for r in batch)
      entry.tm_queue_depth.set(entry.queue.qsize())
      features = coalesce.concat_features(batch)
      with telemetry.span("serving.front_dispatch",
                          tenant=entry.tenant,
                          requests=len(batch), rows=rows):
        if entry.seed is not None:
          generator = torch.Generator(device=engine.device).manual_seed(
              dispatch_seed(entry.seed, self._dispatch_index))
          outputs = engine.predict(features, generator=generator)
        else:
          outputs = engine.predict(features)
      self._dispatch_index += 1
      self.dispatches += 1
      self.dispatches_per_tenant[entry.tenant] = (
          self.dispatches_per_tenant.get(entry.tenant, 0) + 1)
      slo_ms = self._admission.policy(entry.tenant).slo_ms
      done = time.perf_counter()
      for request in batch:
        latency_ms = (done - request.t_submit) * 1e3
        entry.tm_request_ms.observe(latency_ms)
        entry.tm_completions.inc()
        if latency_ms <= slo_ms:
          entry.tm_slo_ok.inc()
          entry.goodput_rows += request.n
          self._goodput_rows += request.n
      self._roll_goodput_windows(done)
      coalesce.deliver(batch, outputs)
    except Exception as exc:  # noqa: BLE001 — deliver to every caller
      coalesce.fail_batch(batch, exc)

  # ---- lifecycle ----

  def close(self, timeout: float = 30.0) -> None:
    """Drains queued requests, then stops the dispatcher thread."""
    with self._submit_lock:
      self._stop.set()
    self._thread.join(timeout=timeout)
    for entry in self._tenants.values():
      stranded = [entry.carry] if entry.carry is not None else []
      entry.carry = None
      while True:
        try:
          stranded.append(entry.queue.get_nowait())
        except queue.Empty:
          break
      for request in stranded:
        if not request.future.done():
          request.future.set_exception(
              RuntimeError("ServingFront closed before dispatch."))

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False
