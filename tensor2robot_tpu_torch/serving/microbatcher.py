"""Dynamic micro-batching (port of `serving/microbatcher.py`).

Callers block on `predict()`; one dispatcher thread drains the request
queue into the largest batch the deadline allows (≤ the engine's
max_batch, ≤ max_wait_µs of queueing), dispatches it through the
engine, and scatters per-caller slices back. N concurrent robots cost
~one dispatch instead of N.

Noise: where the JAX version folds the dispatch index into a PRNG key,
each dispatch here draws from its own `torch.Generator` on the
engine's device, seeded from ``(seed, dispatch_index)`` — coalesced
callers in one dispatch share it, successive dispatches never do. A
graphed engine seeds its bucket's registered generator from it, so the
dispatch draws what an eager one with that generator would.

Telemetry, as the JAX batcher publishes it: the
``serving.microbatch_queue_depth`` gauge (requests still queued behind
a dispatch), the ``serving.microbatch_rows`` histogram (rows per
dispatch) and a ``serving.microbatch_dispatch`` span around each
dispatch (host time; no device synchronization is added).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Any, List, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.serving import coalesce
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
from tensor2robot_tpu_torch.utils import tree


def dispatch_seed(seed: int, dispatch_index: int) -> int:
  """A 63-bit generator seed mixing the base seed and dispatch index."""
  state = np.random.SeedSequence([seed, dispatch_index]).generate_state(
      1, np.uint64)
  return int(state[0]) >> 1


class _Request:

  __slots__ = ("features", "n", "future")

  def __init__(self, features: Any, n: int):
    self.features = features
    self.n = n
    self.future: Future = Future()


class MicroBatcher:
  """Coalesces concurrent requests onto a `BucketedServingEngine`."""

  def __init__(self, engine, max_wait_us: int = 200,
               seed: Optional[int] = None):
    """Args:
      engine: a `BucketedServingEngine`.
      max_wait_us: how long a dispatch may hold its FIRST request while
        waiting for more to coalesce (0 = never wait).
      seed: base seed of the per-dispatch generators for engines that
        take one (CEM policies); None = the engine takes none.
    """
    self._engine = engine
    self._max_wait = max_wait_us / 1e6
    self._seed = seed
    self._dispatch_index = 0
    self._carry: Optional[_Request] = None
    self._queue: "queue.Queue[_Request]" = queue.Queue()
    self._stop = threading.Event()
    # Serializes submit()'s closed-check+enqueue against close()'s stop.
    self._submit_lock = threading.Lock()
    self.dispatches = 0
    self.requests = 0
    self.batch_sizes: List[int] = []
    self._tm_queue_depth = tmetrics.gauge("serving.microbatch_queue_depth")
    self._tm_rows = tmetrics.histogram(
        "serving.microbatch_rows", bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256))
    self._thread = threading.Thread(target=self._run, name="microbatcher",
                                    daemon=True)
    self._thread.start()

  # ---- caller side ----

  def submit(self, features: Any) -> Future:
    """Enqueues one request (1..max_batch rows); returns its Future."""
    n = int(np.asarray(tree.leaves(features)[0]).shape[0])
    if n > self._engine.max_batch:
      raise ValueError(
          f"request of {n} rows exceeds the engine's max_batch "
          f"{self._engine.max_batch}; split it or raise max_batch.")
    request = _Request(features, n)
    with self._submit_lock:
      if self._stop.is_set():
        raise RuntimeError(
            "MicroBatcher is closed; submit() after close() would "
            "enqueue into a dead dispatcher. Create a new MicroBatcher.")
      self.requests += 1
      self._queue.put(request)
    return request.future

  def predict(self, features: Any) -> Any:
    """Blocking predict — what a control loop calls each tick."""
    return self.submit(features).result()

  # ---- dispatcher thread ----

  def _run(self) -> None:
    while (not self._stop.is_set() or not self._queue.empty()
           or self._carry is not None):
      batch, self._carry = coalesce.take_batch(
          self._queue, self._carry, self._engine.max_batch,
          self._max_wait, first_timeout_secs=0.05)
      if batch:
        self._dispatch(batch)

  def _dispatch(self, batch: List[_Request]) -> None:
    batch = coalesce.claim_batch(batch)
    if not batch:
      return
    try:
      rows = sum(r.n for r in batch)
      self._tm_queue_depth.set(self._queue.qsize())
      self._tm_rows.observe(rows)
      features = coalesce.concat_features(batch)
      with telemetry.span("serving.microbatch_dispatch",
                          requests=len(batch), rows=rows):
        if self._seed is not None:
          generator = torch.Generator(
              device=self._engine.device).manual_seed(
                  dispatch_seed(self._seed, self._dispatch_index))
          outputs = self._engine.predict(features, generator=generator)
        else:
          outputs = self._engine.predict(features)
      self._dispatch_index += 1
      self.dispatches += 1
      self.batch_sizes.append(rows)
      coalesce.deliver(batch, outputs)
    except Exception as exc:  # noqa: BLE001 — deliver to every caller
      coalesce.fail_batch(batch, exc)

  # ---- lifecycle ----

  def close(self, timeout: float = 30.0) -> None:
    """Drains queued requests, then stops the dispatcher thread."""
    with self._submit_lock:
      self._stop.set()
    self._thread.join(timeout=timeout)
    # If the dispatcher died or timed out, fail stranded requests
    # instead of hanging their callers.
    while True:
      try:
        request = self._queue.get_nowait()
      except queue.Empty:
        break
      if not request.future.done():
        request.future.set_exception(
            RuntimeError("MicroBatcher closed before dispatch."))

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    return False
