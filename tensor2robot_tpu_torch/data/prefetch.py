"""Host→device pipelining (port of `data/prefetch.py`), on one card.

`DevicePrefetcher` takes the place of the JAX package's
`ShardedPrefetcher`: a host thread pulls batches from the host stream,
copies each into pinned memory and onto the card on a side stream, and
queues it with the copy's event; the consumer's stream waits on that
event, so step N's compute overlaps step N+1's transfer. The shared
helpers keep the JAX trainers' contracts: the `steps_per_dispatch`
cadence rule, the lookahead depth, K-batch stacking and the
`input_wait_fraction` timer.

The release protocol of the data plane (`data/plane.py`): when the host
stream hands out views of a shared-memory ring slot
(`source.release_after_transfer`), the prefetcher copies each batch
(into pinned memory on a card, by a clone on the CPU) and then calls
`source.release_consumed()`, so the slot recycles once the prefetcher
owns the bytes, before the copy to the card has even started.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.specs import TensorSpecStruct

log = logging.getLogger(__name__)


@gin.configurable
def prefetch_buffer_size(buffer_size: Optional[int] = None,
                         online: bool = False) -> int:
  """The prefetcher's lookahead depth: `buffer_size` when given, else 1
  when actors feed replay while training (each buffered batch adds
  sampling lead), else 2."""
  if buffer_size is not None:
    if buffer_size < 1:
      raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
    return int(buffer_size)
  return 1 if online else 2


def validate_steps_per_dispatch(k: int, **cadences: Optional[int]) -> int:
  """Checks the iterations_per_loop quantization contract: every named
  cadence (log, checkpoint, max steps) must be a multiple of K, since
  boundaries are only observable between dispatches. Returns k."""
  k = int(k)
  if k < 1:
    raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
  if k > 1:
    for name, value in cadences.items():
      if value and value % k:
        raise ValueError(
            f"{name}={value} must be a multiple of "
            f"steps_per_dispatch={k} (the iterations_per_loop "
            "quantization: boundaries are only observable between "
            "dispatches).")
  return k


def _flat(batch) -> Dict[str, Any]:
  return dict(batch.to_flat_dict() if hasattr(batch, "to_flat_dict")
              else batch)


class StackedBatchStream:
  """Groups K consecutive batches into one [K, B, ...]-stacked struct.

  A finite stream that runs dry mid-stack ends the output cleanly (the
  partial stack is dropped, and the drop is logged). A class, so
  `close()` reaches the inner stream from another thread.
  """

  def __init__(self, stream: Iterator[Any], k: int):
    self._it = iter(stream)
    self._k = int(k)
    self._exhausted = False

  def __iter__(self):
    return self

  def __next__(self):
    if self._exhausted:
      raise StopIteration
    batches = []
    for _ in range(self._k):
      try:
        batches.append(_flat(next(self._it)))
      except StopIteration:
        self._exhausted = True
        if batches:
          log.warning(
              "steps_per_dispatch=%d dropped a partial tail of %d "
              "batch(es): the finite input stream's length is not a "
              "multiple of K, so this run trains %d fewer step(s) than "
              "K=1 would.", self._k, len(batches), len(batches))
        self.close()
        raise
    return TensorSpecStruct.from_flat_dict(
        {key: np.stack([b[key] for b in batches]) for key in batches[0]})

  def close(self) -> None:
    closer = getattr(self._it, "close", None)
    if callable(closer):
      closer()


def stack_batches(stream: Iterator[Any], k: int) -> StackedBatchStream:
  return StackedBatchStream(stream, k)


def _to_tensor(x) -> torch.Tensor:
  return x if isinstance(x, torch.Tensor) else torch.from_numpy(
      np.ascontiguousarray(x))


class DevicePrefetcher:
  """Iterator wrapper: host batches → flat dicts of tensors on `device`,
  up to `buffer_size` batches ahead of the consumer.

  On a CUDA device each host array is pinned and copied on a side
  stream; the worker waits for its copy to finish before queueing (so
  the pinned buffer outlives it), and `__next__` makes the caller's
  stream wait on the copy's event and records the tensors on that
  stream for the caching allocator. On the CPU batches pass through as
  tensors. `source` is the host stream whose release protocol applies
  (by default `iterator` itself; see the module docstring).
  """

  def __init__(self, iterator: Iterator[Any], device: torch.device,
               buffer_size: int = 2, source: Any = None):
    self._iterator = iterator
    self._source = iterator if source is None else source
    self._device = torch.device(device)
    self._cuda = self._device.type == "cuda"
    self._side = torch.cuda.Stream(self._device) if self._cuda else None
    self._queue: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    self._done = object()
    self._error: Optional[BaseException] = None
    self._stop = threading.Event()
    self._thread = threading.Thread(target=self._worker, daemon=True)
    self._thread.start()

  def _place(self, batch):
    flat = {k: _to_tensor(v) for k, v in _flat(batch).items()}
    views = getattr(self._source, "release_after_transfer", False)
    if self._cuda:
      flat = {k: v.pin_memory() for k, v in flat.items()}  # a copy
    elif views:
      flat = {k: v.clone() for k, v in flat.items()}
    if views:
      self._source.release_consumed()
    if not self._cuda:
      return flat, None
    with torch.cuda.stream(self._side):
      placed = {k: v.to(self._device, non_blocking=True)
                for k, v in flat.items()}
      event = torch.cuda.Event()
      event.record(self._side)
    event.synchronize()
    return placed, event

  def _put(self, item) -> bool:
    """Bounded put that notices close(); False once stopped."""
    while not self._stop.is_set():
      try:
        self._queue.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def _worker(self):
    try:
      for batch in self._iterator:
        if not self._put(self._place(batch)):
          return
    except BaseException as e:  # surfaced on the consumer thread
      self._error = e
    finally:
      self._put(self._done)

  def __iter__(self):
    return self

  def __next__(self) -> Dict[str, torch.Tensor]:
    while True:
      if self._stop.is_set():
        raise StopIteration
      try:
        item = self._queue.get(timeout=0.1)
        break
      except queue.Empty:
        continue
    if item is self._done:
      if self._error is not None:
        raise self._error
      raise StopIteration
    placed, event = item
    if event is not None:
      stream = torch.cuda.current_stream(self._device)
      stream.wait_event(event)
      for t in placed.values():
        t.record_stream(stream)
    return placed

  def close(self, timeout_secs: float = 5.0) -> None:
    """Stops the worker, drops buffered batches and closes the source."""
    self._stop.set()
    while True:
      try:
        self._queue.get_nowait()
      except queue.Empty:
        break
    self._thread.join(timeout=timeout_secs)
    closer = getattr(self._iterator, "close", None)
    if callable(closer) and not self._thread.is_alive():
      closer()


class TimedIterator:
  """Iterator wrapper accumulating the wall time spent blocked in
  `next()`: the `input_wait_fraction` the trainers log (near 0 the feed
  keeps up; toward 1 the device starves)."""

  def __init__(self, iterator: Iterator[Any]):
    self._it = iter(iterator)
    self.wait_secs = 0.0

  def __iter__(self):
    return self

  def __next__(self):
    t0 = time.perf_counter()
    try:
      return next(self._it)
    finally:
      self.wait_secs += time.perf_counter() - t0

  def wait_fraction(self, interval_secs: float) -> float:
    """Clamped share of `interval_secs` spent blocked; resets the
    accumulator (one call per log interval)."""
    fraction = min(max(self.wait_secs / max(interval_secs, 1e-9), 0.0), 1.0)
    self.wait_secs = 0.0
    return fraction
