"""Process-parallel host data plane (port of `data/plane.py`): N decode
workers → a shared-memory ring → one consumer stream.

    worker 0 ─┐ (own process: parse + decode its file shard)
    worker 1 ─┼─ shm ring (finished batches) ─→ consumer
    worker N ─┘

Each worker owns a deterministic shard of the file list (files[i::N]),
runs the in-process TFRecord pipeline over it, and copies each finished
batch into a free ring slot. The consumer's `__next__` pops finished
slots and returns views into the ring (no copy), or copies (`copy`).
Workers are spawned, never forked, and never touch the card: each sets
`CUDA_VISIBLE_DEVICES=-1` before its pipeline runs.

Failure semantics (the JAX plane's):
  * a worker exception ships its traceback through the full queue, is
    latched, and re-raises in the consumer on this and every later
    `__next__`;
  * a worker death without a message (segfault, kill) is found by
    exit-code polling and latched the same way;
  * `close()` always ends the workers, those blocked waiting for a free
    slot included, and unlinks the segment; it may be called any number
    of times, mid-stream too.

Ordering: batches arrive in ring-completion order. With one worker that
is the worker's own pipeline order, so `num_workers` 0 and 1 give the
same stream under a fixed seed; with more, only each worker's suborder
is fixed.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_lib
import time
import traceback
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.data.shm_ring import ShmRing, WireLayout
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

# Queue message tags (worker → consumer).
_BATCH, _DONE, _ERROR = "batch", "done", "error"

Source = Callable[[int, int], Iterator[Dict[str, Any]]]


def views_are_safe() -> bool:
  """Whether the plane's default is to hand out ring views (copy=None).

  Views when this process sees a CUDA card: the trainer's
  `DevicePrefetcher` copies each batch into pinned memory and releases
  the slot at once (`release_after_transfer`). Without a card the
  default copies: a CPU consumer's tensors would alias the ring.
  """
  return torch.cuda.is_available()


def _worker_main(source: Source, worker_index: int, num_workers: int,
                 ring_name: str, layout: WireLayout, num_slots: int,
                 free_q, full_q, stop) -> None:
  """Worker process body: stream `source`'s batches into the ring. Every
  blocking acquire polls `stop`, so `close()` can reclaim a worker stuck
  on a full ring."""
  os.environ["CUDA_VISIBLE_DEVICES"] = "-1"
  ring = None
  try:
    ring = ShmRing.attach(ring_name, layout, num_slots)
    for flat in source(worker_index, num_workers):
      while True:
        if stop.is_set():
          return
        try:
          slot = free_q.get(timeout=0.1)
          break
        except queue_lib.Empty:
          continue
      ring.write(slot, flat)
      full_q.put((_BATCH, worker_index, slot))
    full_q.put((_DONE, worker_index, -1))
  except BaseException:  # latched and re-raised consumer-side
    try:
      full_q.put((_ERROR, worker_index, traceback.format_exc()))
    except Exception:  # pragma: no cover - queue already torn down
      pass
  finally:
    if ring is not None:
      ring.close()
    # Flush the queues' feeder threads so an exit never strands a
    # message half-written into the pipe.
    for q in (free_q, full_q):
      try:
        q.close()
        q.join_thread()
      except Exception:  # pragma: no cover
        pass


def _copied(value):
  return value.clone() if isinstance(value, torch.Tensor) else np.array(value)


@gin.configurable
class HostDataPlane:
  """N worker processes fanned into one shm-ring batch stream.

  Args:
    source: picklable callable `(worker_index, num_workers) → iterator
      of flat dict batches` conforming to `layout`; runs inside each
      (spawned) worker process.
    layout: the ring's `WireLayout` (full batched shapes).
    num_workers: worker process count (>= 1).
    slots_per_worker: ring depth per worker, floored at 2 (a worker
      decodes one batch while its last waits for the consumer); the
      ring holds `max(2, slots_per_worker) × num_workers` slots.
    copy: copy each batch out of the ring before returning it. False
      returns views valid until the next `__next__`/`release`/`close`
      (the consumer owns one slot at a time); None means
      `not views_are_safe()`.
    mp_context: the multiprocessing start method (spawn: workers start
      clear of the parent's threads and CUDA state).
  """

  def __init__(self, source: Source, layout: WireLayout, num_workers: int,
               slots_per_worker: int = 2, copy: Optional[bool] = None,
               mp_context: str = "spawn"):
    if num_workers < 1:
      raise ValueError(
          f"HostDataPlane needs num_workers >= 1, got {num_workers}")
    self._copy = (not views_are_safe()) if copy is None else bool(copy)
    self.num_slots = max(2, slots_per_worker) * num_workers
    self._ring = ShmRing(layout, self.num_slots)
    ctx = multiprocessing.get_context(mp_context)
    self._free_q = ctx.Queue()
    self._full_q = ctx.Queue()
    self._stop = ctx.Event()
    for slot in range(self.num_slots):
      self._free_q.put(slot)
    self._pending_slot: Optional[int] = None
    self._done: List[bool] = [False] * num_workers
    self._suspect: List[bool] = [False] * num_workers
    self._error: Optional[BaseException] = None
    self._closed = False
    self._last_death_poll = time.monotonic()
    self._workers = [
        ctx.Process(
            target=_worker_main,
            args=(source, i, num_workers, self._ring.name, layout,
                  self.num_slots, self._free_q, self._full_q, self._stop),
            name=f"t2r-data-plane-{i}", daemon=True)
        for i in range(num_workers)]
    for p in self._workers:
      p.start()

  # ---- consumer protocol ----

  def __iter__(self) -> "HostDataPlane":
    return self

  def release(self) -> None:
    """Returns the slot behind the last views to the free pool; called
    by the next `__next__` too. Idempotent."""
    if self._pending_slot is not None and not self._closed:
      self._free_q.put(self._pending_slot)
    self._pending_slot = None

  def _latch(self, err: BaseException) -> BaseException:
    self._error = err
    tmetrics.counter("data_plane.worker_failures").inc()
    return err

  def _check_workers(self) -> None:
    """Exit-code poll on an empty queue: a worker that died without a
    message latches a crash error. A clean exit (code 0) whose done
    marker has not surfaced gets one more poll window (the marker may be
    in flight) before it counts as a silent death."""
    for i, p in enumerate(self._workers):
      if self._done[i] or p.is_alive():
        continue
      if p.exitcode != 0:
        raise self._latch(RuntimeError(
            f"data-plane worker {i} died (exit code {p.exitcode}) without "
            "reporting; its batch (if mid-write) is discarded"))
      if self._suspect[i]:
        raise self._latch(RuntimeError(
            f"data-plane worker {i} exited (code 0) without sending its "
            "done marker; treating it as a silent death so the consumer "
            "never hangs"))
      self._suspect[i] = True

  def _poll_crashed_workers(self) -> None:
    """Non-zero exits latch even while siblings keep the queue busy
    (else a crashed worker's shard would silently drop out)."""
    now = time.monotonic()
    if now - self._last_death_poll < 0.5:
      return
    self._last_death_poll = now
    for i, p in enumerate(self._workers):
      if not self._done[i] and not p.is_alive() and p.exitcode != 0:
        raise self._latch(RuntimeError(
            f"data-plane worker {i} died (exit code {p.exitcode}) without "
            "reporting; its file shard is no longer being produced"))

  def __next__(self) -> Dict[str, Any]:
    if self._error is not None:
      raise RuntimeError("data-plane worker failed") from self._error
    if self._closed:
      raise StopIteration
    self.release()
    while True:
      if all(self._done):
        # Per-producer FIFO: every worker's batches precede its done
        # marker, so once all markers are in, the queue holds nothing.
        raise StopIteration
      self._poll_crashed_workers()
      try:
        tag, widx, payload = self._full_q.get(timeout=0.2)
      except queue_lib.Empty:
        self._check_workers()
        continue
      if tag == _BATCH:
        tmetrics.counter("data_plane.batches").inc()
        if self._copy:
          batch = {k: _copied(v)
                   for k, v in self._ring.views(payload).items()}
          self._free_q.put(payload)
          return batch
        self._pending_slot = payload
        return self._ring.views(payload)
      if tag == _DONE:
        self._done[widx] = True
        continue
      raise self._latch(RuntimeError(
          f"data-plane worker {widx} raised:\n{payload}"))

  # ---- introspection / lifecycle ----

  @property
  def copies_batches(self) -> bool:
    return self._copy

  def require_copies(self) -> None:
    """Copy-out mode, for consumers that keep batches past the next
    `__next__` (K-step stacking)."""
    self._copy = True

  def close(self, timeout_secs: float = 5.0) -> None:
    """Stops the workers (even mid-block) and reclaims the segment."""
    if self._closed:
      return
    self._closed = True
    self._stop.set()
    deadline = time.monotonic() + timeout_secs
    for p in self._workers:
      p.join(timeout=max(0.0, deadline - time.monotonic()) + 0.1)
    for p in self._workers:
      if p.is_alive():  # blocked past the grace period: force it
        p.terminate()
        p.join(timeout=1.0)
      if p.is_alive():  # pragma: no cover - terminate() ignored
        p.kill()
        p.join(timeout=1.0)
    for q in (self._full_q, self._free_q):
      try:
        while True:
          q.get_nowait()
      except (queue_lib.Empty, OSError, ValueError):
        pass
      q.close()
      q.join_thread()
    self._pending_slot = None
    self._ring.close()

  def __del__(self):  # best effort: never leak processes or segments
    try:
      self.close(timeout_secs=1.0)
    except Exception:  # pragma: no cover
      pass
