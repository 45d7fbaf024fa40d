"""Bucketed serving engine (port of `serving/engine.py`).

One `BucketedServingEngine` owns what is shape-dependent about the hot
path and the params it serves:

  * powers-of-two batch buckets with last-row padding, and one CUDA
    graph per bucket (`utils.step_graph.StepGraph`: the counterpart of
    the JAX engine's one executable per bucket). `warmup()` captures
    every bucket and runs it once, recording its seconds;
    `warmup_async()` does that on a thread and `wait_warmup()` joins it.
    A bucket is captured once (`compile_count`): a dispatch racing the
    warmup thread waits on the compile lock only for a bucket not yet
    captured, and a ready bucket dispatches without waiting for the
    rest. A dispatch copies its padded features into the bucket's static
    inputs, seeds the bucket's generator from the dispatch's generator
    and replays. On the CPU the same function runs eagerly over the same
    buffers; `graphs=False` runs it eagerly on either device.
  * Two state slots, each the acting params (params and batch
    statistics) in static buffers that every bucket's graph over that
    slot reads: a bucket's compile captures its graph over each slot.
    `swap_state` writes the new params into the slot not published,
    after every dispatch still reading that slot has finished, waits
    for the copy, then publishes it with a single reference assignment
    of a `_Published(state, version, learner_step, slot)` tuple. A
    dispatch reads the tuple once and holds its slot until its outputs
    are on the host, so it completes on the params it started with and
    sees entirely-old or entirely-new params, never a mix.

Telemetry, as the JAX engine publishes it: under `metric_prefix`
(``serving.`` by default; the arena passes ``serving.<tenant>.``) the
``dispatches`` and ``swaps`` counters and one ``bucket_<n>_ms``
histogram per bucket (the wall time of a dispatch on the host, features
in to outputs on the host); a ``serving.dispatch`` span per dispatch
and a ``serving.swap_state`` event per swap. The span and the histogram
time the host side around a graph replay: they add no device
synchronization to the dispatch (the copy of the outputs to the host is
the only wait, as before).

`fn(state, features[, generator])` takes tensors with a leading batch
dim on the engine's device and returns a tensor (or a tree of them)
with the same leading dim.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch import telemetry
from tensor2robot_tpu_torch.device import resolve_device, synchronize
from tensor2robot_tpu_torch.models.abstract_model import TrainState
from tensor2robot_tpu_torch.serving import bucketing
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics
from tensor2robot_tpu_torch.utils import tree
from tensor2robot_tpu_torch.utils.step_graph import (
    StepGraph,
    copy_into,
    copy_tree,
    tensors,
)

_RELEASED = ("BucketedServingEngine was released; build a new engine "
             "to serve again.")


class _Published(NamedTuple):
  """One atomically-published params generation: the state, its
  monotonic version (0 = construction-time params), the learner step it
  was published at (the `param_refresh_lag` stamp) and its slot."""

  state: Any
  version: int
  learner_step: int
  slot: int = 0


def acting_params(state: Any) -> TrainState:
  """The acting params of a `TrainState` or a `QTOptState` (its online
  `TrainState`): params and batch statistics, no optimizer state."""
  ts = getattr(state, "train_state", state)
  return TrainState(step=ts.step, params=ts.params,
                    batch_stats=ts.batch_stats)


class BucketedServingEngine:
  """Serves `fn` over powers-of-two batch buckets on one device."""

  def __init__(self,
               fn: Callable,
               state: Any,
               example_features: Any,
               max_batch: int = 8,
               takes_rng: bool = False,
               device=None,
               graphs: bool = True,
               metric_prefix: str = "serving."):
    """Args:
      fn: `(state, features)` or `(state, features, generator)`.
      state: params holder (a `TrainState` or a `QTOptState`); its
        acting params are copied into the engine's two slots.
      example_features: a features tree with ANY leading batch dim —
        its first row seeds `warmup()`.
      max_batch: largest servable request; the bucket table covers it.
      takes_rng: whether `fn` takes a `torch.Generator` (CEM policies).
      device: where the state lives and `fn` runs; None = CUDA.
      graphs: one captured graph per bucket (default); False runs `fn`
        eagerly per dispatch.
      metric_prefix: namespace of this engine's registry metrics.
    """
    self._device = resolve_device(device)
    self._fn = fn
    self._takes_rng = takes_rng
    self._graphs = graphs
    self._table = bucketing.bucket_table(max_batch)
    self._example_row = tree.map_structure(
        lambda a: np.asarray(a)[:1], example_features)
    first = copy_tree(self._place(state))  # the engine's own buffers
    self._slots = [first, copy_tree(first)]
    self._readers = [0, 0]
    self._slot_cv = threading.Condition()
    self._state_bytes = first.nbytes
    self._published = _Published(first, version=0, learner_step=0, slot=0)
    self._released = False
    self._swap_lock = threading.Lock()
    # Serializes bucket captures: an async warmup must never race a
    # cold `predict` into capturing the same bucket twice.
    self._compile_lock = threading.Lock()
    # bucket → (graph over slot 0, graph over slot 1, replay lock)
    self._compiled: Dict[int, Tuple[StepGraph, StepGraph, threading.Lock]] = {}
    self._warmup_thread: Optional[threading.Thread] = None
    self._warmup_error: Optional[BaseException] = None
    self.compile_count = 0
    self.warmup_seconds: float = 0.0
    self.bucket_warmup_seconds: Dict[int, float] = {}
    self.dispatch_count = 0
    self.dispatches_per_bucket: Dict[int, int] = {}
    self.swap_count = 0
    self._metric_prefix = metric_prefix
    self._tm_dispatches = tmetrics.counter(f"{metric_prefix}dispatches")
    self._tm_swaps = tmetrics.counter(f"{metric_prefix}swaps")
    self._tm_bucket_ms: Dict[int, Any] = {}

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def bucket_sizes(self):
    return self._table

  @property
  def max_batch(self) -> int:
    return self._table[-1]

  @property
  def compiled_buckets(self):
    """Buckets whose graphs are captured (all of them after warmup)."""
    return tuple(sorted(self._compiled))

  @property
  def state_bytes(self) -> int:
    """Device bytes of one slot's params (constant: swaps keep shapes)."""
    return self._state_bytes

  @property
  def released(self) -> bool:
    return self._released

  def _place(self, state: Any) -> TrainState:
    placed = acting_params(state).to(self._device)
    synchronize(self._device)  # published only once fully on device
    return placed

  def release(self) -> None:
    """Retires the engine: drops its references to the slots and the
    graphs. A dispatch in flight keeps its own references and completes
    on the old params; later `predict`/`swap_state` calls raise.
    Idempotent."""
    with self._swap_lock:
      with self._compile_lock:
        if self._released:
          return
        self._released = True
        self._compiled = {}
        self._slots = [None, None]
        self._published = _Published(None, version=-1, learner_step=-1)

  # ---- capture and warmup ----

  def _slot_fn(self):
    if self._takes_rng:
      return lambda state, feats, gens: (state, self._fn(state, feats,
                                                         gens[0]))
    return lambda state, feats, gens: (state, self._fn(state, feats))

  def _features(self, features) -> Any:
    return tree.map_structure(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self._device),
        features)

  def _compile_bucket(self, bucket: int):
    """Captures (or finds) the bucket's graphs and RETURNS them: callers
    dispatch the returned entry, not a re-read of the table."""
    with self._compile_lock:
      if self._released:
        raise RuntimeError(_RELEASED)
      entry = self._compiled.get(bucket)
      if entry is not None:
        return entry  # benign race to the warmup thread
      example = self._features(bucketing.pad_batch(self._example_row,
                                                   bucket))
      graphs = tuple(
          StepGraph(self._slot_fn(), slot, example, self._device,
                    num_generators=int(self._takes_rng), carries=False,
                    own_carry=False)
          for slot in self._slots)
      entry = graphs + (threading.Lock(),)
      self._compiled = {**self._compiled, bucket: entry}
      self.compile_count += 1
      return entry

  def warmup(self) -> float:
    """Captures every bucket and runs each once on the example row;
    returns wall seconds. After it returns no request size ≤ max_batch
    meets a capture."""
    generator = self._generator(0)
    t0 = time.perf_counter()
    for bucket in self._table:
      tb = time.perf_counter()
      if self._graphs:
        self._compile_bucket(bucket)
      self._dispatch(bucketing.pad_batch(self._example_row, bucket),
                     bucket, generator)
      self.bucket_warmup_seconds[bucket] = time.perf_counter() - tb
    self.warmup_seconds = time.perf_counter() - t0
    return self.warmup_seconds

  def warmup_async(self) -> threading.Thread:
    """Starts `warmup()` on a background thread; requests arriving
    meanwhile are served (a captured bucket at once, another after its
    capture). Idempotent: a second call returns the live thread."""
    if self._warmup_thread is None:
      def _run():
        try:
          self.warmup()
        except BaseException as e:  # surfaced by wait_warmup()
          self._warmup_error = e

      self._warmup_thread = threading.Thread(
          target=_run, name="engine-warmup", daemon=True)
      self._warmup_thread.start()
    return self._warmup_thread

  def wait_warmup(self) -> float:
    """Joins an async warmup; returns its wall seconds. Re-raises the
    warmup's error on EVERY join. 0.0 if `warmup_async` never ran."""
    if self._warmup_thread is None:
      return 0.0
    self._warmup_thread.join()
    if self._warmup_error is not None:
      raise self._warmup_error
    return self.warmup_seconds

  def _generator(self, seed: int) -> torch.Generator:
    return torch.Generator(device=self._device).manual_seed(seed)

  # ---- params hot-swap ----

  @property
  def publication(self) -> _Published:
    """(state, version, learner_step, slot) as ONE atomic read."""
    return self._published

  @property
  def params_version(self) -> int:
    return self._published.version

  @property
  def params_learner_step(self) -> int:
    return self._published.learner_step

  def swap_state(self, new_state: Any,
                 learner_step: Optional[int] = None) -> None:
    """Publishes new params (same structure) through the idle slot.

    The lock only serializes concurrent swappers; dispatches never take
    it. Waits until no dispatch reads the idle slot (none can start on
    it: it is not published), writes it, waits for the copy, publishes.
    Each swap bumps `params_version`; `learner_step` stamps the
    publication (kept from the previous one when omitted).
    """
    with self._swap_lock:
      if self._released:
        raise RuntimeError(_RELEASED)
      previous = self._published
      target = 1 - previous.slot
      with self._slot_cv:
        self._slot_cv.wait_for(lambda: self._readers[target] == 0)
      slot = self._slots[target]
      copy_into(tensors(slot), tensors(acting_params(new_state).to(self._device)))
      synchronize(self._device)
      self._published = _Published(
          slot, version=previous.version + 1,
          learner_step=(previous.learner_step if learner_step is None
                        else int(learner_step)),
          slot=target)
      self.swap_count += 1
    telemetry.event("serving.swap_state",
                    version=self._published.version,
                    learner_step=self._published.learner_step)
    self._tm_swaps.inc()

  # ---- the hot path ----

  def _dispatch(self, padded, bucket: int, generator):
    """Runs one padded batch on the published slot: (host numpy outputs,
    the publication they were computed on). The slot is held (counted
    as read) until the outputs are on the host."""
    with self._slot_cv:
      published = self._published  # one read: old or new, never mixed
      if published.state is None:
        raise RuntimeError(_RELEASED)
      self._readers[published.slot] += 1
    try:
      feats = self._features(padded)
      if not self._graphs:
        args = (generator,) if self._takes_rng else ()
        outputs = self._fn(published.state, feats, *args)
      else:
        entry = self._compiled.get(bucket) or self._compile_bucket(bucket)
        graph = entry[published.slot]
        with entry[2]:
          if self._takes_rng:
            own = graph.generators[0]
            if generator is None:
              own.seed()
            else:
              own.set_state(generator.get_state())
          outputs = graph.replay(feats)
          if self._takes_rng and generator is not None:
            generator.set_state(own.get_state())
      return tree.map_structure(lambda t: t.detach().cpu().numpy(),
                                outputs), published
    finally:
      with self._slot_cv:
        self._readers[published.slot] -= 1
        self._slot_cv.notify_all()

  def predict(self, features: Any,
              generator: Optional[torch.Generator] = None) -> Any:
    """One bucketed dispatch; returns host numpy outputs, unpadded."""
    return self.predict_versioned(features, generator)[0]

  def predict_versioned(self, features: Any,
                        generator: Optional[torch.Generator] = None):
    """`predict`, and the `_Published` params generation it ran on."""
    if self._released:
      raise RuntimeError(_RELEASED)
    n = int(np.asarray(tree.leaves(features)[0]).shape[0])
    bucket = bucketing.bucket_for(n, self._table)
    t0 = time.perf_counter()
    with telemetry.span("serving.dispatch", bucket=bucket, rows=n):
      outputs, published = self._dispatch(
          bucketing.pad_batch(features, bucket), bucket, generator)
    hist = self._tm_bucket_ms.get(bucket)
    if hist is None:
      hist = self._tm_bucket_ms[bucket] = tmetrics.histogram(
          f"{self._metric_prefix}bucket_{bucket}_ms")
    hist.observe((time.perf_counter() - t0) * 1e3)
    self.dispatch_count += 1
    self.dispatches_per_bucket[bucket] = (
        self.dispatches_per_bucket.get(bucket, 0) + 1)
    self._tm_dispatches.inc()
    return bucketing.unpad_batch(outputs, n), published
