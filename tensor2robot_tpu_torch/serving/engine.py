"""Bucketed serving engine (port of `serving/engine.py`).

One `BucketedServingEngine` owns what is shape-dependent about the hot
path and the params it serves:

  * powers-of-two batch buckets with last-row padding; `warmup()` runs
    each bucket once eagerly (kernel builds, cuDNN autotuning and the
    allocator's first growth land there, not in a robot's control
    tick) and records its seconds;
  * ONE device-resident state shared by every bucket;
  * lock-free hot-swap: `swap_state` moves the new state to the device,
    waits for the copy, then publishes it with a single reference
    assignment of a `_Published(state, version, learner_step)` tuple.
    A dispatch reads the tuple once, so it sees entirely-old or
    entirely-new params, never a mix.

Per-bucket CUDA graphs, telemetry spans/metrics and the persistent
compile cache of the JAX engine come in later slices (ROADMAP A7).

`fn(state, features[, generator])` takes tensors with a leading batch
dim on the engine's device and returns a tensor (or a tree of them)
with the same leading dim.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.device import resolve_device, synchronize
from tensor2robot_tpu_torch.serving import bucketing
from tensor2robot_tpu_torch.utils import tree

_RELEASED = ("BucketedServingEngine was released; build a new engine "
             "to serve again.")


class _Published(NamedTuple):
  """One atomically-published params generation: the state, its
  monotonic version (0 = construction-time params) and the learner
  step it was published at (the `param_refresh_lag` stamp)."""

  state: Any
  version: int
  learner_step: int


def _state_bytes(state: Any) -> int:
  """Bytes of the acting params (a TrainState's, or a QTOptState's
  online TrainState's)."""
  return getattr(state, "train_state", state).nbytes


class BucketedServingEngine:
  """Serves `fn` over powers-of-two batch buckets on one device."""

  def __init__(self,
               fn: Callable,
               state: Any,
               example_features: Any,
               max_batch: int = 8,
               takes_rng: bool = False,
               device=None):
    """Args:
      fn: `(state, features)` or `(state, features, generator)`.
      state: params holder with `.to(device)` (a `TrainState` or a
        `QTOptState`); moved to the device here and pinned.
      example_features: a features tree with ANY leading batch dim —
        its first row seeds `warmup()`.
      max_batch: largest servable request; the bucket table covers it.
      takes_rng: whether `fn` takes a `torch.Generator` (CEM policies).
      device: where the state lives and `fn` runs; None = CUDA.
    """
    self._device = resolve_device(device)
    self._fn = fn
    self._takes_rng = takes_rng
    self._table = bucketing.bucket_table(max_batch)
    self._example_row = tree.map_structure(
        lambda a: np.asarray(a)[:1], example_features)
    placed = self._place(state)
    self._state_bytes = _state_bytes(placed)
    self._published = _Published(placed, version=0, learner_step=0)
    self._released = False
    self._swap_lock = threading.Lock()
    self.warmup_seconds: float = 0.0
    self.bucket_warmup_seconds: Dict[int, float] = {}
    self.dispatch_count = 0
    self.dispatches_per_bucket: Dict[int, int] = {}
    self.swap_count = 0

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
  def state_bytes(self) -> int:
    """Device bytes of the pinned state (constant: swaps keep shapes)."""
    return self._state_bytes

  @property
  def released(self) -> bool:
    return self._released

  def _place(self, state: Any) -> Any:
    placed = state.to(self._device)
    synchronize(self._device)  # published only once fully on device
    return placed

  def release(self) -> None:
    """Retires the engine: drops its reference to the state. A dispatch
    in flight keeps its own reference and completes on the old params;
    later `predict`/`swap_state` calls raise. Idempotent."""
    with self._swap_lock:
      if self._released:
        return
      self._released = True
      self._published = _Published(None, version=-1, learner_step=-1)

  # ---- warmup ----

  def warmup(self) -> float:
    """Runs every bucket once on the example row; returns wall seconds."""
    generator = self._generator(0)
    t0 = time.perf_counter()
    for bucket in self._table:
      tb = time.perf_counter()
      self._run(self._published.state,
                bucketing.pad_batch(self._example_row, bucket), generator)
      synchronize(self._device)
      self.bucket_warmup_seconds[bucket] = time.perf_counter() - tb
    self.warmup_seconds = time.perf_counter() - t0
    return self.warmup_seconds

  def _generator(self, seed: int) -> torch.Generator:
    return torch.Generator(device=self._device).manual_seed(seed)

  # ---- params hot-swap ----

  @property
  def publication(self) -> _Published:
    """(state, version, learner_step) as ONE atomic read."""
    return self._published

  @property
  def params_version(self) -> int:
    return self._published.version

  @property
  def params_learner_step(self) -> int:
    return self._published.learner_step

  def swap_state(self, new_state: Any,
                 learner_step: Optional[int] = None) -> None:
    """Publishes a fully-materialized new state (lock-free reads).

    The lock only serializes concurrent swappers. Each swap bumps
    `params_version`; `learner_step` stamps the publication (kept from
    the previous one when omitted).
    """
    with self._swap_lock:
      if self._released:
        raise RuntimeError(_RELEASED)
      placed = self._place(new_state)
      previous = self._published
      self._published = _Published(
          placed, version=previous.version + 1,
          learner_step=(previous.learner_step if learner_step is None
                        else int(learner_step)))
      self.swap_count += 1

  # ---- the hot path ----

  def _run(self, state, features, generator):
    feats = tree.map_structure(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self._device),
        features)
    if self._takes_rng:
      return self._fn(state, feats, generator)
    return self._fn(state, feats)

  def predict(self, features: Any,
              generator: Optional[torch.Generator] = None) -> Any:
    """One bucketed dispatch; returns host numpy outputs, unpadded."""
    if self._released:
      raise RuntimeError(_RELEASED)
    n = int(np.asarray(tree.leaves(features)[0]).shape[0])
    bucket = bucketing.bucket_for(n, self._table)
    padded = bucketing.pad_batch(features, bucket)
    state = self._published.state  # one read: old or new, never mixed
    if state is None:
      raise RuntimeError(_RELEASED)
    outputs = self._run(state, padded, generator)
    outputs = tree.map_structure(lambda t: t.detach().cpu().numpy(),
                                 outputs)
    self.dispatch_count += 1
    self.dispatches_per_bucket[bucket] = (
        self.dispatches_per_bucket.get(bucket, 0) + 1)
    return bucketing.unpad_batch(outputs, n)
