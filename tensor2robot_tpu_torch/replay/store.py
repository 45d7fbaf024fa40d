"""Replay store (port of `replay/store.py`): one ring buffer, uniform
sampling.

The port keeps the JAX store's one-shard uniform path exactly: the same
ring layout and wraparound on add, and one `rng.integers(0, total,
size=batch)` on a `numpy.random.default_rng(seed)` per sample, so the
same seed and adds sample the same rows bit for bit (pinned by
tests/test_torch_qtopt_train.py). Rows are gathered with numpy fancy
indexing (the JAX store's native gather computes `src[idx]` too).
Counters and metrics are this store's own fields.

Not ported yet (ROADMAP A4 rest): more than one shard, "fifo" and
"prioritized" sampling, and the eviction spill (`spill_dir`); each
raises `NotImplementedError`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from tensor2robot_tpu_torch.specs import TensorSpecStruct
from tensor2robot_tpu_torch.specs.random_data import _flatten_specs

SAMPLING_MODES = ("uniform", "fifo", "prioritized")


def to_flat_arrays(transitions: Any) -> Dict[str, np.ndarray]:
  """Transition batch (struct or mapping of arrays/CPU tensors) → flat
  numpy dict."""
  flat = (transitions.to_flat_dict() if isinstance(transitions,
                                                   TensorSpecStruct)
          else dict(transitions))
  return {k: np.asarray(v) for k, v in flat.items()}


class ReplayStore:
  """Capacity-bounded transition ring buffer with seeded sampling."""

  def __init__(self,
               transition_spec: Any,
               capacity: int = 100_000,
               num_shards: int = 1,
               seed: int = 0,
               sampling: str = "uniform",
               spill_dir: Optional[str] = None):
    if sampling not in SAMPLING_MODES:
      raise ValueError(
          f"sampling must be one of {SAMPLING_MODES}, got {sampling!r}")
    if num_shards < 1:
      raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if capacity < num_shards:
      raise ValueError(
          f"capacity {capacity} < num_shards {num_shards}: every shard "
          "needs at least one row.")
    for asked, what in ((num_shards > 1, f"num_shards={num_shards}"),
                        (sampling != "uniform", f"sampling={sampling!r}"),
                        (spill_dir is not None, "spill_dir")):
      if asked:
        raise NotImplementedError(
            f"ReplayStore({what}) is not ported yet (ROADMAP A4 rest): the "
            "port has one shard with uniform sampling.")
    self._flat_spec = _flatten_specs(transition_spec)
    self._capacity = int(capacity)
    self._storage = {key: np.zeros((self._capacity,) + tuple(spec.shape),
                                   dtype=spec.dtype)
                     for key, spec in self._flat_spec.items()}
    self._add_step = np.zeros((self._capacity,), np.int64)
    self._insert = 0
    self._size = 0
    self._rng = np.random.default_rng(seed)
    self._lock = threading.Lock()
    self._learner_step = 0
    self.adds_total = 0          # transitions
    self.samples_total = 0       # transitions
    self.evictions_total = 0
    self._last_snapshot = (time.monotonic(), 0, 0)

  @property
  def capacity(self) -> int:
    return self._capacity

  def __len__(self) -> int:
    return self._size

  # ---- learner-step plumbing (staleness source) ----

  def set_learner_step(self, step: int) -> None:
    """Tags subsequent adds with the learner's current step."""
    self._learner_step = int(step)

  # ---- add path ----

  def add(self, transitions: Any, priority: Optional[float] = None) -> int:
    """Appends a BATCH of transitions ([N, ...] per key); returns N.
    `priority` is accepted and unused (uniform sampling)."""
    flat = to_flat_arrays(transitions)
    for key in self._flat_spec:
      if key not in flat:
        raise KeyError(f"Transition batch missing key {key!r}.")
    if priority is not None and priority < 0:
      raise ValueError(
          f"priority must be >= 0 (got {priority}): negative weights "
          "break the prioritized sampler's cumulative draw.")
    n = int(next(iter(flat.values())).shape[0])
    if n == 0:
      return 0
    if n > self._capacity:  # only the last `capacity` rows can survive
      flat = {k: v[-self._capacity:] for k, v in flat.items()}
      n = self._capacity
    with self._lock:
      start = self._insert
      idx = (start + np.arange(n)) % self._capacity
      evicted = max(0, n - (self._capacity - self._size))
      for key, store in self._storage.items():
        store[idx] = flat[key]
      self._add_step[idx] = self._learner_step
      self._insert = int((start + n) % self._capacity)
      self._size = int(min(self._size + n, self._capacity))
      self.adds_total += n
      self.evictions_total += evicted
    return n

  # ---- sample path ----

  def sample(self, batch_size: int) -> TensorSpecStruct:
    """A batch in the wire spec (metadata dropped)."""
    batch, _, _ = self.sample_with_ages(batch_size)
    return batch

  def sample_with_ages(self, batch_size: int
                       ) -> Tuple[TensorSpecStruct, np.ndarray, np.ndarray]:
    """(batch, ages_in_learner_steps [B], row_ids [B]): one uniform
    draw over the live rows, then one gather per key in draw order."""
    with self._lock:
      if self._size == 0:
        raise ValueError("Cannot sample from an empty replay store.")
      idx = self._rng.integers(0, self._size, size=batch_size)
      out = {key: store[idx] for key, store in self._storage.items()}
      ages = np.maximum(self._learner_step - self._add_step[idx], 0)
      self.samples_total += batch_size
    return TensorSpecStruct.from_flat_dict(out), ages, idx.copy()

  # ---- warmup / metrics ----

  def wait_until_size(self, min_size: int,
                      timeout_secs: Optional[float] = None) -> bool:
    """Blocks until `min_size` transitions are live (actor warmup)."""
    deadline = (time.monotonic() + timeout_secs
                if timeout_secs is not None else None)
    while len(self) < min_size:
      if deadline is not None and time.monotonic() > deadline:
        return False
      time.sleep(0.01)
    return True

  def metrics_snapshot(self) -> Dict[str, float]:
    """Cumulative counters + instantaneous fill."""
    size = len(self)
    return {
        "size": float(size),
        "capacity": float(self._capacity),
        "fill": size / max(self._capacity, 1),
        "num_shards": 1.0,
        "adds_total": float(self.adds_total),
        "samples_total": float(self.samples_total),
        "evictions_total": float(self.evictions_total),
        "spilled_total": 0.0,
        "learner_step": float(self._learner_step),
    }

  def metrics_scalars(self, prefix: str = "replay_") -> Dict[str, float]:
    """Windowed rates since the previous call (one call per log
    interval)."""
    now = time.monotonic()
    t0, adds0, samples0 = self._last_snapshot
    dt = max(now - t0, 1e-9)
    adds, samples = self.adds_total, self.samples_total
    self._last_snapshot = (now, adds, samples)
    size = len(self)
    return {
        f"{prefix}fill": size / max(self._capacity, 1),
        f"{prefix}size": float(size),
        f"{prefix}adds_per_sec": (adds - adds0) / dt,
        f"{prefix}samples_per_sec": (samples - samples0) / dt,
        f"{prefix}evictions_total": float(self.evictions_total),
        f"{prefix}spilled_total": 0.0,
    }
