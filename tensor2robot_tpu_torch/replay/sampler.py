"""Streaming sampler (port of `replay/sampler.py`): store → fixed-wire-
spec batches, with the measured sampling staleness.

`ReplayBatchSampler` is an infinite iterator of `TensorSpecStruct`
batches in the store's wire spec. Every batch's per-row age (learner
step at sample minus learner step at add, from the store's
`set_learner_step` tag) lands in a fixed-bucket histogram that the
trainer logs beside its own metrics.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Tuple

import numpy as np

from tensor2robot_tpu_torch.replay.store import ReplayStore
from tensor2robot_tpu_torch.specs import TensorSpecStruct

# Fixed bucket EDGES (upper bounds, in learner steps); the last bucket is
# open.
STALENESS_BUCKETS: Tuple[int, ...] = (
    0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384)


class ReplayBatchSampler:
  """Infinite fixed-batch sampling stream with staleness accounting."""

  def __init__(self, store: ReplayStore, batch_size: int):
    self._store = store
    self._batch_size = int(batch_size)
    self._lock = threading.Lock()
    self._counts = np.zeros(len(STALENESS_BUCKETS) + 1, np.int64)
    self._age_sum = 0
    self._age_max = 0
    self._rows = 0
    self._batches = 0
    # Per-batch mean ages in a fixed ring, so the "recent" p95 tracks
    # the live distribution on long runs.
    self._recent_means = np.zeros(65536, np.float64)
    self._recent_count = 0

  def sample(self) -> TensorSpecStruct:
    """One batch, its rows' ages recorded."""
    batch, ages, _ = self._store.sample_with_ages(self._batch_size)
    with self._lock:
      self._counts += np.bincount(
          np.searchsorted(STALENESS_BUCKETS, ages, side="left"),
          minlength=len(self._counts))[:len(self._counts)]
      self._age_sum += int(ages.sum())
      self._age_max = max(self._age_max, int(ages.max()))
      self._rows += ages.size
      self._batches += 1
      self._recent_means[
          self._recent_count % self._recent_means.size] = ages.mean()
      self._recent_count += 1
    return batch

  def __iter__(self) -> Iterator[TensorSpecStruct]:
    while True:
      yield self.sample()

  def staleness_snapshot(self) -> Dict[str, object]:
    """The measured staleness distribution since construction: bucket
    labels ("<=8", ..., ">16384") → sampled-row counts, ages in learner
    steps."""
    with self._lock:
      labels = [f"<={b}" for b in STALENESS_BUCKETS] + [
          f">{STALENESS_BUCKETS[-1]}"]
      hist = {label: int(c) for label, c in zip(labels, self._counts)}
      mean = self._age_sum / self._rows if self._rows else 0.0
      live = self._recent_means[
          :min(self._recent_count, self._recent_means.size)]
      p95 = float(np.percentile(live, 95)) if live.size else 0.0
      return {
          "histogram": hist,
          "mean_age_steps": mean,
          "max_age_steps": self._age_max,
          "batch_mean_age_p95_steps": p95,
          "rows": self._rows,
          "batches": self._batches,
      }

  def metrics_scalars(self, prefix: str = "replay_") -> Dict[str, float]:
    """The scalar cut of the snapshot, shaped for the train log."""
    snap = self.staleness_snapshot()
    return {
        f"{prefix}staleness_mean_steps": float(snap["mean_age_steps"]),
        f"{prefix}staleness_max_steps": float(snap["max_age_steps"]),
        f"{prefix}staleness_batch_p95_steps": float(
            snap["batch_mean_age_p95_steps"]),
        f"{prefix}sampled_batches": float(snap["batches"]),
    }
