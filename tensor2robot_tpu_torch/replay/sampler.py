"""Streaming sampler (port of `replay/sampler.py`): store → fixed-wire-
spec batches, with the measured sampling staleness.

`ReplayBatchSampler` is an infinite iterator of `TensorSpecStruct`
batches in the store's wire spec. Every batch's per-row age (learner
step at sample minus learner step at add, from the store's
`set_learner_step` tag) lands in a fixed-bucket histogram that the
trainer logs beside its own metrics. With `record_schedule` it also
keeps a running SHA-256 over the exact global row ids drawn: two seeded
runs must give equal digests (the success protocol's seedcheck).

The module also holds the cross-shard helpers of the sharded plane
(`shard_fanout_counts`, `concat_shard_major`) and rendezvous hashing
(`rendezvous_*`), whose salt ``"{key}|shard-{i}"`` is the JAX package's
byte for byte.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.replay.store import ReplayStore
from tensor2robot_tpu_torch.specs import TensorSpecStruct

# Fixed bucket EDGES (upper bounds, in learner steps); the last bucket is
# open.
STALENESS_BUCKETS: Tuple[int, ...] = (
    0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384)


@gin.configurable
class ReplayBatchSampler:
  """Infinite fixed-batch sampling stream with staleness accounting."""

  def __init__(self, store: ReplayStore, batch_size: int,
               record_schedule: bool = False):
    self._store = store
    self._batch_size = int(batch_size)
    self._record_schedule = record_schedule
    self._digest = hashlib.sha256()
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

  @property
  def batch_size(self) -> int:
    return self._batch_size

  @property
  def store(self) -> ReplayStore:
    return self._store

  @property
  def wire_spec(self) -> TensorSpecStruct:
    """The fixed wire spec every emitted batch conforms to."""
    return self._store.transition_spec

  def sample(self) -> TensorSpecStruct:
    """One batch; its rows' ages (and, if asked, the schedule)
    recorded."""
    batch, ages, row_ids = self._store.sample_with_ages(self._batch_size)
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
      if self._record_schedule:
        self._digest.update(row_ids.tobytes())
    return batch

  def __iter__(self) -> Iterator[TensorSpecStruct]:
    while True:
      yield self.sample()

  def as_stream(self) -> Iterator[TensorSpecStruct]:
    return iter(self)

  def schedule_digest(self) -> str:
    """SHA-256 over every (shard, slot) drawn so far, in order."""
    if not self._record_schedule:
      raise RuntimeError(
          "schedule recording is off; construct with "
          "record_schedule=True")
    with self._lock:
      return self._digest.hexdigest()

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


def make_stream(store: ReplayStore, batch_size: int,
                record_schedule: bool = False
                ) -> Tuple[Iterator[TensorSpecStruct], ReplayBatchSampler]:
  """(iterator, sampler): the iterator feeds the prefetcher, the sampler
  stays with the trainer for staleness and metrics reads."""
  sampler = ReplayBatchSampler(store, batch_size,
                               record_schedule=record_schedule)
  return iter(sampler), sampler


# ---- cross-shard fan-out ----
#
# A learner batch assembled from per-shard samples: counts proportional
# to shard fill, rows concatenated shard-major (shards in index order),
# the layout of a multi-shard `sample_with_ages` gather.


def shard_fanout_counts(batch_size: int,
                        shard_sizes: Tuple[int, ...]) -> Tuple[int, ...]:
  """Per-shard sample counts, proportional to shard fill: quotas floor,
  and the leftover rows go to the largest fractional remainders (ties
  to the lower shard index). Empty shards draw zero."""
  sizes = [max(0, int(s)) for s in shard_sizes]
  total = sum(sizes)
  if batch_size < 0:
    raise ValueError(f"batch_size must be >= 0, got {batch_size}")
  if total == 0:
    raise ValueError("cannot allocate a sample batch: every shard "
                     "is empty")
  quotas = [batch_size * s / total for s in sizes]
  counts = [int(q) for q in quotas]
  remainders = sorted(
      range(len(sizes)), key=lambda i: (counts[i] - quotas[i], i))
  for i in remainders[:batch_size - sum(counts)]:
    counts[i] += 1
  return tuple(counts)


def concat_shard_major(
    parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
  """Concatenates per-shard flat sample dicts in shard-index order."""
  if not parts:
    raise ValueError("no shard produced rows for this batch")
  if len(parts) == 1:
    return dict(parts[0])
  return {key: np.concatenate([part[key] for part in parts], axis=0)
          for key in parts[0]}


# ---- rendezvous (highest-random-weight) hashing ----


def rendezvous_weight(key: str, bucket: int) -> int:
  """The deterministic pseudo-random weight of (key, bucket)."""
  digest = hashlib.sha256(f"{key}|shard-{bucket}".encode()).digest()
  return int.from_bytes(digest[:8], "big")


def rendezvous_rank(key: str, buckets: Iterable[int]) -> List[int]:
  """Buckets sorted by descending weight for `key`: removing a bucket
  deletes its entry from every key's ranking and changes nothing else."""
  members = sorted(set(int(b) for b in buckets))
  if not members:
    raise ValueError("rendezvous_rank needs at least one bucket")
  return sorted(members,
                key=lambda b: rendezvous_weight(key, b),
                reverse=True)


def rendezvous_choose(key: str, buckets: Iterable[int]) -> int:
  """The highest-weight bucket for `key`."""
  return rendezvous_rank(key, buckets)[0]


def rendezvous_spread(key: str, buckets: Iterable[int],
                      k: int) -> List[int]:
  """The top-`k` buckets for `key` (clamped to the membership size), in
  failover order: index 0 is the home."""
  if k < 1:
    raise ValueError(f"k must be >= 1, got {k}")
  return rendezvous_rank(key, buckets)[:k]
