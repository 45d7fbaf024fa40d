"""ReplayBuffer (port of `research/qtopt/replay_buffer.py`): the thin
adapter over the replay store — `add` / `sample` / `as_stream` /
`wait_until_size` and the store's metrics — with the JAX adapter's
error messages. With one shard and uniform sampling it samples the rows
the JAX buffer samples, bit for bit, for the same seed and adds.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.replay import ReplayBatchSampler, ReplayStore
from tensor2robot_tpu_torch.specs import TensorSpecStruct


@gin.configurable
class ReplayBuffer:
  """Uniform-sampling ring buffer API over `ReplayStore`."""

  def __init__(self, transition_spec: TensorSpecStruct,
               capacity: int = 100_000, seed: int = 0,
               num_shards: int = 1, sampling: str = "uniform",
               spill_dir: Optional[str] = None):
    self._store = ReplayStore(
        transition_spec, capacity=capacity, num_shards=num_shards,
        seed=seed, sampling=sampling, spill_dir=spill_dir)
    self._stream_sampler: Optional[ReplayBatchSampler] = None

  def __len__(self) -> int:
    return len(self._store)

  @property
  def capacity(self) -> int:
    return self._store.capacity

  @property
  def store(self) -> ReplayStore:
    return self._store

  def add(self, transitions, priority: Optional[float] = None) -> None:
    """Appends a BATCH of transitions (dict/struct of [N, ...] arrays)."""
    self._store.add(transitions, priority=priority)

  def sample(self, batch_size: int) -> TensorSpecStruct:
    """Seeded random batch (an empty buffer raises)."""
    try:
      return self._store.sample(batch_size)
    except ValueError as e:
      raise ValueError(
          "Cannot sample from an empty replay buffer.") from e

  def as_stream(self, batch_size: int) -> Iterator[TensorSpecStruct]:
    """Infinite sampling stream; its sampler is kept so
    `metrics_scalars` / `staleness_snapshot` report its staleness."""
    self._stream_sampler = ReplayBatchSampler(self._store, batch_size)
    return iter(self._stream_sampler)

  def wait_until_size(self, min_size: int,
                      timeout_secs: Optional[float] = None) -> bool:
    """Blocks until `min_size` transitions are buffered (actor warmup)."""
    return self._store.wait_until_size(min_size, timeout_secs)

  def set_learner_step(self, step: int) -> None:
    """Tags subsequent adds with the learner step (staleness source)."""
    self._store.set_learner_step(step)

  def metrics_scalars(self, prefix: str = "replay_") -> Dict[str, float]:
    """Store fill/throughput + stream staleness, for the train log."""
    out = self._store.metrics_scalars(prefix=prefix)
    if self._stream_sampler is not None:
      out.update(self._stream_sampler.metrics_scalars(prefix=prefix))
    return out

  def staleness_snapshot(self) -> Optional[Dict[str, object]]:
    if self._stream_sampler is None:
      return None
    return self._stream_sampler.staleness_snapshot()
