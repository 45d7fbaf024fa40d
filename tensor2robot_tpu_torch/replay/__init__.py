"""Replay data plane, host side: the ring-buffer store and the streaming
sampler that feeds the learner (one shard, uniform sampling so far)."""

from tensor2robot_tpu_torch.replay.sampler import (
    STALENESS_BUCKETS,
    ReplayBatchSampler,
)
from tensor2robot_tpu_torch.replay.store import ReplayStore

__all__ = ["ReplayBatchSampler", "ReplayStore", "STALENESS_BUCKETS"]
