"""Replay data plane, host side (port of `replay/`): the sharded
ring-buffer store, the ingestion service (bounded queue, per-actor
sessions) and the streaming sampler that feeds the learner."""

from tensor2robot_tpu_torch.replay.sampler import (
    STALENESS_BUCKETS,
    ReplayBatchSampler,
    make_stream,
)
from tensor2robot_tpu_torch.replay.service import (
    ActorIngestSession,
    ReplayWriteService,
)
from tensor2robot_tpu_torch.replay.store import ReplayStore

__all__ = ["ActorIngestSession", "ReplayBatchSampler", "ReplayStore",
           "ReplayWriteService", "STALENESS_BUCKETS", "make_stream"]
