"""Serving: bucketed engine, micro-batcher, the CEM policy server, and
the multi-tenant plane (port of `serving/`).

  * `bucketing` — powers-of-two batch buckets and batch-dim padding.
  * `engine.BucketedServingEngine` — one CUDA graph per bucket over two
    params slots, hot-swapped without a mixed dispatch.
  * `microbatcher.MicroBatcher` — coalesces concurrent `predict()`
    calls into one dispatch.
  * `cem_policy.CEMPolicyServer` — the QT-Opt action-selection entry.

The multi-tenant front:

  * `arena.ModelArena` — many models over one device: a budgeted pool
    of engines with LRU eviction and reloads that build no kernel.
  * `admission.AdmissionController` — per-tenant token-bucket rate and
    bounded queues, SLO reports off the telemetry histograms.
  * `front.ServingFront` — ONE continuous-batching dispatcher over
    every tenant's queue, round-robin.
  * `speculative.SpeculativeCEM` — the 1-iteration CEM answer now, the
    full answer refined behind it, never across a hot-swap.
  * `dedup.ObservationDedupCache` — quantized-observation hash + params
    version → cached action.

The replicated tier:

  * `router.ServingRouter` — rendezvous-hash tenant placement over N
    front replicas, with failover inside the call and the dedup cache.
"""

from tensor2robot_tpu_torch.serving.bucketing import (
    bucket_for,
    bucket_table,
    pad_batch,
    unpad_batch,
)
from tensor2robot_tpu_torch.serving.engine import BucketedServingEngine
from tensor2robot_tpu_torch.serving.microbatcher import MicroBatcher
from tensor2robot_tpu_torch.serving.cem_policy import CEMPolicyServer
from tensor2robot_tpu_torch.serving.admission import (
    AdmissionController,
    RequestRejected,
    TenantPolicy,
)
from tensor2robot_tpu_torch.serving.arena import ModelArena
from tensor2robot_tpu_torch.serving.front import ServingFront
from tensor2robot_tpu_torch.serving.dedup import (
    ObservationDedupCache,
    observation_key,
)
from tensor2robot_tpu_torch.serving.speculative import SpeculativeCEM
from tensor2robot_tpu_torch.serving.router import (
    NoReplicasError,
    ServingRouter,
)

__all__ = [
    "AdmissionController",
    "BucketedServingEngine",
    "CEMPolicyServer",
    "MicroBatcher",
    "ModelArena",
    "NoReplicasError",
    "ObservationDedupCache",
    "RequestRejected",
    "ServingFront",
    "ServingRouter",
    "SpeculativeCEM",
    "TenantPolicy",
    "bucket_for",
    "bucket_table",
    "observation_key",
    "pad_batch",
    "unpad_batch",
]
