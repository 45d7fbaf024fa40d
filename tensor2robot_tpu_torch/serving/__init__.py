"""Serving: bucketed engine, micro-batcher and the CEM policy server."""

from tensor2robot_tpu_torch.serving.cem_policy import CEMPolicyServer
from tensor2robot_tpu_torch.serving.engine import BucketedServingEngine
from tensor2robot_tpu_torch.serving.microbatcher import MicroBatcher

__all__ = ["BucketedServingEngine", "CEMPolicyServer", "MicroBatcher"]
