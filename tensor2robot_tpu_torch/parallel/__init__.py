"""Parallelism (port of `parallel/`). Only the single-device attention
oracle so far; the mesh, the ring and MoE wait for ROADMAP A11."""

from tensor2robot_tpu_torch.parallel.ring_attention import (
    attention_reference,
)

__all__ = ["attention_reference"]
