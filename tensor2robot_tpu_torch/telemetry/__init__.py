"""Telemetry: the span tracer, the metrics registry, the metrics-record
envelope and the perf plane (ports of the JAX package's
`telemetry/core.py`, `metrics.py`, `records.py` and `perf.py`; the rest
of that package is ROADMAP A13)."""

from tensor2robot_tpu_torch.telemetry import core
from tensor2robot_tpu_torch.telemetry import metrics
from tensor2robot_tpu_torch.telemetry import perf
from tensor2robot_tpu_torch.telemetry import records
from tensor2robot_tpu_torch.telemetry.core import (
    clock_offset_from_handshake,
    configure,
    current_role,
    event,
    get_tracer,
    span,
)
from tensor2robot_tpu_torch.telemetry.metrics import registry

__all__ = [
    "clock_offset_from_handshake",
    "configure",
    "core",
    "current_role",
    "event",
    "get_tracer",
    "metrics",
    "perf",
    "records",
    "registry",
    "span",
]
