"""Telemetry: the span tracer, the metrics registry, the metrics-record
envelope, the perf plane, the alert sentinel and the crash flight
recorder (ports of the JAX package's `telemetry/core.py`, `metrics.py`,
`records.py`, `perf.py`, `sentinel.py` and `flightrec.py`; `merge.py`,
`report.py` and `prometheus.py` are ROADMAP A13 rest)."""

from tensor2robot_tpu_torch.telemetry import core
from tensor2robot_tpu_torch.telemetry import flightrec
from tensor2robot_tpu_torch.telemetry import metrics
from tensor2robot_tpu_torch.telemetry import perf
from tensor2robot_tpu_torch.telemetry import records
from tensor2robot_tpu_torch.telemetry import sentinel
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
    "flightrec",
    "get_tracer",
    "metrics",
    "perf",
    "records",
    "registry",
    "sentinel",
    "span",
]
