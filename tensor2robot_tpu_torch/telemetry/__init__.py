"""Telemetry: the span tracer, the metrics registry, the metrics-record
envelope, the perf plane, the alert sentinel, the crash flight recorder
and the tools that read a run (ports of the JAX package's
`telemetry/`):

  * `merge` (``python -m tensor2robot_tpu_torch.telemetry.merge``) folds
    every process's ``trace_<role>.jsonl`` into one Chrome/Perfetto
    timeline;
  * `report` (``python -m tensor2robot_tpu_torch.telemetry.report``)
    renders one run directory as a markdown/JSON page;
  * `prometheus` serves the registry as a Prometheus scrape endpoint.
"""

from tensor2robot_tpu_torch.telemetry import core
from tensor2robot_tpu_torch.telemetry import flightrec
from tensor2robot_tpu_torch.telemetry import merge
from tensor2robot_tpu_torch.telemetry import metrics
from tensor2robot_tpu_torch.telemetry import perf
from tensor2robot_tpu_torch.telemetry import prometheus
from tensor2robot_tpu_torch.telemetry import records
from tensor2robot_tpu_torch.telemetry import report
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
    "merge",
    "metrics",
    "perf",
    "prometheus",
    "records",
    "registry",
    "report",
    "sentinel",
    "span",
]
