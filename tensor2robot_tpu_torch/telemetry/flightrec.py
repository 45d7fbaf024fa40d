"""Crash flight recorder (port of `telemetry/flightrec.py`): post-mortem
forensics for fleet failures.

On a latched error, a crash-policy trigger, a sentinel page or hang
detection, a process dumps

  * its span ring (the tracer's last `capacity` spans, kept in memory
    so a crash always has them),
  * its latest metrics-registry snapshot,
  * the trigger reason and its wall/monotonic stamps and clock offset

to ``<model_dir>/flightrec/<role>-<pid>.json``. The file name and the
JSON fields are the JAX package's, so one reader serves both packages'
runs. Learner and actor mains dump in their own except paths; the
orchestrator dumps its own view (latched error and per-child heartbeat
ages) and asks a still-live host to dump over the ``flight_record``
RPC. A hung process cannot dump itself: the orchestrator's dump records
which heartbeat went stale instead.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from tensor2robot_tpu_torch.telemetry import core
from tensor2robot_tpu_torch.telemetry import metrics

DIRNAME = "flightrec"


def flightrec_dir(model_dir: str) -> str:
  """The canonical dump directory of a run (`<model_dir>/flightrec`)."""
  return os.path.join(model_dir, DIRNAME)


def dump(out_dir: str, reason: str,
         extra: Optional[Dict[str, Any]] = None,
         role: Optional[str] = None) -> str:
  """Writes this process's flight record; returns its path.

  Never raises (a failing dump must not mask the error that triggered
  it); returns "" when the write failed. The tracer's file (if any) is
  flushed too, so the run's timeline covers the final spans. ``role``
  overrides the process role (the orchestrator dumps as
  ``orchestrator`` from whatever process supervises the fleet).
  """
  tracer = core.get_tracer()
  role = role or core.current_role()
  record = {
      "reason": str(reason)[:4000],
      "role": role,
      "pid": os.getpid(),
      "wall": time.time(),
      "monotonic": time.monotonic(),
      "clock_offset": tracer.clock_offset,
      "spans": tracer.snapshot_spans(),
      "spans_recorded": tracer.spans_recorded,
      "spans_dropped": tracer.spans_dropped,
      "metrics": metrics.registry().snapshot(),
  }
  if extra:
    record["extra"] = extra
  try:
    tracer.flush()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{role}-{os.getpid()}.json")
    with open(path, "w") as f:
      json.dump(record, f)
    return path
  except OSError:
    return ""


def read_dumps(out_dir: str) -> List[Dict[str, Any]]:
  """All flight records in a dump dir, sorted by wall time."""
  dumps = []
  if not os.path.isdir(out_dir):
    return dumps
  for name in sorted(os.listdir(out_dir)):
    if not name.endswith(".json"):
      continue
    try:
      with open(os.path.join(out_dir, name)) as f:
        dumps.append(json.load(f))
    except (OSError, ValueError):
      continue
  return sorted(dumps, key=lambda d: d.get("wall", 0.0))
