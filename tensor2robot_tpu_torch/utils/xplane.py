"""Per-op device time from a profiler trace (port of `utils/xplane.py`).

The JAX module decodes the XPlane protos a `jax.profiler` trace writes.
This one reads torch profiler traces instead: the chrome-format
`*.pt.trace.json` files that `utils.profiling.trace` (and
`torch.profiler.tensorboard_trace_handler`) write. The device's events
are the complete events (`"ph": "X"`) of the device categories: `kernel`
(compute), `gpu_memcpy` / `gpu_memset` (copy-engine windows), and
`gpu_user_annotation` (a host annotation's span on the device timeline).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, Iterator, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset",
                     "gpu_user_annotation")
_COMPUTE = "kernel"


def _trace_files(trace_dir: str) -> List[str]:
  return sorted(glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                          recursive=True))


def device_events(trace_dir: str, plane_filter: str = ""
                  ) -> Iterator[Tuple[str, str, float, float]]:
  """(category, name, start µs, duration µs) of every device event whose
  category contains `plane_filter` (case-insensitive), across the trace
  files under `trace_dir`."""
  wanted = plane_filter.lower()
  for path in _trace_files(trace_dir):
    with open(path) as f:
      events = json.load(f).get("traceEvents", [])
    for event in events:
      cat = event.get("cat", "")
      if (event.get("ph") != "X" or cat not in DEVICE_CATEGORIES
          or wanted not in cat.lower()):
        continue
      yield cat, event.get("name", ""), float(event["ts"]), float(
          event.get("dur", 0.0))


def op_times_ms(trace_dir: str, plane_filter: str = "") -> Dict[str, float]:
  """Aggregates device time (ms) by event name across a trace dir: the
  device events whose category contains `plane_filter` (all of them by
  default; "kernel" for compute only)."""
  totals: Dict[str, float] = {}
  for _, name, _, dur in device_events(trace_dir, plane_filter):
    totals[name] = totals.get(name, 0.0) + dur / 1e3
  return totals


_ASYNC_WINDOW = re.compile(r"(Memcpy|Memset)\b")


def is_async_window(name: str) -> bool:
  """True for copy-engine windows (`Memcpy ...`, `Memset ...`).

  Their durations are spans of the copy engines, which overlap compute:
  a table meant to attribute device time to compute must drop them."""
  return bool(_ASYNC_WINDOW.match(name))


def device_busy_ms(trace_dir: str) -> float:
  """Wall time (ms) during which the device ran a kernel, a copy or a
  set: the union of those events' intervals (annotations left out)."""
  spans = sorted((ts, ts + dur) for cat, _, ts, dur in
                 device_events(trace_dir)
                 if cat != "gpu_user_annotation")
  busy, end = 0.0, float("-inf")
  for start, stop in spans:
    if start > end:
      busy += stop - start
      end = stop
    elif stop > end:
      busy += stop - end
      end = stop
  return busy / 1e3


def top_ops(trace_dir: str, k: int = 20, plane_filter: str = "",
            compute_only: bool = False) -> List[Tuple[str, float]]:
  """Top-k (op name, device ms) pairs, descending.

  `compute_only` keeps the kernels alone: it drops copy windows
  (`is_async_window`) and the annotations' spans, which cover other
  events, leaving events whose durations are busy time and sum to about
  the device time of the traced work (the JAX function's `hlo_only`
  has no counterpart: a torch trace has no HLO umbrella spans)."""
  if compute_only:
    totals: Dict[str, float] = {}
    for cat, name, _, dur in device_events(trace_dir, plane_filter):
      if cat == _COMPUTE and not is_async_window(name):
        totals[name] = totals.get(name, 0.0) + dur / 1e3
  else:
    totals = op_times_ms(trace_dir, plane_filter)
  return sorted(totals.items(), key=lambda kv: -kv[1])[:k]
