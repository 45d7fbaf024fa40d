"""Overlapped startup phases: compile ∥ restore ∥ input spin-up (port of
`startup/orchestrator.py`).

A cold start has independent serial costs that touch disjoint
resources: on the card, the CUDA context and the kernel libraries the
network launches (the JAX package's AOT compile), the checkpoint
restore (disk and a host-to-device copy), and the input pipeline's
spin-up. `run_overlapped` starts named thunks together on threads,
joins them all, records each one's wall time, and reports failures only
after every phase has finished, so a half-started phase never leaks a
worker thread or a prefetcher holding device buffers.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Mapping, Optional

log = logging.getLogger(__name__)

STARTUP_TIMINGS_FILE = "startup_timings.json"


@dataclasses.dataclass
class StartupReport:
  """Outcome of one `run_overlapped` call."""

  mode: str                      # "overlapped" | "serial"
  results: Dict[str, Any]        # phase name → thunk return value
  seconds: Dict[str, float]      # phase name → wall seconds
  total_seconds: float           # wall of the whole join
  errors: Dict[str, BaseException] = dataclasses.field(
      default_factory=dict)      # phase name → what it raised

  def raise_first(self, order=None) -> None:
    """Re-raises the first failed phase (in `order`, default insertion)."""
    for name in (order or self.errors):
      if name in self.errors:
        raise self.errors[name]

  @property
  def serial_seconds(self) -> float:
    """What the same phases would have cost back-to-back."""
    return sum(self.seconds.values())

  @property
  def overlap_saved_seconds(self) -> float:
    return max(self.serial_seconds - self.total_seconds, 0.0)

  def as_dict(self) -> dict:
    return {
        "mode": self.mode,
        "phase_seconds": {k: round(v, 4) for k, v in
                          self.seconds.items()},
        "total_seconds": round(self.total_seconds, 4),
        "serial_seconds": round(self.serial_seconds, 4),
        "overlap_saved_seconds": round(self.overlap_saved_seconds, 4),
    }

  def write(self, model_dir: str) -> str:
    """Writes the report to `<model_dir>/startup_timings.json`."""
    path = os.path.join(model_dir, STARTUP_TIMINGS_FILE)
    with open(path, "w") as f:
      json.dump(self.as_dict(), f, indent=2)
    return path


def run_overlapped(phases: Mapping[str, Callable[[], Any]],
                   overlap: bool = True) -> StartupReport:
  """Runs named startup thunks concurrently (or serially) and joins all.

  Args:
    phases: {name: zero-arg thunk}. Thunks must be independent — no
      phase may read another's result (pass data through the returned
      report instead).
    overlap: False runs the phases back-to-back in dict order: the
      serial path, kept selectable so the equivalence is testable.

  Returns a StartupReport; failures land in `report.errors` (never
  raised here) so the caller can release any sibling phase's
  resources — e.g. a prefetcher pinning device buffers — before
  calling `report.raise_first()`.
  """
  results: Dict[str, Any] = {}
  seconds: Dict[str, float] = {}
  errors: Dict[str, BaseException] = {}

  def run_one(name: str, fn: Callable[[], Any]) -> None:
    t0 = time.perf_counter()
    try:
      results[name] = fn()
    except BaseException as e:  # re-raised below, never swallowed
      errors[name] = e
    finally:
      seconds[name] = time.perf_counter() - t0

  t_start = time.perf_counter()
  if overlap:
    threads = [
        threading.Thread(target=run_one, args=(name, fn),
                         name=f"startup-{name}", daemon=True)
        for name, fn in phases.items()
    ]
    for t in threads:
      t.start()
    for t in threads:
      t.join()
  else:
    for name, fn in phases.items():
      run_one(name, fn)
  total = time.perf_counter() - t_start

  report = StartupReport(
      mode="overlapped" if overlap else "serial",
      results=results, seconds=seconds, total_seconds=total,
      errors=errors)
  if errors:
    return report
  log.info(
      "Startup (%s): %s → %.2fs wall (serial sum %.2fs, saved %.2fs)",
      report.mode,
      ", ".join(f"{k}={v:.2f}s" for k, v in seconds.items()),
      total, report.serial_seconds, report.overlap_saved_seconds)
  return report


def close_quietly(obj: Optional[Any]) -> None:
  """Best-effort close of a phase result during error unwinding."""
  if obj is None:
    return
  close = getattr(obj, "close", None)
  if close is None:
    return
  try:
    close()
  except Exception:  # already unwinding a real error
    log.warning("close() failed during startup unwinding", exc_info=True)
