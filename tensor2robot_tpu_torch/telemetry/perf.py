"""Live performance attribution and resource watermarks (port of
`telemetry/perf.py`).

  * `mfu_value`: the one MFU formula, achieved FLOP/s over the per-card
    peak times the device count. The trainers' live ``perf.mfu`` gauges
    call it with the FLOPs of `utils.profiling`.
  * `PerfMeter`: per train loop, wraps each dispatch in the telemetry
    span while adding up its host wall time, and at log cadence
    publishes ``perf.mfu``, ``perf.flops_per_sec`` and
    ``perf.device_time_fraction`` into the registry and the record.
    ``perf.device_time_fraction`` is the share of the interval the host
    spent inside dispatch calls, as in JAX (whose dispatch is
    asynchronous too): on a CUDA graph replay that is the launch plus any
    wait the card's queue imposes, not the card's busy time, and no
    synchronize is added to make it so (that would change the loop's
    pacing).
  * `ResourceSampler`: a daemon thread publishing ``rsrc.*`` gauges and
    their ``_peak`` watermarks: host RSS (``/proc/self/status``), the
    sources given (`utils.profiling.device_memory_source`), and the
    peaks of watched registry gauges. A source that raises is logged and
    skipped, never raised out.

One switch turns the plane off: `set_plane_enabled(False)` or
``T2R_PERF_PLANE=0`` (the JAX package's meaning); it turns the alert
sentinel (`telemetry.sentinel`) off with it. This module reads no device
itself: device sources arrive as callables.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

from tensor2robot_tpu_torch.telemetry import core
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

log = logging.getLogger(__name__)

# Registry gauges the sampler tracks peak watermarks for (fill/queue
# depths whose PEAK is the capacity-planning signal; the live values
# are already published at their event sites).
DEFAULT_WATCHED_GAUGES = (
    "replay.fill",
    "replay.ingest_queue_depth",
    "serving.arena.resident_bytes",
    "serving.microbatch_queue_depth",
)

_PLANE_ENV = "T2R_PERF_PLANE"
_plane_enabled: Optional[bool] = None
_plane_lock = threading.Lock()


def plane_enabled() -> bool:
  """Whether the always-on perf plane (live gauges, resource sampler)
  is active in this process. Default on; ``T2R_PERF_PLANE=0`` or
  `set_plane_enabled(False)` disables it."""
  global _plane_enabled
  if _plane_enabled is None:
    _plane_enabled = os.environ.get(_PLANE_ENV, "1") not in (
        "0", "false", "off")
  return _plane_enabled


def set_plane_enabled(enabled: Optional[bool]) -> None:
  """Overrides the plane switch (None = re-read the environment)."""
  global _plane_enabled
  _plane_enabled = enabled


def mfu_value(steps_per_sec: float,
              flops_per_step: Optional[float],
              peak_flops: Optional[float],
              devices: int = 1) -> Optional[float]:
  """Model FLOPs utilization: achieved / (per-card peak × devices).

  The one MFU formula: `utils.profiling.mfu` and `PerfMeter.publish`
  (the live gauges) both call it. None when the peak or the FLOPs are
  unknown (a CPU with no ``T2R_PEAK_FLOPS_OVERRIDE``).
  """
  if not peak_flops or not flops_per_step:
    return None
  return steps_per_sec * flops_per_step / (peak_flops * max(devices, 1))


class PerfMeter:
  """Per-process live performance attribution (one per train loop).

  Usage (the three trainers):

      meter = perf.PerfMeter(flops_per_step=..., peak_flops=...,
                             devices=D)
      ...
      with meter.dispatch("qtopt.dispatch", step=step):  # = span + timer
        state, metrics = train_step(...)
      ...
      scalars.update(meter.publish(grad_steps_per_sec, interval_secs))

  ``flops_per_step`` is the model FLOPs of one global train step
  (`utils.profiling`; pod trainers multiply their per-device count by
  D); ``devices`` scales the peak so ``perf.mfu`` stays the per-card
  fraction of peak. ``perf.device_time_fraction`` is the share of the
  log interval the host spent inside dispatch calls: on a CUDA graph
  replay, the launch plus any wait for room in the card's queue (the
  stall and input-wait fractions decompose the rest).
  """

  def __init__(self,
               flops_per_step: Optional[float] = None,
               peak_flops: Optional[float] = None,
               devices: int = 1,
               registry: Optional[tmetrics.MetricsRegistry] = None,
               enabled: Optional[bool] = None):
    self.flops_per_step = flops_per_step
    self.peak_flops = peak_flops
    self.devices = max(int(devices), 1)
    self._registry = registry or tmetrics.registry()
    self.enabled = plane_enabled() if enabled is None else bool(enabled)
    self._busy_secs = 0.0
    self._busy_lock = threading.Lock()

  def dispatch(self, name: str, **args):
    """The dispatch's telemetry span and busy-time accounting in one
    context manager."""
    return _DispatchSpan(self, core.span(name, **args))

  def _add_busy(self, secs: float) -> None:
    with self._busy_lock:
      self._busy_secs += secs

  def publish(self, steps_per_sec: float,
              interval_secs: float) -> Dict[str, float]:
    """Publishes the interval's perf gauges; returns them as scalars
    for the trainer's `metrics_<tag>.jsonl` record. Resets the busy
    accumulator (one call per log interval)."""
    with self._busy_lock:
      busy, self._busy_secs = self._busy_secs, 0.0
    if not self.enabled:
      return {}
    out: Dict[str, float] = {}
    out["perf.device_time_fraction"] = min(
        max(busy / max(interval_secs, 1e-9), 0.0), 1.0)
    if self.flops_per_step:
      out["perf.flops_per_sec"] = steps_per_sec * self.flops_per_step
    util = mfu_value(steps_per_sec, self.flops_per_step,
                     self.peak_flops, devices=self.devices)
    if util is not None:
      out["perf.mfu"] = util
    self._registry.gauge("perf.device_time_fraction").set(
        out["perf.device_time_fraction"])
    if "perf.flops_per_sec" in out:
      self._registry.gauge("perf.flops_per_sec").set(
          out["perf.flops_per_sec"])
    if "perf.mfu" in out:
      self._registry.gauge("perf.mfu").set(out["perf.mfu"])
    return out


class _DispatchSpan:
  """Context manager pairing a telemetry span with busy accounting."""

  __slots__ = ("_meter", "_span", "_t0")

  def __init__(self, meter: PerfMeter, span: Any):
    self._meter = meter
    self._span = span

  def __enter__(self) -> "_DispatchSpan":
    self._t0 = time.monotonic()
    self._span.__enter__()
    return self

  def __exit__(self, exc_type, exc, tb) -> bool:
    self._span.__exit__(exc_type, exc, tb)
    self._meter._add_busy(time.monotonic() - self._t0)
    return False


def host_rss_source() -> Callable[[], Dict[str, float]]:
  """Resident-set-size source from ``/proc/self/status`` (no psutil
  dependency; yields nothing on hosts without procfs)."""

  def sample() -> Dict[str, float]:
    try:
      with open("/proc/self/status") as f:
        for line in f:
          if line.startswith("VmRSS:"):
            kb = float(line.split()[1])
            return {"host_rss_bytes": kb * 1024.0}
    except (OSError, ValueError, IndexError):
      pass
    return {}

  return sample


class ResourceSampler:
  """Daemon sampler thread publishing ``rsrc.*`` gauges + watermarks.

  Every period it runs each source callable (dict name → value; a
  failing source is logged once and skipped, never raises out), sets
  ``rsrc.<name>`` and the peak watermark ``rsrc.<name>_peak``, and
  mirrors the peak of each watched registry gauge as
  ``rsrc.<gauge>_peak``. It only reads registry gauges and sets its
  own (each metric's lock guards a few arithmetic operations).
  """

  def __init__(self,
               sources: Sequence[Callable[[], Dict[str, float]]] = (),
               watched_gauges: Iterable[str] = DEFAULT_WATCHED_GAUGES,
               period_secs: float = 1.0,
               registry: Optional[tmetrics.MetricsRegistry] = None):
    self._sources = list(sources) or [host_rss_source()]
    self._watched = tuple(watched_gauges)
    self._period = max(float(period_secs), 0.05)
    self._registry = registry or tmetrics.registry()
    self._peaks: Dict[str, float] = {}
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self.samples = 0

  def _publish(self, name: str, value: float) -> None:
    self._registry.gauge(f"rsrc.{name}").set(value)
    peak = self._peaks.get(name)
    if peak is None or value > peak:
      self._peaks[name] = value
      self._registry.gauge(f"rsrc.{name}_peak").set(value)

  def sample_once(self) -> None:
    """One sampling pass (also the test seam)."""
    for source in self._sources:
      try:
        values = source()
      except Exception:  # noqa: BLE001 — sampling must never raise
        log.warning("resource source %r failed; skipping", source,
                    exc_info=True)
        continue
      for name, value in (values or {}).items():
        self._publish(str(name), float(value))
    if self._watched:
      gauges = self._registry.snapshot().get("gauges", {})
      for name in self._watched:
        if name in gauges:
          value = float(gauges[name])
          peak = self._peaks.get(name)
          if peak is None or value > peak:
            self._peaks[name] = value
            self._registry.gauge(f"rsrc.{name}_peak").set(value)
    self.samples += 1

  def _run(self) -> None:
    while not self._stop.wait(self._period):
      try:
        self.sample_once()
      except Exception:  # noqa: BLE001 — the thread must outlive bugs
        log.warning("resource sampling pass failed", exc_info=True)

  def start(self) -> "ResourceSampler":
    """Starts the thread; the first pass runs before this returns, so
    the gauges exist from a trainer's first record on."""
    if self._thread is None:
      self.sample_once()
      self._thread = threading.Thread(
          target=self._run, name="t2r-rsrc-sampler", daemon=True)
      self._thread.start()
    return self

  def close(self, timeout_secs: float = 2.0) -> None:
    self._stop.set()
    thread, self._thread = self._thread, None
    if thread is not None:
      thread.join(timeout=timeout_secs)


_SAMPLER: Optional[ResourceSampler] = None


def start_resource_sampler(
    sources: Sequence[Callable[[], Dict[str, float]]] = (),
    period_secs: float = 1.0) -> Optional[ResourceSampler]:
  """Starts (or returns) the process-wide resource sampler. Idempotent
  per process: the first caller's sources win (one sampler per process).
  No-op returning None while the plane is disabled."""
  global _SAMPLER
  if not plane_enabled():
    return None
  with _plane_lock:
    if _SAMPLER is None:
      _SAMPLER = ResourceSampler(
          sources=list(sources) + [host_rss_source()],
          period_secs=period_secs).start()
      # Joined at interpreter exit, before teardown: a device-memory
      # source must not be mid-call while the interpreter tears down.
      atexit.register(stop_resource_sampler)
  return _SAMPLER


def stop_resource_sampler() -> None:
  """Stops the process-wide sampler (tests / clean teardown)."""
  global _SAMPLER
  with _plane_lock:
    sampler, _SAMPLER = _SAMPLER, None
  if sampler is not None:
    sampler.close()
