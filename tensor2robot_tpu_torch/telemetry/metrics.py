"""Process-wide metrics registry: counters, gauges, histograms (port of
`telemetry/metrics.py`).

One registry per process and a fixed snapshot schema; the port's
serving plane publishes into it at its event sites (engine dispatches
and swaps, per-bucket latency, micro-batcher queue depth and rows,
arena loads and evictions, admission verdicts, front completions,
dedup and speculative counters). The bucket bounds, the quantile
arithmetic and the schema are the JAX module's, so the same
observations give the same snapshot. It is a separate registry object
from the JAX package's: a process that imports both never shares a
metric between them.

Snapshot schema::

    {"counters":   {name: float},          # monotonic totals
     "gauges":     {name: float},          # last-set values
     "histograms": {name: {"bounds": [...], "counts": [...],
                           "count": n, "sum": s, "min": lo,
                           "max": hi, "p50": ..., "p95": ...}}}

Thread-safety: each metric guards its few arithmetic ops with its own
lock; nothing blocking ever runs under one.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

# Default histogram bounds: latency in MILLISECONDS, log-spaced from
# sub-bucket dispatches to multi-second stalls. Values above the last
# bound land in the overflow bucket.
DEFAULT_MS_BOUNDS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                     50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
                     5000.0, 10000.0)
# For step-denominated distributions (lag, staleness).
DEFAULT_STEP_BOUNDS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                       128.0, 256.0, 512.0, 1024.0, 4096.0)


class Counter:
  """Monotonic total. `inc` only — resets happen by registry reset."""

  __slots__ = ("_lock", "value")

  def __init__(self):
    self._lock = threading.Lock()
    self.value = 0.0

  def inc(self, n: float = 1.0) -> None:
    with self._lock:
      self.value += n


class Gauge:
  """Last-set value (fill fractions, queue depths, rates)."""

  __slots__ = ("_lock", "value")

  def __init__(self):
    self._lock = threading.Lock()
    self.value = 0.0

  def set(self, value: float) -> None:
    with self._lock:
      self.value = float(value)


class Histogram:
  """Fixed-bound histogram with running count/sum/min/max.

  ``bounds`` are inclusive upper edges; one overflow bucket catches
  everything above the last bound. Quantiles are estimated from the
  bucket counts (linear interpolation inside the winning bucket), the
  standard Prometheus-style read: exact enough for p50/p95 dashboards
  at these bucket densities.
  """

  __slots__ = ("_lock", "bounds", "counts", "count", "sum",
               "min", "max")

  def __init__(self, bounds: Sequence[float] = DEFAULT_MS_BOUNDS):
    self._lock = threading.Lock()
    self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
    self.counts = [0] * (len(self.bounds) + 1)
    self.count = 0
    self.sum = 0.0
    self.min: Optional[float] = None
    self.max: Optional[float] = None

  def observe(self, value: float, n: int = 1) -> None:
    """Records `value` with weight `n` (e.g. a per-commit lag applies
    to every row of the commit — n=rows keeps the distribution
    row-weighted without n bisects)."""
    value = float(value)
    index = bisect.bisect_left(self.bounds, value)
    with self._lock:
      self.counts[index] += n
      self.count += n
      self.sum += value * n
      if self.min is None or value < self.min:
        self.min = value
      if self.max is None or value > self.max:
        self.max = value

  def quantile(self, q: float) -> float:
    """Bucket-interpolated quantile; 0.0 on an empty histogram."""
    with self._lock:
      counts = list(self.counts)
      total = self.count
      hi = self.max
    if not total:
      return 0.0
    rank = q * total
    seen = 0
    for index, bucket_count in enumerate(counts):
      if seen + bucket_count >= rank:
        if index == len(self.bounds):  # overflow bucket
          return float(hi)
        lo = self.bounds[index - 1] if index else 0.0
        up = self.bounds[index]
        if not bucket_count:
          return up
        frac = (rank - seen) / bucket_count
        return lo + (up - lo) * min(max(frac, 0.0), 1.0)
      seen += bucket_count
    return float(hi)

  def snapshot(self) -> Dict[str, object]:
    with self._lock:
      snap = {
          "bounds": list(self.bounds),
          "counts": list(self.counts),
          "count": int(self.count),
          "sum": float(self.sum),
          "min": self.min,
          "max": self.max,
      }
    snap["p50"] = self.quantile(0.5)
    snap["p95"] = self.quantile(0.95)
    return snap


class MetricsRegistry:
  """Name → metric table with get-or-create accessors and the fixed
  snapshot schema. The registry lock guards only dict lookups; metric
  updates take the metric's own lock."""

  def __init__(self):
    self._lock = threading.Lock()
    self._counters: Dict[str, Counter] = {}
    self._gauges: Dict[str, Gauge] = {}
    self._histograms: Dict[str, Histogram] = {}

  def counter(self, name: str) -> Counter:
    with self._lock:
      metric = self._counters.get(name)
      if metric is None:
        metric = self._counters[name] = Counter()
    return metric

  def gauge(self, name: str) -> Gauge:
    with self._lock:
      metric = self._gauges.get(name)
      if metric is None:
        metric = self._gauges[name] = Gauge()
    return metric

  def histogram(self, name: str,
                bounds: Sequence[float] = DEFAULT_MS_BOUNDS
                ) -> Histogram:
    with self._lock:
      metric = self._histograms.get(name)
      if metric is None:
        metric = self._histograms[name] = Histogram(bounds)
    return metric

  def snapshot(self) -> Dict[str, Dict[str, object]]:
    """The full registry in the fixed schema (see module docstring)."""
    with self._lock:
      counters = dict(self._counters)
      gauges = dict(self._gauges)
      histograms = dict(self._histograms)
    return {
        "counters": {n: float(c.value) for n, c in counters.items()},
        "gauges": {n: float(g.value) for n, g in gauges.items()},
        "histograms": {n: h.snapshot() for n, h in histograms.items()},
    }

  def scalars(self, prefix: str = "") -> Dict[str, float]:
    """The flat-scalar cut, shaped for `metrics_<tag>.jsonl` payloads:
    counters/gauges as-is, histograms as `<name>_{p50,p95,count}`.
    ``prefix`` filters by metric-name prefix."""
    return scalars_from_snapshot(self.snapshot(), name_filter=prefix)

  def reset(self) -> None:
    with self._lock:
      self._counters.clear()
      self._gauges.clear()
      self._histograms.clear()


def scalars_from_snapshot(snapshot: Dict[str, Dict[str, object]],
                          prefix: str = "",
                          name_filter: str = "") -> Dict[str, float]:
  """Flattens a registry `snapshot()` to scalars, optionally
  prepending ``prefix`` to every key and keeping only names starting
  with ``name_filter``: counters and gauges as they are, each histogram
  with a count as `<name>_{p50,p95,count}`."""
  out: Dict[str, float] = {}
  for name, value in snapshot.get("counters", {}).items():
    if name.startswith(name_filter):
      out[prefix + name] = float(value)
  for name, value in snapshot.get("gauges", {}).items():
    if name.startswith(name_filter):
      out[prefix + name] = float(value)
  for name, hist in snapshot.get("histograms", {}).items():
    if name.startswith(name_filter) and hist.get("count"):
      out[f"{prefix}{name}_p50"] = float(hist["p50"])
      out[f"{prefix}{name}_p95"] = float(hist["p95"])
      out[f"{prefix}{name}_count"] = float(hist["count"])
  return out


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
  """The process-wide registry every subsystem publishes into."""
  return _REGISTRY


def counter(name: str) -> Counter:
  return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
  return _REGISTRY.gauge(name)


def histogram(name: str,
              bounds: Sequence[float] = DEFAULT_MS_BOUNDS) -> Histogram:
  return _REGISTRY.histogram(name, bounds)


def reset_for_tests() -> None:
  _REGISTRY.reset()
