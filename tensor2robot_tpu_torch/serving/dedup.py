"""Observation-dedup cache: identical frames short-circuit to a
cached action (port of `serving/dedup.py`).

Fleets of robots produce DUPLICATE observations constantly — a parked
arm streams the same camera frame at 10 Hz, and N robots staring at
the same calibration target submit N bitwise-equal requests. Running
the CEM program again for a frame the tier just answered is pure
waste, so the router hashes a QUANTIZED copy of each observation and
serves repeats straight from a bounded cache.

Correctness contract:

  * A hit is BITWISE-EQUAL to the uncached path. The cached value is
    the action the real engine produced for that exact (quantized)
    key under the SAME param version; the engine is deterministic for
    identical input + identical params, so replaying its output is
    indistinguishable from recomputing it.
  * A cached action NEVER crosses a param hot-swap. Every entry is
    stamped with the param version it was computed under; `get` only
    returns an entry whose stamp matches the caller's current
    version, and `invalidate(version)` (called on publish) drops
    every stale entry eagerly so the cache never pins dead actions.

Quantization: float leaves are rounded to `quantize_scale` steps
before hashing (default 1/256 — camera frames are uint8 upstream, so
this is lossless for the deployment pixel path while absorbing
float32 jitter from preprocessing). Integer/bool leaves hash as-is.
Quantization affects only the KEY; the action returned is whatever
the engine computed for the first frame in the equivalence class.

The cache is a plain LRU over `capacity` entries with a lock around a
dict — arithmetic-only critical sections (the CON301 contract); the
expensive part (hashing a frame) happens OUTSIDE the lock.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.telemetry import metrics as tmetrics


def observation_key(features: Any, quantize_scale: float = 256.0
                    ) -> str:
  """The dedup key: sha256 over every leaf's dtype/shape/quantized
  bytes, leaves visited in sorted-name order — the JAX package's digest.

  `features` is anything with `.to_flat_dict()` (TensorSpecStruct) or
  a flat mapping of name → array. A torch leaf hashes as its numpy
  counterpart (dtype name ``uint8``, not ``torch.uint8``), so the same
  observation has one key in both packages.
  """
  flat = (features.to_flat_dict()
          if hasattr(features, "to_flat_dict") else dict(features))
  h = hashlib.sha256()
  for name in sorted(flat):
    leaf = flat[name]
    if isinstance(leaf, torch.Tensor):
      leaf = leaf.detach().cpu().numpy()
    leaf = np.asarray(leaf)
    if np.issubdtype(leaf.dtype, np.floating):
      leaf = np.round(leaf * quantize_scale).astype(np.int64)
    h.update(name.encode())
    h.update(str(leaf.dtype).encode())
    h.update(str(leaf.shape).encode())
    h.update(np.ascontiguousarray(leaf).tobytes())
  return h.hexdigest()


class ObservationDedupCache:
  """Bounded, version-stamped LRU of observation-key → action."""

  def __init__(self, capacity: int = 1024,
               quantize_scale: float = 256.0,
               metric_prefix: str = "serving.dedup."):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    self.capacity = int(capacity)
    self.quantize_scale = float(quantize_scale)
    self._entries: "OrderedDict[str, Tuple[int, Any]]" = OrderedDict()
    self._lock = threading.Lock()
    self._hits = tmetrics.counter(f"{metric_prefix}hits")
    self._misses = tmetrics.counter(f"{metric_prefix}misses")
    self._evictions = tmetrics.counter(f"{metric_prefix}evictions")
    self._invalidated = tmetrics.counter(
        f"{metric_prefix}invalidated")
    self._size = tmetrics.gauge(f"{metric_prefix}size")
    # Telemetry counters are process-global (shared across every cache
    # with this prefix); stats() must describe THIS instance, so keep
    # local tallies beside them.
    self._n = {"hits": 0, "misses": 0, "evictions": 0,
               "invalidated": 0}

  def key(self, features: Any) -> str:
    return observation_key(features, self.quantize_scale)

  def get(self, key: str, version: int) -> Optional[Any]:
    """The cached action, iff one exists AND its param-version stamp
    matches `version` (else None — a stale entry is a miss)."""
    with self._lock:
      entry = self._entries.get(key)
      if entry is not None and entry[0] == version:
        self._entries.move_to_end(key)
        self._hits.inc()
        self._n["hits"] += 1
        return entry[1]
      self._misses.inc()
      self._n["misses"] += 1
      return None

  def put(self, key: str, version: int, action: Any) -> None:
    with self._lock:
      self._entries[key] = (int(version), action)
      self._entries.move_to_end(key)
      while len(self._entries) > self.capacity:
        self._entries.popitem(last=False)
        self._evictions.inc()
        self._n["evictions"] += 1
      self._size.set(len(self._entries))

  def invalidate(self, current_version: Optional[int] = None) -> int:
    """Drops every entry not stamped `current_version` (all entries
    when None). Called on publish; returns the drop count."""
    with self._lock:
      if current_version is None:
        dropped = len(self._entries)
        self._entries.clear()
      else:
        stale = [k for k, (v, _) in self._entries.items()
                 if v != current_version]
        for k in stale:
          del self._entries[k]
        dropped = len(stale)
      self._invalidated.inc(dropped)
      self._n["invalidated"] += dropped
      self._size.set(len(self._entries))
      return dropped

  def stats(self) -> Dict[str, int]:
    with self._lock:
      out = dict(self._n)
      out["size"] = len(self._entries)
      return out
