"""Kernel build cache, its configuration and its watch (port of the
JAX package's `startup/compile_cache.py`).

The JAX package keeps compiled XLA executables in a persistent cache
(`configure_compilation_cache`, gin-configurable) and proves a warm start
by `CompileWatch().cache_misses == 0`. The port has two kinds of compiled
code:

  * the hand-written CUDA kernels, built by `nvcc` into the build
    directory (`ops/build.py`, `cache_dir()`), named by a hash of their
    sources and flags, and loaded once per process;
  * CUDA graphs (`utils/step_graph.py`), which cannot be saved and
    loaded again: every new engine captures its buckets anew
    (`BucketedServingEngine.compile_count`).

So the persistent cache here is the kernel build directory:
`configure_compilation_cache(cache_dir)` points it at `cache_dir` (or at
`T2R_COMPILATION_CACHE_DIR`), and a kernel not built there yet builds
once into it. A library already loaded in the process stays loaded.
`cache_misses` counts the `nvcc` builds that ran inside the watch and
`cache_hits` the kernel libraries a build found already built. A reload
of an evicted tenant captures its graphs again and builds no kernel:
`cache_misses == 0` on a reload is the port's form of the JAX reload
contract. Every build also counts in the registry
(``compile_cache.misses`` / ``compile_cache.hits``).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional

from tensor2robot_tpu_torch import config as gin
from tensor2robot_tpu_torch.ops import build as build_lib
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics

log = logging.getLogger(__name__)

ENV_CACHE_DIR = "T2R_COMPILATION_CACHE_DIR"

_configured_dir: Optional[str] = None


def cache_dir() -> str:
  """The directory the kernel libraries are built into and found in."""
  return str(build_lib.BUILD_DIR)


@gin.configurable
def configure_compilation_cache(cache_dir: Optional[str] = None
                                ) -> Optional[str]:
  """Points the kernel build directory at `cache_dir`.

  Idempotent and safe to call from every entry point. Unconfigured (no
  argument, no gin binding, no `T2R_COMPILATION_CACHE_DIR`) it leaves
  the build directory as it is and returns None. The environment
  variable is a default, not an override: once a caller has configured
  a directory, a later call without one keeps it. Configured, it makes
  the directory and returns it. The JAX function's size and time
  thresholds have no counterpart: every kernel build is kept.
  """
  global _configured_dir
  if not cache_dir:
    if _configured_dir is not None:
      return _configured_dir
    cache_dir = os.environ.get(ENV_CACHE_DIR)
  if not cache_dir:
    return None
  cache_dir = os.path.abspath(cache_dir)
  os.makedirs(cache_dir, exist_ok=True)
  if cache_dir != _configured_dir:
    build_lib.set_build_dir(cache_dir)
    _configured_dir = cache_dir
    log.info("Kernel build cache at %s", cache_dir)
  return cache_dir


def cache_entry_count(cache_dir: str) -> int:
  """Number of kernel libraries built into `cache_dir` (one
  `lib<name>-<hash>.so` per source, header and flag hash)."""
  if not os.path.isdir(cache_dir):
    return 0
  return sum(1 for name in os.listdir(cache_dir)
             if name.startswith("lib") and name.endswith(".so"))


class CompileWatch:
  """Counts kernel builds (misses) and already-built libraries (hits)
  while the watch is open::

      with CompileWatch() as watch:
        ...  # everything that might build a kernel
      assert watch.cache_misses == 0

  Nested and concurrent watches each see every build in their window.
  """

  _lock = threading.Lock()
  _active: List["CompileWatch"] = []

  def __init__(self):
    self.cache_hits = 0
    self.cache_misses = 0

  @classmethod
  def _on_build(cls, name: str, built: bool) -> None:
    tmetrics.counter("compile_cache.misses" if built
                     else "compile_cache.hits").inc()
    with cls._lock:
      for watch in cls._active:
        if built:
          watch.cache_misses += 1
        else:
          watch.cache_hits += 1

  def counts(self) -> dict:
    """The JAX watch's fields: `cache_requests` is the kernel libraries
    asked for, `backend_compiles` the `nvcc` builds among them (=
    `cache_misses`)."""
    return {
        "cache_hits": self.cache_hits,
        "cache_misses": self.cache_misses,
        "cache_requests": self.cache_hits + self.cache_misses,
        "backend_compiles": self.cache_misses,
    }

  def __enter__(self) -> "CompileWatch":
    with type(self)._lock:
      type(self)._active.append(self)
    return self

  def __exit__(self, *exc) -> bool:
    with type(self)._lock:
      type(self)._active.remove(self)
    return False


build_lib.add_build_listener(CompileWatch._on_build)
