"""Kernel build cache and its watch (the part of the JAX package's
`startup/compile_cache.py` that the serving arena needs).

The JAX package keeps compiled XLA executables in a persistent cache and
proves a warm start by `CompileWatch().cache_misses == 0`. The port has
two kinds of compiled code:

  * the hand-written CUDA kernels, built by `nvcc` into the build
    directory (`ops/build.py`, `cache_dir()`), named by a hash of their
    sources and flags, and loaded once per process;
  * CUDA graphs (`utils/step_graph.py`), which cannot be saved and
    loaded again: every new engine captures its buckets anew
    (`BucketedServingEngine.compile_count`).

So here `cache_misses` counts the `nvcc` builds that ran inside the
watch and `cache_hits` the kernel libraries a build found already
built. A reload of an evicted tenant captures its graphs again and
builds no kernel: `cache_misses == 0` on a reload is the port's form of
the JAX reload contract. Every build also counts in the registry
(``compile_cache.misses`` / ``compile_cache.hits``).
"""

from __future__ import annotations

import threading
from typing import List

from tensor2robot_tpu_torch.ops import build as build_lib
from tensor2robot_tpu_torch.telemetry import metrics as tmetrics


def cache_dir() -> str:
  """The directory the kernel libraries are built into and found in."""
  return str(build_lib.BUILD_DIR)


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

  def __enter__(self) -> "CompileWatch":
    with type(self)._lock:
      type(self)._active.append(self)
    return self

  def __exit__(self, *exc) -> bool:
    with type(self)._lock:
      type(self)._active.remove(self)
    return False


build_lib.add_build_listener(CompileWatch._on_build)
