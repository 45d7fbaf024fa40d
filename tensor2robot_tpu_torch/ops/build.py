"""Builds and loads the port's CUDA kernels (nvcc → shared lib → ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC

into `tensor2robot_tpu_torch/_build/lib<name>-<hash>.so`, where the hash
covers the source, the headers in `csrc/` and the flags: an edited
source or header builds anew, an unchanged one loads the library
already there. Nothing is built at import time. `build(names)` starts
one nvcc per source, all at once.

No build or first load runs inside a CUDA-graph capture: `load` raises
there. `utils.step_graph` runs its step once before it captures, which
builds and loads every library the step calls (and makes each
library's once-per-process calls: shared-memory opt-ins, the SM count,
the driver's tensor-map entry point).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
# Called with (name, built) for each kernel `build` is asked for: built
# True when nvcc ran, False when the library was already there
# (`startup.compile_cache.CompileWatch` counts them).
_BUILD_LISTENERS: List[Callable[[str, bool], None]] = []


def set_build_dir(path) -> None:
  """Builds and finds the kernel libraries in `path` from now on
  (`startup.compile_cache.configure_compilation_cache`); a library
  already loaded in the process stays loaded."""
  global BUILD_DIR
  with _LOCK:
    BUILD_DIR = Path(path)


def add_build_listener(listener: Callable[[str, bool], None]) -> None:
  _BUILD_LISTENERS.append(listener)


def _notify(name: str, built: bool) -> None:
  for listener in _BUILD_LISTENERS:
    listener(name, built)


def nvcc_path() -> str:
  found = shutil.which("nvcc")
  if found:
    return found
  default = "/usr/local/cuda/bin/nvcc"
  if os.path.exists(default):
    return default
  raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                     "CUDA kernels build only where the CUDA toolkit is.")


def library_path(name: str) -> Path:
  """Where `csrc/<name>.cu` builds to: named by a hash of the source, of
  every header in `csrc/` (any may be included) and of the flags."""
  digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
  for header in sorted(CSRC_DIR.glob("*.cuh")):
    digest.update(header.name.encode() + header.read_bytes())
  digest.update(" ".join(NVCC_FLAGS).encode())
  return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str], ptxas_verbose: bool = False,
          logs: Dict[str, str] = None) -> Dict[str, float]:
  """Compiles every listed kernel whose library is missing, one nvcc
  each, all started together. Returns wall seconds per name (0.0 when
  already built). `ptxas_verbose` prints registers/smem/spills; `logs`,
  when given, receives each compiled name's compiler output."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  started = {}
  seconds = {}
  try:
    for name in names:
      out = library_path(name)
      if out.exists():
        seconds[name] = 0.0
        _notify(name, False)
        continue
      tmp = out.with_suffix(f".{os.getpid()}.tmp")
      cmd = [nvcc_path(), *NVCC_FLAGS,
             *(("-Xptxas", "-v") if ptxas_verbose else ()),
             "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
      started[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in started.items():
      log, _ = proc.communicate()
      seconds[name] = time.perf_counter() - t0
      if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
      if ptxas_verbose and log:
        print(log, end="")
      if logs is not None:
        logs[name] = log
      os.replace(tmp, out)  # atomic: a concurrent builder sees old or new
      _notify(name, True)
  finally:
    for proc, tmp, _, _ in started.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()
      if tmp.exists():
        tmp.unlink()
  return seconds


def load(name: str, argtypes: Dict[str, Sequence] = None) -> ctypes.CDLL:
  """The kernel library `name`, built if needed; loaded once per process.

  `argtypes` maps C function → (restype, [argtypes...]).
  """
  with _LOCK:
    lib = _LOADED.get(name)
    if lib is None:
      import torch
      if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"kernel library {name!r} would be built and loaded inside a "
            "CUDA-graph capture; run the step once before capturing it.")
      build([name])
      lib = ctypes.CDLL(str(library_path(name)))
      for fn, (restype, args) in (argtypes or {}).items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = list(args)
      _LOADED[name] = lib
    return lib
