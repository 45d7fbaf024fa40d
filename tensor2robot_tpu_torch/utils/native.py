"""Host row gather and scatter (port of `utils/native.py`), through the
port's own copy of the C++ source, `native/gather.cc`.

`gather_rows` and `scatter_rows` compute `src[idx]` and `dst[idx] = src`
along axis 0, with the rows' memcpys striped across threads that run
without the interpreter lock. The library is compiled with g++ on first
use into `tensor2robot_tpu_torch/_build/libt2r_gather-<hash>.so`, where
the hash covers the source and the flags, by way of a per-process
temporary file renamed into place (processes racing on a fresh checkout
never load a half-written library).

A failed build is not silent: the first call that needs the library
raises `NativeBuildError` with the compiler's stderr, every later call
raises it again, and `load_error()` returns the message. numpy serves
only what the native path does not take: arrays that are not
C-contiguous, and empty ones (`_rows_ok`).

One default differs from the JAX package's: `num_threads` is 1, not 0
(one thread per core, the C++ rule, still there for the asking). The
library starts its threads on every call, and on the H100's host (8
cores) that cost more than the copy it shared: a B=256 gather of the
Bellman transition took 6.2 ms at 0 against 1.3 ms at 1 (numpy's fancy
index 1.1 ms, holding the interpreter lock that the library releases),
and the replay-fed Bellman loop ran 149 grad steps/s against 185–194
with numpy's gather before (`chip_smoke.py` phases 14 and 22;
`PERF.md` §6). At one thread the call is still ~0.1 ms slower than
numpy's index, and releasing the interpreter lock did not pay for it
end to end: the online protocol's learner ran ~5% fewer grad steps/s
with it than with numpy's index in the store (`chip_smoke.py`'s
`_online_gather_ab`, H100 host, 8 cores).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "gather.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None


class NativeBuildError(RuntimeError):
  """The gather library did not build or load; the message holds why."""


def library_path() -> Path:
  """Where the library builds to: named by a hash of the source and
  the flags."""
  digest = hashlib.sha256(SOURCE.read_bytes())
  digest.update(" ".join(CXX_FLAGS).encode())
  return BUILD_DIR / f"libt2r_gather-{digest.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
  cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
  try:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
  except (OSError, subprocess.SubprocessError) as e:
    raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
  if out.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise NativeBuildError(
        f"{' '.join(cmd)} exited {out.returncode}:\n{out.stderr}")
  os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
  """The library, built if needed; raises `NativeBuildError` if it did
  not build or load (and again on every later call)."""
  global _LIB, _ERROR
  with _LOCK:
    if _LIB is not None:
      return _LIB
    if _ERROR is not None:
      raise NativeBuildError(_ERROR)
    try:
      path = library_path()
      if not path.exists():
        _build(path)
      lib = ctypes.CDLL(str(path))
    except (NativeBuildError, OSError) as e:
      _ERROR = str(e)
      raise NativeBuildError(_ERROR) from e
    for fn in (lib.t2r_gather_rows, lib.t2r_scatter_rows):
      fn.restype = None
      fn.argtypes = [
          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
          ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
      ]
    _LIB = lib
    return _LIB


def load_error() -> Optional[str]:
  """Why the library failed to build or load; None if it has not
  failed."""
  return _ERROR


def native_available() -> bool:
  """Whether the library loads (building it if needed)."""
  try:
    load_library()
  except NativeBuildError:
    return False
  return True


def _rows_ok(arr: np.ndarray) -> bool:
  return arr.flags.c_contiguous and arr.size > 0


def _checked_index(idx: np.ndarray, n: int) -> np.ndarray:
  """`idx` as int64 with negative entries wrapped; raises IndexError as
  numpy would on an out-of-range entry (the memcpy must never see one)."""
  idx = np.ascontiguousarray(idx, dtype=np.int64)
  if idx.size:
    lo, hi = int(idx.min()), int(idx.max())
    if lo < -n or hi >= n:
      raise IndexError(
          f"index {hi if hi >= n else lo} is out of bounds for axis 0 "
          f"with size {n}")
    if lo < 0:
      idx = np.where(idx < 0, idx + n, idx)
  return idx


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: Optional[np.ndarray] = None,
                num_threads: int = 1) -> np.ndarray:
  """out[i] = src[idx[i]] along axis 0, striped over `num_threads`
  threads started for the call (0: one per core; transfers under 1 MB
  use one).

  Matches `src[idx]` exactly, negative indices and the IndexError on an
  out-of-range one included. `out` (optional) is a preallocated batch
  buffer of the right shape and dtype.
  """
  idx = _checked_index(idx, src.shape[0])
  if out is None:
    out = np.empty((idx.shape[0],) + src.shape[1:], dtype=src.dtype)
  elif (out.shape != (idx.shape[0],) + src.shape[1:]
        or out.dtype != src.dtype):
    # Checked before the memcpy: a too-small or reinterpreted buffer
    # must raise, not be written past its end.
    raise ValueError(
        f"gather_rows: out shape/dtype {out.shape}/{out.dtype} does "
        f"not match {(idx.shape[0],) + src.shape[1:]}/{src.dtype}.")
  if not (_rows_ok(src) and _rows_ok(out)):
    np.take(src, idx, axis=0, out=out)
    return out
  row_bytes = int(src.dtype.itemsize * np.prod(src.shape[1:], dtype=np.int64))
  load_library().t2r_gather_rows(
      src.ctypes.data_as(ctypes.c_void_p),
      idx.ctypes.data_as(ctypes.c_void_p),
      out.ctypes.data_as(ctypes.c_void_p),
      ctypes.c_int64(idx.shape[0]), ctypes.c_int64(row_bytes),
      ctypes.c_int32(num_threads))
  return out


def scatter_rows(dst: np.ndarray, idx: np.ndarray, src: np.ndarray,
                 num_threads: int = 1) -> None:
  """dst[idx[i]] = src[i] along axis 0, striped like `gather_rows`.

  `idx` must not repeat a row (a ring buffer's batched add writes
  distinct slots). Shape and bounds mismatches raise as the numpy
  assignment would.
  """
  src = np.asarray(src)
  if src.shape != (len(idx),) + dst.shape[1:]:
    raise ValueError(
        f"scatter_rows: src shape {src.shape} does not match "
        f"{(len(idx),) + dst.shape[1:]} (len(idx), dst row shape).")
  idx = _checked_index(idx, dst.shape[0])
  if not (_rows_ok(dst) and _rows_ok(src)):
    dst[idx] = src
    return
  src = np.ascontiguousarray(src, dtype=dst.dtype)
  row_bytes = int(dst.dtype.itemsize * np.prod(dst.shape[1:], dtype=np.int64))
  load_library().t2r_scatter_rows(
      src.ctypes.data_as(ctypes.c_void_p),
      idx.ctypes.data_as(ctypes.c_void_p),
      dst.ctypes.data_as(ctypes.c_void_p),
      ctypes.c_int64(idx.shape[0]), ctypes.c_int64(row_bytes),
      ctypes.c_int32(num_threads))
