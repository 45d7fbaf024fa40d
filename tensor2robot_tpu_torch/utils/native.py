"""Host row gather and scatter (port of `utils/native.py`), through the
port's own copy of the C++ source, `native/gather.cc`; and the data
plane's host codec, `native/codec.cc`: CRC-32C, PNG row unfiltering and
the baseline JPEG codec.

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

The codec library (`libt2r_codec-<hash>.so`) builds and fails the same
way, on its own: `crc32c` and `png_unfilter` raise `NativeBuildError`
on every call when it did not build (`codec_load_error()`), and never
fall back to their plain versions, `crc32c_plain` and
`png_unfilter_plain`, which exist for the tests.
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
CODEC_SOURCE = _PKG / "native" / "codec.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERROR: Optional[str] = None
_CODEC_LIB: Optional[ctypes.CDLL] = None
_CODEC_ERROR: Optional[str] = None


class NativeBuildError(RuntimeError):
  """A native library did not build or load; the message holds why."""


def _library_path(source: Path, name: str) -> Path:
  digest = hashlib.sha256(source.read_bytes())
  digest.update(" ".join(CXX_FLAGS).encode())
  return BUILD_DIR / f"libt2r_{name}-{digest.hexdigest()[:16]}.so"


def library_path() -> Path:
  """Where the gather library builds to: named by a hash of the source
  and the flags."""
  return _library_path(SOURCE, "gather")


def codec_library_path() -> Path:
  """Where the codec library builds to (named as the gather's is)."""
  return _library_path(CODEC_SOURCE, "codec")


def _build(path: Path, source: Path) -> None:
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
  cmd = ["g++", *CXX_FLAGS, str(source), "-o", str(tmp)]
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
        _build(path, SOURCE)
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


# ---- the codec library ----


def load_codec() -> ctypes.CDLL:
  """The codec library, built if needed; raises `NativeBuildError` if
  it did not build or load (and again on every later call)."""
  global _CODEC_LIB, _CODEC_ERROR
  with _LOCK:
    if _CODEC_LIB is not None:
      return _CODEC_LIB
    if _CODEC_ERROR is not None:
      raise NativeBuildError(_CODEC_ERROR)
    try:
      path = codec_library_path()
      if not path.exists():
        _build(path, CODEC_SOURCE)
      lib = ctypes.CDLL(str(path))
    except (NativeBuildError, OSError) as e:
      _CODEC_ERROR = str(e)
      raise NativeBuildError(_CODEC_ERROR) from e
    for fn in (lib.t2r_crc32c, lib.t2r_crc32c_sw):
      fn.restype = ctypes.c_uint32
      fn.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_int64]
    lib.t2r_crc32c_hw.restype = ctypes.c_int32
    lib.t2r_crc32c_hw.argtypes = []
    lib.t2r_png_unfilter.restype = ctypes.c_int64
    lib.t2r_png_unfilter.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64]
    lib.t2r_jpeg_info.restype = ctypes.c_int32
    lib.t2r_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int64]
    lib.t2r_jpeg_decode_many.restype = ctypes.c_int64
    lib.t2r_jpeg_decode_many.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_char_p, ctypes.c_int64])
    lib.t2r_jpeg_encode.restype = ctypes.c_int64
    lib.t2r_jpeg_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64]
    _CODEC_LIB = lib
    return _CODEC_LIB


def codec_load_error() -> Optional[str]:
  """Why the codec library failed to build or load; None if it has not
  failed."""
  return _CODEC_ERROR


def crc32c(data: bytes, crc: int = 0, hardware: bool = True) -> int:
  """CRC-32C (Castagnoli) of `data`, continuing from `crc`: by the
  SSE4.2 instruction where the CPU has it and `hardware`, else by
  slice-by-8 tables."""
  lib = load_codec()
  fn = lib.t2r_crc32c if hardware else lib.t2r_crc32c_sw
  return fn(crc, bytes(data), len(data))


def crc32c_uses_hardware() -> bool:
  return bool(load_codec().t2r_crc32c_hw())


def _crc32c_table():
  table = []
  for i in range(256):
    c = i
    for _ in range(8):
      c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    table.append(c)
  return table


_CRC32C_TABLE = _crc32c_table()


def crc32c_plain(data: bytes, crc: int = 0) -> int:
  """`crc32c` a byte at a time in Python (for the tests)."""
  crc ^= 0xFFFFFFFF
  for byte in bytes(data):
    crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ byte) & 0xFF]
  return crc ^ 0xFFFFFFFF


def _frame_table(frames) -> np.ndarray:
  table = np.ascontiguousarray(frames, dtype=np.int64).reshape(-1, 5)
  if table.size and (table[:, 2:] < 0).any():
    raise ValueError("png_unfilter: negative frame geometry")
  return table


def _check_bounds(src: np.ndarray, dst: np.ndarray, table: np.ndarray):
  """The memcpy must never see a frame outside its buffers."""
  height, row_bytes = table[:, 2], table[:, 3]
  if table.size and (
      (table[:, 0] < 0).any() or (table[:, 1] < 0).any()
      or (table[:, 0] + height * (1 + row_bytes) > src.size).any()
      or (table[:, 1] + height * row_bytes > dst.size).any()
      or (table[:, 4] < 1).any()):
    raise ValueError("png_unfilter: a frame lies outside its buffers")


def png_unfilter(src: np.ndarray, frames, dst: np.ndarray) -> None:
  """Unfilters PNG scanlines of many frames in one native call.

  `src` and `dst` are contiguous uint8 buffers; `frames` is an int64
  `[n, 5]` table of (src offset, dst offset, height, row bytes, bytes
  per pixel): frame i's `height` filtered rows (a filter-type byte, then
  `row bytes`) start at its src offset, and its pixels land at its dst
  offset. A filter type outside 0..4 raises ValueError naming the frame.
  """
  table = _frame_table(frames)
  if src.dtype != np.uint8 or dst.dtype != np.uint8 or not (
      src.flags.c_contiguous and dst.flags.c_contiguous):
    raise ValueError("png_unfilter: src and dst must be contiguous uint8")
  _check_bounds(src, dst, table)
  lib = load_codec()
  cols = [np.ascontiguousarray(table[:, i]) for i in range(5)]
  bad = lib.t2r_png_unfilter(
      src.ctypes.data, cols[0].ctypes.data, dst.ctypes.data,
      cols[1].ctypes.data, cols[2].ctypes.data, cols[3].ctypes.data,
      cols[4].ctypes.data, len(table))
  if bad < 0:
    raise ValueError(f"PNG frame {-bad - 1}: invalid scanline filter type")


def png_unfilter_plain(src: np.ndarray, frames, dst: np.ndarray) -> None:
  """`png_unfilter` a byte at a time in Python (for the tests)."""
  table = _frame_table(frames)
  _check_bounds(src, dst, table)
  for index, (s, d, height, row_bytes, bpp) in enumerate(table.tolist()):
    prev = [0] * row_bytes
    for y in range(height):
      base = s + y * (1 + row_bytes)
      kind = int(src[base])
      line = src[base + 1:base + 1 + row_bytes].tolist()
      out = [0] * row_bytes
      for x in range(row_bytes):
        a = out[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        if kind == 0:
          pred = 0
        elif kind == 1:
          pred = a
        elif kind == 2:
          pred = b
        elif kind == 3:
          pred = (a + b) // 2
        elif kind == 4:
          p = a + b - c
          pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
          pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
          raise ValueError(
              f"PNG frame {index}: invalid scanline filter type")
        out[x] = (line[x] + pred) & 0xFF
      dst[d + y * row_bytes:d + (y + 1) * row_bytes] = out
      prev = out
