"""JPEG decode and encode without TensorFlow or PIL: what
`tf.io.decode_image` and `tf.io.encode_jpeg` do with their defaults.

TensorFlow's codec is libjpeg-turbo. Its defaults, which this module
reproduces bit for bit (`native/codec.cc` does the work; Python only
dispatches):
- decode: the IFAST integer IDCT (`dct_method=""` is libjpeg's
  `JDCT_IFAST`, not the accurate `INTEGER_ACCURATE`), fancy (triangle)
  chroma upsampling, libjpeg's fixed-point YCbCr -> RGB;
- encode: quality 95 (the Annex K tables scaled by `jpeg_set_quality`,
  clamped to 1..255), 4:2:0 chroma with the alternating rounding bias,
  the ISLOW forward DCT with libjpeg-turbo's reciprocal quantizer, the
  standard Huffman tables, and a JFIF APP0 with 300 x 300 dots per inch.

Decoded: baseline (and extended) sequential Huffman JPEG, 8-bit, 1 or 3
components, sampling factors up to 2 x 2, restart intervals. Refused
with NotImplementedError naming what was met: progressive, arithmetic
coding, lossless, hierarchical, 12-bit, and 4-component (CMYK / YCCK)
files. Malformed files raise `JPEGError` (a ValueError).

Channels are those of `decode_image(channels=c)` on a JPEG: c=0 keeps
the file's (1 or 3), 1 takes the luma of a colour file, 3 replicates a
grey one; 4 is refused as TensorFlow refuses it.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from tensor2robot_tpu_torch.utils import native

MAGIC = b"\xff\xd8\xff"
_ERR_CAP = 512


class JPEGError(ValueError):
  """Bytes that are not a JPEG this decoder reads."""


def is_jpeg(data: bytes) -> bool:
  return bytes(data[:3]) == MAGIC


def _raise(kind: int, message: str):
  if kind == 1:
    raise NotImplementedError(message)
  raise JPEGError(message)


def _header(data: bytes) -> Tuple[int, str, Tuple[int, int, int]]:
  """(error kind or 0, its message, (height, width, components)) from a
  JPEG's headers."""
  out = np.zeros(3, np.int64)
  err = ctypes.create_string_buffer(_ERR_CAP)
  kind = native.load_codec().t2r_jpeg_info(
      data, len(data), out.ctypes.data, err, _ERR_CAP)
  return kind, err.value.decode(), (int(out[0]), int(out[1]), int(out[2]))


def _check_channels(channels: int) -> None:
  if channels not in (0, 1, 3):
    raise JPEGError(f"JPEG decodes to 0, 1 or 3 channels, got {channels}")


def decode_many(datas: Sequence[bytes], channels: int = 0) -> List[np.ndarray]:
  """Decodes JPEG byte strings to uint8 [h, w, c] arrays in one native
  call, which splits the frames over up to 8 threads (one per core, at
  least 8 frames a thread) without the interpreter lock; each frame
  decodes alike whatever the split. A failure names the first bad
  frame."""
  _check_channels(channels)
  datas = [bytes(d) for d in datas]
  if not datas:
    return []
  shapes = []
  for i, data in enumerate(datas):
    kind, message, (height, width, comps) = _header(data)
    if kind:
      _raise(kind, f"JPEG frame {i}: {message}")
    shapes.append((height, width, channels or comps))
  lens = np.array([len(d) for d in datas], np.int64)
  src_off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
  sizes = np.array([h * w * c for h, w, c in shapes], np.int64)
  dst_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
  want = np.array([c for _, _, c in shapes], np.int64)
  src = np.frombuffer(b"".join(datas), np.uint8)
  dst = np.empty(int(sizes.sum()), np.uint8)
  kind = ctypes.c_int32(0)
  err = ctypes.create_string_buffer(_ERR_CAP)
  bad = native.load_codec().t2r_jpeg_decode_many(
      src.ctypes.data, src_off.ctypes.data, lens.ctypes.data,
      dst.ctypes.data, dst_off.ctypes.data, want.ctypes.data, len(datas),
      ctypes.byref(kind), err, _ERR_CAP)
  if bad < 0:
    _raise(kind.value, f"JPEG frame {-bad - 1}: {err.value.decode()}")
  return [dst[o:o + s].reshape(shape)
          for o, s, shape in zip(dst_off.tolist(), sizes.tolist(), shapes)]


def decode(data: bytes, channels: int = 0) -> np.ndarray:
  """One JPEG -> a uint8 [h, w, c] array (see `decode_many`)."""
  return decode_many([data], channels)[0]


def encode(image: np.ndarray) -> bytes:
  """A uint8 [h, w], [h, w, 1] or [h, w, 3] array -> the bytes
  `tf.io.encode_jpeg(image)` gives (quality 95, 4:2:0)."""
  image = np.asarray(image)
  if image.dtype != np.uint8:
    raise ValueError(f"encode_jpeg takes uint8, got {image.dtype}")
  if image.ndim == 2:
    image = image[..., None]
  if image.ndim != 3 or image.shape[-1] not in (1, 3):
    raise ValueError(f"encode_jpeg takes [h, w, 1 or 3], got {image.shape}")
  height, width, channels = image.shape
  if not (0 < height < 65536 and 0 < width < 65536):
    raise ValueError(f"encode_jpeg: {height} x {width} is outside 1..65535")
  image = np.ascontiguousarray(image)
  lib = native.load_codec()
  cap = 2048 + 2 * image.size
  while True:
    out = np.empty(cap, np.uint8)
    size = lib.t2r_jpeg_encode(image.ctypes.data, height, width, channels,
                               out.ctypes.data, cap)
    if size <= cap:
      return out[:size].tobytes()
    cap = size
