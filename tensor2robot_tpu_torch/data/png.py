"""PNG decode and encode without TensorFlow or PIL: the part of
`tf.io.decode_image` / `tf.io.encode_png` the data plane uses, and the
image dispatch: `decode_many` hands JPEG frames to `data/jpeg.py`.

Decoding concatenates a file's IDAT chunks, inflates them with `zlib`
and unfilters the scanlines with the native codec (`utils/native.py`),
one call for a whole batch of frames (`decode_many`). Encoders choose a
filter per row (TensorFlow's libpng writes Sub, Up and Paeth rows), so
all five filter types are undone. Supported: bit depth 8, colour types
0 (grey), 2 (RGB), 3 (palette, with its tRNS alpha), 4 (grey + alpha)
and 6 (RGBA), no interlace; 16-bit samples, depths below 8 and Adam7
interlace raise ValueError saying so. Chunk CRCs are checked.

Channel conversion is that of `decode_image(channels=c)`: c=0 keeps the
file's channels (a palette becomes RGB, or RGBA when it has alpha);
grey becomes RGB by replication; alpha is dropped when c has none and
added opaque when c has one. Colour to grey is libpng's truncated
weighted sum with TF's weights (`_rgb_to_grey`).

Encoding writes filter 1 (Sub) rows, deflated by `zlib`, chunk CRCs by
`zlib.crc32`.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Sequence

import numpy as np

from tensor2robot_tpu_torch.data import jpeg
from tensor2robot_tpu_torch.utils import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_FILE_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


class PNGError(ValueError):
  """Bytes that are not a PNG this decoder reads."""


class _Header:
  __slots__ = ("width", "height", "colour", "palette", "alpha", "idat")

  @property
  def bpp(self) -> int:
    return _FILE_CHANNELS[self.colour]

  @property
  def row_bytes(self) -> int:
    return self.width * self.bpp

  @property
  def channels(self) -> int:
    """The channels `decode_image(channels=0)` gives."""
    if self.colour == 3:
      return 3 if self.alpha is None else 4
    return self.bpp


def _read_chunks(data: bytes) -> _Header:
  if data[:8] != SIGNATURE:
    raise PNGError("not a PNG (bad signature); decodable formats: PNG, "
                   "JPEG")
  head = _Header()
  head.palette = head.alpha = None
  idat: List[bytes] = []
  pos, seen_ihdr = 8, False
  while True:
    if pos + 8 > len(data):
      raise PNGError("truncated PNG: no IEND chunk")
    length, kind = struct.unpack_from(">I4s", data, pos)
    body = data[pos + 8:pos + 8 + length]
    crc_at = pos + 8 + length
    if crc_at + 4 > len(data):
      raise PNGError(f"truncated PNG chunk {kind!r}")
    if zlib.crc32(data[pos + 4:crc_at]) != struct.unpack_from(
        ">I", data, crc_at)[0]:
      raise PNGError(f"PNG chunk {kind!r}: CRC mismatch")
    pos = crc_at + 4
    if kind == b"IHDR":
      (head.width, head.height, depth, head.colour, _, _,
       interlace) = struct.unpack(">IIBBBBB", body)
      if head.colour not in _FILE_CHANNELS:
        raise PNGError(f"PNG colour type {head.colour} is not valid")
      if depth != 8:
        raise PNGError(
            f"PNG bit depth {depth} is not supported (8-bit samples only; "
            "16-bit and sub-byte depths are not ported)")
      if interlace:
        raise PNGError(
            "interlaced (Adam7) PNG is not supported; write it "
            "non-interlaced")
      seen_ihdr = True
    elif not seen_ihdr:
      raise PNGError("PNG does not start with an IHDR chunk")
    elif kind == b"PLTE":
      head.palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
    elif kind == b"tRNS" and head.colour == 3:
      head.alpha = np.frombuffer(body, np.uint8)
    elif kind == b"IDAT":
      idat.append(body)
    elif kind == b"IEND":
      break
  if head.colour == 3 and head.palette is None:
    raise PNGError("palette PNG without a PLTE chunk")
  head.idat = b"".join(idat)
  return head


def _natural(head: _Header, pixels: np.ndarray) -> np.ndarray:
  """Unfiltered samples [h, w, bpp] → the image `channels=0` gives."""
  if head.colour != 3:
    return pixels
  index = pixels[..., 0]
  if int(index.max(initial=0)) >= len(head.palette):
    raise PNGError("palette index outside the PLTE chunk")
  rgb = head.palette[index]
  if head.alpha is None:
    return rgb
  alpha = np.full(len(head.palette), 255, np.uint8)
  alpha[:len(head.alpha)] = head.alpha[:len(head.palette)]
  return np.concatenate([rgb, alpha[index][..., None]], axis=-1)


# libpng's `png_set_rgb_to_gray(png_ptr, 1, 0.299, 0.587)` weights in
# 15-bit fixed point (each truncated from the fixed-point 29900 and 58700;
# blue takes the rest), as TF's `decode_png(channels=1)` sets them.
_GREY_WEIGHTS = (9797, 19234, 32768 - 9797 - 19234)


def _rgb_to_grey(image: np.ndarray) -> np.ndarray:
  """libpng's colour-to-grey of 8-bit RGB(A) [h, w, 3|4] → [h, w, 1]:
  (r·9797 + g·19234 + b·3737) >> 15, truncated (a grey pixel keeps its
  value); alpha dropped."""
  rgb = image[..., :3].astype(np.uint32)
  r, g, b = _GREY_WEIGHTS
  grey = (rgb[..., 0] * r + rgb[..., 1] * g + rgb[..., 2] * b) >> 15
  return grey.astype(np.uint8)[..., None]


def _convert(image: np.ndarray, channels: int) -> np.ndarray:
  have = image.shape[-1]
  if channels not in (0, 1, 3, 4):
    raise PNGError(f"channels must be 0, 1, 3 or 4, got {channels}")
  if channels in (0, have):
    return image
  grey = have <= 2
  if channels == 1:
    if not grey:
      return _rgb_to_grey(image)
    return np.ascontiguousarray(image[..., :1])
  colour = np.repeat(image[..., :1], 3, axis=-1) if grey else image[..., :3]
  if channels == 3:
    return np.ascontiguousarray(colour)
  alpha = (image[..., -1:] if have in (2, 4)
           else np.full(image.shape[:-1] + (1,), 255, np.uint8))
  return np.concatenate([colour, alpha], axis=-1)


def decode_many(datas: Sequence[bytes], channels: int = 0,
                unfilter=None) -> List[np.ndarray]:
  """Decodes PNG and JPEG byte strings to uint8 [h, w, c] arrays: the
  PNGs with one native unfilter call for all of them, the JPEGs with
  one `jpeg.decode_many` call. `unfilter` replaces the native unfilter
  (tests pass `native.png_unfilter_plain`)."""
  datas = [bytes(d) for d in datas]
  at_jpeg = [i for i, d in enumerate(datas) if jpeg.is_jpeg(d)]
  if not at_jpeg:
    return _decode_png_many(datas, channels, unfilter)
  out: List[np.ndarray] = [None] * len(datas)  # type: ignore[list-item]
  for i, image in zip(at_jpeg, jpeg.decode_many(
      [datas[i] for i in at_jpeg], channels)):
    out[i] = image
  at_png = [i for i in range(len(datas)) if out[i] is None]
  for i, image in zip(at_png, _decode_png_many(
      [datas[i] for i in at_png], channels, unfilter)):
    out[i] = image
  return out


def _decode_png_many(datas: Sequence[bytes], channels: int,
                     unfilter) -> List[np.ndarray]:
  heads: List[_Header] = []
  raws: List[bytes] = []
  table = np.zeros((len(datas), 5), np.int64)
  src_at = dst_at = 0
  for i, data in enumerate(datas):
    head = _read_chunks(bytes(data))
    try:
      raw = zlib.decompress(head.idat)
    except zlib.error as e:
      raise PNGError(f"PNG image data does not inflate: {e}") from e
    need = head.height * (1 + head.row_bytes)
    if len(raw) < need:
      raise PNGError(
          f"PNG image data too short: {len(raw)} bytes for {head.height} "
          f"rows of {head.row_bytes}")
    table[i] = (src_at, dst_at, head.height, head.row_bytes, head.bpp)
    src_at += need
    dst_at += head.height * head.row_bytes
    heads.append(head)
    raws.append(raw[:need])
  src = np.frombuffer(b"".join(raws), np.uint8)
  dst = np.empty((dst_at,), np.uint8)
  if len(datas):
    (unfilter or native.png_unfilter)(src, table, dst)
  out = []
  for head, (_, at, height, row_bytes, bpp) in zip(heads, table.tolist()):
    pixels = dst[at:at + height * row_bytes].reshape(height, head.width, bpp)
    out.append(_convert(_natural(head, pixels), channels))
  return out


def decode(data: bytes, channels: int = 0) -> np.ndarray:
  """One PNG or JPEG → a uint8 [h, w, c] array (see `decode_many`)."""
  return decode_many([data], channels)[0]


def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack(">I", len(body)) + kind + body
          + struct.pack(">I", zlib.crc32(kind + body)))


def encode(image: np.ndarray) -> bytes:
  """A uint8 [h, w] or [h, w, c] (c in 1..4) array → PNG bytes, every
  row with filter 1 (Sub)."""
  image = np.asarray(image)
  if image.dtype != np.uint8:
    raise ValueError(f"encode_png takes uint8, got {image.dtype}")
  if image.ndim == 2:
    image = image[..., None]
  if image.ndim != 3 or image.shape[-1] not in _COLOUR_TYPE:
    raise ValueError(f"encode_png takes [h, w, 1..4], got {image.shape}")
  height, width, channels = image.shape
  rows = image.reshape(height, width * channels)
  lines = np.empty((height, 1 + width * channels), np.uint8)
  lines[:, 0] = 1
  lines[:, 1:1 + channels] = rows[:, :channels]
  np.subtract(rows[:, channels:], rows[:, :-channels],
              out=lines[:, 1 + channels:])
  header = struct.pack(">IIBBBBB", width, height, 8,
                       _COLOUR_TYPE[channels], 0, 0, 0)
  return (SIGNATURE + _chunk(b"IHDR", header)
          + _chunk(b"IDAT", zlib.compress(lines.tobytes()))
          + _chunk(b"IEND", b""))


def encode_jpeg(image: np.ndarray) -> bytes:
  """`tf.io.encode_jpeg(image)` with its defaults (`jpeg.encode`)."""
  return jpeg.encode(image)
