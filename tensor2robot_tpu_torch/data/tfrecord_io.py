"""TFRecord files without TensorFlow: the record reader and writer.

A TFRecord file is a sequence of records, each framed as

    uint64 length (little-endian)
    uint32 masked CRC-32C of the 8 length bytes
    length bytes of data
    uint32 masked CRC-32C of the data

where mask(crc) = ((crc >> 15) | (crc << 17)) + 0xa282ead8 (mod 2^32).
The CRC is CRC-32C (Castagnoli), not zlib's CRC-32, computed by the
native codec (`utils/native.py`). Every CRC is checked: a mismatch or a
record cut short raises `TFRecordError`, naming the file and the byte
offset of the record.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, Iterator, Optional

from tensor2robot_tpu_torch.utils import native

_MASK_DELTA = 0xA282EAD8
_HEADER = struct.Struct("<QI")
_FOOTER = struct.Struct("<I")


class TFRecordError(ValueError):
  """A corrupt or truncated TFRecord file."""


def masked_crc(data: bytes) -> int:
  """The TFRecord mask of `data`'s CRC-32C."""
  crc = native.crc32c(data)
  return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def iterate_records(path: str) -> Iterator[bytes]:
  """Yields each record's data from one TFRecord file, checking both
  CRCs of every record."""
  with open(path, "rb") as f:
    offset = 0
    while True:
      header = f.read(_HEADER.size)
      if not header:
        return
      if len(header) < _HEADER.size:
        raise TFRecordError(
            f"{path}: truncated record header at byte {offset} "
            f"({len(header)} of {_HEADER.size} bytes)")
      length, length_crc = _HEADER.unpack(header)
      if masked_crc(header[:8]) != length_crc:
        raise TFRecordError(
            f"{path}: corrupt record length at byte {offset} "
            "(CRC-32C mismatch)")
      data = f.read(length)
      footer = f.read(_FOOTER.size)
      if len(data) < length or len(footer) < _FOOTER.size:
        raise TFRecordError(
            f"{path}: truncated record at byte {offset}: it declares "
            f"{length} data bytes, the file ends first")
      if masked_crc(data) != _FOOTER.unpack(footer)[0]:
        raise TFRecordError(
            f"{path}: corrupt record data at byte {offset} "
            "(CRC-32C mismatch)")
      yield data
      offset += _HEADER.size + length + _FOOTER.size


class TFRecordWriter:
  """Writes records to one TFRecord file (a context manager, as
  `tf.io.TFRecordWriter` is)."""

  def __init__(self, path: str):
    directory = os.path.dirname(path)
    if directory:
      os.makedirs(directory, exist_ok=True)
    self._file: Optional[BinaryIO] = open(path, "wb")

  def write(self, record: bytes) -> None:
    if self._file is None:
      raise ValueError("TFRecordWriter is closed")
    length = struct.pack("<Q", len(record))
    self._file.write(length)
    self._file.write(_FOOTER.pack(masked_crc(length)))
    self._file.write(record)
    self._file.write(_FOOTER.pack(masked_crc(record)))

  def close(self) -> None:
    if self._file is not None:
      self._file.close()
      self._file = None

  def __enter__(self) -> "TFRecordWriter":
    return self

  def __exit__(self, *exc) -> None:
    self.close()
