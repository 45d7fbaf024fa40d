"""The protobuf wire format of `tf.train.Example` and `SequenceExample`,
in plain Python and numpy (no protobuf library, no TensorFlow).

The messages and their field numbers (`example.proto`, `feature.proto`):

    Example         { Features features = 1; }
    SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }
    Features        { map<string, Feature> feature = 1; }
    FeatureLists    { map<string, FeatureList> feature_list = 1; }
    FeatureList     { repeated Feature feature = 1; }
    Feature         { oneof kind { BytesList bytes_list = 1;
                                   FloatList float_list = 2;
                                   Int64List int64_list = 3; } }
    BytesList / FloatList / Int64List { repeated <type> value = 1; }

A map entry is a message { key = 1; value = 2; }. The decoder takes
packed and unpacked repeated scalars, negative int64 (ten-byte
varints), skips unknown fields, lets the last entry win on a repeated
map key, and reads a packed float list with one `np.frombuffer`. The
encoder writes what protobuf writes: packed scalars, entries in the
order given.

A decoded feature is a `Feature(kind, values)`: kind "bytes" with a
list of bytes, "float" with a float32 array, "int64" with an int64
array, or None (no kind set) with an empty list.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

_VARINT, _FIXED64, _LENGTH, _FIXED32 = 0, 1, 2, 5
_KINDS = {1: "bytes", 2: "float", 3: "int64"}
_FIELD_OF_KIND = {v: k for k, v in _KINDS.items()}


class Feature(NamedTuple):
  kind: object  # "bytes" | "float" | "int64" | None
  values: object  # list of bytes | float32 array | int64 array


EMPTY = Feature(None, [])


class ProtoDecodeError(ValueError):
  """Bytes that are not a well-formed message of the expected type."""


def bytes_feature(values: Sequence[bytes]) -> Feature:
  return Feature("bytes", [bytes(v) for v in values])


def float_feature(values) -> Feature:
  return Feature("float", np.asarray(values, np.float32).reshape(-1))


def int64_feature(values) -> Feature:
  return Feature("int64", np.asarray(values, np.int64).reshape(-1))


# ---- decoding ----


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
  byte = buf[pos]
  if byte < 0x80:
    return byte, pos + 1
  result, shift = byte & 0x7F, 7
  while True:
    pos += 1
    byte = buf[pos]
    result |= (byte & 0x7F) << shift
    if byte < 0x80:
      return result, pos + 1
    shift += 7
    if shift > 63:
      raise ProtoDecodeError("varint longer than ten bytes")


def _fields(buf: bytes, pos: int, end: int):
  """(field number, wire type, a, b) of each field in buf[pos:end]: for a
  varint a is its value; otherwise [a, b) are the payload's bounds."""
  while pos < end:
    key, pos = _varint(buf, pos)
    number, wire = key >> 3, key & 7
    if wire == _LENGTH:
      length, pos = _varint(buf, pos)
      start, pos = pos, pos + length
      if pos > end:
        raise ProtoDecodeError("length-delimited field runs past its message")
      yield number, wire, start, pos
    elif wire == _VARINT:
      value, pos = _varint(buf, pos)
      yield number, wire, value, pos
    elif wire == _FIXED32:
      pos += 4
      yield number, wire, pos - 4, pos
    elif wire == _FIXED64:
      pos += 8
      yield number, wire, pos - 8, pos
    else:
      raise ProtoDecodeError(f"unsupported wire type {wire}")
  if pos != end:
    raise ProtoDecodeError("field runs past its message")


def _signed(value: int) -> int:
  return value - (1 << 64) if value >= 1 << 63 else value


def _decode_list(buf: bytes, start: int, end: int, kind: str):
  if kind == "bytes":
    return [buf[a:b] for number, wire, a, b in _fields(buf, start, end)
            if number == 1 and wire == _LENGTH]
  chunks = []
  if kind == "float":
    for number, wire, a, b in _fields(buf, start, end):
      if number != 1:
        continue
      if wire == _LENGTH:
        if (b - a) % 4:
          raise ProtoDecodeError("packed float list of a partial float")
        chunks.append(np.frombuffer(buf, "<f4", (b - a) // 4, a))
      elif wire == _FIXED32:
        chunks.append(np.frombuffer(buf, "<f4", 1, a))
    if len(chunks) == 1:
      return chunks[0]
    return (np.concatenate(chunks) if chunks
            else np.zeros((0,), np.float32)).astype(np.float32, copy=False)
  values: List[int] = []
  for number, wire, a, b in _fields(buf, start, end):
    if number != 1:
      continue
    if wire == _LENGTH:
      pos = a
      while pos < b:
        value, pos = _varint(buf, pos)
        values.append(_signed(value))
      if pos != b:
        raise ProtoDecodeError("packed int64 list runs past its field")
    elif wire == _VARINT:
      values.append(_signed(a))
  return np.array(values, np.int64)


def _decode_feature(buf: bytes, start: int, end: int) -> Feature:
  feature = EMPTY
  for number, wire, a, b in _fields(buf, start, end):
    kind = _KINDS.get(number)
    if kind is None or wire != _LENGTH:
      continue
    values = _decode_list(buf, a, b, kind)
    if feature.kind == kind:  # a repeated message field merges
      values = (feature.values + values if kind == "bytes"
                else np.concatenate([feature.values, values]))
    feature = Feature(kind, values)
  return feature


def _map_entry(buf: bytes, start: int, end: int):
  """(key, (value start, value end) or None) of one map entry."""
  key, value = "", None
  for number, wire, a, b in _fields(buf, start, end):
    if number == 1 and wire == _LENGTH:
      key = buf[a:b].decode("utf-8")
    elif number == 2 and wire == _LENGTH:
      value = (a, b)
  return key, value


def _decode_features(buf: bytes, start: int, end: int,
                     out: Dict[str, Feature]) -> None:
  for number, wire, a, b in _fields(buf, start, end):
    if number == 1 and wire == _LENGTH:
      key, value = _map_entry(buf, a, b)
      out[key] = EMPTY if value is None else _decode_feature(buf, *value)


def _decode_feature_list(buf: bytes, start: int, end: int) -> List[Feature]:
  return [_decode_feature(buf, a, b)
          for number, wire, a, b in _fields(buf, start, end)
          if number == 1 and wire == _LENGTH]


def _guarded(fn, what: str, *args):
  try:
    return fn(*args)
  except IndexError as e:
    raise ProtoDecodeError(f"truncated {what}") from e
  except UnicodeDecodeError as e:
    raise ProtoDecodeError(f"{what}: a map key is not UTF-8") from e


def _example(buf: bytes) -> Dict[str, Feature]:
  features: Dict[str, Feature] = {}
  for number, wire, a, b in _fields(buf, 0, len(buf)):
    if number == 1 and wire == _LENGTH:
      _decode_features(buf, a, b, features)
  return features


def decode_example(serialized: bytes) -> Dict[str, Feature]:
  """A serialized `tf.train.Example` → {key: Feature}."""
  return _guarded(_example, "tf.train.Example", bytes(serialized))


def _sequence_example(buf: bytes):
  context: Dict[str, Feature] = {}
  lists: Dict[str, List[Feature]] = {}
  for number, wire, a, b in _fields(buf, 0, len(buf)):
    if wire != _LENGTH:
      continue
    if number == 1:
      _decode_features(buf, a, b, context)
    elif number == 2:
      for inner, inner_wire, c, d in _fields(buf, a, b):
        if inner == 1 and inner_wire == _LENGTH:
          key, value = _map_entry(buf, c, d)
          lists[key] = [] if value is None else _decode_feature_list(
              buf, *value)
  return context, lists


def decode_sequence_example(serialized: bytes
                            ) -> Tuple[Dict[str, Feature],
                                       Dict[str, List[Feature]]]:
  """A serialized `tf.train.SequenceExample` → (context {key: Feature},
  feature lists {key: [Feature per step]})."""
  return _guarded(_sequence_example, "tf.train.SequenceExample",
                  bytes(serialized))


# ---- encoding ----


def _put_varint(out: bytearray, value: int) -> None:
  value &= (1 << 64) - 1
  while value >= 0x80:
    out.append((value & 0x7F) | 0x80)
    value >>= 7
  out.append(value)


def _put_length(out: bytearray, number: int, payload: bytes) -> None:
  _put_varint(out, (number << 3) | _LENGTH)
  _put_varint(out, len(payload))
  out += payload


def _encode_feature(feature: Feature) -> bytes:
  if feature.kind is None:
    return b""
  payload = bytearray()
  if feature.kind == "bytes":
    for value in feature.values:
      _put_length(payload, 1, bytes(value))
  elif feature.kind == "float":
    values = np.asarray(feature.values, "<f4")
    if values.size:
      _put_length(payload, 1, values.tobytes())
  elif feature.kind == "int64":
    packed = bytearray()
    for value in np.asarray(feature.values, np.int64).tolist():
      _put_varint(packed, value)
    if packed:
      _put_length(payload, 1, bytes(packed))
  else:
    raise ValueError(f"unknown feature kind {feature.kind!r}")
  out = bytearray()
  _put_length(out, _FIELD_OF_KIND[feature.kind], bytes(payload))
  return bytes(out)


def _encode_entry(key: str, value: bytes) -> bytes:
  entry = bytearray()
  _put_length(entry, 1, key.encode("utf-8"))
  _put_length(entry, 2, value)
  return bytes(entry)


def _encode_features(features: Dict[str, Feature]) -> bytes:
  out = bytearray()
  for key, feature in features.items():
    _put_length(out, 1, _encode_entry(key, _encode_feature(feature)))
  return bytes(out)


def encode_example(features: Dict[str, Feature]) -> bytes:
  """{key: Feature} → a serialized `tf.train.Example`."""
  out = bytearray()
  if features:
    _put_length(out, 1, _encode_features(features))
  return bytes(out)


def encode_sequence_example(context: Dict[str, Feature],
                            feature_lists: Dict[str, Sequence[Feature]]
                            ) -> bytes:
  """(context, feature lists) → a serialized `tf.train.SequenceExample`."""
  out = bytearray()
  if context:
    _put_length(out, 1, _encode_features(context))
  if feature_lists:
    lists = bytearray()
    for key, steps in feature_lists.items():
      body = bytearray()
      for feature in steps:
        _put_length(body, 1, _encode_feature(feature))
      _put_length(lists, 1, _encode_entry(key, bytes(body)))
    _put_length(out, 2, bytes(lists))
  return bytes(out)
