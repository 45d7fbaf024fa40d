"""Spec-derived tf.Example / SequenceExample encoding and decoding (port
of `data/tfexample.py`), without TensorFlow.

The wire format is TensorFlow's: `data/example_proto.py` reads and
writes the protobuf messages, `data/png.py` the PNG frames. Each spec
binds one wire feature, keyed `spec.name or key` (`wire_key`):

  * image specs (`data_format="png"`) and raw specs (`"raw"`: the C-order
    array bytes, little-endian) travel as one byte string;
  * float and bfloat16 specs as a float list, integer and bool specs as
    an int64 list, of `prod(shape)` values, or any number for `varlen`
    specs (zero-padded or truncated to `prod(shape)` in flat form);
  * in a SequenceExample, `is_sequence` specs travel as feature lists
    (one feature a step), the others in the context.

Two parsers, each with the semantics of its JAX twin:

  * `parse_example_batch` / `parse_sequence_example_batch` (the JAX
    eager parsers): an image keeps the file's channels (only a 2-D grey
    image is lifted) and must match the spec's shape; in a sequence only
    the first min(length, T) frames are decoded, each a real frame;
  * `graph_parse_example` / `graph_parse_sequence_example` (the JAX
    parse that the TFRecord generators run inside tf.data): an image
    decodes to the spec's channel count and is reshaped to the spec's
    shape; an empty byte string (SequenceExample time padding) decodes
    to a zero frame, for images and raw features alike.

Both return flat dicts of `[B, ...]` arrays (`[B, T, ...]` for sequence
keys, T = `sequence_length`, zero-padded or truncated), floats cast from
float32 and ints from int64 to the spec's dtype as `tf.cast` casts them
(bfloat16 rounded to nearest even, as a torch tensor: numpy has no
bfloat16), and, for sequences, the true lengths under
`SEQUENCE_LENGTH_KEY`: `[B]`, the max over sequence keys of min(length,
T); int32, or int64 from the eager parser, as in JAX. A record that does not fit its specs raises ValueError
naming the key. Images are PNG or JPEG (`png.decode_many` dispatches).
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tensor2robot_tpu_torch.data import example_proto as proto
from tensor2robot_tpu_torch.data import png
from tensor2robot_tpu_torch.specs import packing
from tensor2robot_tpu_torch.specs.tensorspec import (
    ExtendedTensorSpec,
    TensorSpecStruct,
    numpy_dtype,
)

SEQUENCE_LENGTH_KEY = "sequence_length"


class FeatureDesc(NamedTuple):
  """What a spec binds on the wire: the feature's kind, and its value
  count (None: any number, a varlen feature)."""

  kind: str  # "bytes" | "float" | "int64"
  length: Optional[int]


def wire_key(key: str, spec: ExtendedTensorSpec) -> str:
  """The on-disk feature key for a spec: explicit name, else flat path."""
  return spec.name or key


def _is_raw(spec: ExtendedTensorSpec) -> bool:
  return spec.data_format == "raw"


def _flat(feature_spec: Any) -> Dict[str, ExtendedTensorSpec]:
  return packing.flatten_spec_structure(feature_spec).to_flat_dict()


def _value_kind(spec: ExtendedTensorSpec, what: str) -> str:
  if spec.dtype is torch.bfloat16 or spec.dtype.kind == "f":
    return "float"
  if spec.dtype.kind in ("i", "u", "b"):
    return "int64"
  raise ValueError(f"Unsupported spec dtype for {what}: {spec.dtype}")


def build_feature_map(feature_spec: Any) -> Dict[str, FeatureDesc]:
  """The wire feature each spec binds, by wire key (tf.Example)."""
  feature_map: Dict[str, FeatureDesc] = {}
  for key, spec in _flat(feature_spec).items():
    name = wire_key(key, spec)
    if spec.is_sequence:
      raise ValueError(
          f"Sequence spec {name!r} cannot be bound to a tf.Example wire "
          f"directly; episode data travels as tf.SequenceExample — use "
          f"parse_sequence_example_batch / encode_sequence_example — or "
          f"materialize a fixed length first via "
          f"specs.add_sequence_length (static shapes).")
    if spec.is_image or _is_raw(spec):
      feature_map[name] = FeatureDesc("bytes", 1)
      continue
    kind = _value_kind(spec, "tf.Example")
    feature_map[name] = FeatureDesc(
        kind, None if spec.varlen else int(np.prod(spec.shape)))
  return feature_map


def split_sequence_specs(feature_spec: Any):
  """Splits a spec structure into (context, sequence) flat dicts."""
  flat = _flat(feature_spec)
  context = {k: s for k, s in flat.items() if not s.is_sequence}
  sequence = {k: s for k, s in flat.items() if s.is_sequence}
  return context, sequence


def build_sequence_feature_maps(feature_spec: Any):
  """(context_map, sequence_map) of wire features (SequenceExample)."""
  context_specs, sequence_specs = split_sequence_specs(feature_spec)
  context_map = (build_feature_map(TensorSpecStruct.from_flat_dict(
      context_specs)) if context_specs else {})
  sequence_map = {}
  for key, spec in sequence_specs.items():
    if spec.is_image or _is_raw(spec):
      sequence_map[wire_key(key, spec)] = FeatureDesc("bytes", 1)
      continue
    kind = _value_kind(spec, "tf.SequenceExample")
    sequence_map[wire_key(key, spec)] = FeatureDesc(
        kind, int(np.prod(spec.shape)))
  return context_map, sequence_map


# ---- wire values → arrays ----


def _empty(kind: str):
  return [] if kind == "bytes" else np.zeros(
      (0,), np.float32 if kind == "float" else np.int64)


def _values(feature: Optional[proto.Feature], desc: FeatureDesc, name: str,
            what: str = "Feature"):
  """The values of one wire feature checked against its desc, as
  `tf.io.parse_example` checks them: a fixed-length feature must be
  present, of its kind, with exactly its count of values."""
  if feature is None:
    if desc.length is None:
      return _empty(desc.kind)
    raise ValueError(f"{what} {name!r} (kind {desc.kind}) is required "
                     "but could not be found.")
  if feature.kind is None:
    values = _empty(desc.kind)
  elif feature.kind != desc.kind:
    raise ValueError(f"{what} {name!r}: data types don't match: the wire "
                     f"holds {feature.kind}, the spec needs {desc.kind}.")
  else:
    values = feature.values
  if desc.length is not None and len(values) != desc.length:
    raise ValueError(f"{what} {name!r}: key has {len(values)} values, the "
                     f"spec needs {desc.length}.")
  return values


def _cast(array: np.ndarray, spec: ExtendedTensorSpec):
  """float32 / int64 / uint8 wire values → the spec's dtype, as
  `tf.cast` does (bfloat16 rounds to nearest even; a torch tensor)."""
  if spec.dtype is torch.bfloat16:
    return torch.from_numpy(
        np.ascontiguousarray(array, np.float32)).to(torch.bfloat16)
  return np.asarray(array).astype(spec.dtype, copy=False)


def _from_raw_bits(array: np.ndarray, spec: ExtendedTensorSpec):
  """A raw feature's decoded array in the spec's dtype."""
  if spec.dtype is torch.bfloat16:
    return torch.from_numpy(array).view(torch.bfloat16)
  return array


def _fit_raw(data: bytes, spec: ExtendedTensorSpec, key: str) -> np.ndarray:
  """One raw-wire byte string, naming the spec on a size mismatch."""
  dtype = numpy_dtype(spec.dtype)
  expected = int(np.prod(spec.shape)) * dtype.itemsize
  if len(data) != expected:
    name = "bfloat16" if spec.dtype is torch.bfloat16 else dtype.name
    raise ValueError(
        f"Raw feature {key!r}: wire holds {len(data)} bytes but spec "
        f"{tuple(spec.shape)} {name} needs {expected}. The record was "
        "written against a different shape/dtype.")
  return np.frombuffer(data, dtype).reshape(spec.shape)


def _fit_image(image: np.ndarray, spec: ExtendedTensorSpec) -> np.ndarray:
  expected = tuple(spec.shape)
  if image.shape == expected:
    return image
  if image.ndim == 2 and len(expected) == 3 and expected[-1] == 1:
    image = image[..., None]
  if image.shape != expected:
    raise ValueError(
        f"Decoded image shape {image.shape} does not match spec "
        f"{expected} for {spec.name!r}. Resize at dataset-build time or "
        f"declare the true decoded shape.")
  return image


def _decode_frames(out: np.ndarray, slots: Sequence[Tuple[Any, bytes]],
                   spec: ExtendedTensorSpec, key: str, graph: bool,
                   skip_empty: bool) -> None:
  """Decodes encoded frames into `out[index]` for each (index, bytes) of
  `slots`; what no slot fills stays zero. `skip_empty`: an empty string
  is a zero frame. Images in the generators' parse (`graph`) decode to
  the spec's channel count and reshape to its shape (same size); in
  the eager parse they keep the file's channels and must have the
  spec's exact shape (all of the batch's frames in one native unfilter
  call). Raw frames hold the spec's exact byte count."""
  if skip_empty:
    slots = [(index, data) for index, data in slots if data]
  if not spec.is_image:
    for index, data in slots:
      out[index] = _fit_raw(data, spec, key)
    return
  shape = tuple(spec.shape)
  decoded = png.decode_many([data for _, data in slots],
                            channels=shape[-1] if graph else 0)
  for (index, _), image in zip(slots, decoded):
    if not graph:
      out[index] = _fit_image(image, spec)
    elif image.size != out[index].size:
      raise ValueError(
          f"Image feature {key!r}: a decoded frame of shape {image.shape} "
          f"cannot be reshaped to the spec's {shape}.")
    else:
      out[index] = image.reshape(shape)


def _frames_value(out: np.ndarray, spec: ExtendedTensorSpec):
  """Decoded frames in the spec's dtype: images cast from uint8, raw
  bits viewed as the spec's dtype."""
  return _cast(out, spec) if spec.is_image else _from_raw_bits(out, spec)


def _frame_dtype(spec: ExtendedTensorSpec) -> np.dtype:
  return np.dtype(np.uint8) if spec.is_image else numpy_dtype(spec.dtype)


def _dense(rows: List, kind: str, width: Optional[int]) -> np.ndarray:
  """Per-record value lists → [B, width] zero-padded (width None: the
  longest row)."""
  width = max((len(r) for r in rows), default=0) if width is None else width
  out = np.zeros((len(rows), width),
                 np.float32 if kind == "float" else np.int64)
  for i, row in enumerate(rows):
    n = min(len(row), width)
    out[i, :n] = row[:n]
  return out


def _context_value(key: str, spec: ExtendedTensorSpec, desc: FeatureDesc,
                   features: List[Dict[str, proto.Feature]],
                   graph: bool, what: str = "Feature"):
  """One non-sequence key over a batch of decoded records."""
  name = wire_key(key, spec)
  values = [_values(f.get(name), desc, name, what) for f in features]
  if spec.is_image or _is_raw(spec):
    out = np.zeros((len(values),) + tuple(spec.shape), _frame_dtype(spec))
    _decode_frames(out, [(b, v[0]) for b, v in enumerate(values)], spec, key,
                   graph, skip_empty=graph and spec.is_image)
    return _frames_value(out, spec)
  flat_len = int(np.prod(spec.shape))
  dense = _dense(values, desc.kind, None if spec.varlen else flat_len)
  if spec.varlen:
    dense = _dense(list(dense), desc.kind, flat_len)
  return _cast(dense.reshape((len(values),) + tuple(spec.shape)), spec)


def _parse_error(what: str, keys, e: Exception) -> ValueError:
  return ValueError(
      f"{what} parse failed against the declared specs ({keys}). Most "
      f"often a record is missing a required key or has the wrong length. "
      f"Underlying error: {e}")


def _parse_examples(serialized: Sequence[bytes], feature_spec: Any,
                    graph: bool) -> Dict[str, Any]:
  flat = _flat(feature_spec)
  feature_map = build_feature_map(feature_spec)
  try:
    features = [proto.decode_example(s) for s in serialized]
    return {key: _context_value(key, spec, feature_map[wire_key(key, spec)],
                                features, graph)
            for key, spec in flat.items()}
  except ValueError as e:
    raise _parse_error("tf.Example", f"wire keys: {sorted(feature_map)}",
                       e) from e


def parse_example_batch(serialized: Sequence[bytes],
                        feature_spec: Any) -> TensorSpecStruct:
  """Parses a batch of serialized tf.Examples (the JAX eager parser's
  semantics) into a flat TensorSpecStruct of `[B] + spec.shape` arrays."""
  return TensorSpecStruct.from_flat_dict(
      _parse_examples(list(serialized), feature_spec, graph=False))


def graph_parse_example(serialized: Sequence[bytes],
                        feature_spec: Any) -> Dict[str, Any]:
  """Parses a batch of serialized tf.Examples with the semantics of the
  JAX `graph_parse_example` (what the TFRecord generators run)."""
  return _parse_examples(list(serialized), feature_spec, graph=True)


def _parse_sequence_examples(serialized: Sequence[bytes], feature_spec: Any,
                             sequence_length: int,
                             graph: bool) -> Dict[str, Any]:
  flat = _flat(feature_spec)
  if SEQUENCE_LENGTH_KEY in flat:
    raise ValueError(
        f"Spec key {SEQUENCE_LENGTH_KEY!r} is reserved: the parser "
        f"emits the true episode lengths under it. Rename the feature.")
  context_map, sequence_map = build_sequence_feature_maps(feature_spec)
  seq_len = int(sequence_length)
  try:
    records = [proto.decode_sequence_example(s) for s in serialized]
    batch = len(records)
    out: Dict[str, Any] = {}
    true_lengths = np.zeros((batch,), np.int32)
    for key, spec in flat.items():
      name = wire_key(key, spec)
      if not spec.is_sequence:
        out[key] = _context_value(key, spec, context_map[name],
                                  [c for c, _ in records], graph)
        continue
      desc = sequence_map[name]
      steps = []
      for _, lists in records:
        if name not in lists:
          raise ValueError(f"Feature list {name!r} is required but could "
                           "not be found.")
        steps.append([_values(f, desc, name, "Feature list")
                      for f in lists[name]])
      lengths = np.array([len(s) for s in steps], np.int64)
      true_lengths = np.maximum(true_lengths, np.minimum(lengths, seq_len))
      shape = (batch, seq_len) + tuple(spec.shape)
      if spec.is_image or _is_raw(spec):
        # The first min(length, T) frames of each record; time padding
        # is zeros. The generators' parse reads "" frames as zeros too.
        value = np.zeros(shape, _frame_dtype(spec))
        _decode_frames(value, [((b, t), row[t][0])
                               for b, row in enumerate(steps)
                               for t in range(min(len(row), seq_len))],
                       spec, key, graph, skip_empty=graph)
        out[key] = _frames_value(value, spec)
        continue
      dense = np.zeros((batch, seq_len, desc.length),
                       np.float32 if desc.kind == "float" else np.int64)
      for b, row in enumerate(steps):
        if row[:seq_len]:
          dense[b, :min(len(row), seq_len)] = np.stack(row[:seq_len])
      out[key] = _cast(dense.reshape(shape), spec)
    # int32 from the generator's parse; the eager one promotes to int64
    # once a sequence key is seen, as numpy does in the JAX twin.
    out[SEQUENCE_LENGTH_KEY] = (true_lengths.astype(np.int32) if graph
                                else true_lengths)
    return out
  except ValueError as e:
    raise _parse_error(
        "tf.SequenceExample",
        f"context keys: {sorted(context_map)}, sequence keys: "
        f"{sorted(sequence_map)}", e) from e


def parse_sequence_example_batch(serialized: Sequence[bytes],
                                 feature_spec: Any,
                                 sequence_length: int) -> TensorSpecStruct:
  """Parses serialized tf.SequenceExamples (the JAX eager parser's
  semantics): sequence keys `[B, sequence_length] + spec.shape`, context
  keys `[B] + spec.shape`, true lengths under `SEQUENCE_LENGTH_KEY`."""
  return TensorSpecStruct.from_flat_dict(_parse_sequence_examples(
      list(serialized), feature_spec, sequence_length, graph=False))


def graph_parse_sequence_example(serialized: Sequence[bytes],
                                 feature_spec: Any,
                                 sequence_length: int) -> Dict[str, Any]:
  """The semantics of the JAX `graph_parse_sequence_example` (what the
  episode generator runs); see the module docstring."""
  return _parse_sequence_examples(list(serialized), feature_spec,
                                  sequence_length, graph=True)


# ---- arrays → wire ----


def _numpy(value: Any, spec: ExtendedTensorSpec) -> np.ndarray:
  """An unbatched value as a numpy array of the spec's wire dtype
  (bfloat16 as its uint16 bits, rounded to nearest even)."""
  if spec.dtype is torch.bfloat16:
    tensor = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.asarray(value, np.float32))
    return tensor.to(torch.bfloat16).view(torch.int16).numpy().view(
        np.uint16)
  if isinstance(value, torch.Tensor):
    value = value.numpy()
  return np.asarray(value, dtype=spec.dtype)


def _encode_feature(value: Any, spec: ExtendedTensorSpec) -> proto.Feature:
  """Encodes ONE unbatched value as a wire feature per its spec."""
  if _is_raw(spec) or spec.is_image:
    if isinstance(value, (bytes, np.bytes_)):
      return proto.bytes_feature([bytes(value)])
    if _is_raw(spec):
      return proto.bytes_feature(
          [np.ascontiguousarray(_numpy(value, spec)).tobytes()])
    image = np.ascontiguousarray(np.asarray(value, dtype=np.uint8))
    if spec.data_format != "png":
      return proto.bytes_feature([png.encode_jpeg(image)])
    return proto.bytes_feature([png.encode(image)])
  if isinstance(value, torch.Tensor):
    value = value.float().numpy() if value.is_floating_point() else (
        value.numpy())
  arr = np.asarray(value).reshape(-1)
  if _value_kind(spec, "tf.Example") == "float":
    return proto.float_feature(arr.astype(np.float32))
  return proto.int64_feature(arr.astype(np.int64))


def encode_example(flat_tensors: Dict[str, Any], feature_spec: Any) -> bytes:
  """Encodes ONE example (unbatched) as a serialized tf.Example. Image
  specs take uint8 arrays (encoded here) or encoded bytes."""
  feature = {}
  for key, spec in _flat(feature_spec).items():
    if key not in flat_tensors:
      if spec.is_optional:
        continue
      raise ValueError(f"Missing required feature {key!r}")
    feature[wire_key(key, spec)] = _encode_feature(flat_tensors[key], spec)
  return proto.encode_example(feature)


def encode_sequence_example(flat_tensors: Dict[str, Any],
                            feature_spec: Any) -> bytes:
  """Encodes ONE episode as a serialized tf.SequenceExample: sequence
  specs take [T, ...] arrays (or lists of encoded frames), T the same
  for every sequence key of the episode; context specs unbatched
  arrays."""
  context_specs, sequence_specs = split_sequence_specs(feature_spec)
  if not sequence_specs:
    raise ValueError(
        "encode_sequence_example needs at least one is_sequence spec; "
        "use encode_example for flat records.")
  context = {}
  for key, spec in context_specs.items():
    if key not in flat_tensors:
      if spec.is_optional:
        continue
      raise ValueError(f"Missing required context feature {key!r}")
    context[wire_key(key, spec)] = _encode_feature(flat_tensors[key], spec)
  lengths = set()
  feature_lists = {}
  for key, spec in sequence_specs.items():
    if key not in flat_tensors:
      if spec.is_optional:
        continue
      raise ValueError(f"Missing required sequence feature {key!r}")
    steps = flat_tensors[key]
    lengths.add(len(steps))
    step_spec = spec.replace(is_sequence=False)
    feature_lists[wire_key(key, spec)] = [
        _encode_feature(step, step_spec) for step in steps]
  if len(lengths) > 1:
    raise ValueError(
        f"All sequence features of one episode must share a length; "
        f"got lengths {sorted(lengths)}.")
  return proto.encode_sequence_example(context, feature_lists)
