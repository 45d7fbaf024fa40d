"""Validation and packing of tensors against spec structures (port of
`specs/packing.py`).

A model declares specs; data pipelines produce flat dicts of arrays;
before an array reaches a step it is validated (shape and dtype, modulo
the batch and time prefixes) and packed into a `TensorSpecStruct` whose
layout matches the declaration. Optional specs may be absent; required
specs must match. Leaves may be numpy arrays or torch tensors (a
bfloat16 leaf is a torch tensor: numpy has no bfloat16 of its own).

`to_shape_dtype_structs` has no counterpart: it returns
`jax.ShapeDtypeStruct`s for `jax.eval_shape`, and the port builds its
networks from their constructor arguments instead.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch

from tensor2robot_tpu_torch.specs.tensorspec import (
    PATH_SEP,
    ExtendedTensorSpec,
    TensorSpecStruct,
    _normalize_dtype,
)


class SpecValidationError(ValueError):
  """Raised when tensors do not conform to their declared specs."""


def is_leaf_spec(value: Any) -> bool:
  return isinstance(value, ExtendedTensorSpec)


def flatten_spec_structure(spec_structure: Any) -> TensorSpecStruct:
  """Flattens an arbitrarily nested structure into a TensorSpecStruct.

  Accepts TensorSpecStruct, mappings, named tuples and (nested) lists /
  tuples; list positions become string indices.
  """
  flat: dict = {}

  def visit(prefix: str, node: Any):
    if isinstance(node, TensorSpecStruct):
      for k, v in node.to_flat_dict().items():
        flat[f"{prefix}{PATH_SEP}{k}" if prefix else k] = v
    elif isinstance(node, Mapping):
      for k, v in node.items():
        visit(f"{prefix}{PATH_SEP}{k}" if prefix else str(k), v)
    elif hasattr(node, "_asdict"):  # namedtuple
      visit(prefix, node._asdict())
    elif isinstance(node, (list, tuple)):
      for i, v in enumerate(node):
        visit(f"{prefix}{PATH_SEP}{i}" if prefix else str(i), v)
    else:
      if not prefix:
        raise SpecValidationError(
            "Cannot flatten a bare leaf without a key.")
      flat[prefix] = node

  visit("", spec_structure)
  return TensorSpecStruct.from_flat_dict(flat)


def assert_valid_spec_structure(spec_structure: Any) -> None:
  """Asserts every leaf is an ExtendedTensorSpec."""
  flat = flatten_spec_structure(spec_structure)
  for key, leaf in flat.to_flat_dict().items():
    if not is_leaf_spec(leaf):
      raise SpecValidationError(
          f"Spec structure leaf {key!r} is not an ExtendedTensorSpec: "
          f"{type(leaf)}")


def filter_required_flat_tensor_spec_structure(
    spec_structure: Any) -> TensorSpecStruct:
  """Returns only the non-optional specs, flattened."""
  flat = flatten_spec_structure(spec_structure)
  return TensorSpecStruct.from_flat_dict({
      k: v for k, v in flat.to_flat_dict().items() if not v.is_optional})


def _check_leaf(key: str, spec: ExtendedTensorSpec, array: Any,
                batch_prefix_dims: int) -> None:
  """Validates one array against one spec, ignoring leading prefix dims."""
  shape = tuple(array.shape)
  expected = tuple(spec.shape)
  # Sequence tensors carry one extra (time) axis inside the prefix.
  prefix = batch_prefix_dims + (1 if spec.is_sequence else 0)
  if len(shape) != prefix + len(expected):
    raise SpecValidationError(
        f"{key!r}: rank mismatch — got shape {shape}, expected "
        f"{prefix} prefix dim(s) + {expected} (spec {spec!r}).")
  if shape[prefix:] != expected:
    raise SpecValidationError(
        f"{key!r}: shape mismatch — got {shape}, expected trailing dims "
        f"{expected} (spec {spec!r}).")
  if spec.is_image:
    # Encoded images arrive as uint8 bytes or already-decoded uint8/float.
    return
  got = _normalize_dtype(array.dtype)  # numpy, or torch.bfloat16
  if got != spec.dtype:
    name = "bfloat16" if spec.dtype is torch.bfloat16 else spec.dtype
    raise SpecValidationError(
        f"{key!r}: dtype mismatch — got {got}, expected {name}.")


def validate_and_flatten(spec_structure: Any, tensors: Any,
                         ignore_batch: bool = True) -> TensorSpecStruct:
  """Validates tensors against specs; returns them flat, spec-ordered.

  Optional specs may be missing from `tensors`; required specs must be
  present and conforming. Tensors no spec covers are dropped.
  `ignore_batch`: arrays have one leading batch dim the specs lack.
  """
  spec_dict = flatten_spec_structure(spec_structure).to_flat_dict()
  tensor_dict = flatten_spec_structure(tensors).to_flat_dict()
  prefix = 1 if ignore_batch else 0
  out: dict = {}
  missing = []
  for key, spec in spec_dict.items():
    if not is_leaf_spec(spec):
      raise SpecValidationError(
          f"Spec leaf {key!r} is not an ExtendedTensorSpec.")
    if key in tensor_dict:
      _check_leaf(key, spec, tensor_dict[key], prefix)
      out[key] = tensor_dict[key]
    elif not spec.is_optional:
      missing.append(key)
  if missing:
    raise SpecValidationError(
        f"Required specs missing from tensors: {missing}. "
        f"Available keys: {list(tensor_dict)}")
  return TensorSpecStruct.from_flat_dict(out)


def validate_and_pack(spec_structure: Any, tensors: Any,
                      ignore_batch: bool = True) -> TensorSpecStruct:
  """Validates and returns tensors packed in the spec structure's layout."""
  packed = TensorSpecStruct()
  for key, value in validate_and_flatten(
      spec_structure, tensors, ignore_batch).to_flat_dict().items():
    packed[key] = value
  return packed


def pack_flat_sequence_to_spec_structure(
    spec_structure: Any, flat_sequence: Sequence[Any]) -> TensorSpecStruct:
  """Packs a flat sequence of leaves against the spec's leaf order."""
  flat_specs = flatten_spec_structure(spec_structure).to_flat_dict()
  if len(flat_specs) != len(flat_sequence):
    raise SpecValidationError(
        f"Leaf count mismatch: {len(flat_specs)} specs vs "
        f"{len(flat_sequence)} tensors.")
  out = TensorSpecStruct()
  for key, value in zip(flat_specs, flat_sequence):
    out[key] = value
  return out


def replace_dtype(spec_structure: Any, from_dtype: Any,
                  to_dtype: Any) -> TensorSpecStruct:
  """A copy of the spec structure with `from_dtype` leaves made
  `to_dtype`."""
  from_dtype = _normalize_dtype(from_dtype)
  return TensorSpecStruct.from_flat_dict({
      key: spec.replace(dtype=to_dtype) if spec.dtype == from_dtype else spec
      for key, spec in flatten_spec_structure(
          spec_structure).to_flat_dict().items()})


def as_sequence_specs(spec_structure: Any) -> TensorSpecStruct:
  """Every spec of a structure lifted to a per-timestep sequence spec
  (episode pipelines record a model's per-step specs once per step)."""
  flat = flatten_spec_structure(spec_structure).to_flat_dict()
  return TensorSpecStruct.from_flat_dict(
      {k: v.replace(is_sequence=True) for k, v in flat.items()})


def add_sequence_length(spec_structure: Any,
                        sequence_length: int) -> TensorSpecStruct:
  """Sequence specs rewritten to fixed-length specs of shape
  `(sequence_length,) + shape`; other specs unchanged."""
  flat = flatten_spec_structure(spec_structure).to_flat_dict()
  return TensorSpecStruct.from_flat_dict({
      key: (spec.replace(shape=(sequence_length,) + tuple(spec.shape),
                         is_sequence=False) if spec.is_sequence else spec)
      for key, spec in flat.items()})

