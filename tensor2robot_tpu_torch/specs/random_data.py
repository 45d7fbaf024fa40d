"""Spec-driven random data (port of `specs/random_data.py`).

Draws exactly what the JAX package draws for the same seed — the same
numpy Generator calls in the same order — so a test can feed one batch
to both packages. bfloat16 leaves come back as torch tensors.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from tensor2robot_tpu_torch.specs.packing import flatten_spec_structure
from tensor2robot_tpu_torch.specs.tensorspec import (
    ExtendedTensorSpec,
    TensorSpecStruct,
)


def _flatten_specs(spec_structure: Any) -> dict:
  """The flat '/'-keyed dict of a spec structure (a single spec raises)."""
  if isinstance(spec_structure, ExtendedTensorSpec):
    raise ValueError("pass a structure of specs, not a single spec")
  return flatten_spec_structure(spec_structure).to_flat_dict()


def random_array_for_spec(spec: ExtendedTensorSpec,
                          rng: np.random.Generator,
                          batch_size: Optional[int] = None,
                          sequence_length: Optional[int] = None):
  """Images uniform in [0, 255]; floats standard normal; ints [0, 10)."""
  shape = tuple(spec.shape)
  if spec.is_sequence:
    shape = (sequence_length or 3,) + shape
  if batch_size is not None:
    shape = (batch_size,) + shape
  if spec.dtype is torch.bfloat16:
    return torch.from_numpy(
        rng.standard_normal(size=shape).astype(np.float32)).bfloat16()
  dtype = spec.dtype
  if spec.is_image or dtype == np.uint8:
    return rng.integers(0, 256, size=shape, dtype=np.uint8).astype(dtype)
  if dtype.kind == "f":
    return rng.standard_normal(size=shape).astype(dtype)
  if dtype.kind in ("i", "u"):
    return rng.integers(0, 10, size=shape).astype(dtype)
  if dtype.kind == "b":
    return rng.random(size=shape) > 0.5
  raise ValueError(f"Cannot generate random data for dtype {dtype}")


def make_random_tensors(spec_structure: Any,
                        batch_size: Optional[int] = None,
                        sequence_length: Optional[int] = None,
                        seed: int = 0,
                        include_optional: bool = True) -> TensorSpecStruct:
  """A full random batch conforming to a spec structure."""
  rng = np.random.default_rng(seed)
  out = {}
  for key, spec in _flatten_specs(spec_structure).items():
    if spec.is_optional and not include_optional:
      continue
    out[key] = random_array_for_spec(
        spec, rng, batch_size=batch_size, sequence_length=sequence_length)
  return TensorSpecStruct.from_flat_dict(out)
